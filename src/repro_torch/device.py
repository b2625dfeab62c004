"""Device resolution for the port's entry points.

Entry points default to ``device="cuda"`` and raise when no card is present:
the port never drops to the CPU on its own. The CPU runs only when the
caller asks for it, as the tests do.
"""
from __future__ import annotations

from typing import Union

import torch

Device = Union[str, torch.device]


def resolve_device(device: Device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
