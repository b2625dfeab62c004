"""Plain PyTorch version of the swiglu kernel (the CPU path and the oracle)."""
from __future__ import annotations

import torch


def swiglu_ref(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    gf = gate.float()
    return (gf * torch.sigmoid(gf) * up.float()).to(gate.dtype)
