"""Engine backends of the port's middleware copy.

The engines (``BatchDispatchEngine``, ``BatchClientEngine``, ``HostArrays``,
``BatchValidationEngine``) take ``backend="numpy"`` (the default) or
``"torch"``, where the reference takes ``"numpy"`` or ``"jax"``. The torch
backend runs the engines' dense passes on a device (``core/torch_backend``):
``device="cuda"`` unless the caller asks for ``"cpu"``, and without a card
``"cuda"`` raises. The NumPy backend ignores the device.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..device import Device, resolve_device

BACKENDS = ("numpy", "torch")


def resolve_backend(backend: str) -> str:
    """Validate a ``backend=`` engine argument."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    return backend


def resolve_engine(backend: str, device: Device = "cuda") -> Tuple[str, Optional[torch.device]]:
    """``(backend, device)`` of an engine: the torch backend's device
    resolved (raising without a card unless ``device="cpu"``), None for
    NumPy, which ignores ``device``."""
    backend = resolve_backend(backend)
    return backend, (resolve_device(device) if backend == "torch" else None)
