"""Plain PyTorch versions of the swiglu kernels (the CPU path and the oracle)."""
from __future__ import annotations

from typing import Tuple

import torch


def swiglu_ref(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    gf = gate.float()
    return (gf * torch.sigmoid(gf) * up.float()).to(gate.dtype)


def swiglu_bwd_ref(
    gate: torch.Tensor, up: torch.Tensor, dh: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dgate, dup)`` of ``swiglu_ref`` for the cotangent ``dh``, in f32:
    ``dg = dh * u * s * (1 + g * (1 - s))`` and ``du = dh * g * s`` with
    ``s = sigmoid(g)``, each cast to the gate's dtype."""
    g, u, d = gate.float(), up.float(), dh.float()
    sig = torch.sigmoid(g)
    dg = d * u * sig * (1.0 + g * (1.0 - sig))
    du = d * (g * sig)
    return dg.to(gate.dtype), du.to(gate.dtype)
