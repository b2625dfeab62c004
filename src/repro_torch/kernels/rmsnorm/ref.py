"""Plain PyTorch versions of the rmsnorm kernels (the CPU path and the oracle)."""
from __future__ import annotations

from typing import Tuple

import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rmsnorm_bwd_ref(
    x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor, eps: float = 1e-6
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dx, dscale)`` of ``rmsnorm_ref`` for the cotangent ``dy``, in f32:
    ``dx = r * (g - xh * mean(g * xh))`` with ``r = rsqrt(mean(x**2) + eps)``,
    ``xh = x * r``, ``g = dy * scale``, cast to x's dtype; ``dscale`` is the
    f32 sum over rows of ``dy * xh``."""
    d = x.shape[-1]
    xf = x.float().reshape(-1, d)
    gf = dy.float().reshape(-1, d)
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    xh = xf * r
    dscale = (gf * xh).sum(dim=0)
    g = gf * scale.float()
    dx = r * (g - xh * (g * xh).mean(dim=-1, keepdim=True))
    return dx.to(x.dtype).view(x.shape), dscale
