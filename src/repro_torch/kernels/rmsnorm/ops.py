"""rmsnorm over the last axis, forward and backward: the CUDA kernels
(``csrc/rmsnorm.cu``) for CUDA tensors, the plain versions (``ref.py``) for
CPU tensors.

``rmsnorm`` goes through a ``torch.autograd.Function`` when a gradient is
wanted (its backward is the backward kernel), and calls the forward alone
otherwise. ``launches`` and ``launches_bwd`` count the forward and backward
kernels' launches; the CPU path leaves them alone.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import _build
from .ref import rmsnorm_bwd_ref, rmsnorm_ref

MAX_D = 4096
MAX_D_BWD = 1024  # the backward keeps each lane's dscale sums in registers
BWD_WARPS = 8  # rows per block of the backward kernel (csrc kBwdWarps)
BWD_MAX_BLOCKS = 2 * 132  # two blocks for each of the H100's 132 SMs
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x, scale, out
    ctypes.c_int64, ctypes.c_int, ctypes.c_float, ctypes.c_int,  # rows, d, eps, dtype
    ctypes.c_void_p,  # stream
]
_BWD_ARGTYPES = (
    [ctypes.c_void_p] * 6  # x, scale, dy, dx, partial, dscale
    + [ctypes.c_int64, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int]  # rows, d, eps, parts, dtype
    + [ctypes.c_void_p]  # stream
)

launches = 0
launches_bwd = 0


def _check(x: torch.Tensor, scale: torch.Tensor, max_d: int) -> int:
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm runs on cuda or cpu tensors, not {x.device}")
    d = x.shape[-1]
    if x.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm kernel takes float32 or bfloat16, not {x.dtype}")
    if not 0 < d <= max_d or tuple(scale.shape) != (d,):
        raise ValueError(f"rmsnorm kernel needs 0 < d <= {max_d} and scale of shape ({d},)")
    return d


def rmsnorm_fwd(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The forward alone: ``x * rsqrt(mean(x**2) + eps) * scale``, f32 statistics."""
    global launches
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps)
    d = _check(x, scale, MAX_D)
    xf = x.reshape(-1, d).contiguous()
    sc = scale.to(device=x.device, dtype=torch.float32).contiguous()
    out = torch.empty_like(xf)
    rows = xf.shape[0]
    if rows:
        fn = _build.entry("rmsnorm", "repro_rmsnorm", _ARGTYPES)
        code = fn(xf.data_ptr(), sc.data_ptr(), out.data_ptr(), rows, d, eps,
                  _DTYPES[x.dtype], _build.stream_ptr(x.device))
        _build.check("rmsnorm", code)
        launches += 1
    return out.view(x.shape)


def rmsnorm_bwd(
    x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor, eps: float = 1e-6
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dx, dscale)``: dx in x's dtype, dscale f32 of shape ``(d,)``."""
    global launches_bwd
    if x.device.type == "cpu":
        return rmsnorm_bwd_ref(x, scale, dy, eps)
    d = _check(x, scale, MAX_D_BWD)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"rmsnorm backward: dy {tuple(dy.shape)} {dy.dtype} does not match x")
    xf = x.reshape(-1, d).contiguous()
    gf = dy.reshape(-1, d).contiguous()
    sc = scale.to(device=x.device, dtype=torch.float32).contiguous()
    rows = xf.shape[0]
    dx = torch.empty_like(xf)
    dscale = torch.zeros(d, dtype=torch.float32, device=x.device)
    if rows:
        parts = min(-(-rows // BWD_WARPS), BWD_MAX_BLOCKS)
        partial = torch.empty((parts, d), dtype=torch.float32, device=x.device)
        fn = _build.entry("rmsnorm", "repro_rmsnorm_bwd", _BWD_ARGTYPES)
        code = fn(xf.data_ptr(), sc.data_ptr(), gf.data_ptr(), dx.data_ptr(), partial.data_ptr(),
                  dscale.data_ptr(), rows, d, eps, parts, _DTYPES[x.dtype],
                  _build.stream_ptr(x.device))
        _build.check("rmsnorm", code)
        launches_bwd += 1
    return dx.view(x.shape), dscale


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rmsnorm_fwd(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd(x, scale, dy.contiguous(), ctx.eps)
        return dx, dscale, None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x**2) + eps) * scale`` with f32 statistics, in x's
    dtype; differentiable in x and scale (scale's gradient is f32, cast back
    to scale's dtype by autograd)."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RMSNorm.apply(x, scale.float(), eps)
    return rmsnorm_fwd(x, scale, eps)
