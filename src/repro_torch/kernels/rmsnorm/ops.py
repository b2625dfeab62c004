"""rmsnorm over the last axis, forward and backward: the CUDA kernels
(``csrc/rmsnorm.cu``) for CUDA tensors, the plain versions (``ref.py``) for
CPU tensors.

``rmsnorm`` goes through a ``torch.autograd.Function`` when a gradient is
wanted (its backward is the backward kernel), and calls the forward alone
otherwise. ``launches`` and ``launches_bwd`` count the forward and backward
kernels' launches; the CPU path leaves them alone. Both kernels take any
width d > 0: the C entry points spread a row over threads chosen from d and
the row count. The backward's grid, ``bwd_parts(rows, d)``, depends on the
shape alone, never on the card, so equal inputs give equal bits anywhere.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.distributed.dtensors import (dtensor, grad_partial_where_sharded, is_dtensor, local,
                                              placements_keeping)

from .. import _build
from .._costs import KernelCost, counted, nbytes
from .._sharded import per_rank
from .ref import rmsnorm_bwd_ref, rmsnorm_ref

H100_SMS = 132
BWD_MAX_PARTS = 4 * H100_SMS  # backward blocks: at most four per SM
BWD_PARTIAL_FLOATS = 1 << 19  # wide rows get fewer blocks: about 2 MB of f32 partials
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


def _check(x: torch.Tensor, scale: torch.Tensor) -> int:
    """What the kernels refuse, on the card and on the meta device alike (a
    dry run fails where the card would)."""
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"rmsnorm runs on cuda or cpu tensors, not {x.device}")
    d = x.shape[-1]
    if x.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm kernel takes float32 or bfloat16, not {x.dtype}")
    if d == 0 or tuple(scale.shape) != (d,):
        raise ValueError(f"rmsnorm kernel needs d > 0 and scale of shape ({d},)")
    return d


def bwd_parts(rows: int, d: int) -> int:
    """Blocks of the backward kernel for ``rows`` rows of width ``d``; each
    writes one row of f32 dscale partials. One per row, up to four per SM of
    an H100, and fewer for wide rows, down to one per SM. A function of the
    shape alone, so the partials, and the order in which they are summed,
    are the same on every card."""
    return max(1, min(rows, BWD_MAX_PARTS, max(H100_SMS, BWD_PARTIAL_FLOATS // d)))


def _fwd_cost(x, scale, eps=1e-6) -> KernelCost:
    """x read and the output written (and the scale, f32); four f32
    operations an element."""
    n, d = x.numel(), x.shape[-1]
    return KernelCost(0.0, 2 * nbytes(x) + 4 * d, 4 * n, "float32")


def _bwd_cost(x, scale, dy, eps=1e-6) -> KernelCost:
    """x and dy read, dx written, the scale read and dscale written (f32);
    ten f32 operations an element."""
    n, d = x.numel(), x.shape[-1]
    return KernelCost(0.0, 3 * nbytes(x) + 8 * d, 10 * n, "float32")


@per_rank
@counted("rmsnorm_fwd", _fwd_cost)
def rmsnorm_fwd(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The forward alone: ``x * rsqrt(mean(x**2) + eps) * scale``, f32 statistics."""
    global launches
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps)
    d = _check(x, scale)
    if x.device.type == "meta":
        return x.new_empty(x.shape)
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


@per_rank
@counted("rmsnorm_bwd", _bwd_cost)
def rmsnorm_bwd(
    x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor, eps: float = 1e-6
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dx, dscale)``: dx in x's dtype, dscale f32 of shape ``(d,)``."""
    global launches_bwd
    if x.device.type == "cpu":
        return rmsnorm_bwd_ref(x, scale, dy, eps)
    d = _check(x, scale)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"rmsnorm backward: dy {tuple(dy.shape)} {dy.dtype} does not match x")
    if x.device.type == "meta":
        return x.new_empty(x.shape), x.new_empty(x.shape[-1:], dtype=torch.float32)
    xf = x.reshape(-1, d).contiguous()
    gf = dy.reshape(-1, d).contiguous()
    sc = scale.to(device=x.device, dtype=torch.float32).contiguous()
    rows = xf.shape[0]
    dx = torch.empty_like(xf)
    if not rows:
        return dx.view(x.shape), torch.zeros(d, dtype=torch.float32, device=x.device)
    parts = bwd_parts(rows, d)
    partial = torch.empty((parts, d), dtype=torch.float32, device=x.device)
    dscale = torch.empty(d, dtype=torch.float32, device=x.device)  # every column is written
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


def rmsnorm(
    x: torch.Tensor,
    scale: torch.Tensor,
    *,
    eps: float = 1e-6,
    block_rows: int = 256,
    interpret: bool = False,
) -> torch.Tensor:
    """``x * rsqrt(mean(x**2) + eps) * scale`` with f32 statistics, in x's
    dtype; differentiable in x and scale (scale's gradient is f32, cast back
    to scale's dtype by autograd).

    ``block_rows`` and ``interpret`` are the reference's keywords, accepted
    and ignored: the kernel picks its rows per block from d and the row
    count, and ``interpret`` names the TPU kernel's interpreter, so a CUDA
    tensor still runs the CUDA kernel. A DTensor ``x`` (the sharded step)
    runs the kernel on each rank's rows (``_sharded``)."""
    if is_dtensor(x):
        return _sharded(x, scale, eps)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RMSNorm.apply(x, scale.float(), eps)
    return rmsnorm_fwd(x, scale, eps)


def _sharded(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """rmsnorm of a DTensor: the rows keep their shards; a last dimension
    split over a mesh axis is gathered first, since the statistics sum over
    it. The scale is gathered whole on every rank, and its local gradient is
    a partial sum over each axis that splits the rows."""
    from torch.distributed.tensor import Replicate

    if not is_dtensor(scale):
        raise TypeError("rmsnorm of a DTensor needs a DTensor scale on the same mesh")
    pl = placements_keeping(x.placements, range(x.ndim - 1))
    whole = (Replicate(),) * len(pl)
    out = rmsnorm(local(x, pl), local(scale, whole, grad_partial_where_sharded(pl)), eps=eps)
    return dtensor(out, x, pl)
