"""swiglu ``silu(gate) * up``, forward and backward: the CUDA kernels
(``csrc/swiglu.cu``) for CUDA tensors, the plain versions (``ref.py``) for
CPU tensors.

``swiglu`` goes through a ``torch.autograd.Function`` when a gradient is
wanted (its backward is the backward kernel), and calls the forward alone
otherwise. ``launches`` and ``launches_bwd`` count the forward and backward
kernels' launches; the CPU path leaves them alone.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.distributed.dtensors import dtensor, is_dtensor, local, placements_keeping

from .. import _build
from .._costs import KernelCost, counted, nbytes
from .._sharded import per_rank
from .ref import swiglu_bwd_ref, swiglu_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # gate, up, out
    ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,  # n, dtype, stream
]
_BWD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]

launches = 0
launches_bwd = 0


def _check(*ts: torch.Tensor) -> None:
    """What the kernels refuse, on the card and on the meta device alike (a
    dry run fails where the card would)."""
    g = ts[0]
    if g.device.type not in ("cuda", "meta") or any(t.device != g.device for t in ts):
        raise ValueError(f"swiglu runs on cuda or cpu tensors, not {[str(t.device) for t in ts]}")
    if g.dtype not in _DTYPES or any(t.dtype != g.dtype for t in ts):
        raise TypeError(f"swiglu kernel takes float32 or bfloat16, not {[t.dtype for t in ts]}")
    if any(t.shape != g.shape for t in ts):
        raise ValueError(f"swiglu shapes differ: {[tuple(t.shape) for t in ts]}")


def _fwd_cost(gate, up) -> KernelCost:
    """gate and up read, the output written; six f32 operations an element."""
    return KernelCost(0.0, 3 * nbytes(gate), 6 * gate.numel(), "float32")


def _bwd_cost(gate, up, dh) -> KernelCost:
    """gate, up and dh read, dgate and dup written; fourteen f32 operations
    an element."""
    return KernelCost(0.0, 5 * nbytes(gate), 14 * gate.numel(), "float32")


@per_rank
@counted("swiglu_fwd", _fwd_cost)
def swiglu_fwd(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """The forward alone: ``silu(gate) * up`` in f32, in the gate's dtype."""
    global launches
    if gate.device.type == "cpu":
        return swiglu_ref(gate, up)
    _check(gate, up)
    if gate.device.type == "meta":
        return gate.new_empty(gate.shape)
    g = gate.contiguous()
    u = up.contiguous()
    out = torch.empty_like(g)
    if g.numel():
        fn = _build.entry("swiglu", "repro_swiglu", _ARGTYPES)
        code = fn(g.data_ptr(), u.data_ptr(), out.data_ptr(), g.numel(),
                  _DTYPES[g.dtype], _build.stream_ptr(g.device))
        _build.check("swiglu", code)
        launches += 1
    return out


@per_rank
@counted("swiglu_bwd", _bwd_cost)
def swiglu_bwd(
    gate: torch.Tensor, up: torch.Tensor, dh: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dgate, dup)`` in the gate's dtype."""
    global launches_bwd
    if gate.device.type == "cpu":
        return swiglu_bwd_ref(gate, up, dh)
    _check(gate, up, dh)
    if gate.device.type == "meta":
        return gate.new_empty(gate.shape), gate.new_empty(gate.shape)
    g, u, d = gate.contiguous(), up.contiguous(), dh.contiguous()
    dg, du = torch.empty_like(g), torch.empty_like(g)
    if g.numel():
        fn = _build.entry("swiglu", "repro_swiglu_bwd", _BWD_ARGTYPES)
        code = fn(g.data_ptr(), u.data_ptr(), d.data_ptr(), dg.data_ptr(), du.data_ptr(),
                  g.numel(), _DTYPES[g.dtype], _build.stream_ptr(g.device))
        _build.check("swiglu", code)
        launches_bwd += 1
    return dg, du


class _SwiGLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gate, up):
        ctx.save_for_backward(gate, up)
        return swiglu_fwd(gate, up)

    @staticmethod
    def backward(ctx, dh):
        gate, up = ctx.saved_tensors
        return swiglu_bwd(gate, up, dh)


def swiglu(
    gate: torch.Tensor,
    up: torch.Tensor,
    *,
    block_rows: int = 256,
    interpret: bool = False,
) -> torch.Tensor:
    """``silu(gate) * up`` computed in f32, returned in the gate's dtype;
    differentiable in both inputs.

    ``block_rows`` and ``interpret`` are the reference's keywords, accepted
    and ignored: the kernel is elementwise over the flattened inputs, and
    ``interpret`` names the TPU kernel's interpreter, so a CUDA tensor still
    runs the CUDA kernel. DTensors (the sharded step) run the kernel on
    each rank's shard (``_sharded``)."""
    if is_dtensor(gate):
        return _sharded(gate, up)
    if torch.is_grad_enabled() and (gate.requires_grad or up.requires_grad):
        return _SwiGLU.apply(gate, up)
    return swiglu_fwd(gate, up)


def _sharded(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """swiglu of DTensors: elementwise, so every shard of the gate is kept
    (pending sums are reduced) and the up projection is laid out as the
    gate."""
    if not is_dtensor(up):
        raise TypeError("swiglu of a DTensor gate needs a DTensor up on the same mesh")
    pl = placements_keeping(gate.placements, range(gate.ndim))
    return dtensor(swiglu(local(gate, pl), local(up, pl)), gate, pl)
