"""Flash attention on the model layout ``(B, S, H, D)``, forward and
backward: the CUDA kernels (``csrc/flash_attention.cu``) for CUDA tensors,
the plain versions (``ref.py``) for CPU tensors.

They replace the Pallas TPU kernel
``src/repro/kernels/flash_attention/kernel.py`` (``_flash_kernel``); the
backward has no TPU kernel (the reference differentiates its jnp attention
with XLA). bf16 runs the tensor-core kernels (``mma.sync`` with bf16
operands and f32 accumulators, tiles copied by ``cp.async`` in a 2-stage
ring); f32 runs the scalar f32 kernels, since an f32 product on the tensor
cores would be TF32. The C entry points choose by dtype. Bound on the
card: at the training shape the operations at the type's peak rate, at
short serving prompts about equally the bytes; the bf16 kernels round P
and dS to bf16 before their products, the one rounding the Pallas kernel
does not have (softmax, lse and Delta stay f32).

The kernels read q, k and v through their strides, so neither the transpose
to ``(B, H, S, D)`` nor the reference wrapper's padding of the sequence to
block multiples and of D to 128 lanes is needed: the kernels pad D in shared
memory to 64, 128 or 256 and take any D up to ``MAX_TILE_D`` = 256. A wider D
(no architecture in the repo passes 128), in either type, goes to the wide-D
kernels: scalar f32 FMAs over 64-column slices of D staged in shared memory,
one block per (query or key tile, head, batch, 64 output columns), the
scores recomputed for each slice, and Delta by a small first kernel; the
reference takes any D too (it pads D to 128 lanes). Query head h reads KV head
``h // (H // KV)``; ``sm_scale`` is ``1/sqrt(D)``. In bf16, rows whose
base or stride is not 16-byte aligned (or D not a multiple of 8) are
staged with 2-byte loads instead of 16-byte copies.

``flash_attention`` goes through a ``torch.autograd.Function`` when a
gradient is wanted: its forward also writes the rows' log-sum-exp, which
the backward kernels (dQ, then dK/dV) read. Serving calls the forward alone,
with no log-sum-exp. ``launches`` counts forward launches and
``launches_bwd`` backward calls (each two CUDA launches; three past
``MAX_TILE_D``), of which ``launches_wide`` and ``launches_wide_bwd`` count
those that ran the wide-D kernels; the CPU path leaves them alone. No kernel uses a float atomic: equal inputs give
bit-equal gradients.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from repro_torch.distributed.dtensors import dtensor, is_dtensor, local, placements_keeping

from .. import _build
from .._costs import KernelCost, counted, nbytes, op_type
from .._sharded import per_rank
from .ref import attention_bwd_ref, attention_ref

MAX_TILE_D = 256  # the widest D of the tile kernels; past it the wide-D kernels
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (
    [ctypes.c_void_p] * 5  # q, k, v, out, lse (null when not wanted)
    + [ctypes.c_int] * 5  # B, S, H, KV, D
    + [ctypes.c_int64] * 12  # (batch, seq, head) strides of q, k, v, out
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]  # scale, causal, dtype, stream
)
_BWD_ARGTYPES = (
    [ctypes.c_void_p] * 10  # q, k, v, o, do, lse, delta, dq, dk, dv
    + [ctypes.c_int] * 5  # B, S, H, KV, D
    + [ctypes.c_int64] * 24  # (batch, seq, head) strides of q, k, v, o, do, dq, dk, dv
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]  # scale, causal, dtype, stream
)

launches = 0
launches_bwd = 0
launches_wide = 0
launches_wide_bwd = 0


def _heads_first(*ts: torch.Tensor):
    return [t.movedim(1, 2) for t in ts]


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> Tuple[int, int, int, int, int]:
    """What the kernels refuse, on the card and on the meta device alike (a
    dry run fails where the card would)."""
    if q.device.type not in ("cuda", "meta") or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, not {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, not {q.dtype}")
    b, s, h, d = q.shape
    kv = k.shape[2]
    if k.shape != (b, s, kv, d) or v.shape != k.shape or kv == 0 or h % kv:
        raise ValueError(f"flash_attention shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if d <= 0:
        raise ValueError(f"flash_attention kernel needs D > 0, got {d}")
    return b, s, h, kv, d


def _fwd_cost(q, k, v, *, causal=True, with_lse=False) -> KernelCost:
    """The products of the scores and the output, ``4 B H S^2 D`` at the
    true D, halved under the causal mask; q, k and v read, the output (and
    the log-sum-exp) written."""
    b, s, h, d = q.shape
    flops = 4.0 * b * h * s * s * d / (2 if causal else 1)
    moved = 2 * nbytes(q) + nbytes(k) + nbytes(v) + 4 * b * h * s * with_lse
    return KernelCost(flops, moved, flops, op_type(q))


def _bwd_cost(q, k, v, out, lse, dout, *, causal=True) -> KernelCost:
    """2.5 times the forward's products (the scores again, dV, dP, dQ, dK);
    q, k, v, the output, dO and the log-sum-exp read, dQ, dK and dV written."""
    fwd = _fwd_cost(q, k, v, causal=causal)
    moved = 4 * nbytes(q) + 2 * (nbytes(k) + nbytes(v)) + nbytes(lse)
    return KernelCost(2.5 * fwd.flops, moved, 2.5 * fwd.flops, fwd.ops_type)


@per_rank
@counted("flash_attention_fwd", _fwd_cost)
def flash_attention_fwd(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, S, KV, D)
    v: torch.Tensor,  # (B, S, KV, D)
    *,
    causal: bool = True,
    with_lse: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(out (B, S, H, D), lse (B, H, S) f32 or None)``."""
    global launches, launches_wide
    b, s, h, d = q.shape
    sm_scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        res = attention_ref(*_heads_first(q, k, v), causal=causal, sm_scale=sm_scale,
                            return_lse=with_lse)
        out, lse = res if with_lse else (res, None)
        return out.movedim(1, 2).contiguous(), lse  # the kernel's layout
    b, s, h, kv, d = _check(q, k, v)
    if q.device.type == "meta":
        lse = q.new_empty((b, h, s), dtype=torch.float32) if with_lse else None
        return q.new_empty((b, s, h, d)), lse
    q, k, v = (x if x.stride(-1) == 1 else x.contiguous() for x in (q, k, v))
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if with_lse else None
    if out.numel():
        fn = _build.entry("flash_attention", "repro_flash_attention", _ARGTYPES)
        strides = [st for x in (q, k, v, out) for st in x.stride()[:3]]
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  lse.data_ptr() if lse is not None else None,
                  b, s, h, kv, d, *strides, sm_scale, int(causal), _DTYPES[q.dtype],
                  _build.stream_ptr(q.device))
        _build.check("flash_attention", code)
        launches += 1
        launches_wide += int(d > MAX_TILE_D)
    return out, lse


@per_rank
@counted("flash_attention_bwd", _bwd_cost)
def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
    dout: torch.Tensor, *, causal: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` on the model layout, in the inputs' dtype."""
    global launches_bwd, launches_wide_bwd
    b, s, h, d = q.shape
    sm_scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        dq, dk, dv = attention_bwd_ref(*_heads_first(q, k, v, out), lse, dout.movedim(1, 2),
                                       causal=causal, sm_scale=sm_scale)
        return tuple(t.movedim(1, 2).contiguous() for t in (dq, dk, dv))  # the kernels' layout
    b, s, h, kv, d = _check(q, k, v)
    if out.shape != q.shape or dout.shape != q.shape or out.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError("flash_attention backward: out and dout must match q")
    if lse.shape != (b, h, s) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention backward: lse must be f32 {(b, h, s)}")
    if q.device.type == "meta":
        return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)
    q, k, v, out, dout = (x if x.stride(-1) == 1 else x.contiguous() for x in (q, k, v, out, dout))
    lse = lse.contiguous()
    dq = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, s, kv, d), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, s, kv, d), dtype=q.dtype, device=q.device)
    if dq.numel():
        delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
        fn = _build.entry("flash_attention", "repro_flash_attention_bwd", _BWD_ARGTYPES)
        strides = [st for x in (q, k, v, out, dout, dq, dk, dv) for st in x.stride()[:3]]
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
                  lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                  b, s, h, kv, d, *strides, sm_scale, int(causal), _DTYPES[q.dtype],
                  _build.stream_ptr(q.device))
        _build.check("flash_attention", code)
        launches_bwd += 1
        launches_wide_bwd += int(d > MAX_TILE_D)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, S, KV, D)
    v: torch.Tensor,  # (B, S, KV, D)
    *,
    causal: bool = True,
    block_q: int = 128,
    block_k: int = 128,
    interpret: bool = False,
) -> torch.Tensor:
    """Attention output ``(B, S, H, D)`` in q's dtype; differentiable in q,
    k and v.

    ``block_q``, ``block_k`` and ``interpret`` are the reference's keywords,
    accepted and ignored: the kernels' tiles are fixed by D and the dtype
    (the result does not depend on the tiling beyond rounding), and
    ``interpret`` names the TPU kernel's interpreter, so a CUDA tensor still
    runs the CUDA kernels. DTensors (the sharded step) run the kernels on
    each rank's batch rows and heads (``_sharded``)."""
    if is_dtensor(q):
        return _sharded(q, k, v, causal)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal)
    return flash_attention_fwd(q, k, v, causal=causal)[0]


def _sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> torch.Tensor:
    """Attention of DTensors: batch rows and heads are independent, so their
    shards are kept; a split sequence (the keys every query attends) or head
    width is gathered first. K and V are laid out as the queries: the shard
    of query heads [r H/n, (r+1) H/n) then holds KV heads [r KV/n, (r+1)
    KV/n), which are the ones its heads read, provided KV splits as H does.
    When it does not, K and V must come repeated to H heads (the model does
    so, ``models.attention``); otherwise this raises."""
    if not (is_dtensor(k) and is_dtensor(v)):
        raise TypeError("flash_attention of DTensor queries needs DTensor keys and values")
    pl = placements_keeping(q.placements, (0, 2))
    splits = math.prod(q.device_mesh.size(i) for i, p in enumerate(pl) if p.is_shard() and p.dim == 2)
    if k.shape[2] % splits:
        raise ValueError(f"flash_attention: {k.shape[2]} KV heads cannot follow {q.shape[2]} query "
                         f"heads split {splits} ways; repeat K and V to the query heads first")
    out = flash_attention(local(q, pl), local(k, pl), local(v, pl), causal=causal)
    return dtensor(out, q, pl)
