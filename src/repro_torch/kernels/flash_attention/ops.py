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

from .. import _build
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
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
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
        return out.movedim(1, 2), lse
    b, s, h, kv, d = _check(q, k, v)
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
        return dq.movedim(1, 2), dk.movedim(1, 2), dv.movedim(1, 2)
    b, s, h, kv, d = _check(q, k, v)
    if out.shape != q.shape or dout.shape != q.shape or out.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError("flash_attention backward: out and dout must match q")
    if lse.shape != (b, h, s) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention backward: lse must be f32 {(b, h, s)}")
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
    runs the CUDA kernels."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal)
    return flash_attention_fwd(q, k, v, causal=causal)[0]
