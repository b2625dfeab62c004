"""Forward flash attention on the model layout ``(B, S, H, D)``: the CUDA
kernel (``csrc/flash_attention.cu``) for CUDA tensors, the plain version
(``ref.py``) for CPU tensors.

The kernel reads q, k and v through their strides, so neither the transpose
to ``(B, H, S, D)`` nor the reference wrapper's padding of the sequence to
block multiples and of D to 128 lanes is needed. Query head h reads KV head
``h // (H // KV)``; ``sm_scale`` is ``1/sqrt(D)``.

``launches`` counts the kernel's launches; the CPU path leaves it alone.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import _build
from .ref import attention_ref

MAX_D = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (
    [ctypes.c_void_p] * 4  # q, k, v, out
    + [ctypes.c_int] * 5  # B, S, H, KV, D
    + [ctypes.c_int64] * 12  # (batch, seq, head) strides of q, k, v, out
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]  # scale, causal, dtype, stream
)

launches = 0


def flash_attention(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, S, KV, D)
    v: torch.Tensor,  # (B, S, KV, D)
    *,
    causal: bool = True,
) -> torch.Tensor:
    global launches
    b, s, h, d = q.shape
    sm_scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        qh, kh, vh = (x.movedim(1, 2) for x in (q, k, v))
        return attention_ref(qh, kh, vh, causal=causal, sm_scale=sm_scale).movedim(1, 2)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, not {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, not {q.dtype}")
    kv = k.shape[2]
    if k.shape != (b, s, kv, d) or v.shape != k.shape or kv == 0 or h % kv:
        raise ValueError(f"flash_attention shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not 0 < d <= MAX_D:
        raise ValueError(f"flash_attention kernel needs 0 < D <= {MAX_D}, got {d}")
    q, k, v = (x if x.stride(-1) == 1 else x.contiguous() for x in (q, k, v))
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if out.numel():
        fn = _build.entry("flash_attention", "repro_flash_attention", _ARGTYPES)
        strides = [st for x in (q, k, v, out) for st in x.stride()[:3]]
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  b, s, h, kv, d, *strides, sm_scale, int(causal), _DTYPES[q.dtype],
                  _build.stream_ptr(q.device))
        _build.check("flash_attention", code)
        launches += 1
    return out
