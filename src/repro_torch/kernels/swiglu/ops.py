"""swiglu ``silu(gate) * up``: the CUDA kernel (``csrc/swiglu.cu``) for CUDA
tensors, the plain version (``ref.py``) for CPU tensors.

``launches`` counts the kernel's launches; the CPU path leaves it alone.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import swiglu_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # gate, up, out
    ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,  # n, dtype, stream
]

launches = 0


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """``silu(gate) * up`` computed in f32, returned in the gate's dtype."""
    global launches
    if gate.device.type == "cpu":
        return swiglu_ref(gate, up)
    if gate.device.type != "cuda" or up.device != gate.device:
        raise ValueError(f"swiglu runs on cuda or cpu tensors, not {gate.device}/{up.device}")
    if gate.dtype not in _DTYPES or up.dtype != gate.dtype:
        raise TypeError(f"swiglu kernel takes float32 or bfloat16 pairs, not {gate.dtype}/{up.dtype}")
    if gate.shape != up.shape:
        raise ValueError(f"swiglu shapes differ: {tuple(gate.shape)} vs {tuple(up.shape)}")
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
