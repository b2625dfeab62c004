"""rmsnorm over the last axis: the CUDA kernel (``csrc/rmsnorm.cu``) for a
CUDA tensor, the plain version (``ref.py``) for a CPU tensor.

``launches`` counts the kernel's launches; the CPU path leaves it alone.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import rmsnorm_ref

MAX_D = 4096
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x, scale, out
    ctypes.c_int64, ctypes.c_int, ctypes.c_float, ctypes.c_int,  # rows, d, eps, dtype
    ctypes.c_void_p,  # stream
]

launches = 0


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x**2) + eps) * scale`` with f32 statistics, in x's dtype."""
    global launches
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm runs on cuda or cpu tensors, not {x.device}")
    d = x.shape[-1]
    if x.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm kernel takes float32 or bfloat16, not {x.dtype}")
    if not 0 < d <= MAX_D or tuple(scale.shape) != (d,):
        raise ValueError(f"rmsnorm kernel needs 0 < d <= {MAX_D} and scale of shape ({d},)")
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
