"""Fuzzy quorum comparison of result replicas: the CUDA kernel
(``csrc/quorum_compare.cu``) for CUDA tensors, the plain version
(``ref.py``) for CPU tensors.

``quorum_compare`` returns ``(n_bad, sum_sq)`` over the flattened inputs as
0-dim device tensors (no host sync); ``tree_quorum_agree`` is the tree-level
agreement test of the reference's ``ops.py``. The TPU wrapper's padding to
256 lanes is not needed: the kernel takes any length. ``launches`` counts
the kernel's launches (one per call: a partial pass and a one-block final
pass); the CPU path leaves it alone.
"""
from __future__ import annotations

import ctypes
from typing import Any, Tuple

import torch

from .. import _build
from repro_torch.models.layers import tree_leaves
from .ref import quorum_compare_ref

THREADS = 256  # csrc kThreads
MAX_PARTS = 132 * 8  # first-pass blocks: eight for each of the H100's 132 SMs
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p,  # a, b
    ctypes.c_int64, ctypes.c_float, ctypes.c_float, ctypes.c_int,  # n, rtol, atol, parts
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # partials, outputs
    ctypes.c_int, ctypes.c_void_p,  # dtype, stream
]

launches = 0


def quorum_compare(
    a: torch.Tensor, b: torch.Tensor, *, rtol: float = 1e-5, atol: float = 1e-8
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(n_bad int64, sum_sq f32)`` over flattened inputs of equal size.

    An element is bad when ``|a - b| > atol + rtol*|b|`` in f32; a NaN is
    never bad (as on the TPU), and any non-finite element makes ``sum_sq``
    non-finite."""
    global launches
    if a.numel() != b.numel():
        raise ValueError(f"quorum_compare sizes differ: {a.numel()} vs {b.numel()}")
    if a.device.type == "cpu":
        return quorum_compare_ref(a, b, rtol, atol)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"quorum_compare runs on cuda or cpu tensors, not {a.device}/{b.device}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"quorum_compare kernel takes float32 or bfloat16 pairs, not {a.dtype}/{b.dtype}")
    n = a.numel()
    cnt = torch.zeros((), dtype=torch.int64, device=a.device)
    sq = torch.zeros((), dtype=torch.float32, device=a.device)
    if n:
        af, bf = a.contiguous(), b.contiguous()
        parts = min(-(-n // (THREADS * 4)), MAX_PARTS)
        cnt_part = torch.empty(parts, dtype=torch.int64, device=a.device)
        sq_part = torch.empty(parts, dtype=torch.float64, device=a.device)
        fn = _build.entry("quorum_compare", "repro_quorum_compare", _ARGTYPES)
        code = fn(af.data_ptr(), bf.data_ptr(), n, rtol, atol, parts, cnt_part.data_ptr(),
                  sq_part.data_ptr(), cnt.data_ptr(), sq.data_ptr(), _DTYPES[a.dtype],
                  _build.stream_ptr(a.device))
        _build.check("quorum_compare", code)
        launches += 1
    return cnt, sq


def tree_quorum_agree(
    tree_a: Any,
    tree_b: Any,
    *,
    rtol: float = 1e-4,
    atol: float = 1e-6,
    max_bad_fraction: float = 0.0,
) -> bool:
    """Tree-level fuzzy agreement: the fraction of bad elements over every
    leaf is at most ``max_bad_fraction``. Leaves are taken in sorted-key
    order; trees with different leaf counts or shapes disagree."""
    la, lb = tree_leaves(tree_a), tree_leaves(tree_b)
    if len(la) != len(lb):
        return False
    if any(xa.shape != xb.shape for xa, xb in zip(la, lb)):
        return False
    total = sum(xa.numel() for xa in la)
    if total == 0:
        return True
    bad = sum(int(quorum_compare(xa, xb, rtol=rtol, atol=atol)[0]) for xa, xb in zip(la, lb))
    return (bad / total) <= max_bad_fraction
