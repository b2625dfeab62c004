"""Fuzzy quorum comparison of result replicas: the CUDA kernels
(``csrc/quorum_compare.cu``) for CUDA tensors, the plain versions
(``ref.py``) for CPU tensors.

``quorum_compare`` returns ``(n_bad, sum_sq)`` over the flattened inputs as
0-dim device tensors (no host sync); ``tree_quorum_agree`` is the tree-level
agreement test of the reference's ``ops.py``. The TPU wrapper's padding to
256 lanes is not needed: the kernel takes any length. ``launches`` counts
the kernel's launches (one per call: a partial pass and a one-block final
pass); the CPU path leaves it alone.

``quorum_pair_counts`` counts the same test for every earlier-row pair of a
panel of a matrix's rows in one launch (the validation engine's digests);
``launches_pairs`` counts its launches.
"""
from __future__ import annotations

import ctypes
from typing import Any, Tuple

import torch

from .. import _build
from .._costs import KernelCost, counted, nbytes
from repro_torch.models.layers import tree_leaves
from .ref import quorum_compare_ref, quorum_pair_counts_ref

THREADS = 256  # csrc kThreads
MAX_PARTS = 132 * 8  # first-pass blocks: eight for each of the H100's 132 SMs
PAIR_TILE = 64  # csrc kPairTile: the i-rows and r-rows of a block
CHUNK_BYTES = 128  # csrc kChunkBytes: the bytes of a row a chunk of the d axis holds
PAIR_BLOCKS = 132 * 2  # pair-count blocks the H100 runs at once: two for each SM
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p,  # a, b
    ctypes.c_int64, ctypes.c_float, ctypes.c_float, ctypes.c_int,  # n, rtol, atol, parts
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # partials, outputs
    ctypes.c_int, ctypes.c_void_p,  # dtype, stream
]

_PAIR_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,  # rows, n, d
    ctypes.c_int64, ctypes.c_int64, ctypes.c_float, ctypes.c_float,  # lo, hi, rtol, atol
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p,  # vec, slices, partials
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,  # counts, dtype, stream
]

launches = 0
launches_pairs = 0


def _compare_cost(a, b, **_) -> KernelCost:
    """Both payloads read; six f32 operations an element."""
    return KernelCost(0.0, nbytes(a) + nbytes(b), 6 * a.numel(), "float32")


def _pairs_cost(rows, lo, hi, **_) -> KernelCost:
    """The rows read once, the counts written; five f32 operations an
    element of each pair (row i against every earlier row, i in [lo, hi))."""
    pairs = (hi * (hi - 1) - lo * (lo - 1)) // 2
    return KernelCost(0.0, nbytes(rows) + 4 * (hi - lo) * hi, 5 * rows.shape[1] * pairs, "float32")


@counted("quorum_compare", _compare_cost)
def quorum_compare(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    rtol: float = 1e-5,
    atol: float = 1e-8,
    interpret: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(n_bad int64, sum_sq f32)`` over flattened inputs of equal size.

    An element is bad when ``|a - b| > atol + rtol*|b|`` in f32; a NaN is
    never bad (as on the TPU), and any non-finite element makes ``sum_sq``
    non-finite. ``interpret``, the reference's keyword, is accepted and
    ignored: it names the TPU kernel's interpreter, so a CUDA tensor still
    runs the CUDA kernel."""
    global launches
    if a.numel() != b.numel():
        raise ValueError(f"quorum_compare sizes differ: {a.numel()} vs {b.numel()}")
    if a.device.type == "cpu":
        return quorum_compare_ref(a, b, rtol, atol)
    # what the kernel refuses, on the card and on the meta device alike
    if a.device.type not in ("cuda", "meta") or b.device != a.device:
        raise ValueError(f"quorum_compare runs on cuda or cpu tensors, not {a.device}/{b.device}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"quorum_compare kernel takes float32 or bfloat16 pairs, not {a.dtype}/{b.dtype}")
    if a.device.type == "meta":
        return a.new_empty((), dtype=torch.int64), a.new_empty((), dtype=torch.float32)
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


def _pair_slices(lo: int, hi: int, d: int, esize: int) -> int:
    """Slices of the d axis for a panel: as many blocks as the card runs at
    once over the panel's lower-triangle tiles, at least two chunks a slice
    (so the double buffer has work); 1 when the tiles fill the card."""
    tiles = sum(-(-(min(hi, i0 + PAIR_TILE) - 1) // PAIR_TILE) for i0 in range(lo, hi, PAIR_TILE))
    chunks = -(-d * esize // CHUNK_BYTES)
    per = max(2, -(-chunks // max(1, PAIR_BLOCKS // tiles)))
    return max(1, -(-chunks // per))


@counted("quorum_pair_counts", _pairs_cost)
def quorum_pair_counts(
    rows: torch.Tensor,
    lo: int,
    hi: int,
    *,
    rtol: float = 1e-5,
    atol: float = 1e-8,
) -> torch.Tensor:
    """``(hi - lo, hi)`` int32 counts for the rows ``[lo, hi)`` of an (n, d)
    matrix: entry ``[i - lo, r]`` is ``quorum_compare(rows[i], rows[r])``'s
    ``n_bad`` for ``r < i`` (the earlier row is ``b``: the tolerance is
    ``atol + rtol*|rows[r]|``), 0 for ``r >= i``. One launch on the card
    (none where there is no pair): the tiled kernel and, where the panel's
    tiles are too few to fill the card and the d axis is split across
    blocks, a second kernel that adds the slices' counts in a fixed order,
    as ``quorum_compare``'s launch is a partial and a final pass."""
    global launches_pairs
    if rows.dim() != 2:
        raise ValueError(f"quorum_pair_counts takes an (n, d) matrix, not {tuple(rows.shape)}")
    n, d = rows.shape
    if not 0 <= lo <= hi <= n:
        raise ValueError(f"quorum_pair_counts panel [{lo}, {hi}) outside {n} rows")
    if d >= 2**31:
        raise ValueError(f"quorum_pair_counts takes rows shorter than 2**31, not {d}")
    if rows.device.type == "cpu":
        return quorum_pair_counts_ref(rows, lo, hi, rtol, atol)
    # what the kernel refuses, on the card and on the meta device alike
    if rows.device.type not in ("cuda", "meta"):
        raise ValueError(f"quorum_pair_counts runs on cuda or cpu tensors, not {rows.device}")
    if rows.dtype not in _DTYPES:
        raise TypeError(f"quorum_pair_counts kernel takes float32 or bfloat16 rows, not {rows.dtype}")
    if rows.device.type == "meta":
        return rows.new_empty((hi - lo, hi), dtype=torch.int32)
    counts = torch.empty((hi - lo, hi), dtype=torch.int32, device=rows.device)
    if hi < 2 or lo == hi:
        return counts.zero_()
    x = rows.contiguous()
    ptr, row_bytes = x.data_ptr(), d * x.element_size()
    vec = (ptr | row_bytes) % 16 == 0  # every row starts 16-byte aligned: 16-byte copies
    slices = _pair_slices(lo, hi, d, x.element_size())
    partials = counts.new_empty((slices, hi - lo, hi) if slices > 1 else (0,))
    fn = _build.entry("quorum_compare", "repro_quorum_pair_counts", _PAIR_ARGTYPES)
    code = fn(ptr, n, d, lo, hi, rtol, atol, vec, slices, partials.data_ptr() or None,
              counts.data_ptr(), _DTYPES[x.dtype], _build.stream_ptr(x.device))
    _build.check("quorum_compare", code)
    launches_pairs += 1
    return counts


def tree_quorum_agree(
    tree_a: Any,
    tree_b: Any,
    *,
    rtol: float = 1e-4,
    atol: float = 1e-6,
    max_bad_fraction: float = 0.0,
    interpret: bool = True,
) -> bool:
    """Tree-level fuzzy agreement: the fraction of bad elements over every
    leaf is at most ``max_bad_fraction``. Leaves are taken in sorted-key
    order; trees with different leaf counts or shapes disagree.
    ``interpret`` is accepted and ignored, as in ``quorum_compare``."""
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
