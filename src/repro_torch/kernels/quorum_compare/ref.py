"""Plain PyTorch versions of the quorum_compare kernels (the CPU path and the
oracle): ``quorum_compare_ref`` is the same function as
``repro.kernels.quorum_compare.ref``, with the count in int64;
``quorum_pair_counts_ref`` counts the same test for every earlier-row pair
of a matrix's rows."""
from __future__ import annotations

import math
from typing import Tuple

import torch


def quorum_compare_ref(
    a: torch.Tensor, b: torch.Tensor, rtol: float = 1e-5, atol: float = 1e-8
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(n_bad int64, sum_sq f32)``: the count of ``|a - b| > atol + rtol*|b|``
    in f32 (each operation rounded on its own, as numpy.isclose does) and
    ``sum((a - b)**2)``, summed in f64 and returned as f32."""
    af, bf = a.float().reshape(-1), b.float().reshape(-1)
    diff = (af - bf).abs()
    bad = diff > atol + rtol * bf.abs()
    return bad.sum(dtype=torch.int64), diff.double().square().sum().float()


# elements of the (rows, rows, d) difference block the pair counts build at once
_PAIR_BLOCK = 1 << 23


def quorum_pair_counts_ref(
    rows: torch.Tensor, lo: int, hi: int, rtol: float = 1e-5, atol: float = 1e-8
) -> torch.Tensor:
    """``(hi - lo, hi)`` int32: entry ``[i - lo, r]`` counts the elements of
    ``|rows[i] - rows[r]| > atol + rtol*|rows[r]|`` for ``r < i`` (the
    earlier row is ``b``), 0 for ``r >= i``. In f32, each operation rounded
    on its own, as ``quorum_compare_ref``; blocks of i and r rows keep the
    difference block under ``_PAIR_BLOCK`` elements (never (n, n, d))."""
    x = rows.float()
    d = x.shape[1]
    out = torch.zeros((hi - lo, hi), dtype=torch.int32, device=rows.device)
    step = max(1, math.isqrt(_PAIR_BLOCK // max(d, 1)))  # square blocks of pairs
    for i0 in range(lo, hi, step):
        i1 = min(hi, i0 + step)
        a = x[i0:i1, None, :]
        for r0 in range(0, i1 - 1, step):
            r1 = min(i1 - 1, r0 + step)
            b = x[None, r0:r1, :]
            bad = (a - b).abs() > atol + rtol * b.abs()
            out[i0 - lo:i1 - lo, r0:r1] = bad.sum(dim=2, dtype=torch.int32)
    ii = torch.arange(lo, hi, device=rows.device)[:, None]
    rr = torch.arange(hi, device=rows.device)[None, :]
    return out.masked_fill_(rr >= ii, 0)
