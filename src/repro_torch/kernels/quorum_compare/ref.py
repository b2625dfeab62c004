"""Plain PyTorch version of the quorum_compare kernel (the CPU path and the
oracle); the same function as ``repro.kernels.quorum_compare.ref``, with the
count in int64."""
from __future__ import annotations

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
