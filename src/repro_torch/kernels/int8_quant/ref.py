"""Plain PyTorch versions of the int8 block-quant kernels (the CPU path and
the oracle); the same functions as ``repro.kernels.int8_quant.ref``.

Per tile of ``block_rows`` x d: the amax over the whole tile in f32,
``scale = max(amax * f32(1/127), 1e-12)`` in f32, true division
``x / scale``, ``torch.round`` (half to even, as ``jnp.round``), a clip to
±127 and a cast to int8. Dequantize is one f32 multiply and a cast to
``out_dtype``.

The scale follows the reference's Pallas kernel, not its jnp oracle: the
kernel writes ``amax / 127.0``, and XLA, compiling it, turns a division by
a constant into a multiply by the constant's f32 reciprocal. The eager
oracle divides. The two differ by one ulp in about 4% of tiles; the port
follows the kernel it replaces, whose scales ``compress_tree`` ships."""
from __future__ import annotations

from typing import Tuple

import torch

INV_127 = 1.0 / 127.0  # rounded to f32 where it multiplies an f32 tensor


def int8_quantize_ref(x: torch.Tensor, block_rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q int8 (rows, d), scales f32 (rows // block_rows, 1))``."""
    rows, d = x.shape
    nb = rows // block_rows
    xb = x.float().reshape(nb, block_rows, d)
    amax = xb.abs().amax(dim=(1, 2), keepdim=True)
    scale = torch.clamp_min(amax * INV_127, 1e-12)
    q = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
    return q.reshape(rows, d), scale.reshape(nb, 1)


def int8_dequantize_ref(
    q: torch.Tensor, scales: torch.Tensor, block_rows: int, out_dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """``q * scale`` per tile, (rows, d) in ``out_dtype``."""
    rows, d = q.shape
    nb = rows // block_rows
    x = q.float().reshape(nb, block_rows, d) * scales.reshape(nb, 1, 1)
    return x.reshape(rows, d).to(out_dtype)
