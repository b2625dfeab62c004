"""Block-scaled int8 quantize/dequantize: the CUDA kernels
(``csrc/int8_quant.cu``) for CUDA tensors, the plain versions (``ref.py``)
for CPU tensors. The array-shaped round trip that ``optim/compression.py``
applies to every gradient leaf.

The wrappers take the reference's signatures and padding
(``repro.kernels.int8_quant.ops``): the input is flattened, zero-padded to
256 lanes, cut into tiles of ``br = min(block_rows, rows)`` rows and
zero-padded to a whole number of tiles; dequantize trims the padding again
(``reshape(-1)[:n].reshape(shape)``, a view of the padded result).
``launches_quantize`` and ``launches_dequantize`` count the kernels'
launches; the CPU path leaves them alone.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from .. import _build
from .._costs import KernelCost, counted, nbytes
from .ref import int8_dequantize_ref, int8_quantize_ref

LANES = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_Q_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,  # x, rows, block_rows
    ctypes.c_void_p, ctypes.c_void_p,  # q, scales
    ctypes.c_int, ctypes.c_void_p,  # dtype, stream
]
_D_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,  # q, scales, rows, block_rows
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,  # out, dtype, stream
]

launches_quantize = 0
launches_dequantize = 0


def _device_check(name: str, *ts: torch.Tensor) -> None:
    """The kernels' tensors are on one card, or on the meta device, where
    the same checks follow (a dry run fails where the card would)."""
    dev = ts[0].device
    if dev.type not in ("cuda", "meta") or any(t.device != dev for t in ts):
        raise ValueError(f"{name} runs on cuda or cpu tensors, not {[str(t.device) for t in ts]}")


def to_rows(x: torch.Tensor, block_rows: int = 256) -> Tuple[torch.Tensor, int]:
    """``x`` flattened and zero-padded to (rows, 256), rows a multiple of
    ``br = min(block_rows, rows)``: ``(rows2d, br)``. No copy where no
    padding is needed and ``x`` is contiguous."""
    if x.numel() == 0:
        raise ValueError("int8_quantize takes a non-empty tensor")
    flat = x.reshape(-1)
    pad = (-flat.numel()) % LANES
    if pad:
        flat = F.pad(flat, (0, pad))
    rows2d = flat.view(-1, LANES)
    br = min(block_rows, rows2d.shape[0])
    rpad = (-rows2d.shape[0]) % br
    if rpad:
        rows2d = F.pad(rows2d, (0, 0, 0, rpad))
    return rows2d, br


def _quantize_cost(rows2d, br) -> KernelCost:
    """x read, the codes and one f32 scale a tile written; six f32
    operations an element (abs, max, divide, round, two clamps)."""
    m = rows2d.numel()
    return KernelCost(0.0, nbytes(rows2d) + m + 4 * (rows2d.shape[0] // br), 6 * m, "float32")


def _dequantize_cost(q, scales, br, out_dtype=torch.float32) -> KernelCost:
    """The codes and scales read, the values written; one f32 operation an
    element."""
    m = q.numel()
    return KernelCost(0.0, m * (1 + out_dtype.itemsize) + nbytes(scales), m, "float32")


@counted("int8_quantize", _quantize_cost)
def quantize_rows(rows2d: torch.Tensor, br: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel on (rows, 256) rows already padded to whole tiles of
    ``br`` rows: ``(q int8 (rows, 256), scales f32 (rows // br, 1))``."""
    global launches_quantize
    if rows2d.device.type == "cpu":
        return int8_quantize_ref(rows2d, br)
    _device_check("int8_quantize", rows2d)
    if rows2d.dtype not in _DTYPES:
        raise TypeError(f"int8_quantize kernel takes float32 or bfloat16, not {rows2d.dtype}")
    rows, d = rows2d.shape
    if d != LANES or rows % br:
        raise ValueError(f"int8_quantize takes (rows, {LANES}) in whole tiles of {br} rows, "
                         f"not {tuple(rows2d.shape)}")
    if rows2d.device.type == "meta":
        return (rows2d.new_empty((rows, LANES), dtype=torch.int8),
                rows2d.new_empty((rows // br, 1), dtype=torch.float32))
    x = rows2d.contiguous()
    q = torch.empty((rows, LANES), dtype=torch.int8, device=x.device)
    scales = torch.empty((rows // br, 1), dtype=torch.float32, device=x.device)
    fn = _build.entry("int8_quant", "repro_int8_quantize", _Q_ARGTYPES)
    code = fn(x.data_ptr(), rows, br, q.data_ptr(), scales.data_ptr(), _DTYPES[x.dtype],
              _build.stream_ptr(x.device))
    _build.check("int8_quant", code)
    launches_quantize += 1
    return q, scales


@counted("int8_dequantize", _dequantize_cost)
def dequantize_rows(
    q: torch.Tensor, scales: torch.Tensor, br: int, out_dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """The kernel: ``q * scale`` per tile of ``br`` rows, (rows, 256) in
    ``out_dtype``."""
    global launches_dequantize
    if q.device.type == "cpu":
        return int8_dequantize_ref(q, scales, br, out_dtype)
    _device_check("int8_dequantize", q, scales)
    if q.dtype != torch.int8 or scales.dtype != torch.float32 or out_dtype not in _DTYPES:
        raise TypeError(f"int8_dequantize kernel takes int8 codes and float32 scales to float32 "
                        f"or bfloat16, not {q.dtype}, {scales.dtype} to {out_dtype}")
    rows, d = q.shape
    if d != LANES or rows % br or scales.numel() != rows // br:
        raise ValueError(f"int8_dequantize takes (rows, {LANES}) codes in tiles of {br} rows with "
                         f"one scale each, not {tuple(q.shape)} and {scales.numel()} scales")
    if q.device.type == "meta":
        return q.new_empty((rows, LANES), dtype=out_dtype)
    qc, sc = q.contiguous(), scales.contiguous()
    out = torch.empty((rows, LANES), dtype=out_dtype, device=q.device)
    fn = _build.entry("int8_quant", "repro_int8_dequantize", _D_ARGTYPES)
    code = fn(qc.data_ptr(), sc.data_ptr(), rows, br, out.data_ptr(), _DTYPES[out_dtype],
              _build.stream_ptr(q.device))
    _build.check("int8_quant", code)
    launches_dequantize += 1
    return out


def int8_quantize(
    x: torch.Tensor, *, block_rows: int = 256, interpret: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q int8 (rows, 256), scales f32 (nb, 1))`` of ``x`` (any shape,
    float32 or bfloat16 on the card) after the reference's padding.
    ``interpret``, the reference's keyword, is accepted and ignored: it
    names the TPU kernel's interpreter, so a CUDA tensor still runs the
    CUDA kernel (here and in the two functions below)."""
    return quantize_rows(*to_rows(x, block_rows))


def int8_dequantize(
    q: torch.Tensor,
    scales: torch.Tensor,
    *,
    n: int,
    shape: Tuple[int, ...],
    block_rows: int = 256,
    out_dtype: torch.dtype = torch.float32,
    interpret: bool = False,
) -> torch.Tensor:
    """The ``n`` leading values of ``q * scale``, reshaped to ``shape``."""
    br = min(block_rows, q.shape[0])
    x = dequantize_rows(q, scales, br, out_dtype)
    return x.reshape(-1)[:n].reshape(shape)


def quantize_dequantize(x: torch.Tensor, *, interpret: bool = True) -> torch.Tensor:
    """Round-trip helper (what the compression path applies per leaf)."""
    q, s = int8_quantize(x)
    return int8_dequantize(q, s, n=x.numel(), shape=tuple(x.shape), out_dtype=x.dtype)
