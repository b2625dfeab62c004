"""What one call of a hand-written kernel costs, reported to the counter of
``repro_torch.distributed.hlo_costs``.

The kernels are called through ``ctypes``, so no dispatch mode sees them.
Each kernel entry of an ``ops.py`` is wrapped by ``counted``: with no
counter running (``ACTIVE`` is None) the call goes straight through; with
one, the call reports its formula (``KernelCost``) and the counter ignores
the aten ops the entry runs inside (the plain version's on the CPU, a
``.contiguous()`` copy on the card), so a step counts the same on the meta
device, the CPU and the card. The formulas are the bound column of the
kernel table in ``PERF.md``: the bytes each input read once and each output
written once, and the operations the bound counts, at the rate of their type.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable

import torch

# the running counter (``hlo_costs._Counter``), set by ``count_costs``
ACTIVE: Any = None


@dataclass(frozen=True)
class KernelCost:
    flops: float  # matrix products (the counter's flops): flash's and ssd_scan's
    bytes: float  # each input read once, each output written once
    ops: float  # every operation the bound counts
    ops_type: str  # their rate: "bfloat16" (tensor cores) or "float32"


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def op_type(t: torch.Tensor) -> str:
    """The rate a kernel's products run at: bf16 on the tensor cores, f32 on
    the scalar units."""
    return "bfloat16" if t.dtype == torch.bfloat16 else "float32"


def counted(name: str, cost: Callable[..., KernelCost]) -> Callable:
    """Wrap a kernel entry: with a counter running, the call reports
    ``cost(*args, **kwargs)`` under ``name`` and hides its own aten ops."""

    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def call(*args, **kwargs):
            counter = ACTIVE
            if counter is None:
                return fn(*args, **kwargs)
            with counter.kernel(name, cost(*args, **kwargs)):
                return fn(*args, **kwargs)

        return call

    return wrap
