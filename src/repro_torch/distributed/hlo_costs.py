"""Whole-step cost counter; counterpart of ``repro.distributed.hlo_costs``.

The reference parses XLA's optimized HLO. The port runs eagerly and has no
HLO: ``count_costs`` runs the step once under a ``TorchDispatchMode`` and
counts what its aten ops and its hand-written kernels do:

  flops       — matrix products only, as the reference counts ``dot``s only:
                ``mm``, ``addmm``, ``bmm`` and ``baddbmm`` (the ``bmm``s an
                ``einsum`` dispatches to among them) by
                ``torch.utils.flop_counter``'s formulas, plus each kernel
                call's products by its own formula (flash attention's
                scores and output, ssd_scan's chunk products)
  bytes       — operand and output bytes of every aten op that
                materializes a tensor (views and factories such as
                ``empty`` are free), plus each kernel call's bytes: the
                eager port's own traffic, not the reference's fused figure

The reference's collective bytes and while-loop trip counts have no field:
the dry run lowers the steps of one device (the sharded step's collectives
are counted with the production meshes, ROADMAP.md Queue A 10b.2), and
eager layer loops run unrolled, so every trip is counted as it runs.

The kernels run through ``ctypes``, so each wrapper reports its call
(``repro_torch.kernels._costs``) and the counter ignores the aten ops run
inside it: a step counts the same on the meta device, the CPU (the plain
versions) and the card. The counter also follows the storages the step
allocates and keeps the largest sum of those alive at once (``peak_bytes``,
the dry run's ``temp_size_in_bytes``), and counts every aten op by name
(``census``, for ``hlo_analysis.op_census``).
"""
from __future__ import annotations

import contextlib
import weakref
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.distributed.roofline import kernel_bound_s
from repro_torch.kernels import _costs
from repro_torch.kernels._costs import KernelCost

_aten = torch.ops.aten
# the matrix products, as the reference's ``dot``
_DOT_PACKETS = (_aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm)
_DOT_FORMULAS = {p: flop_registry[p] for p in _DOT_PACKETS}
# free besides the views and the factories with no tensor operand: a view the
# schema does not mark as one, and the factories that read only a shape
_FREE_OPS = {
    _aten._unsafe_view.default,
    _aten.empty_like.default,
    _aten.zeros_like.default,
    _aten.ones_like.default,
    _aten.full_like.default,
    _aten.new_empty.default,
    _aten.new_zeros.default,
    _aten.new_ones.default,
    _aten.new_full.default,
}


@dataclass
class KernelTotals:
    calls: int = 0
    flops: float = 0.0
    bytes: float = 0.0
    bound_s: float = 0.0  # the calls' least time on the card (``roofline.kernel_bound_s``)


@dataclass
class ModuleCosts:
    flops: float = 0.0
    bytes: float = 0.0
    # the hand-written kernels' calls, by wrapper entry
    kernels: Dict[str, KernelTotals] = field(default_factory=dict)
    # aten ops by name (hidden kernel internals excluded), and their bytes
    census: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    bytes_by_op: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    # the most bytes of storages allocated during the run alive at once
    peak_bytes: int = 0


def tensors_in(x: Any) -> List[torch.Tensor]:
    """The tensors in an op's arguments or results, or in a step's argument
    tree (lists, tuples and dicts searched)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for item in x for t in tensors_in(item)]
    if isinstance(x, dict):
        return [t for item in x.values() for t in tensors_in(item)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Counter(TorchDispatchMode):
    def __init__(self) -> None:
        super().__init__()
        self.costs = ModuleCosts()
        self.hidden = 0  # depth of kernel calls in progress
        self._live: Dict[int, int] = {}  # storage -> bytes, for those the run allocated
        self._live_bytes = 0

    @contextlib.contextmanager
    def kernel(self, name: str, cost: KernelCost) -> Iterator[None]:
        """A kernel call: its formula counts once, its own aten ops not."""
        if not self.hidden:
            tot = self.costs.kernels.setdefault(name, KernelTotals())
            tot.calls += 1
            tot.flops += cost.flops
            tot.bytes += cost.bytes
            tot.bound_s += kernel_bound_s(cost)
            self.costs.flops += cost.flops
            self.costs.bytes += cost.bytes
        self.hidden += 1
        try:
            yield
        finally:
            self.hidden -= 1

    def _free(self, key: int) -> None:
        self._live_bytes -= self._live.pop(key, 0)

    def _track(self, inputs: List[torch.Tensor], outputs: List[torch.Tensor]) -> None:
        """Follow the new storages among ``outputs`` until they are freed."""
        seen = {t.untyped_storage()._cdata for t in inputs}
        for t in outputs:
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self._live:
                continue
            size = st.nbytes()
            self._live[key] = size
            self._live_bytes += size
            weakref.finalize(st, self._free, key)
        self.costs.peak_bytes = max(self.costs.peak_bytes, self._live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        inputs, outputs = tensors_in(args) + tensors_in(kwargs), tensors_in(out)
        if not func.is_view:
            self._track(inputs, outputs)
        if self.hidden:
            return out
        name = str(func.overloadpacket)
        costs = self.costs
        costs.census[name] += 1
        if func.is_view or func in _FREE_OPS or not inputs or not outputs:
            return out
        formula = _DOT_FORMULAS.get(func.overloadpacket)
        if formula is not None:
            costs.flops += formula(*args, **kwargs, out_val=out)
        moved = sum(_nbytes(t) for t in inputs) + sum(_nbytes(t) for t in outputs)
        costs.bytes += moved
        costs.bytes_by_op[name] += moved
        return out


@contextlib.contextmanager
def counting() -> Iterator[ModuleCosts]:
    """Count everything run inside the block; the costs are complete when it
    ends. Counters do not nest."""
    if _costs.ACTIVE is not None:
        raise RuntimeError("count_costs is already running")
    counter = _Counter()
    _costs.ACTIVE = counter
    try:
        with counter:
            yield counter.costs
    finally:
        _costs.ACTIVE = None


def count_costs(fn: Callable[..., Any], *args: Any, **kwargs: Any) -> ModuleCosts:
    """Run ``fn(*args, **kwargs)`` once and return what it cost."""
    with counting() as costs:
        fn(*args, **kwargs)
    return costs
