"""Step analysis for the dry run: op census, costs, memory; counterpart of
``repro.distributed.hlo_analysis``.

The reference reads these from XLA's compiled module. The port reads them
from the record ``StepBundle.lower()`` returns (``runtime.step_builder``):
the step run once on the meta device under ``hlo_costs.counting``. The dry
run lowers the steps of one device, so the reference's collective
statistics come with the production meshes (ROADMAP.md, Queue A 10b.2).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict


def op_census(hlo_text: Any) -> Dict[str, int]:
    """aten ops by name, as the counter saw them: remat duplicates and copy
    storms show here. ``hlo_text`` keeps the reference's name; the port has
    no HLO, and takes a lowered step or its ``ModuleCosts``."""
    return dict(getattr(hlo_text, "costs", hlo_text).census)


def cost_analysis_flops(compiled: Any) -> float:
    """``compiled``: the lowered step (``StepBundle.lower()``), the port's
    counterpart of XLA's compiled module."""
    return float(compiled.costs.flops)


def cost_analysis_bytes(compiled: Any) -> float:
    return float(compiled.costs.bytes)


def memory_analysis_dict(compiled: Any) -> Dict[str, float]:
    """The reference's ``*_size_in_bytes`` fields of a lowered step."""
    return {k: float(v) for k, v in dataclasses.asdict(compiled.memory).items()}
