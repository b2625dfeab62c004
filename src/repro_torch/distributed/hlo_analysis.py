"""Step analysis for the dry run: op census, costs, memory; counterpart of
``repro.distributed.hlo_analysis``.

The reference reads these from XLA's compiled module. The port reads them
from the record ``StepBundle.lower()`` returns (``runtime.step_builder``):
the step run once on the meta device under ``hlo_costs.counting``. A step
of the port runs on one device, so the reference's collective statistics
come with the sharded step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict


def op_census(lowered: Any) -> Dict[str, int]:
    """aten ops by name, as the counter saw them (a lowered step or its
    ``ModuleCosts``): remat duplicates and copy storms show here."""
    return dict(getattr(lowered, "costs", lowered).census)


def cost_analysis_flops(lowered: Any) -> float:
    return float(lowered.costs.flops)


def cost_analysis_bytes(lowered: Any) -> float:
    return float(lowered.costs.bytes)


def memory_analysis_dict(lowered: Any) -> Dict[str, float]:
    """The reference's ``*_size_in_bytes`` fields of a lowered step."""
    return {k: float(v) for k, v in dataclasses.asdict(lowered.memory).items()}
