"""Fleet-level fault tolerance of the port; counterpart of the part of
``repro.distributed`` that ``distributed/fault_tolerance.py`` holds (a copy:
pure Python). The reference's HLO, roofline and sharding modules read
XLA's programs and are not ported yet."""
from .fault_tolerance import (
    ElasticPlan,
    HeartbeatMonitor,
    StragglerPolicy,
    candidate_meshes,
    plan_elastic_config,
)

__all__ = [
    "ElasticPlan",
    "HeartbeatMonitor",
    "StragglerPolicy",
    "candidate_meshes",
    "plan_elastic_config",
]
