"""Distributed tooling of the port; counterpart of ``repro.distributed``:
fleet-level fault tolerance (a copy: pure Python), the sharding rules and
logical-axis constraints, the cost counter (``hlo_costs``: the port has no
HLO; it counts a step's aten ops and kernel calls) with its analysis, and
the three-term roofline on the H100's constants. The rules resolve for
every mesh, and place the sharded train step's DTensors on a mesh of more
than one device; the dry run lowers the steps of one device, so the
reference's collective statistics come with the production meshes."""
from .fault_tolerance import (
    ElasticPlan,
    HeartbeatMonitor,
    StragglerPolicy,
    candidate_meshes,
    plan_elastic_config,
)
from .hlo_analysis import (
    cost_analysis_bytes,
    cost_analysis_flops,
    memory_analysis_dict,
    op_census,
)
from .roofline import DCN_BW, HBM_BW, ICI_BW, PEAK_FLOPS_BF16, RooflineTerms
from .sharding import (
    DEFAULT_RULES,
    ShardingRules,
    batch_specs,
    make_rules,
    opt_state_specs,
    param_specs,
    shardings_from_specs,
    tree_specs_from_axes,
)

__all__ = [
    "DCN_BW",
    "DEFAULT_RULES",
    "ElasticPlan",
    "HBM_BW",
    "HeartbeatMonitor",
    "ICI_BW",
    "PEAK_FLOPS_BF16",
    "RooflineTerms",
    "ShardingRules",
    "StragglerPolicy",
    "batch_specs",
    "candidate_meshes",
    "cost_analysis_bytes",
    "cost_analysis_flops",
    "make_rules",
    "memory_analysis_dict",
    "op_census",
    "opt_state_specs",
    "param_specs",
    "plan_elastic_config",
    "shardings_from_specs",
    "tree_specs_from_axes",
]
