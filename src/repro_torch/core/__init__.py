"""BOINC core middleware, the port's own copy of ``repro.core``.

The modules are the reference's, verbatim apart from the engine backends:
``backend.resolve_backend`` accepts ``"numpy"`` only, and the reference's
``backend="jax"`` branches are gone. The copies stay plain Python and NumPy;
the grid trainer's gradient payloads are the only tensors that pass through
them. ``scenarios`` and ``coordinator`` are not copied: nothing the trainer
runs needs them.

Layout (paper section in parens):
  types        — projects/hosts/apps/app-versions/plan-classes/jobs (§2, §3)
  backoff      — exponential backoff (§2.2)
  keywords     — keyword hierarchies & prefs (§2.4)
  store        — the job database + ID-space daemon sharding (§5.1)
  fsm          — transitioner: job lifecycle FSM (§4)
  validator    — replication validation, HR classes, payload digests (§3.4)
  adaptive     — adaptive replication reputations, array-backed (§3.4)
  batch_validate — vectorized validation→credit→reputation engine (§3.4, §7)
  estimation   — runtime estimation / proj_flops (§6.3)
  credit       — PFC credit + normalizations + cross-project (§7)
  allocation   — linear-bounded allocation model (§3.9)
  defense      — work-spreading / HR census / host punishment (§3.4)
  scheduler    — feeder, job cache, dispatch policy (§5.1, §6.4)
  shard        — host→shard affinity, cache-slot ownership, migration (§5.1)
  batch_dispatch — vectorized slots×hosts batch scoring engine (§5.1, §6.4)
  client       — WRR/EDF resource scheduling + work fetch (§6.1–6.2)
  batch_client — vectorized host-population client engine (§6.1–6.2, §9)
  world        — columnar host-population state (§9)
  server       — project-server facade w/ daemon set (§5.1)
  simulator    — EmBOINC-style virtual-time emulator (§9)
"""
from .adaptive import AdaptiveReplication
from .allocation import LinearBoundedAllocator
from .backoff import ExponentialBackoff
from .batch_client import BatchClientEngine
from .batch_dispatch import BatchDispatchEngine
from .batch_validate import BatchValidationEngine
from .client import Client, ClientJob, ClientPrefs, ClientResource, ProjectAttachment
from .credit import CreditSystem, peak_flop_count
from .defense import DefenseLayer, DefensePolicy
from .estimation import RuntimeEstimator
from .fsm import Transitioner
from .keywords import KeywordPrefs, keyword_score
from .scheduler import (
    Candidate,
    CompletedResult,
    Feeder,
    ResourceRequest,
    ScheduleReply,
    ScheduleRequest,
    Scheduler,
)
from .server import ProjectServer
from .shard import ShardMap, ShardPolicy, ShardStats
from .simulator import GridSimulation, HostSpec, SimMetrics, make_population
from .store import JobStore
from .types import (
    App,
    AppVersion,
    Batch,
    HRLevel,
    Host,
    InstanceOutcome,
    InstanceState,
    Job,
    JobInstance,
    JobState,
    Platform,
    PlanClass,
    ProcessingResource,
    ResourceType,
    ValidateState,
    default_cpu_plan_class,
    gpu_plan_class,
    hr_class,
    next_id,
    reset_ids,
)
from .validator import (
    bitwise_digest_batch,
    bitwise_equal,
    check_set,
    digest_batch_for,
    fuzzy_comparator,
)
from .world import ExpDrawCache, HostArrays

__all__ = [
    "AdaptiveReplication",
    "App",
    "AppVersion",
    "Batch",
    "BatchClientEngine",
    "BatchDispatchEngine",
    "BatchValidationEngine",
    "Candidate",
    "Client",
    "ClientJob",
    "ClientPrefs",
    "ClientResource",
    "CompletedResult",
    "CreditSystem",
    "DefenseLayer",
    "DefensePolicy",
    "ExpDrawCache",
    "ExponentialBackoff",
    "Feeder",
    "GridSimulation",
    "HRLevel",
    "Host",
    "HostArrays",
    "HostSpec",
    "InstanceOutcome",
    "InstanceState",
    "Job",
    "JobInstance",
    "JobState",
    "JobStore",
    "KeywordPrefs",
    "LinearBoundedAllocator",
    "Platform",
    "PlanClass",
    "ProcessingResource",
    "ProjectAttachment",
    "ProjectServer",
    "ResourceRequest",
    "ResourceType",
    "RuntimeEstimator",
    "ScheduleReply",
    "ScheduleRequest",
    "Scheduler",
    "ShardMap",
    "ShardPolicy",
    "ShardStats",
    "SimMetrics",
    "Transitioner",
    "ValidateState",
    "bitwise_digest_batch",
    "bitwise_equal",
    "check_set",
    "default_cpu_plan_class",
    "digest_batch_for",
    "fuzzy_comparator",
    "gpu_plan_class",
    "hr_class",
    "keyword_score",
    "make_population",
    "next_id",
    "peak_flop_count",
    "reset_ids",
]
