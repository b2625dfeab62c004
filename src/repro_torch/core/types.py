"""Core datatypes for the BOINC-JAX middleware layer.

Faithful to the abstractions in Anderson, "BOINC: A Platform for Volunteer
Computing" (2019): projects, hosts, platforms, apps, app versions, plan
classes, jobs (workunits) and job instances (results).

The names follow the paper's terminology (section references in docstrings).
Everything here is plain host-side Python: these objects describe *work*, not
tensors. The tensor layer plugs in through ``App.execute`` payloads (see
``repro_torch.runtime.grid_runtime``).
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Resources and platforms (§3.1, §6.1)
# ---------------------------------------------------------------------------


class ResourceType(enum.Enum):
    """A processing-resource type on a host (§6.1)."""

    CPU = "cpu"
    GPU = "gpu"
    TPU = "tpu"  # hardware adaptation: TPU slices are first-class resources


@dataclass(frozen=True)
class Platform:
    """A (processor type, operating system) pair (§3.1)."""

    os: str  # "windows" | "mac" | "linux" | "android" | "tpu-vm"
    arch: str  # "x86_64" | "arm64" | "tpu-v5e" | ...

    @property
    def name(self) -> str:
        return f"{self.os}-{self.arch}"


@dataclass
class ProcessingResource:
    """A pool of identical processing-resource instances on one host (§6.1)."""

    rtype: ResourceType
    ninstances: int
    peak_flops: float  # per instance; Whetstone for CPUs, vendor est for GPUs
    availability: float = 1.0  # long-term fraction of time usable (§6)
    model: str = "generic"
    driver_version: int = 0

    @property
    def total_peak_flops(self) -> float:
        return self.ninstances * self.peak_flops


@dataclass
class Host:
    """A volunteer device / worker node (§2.1).

    In the TPU adaptation a Host is a slice (worker group); ``platforms``
    then contains e.g. Platform("tpu-vm", "tpu-v5e").
    """

    id: int
    platforms: Tuple[Platform, ...]
    resources: Dict[ResourceType, ProcessingResource]
    os_version: str = ""
    cpu_vendor: str = "genuineintel"
    cpu_model: str = "generic"
    ram_bytes: float = 8e9
    disk_free_bytes: float = 100e9
    # Fraction of wall time the host is on & BOINC allowed to compute (§6).
    on_fraction: float = 1.0
    # Owner/account linkage (cross-project credit, §7).
    volunteer_id: int = 0
    n_usable_cpus: int = 0  # 0 => all instances usable
    # Hardware adaptation: numeric determinism class inputs.
    xla_version: str = ""
    deterministic_reductions: bool = True

    def usable_cpus(self) -> int:
        cpu = self.resources.get(ResourceType.CPU)
        if cpu is None:
            return 0
        if self.n_usable_cpus <= 0:
            return cpu.ninstances
        return min(self.n_usable_cpus, cpu.ninstances)

    def peak_flops(self, usage: Dict[ResourceType, float]) -> float:
        """Peak FLOPS of a job with the given per-resource usage (§6.3)."""
        total = 0.0
        for rtype, amount in usage.items():
            res = self.resources.get(rtype)
            if res is not None:
                total += amount * res.peak_flops
        return total

    def supports_platform(self, platform: Platform) -> bool:
        return platform in self.platforms


# ---------------------------------------------------------------------------
# Homogeneous redundancy (§3.4)
# ---------------------------------------------------------------------------


class HRLevel(enum.IntEnum):
    """Homogeneous-redundancy equivalence granularity (§3.4)."""

    NONE = 0
    COARSE = 1  # (OS family, CPU vendor)
    FINE = 2  # + CPU model

    # Hardware adaptation: TPU fleets group by (generation, XLA version,
    # deterministic-reduction flag) — same root cause (FP non-determinism).
    NUMERIC_CLASS = 3


def hr_class(host: Host, level: HRLevel) -> Tuple:
    """Equivalence class of ``host`` at ``level``; jobs validated by byte
    comparison are only co-scheduled within one class (§3.4)."""
    if level == HRLevel.NONE:
        return ()
    if level == HRLevel.COARSE:
        return (host.platforms[0].os, host.cpu_vendor)
    if level == HRLevel.FINE:
        return (host.platforms[0].os, host.cpu_vendor, host.cpu_model)
    if level == HRLevel.NUMERIC_CLASS:
        return (host.platforms[0].arch, host.xla_version, host.deterministic_reductions)
    raise ValueError(f"unknown HR level {level}")


# ---------------------------------------------------------------------------
# Apps, app versions, plan classes (§3.1)
# ---------------------------------------------------------------------------


#: A plan-class function (§3.1): Host -> None (reject) or (usage, peak_flops).
PlanClassFn = Callable[[Host], Optional[Tuple[Dict[ResourceType, float], float]]]


@dataclass
class PlanClass:
    """Fine-grained app-version applicability (§3.1).

    ``fn`` returns, for an accepting host, the per-resource usage (possibly
    fractional) and the resulting peak FLOPS.
    """

    name: str
    fn: PlanClassFn

    def evaluate(self, host: Host) -> Optional[Tuple[Dict[ResourceType, float], float]]:
        return self.fn(host)


def default_cpu_plan_class(ncpus: float = 1.0) -> PlanClass:
    def fn(host: Host):
        cpu = host.resources.get(ResourceType.CPU)
        if cpu is None or host.usable_cpus() < ncpus:
            return None
        usage = {ResourceType.CPU: ncpus}
        return usage, ncpus * cpu.peak_flops

    return PlanClass(name=f"cpu{ncpus:g}", fn=fn)


def gpu_plan_class(min_driver: int = 0, gpu_usage: float = 1.0, cpu_usage: float = 0.1) -> PlanClass:
    def fn(host: Host):
        gpu = host.resources.get(ResourceType.GPU)
        if gpu is None or gpu.driver_version < min_driver:
            return None
        usage = {ResourceType.GPU: gpu_usage, ResourceType.CPU: cpu_usage}
        cpu = host.resources.get(ResourceType.CPU)
        pf = gpu_usage * gpu.peak_flops + (cpu.peak_flops * cpu_usage if cpu else 0.0)
        return usage, pf

    return PlanClass(name=f"gpu{gpu_usage:g}", fn=fn)


@dataclass
class AppVersion:
    """One build of an app for a (platform, plan class) (§3.1).

    In the TPU adaptation an AppVersion is a *compiled executable*: a
    (mesh shape, sharding rules, precision) variant of a jitted step.
    """

    id: int
    app_name: str
    platform: Platform
    version_num: int
    plan_class: PlanClass
    files: Tuple[str, ...] = ()
    # Payload executed by the grid runtime; signature (job, host) -> output.
    execute: Optional[Callable[["Job", Host], Any]] = None

    def key(self) -> Tuple[str, str, str]:
        return (self.app_name, self.platform.name, self.plan_class.name)


@dataclass
class App:
    """An application: a set of app versions for one program (§3.1)."""

    name: str
    min_quorum: int = 2
    init_ninstances: int = 2
    max_error_instances: int = 3
    max_success_instances: int = 6
    delay_bound: float = 14 * 86400.0
    # Validation configuration (§3.4).
    hr_level: HRLevel = HRLevel.NONE
    homogeneous_app_version: bool = False
    adaptive_replication: bool = False
    # Comparator: (out_a, out_b) -> bool. None => bitwise equality.
    comparator: Optional[Callable[[Any, Any], bool]] = None
    non_cpu_intensive: bool = False
    uses_locality: bool = False
    multi_size: bool = False
    n_size_classes: int = 1
    # Jobs always use dynamic runtime estimate (fixed-iteration apps, §6.1).
    fraction_done_exact: bool = False
    versions: List[AppVersion] = field(default_factory=list)
    keywords: Tuple[str, ...] = ()

    def add_version(self, version: AppVersion) -> None:
        assert version.app_name == self.name
        self.versions.append(version)

    def latest_versions(self) -> List[AppVersion]:
        """Latest version per (platform, plan class) (§3.1)."""
        best: Dict[Tuple[str, str, str], AppVersion] = {}
        for v in self.versions:
            k = v.key()
            if k not in best or v.version_num > best[k].version_num:
                best[k] = v
        return list(best.values())


# ---------------------------------------------------------------------------
# Jobs and instances (§3.3, §4)
# ---------------------------------------------------------------------------


class IndexObserved:
    """Mixin: notify the owning :class:`~repro_torch.core.store.JobStore` when an
    indexed field is assigned.

    The store's §5.1 "DB indexes" (state sets, pending queues, the deadline
    heap) are maintained *at mutation time*. Concurrent daemons — and tests —
    mutate rows by plain attribute assignment (``inst.state = ...``,
    ``job.transition_flag = True``), exactly like UPDATEs against the real
    MySQL schema, so the hook lives here rather than in store methods: any
    assignment to a field named in ``_TRACKED`` is forwarded to
    ``store._on_field_change``. Rows not attached to a store (``_store``
    unset) behave as plain dataclasses.
    """

    _TRACKED = frozenset()

    def __setattr__(self, name: str, value: Any) -> None:
        if name in self._TRACKED:
            store = self.__dict__.get("_store")
            if store is not None:
                old = self.__dict__.get(name)
                object.__setattr__(self, name, value)
                if old != value:
                    store._on_field_change(self, name, old, value)
                return
        object.__setattr__(self, name, value)


class JobState(enum.Enum):
    ACTIVE = "active"  # instances outstanding or validation pending
    SUCCESS = "success"  # canonical instance found & assimilated
    FAILURE = "failure"  # error/success limits exceeded
    PURGED = "purged"  # removed from DB (§4)


class InstanceState(enum.Enum):
    UNSENT = "unsent"
    IN_PROGRESS = "in_progress"
    OVER = "over"


class InstanceOutcome(enum.Enum):
    INIT = "init"
    SUCCESS = "success"
    CLIENT_ERROR = "client_error"
    NO_REPLY = "no_reply"  # deadline passed (§4)
    ABANDONED = "abandoned"  # host detached / churned
    CANCELLED = "cancelled"  # unsent instance cancelled after canonical found
    VALIDATE_ERROR = "validate_error"


class ValidateState(enum.Enum):
    INIT = "init"
    VALID = "valid"
    INVALID = "invalid"
    INCONCLUSIVE = "inconclusive"


@dataclass
class Job(IndexObserved):
    """A workunit (§3.3). Instances of it are dispatched to hosts."""

    _TRACKED = frozenset({"state", "transition_flag", "assimilated", "files_deleted"})

    id: int
    app_name: str
    est_flop_count: float  # a-priori size estimate (§6.3)
    max_flop_count: float = 0.0  # abort infinite loops (§3.3)
    ram_bytes: float = 0.0  # working-set estimate, job selection (§6.4)
    disk_bytes: float = 0.0  # upper bound (§3.3)
    delay_bound: float = 14 * 86400.0  # §4
    min_quorum: int = 2
    init_ninstances: int = 2
    max_error_instances: int = 3
    max_success_instances: int = 6
    keywords: Tuple[str, ...] = ()
    input_files: Tuple[str, ...] = ()
    size_class: int = 0  # multi-size jobs (§3.5)
    target_host: Optional[int] = None  # targeted jobs (§3.5)
    pinned_version_num: Optional[int] = None  # version pinning (§3.5)
    submitter: str = "default"
    batch_id: int = 0
    priority: float = 0.0
    created_time: float = 0.0
    # Ground-truth payload for emulation: what a correct execution returns.
    payload: Any = None

    # -- server-side state (§4) --
    state: JobState = JobState.ACTIVE
    canonical_instance_id: Optional[int] = None
    hr_class: Optional[Tuple] = None  # locked after first dispatch (§3.4)
    hav_version_id: Optional[int] = None  # homogeneous app version lock
    assimilated: bool = False
    files_deleted: bool = False
    transition_flag: bool = True  # set by concurrent daemons; cleared by transitioner
    error_mask: int = 0


@dataclass
class JobInstance(IndexObserved):
    """A job instance / result (§3.3, §4)."""

    _TRACKED = frozenset({"state", "deadline", "host_id", "outcome", "validate_state"})

    id: int
    job_id: int
    state: InstanceState = InstanceState.UNSENT
    outcome: InstanceOutcome = InstanceOutcome.INIT
    validate_state: ValidateState = ValidateState.INIT
    host_id: Optional[int] = None
    # volunteer of record, captured by the store when host_id is assigned:
    # the one-instance-per-volunteer rule (§6.4) keys on this
    volunteer_id: Optional[int] = None
    app_version_id: Optional[int] = None
    sent_time: float = 0.0
    deadline: float = 0.0
    received_time: float = 0.0
    runtime: float = 0.0  # raw runtime (§6)
    peak_flop_count: float = 0.0  # PFC (§7)
    output: Any = None
    stderr: str = ""
    exit_code: int = 0
    claimed_credit: float = 0.0
    granted_credit: float = 0.0

    def is_outstanding(self) -> bool:
        return self.state in (InstanceState.UNSENT, InstanceState.IN_PROGRESS)


# ---------------------------------------------------------------------------
# Batches & submitters (§3.9)
# ---------------------------------------------------------------------------


@dataclass
class Batch:
    id: int
    submitter: str
    job_ids: List[int] = field(default_factory=list)
    created_time: float = 0.0
    completed_time: Optional[float] = None


_id_counters: Dict[str, itertools.count] = {}


def next_id(kind: str) -> int:
    """Process-wide monotonically increasing IDs per entity kind."""
    if kind not in _id_counters:
        _id_counters[kind] = itertools.count(1)
    return next(_id_counters[kind])


def reset_ids() -> None:
    """Reset ID counters (tests / simulator determinism)."""
    _id_counters.clear()


def clone_job(job: Job, **overrides: Any) -> Job:
    return dataclasses.replace(job, **overrides)
