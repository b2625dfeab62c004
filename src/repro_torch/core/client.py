"""The BOINC client: resource scheduling and work fetch (§6.1–6.2).

Three interacting policies (Fig. 4): the server's job selection is in
``scheduler.py``; this module implements the client half:

* **Resource scheduling** (§6.1): run a *maximal feasible* set of queued
  jobs. Weighted round-robin by project scheduling priority (linear-bounded
  model), overridden by earliest-deadline-first for jobs the WRR simulation
  predicts will miss their deadlines.
* **Work fetch** (§6.2): per-resource buffer watermarks B_LO/B_HI; the WRR
  simulation yields each resource's **shortfall** and idle-instance count;
  requests go to the highest-priority project with a fetchable resource, and
  piggyback on report RPCs.

The client is driven in virtual time by ``simulator.py`` (EmBOINC-style) or
in wall time by the grid runtime.

This module is the *scalar reference oracle*: ``batch_client.py`` runs the
same WRR simulation, run-set selection, and work-fetch test for a whole
host population in fused NumPy passes, bit-exact with this path
(``tests/test_batch_client.py``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .allocation import LinearBoundedAllocator
from .backoff import ExponentialBackoff
from .scheduler import ResourceRequest
from .types import ResourceType

# ---------------------------------------------------------------------------
# Client-side job & project state
# ---------------------------------------------------------------------------


class RunState:
    UNSTARTED = "unstarted"
    RUNNING = "running"
    PREEMPTED_IN_MEMORY = "preempted_in_memory"
    PREEMPTED = "preempted"
    DONE = "done"


@dataclass
class ClientJob:
    """A job instance as the client sees it (§6.1)."""

    instance_id: int
    job_id: int
    project: str
    app_name: str
    usage: Dict[ResourceType, float]
    est_flops: float  # server estimate of program FLOPS on this host (§6.4)
    est_flop_count: float  # job size estimate (§3.3)
    deadline: float
    est_wss: float = 0.0  # RAM working set (§6.1)
    received_time: float = 0.0  # when the client got the job (reporting, §6.2)
    fraction_done: float = 0.0
    fraction_done_exact: bool = False
    runtime: float = 0.0  # scaled runtime so far
    state: str = RunState.UNSTARTED
    checkpoint_time: float = 0.0  # last checkpoint (virtual time)
    slice_start: float = 0.0
    non_cpu_intensive: bool = False
    deadline_miss: bool = False  # set by WRR simulation

    def static_estimate(self) -> float:
        """Whole-job runtime from size / speed (§6.1)."""
        if self.est_flops <= 0:
            return float("inf")
        return self.est_flop_count / self.est_flops

    def remaining_estimate(self) -> float:
        """Blend static & dynamic estimates by fraction done (§6.1)."""
        static_total = self.static_estimate()
        fd = float(self.fraction_done)
        if fd <= 0.0:
            return static_total
        dynamic_total = self.runtime / fd
        if self.fraction_done_exact:
            total = dynamic_total
        else:
            total = fd * dynamic_total + (1.0 - fd) * static_total
        return max(0.0, total - self.runtime)

    @property
    def uses_gpu(self) -> bool:
        return any(
            r in (ResourceType.GPU, ResourceType.TPU) and u > 0
            for r, u in self.usage.items()
        )

    def cpu_usage(self) -> float:
        return self.usage.get(ResourceType.CPU, 0.0)


@dataclass
class ClientResource:
    rtype: ResourceType
    ninstances: int
    peak_flops: float
    availability: float = 1.0  # measured long-term availability (§6)


@dataclass
class ProjectAttachment:
    name: str
    resource_share: float = 100.0
    suspended: bool = False
    # which resource types the project has app versions for (affects fetchable)
    resource_types: Tuple[ResourceType, ...] = (ResourceType.CPU,)
    backoff: Dict[ResourceType, ExponentialBackoff] = field(default_factory=dict)
    dont_request_work: bool = False
    report_immediately: bool = False

    def backoff_for(self, rtype: ResourceType) -> ExponentialBackoff:
        if rtype not in self.backoff:
            self.backoff[rtype] = ExponentialBackoff()
        return self.backoff[rtype]


@dataclass
class ClientPrefs:
    buffer_lo_days: float = 0.1  # B_LO (§6.2)
    buffer_hi_days: float = 0.5  # B_HI
    cpu_throttle: float = 1.0  # duty cycle (§2.4); 1.0 = no throttling
    ram_limit_fraction: float = 0.9
    time_slice: float = 3600.0  # §6.1 default 1 hour

    @property
    def b_lo(self) -> float:
        return self.buffer_lo_days * 86400.0

    @property
    def b_hi(self) -> float:
        return self.buffer_hi_days * 86400.0


# ---------------------------------------------------------------------------
# WRR simulation (§6.1, Fig. 5)
# ---------------------------------------------------------------------------


@dataclass
class WRRResult:
    deadline_misses: List[int]  # instance_ids predicted to miss under WRR
    shortfall: Dict[ResourceType, float]
    idle_instances: Dict[ResourceType, float]
    queue_dur: Dict[ResourceType, float]
    saturated_until: Dict[ResourceType, float]


def wrr_simulate(
    jobs: Sequence[ClientJob],
    resources: Dict[ResourceType, ClientResource],
    project_priority: Dict[str, float],
    prefs: ClientPrefs,
    now: float,
    ram_bytes: float = float("inf"),
) -> WRRResult:
    """Simulate WRR execution of the queue to predict deadline misses and
    per-resource shortfall (fluid-instance approximation of Fig. 5)."""
    remaining = {j.instance_id: max(j.remaining_estimate(), 1e-9) for j in jobs if j.state != RunState.DONE}
    horizon = prefs.b_hi
    # fluid busy-time accounting per resource
    busy: Dict[ResourceType, float] = {r: 0.0 for r in resources}
    queue_dur: Dict[ResourceType, float] = {r: 0.0 for r in resources}
    misses: List[int] = []
    # WRR ordering: projects by priority, FIFO inside a project (queue order
    # — NOT deadline order: the simulation must mirror what WRR would
    # actually run so that deadline misses are predicted correctly)
    live = [j for j in jobs if j.state != RunState.DONE]
    order = sorted(
        range(len(live)),
        key=lambda i: (-project_priority.get(live[i].project, 0.0), i),
    )
    order = [live[i] for i in order]
    for j in order:
        for r, u in j.usage.items():
            if r in queue_dur and u > 0:
                queue_dur[r] += remaining[j.instance_id]

    t = 0.0
    pending = list(order)
    max_events = 10_000
    for _ in range(max_events):
        if not pending:
            break
        # greedy maximal set in WRR order (§6.1)
        cap = {r: float(res.ninstances) for r, res in resources.items()}
        ram_left = ram_bytes
        running: List[ClientJob] = []
        for j in pending:
            ok = all(cap.get(r, 0.0) >= u - 1e-12 for r, u in j.usage.items() if u > 0)
            if ok and j.est_wss <= ram_left:
                for r, u in j.usage.items():
                    if r in cap:
                        cap[r] -= u
                ram_left -= j.est_wss
                running.append(j)
        if not running:
            break
        dt = min(remaining[j.instance_id] for j in running)
        dt = max(dt, 1e-9)
        for r, res in resources.items():
            used = sum(j.usage.get(r, 0.0) for j in running)
            # only count busy time inside the horizon for shortfall
            within = max(0.0, min(horizon - t, dt))
            busy[r] += min(used, res.ninstances) * within
        t += dt
        done_now = []
        for j in running:
            remaining[j.instance_id] -= dt
            if remaining[j.instance_id] <= 1e-9:
                done_now.append(j)
                if now + t > j.deadline:
                    misses.append(j.instance_id)
        if done_now:
            # drop by instance id: O(pending) per event, and immune to
            # dataclass __eq__ conflating distinct jobs with equal fields
            done_ids = {j.instance_id for j in done_now}
            pending = [j for j in pending if j.instance_id not in done_ids]

    # any jobs never scheduled (infeasible) count as misses
    for j in pending:
        if now + t + remaining[j.instance_id] > j.deadline:
            if j.instance_id not in misses:
                misses.append(j.instance_id)

    shortfall: Dict[ResourceType, float] = {}
    idle: Dict[ResourceType, float] = {}
    saturated: Dict[ResourceType, float] = {}
    for r, res in resources.items():
        cap_time = horizon * res.ninstances
        shortfall[r] = max(0.0, cap_time - busy[r])
        # idle right now: instances unused by the first running set
        used0 = 0.0
        cap0 = {rr: float(rs.ninstances) for rr, rs in resources.items()}
        ram_left = ram_bytes
        for j in order:
            ok = all(cap0.get(rr, 0.0) >= u - 1e-12 for rr, u in j.usage.items() if u > 0)
            if ok and j.est_wss <= ram_left:
                for rr, u in j.usage.items():
                    if rr in cap0:
                        cap0[rr] -= u
                ram_left -= j.est_wss
        idle[r] = max(0.0, cap0.get(r, 0.0))
        saturated[r] = busy[r] / max(res.ninstances, 1)
    return WRRResult(misses, shortfall, idle, queue_dur, saturated)


# ---------------------------------------------------------------------------
# The client
# ---------------------------------------------------------------------------


@dataclass
class WorkRequest:
    project: str
    requests: Dict[ResourceType, ResourceRequest]


@dataclass
class Client:
    host_id: int
    resources: Dict[ResourceType, ClientResource]
    prefs: ClientPrefs = field(default_factory=ClientPrefs)
    projects: Dict[str, ProjectAttachment] = field(default_factory=dict)
    jobs: List[ClientJob] = field(default_factory=list)
    ram_bytes: float = 8e9
    rec: LinearBoundedAllocator = field(default_factory=lambda: LinearBoundedAllocator(default_cap=86400.0 * 10))
    completed: List[ClientJob] = field(default_factory=list)
    reported_pending: List[ClientJob] = field(default_factory=list)
    running: List[ClientJob] = field(default_factory=list)
    n_usable_cpus: int = 0

    # -- attachment --

    def attach(self, project: ProjectAttachment, now: float = 0.0) -> None:
        self.projects[project.name] = project
        self._resplit_shares(now)

    def detach(self, name: str, now: float = 0.0) -> None:
        """Account-manager-driven detach (§2.3): abandon that project's jobs
        and purge every trace of it — queued/running jobs, unreported and
        reported-pending results, and its REC allocator account (leaving the
        row would keep accruing balance and skew the remaining projects'
        relative priorities)."""
        self.projects.pop(name, None)
        self.jobs = [j for j in self.jobs if j.project != name]
        self.running = [j for j in self.running if j.project != name]
        self.completed = [j for j in self.completed if j.project != name]
        self.reported_pending = [j for j in self.reported_pending if j.project != name]
        self.rec.accounts.pop(name, None)
        self._resplit_shares(now)

    def _resplit_shares(self, now: float) -> None:
        """Priority accrues with resource share (linear-bounded, §6.1): the
        attached projects split the total share between them."""
        total_share = sum(p.resource_share for p in self.projects.values())
        for name, p in self.projects.items():
            self.rec.ensure(name, now).rate = p.resource_share / max(total_share, 1e-9)

    def project_priorities(self, now: float) -> Dict[str, float]:
        return {name: self.rec.priority(name, now) for name in self.projects}

    # -- resource scheduling (§6.1) --

    def schedule(self, now: float) -> List[ClientJob]:
        """Choose and return the set of jobs to run (maximal feasible).

        Decomposed so the vectorized population engine
        (``batch_client.BatchClientEngine``) can reuse the mutation steps:
        WRR miss prediction → ``_select_run_set`` (ordering + greedy) →
        ``_apply_run_set`` (run/preempt transitions).
        """
        queued = [j for j in self.jobs if j.state != RunState.DONE]
        if not queued:
            self.running = []
            return []
        prio = self.project_priorities(now)
        sim = wrr_simulate(queued, self.resources, prio, self.prefs, now, self.ram_bytes)
        self._set_miss_flags(queued, set(sim.deadline_misses))
        chosen = self._select_run_set(queued, prio, now)
        return self._apply_run_set(chosen, now)

    # class attr (not a dataclass field): True forces the first sweep, after
    # which it tracks whether any queued job carries a deadline-miss flag
    _any_miss_flags = True

    def _set_miss_flags(self, queued: Sequence[ClientJob], miss_set: set) -> None:
        if not miss_set and not self._any_miss_flags:
            return  # no predicted misses and every flag already False
        any_f = False
        for j in queued:
            f = j.instance_id in miss_set
            j.deadline_miss = f
            any_f = any_f or f
        self._any_miss_flags = any_f

    def _select_run_set(
        self, queued: Sequence[ClientJob], prio: Dict[str, float], now: float
    ) -> List[ClientJob]:
        """§6.1 ordering + greedy maximal feasible set (scalar reference)."""

        def order_key(j: ClientJob):
            in_slice = j.state == RunState.RUNNING and (now - j.slice_start) < self.prefs.time_slice
            unchk = j.state == RunState.RUNNING and j.checkpoint_time <= j.slice_start
            return (
                0 if j.deadline_miss else 1,  # (a) EDF for misses
                j.deadline if j.deadline_miss else 0.0,
                0 if j.uses_gpu else 1,  # (b) GPU before CPU
                0 if (in_slice or unchk) else 1,  # (c) mid-slice / not checkpointed
                -j.cpu_usage(),  # (d) more CPUs first
                -prio.get(j.project, 0.0),  # (e) project priority
            )

        ordered = sorted(queued, key=order_key)
        # greedy maximal feasible set (§6.1 definition)
        ncpu = self.n_usable_cpus or self.resources.get(
            ResourceType.CPU, ClientResource(ResourceType.CPU, 1, 1e9)
        ).ninstances
        cap = {r: float(res.ninstances) for r, res in self.resources.items()}
        cpu_sum_cpu_jobs = 0.0
        cpu_sum_all = 0.0
        ram_left = self.ram_bytes * self.prefs.ram_limit_fraction
        chosen: List[ClientJob] = []
        for j in ordered:
            cu = j.cpu_usage()
            feasible = True
            for r, u in j.usage.items():
                if r == ResourceType.CPU:
                    continue
                if cap.get(r, 0.0) < u - 1e-12:
                    feasible = False
            if not j.uses_gpu and cpu_sum_cpu_jobs + cu > ncpu + 1e-12:
                feasible = False
            if cpu_sum_all + cu > ncpu + 1 + 1e-12:
                feasible = False
            if j.est_wss > ram_left:
                feasible = False
            if j.non_cpu_intensive:
                feasible = True  # always run non-CPU-intensive apps (§3.5)
            if not feasible:
                continue
            for r, u in j.usage.items():
                if r != ResourceType.CPU and r in cap:
                    cap[r] -= u
            if not j.uses_gpu:
                cpu_sum_cpu_jobs += cu
            cpu_sum_all += cu
            ram_left -= j.est_wss
            chosen.append(j)
        return chosen

    def _apply_run_set(self, chosen: List[ClientJob], now: float) -> List[ClientJob]:
        """Apply run/preempt transitions for a computed run set."""
        chosen_ids = {j.instance_id for j in chosen}
        for j in self.running:
            if j.instance_id not in chosen_ids and j.state == RunState.RUNNING:
                # preempt; keep in memory if RAM allows (modelled simply)
                j.state = RunState.PREEMPTED
        for j in chosen:
            if j.state != RunState.RUNNING:
                j.state = RunState.RUNNING
                j.slice_start = now
        self.running = chosen
        return chosen

    # -- execution accounting (driven by the simulator / runtime) --

    def debit_usage(self, job: ClientJob, dt: float, now: float) -> None:
        """Charge ``dt`` seconds of *executed* time on ``job`` to its
        project's REC account (§6.1) — the accounting formula shared by
        ``advance`` (which passes throttle-scaled time, §2.4) and the
        simulator's execution path (which runs jobs at full speed and so
        passes raw dt)."""
        self.rec.debit(job.project, dt * max(sum(job.usage.values()), 1.0), now)

    def advance(self, dt: float, now: float) -> List[ClientJob]:
        """Advance running jobs by scaled time ``dt``; returns completions."""
        done: List[ClientJob] = []
        for j in self.running:
            if j.state != RunState.RUNNING:
                continue
            eff_dt = dt * self.prefs.cpu_throttle  # CPU throttling (§2.4)
            j.runtime += eff_dt
            total = j.static_estimate()
            if total <= 0 or math.isinf(total):
                continue
            j.fraction_done = min(1.0, j.runtime / total)
            self.debit_usage(j, eff_dt, now)
            if j.fraction_done >= 1.0:
                j.state = RunState.DONE
                done.append(j)
        if done:
            done_ids = {j.instance_id for j in done}
            self.jobs = [j for j in self.jobs if j.instance_id not in done_ids]
            self.running = [j for j in self.running if j.instance_id not in done_ids]
            self.completed.extend(done)
        return done

    def checkpoint_tick(self, now: float, period: float = 300.0) -> None:
        """Client asks running apps to checkpoint every few minutes (§3.6)."""
        for j in self.running:
            if now - j.checkpoint_time >= period:
                j.checkpoint_time = now

    # -- work fetch (§6.2) --

    def needs_work(
        self, now: float, sim: Optional[WRRResult] = None
    ) -> Dict[ResourceType, ResourceRequest]:
        if sim is None:
            queued = [j for j in self.jobs if j.state != RunState.DONE]
            prio = self.project_priorities(now)
            sim = wrr_simulate(queued, self.resources, prio, self.prefs, now, self.ram_bytes)
        return self._requests_from_sim(sim)

    def _requests_from_sim(self, sim: WRRResult) -> Dict[ResourceType, ResourceRequest]:
        """Buffer-watermark test (§6.2) over a WRR simulation result."""
        out: Dict[ResourceType, ResourceRequest] = {}
        for r, res in self.resources.items():
            needs = sim.saturated_until.get(r, 0.0) < self.prefs.b_lo
            if needs:
                out[r] = ResourceRequest(
                    req_runtime=sim.shortfall.get(r, 0.0),
                    req_idle=sim.idle_instances.get(r, 0.0),
                    queue_dur=sim.queue_dur.get(r, 0.0),
                )
        return out

    def fetchable(self, project: ProjectAttachment, rtype: ResourceType, now: float) -> bool:
        if project.suspended or project.dont_request_work:
            return False
        if rtype not in project.resource_types:
            return False
        if not project.backoff_for(rtype).ready(now):
            return False
        return True

    def choose_fetch_project(
        self, now: float, needs: Optional[Dict[ResourceType, ResourceRequest]] = None
    ) -> Optional[WorkRequest]:
        """The work-fetch policy (§6.2): highest-priority project with a
        fetchable resource that needs replenishment. ``needs`` may be
        precomputed (the batched engine runs one fused WRR pass per tick)."""
        if needs is None:
            needs = self.needs_work(now)
        if not needs:
            return None
        prio = self.project_priorities(now)
        for name in sorted(self.projects, key=lambda n: -prio.get(n, 0.0)):
            p = self.projects[name]
            if any(self.fetchable(p, r, now) for r in needs):
                reqs = {
                    r: rr
                    for r, rr in needs.items()
                    if self.fetchable(p, r, now)
                }
                if reqs:
                    return WorkRequest(project=name, requests=reqs)
        return None

    def piggyback_request(
        self,
        project: str,
        now: float,
        needs: Optional[Dict[ResourceType, ResourceRequest]] = None,
    ) -> Dict[ResourceType, ResourceRequest]:
        """When RPCing ``project`` for other reasons, attach a work request
        for each resource where it is the top fetchable project (§6.2)."""
        if needs is None:
            needs = self.needs_work(now)
        out: Dict[ResourceType, ResourceRequest] = {}
        prio = self.project_priorities(now)
        p = self.projects.get(project)
        if p is None:
            return out
        ranked = sorted(self.projects, key=lambda n: -prio.get(n, 0.0))
        for r, rr in needs.items():
            top = next((n for n in ranked if self.fetchable(self.projects[n], r, now)), None)
            if top == project:
                out[r] = rr
        return out

    # -- reporting policy (§6.2) --

    def should_report(self, project: str, now: float, batch_threshold: int = 4) -> bool:
        pend = [j for j in self.completed if j.project == project]
        if not pend:
            return False
        p = self.projects.get(project)
        if p is not None and p.report_immediately:
            return True
        if len(pend) >= batch_threshold:
            return True
        # report when a deadline approaches (§6.2). The window is *relative*
        # to the job's own deadline allowance (deadline - received_time):
        # comparing against 0.1 × the absolute virtual-time deadline made
        # every completion report immediately once now grew past ~90% of the
        # deadline value, silently defeating report batching in long runs.
        soonest = min(pend, key=lambda j: j.deadline)
        window = max(3600.0, 0.1 * max(soonest.deadline - soonest.received_time, 0.0))
        return now >= soonest.deadline - window

    def take_completed(self, project: str) -> List[ClientJob]:
        out = [j for j in self.completed if j.project == project]
        self.completed = [j for j in self.completed if j.project != project]
        return out

    # -- account-manager support (§2.3) --

    def apply_am_reply(self, attach: Sequence[ProjectAttachment], detach: Sequence[str], now: float = 0.0) -> None:
        for name in detach:
            self.detach(name, now)
        for p in attach:
            if p.name not in self.projects:
                self.attach(p, now)
