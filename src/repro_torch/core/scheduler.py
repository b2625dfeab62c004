"""Server-side job dispatch (§5.1 server architecture, §6.3–6.4 policy).

Architecture (§5.1): scheduler instances never scan the DB for dispatchable
work; a shared-memory **job cache** of ~1000 unsent instances is replenished
by a **feeder** daemon. The scheduler scans the cache (random start point to
reduce lock conflict), scores candidates, re-checks under a mutex ("fast
check"), then against the DB ("slow check"), and builds the reply. This is
what lets one server dispatch hundreds of jobs per second [paper ref 17] —
reproduced in ``benchmarks/bench_dispatch.py``.

Policy (§6.4): GPUs handled first; app-version selection by max
``proj_flops`` among (platform, plan-class, HR)-compatible versions; score =
weighted sum of keyword match, submitter allocation balance, skipped-before,
locality, size-quantile match; fast checks = disk / deadline-feasibility /
duplicate-in-reply; slow checks = one-instance-per-volunteer / job errored /
HR class.

Two dispatch engines implement the policy: the scalar per-request path here
(``handle_request``, the reference oracle) and the vectorized batch path
(``handle_batch`` + ``batch_dispatch.BatchDispatchEngine``), which scores
all cache slots × a batch of hosts in fused NumPy passes. The two are
result-identical (see ``tests/test_batch_dispatch.py``).
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .adaptive import AdaptiveReplication
from .allocation import LinearBoundedAllocator
from .defense import DefenseLayer
from .estimation import RuntimeEstimator
from .keywords import KeywordPrefs, keyword_score
from .shard import ShardMap
from .store import JobStore
from .types import (
    App,
    AppVersion,
    HRLevel,
    Host,
    InstanceOutcome,
    InstanceState,
    Job,
    JobInstance,
    ResourceType,
    hr_class,
)

# ---------------------------------------------------------------------------
# RPC messages (§6.2, §6.4)
# ---------------------------------------------------------------------------


@dataclass
class ResourceRequest:
    """Per-processing-resource work request (§6.2)."""

    req_runtime: float = 0.0  # buffer shortfall, scaled seconds
    req_idle: float = 0.0  # idle instance count
    queue_dur: float = 0.0  # remaining scaled runtime of queued jobs


@dataclass
class CompletedResult:
    """A finished instance reported by the client."""

    instance_id: int
    outcome: InstanceOutcome
    runtime: float = 0.0
    peak_flop_count: float = 0.0
    output: Any = None
    exit_code: int = 0
    stderr: str = ""


@dataclass
class TrickleUp:
    """Partial-progress message from a running app (§3.5): conveyed
    immediately and handled by project-specific logic — e.g. partial credit
    for long jobs, or streamed training metrics in the grid runtime."""

    instance_id: int
    fraction_done: float
    payload: Any = None


@dataclass
class ScheduleRequest:
    host_id: int
    requests: Dict[ResourceType, ResourceRequest] = field(default_factory=dict)
    completed: List[CompletedResult] = field(default_factory=list)
    trickles: List[TrickleUp] = field(default_factory=list)
    sticky_files: Tuple[str, ...] = ()
    usable_disk: float = 1e12
    keyword_prefs: KeywordPrefs = field(default_factory=KeywordPrefs)
    # anonymous platform (§3.2): client-supplied app versions
    anonymous_versions: List[AppVersion] = field(default_factory=list)


@dataclass
class DispatchedJob:
    job: Job
    instance: JobInstance
    version: AppVersion
    est_flops: float  # server's FLOPS estimate for the program (§6.4)
    est_runtime: float


@dataclass
class ScheduleReply:
    jobs: List[DispatchedJob] = field(default_factory=list)
    delete_sticky: List[str] = field(default_factory=list)
    request_delay: float = 0.0


@dataclass
class Candidate:
    """One scored (cache slot, job, app version) dispatch candidate.

    Produced either by the scalar cache scan (``Scheduler._candidate_list``)
    or by the vectorized batch engine (``batch_dispatch``). The batch engine
    precomputes ``est_rt``/``scaled_rt`` in one fused pass; the scalar path
    leaves them ``None`` and the dispatch tail computes them lazily.
    """

    score: float
    slot: CacheSlot
    job: Job
    version: AppVersion
    usage: Dict[ResourceType, float]
    est_rt: Optional[float] = None
    scaled_rt: Optional[float] = None
    index: int = -1  # engine slot position (batch path only)


# ---------------------------------------------------------------------------
# Feeder + shared-memory job cache (§5.1)
# ---------------------------------------------------------------------------


@dataclass
class CacheSlot:
    instance_id: int
    job_id: int
    app_name: str
    taken: bool = False
    skipped: int = 0  # times passed over by a scheduler scan (§6.4 score)


@dataclass
class Feeder:
    """Replenishes the job cache from the store (§5.1), interleaving apps
    and size classes so all categories stay represented."""

    store: JobStore
    cache_size: int = 1024
    slots: List[Optional[CacheSlot]] = field(default_factory=list)
    # instance_id -> slot position, so the dispatch tail's clear_slot is
    # O(1) instead of a full cache scan per dispatched job
    _slot_idx: Dict[int, int] = field(default_factory=dict, repr=False)
    # cache-content generation, for the persistent vectorized dispatch
    # snapshot: bumped whenever slot contents change *outside* the dispatch
    # tail (a fill, or an explicit invalidate). Dispatch-tail mutations are
    # reported to the engine as events instead, so they do not invalidate.
    version: int = 0
    # persistent BatchDispatchEngine snapshots (built lazily by the
    # scheduler's vector-dispatch path), keyed by shard: ``None`` for the
    # unsharded shared-cache snapshot, shard index for the per-shard cache
    # slices of the federated dispatch path (core/shard.py). All snapshots
    # share this cache's generation counter, so one ``invalidate`` rebuilds
    # every shard's slice.
    _engines: Dict[Optional[int], object] = field(default_factory=dict, repr=False)

    def __post_init__(self) -> None:
        if not self.slots:
            self.slots = [None] * self.cache_size

    def invalidate(self) -> None:
        """Force the persistent dispatch snapshot to rebuild. Any code that
        mutates cache slots or the scoring fields of cached jobs outside the
        dispatch tail must call this (the feeder's own ``fill`` does)."""
        self.version += 1

    def fill(self) -> int:
        """One feeder pass; returns slots filled. Stale slots (instances no
        longer UNSENT) that cannot be refilled are cleared, so between
        fills every resident slot references a dispatchable instance — the
        persistent engine's validity arrays rely on this."""
        in_cache = {s.instance_id for s in self.slots if s is not None}
        stale = [i for i, s in enumerate(self.slots) if s is not None and self._stale(s)]
        vacancies = [i for i, s in enumerate(self.slots) if s is None or self._stale(s)]
        if not vacancies:
            return 0
        per_app: Dict[str, List[JobInstance]] = {}
        for app_name in self.store.apps:
            # exclude in-cache ids *inside* the queue walk: with a backlog
            # larger than the cache, the oldest UNSENT rows are exactly the
            # cached ones, and filtering after the limit would starve refills
            per_app[app_name] = self.store.unsent_instances(
                app_name, limit=len(vacancies), exclude=in_cache
            )
        filled = 0
        app_names = [a for a in per_app if per_app[a]]
        ai = 0
        for slot_idx in vacancies:
            while app_names and not per_app[app_names[ai % len(app_names)]]:
                app_names.pop(ai % len(app_names))
            if not app_names:
                break
            app_name = app_names[ai % len(app_names)]
            inst = per_app[app_name].pop(0)
            old = self.slots[slot_idx]
            if old is not None:
                self._slot_idx.pop(old.instance_id, None)
            self.slots[slot_idx] = CacheSlot(
                instance_id=inst.id, job_id=inst.job_id, app_name=app_name
            )
            self._slot_idx[inst.id] = slot_idx
            in_cache.add(inst.id)
            filled += 1
            ai += 1
        cleared = 0
        for i in stale:
            s = self.slots[i]
            if s is not None and self._stale(s):
                self._slot_idx.pop(s.instance_id, None)
                self.slots[i] = None
                cleared += 1
        if filled or cleared:
            self.invalidate()
        return filled

    def _stale(self, slot: CacheSlot) -> bool:
        inst = self.store.instances.get(slot.instance_id)
        return inst is None or inst.state != InstanceState.UNSENT

    def clear_slot(self, instance_id: int) -> None:
        # no ``invalidate()`` here: the only caller is the dispatch tail,
        # which reports the mutation to the persistent engine as a
        # ("dispatch", candidate) event instead
        i = self._slot_idx.pop(instance_id, None)
        if i is not None:
            s = self.slots[i]
            if s is not None and s.instance_id == instance_id:
                self.slots[i] = None


# ---------------------------------------------------------------------------
# Scheduler (§6.4)
# ---------------------------------------------------------------------------

_RESOURCE_ORDER = (ResourceType.TPU, ResourceType.GPU, ResourceType.CPU)  # GPUs first (§6.4)

# score weights (§6.4 "weighted sum of several factors")
W_KEYWORD = 10.0
W_BALANCE = 1.0
W_SKIPPED = 5.0
W_LOCALITY = 20.0
W_SIZE_MATCH = 8.0
W_PRIORITY = 1.0


@dataclass
class SchedulerMetrics:
    requests: int = 0
    dispatched: int = 0
    reported: int = 0
    fast_check_rejects: int = 0
    slow_check_rejects: int = 0
    cache_misses: int = 0


@dataclass
class Scheduler:
    store: JobStore
    feeder: Feeder
    estimator: RuntimeEstimator
    allocator: Optional[LinearBoundedAllocator] = None
    adaptive: Optional[AdaptiveReplication] = None
    seed: int = 0
    # route *every* request — including singleton RPCs — through the
    # vectorized dispatch engine, against a persistent cache snapshot that
    # is maintained incrementally (dispatch-tail events) and rebuilt only
    # when the feeder's cache generation changes. Bit-identical to the
    # scalar scan (tests/test_batch_dispatch.py); False keeps the scalar
    # O(slots²) reference path as the oracle.
    vector_dispatch: bool = False
    # execution backend handed to BatchDispatchEngine ("numpy" | "jax");
    # "jax" runs the dense mask/score passes as staged jits, bit-identical
    # to the NumPy engine (4th parity axis in core/scenarios.run_parity)
    engine_backend: str = "numpy"
    # defense layer (§3.4 work-spreading / HR census / host punishment);
    # enforced in the shared slow-check + dispatch choke points, so the
    # scalar and vectorized tails stay result-identical
    defense: Optional["DefenseLayer"] = None
    # federated dispatch (core/shard.py): when set, this instance serves
    # only hosts whose affinity maps to ``shard`` and scans only the cache
    # positions that shard owns — the scalar scan and the engine snapshot
    # are both restricted to the slice, keeping them bit-identical to each
    # other. None = the classic shared-cache instance (full scan).
    shard_map: Optional[ShardMap] = None
    shard: int = 0
    metrics: SchedulerMetrics = field(default_factory=SchedulerMetrics)
    _rng: random.Random = field(default=None, repr=False)  # type: ignore[assignment]

    def __post_init__(self) -> None:
        self._rng = random.Random(self.seed)

    # ------------------------------------------------------------------

    def _persistent_engine(self):
        """The shared persistent dispatch snapshot, rebuilt on cache-content
        generation changes (feeder fills / explicit invalidations)."""
        from .batch_dispatch import BatchDispatchEngine  # deferred: avoids cycle

        feeder = self.feeder
        key = self.shard if self.shard_map is not None else None
        engine = feeder._engines.get(key)
        if (
            engine is None
            or engine.version != feeder.version
            or engine.backend != self.engine_backend
        ):
            # the constructor stamps the snapshot with feeder.version
            engine = BatchDispatchEngine(self.store, feeder,
                                         backend=self.engine_backend,
                                         shard_map=self.shard_map,
                                         shard=key)
            feeder._engines[key] = engine
        return engine

    def handle_request(self, req: ScheduleRequest, now: float) -> ScheduleReply:
        if self.vector_dispatch:
            return self._handle_one(req, now, engine=self._persistent_engine())
        reply = self._handle_one(req, now, engine=None)
        # scalar dispatch mutates slots without emitting engine events: any
        # persistent snapshot other schedulers hold is now stale
        if self.feeder._engines:
            self.feeder.invalidate()
        return reply

    def handle_batch(self, reqs: Sequence[ScheduleRequest], now: float) -> List[ScheduleReply]:
        """Dispatch a batch of scheduler RPCs against one cache snapshot.

        Semantically identical to N sequential :meth:`handle_request` calls
        (same RNG consumption, same assignments, same metrics — asserted by
        ``tests/test_batch_dispatch.py``), but candidate scoring runs as one
        vectorized slots×host pass per request instead of the scalar
        O(slots²) scan. Requests are processed in order; the shared dispatch
        tail reports every slot mutation back to the engine as an event so
        later requests in the batch observe taken slots, skip-count bumps,
        and HR / homogeneous-app-version locks exactly as they would under
        sequential execution. With ``vector_dispatch`` the batch runs
        against the persistent snapshot; otherwise a fresh snapshot is built
        per call (the original PR 1 behavior, kept as the oracle).
        """
        from .batch_dispatch import BatchDispatchEngine  # deferred: avoids cycle

        if self.vector_dispatch:
            engine = self._persistent_engine()
            return [self._handle_one(req, now, engine=engine) for req in reqs]
        engine = BatchDispatchEngine(self.store, self.feeder,
                                     backend=self.engine_backend,
                                     shard_map=self.shard_map,
                                     shard=self.shard if self.shard_map is not None else None)
        replies = [self._handle_one(req, now, engine=engine) for req in reqs]
        if self.feeder._engines:
            self.feeder.invalidate()  # slot mutations bypassed the snapshot
        return replies

    def _handle_one(self, req: ScheduleRequest, now: float, engine) -> ScheduleReply:
        """One scheduler RPC; candidates come from the scalar cache scan or,
        when ``engine`` is given, from the vectorized batch engine."""
        self.metrics.requests += 1
        host = self.store.hosts.get(req.host_id)
        reply = ScheduleReply()
        if host is None:
            reply.request_delay = 3600.0
            return reply

        self._process_completed(req, host, now)

        disk_left = req.usable_disk
        if disk_left < 0:
            # over limit: direct the client to delete sticky files (§3.10)
            reply.delete_sticky = list(req.sticky_files)
            return reply

        for rtype in _RESOURCE_ORDER:
            rreq = req.requests.get(rtype)
            if rreq is None or (rreq.req_runtime <= 0 and rreq.req_idle <= 0):
                continue
            if engine is None:
                disk_left = self._dispatch_resource(
                    host, req, rtype, rreq, reply, disk_left, now
                )
                continue
            # same RNG draw as the scalar scan's random start point
            start = self._rng.randrange(engine.n) if engine.n else 0
            disk_left = self._dispatch_resource_vec(
                engine, host, req, rtype, rreq, reply, disk_left, now, start
            )
        return reply

    # ------------------------------------------------------------------

    def _process_completed(self, req: ScheduleRequest, host: Host, now: float) -> None:
        """Report path: completed instances update the DB + estimators."""
        for c in req.completed:
            inst = self.store.instances.get(c.instance_id)
            if inst is None or inst.state == InstanceState.OVER:
                continue
            inst.state = InstanceState.OVER
            inst.outcome = c.outcome
            inst.received_time = now
            inst.runtime = c.runtime
            inst.peak_flop_count = c.peak_flop_count
            inst.output = c.output
            inst.exit_code = c.exit_code
            inst.stderr = c.stderr
            self.metrics.reported += 1
            job = self.store.jobs.get(inst.job_id)
            if job is not None:
                job.transition_flag = True
                version = self.store.app_versions.get(inst.app_version_id or -1)
                if version is not None and c.outcome == InstanceOutcome.SUCCESS:
                    self.estimator.record(host, version, job, c.runtime)
                if self.adaptive is not None and c.outcome != InstanceOutcome.SUCCESS \
                        and inst.app_version_id is not None:
                    self.adaptive.on_invalid(host.id, inst.app_version_id)
                if self.defense is not None and c.outcome != InstanceOutcome.SUCCESS \
                        and inst.app_version_id is not None:
                    self.defense.on_error(host.id, inst.app_version_id, now)
                # debit the submitter's allocation balance (§3.9)
                if self.allocator is not None and c.runtime > 0:
                    self.allocator.debit(job.submitter, c.runtime, now)

    # ------------------------------------------------------------------

    def _dispatch_resource(
        self,
        host: Host,
        req: ScheduleRequest,
        rtype: ResourceType,
        rreq: ResourceRequest,
        reply: ScheduleReply,
        disk_left: float,
        now: float,
        candidates: Optional[Sequence[Candidate]] = None,
        events: Optional[List[Tuple[str, Candidate]]] = None,
    ) -> float:
        """Dispatch tail shared by the scalar and batch paths.

        ``candidates`` may be any iterable in descending-score order; when
        omitted, the scalar cache scan produces it. ``events`` (batch path)
        collects slot-state mutations for the engine's incremental arrays.
        """
        if candidates is None:
            candidates = self._candidate_list(host, req, rtype, now)
        queue_dur = rreq.queue_dur
        req_runtime = rreq.req_runtime
        req_idle = rreq.req_idle
        sending_jobs = {d.job.id for d in reply.jobs}

        for cand in candidates:
            slot, job, version, usage = cand.slot, cand.job, cand.version, cand.usage
            inst = self.store.instances.get(slot.instance_id)
            # fast check (§6.4): still unsent? (another scheduler may have taken it)
            if inst is None or inst.state != InstanceState.UNSENT or slot.taken:
                self.metrics.cache_misses += 1
                if events is not None and slot.taken:
                    events.append(("taken", cand))
                continue
            est_rt = (
                cand.est_rt
                if cand.est_rt is not None
                else self.estimator.est_runtime(job, host, version)
            )
            scaled_rt = (
                cand.scaled_rt
                if cand.scaled_rt is not None
                else self._scale_runtime(est_rt, host, rtype)
            )
            if job.disk_bytes > disk_left:
                self.metrics.fast_check_rejects += 1
                slot.skipped += 1
                if events is not None:
                    events.append(("skip", cand))
                continue
            if queue_dur + scaled_rt > job.delay_bound:
                # probably won't make the deadline (§6.4 fast check b)
                self.metrics.fast_check_rejects += 1
                slot.skipped += 1
                if events is not None:
                    events.append(("skip", cand))
                continue
            if job.id in sending_jobs:
                self.metrics.fast_check_rejects += 1
                continue

            slot.taken = True
            # slow check (§6.4): DB-level conditions
            if not self._slow_check(job, host, version, now):
                slot.taken = False
                self.metrics.slow_check_rejects += 1
                slot.skipped += 1
                if events is not None:
                    events.append(("skip", cand))
                continue

            self._dispatch(job, inst, host, version, now, reply, est_rt)
            sending_jobs.add(job.id)
            self.feeder.clear_slot(inst.id)
            if events is not None:
                events.append(("dispatch", cand))
            disk_left -= job.disk_bytes
            queue_dur += scaled_rt
            req_runtime -= scaled_rt
            req_idle -= usage.get(rtype, 0.0)
            if req_runtime <= 0 and req_idle <= 0:
                break
        return disk_left

    def _dispatch_resource_vec(
        self,
        engine,
        host: Host,
        req: ScheduleRequest,
        rtype: ResourceType,
        rreq: ResourceRequest,
        reply: ScheduleReply,
        disk_left: float,
        now: float,
        start: int,
    ) -> float:
        """Array-driven dispatch tail for the vectorized engine: identical
        checks, order, metrics, and slot mutations to
        :meth:`_dispatch_resource` over ``engine.candidates``, but the
        fast-check rejections — the overwhelming bulk of the visited
        candidates — are classified as whole array prefixes (``engine.valid``
        is exact, see the engine's build-time staleness probe) and skip-bumped
        through ``engine.bulk_skip`` instead of per-candidate Python."""
        rows = engine.candidate_rows(self, host, req, rtype, start, now)
        if rows is None:
            return disk_left
        pos, gidx, _scores, est, scaled, choices, disk_c, delay_c = rows
        queue_dur = rreq.queue_dur
        req_runtime = rreq.req_runtime
        req_idle = rreq.req_idle
        sending_jobs = {d.job.id for d in reply.jobs}
        metrics = self.metrics
        slots = engine.slots
        insts = self.store.instances
        jobs = self.store.jobs
        unsent = InstanceState.UNSENT
        n = len(pos)
        k = 0

        def bulk_reject(a: int, b: int) -> None:
            """Candidates [a, b) all failed a disk/deadline fast check: the
            valid ones get the skip-bump (fast_check_rejects), the rest are
            cache misses — exactly the scalar per-candidate classification."""
            if a >= b:
                return
            seg = pos[a:b]
            v = engine.valid[seg]
            bump = seg[v]
            miss = len(seg) - len(bump)
            if miss:
                metrics.cache_misses += miss
            if len(bump):
                metrics.fast_check_rejects += len(bump)
                engine.bulk_skip(bump)

        while k < n:
            # vectorized fast checks (§6.4 a/b) over the remaining ranked
            # candidates at the *current* disk/queue budget — the budget
            # only changes on a dispatch, so the prefix scan is exact
            ok = (disk_c[k:] <= disk_left) & (queue_dur + scaled[k:] <= delay_c[k:])
            hits = np.flatnonzero(ok)
            if hits.size == 0:
                bulk_reject(k, n)
                break
            m = k + int(hits[0])
            bulk_reject(k, m)
            k = m
            p = int(pos[k])
            slot = slots[p]
            inst = insts.get(slot.instance_id)
            # fast check (§6.4): still unsent? (another scheduler may have taken it)
            if inst is None or inst.state != unsent or slot.taken:
                metrics.cache_misses += 1
                if slot.taken:
                    engine.valid[p] = False
                k += 1
                continue
            job = jobs.get(slot.job_id)
            if job is None:
                k += 1
                continue  # purged after snapshot build: scalar scan skips it
            if job.id in sending_jobs:
                metrics.fast_check_rejects += 1
                k += 1
                continue

            choice = choices[int(gidx[k])]
            slot.taken = True
            # slow check (§6.4): DB-level conditions
            if not self._slow_check(job, host, choice.version, now):
                slot.taken = False
                metrics.slow_check_rejects += 1
                slot.skipped += 1
                engine.apply_skip(p, job, slot)
                k += 1
                continue

            scaled_rt = scaled[k]
            self._dispatch(job, inst, host, choice.version, now, reply, float(est[k]))
            sending_jobs.add(job.id)
            self.feeder.clear_slot(inst.id)
            engine.apply_dispatch(p, job)
            disk_left -= job.disk_bytes
            queue_dur += scaled_rt
            req_runtime -= scaled_rt
            req_idle -= choice.usage.get(rtype, 0.0)
            k += 1
            if req_runtime <= 0 and req_idle <= 0:
                break
        return disk_left

    # ------------------------------------------------------------------

    def _candidate_list(
        self, host: Host, req: ScheduleRequest, rtype: ResourceType, now: float
    ) -> List[Candidate]:
        """Scan the job cache from a random start; score candidates (§6.4).

        Under federated dispatch the scan is restricted to the cache
        positions this scheduler's shard owns — the same rotated visiting
        order over a masked slice, mirroring the engine snapshot's
        build-time ownership mask."""
        slots = self.feeder.slots
        n = len(slots)
        start = self._rng.randrange(n) if n else 0
        owner = self.shard_map.owner if self.shard_map is not None else None
        out: List[Candidate] = []
        seen_jobs = set()
        for k in range(n):
            idx = (start + k) % n
            if owner is not None and owner[idx] != self.shard:
                continue
            slot = slots[idx]
            if slot is None or slot.taken:
                continue
            job = self.store.jobs.get(slot.job_id)
            if job is None or slot.job_id in seen_jobs:
                continue
            app = self.store.apps[job.app_name]
            if job.target_host is not None and job.target_host != host.id:
                continue  # targeted jobs (§3.5)
            version, usage = self._select_version(app, job, host, req, rtype)
            if version is None:
                continue
            score = self._score(job, app, host, req, version, rtype, now)
            if score is None:
                continue
            seen_jobs.add(slot.job_id)
            out.append(Candidate(score=score, slot=slot, job=job, version=version, usage=usage))
        out.sort(key=lambda c: -c.score)
        return out

    # ------------------------------------------------------------------

    def _select_version(
        self,
        app: App,
        job: Job,
        host: Host,
        req: ScheduleRequest,
        rtype: ResourceType,
    ) -> Tuple[Optional[AppVersion], Dict[ResourceType, float]]:
        """Best app version for (job, host, resource) by proj_flops (§6.4)."""
        pool = list(app.latest_versions())
        if req.anonymous_versions:
            # anonymous platform (§3.2): client-built versions take part
            pool += [v for v in req.anonymous_versions if v.app_name == app.name]
        best: Optional[AppVersion] = None
        best_usage: Dict[ResourceType, float] = {}
        best_pf = -1.0
        for v in pool:
            if job.pinned_version_num is not None and v.version_num != job.pinned_version_num:
                continue  # version pinning (§3.5)
            if job.hav_version_id is not None and v.id != job.hav_version_id:
                continue  # homogeneous app version (§3.4)
            if not host.supports_platform(v.platform):
                continue
            ev = v.plan_class.evaluate(host)
            if ev is None:
                continue
            usage, _ = ev
            if usage.get(rtype, 0.0) <= 0.0:
                continue  # version doesn't use this resource
            pf = self.estimator.proj_flops(host, v)
            if pf > best_pf:
                best, best_usage, best_pf = v, usage, pf
        return best, best_usage

    # ------------------------------------------------------------------

    def _score(
        self,
        job: Job,
        app: App,
        host: Host,
        req: ScheduleRequest,
        version: AppVersion,
        rtype: ResourceType,
        now: float,
    ) -> Optional[float]:
        # HR constraint: job locked to an equivalence class (§3.4)
        if app.hr_level != HRLevel.NONE and job.hr_class is not None:
            if hr_class(host, app.hr_level) != job.hr_class:
                return None
        kscore = keyword_score(job.keywords, req.keyword_prefs)
        if kscore is None:
            return None  # "no" keyword: never send (§2.4)
        score = W_KEYWORD * kscore
        if self.allocator is not None:
            score += W_BALANCE * self.allocator.priority(job.submitter, now)
        score += W_PRIORITY * job.priority
        # skipped-before boost: hard-to-send jobs go while they can (§6.4).
        # Under federated dispatch the lookup is slice-local (first owned
        # slot of the job) — skip counts are per-shard state, matching the
        # engine snapshot's slice-local ``skips`` array.
        slot_skips = 0
        slots = self.feeder.slots
        if self.shard_map is None:
            for s in slots:
                if s is not None and s.job_id == job.id:
                    slot_skips = s.skipped
                    break
        else:
            for p in self.shard_map.owned_positions(self.shard):
                s = slots[p]
                if s is not None and s.job_id == job.id:
                    slot_skips = s.skipped
                    break
        score += W_SKIPPED * min(slot_skips, 5)
        # locality scheduling (§3.5): prefer jobs whose files are resident
        if app.uses_locality and job.input_files:
            resident = len(set(job.input_files) & set(req.sticky_files))
            score += W_LOCALITY * (resident / len(job.input_files))
        # multi-size jobs (§3.5): match job size class to host speed quantile
        if app.multi_size and app.n_size_classes > 1:
            all_pf = [st.mean for st in self.estimator.version.values() if st.n > 0]
            pop = [1.0 / m for m in all_pf if m > 0]
            q = self.estimator.size_quantile(host, version, app.n_size_classes, pop)
            if q == job.size_class:
                score += W_SIZE_MATCH
        return score

    # ------------------------------------------------------------------

    def _slow_check(
        self,
        job: Job,
        host: Host,
        version: Optional[AppVersion] = None,
        now: float = 0.0,
    ) -> bool:
        if job.state.value != "active":
            return False  # errored out since we considered it
        if self.store.host_has_instance_of_job(host.id, job.id):
            return False  # one instance per volunteer (§6.4)
        if self.defense is not None and version is not None:
            # defense layer (§3.4): punishment deferral, daily quota,
            # work-spreading suspicion clusters
            return self.defense.check_dispatch(job, host, version, now)
        return True

    # ------------------------------------------------------------------

    def _dispatch(
        self,
        job: Job,
        inst: JobInstance,
        host: Host,
        version: AppVersion,
        now: float,
        reply: ScheduleReply,
        est_rt: float,
    ) -> None:
        app = self.store.apps[job.app_name]
        inst.state = InstanceState.IN_PROGRESS
        inst.host_id = host.id
        inst.app_version_id = version.id
        inst.sent_time = now
        inst.deadline = now + job.delay_bound
        # lock HR class / app version on first dispatch (§3.4). With the
        # defense layer active, the census guard skips the pin when the
        # class holds too few hosts to reach quorum (logged, not fatal) —
        # the batch engine folds the lock from job.hr_class afterwards, so
        # the guard propagates to the fused HR mask automatically.
        if app.hr_level != HRLevel.NONE and job.hr_class is None:
            if self.defense is None or self.defense.can_pin(host, app, job):
                job.hr_class = hr_class(host, app.hr_level)
        if app.homogeneous_app_version and job.hav_version_id is None:
            job.hav_version_id = version.id
        # adaptive replication decision (§3.4): replicate this host's job?
        if app.adaptive_replication and job.min_quorum <= 1:
            if self.adaptive is not None and self.adaptive.should_replicate(host.id, version.id):
                job.min_quorum = app.min_quorum
                job.init_ninstances = max(job.init_ninstances, app.min_quorum)
                job.transition_flag = True  # transitioner creates the replica
        self.metrics.dispatched += 1
        if self.defense is not None:
            self.defense.on_dispatch(job, app, host, version, now)
        reply.jobs.append(
            DispatchedJob(
                job=job,
                instance=inst,
                version=version,
                est_flops=self.estimator.proj_flops(host, version),
                est_runtime=est_rt,
            )
        )

    # ------------------------------------------------------------------

    @staticmethod
    def _scale_runtime(raw: float, host: Host, rtype: ResourceType) -> float:
        """Raw -> scaled runtime using availability (§6)."""
        res = host.resources.get(rtype)
        avail = (res.availability if res else 1.0) * host.on_fraction
        if avail <= 0:
            return float("inf")
        return raw / avail
