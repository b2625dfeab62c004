"""The project server facade (§5.1).

Wires the store, feeder, scheduler instances, and the daemon set
(transitioner, validator — folded into the transitioner's quorum step as in
the paper's flow, assimilator, file deleter, database purger). Daemons are
independent ``tick`` callables; any can be paused and its work accumulates
in the store (the paper's fault-tolerance property — exercised by tests).

Scale-out (§5.1): every daemon supports ID-space sharding; scheduler
instances share the feeder cache.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from .adaptive import AdaptiveReplication
from .backend import resolve_engine
from .allocation import LinearBoundedAllocator
from .credit import CreditSystem
from .defense import DefenseLayer, DefensePolicy
from .estimation import RuntimeEstimator
from .fsm import Transitioner
from .scheduler import Feeder, Scheduler, ScheduleReply, ScheduleRequest, TrickleUp
from .shard import ShardMap, ShardPolicy
from .store import JobStore
from .types import App, AppVersion, Batch, Host, Job, next_id

AssimilatorFn = Callable[[Job, Any], None]


@dataclass
class DaemonControl:
    """Pause switch per daemon — used to exercise §5.1 fault tolerance."""

    transitioner: bool = True
    assimilator: bool = True
    file_deleter: bool = True
    purger: bool = True
    feeder: bool = True


@dataclass
class ProjectServer:
    name: str = "project"
    store: JobStore = field(default_factory=JobStore)
    estimator: RuntimeEstimator = field(default_factory=RuntimeEstimator)
    credit: CreditSystem = field(default_factory=CreditSystem)
    allocator: LinearBoundedAllocator = field(default_factory=LinearBoundedAllocator)
    adaptive: AdaptiveReplication = field(default_factory=AdaptiveReplication)
    cache_size: int = 1024
    n_scheduler_instances: int = 1
    n_daemon_instances: int = 1
    # route the transitioners' validate pass through the vectorized batch
    # validation engine (core/batch_validate.py); False selects the scalar
    # per-job oracle path (the parity reference)
    batch_validate: bool = True
    # route every scheduler RPC — singletons included — through the
    # vectorized dispatch engine's persistent cache snapshot
    # (core/batch_dispatch.py); False keeps the scalar per-request scan and
    # PR 1's fresh-snapshot-per-batch behavior (the parity reference).
    # GridSimulation(vector_world=True) flips this on via
    # :meth:`set_vector_dispatch`.
    vector_dispatch: bool = False
    # execution backend for the batch engines ("numpy" | "torch"), handed
    # to every Scheduler (dispatch scoring) and Transitioner (validation
    # digests); engine outputs are bit-identical either way (4th parity
    # axis in core/scenarios.run_parity). The torch engines run on
    # ``engine_device`` ("cuda" unless "cpu" is asked for; ignored by NumPy)
    engine_backend: str = "numpy"
    engine_device: Any = "cuda"
    # defense-in-depth replica placement (§3.4): work-spreading, HR census
    # pinning, host punishment. None disables the layer entirely.
    defense_policy: Optional[DefensePolicy] = None
    defense: Optional[DefenseLayer] = None
    # shard-aware federated dispatch (§5.1 scale-out, core/shard.py): with
    # several scheduler instances, partition hosts across them by a stable
    # host→shard affinity and give each shard its own slice of the feeder
    # cache, so rpc_batch runs one vectorized handle_batch pass per shard.
    # None = auto (sharding on exactly when n_scheduler_instances > 1);
    # False keeps the legacy sequential round-robin fallback — the
    # unsharded oracle the parity tests compare against.
    sharded_dispatch: Optional[bool] = None
    # pinned host_id→shard overrides (default affinity: host_id % n_shards)
    shard_affinity: Optional[Dict[int, int]] = None
    shard_policy: Optional[ShardPolicy] = None
    shard_map: Optional[ShardMap] = None
    purge_delay: float = 0.0  # keep completed rows briefly (§4)
    enabled: DaemonControl = field(default_factory=DaemonControl)
    assimilators: Dict[str, AssimilatorFn] = field(default_factory=dict)
    # trickle-up handlers (§3.5): app_name -> fn(instance, trickle, now)
    trickle_handlers: Dict[str, Any] = field(default_factory=dict)
    feeder: Feeder = None  # type: ignore[assignment]
    schedulers: List[Scheduler] = field(default_factory=list)
    transitioners: List[Transitioner] = field(default_factory=list)
    _rr: int = 0
    assimilated_outputs: List[Any] = field(default_factory=list)

    def __post_init__(self) -> None:
        # an unknown backend, or the torch backend on "cuda" without a card,
        # raises here rather than at the first RPC or daemon pass
        resolve_engine(self.engine_backend, self.engine_device)
        self.feeder = Feeder(store=self.store, cache_size=self.cache_size)
        if self.defense is None and self.defense_policy is not None:
            self.defense = DefenseLayer(policy=self.defense_policy, store=self.store)
        if self.defense is not None:
            # HR relax unpins mutate job.hr_class behind the persistent
            # dispatch snapshot's back; bump the cache generation so the
            # vectorized path re-reads the pins (scalar-parity requirement)
            self.defense.invalidate_dispatch = self.feeder.invalidate
        sharded = self.sharded_dispatch
        if sharded is None:
            sharded = self.n_scheduler_instances > 1
        if sharded and self.n_scheduler_instances > 1 and self.shard_map is None:
            self.shard_map = ShardMap(
                n_shards=self.n_scheduler_instances,
                cache_size=self.cache_size,
                affinity=self.shard_affinity,
                policy=self.shard_policy or ShardPolicy(),
            )
        self.schedulers = [
            Scheduler(
                store=self.store,
                feeder=self.feeder,
                estimator=self.estimator,
                allocator=self.allocator,
                adaptive=self.adaptive,
                seed=i,
                vector_dispatch=self.vector_dispatch,
                engine_backend=self.engine_backend,
                engine_device=self.engine_device,
                defense=self.defense,
                shard_map=self.shard_map,
                shard=i,
            )
            for i in range(self.n_scheduler_instances)
        ]
        self.transitioners = [
            Transitioner(
                store=self.store,
                credit=self.credit,
                adaptive=self.adaptive,
                instance=i,
                n_instances=self.n_daemon_instances,
                batch_validate=self.batch_validate,
                engine_backend=self.engine_backend,
                engine_device=self.engine_device,
                defense=self.defense,
            )
            for i in range(self.n_daemon_instances)
        ]

    # ------------------------------------------------------------------
    # registration & submission (§3.9)
    # ------------------------------------------------------------------

    def add_app(self, app: App) -> App:
        return self.store.add_app(app)

    def add_host(self, host: Host) -> Host:
        if self.defense is not None:
            self.defense.on_host_added(host)
        return self.store.add_host(host)

    def submit_job(self, job: Job, now: float = 0.0) -> Job:
        job.created_time = now
        app = self.store.apps[job.app_name]
        # validation/deadline parameters are set "typically at the level of
        # app rather than job" (§4): inherit app values for any field the
        # submitter left at the dataclass default
        from .types import Job as JobCls

        for field_name in (
            "min_quorum",
            "init_ninstances",
            "max_error_instances",
            "max_success_instances",
            "delay_bound",
        ):
            if getattr(job, field_name) == JobCls.__dataclass_fields__[field_name].default:
                setattr(job, field_name, getattr(app, field_name))
        if app.adaptive_replication:
            # start unreplicated; the dispatch path may bump the quorum (§3.4)
            job.min_quorum = 1
            job.init_ninstances = 1
        self.allocator.ensure(job.submitter, now)
        return self.store.submit_job(job)

    def submit_batch(self, jobs: List[Job], submitter: str, now: float = 0.0) -> Batch:
        """Batch submission (§3.9) — designed so a thousand jobs submit fast;
        see benchmarks/bench_dispatch.py."""
        batch = Batch(id=next_id("batch"), submitter=submitter, created_time=now)
        self.store.batches[batch.id] = batch
        for j in jobs:
            j.batch_id = batch.id
            j.submitter = submitter
            self.submit_job(j, now)
        return batch

    # ------------------------------------------------------------------
    # RPC entry (scheduler CGI instances, §5.1)
    # ------------------------------------------------------------------

    def rpc(self, request: ScheduleRequest, now: float) -> ScheduleReply:
        self._handle_trickles(request, now)
        if self.shard_map is not None:
            # federated dispatch: stable host→shard affinity replaces the
            # round-robin rotation, so a host always hits the same shard's
            # cache slice (and the same scheduler RNG stream)
            shard = self.shard_map.shard_of(request.host_id)
            self.shard_map.rebalance(self.feeder, shard)
            reply = self.schedulers[shard].handle_request(request, now)
            self.shard_map.note(shard, requests=1, dispatched=len(reply.jobs))
            return reply
        sched = self.schedulers[self._rr % len(self.schedulers)]
        self._rr += 1
        return sched.handle_request(request, now)

    def rpc_batch(self, requests: List[ScheduleRequest], now: float) -> List[ScheduleReply]:
        """Coalesced scheduler RPCs: one vectorized batch-dispatch pass.

        One scheduler instance serves the whole batch through
        ``Scheduler.handle_batch`` (the shared-memory cache is snapshotted
        into struct-of-arrays form once and scored vectorized per host),
        result-identical to calling :meth:`rpc` per request in order.

        With multiple scheduler instances and federated dispatch active
        (``shard_map``), the batch is grouped by host→shard affinity and
        served as one vectorized ``handle_batch`` pass *per shard* in
        ascending shard order (requests keep their arrival order within a
        shard; replies are scattered back to arrival positions). Each
        request is result-identical to routing it through :meth:`rpc` under
        the same affinity; the shard-parity contract (union of per-shard
        assignments == sequential affinity-routed dispatch) is pinned by
        tests/test_shard_dispatch.py. With sharding opted out
        (``sharded_dispatch=False``) the legacy behavior remains: the
        sequential path round-robins requests across distinct RNG streams,
        so batching would change assignments — fall back to per-request
        dispatch to keep the identity.
        """
        if len(self.schedulers) > 1:
            if self.shard_map is None:
                return [self.rpc(r, now) for r in requests]
            return self._rpc_batch_sharded(requests, now)
        for request in requests:
            self._handle_trickles(request, now)
        if not requests:
            return []
        sched = self.schedulers[self._rr % len(self.schedulers)]
        self._rr += 1
        # adaptive-replication decisions in this coalesced pass consume one
        # prefetched RNG batch instead of interleaved per-job draws (§3.4);
        # the FIFO cache preserves stream order, so every decision is
        # identical to unbatched use regardless of the estimate's accuracy
        self.adaptive.prefetch_draws(len(requests))
        return sched.handle_batch(requests, now)

    def _rpc_batch_sharded(
        self, requests: List[ScheduleRequest], now: float
    ) -> List[ScheduleReply]:
        """Federated coalesced dispatch: one vectorized ``handle_batch``
        pass per shard (ascending shard order, arrival order within each
        shard), after a work-migration check per participating shard.
        Trickles are handled up front for the whole batch, like the
        single-instance coalesced path."""
        for request in requests:
            self._handle_trickles(request, now)
        if not requests:
            return []
        assert self.shard_map is not None
        groups: Dict[int, List[int]] = {}
        for i, r in enumerate(requests):
            groups.setdefault(self.shard_map.shard_of(r.host_id), []).append(i)
        replies: List[Optional[ScheduleReply]] = [None] * len(requests)
        for s in sorted(groups):
            idxs = groups[s]
            # starved-shard migration before the pass, so a drained slice
            # can steal neighbors' cached slots instead of replying empty
            self.shard_map.rebalance(self.feeder, s)
            # one prefetched adaptive-RNG batch per shard pass (same FIFO
            # stream-order guarantee as the single-instance coalesced path)
            self.adaptive.prefetch_draws(len(idxs))
            out = self.schedulers[s].handle_batch([requests[i] for i in idxs], now)
            dispatched = 0
            for i, reply in zip(idxs, out):
                replies[i] = reply
                dispatched += len(reply.jobs)
            self.shard_map.note(s, requests=len(idxs), dispatched=dispatched)
        return replies  # type: ignore[return-value]

    def _handle_trickles(self, request: ScheduleRequest, now: float) -> None:
        """Trickle-up messages are 'conveyed immediately to the server and
        handled by project-specific logic' (§3.5). The default handler
        grants partial credit for partial completion — the paper's example."""
        for t in request.trickles:
            inst = self.store.instances.get(t.instance_id)
            if inst is None:
                continue
            job = self.store.jobs.get(inst.job_id)
            if job is None:
                continue
            handler = self.trickle_handlers.get(job.app_name)
            if handler is not None:
                handler(inst, t, now)
            else:
                # default: partial credit proportional to fraction done
                host = self.store.hosts.get(request.host_id)
                if host is not None and t.fraction_done > 0:
                    partial = (
                        job.est_flop_count * t.fraction_done / 86400.0 / 1e9
                    )
                    self.credit.grant(f"host:{host.id}:partial", partial, now)

    # ------------------------------------------------------------------
    # daemons (§5.1)
    # ------------------------------------------------------------------

    def tick(self, now: float) -> None:
        """Run one pass of every enabled daemon."""
        if self.enabled.feeder:
            self.feeder.fill()
        if self.enabled.transitioner:
            for t in self.transitioners:
                t.tick(now)
            if self.enabled.feeder:
                self.feeder.fill()  # newly created instances become dispatchable
            else:
                # transitions may have staled cached slots (cancelled /
                # timed-out instances); with the feeder paused no fill will
                # clear them, so force the persistent dispatch snapshot to
                # rebuild with its staleness probe
                self.feeder.invalidate()
        if self.enabled.assimilator:
            self.assimilate(now)
        if self.enabled.file_deleter:
            self.delete_files(now)
        if self.enabled.purger:
            self.purge(now)
        self._update_batches(now)

    def assimilate(self, now: float) -> int:
        n = 0
        for job in self.store.pending_assimilation():
            handler = self.assimilators.get(job.app_name)
            output = None
            if job.canonical_instance_id is not None:
                canonical = self.store.instances.get(job.canonical_instance_id)
                output = canonical.output if canonical else None
            if handler is not None:
                handler(job, output)
            else:
                self.assimilated_outputs.append((job.id, output))
            job.assimilated = True
            n += 1
        return n

    def delete_files(self, now: float) -> int:
        n = 0
        for job in self.store.pending_file_deletion():
            # retain canonical output until all instances resolved (§4).
            # The indexed store already defers blocked jobs to their
            # instance-terminal events (store.delete_ready), so this check
            # is a cheap defense there and the actual filter only on the
            # use_indexes=False oracle path.
            if any(i.is_outstanding() for i in self.store.job_instances(job.id)):
                continue
            job.files_deleted = True
            n += 1
        return n

    def remove_host(self, host_id: int, now: float = 0.0) -> None:
        """Device churn (§4): drop the server's scheduling-side traces of
        the host — the DB row, the estimator's (host, version) runtime
        stats, and the adaptive-replication reputation row. In-progress
        instances are left to hit their deadlines and get retried
        elsewhere. The credit system's per-(host, version) claim stats are
        deliberately retained: straggler results reported before the
        departure may still reach validation, and their quorum partners'
        claims normalize against that history (§7)."""
        self.store.remove_host(host_id)
        self.estimator.forget_host(host_id)
        self.adaptive.forget_host(host_id)
        if self.defense is not None:
            self.defense.forget_host(host_id)
        if self.shard_map is not None:
            self.shard_map.forget_host(host_id)

    def set_vector_dispatch(self, flag: bool) -> None:
        """Flip the persistent-snapshot dispatch path on every scheduler
        instance (used by ``GridSimulation(vector_world=...)``)."""
        self.vector_dispatch = flag
        for s in self.schedulers:
            s.vector_dispatch = flag

    def purge(self, now: float) -> int:
        # the store pops only rows past the retention window (§4): jobs
        # still inside it stay heaped and cost nothing per tick
        n = 0
        for job in self.store.purgeable_jobs(now - self.purge_delay):
            self.store.purge_job(job)
            n += 1
        if n:
            # purged jobs may still be referenced by the persistent dispatch
            # snapshot's static arrays — force a rebuild
            self.feeder.invalidate()
        return n

    def _update_batches(self, now: float) -> None:
        if self.store.use_indexes:
            # O(newly completed): the store flags a batch the moment its
            # last job reaches a terminal state
            for bid in self.store.drain_completed_batches():
                b = self.store.batches.get(bid)
                # re-check doneness (O(1) counter probe): the batch may have
                # reopened since it was flagged
                if b is not None and b.completed_time is None and self.store.batch_done(bid):
                    b.completed_time = now
            return
        for b in self.store.batches.values():
            if b.completed_time is None and b.job_ids and self.store.batch_done(b.id):
                b.completed_time = now

    # ------------------------------------------------------------------
    # status
    # ------------------------------------------------------------------

    def counts(self) -> Dict[str, int]:
        return self.store.status_counts()
