"""In-memory job database (the relational DB of §5.1).

The real BOINC server centers on MySQL; here the store is an indexed
in-memory structure with the same role: the single point of coordination
between scheduler instances and daemons. Daemons communicate *only* through
this store (flags on rows), which is what makes the multi-daemon
architecture fault-tolerant: a stopped daemon's work accumulates here.

**Indexes (§5.1).** Real BOINC daemons never table-scan: they enumerate
flagged records through DB indexes (``WHERE transition_time < now``). This
store reproduces that with structures maintained *at mutation time* (rows
notify the store on field assignment, see ``types.IndexObserved``):

  * per-state ID sets for jobs and instances (``counts`` in O(1));
  * per-daemon pending queues — ``transition_pending``,
    ``assimilate_pending``, ``delete_pending``, ``purge_pending`` and
    ``batch_done_pending`` — so a daemon pass is O(work to do), not
    O(table size);
  * a lazy min-heap over IN_PROGRESS instance deadlines, so the
    transitioner's deadline pass pops only expired entries;
  * per-job ``(host, volunteer)`` assignment sets, making the
    one-instance-per-volunteer "slow check" (§6.4) O(1);
  * per-batch open-job counters replacing the all-jobs ``batch_done`` scan;
  * a validation-pending set — jobs holding a fresh (OVER/SUCCESS/INIT)
    instance — consumed by the batch validation engine's digest pass;
  * a file-deletion readiness set — delete-pending jobs with zero
    outstanding instances (per-job counts maintained on instance state
    transitions), so the deleter never re-scans blocked jobs per tick.

The original scan queries (``jobs_with_flag`` & co.) are kept as the
debug/oracle path: ``use_indexes=False`` routes every daemon query through
them, and :meth:`check_invariants` asserts index ↔ scan agreement.

ID-space sharding (§5.1): every daemon iterates ``shard(items, i, n)`` —
instance ``i`` of ``n`` handles rows with ``id % n == i``.
"""
from __future__ import annotations

import heapq
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, Iterable, Iterator, List, Optional, Set, Tuple

from .types import (
    App,
    AppVersion,
    Batch,
    Host,
    InstanceOutcome,
    InstanceState,
    Job,
    JobInstance,
    JobState,
    ValidateState,
    next_id,
)


def shard(ids: Iterable[int], instance: int, n_instances: int) -> Iterator[int]:
    """ID-space daemon sharding: (ID mod N) == i (§5.1)."""
    for i in ids:
        if i % n_instances == instance:
            yield i


_TERMINAL = (JobState.SUCCESS, JobState.FAILURE)


@dataclass
class JobStore:
    apps: Dict[str, App] = field(default_factory=dict)
    app_versions: Dict[int, AppVersion] = field(default_factory=dict)
    hosts: Dict[int, Host] = field(default_factory=dict)
    jobs: Dict[int, Job] = field(default_factory=dict)
    instances: Dict[int, JobInstance] = field(default_factory=dict)
    batches: Dict[int, Batch] = field(default_factory=dict)
    _by_job: Dict[int, List[int]] = field(default_factory=dict)
    # instances awaiting dispatch, FIFO per app; entries are dropped lazily
    # (from the head, or skipped mid-queue) once no longer UNSENT.
    # _unsent_ids mirrors queue membership exactly so re-enqueues (a row
    # returning to UNSENT while its stale entry is still mid-queue) can't
    # create duplicates
    _unsent: Dict[str, Deque[int]] = field(default_factory=dict)
    _unsent_ids: Dict[str, Set[int]] = field(default_factory=dict)
    # monotonically increasing DB "row version" for cheap change detection
    mutations: int = 0
    # daemon queries go through the maintained indexes; False selects the
    # original scan implementations (the oracle used for parity tests)
    use_indexes: bool = True

    # ---- maintained indexes (§5.1 "DB index" analogy) ----
    _jobs_by_state: Dict[JobState, Set[int]] = field(default_factory=dict)
    _insts_by_state: Dict[InstanceState, Set[int]] = field(default_factory=dict)
    transition_pending: Set[int] = field(default_factory=set)
    assimilate_pending: Set[int] = field(default_factory=set)
    delete_pending: Set[int] = field(default_factory=set)
    purge_pending: Set[int] = field(default_factory=set)
    batch_done_pending: Set[int] = field(default_factory=set)
    _batch_open: Dict[int, int] = field(default_factory=dict)
    # (deadline, instance_id) heap over IN_PROGRESS instances; entries are
    # validated on pop (state / deadline may have changed since push)
    _deadline_heap: List[Tuple[float, int]] = field(default_factory=list)
    # (created_time, job_id) heap over purge-pending jobs, so a purger with
    # a retention window (purge_delay, §4) pops only eligible rows instead
    # of re-visiting every completed-but-retained job each tick
    _purge_heap: List[Tuple[float, int]] = field(default_factory=list)
    # job_id -> host ids / volunteer ids ever assigned an instance
    _job_hosts: Dict[int, Set[int]] = field(default_factory=dict)
    _job_vols: Dict[int, Set[int]] = field(default_factory=dict)
    # validation-pending index (§3.4/§4): jobs holding >=1 *fresh* success —
    # an instance with state OVER, outcome SUCCESS, validate_state INIT.
    # These are exactly the jobs whose next transition may run the quorum
    # check; the batch validation engine reads this set to decide which
    # flagged jobs need the digest pass. Maintained from the per-job fresh
    # counts below on every tracked-field assignment.
    validation_pending: Set[int] = field(default_factory=set)
    _fresh_success: Dict[int, int] = field(default_factory=dict)
    # file-deletion readiness (§4): the deleter must retain a job's files
    # while any instance is outstanding (UNSENT / IN_PROGRESS). Rather than
    # re-scanning every delete-pending job's instances each tick, the store
    # keeps a per-job outstanding-instance count (maintained on instance
    # state transitions) and promotes a job into ``delete_ready`` the
    # moment its count hits zero — i.e. the re-check is deferred to
    # instance-*terminal* events.
    delete_ready: Set[int] = field(default_factory=set)
    _job_outstanding: Dict[int, int] = field(default_factory=dict)

    def __post_init__(self) -> None:
        for s in JobState:
            self._jobs_by_state.setdefault(s, set())
        for s in InstanceState:
            self._insts_by_state.setdefault(s, set())

    # ---- registration ----

    def add_app(self, app: App) -> App:
        self.apps[app.name] = app
        for v in app.versions:
            self.app_versions[v.id] = v
        self.mutations += 1
        return app

    def add_app_version(self, version: AppVersion) -> AppVersion:
        self.apps[version.app_name].add_version(version)
        self.app_versions[version.id] = version
        self.mutations += 1
        return version

    def add_host(self, host: Host) -> Host:
        self.hosts[host.id] = host
        self.mutations += 1
        return host

    def remove_host(self, host_id: int) -> None:
        self.hosts.pop(host_id, None)
        self.mutations += 1

    # ---- jobs & instances ----

    def submit_job(self, job: Job) -> Job:
        assert job.app_name in self.apps, f"unknown app {job.app_name}"
        job.transition_flag = True
        self.jobs[job.id] = job
        self._by_job.setdefault(job.id, [])
        self._jobs_by_state[job.state].add(job.id)
        if job.batch_id:
            self.batches.setdefault(
                job.batch_id, Batch(id=job.batch_id, submitter=job.submitter)
            ).job_ids.append(job.id)
            if job.state not in _TERMINAL and job.state != JobState.PURGED:
                self._batch_open[job.batch_id] = self._batch_open.get(job.batch_id, 0) + 1
                # the batch reopened: a momentarily-complete batch must not
                # keep its done flag
                self.batch_done_pending.discard(job.batch_id)
        object.__setattr__(job, "_store", self)  # begin observing mutations
        self._reindex_job(job)
        self.mutations += 1
        return job

    def create_instance(self, job: Job) -> JobInstance:
        inst = JobInstance(id=next_id("instance"), job_id=job.id)
        self.instances[inst.id] = inst
        self._by_job[job.id].append(inst.id)
        self._insts_by_state[inst.state].add(inst.id)
        self._outstanding_delta(job.id, 1)  # new instances start UNSENT
        self._unsent.setdefault(job.app_name, deque()).append(inst.id)
        self._unsent_ids.setdefault(job.app_name, set()).add(inst.id)
        object.__setattr__(inst, "_store", self)
        self.mutations += 1
        return inst

    def job_instances(self, job_id: int) -> List[JobInstance]:
        return [self.instances[i] for i in self._by_job.get(job_id, [])]

    def unsent_instances(
        self,
        app_name: str,
        limit: int = 0,
        exclude: Optional[Set[int]] = None,
    ) -> List[JobInstance]:
        """First ``limit`` dispatchable instances of ``app_name``, FIFO.

        ``exclude`` (the feeder passes its in-cache set) skips instance ids
        without counting them toward ``limit`` — otherwise a backlog larger
        than the cache would keep returning the already-cached queue head
        and the feeder could never refill past it.

        O(limit + skipped + dropped): dead entries are popped from the
        queue head; dead entries deeper in the queue are skipped (and
        dropped once they surface at the head) instead of rebuilding the
        whole list per call.
        """
        q = self._unsent.get(app_name)
        if not q:
            return []
        insts = self.instances
        ids = self._unsent_ids.get(app_name, set())
        while q:  # compact the head so the queue cannot grow unboundedly
            inst = insts.get(q[0])
            if inst is not None and inst.state == InstanceState.UNSENT:
                break
            ids.discard(q.popleft())
        out: List[JobInstance] = []
        for iid in q:
            if exclude is not None and iid in exclude:
                continue
            inst = insts.get(iid)
            if inst is None or inst.state != InstanceState.UNSENT:
                continue
            out.append(inst)
            if limit and len(out) >= limit:
                break
        return out

    def host_has_instance_of_job(self, host_id: int, job_id: int) -> bool:
        """One-instance-per-host rule ('slow check', §6.4) — BOINC actually
        enforces one per *volunteer*; we key on the volunteer of record
        captured at dispatch time."""
        if self.use_indexes:
            if host_id in self._job_hosts.get(job_id, ()):
                return True
            host = self.hosts.get(host_id)
            return host is not None and host.volunteer_id in self._job_vols.get(job_id, ())
        # oracle path: resolve the volunteer via the hosts table at query
        # time (the seed semantics), independent of the observer-captured
        # assignment sets it is used to cross-check
        host = self.hosts.get(host_id)
        vol = host.volunteer_id if host else None
        for inst in self.job_instances(job_id):
            if inst.host_id is None:
                continue
            h = self.hosts.get(inst.host_id)
            if inst.host_id == host_id or (vol is not None and h is not None and h.volunteer_id == vol):
                return True
        return False

    def hosts_with_instance(self, job_id: int) -> Set[int]:
        """Host ids ever assigned an instance of ``job_id`` (work-spreading
        constraint, §3.4). Index path reads the maintained assignment set;
        the oracle path rebuilds it by scanning the job's instances — the
        two agree because instances persist until the job row is purged and
        the purge pops the set."""
        if self.use_indexes:
            return self._job_hosts.get(job_id, set())
        return {i.host_id for i in self.job_instances(job_id) if i.host_id is not None}

    def in_progress_instances(self) -> List[JobInstance]:
        """IN_PROGRESS instances in ascending id order (defense spread
        sweep). Index path reads the state index; oracle path scans."""
        if self.use_indexes:
            insts = self.instances
            return [
                insts[iid]
                for iid in sorted(self._insts_by_state[InstanceState.IN_PROGRESS])
                if iid in insts
            ]
        return sorted(
            (i for i in self.instances.values()
             if i.state == InstanceState.IN_PROGRESS),
            key=lambda i: i.id,
        )

    def unsent_job_ids(self) -> Set[int]:
        """Job ids with at least one UNSENT instance (defense HR-relax
        sweep). Index path reads the state index; oracle path scans."""
        if self.use_indexes:
            insts = self.instances
            return {
                insts[iid].job_id
                for iid in self._insts_by_state[InstanceState.UNSENT]
                if iid in insts
            }
        return {
            i.job_id
            for i in self.instances.values()
            if i.state == InstanceState.UNSENT
        }

    # ---- batch bookkeeping (§3.9) ----

    def batch_done(self, batch_id: int) -> bool:
        b = self.batches.get(batch_id)
        if b is None:
            return False
        if self.use_indexes:
            return bool(b.job_ids) and self._batch_open.get(batch_id, 0) <= 0
        return all(
            j not in self.jobs or self.jobs[j].state in _TERMINAL
            for j in b.job_ids  # rows already purged count as done (§4)
        )

    def drain_completed_batches(self) -> List[int]:
        """Batches whose last job just reached a terminal state, ascending."""
        out = sorted(self.batch_done_pending)
        self.batch_done_pending.clear()
        return out

    # ---- queries for daemons ----
    #
    # ``pending_*`` are what the daemons consume: the indexed path reads the
    # maintained queues (O(pending)); the oracle path falls back to the
    # original full scans. Both return ascending job id for determinism.

    def pending_transitions(self, instance: int = 0, n_instances: int = 1) -> List[Job]:
        if self.use_indexes:
            ids = self.transition_pending
        else:
            ids = (j.id for j in self.jobs_with_flag())
        return [self.jobs[j] for j in sorted(shard(ids, instance, n_instances))]

    def pending_validation(self, instance: int = 0, n_instances: int = 1) -> Set[int]:
        """Job ids (one daemon shard) with at least one fresh success — an
        OVER/SUCCESS instance whose validate_state is still INIT.

        The batch validation engine intersects this with the flagged-job
        list to pick the jobs that need the digest pass; the oracle path
        falls back to a full instance-table scan.
        """
        if self.use_indexes:
            ids: Iterable[int] = self.validation_pending
        else:
            ids = {
                inst.job_id
                for inst in self.instances.values()
                if _is_fresh_success(inst)
            }
        return set(shard(ids, instance, n_instances))

    def pending_assimilation(self) -> List[Job]:
        source = self.assimilate_pending if self.use_indexes else (
            j.id for j in self.jobs_to_assimilate()
        )
        return [self.jobs[j] for j in sorted(source)]

    def pending_file_deletion(self) -> List[Job]:
        """Delete-pending jobs that are *ready* — no outstanding (UNSENT /
        IN_PROGRESS) instance. The indexed path reads ``delete_ready``, so
        jobs blocked on a straggler instance cost nothing per tick: their
        re-check is deferred to the instance-terminal event that drops the
        outstanding count to zero. The oracle path keeps the original scan
        over all delete-pending jobs — the deleter daemon re-applies the
        outstanding check itself, so both paths converge on the same jobs.
        """
        source = self.delete_ready if self.use_indexes else (
            j.id for j in self.jobs_to_delete_files()
        )
        return [self.jobs[j] for j in sorted(source)]

    def purgeable_jobs(self, cutoff: float) -> List[Job]:
        """Purge-pending jobs with ``created_time <= cutoff``, ascending id.

        Indexed path: pops the purge heap down to ``cutoff`` — jobs inside
        the retention window stay heaped and cost nothing per tick. Popped
        jobs are expected to be purged by the caller (the purger daemon);
        stale entries are dropped on pop.
        """
        if not self.use_indexes:
            return sorted(
                (j for j in self.jobs_to_purge() if j.created_time <= cutoff),
                key=lambda j: j.id,
            )
        out: List[Job] = []
        h = self._purge_heap
        while h and h[0][0] <= cutoff:
            created, jid = heapq.heappop(h)
            job = self.jobs.get(jid)
            if job is None or jid not in self.purge_pending or job.created_time != created:
                continue  # stale entry
            out.append(job)
        out.sort(key=lambda j: j.id)
        return out

    def expired_instances(self, now: float, instance: int = 0, n_instances: int = 1) -> List[JobInstance]:
        """IN_PROGRESS instances past deadline, for one daemon shard (§5.1).

        Indexed path: pop the deadline heap down to ``now`` — O(expired log
        heap) instead of a full instance-table scan. Entries belonging to
        other shards are pushed back for their transitioner instance.
        """
        if not self.use_indexes:
            return [
                inst
                for inst in self.instances.values()
                if inst.state == InstanceState.IN_PROGRESS
                and now > inst.deadline > 0
                and inst.job_id % n_instances == instance
            ]
        h = self._deadline_heap
        in_progress = self._insts_by_state[InstanceState.IN_PROGRESS]
        if len(h) > 1024 and len(h) > 4 * len(in_progress):
            # mostly-stale heap (instances completed before their deadline):
            # rebuild from live rows so pops stay O(expired)
            h[:] = [
                (inst.deadline, iid)
                for iid in in_progress
                if (inst := self.instances[iid]).deadline > 0
            ]
            heapq.heapify(h)
        out: List[JobInstance] = []
        other_shards: List[Tuple[float, int]] = []
        while h and h[0][0] < now:
            deadline, iid = heapq.heappop(h)
            inst = self.instances.get(iid)
            if (
                inst is None
                or inst.state != InstanceState.IN_PROGRESS
                or inst.deadline != deadline
                or deadline <= 0
            ):
                continue  # stale entry
            if inst.job_id % n_instances != instance:
                other_shards.append((deadline, iid))
                continue
            out.append(inst)
        for entry in other_shards:
            heapq.heappush(h, entry)
        return out

    def status_counts(self) -> Dict[str, int]:
        if self.use_indexes:
            return {
                "jobs_active": len(self._jobs_by_state[JobState.ACTIVE]),
                "jobs_success": len(self._jobs_by_state[JobState.SUCCESS]),
                "jobs_failure": len(self._jobs_by_state[JobState.FAILURE]),
                "instances_unsent": len(self._insts_by_state[InstanceState.UNSENT]),
                "instances_in_progress": len(self._insts_by_state[InstanceState.IN_PROGRESS]),
            }
        jobs = self.jobs.values()
        return {
            "jobs_active": sum(1 for j in jobs if j.state == JobState.ACTIVE),
            "jobs_success": sum(1 for j in self.jobs.values() if j.state == JobState.SUCCESS),
            "jobs_failure": sum(1 for j in self.jobs.values() if j.state == JobState.FAILURE),
            "instances_unsent": sum(
                1 for i in self.instances.values() if i.state == InstanceState.UNSENT
            ),
            "instances_in_progress": sum(
                1 for i in self.instances.values() if i.state == InstanceState.IN_PROGRESS
            ),
        }

    # ---- scan queries (debug / oracle path) ----

    def jobs_with_flag(self) -> List[Job]:
        return [j for j in self.jobs.values() if j.transition_flag and j.state == JobState.ACTIVE]

    def jobs_to_assimilate(self) -> List[Job]:
        return [
            j
            for j in self.jobs.values()
            if j.state in _TERMINAL and not j.assimilated
        ]

    def jobs_to_delete_files(self) -> List[Job]:
        return [
            j
            for j in self.jobs.values()
            if j.assimilated and not j.files_deleted
        ]

    def jobs_to_purge(self) -> List[Job]:
        return [
            j
            for j in self.jobs.values()
            if j.assimilated and j.files_deleted and j.state != JobState.PURGED
        ]

    def purge_job(self, job: Job) -> None:
        """Remove completed rows; the DB is a cache of jobs in progress, not
        an archive (§4)."""
        jid = job.id
        for iid in self._by_job.get(jid, []):
            inst = self.instances.pop(iid, None)
            if inst is not None:
                self._insts_by_state[inst.state].discard(iid)
                object.__setattr__(inst, "_store", None)
        self._by_job.pop(jid, None)
        self._job_hosts.pop(jid, None)
        self._job_vols.pop(jid, None)
        self._fresh_success.pop(jid, None)
        self.validation_pending.discard(jid)
        self._job_outstanding.pop(jid, None)
        self.delete_ready.discard(jid)
        job.state = JobState.PURGED
        self.jobs.pop(jid, None)
        self._jobs_by_state[JobState.PURGED].discard(jid)
        for pending in (
            self.transition_pending,
            self.assimilate_pending,
            self.delete_pending,
            self.purge_pending,
        ):
            pending.discard(jid)
        object.__setattr__(job, "_store", None)
        self.mutations += 1

    # ------------------------------------------------------------------
    # index maintenance: rows notify us on tracked-field assignment
    # (types.IndexObserved) — the moral equivalent of index updates
    # riding along with every UPDATE in the real schema (§5.1)
    # ------------------------------------------------------------------

    def _on_field_change(self, row, name: str, old, new) -> None:
        if isinstance(row, Job):
            self._job_changed(row, name, old, new)
        else:
            self._instance_changed(row, name, old, new)

    def _job_changed(self, job: Job, name: str, old, new) -> None:
        if name == "transition_flag":
            # hot path (every report/clear toggles it): only the
            # transition-pending set can change
            _set_membership(
                self.transition_pending, job.id,
                new and job.state == JobState.ACTIVE,
            )
            return
        if name == "state":
            self._jobs_by_state[old].discard(job.id)
            self._jobs_by_state[new].add(job.id)
            if job.batch_id:
                was_open = old not in _TERMINAL and old != JobState.PURGED
                is_open = new not in _TERMINAL and new != JobState.PURGED
                if was_open and not is_open:
                    left = self._batch_open.get(job.batch_id, 0) - 1
                    self._batch_open[job.batch_id] = left
                    if left <= 0:
                        b = self.batches.get(job.batch_id)
                        if b is not None and b.job_ids and b.completed_time is None:
                            self.batch_done_pending.add(job.batch_id)
                elif is_open and not was_open:
                    self._batch_open[job.batch_id] = self._batch_open.get(job.batch_id, 0) + 1
                    self.batch_done_pending.discard(job.batch_id)
        self._reindex_job(job)

    def _reindex_job(self, job: Job) -> None:
        jid = job.id
        _set_membership(
            self.transition_pending, jid,
            job.transition_flag and job.state == JobState.ACTIVE,
        )
        _set_membership(
            self.assimilate_pending, jid,
            job.state in _TERMINAL and not job.assimilated,
        )
        delete_pending = job.assimilated and not job.files_deleted
        _set_membership(self.delete_pending, jid, delete_pending)
        _set_membership(
            self.delete_ready, jid,
            delete_pending and self._job_outstanding.get(jid, 0) == 0,
        )
        want_purge = job.assimilated and job.files_deleted and job.state != JobState.PURGED
        if want_purge and jid not in self.purge_pending:
            heapq.heappush(self._purge_heap, (job.created_time, jid))
        _set_membership(self.purge_pending, jid, want_purge)

    def _instance_changed(self, inst: JobInstance, name: str, old, new) -> None:
        # validation-pending maintenance: the freshness predicate depends on
        # (state, outcome, validate_state); evaluate the before/after pair
        # inline with the two unchanged fields short-circuiting first
        if name == "state":
            if (
                inst.outcome is InstanceOutcome.SUCCESS
                and inst.validate_state is ValidateState.INIT
            ):
                was = old is InstanceState.OVER
                now_fresh = new is InstanceState.OVER
                if was != now_fresh:
                    self._fresh_delta(inst.job_id, 1 if now_fresh else -1)
        elif name == "outcome":
            if (
                inst.state is InstanceState.OVER
                and inst.validate_state is ValidateState.INIT
            ):
                was = old is InstanceOutcome.SUCCESS
                now_fresh = new is InstanceOutcome.SUCCESS
                if was != now_fresh:
                    self._fresh_delta(inst.job_id, 1 if now_fresh else -1)
            return
        elif name == "validate_state":
            if (
                inst.state is InstanceState.OVER
                and inst.outcome is InstanceOutcome.SUCCESS
            ):
                was = old is ValidateState.INIT
                now_fresh = new is ValidateState.INIT
                if was != now_fresh:
                    self._fresh_delta(inst.job_id, 1 if now_fresh else -1)
            return
        if name == "state":
            self._insts_by_state[old].discard(inst.id)
            self._insts_by_state[new].add(inst.id)
            was_out = old in (InstanceState.UNSENT, InstanceState.IN_PROGRESS)
            now_out = new in (InstanceState.UNSENT, InstanceState.IN_PROGRESS)
            if was_out != now_out:
                self._outstanding_delta(inst.job_id, 1 if now_out else -1)
            if new == InstanceState.IN_PROGRESS and inst.deadline > 0:
                heapq.heappush(self._deadline_heap, (inst.deadline, inst.id))
            elif new == InstanceState.UNSENT:
                # a row returned to the dispatchable pool re-enters the
                # queue — unless its previous entry is still queued (it
                # simply becomes live again)
                job = self.jobs.get(inst.job_id)
                if job is not None:
                    queued = self._unsent_ids.setdefault(job.app_name, set())
                    if inst.id not in queued:
                        self._unsent.setdefault(job.app_name, deque()).append(inst.id)
                        queued.add(inst.id)
        elif name == "deadline":
            if inst.state == InstanceState.IN_PROGRESS and new > 0:
                heapq.heappush(self._deadline_heap, (new, inst.id))
        elif name == "host_id" and new is not None:
            self._job_hosts.setdefault(inst.job_id, set()).add(new)
            host = self.hosts.get(new)
            if host is not None:
                inst.volunteer_id = host.volunteer_id
                self._job_vols.setdefault(inst.job_id, set()).add(host.volunteer_id)

    def clear_transition_flags(self, jobs: List[Job]) -> None:
        """Bulk flag clear for one tick's pending list (batch validation
        engine): same end state as per-job ``transition_flag = False``, with
        one set-difference instead of per-write observer dispatch."""
        for job in jobs:
            object.__setattr__(job, "transition_flag", False)
        self.transition_pending.difference_update([j.id for j in jobs])

    def finish_jobs(self, entries: List[Tuple[Job, int]]) -> None:
        """Bulk ACTIVE→SUCCESS completion for one tick's decided jobs
        (batch validation engine): ``(job, canonical_instance_id)`` pairs.

        Replicates exactly what per-field assignment would do — state-set
        moves, transition/assimilate pending membership, batch open-count
        bookkeeping — as fused set operations. The jobs are ACTIVE (so not
        yet assimilated; the delete/purge indexes cannot change) and end
        with ``transition_flag=True`` exactly like the scalar
        ``_validate`` epilogue. ``check_invariants`` cross-checks this
        against the scan semantics.
        """
        ids = []
        for job, canonical_id in entries:
            job.canonical_instance_id = canonical_id
            object.__setattr__(job, "state", JobState.SUCCESS)
            object.__setattr__(job, "transition_flag", True)
            ids.append(job.id)
            if job.batch_id:
                left = self._batch_open.get(job.batch_id, 0) - 1
                self._batch_open[job.batch_id] = left
                if left <= 0:
                    b = self.batches.get(job.batch_id)
                    if b is not None and b.job_ids and b.completed_time is None:
                        self.batch_done_pending.add(job.batch_id)
        self._jobs_by_state[JobState.ACTIVE].difference_update(ids)
        self._jobs_by_state[JobState.SUCCESS].update(ids)
        # flag is set but the job is no longer ACTIVE: not transition-pending
        self.transition_pending.difference_update(ids)
        self.assimilate_pending.update(ids)

    def set_validate_states(self, insts: List[JobInstance], vstate: ValidateState) -> None:
        """Bulk validate_state assignment (batch validation engine): same
        index maintenance as per-field assignment, minus the per-write
        observer dispatch; freshness deltas are aggregated per job before
        touching the validation-pending index."""
        deltas: Dict[int, int] = {}
        to_init = vstate is ValidateState.INIT
        init = ValidateState.INIT
        over = InstanceState.OVER
        success = InstanceOutcome.SUCCESS
        for inst in insts:
            d = inst.__dict__
            old = d.get("validate_state")
            if old is vstate:
                continue
            d["validate_state"] = vstate
            if d.get("_store") is None:
                continue
            if d["state"] is over and d["outcome"] is success:
                if (old is init) != to_init:
                    jid = inst.job_id
                    deltas[jid] = deltas.get(jid, 0) + (1 if to_init else -1)
        for jid, delta in deltas.items():
            self._fresh_delta(jid, delta)

    def _outstanding_delta(self, job_id: int, delta: int) -> None:
        """Maintain the per-job outstanding-instance count and, for
        delete-pending jobs, the readiness set — the instance-terminal
        event that replaces the deleter's per-tick re-scan."""
        c = self._job_outstanding.get(job_id, 0) + delta
        if c <= 0:
            self._job_outstanding.pop(job_id, None)
        else:
            self._job_outstanding[job_id] = c
        if job_id in self.delete_pending:
            _set_membership(self.delete_ready, job_id, c <= 0)

    def _fresh_delta(self, job_id: int, delta: int) -> None:
        c = self._fresh_success.get(job_id, 0) + delta
        if c <= 0:
            self._fresh_success.pop(job_id, None)
            self.validation_pending.discard(job_id)
        else:
            self._fresh_success[job_id] = c
            self.validation_pending.add(job_id)

    # ------------------------------------------------------------------
    # invariant checker: index ↔ scan agreement
    # ------------------------------------------------------------------

    def check_invariants(self) -> None:
        """Assert every maintained index agrees with a full-table scan.

        This is the oracle tying the O(dirty) daemon path back to the seed
        semantics; tests and the simulator audit path call it.
        """
        problems: List[str] = []

        expect_jobs: Dict[JobState, Set[int]] = {s: set() for s in JobState}
        for j in self.jobs.values():
            expect_jobs[j.state].add(j.id)
        for s in JobState:
            if self._jobs_by_state[s] != expect_jobs[s]:
                problems.append(
                    f"jobs_by_state[{s}] diverged: "
                    f"extra={sorted(self._jobs_by_state[s] - expect_jobs[s])[:5]} "
                    f"missing={sorted(expect_jobs[s] - self._jobs_by_state[s])[:5]}"
                )

        expect_insts: Dict[InstanceState, Set[int]] = {s: set() for s in InstanceState}
        for i in self.instances.values():
            expect_insts[i.state].add(i.id)
        for s in InstanceState:
            if self._insts_by_state[s] != expect_insts[s]:
                problems.append(f"insts_by_state[{s}] diverged")

        scans = {
            "transition_pending": (self.transition_pending, self.jobs_with_flag()),
            "assimilate_pending": (self.assimilate_pending, self.jobs_to_assimilate()),
            "delete_pending": (self.delete_pending, self.jobs_to_delete_files()),
            "purge_pending": (self.purge_pending, self.jobs_to_purge()),
        }
        for label, (idx, scan) in scans.items():
            scan_ids = {j.id for j in scan}
            if idx != scan_ids:
                problems.append(
                    f"{label} diverged: extra={sorted(idx - scan_ids)[:5]} "
                    f"missing={sorted(scan_ids - idx)[:5]}"
                )

        for bid, b in self.batches.items():
            expect_open = sum(
                1
                for j in b.job_ids
                if (jb := self.jobs.get(j)) is not None and jb.state == JobState.ACTIVE
            )
            if self._batch_open.get(bid, 0) != expect_open:
                problems.append(
                    f"batch {bid} open-count {self._batch_open.get(bid, 0)} != scan {expect_open}"
                )
        for bid in self.batch_done_pending:
            if self._batch_open.get(bid, 0) > 0:
                problems.append(f"batch {bid} flagged done with open jobs")

        live_deadlines = {
            (inst.deadline, iid)
            for iid, inst in self.instances.items()
            if inst.state == InstanceState.IN_PROGRESS and inst.deadline > 0
        }
        missing = live_deadlines - set(self._deadline_heap)
        if missing:
            problems.append(f"deadline heap missing live entries: {sorted(missing)[:5]}")

        live_purge = {
            (self.jobs[jid].created_time, jid)
            for jid in self.purge_pending
            if jid in self.jobs
        }
        missing_purge = live_purge - set(self._purge_heap)
        if missing_purge:
            problems.append(f"purge heap missing live entries: {sorted(missing_purge)[:5]}")

        queued: Set[int] = set()
        for app_name, q in self._unsent.items():
            entries = set(q)
            if len(entries) != len(q):
                problems.append(f"dispatch queue for {app_name!r} has duplicate entries")
            if entries != self._unsent_ids.get(app_name, set()):
                problems.append(f"dispatch-queue mirror set for {app_name!r} diverged")
            queued.update(entries)
        for iid in self._insts_by_state[InstanceState.UNSENT]:
            if iid not in queued:
                problems.append(f"UNSENT instance {iid} not in any dispatch queue")
                break

        expect_fresh: Dict[int, int] = {}
        for i in self.instances.values():
            if _is_fresh_success(i):
                expect_fresh[i.job_id] = expect_fresh.get(i.job_id, 0) + 1
        if self._fresh_success != expect_fresh:
            diff = set(self._fresh_success.items()) ^ set(expect_fresh.items())
            problems.append(f"fresh-success counts diverged: {sorted(diff)[:5]}")
        if self.validation_pending != set(expect_fresh):
            problems.append(
                "validation_pending diverged: "
                f"extra={sorted(self.validation_pending - set(expect_fresh))[:5]} "
                f"missing={sorted(set(expect_fresh) - self.validation_pending)[:5]}"
            )

        expect_out: Dict[int, int] = {}
        for i in self.instances.values():
            if i.state in (InstanceState.UNSENT, InstanceState.IN_PROGRESS):
                expect_out[i.job_id] = expect_out.get(i.job_id, 0) + 1
        if self._job_outstanding != expect_out:
            diff = set(self._job_outstanding.items()) ^ set(expect_out.items())
            problems.append(f"outstanding-instance counts diverged: {sorted(diff)[:5]}")
        expect_ready = {
            j.id
            for j in self.jobs_to_delete_files()
            if not any(i.is_outstanding() for i in self.job_instances(j.id))
        }
        if self.delete_ready != expect_ready:
            problems.append(
                "delete_ready diverged: "
                f"extra={sorted(self.delete_ready - expect_ready)[:5]} "
                f"missing={sorted(expect_ready - self.delete_ready)[:5]}"
            )

        expect_hosts: Dict[int, Set[int]] = {}
        expect_vols: Dict[int, Set[int]] = {}
        for inst in self.instances.values():
            if inst.host_id is not None:
                expect_hosts.setdefault(inst.job_id, set()).add(inst.host_id)
            if inst.volunteer_id is not None:
                expect_vols.setdefault(inst.job_id, set()).add(inst.volunteer_id)
        for label, idx, expect in (
            ("job_hosts", self._job_hosts, expect_hosts),
            ("job_vols", self._job_vols, expect_vols),
        ):
            for jid, members in expect.items():
                if not members <= idx.get(jid, set()):
                    problems.append(f"{label}[{jid}] missing assignments")
                    break

        if problems:
            raise AssertionError("store index invariants violated:\n  " + "\n  ".join(problems))


def _set_membership(s: Set[int], item: int, member: bool) -> None:
    if member:
        s.add(item)
    else:
        s.discard(item)


def _is_fresh_success(inst: JobInstance, **override) -> bool:
    """The validation-pending predicate (§4): a completed success whose
    validate_state is still INIT. ``override`` substitutes one field's prior
    value so observers can evaluate the predicate before a mutation."""
    state = override.get("state", inst.state)
    outcome = override.get("outcome", inst.outcome)
    vstate = override.get("validate_state", inst.validate_state)
    return (
        state == InstanceState.OVER
        and outcome == InstanceOutcome.SUCCESS
        and vstate == ValidateState.INIT
    )
