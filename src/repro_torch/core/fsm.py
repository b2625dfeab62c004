"""The transitioner: the job-lifecycle finite-state machine (§4, §5.1).

"Viewing the progress of a job as a finite-state machine, this handles the
transitions. The events that trigger transitions come from potentially
concurrent processes like schedulers and validators. Instead of handling the
transitions, these programs set a flag in the job's database record. The
transitioner enumerates these records and processes them. This eliminates
the need for concurrency control of DB access."

Responsibilities per job (§4):
  * create the initial ``init_ninstances`` instances;
  * on deadline pass, mark instances NO_REPLY and create replacements;
  * trigger validation at quorum; designate the canonical instance;
  * grant credit (via the credit system) to valid instances;
  * cancel unsent instances once a canonical instance exists;
  * enforce max_error_instances / max_success_instances;
  * mark jobs for assimilation/file-deletion/purge.

Two implementations drive the validate pass:

  * **scalar oracle** (``batch_validate=False``): per-job Python —
    ``check_set`` pairwise comparator grouping, immediate per-instance
    credit/reputation updates. Faithful and simple; the parity reference.
  * **batch engine** (``batch_validate=True``, the default): a
    :class:`~repro_torch.core.batch_validate.BatchValidationEngine` pre-pass
    computes per-job counts, payload digests, and quorum decisions for the
    whole tick in fused array passes; the per-job loop applies them, and
    credit/reputation flush once at end of tick (ordered, so granted
    credit is bit-equal to the oracle). See ``core/batch_validate.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from .adaptive import AdaptiveReplication
from .credit import CreditSystem
from .defense import DefenseLayer
from .store import JobStore
from .types import (
    App,
    InstanceOutcome,
    InstanceState,
    Job,
    JobInstance,
    JobState,
    ValidateState,
)
from .validator import check_set, validate_against_canonical


@dataclass
class TransitionerMetrics:
    timeouts: int = 0
    retries_created: int = 0
    jobs_validated: int = 0
    jobs_failed: int = 0
    instances_cancelled: int = 0
    credit_granted: float = 0.0


@dataclass
class Transitioner:
    """Drives job state transitions against a JobStore (§5.1).

    ``instance``/``n_instances`` implement ID-space daemon sharding.
    """

    store: JobStore
    credit: Optional[CreditSystem] = None
    adaptive: Optional[AdaptiveReplication] = None
    instance: int = 0
    n_instances: int = 1
    batch_validate: bool = True
    # execution backend handed to BatchValidationEngine ("numpy" | "jax");
    # "jax" routes homogeneous tensor payload digests through the
    # kernels/quorum_compare Pallas kernel
    engine_backend: str = "numpy"
    # defense layer (§3.4): validation outcomes feed its agreement stats +
    # per-(host, version) quota table. Scalar path calls it inline; batch
    # path defers the identical (valid, invalid) pair lists through
    # ``ValidationPlan.defense_events`` and replays them in finalize order.
    defense: Optional[DefenseLayer] = None
    metrics: TransitionerMetrics = field(default_factory=TransitionerMetrics)
    _engine: object = field(default=None, repr=False)
    # tick-start snapshot of the defense suspicion clusters (host -> cluster
    # id). Quorum decisions consult the snapshot — not live cluster state —
    # so the scalar loop (which feeds the defense layer mid-tick) and the
    # batch engine (which defers the feed to finalize) decide identically.
    _sus_clusters: Dict[int, int] = field(default_factory=dict, repr=False)

    # ------------------------------------------------------------------

    def tick(self, now: float) -> int:
        """One daemon pass: handle deadline misses, then flagged jobs.

        Both passes enumerate the store's indexes (deadline heap, pending
        queue) so the cost is O(work to do), not O(table size); with
        ``store.use_indexes=False`` they fall back to the oracle scans.
        With ``batch_validate`` the flagged-job pass is preceded by the
        engine's fused pre-pass and followed by the credit/reputation
        flush.

        Returns the number of jobs transitioned.
        """
        self._sus_clusters = (
            self.defense.clusters() if self.defense is not None else {}
        )
        self._check_deadlines(now)
        pending = self.store.pending_transitions(self.instance, self.n_instances)
        plan = None
        if self.batch_validate and pending:
            if self._engine is None:
                from .batch_validate import BatchValidationEngine

                self._engine = BatchValidationEngine(
                    self.store, backend=self.engine_backend
                )
            plan = self._engine.prepare(
                pending, now, self.instance, self.n_instances,
                clusters=self._sus_clusters,
            )
        n = 0
        if plan is not None:
            from .batch_validate import DECIDED

            # flag clears, validate-state writes, job completions, and
            # credit/reputation events are deferred into fused bulk passes;
            # the per-job loop applies decisions (the common fully-decided
            # job inline) and tops up instances — order-identical to
            # scalar, since nothing in the loop reads another job's
            # deferred state
            self.store.clear_transition_flags(pending)
            decisions = plan.decisions
            n_error = plan.n_error
            n_succ = plan.n_succ
            metrics = self.metrics
            adaptive = self.adaptive
            credit = self.credit
            apps = self.store.apps
            valid_bulk = plan.valid_bulk
            invalid_bulk = plan.invalid_bulk
            finish = plan.finish
            adp_h = plan.adp_h
            adp_v = plan.adp_v
            adp_ok = plan.adp_ok
            err_out = plan.err_outcome
            credit_entries = plan.credit_entries
            peers_cache = plan.peers_cache
            for pos, job in enumerate(pending):
                dec = decisions[pos]
                if (
                    dec is not None
                    and dec[0] is DECIDED
                    and n_error[pos] <= job.max_error_instances
                ):
                    # common case inlined: queue the decided job's deferred
                    # effects (same order/content as _queue_event)
                    _, canonical, valid, invalid = dec
                    valid_bulk.extend(valid)
                    if invalid:
                        invalid_bulk.extend(invalid)
                    finish.append((job, canonical.id))
                    metrics.jobs_validated += 1
                    if adaptive is not None:
                        if n_succ[pos] >= 2:
                            for i in valid:
                                if i.host_id is not None and i.app_version_id is not None:
                                    adp_h.append(i.host_id)
                                    adp_v.append(i.app_version_id)
                                    adp_ok.append(True)
                        for i in invalid:
                            if i.host_id is not None and i.app_version_id is not None:
                                adp_h.append(i.host_id)
                                adp_v.append(i.app_version_id)
                                adp_ok.append(False)
                            err_out.append(i)
                    if self.defense is not None:
                        plan.defense_events.append((
                            [(i.host_id, i.app_version_id) for i in valid
                             if i.host_id is not None and i.app_version_id is not None],
                            [(i.host_id, i.app_version_id) for i in invalid
                             if i.host_id is not None and i.app_version_id is not None],
                        ))
                    if credit is not None and valid:
                        peers = peers_cache.get(job.app_name)
                        if peers is None:
                            peers = peers_cache[job.app_name] = [
                                v.id for v in apps[job.app_name].latest_versions()
                            ]
                        credit_entries.append((job, valid, peers))
                else:
                    self._transition(job, now, plan, pos)
                n += 1
            self._finalize_plan(plan, now)
        else:
            for job in pending:
                job.transition_flag = False
                self._transition(job, now)
                n += 1
        if self.defense is not None:
            # enforcement sweep: abort clustered in-flight co-placements and
            # unpin HR-stuck retries. After the finalize / scalar loop above
            # both validation engines hold identical store state, so the
            # sweep's decisions are engine-identical.
            self.defense.tick_sweep(now, self.instance, self.n_instances)
        return n

    # ------------------------------------------------------------------

    def _check_deadlines(self, now: float) -> None:
        """Instances past deadline are assumed lost (§4).

        Deadline handling is sharded by ``job_id % n_instances`` like the
        flagged-job pass — each transitioner instance mutates only its own
        ID-space shard (§5.1).
        """
        for inst in self.store.expired_instances(now, self.instance, self.n_instances):
            inst.state = InstanceState.OVER
            inst.outcome = InstanceOutcome.NO_REPLY
            self.metrics.timeouts += 1
            job = self.store.jobs.get(inst.job_id)
            if job is not None:
                job.transition_flag = True
            if self.adaptive is not None and inst.host_id is not None \
                    and inst.app_version_id is not None:
                self.adaptive.on_invalid(inst.host_id, inst.app_version_id)
            if self.defense is not None and inst.host_id is not None \
                    and inst.app_version_id is not None:
                self.defense.on_error(inst.host_id, inst.app_version_id, now)

    # ------------------------------------------------------------------

    def _transition(self, job: Job, now: float, plan=None, pos: int = 0) -> None:
        app = self.store.apps[job.app_name]
        if plan is not None:
            n_outstanding = int(plan.n_outstanding[pos])
            successes = plan.successes(pos)
            n_error = int(plan.n_error[pos])
            n_total = int(plan.n_total[pos])
        else:
            insts = self.store.job_instances(job.id)
            n_outstanding = sum(1 for i in insts if i.is_outstanding())
            successes = [
                i
                for i in insts
                if i.state == InstanceState.OVER and i.outcome == InstanceOutcome.SUCCESS
            ]
            n_error = sum(
                1
                for i in insts
                if i.state == InstanceState.OVER
                and i.outcome
                in (
                    InstanceOutcome.CLIENT_ERROR,
                    InstanceOutcome.NO_REPLY,
                    InstanceOutcome.ABANDONED,
                    InstanceOutcome.VALIDATE_ERROR,
                )
            )
            n_total = len(insts)

        # -- failure limits (§4) --
        if n_error > job.max_error_instances:
            self._fail_job(job, "too many errored instances")
            return

        # -- validation (§4) --
        if job.canonical_instance_id is None:
            if plan is not None:
                has_fresh = bool(plan.fresh[pos])
            else:
                has_fresh = any(
                    s.validate_state == ValidateState.INIT for s in successes
                )
            quorum = self._required_quorum(job)
            if len(successes) >= quorum and has_fresh:
                if plan is not None:
                    if self._apply_decision(job, app, successes, now, plan, pos):
                        return  # decided: completion deferred to finalize
                else:
                    self._validate(job, app, successes, now)
                if job.state != JobState.ACTIVE:
                    return
            if job.canonical_instance_id is None and len(successes) > job.max_success_instances:
                self._fail_job(job, "too many successes without consensus")
                return
        else:
            # late-arriving successes validate against the canonical (§4)
            canonical = self.store.instances.get(job.canonical_instance_id)
            if canonical is not None:
                self._validate_stragglers(
                    job, app, canonical, successes, now, plan, pos
                )

        if job.state != JobState.ACTIVE:
            return

        # -- instance top-up (§4) --
        if job.canonical_instance_id is None:
            target = self._target_instances(job, n_total)
            # Count outstanding plus the largest mutually-agreeing group of
            # successes: "if the outputs agree, they are accepted ...
            # otherwise a third instance is created and run" (§3.4). Two
            # disagreeing successes contribute 1, forcing a tie-breaker.
            clusters = self._sus_clusters
            if clusters and self._has_cluster_pair(successes, clusters):
                # same-cluster successes count as one vote (work-spreading):
                # force the scalar group scan so the top-up sees the reduced
                # effective agreement and issues the tie-breaking replica
                agree = self._largest_agreeing_group(app, successes, clusters)
            elif plan is not None:
                agree = plan.largest_agreeing_group(pos, app, successes)
            else:
                agree = self._largest_agreeing_group(app, successes)
            live = n_outstanding + agree
            total_created = n_total
            while live < target:
                # cap total instance creation to avoid unbounded retry loops
                if total_created >= job.max_error_instances + job.max_success_instances + 1:
                    break
                self.store.create_instance(job)
                if total_created >= job.init_ninstances:
                    self.metrics.retries_created += 1
                live += 1
                total_created += 1
        else:
            # canonical exists: cancel unsent instances (§4)
            if plan is not None:
                unsent = plan.unsent(pos)
            else:
                unsent = [i for i in insts if i.state == InstanceState.UNSENT]
            for i in unsent:
                if i.state == InstanceState.UNSENT:
                    i.state = InstanceState.OVER
                    i.outcome = InstanceOutcome.CANCELLED
                    self.metrics.instances_cancelled += 1

    # ------------------------------------------------------------------

    def _required_quorum(self, job: Job) -> int:
        """Adaptive replication (§3.4): unreplicated jobs have quorum 1."""
        return job.min_quorum

    def _target_instances(self, job: Job, n_total: int) -> int:
        if n_total == 0:
            return job.init_ninstances
        return job.min_quorum

    @staticmethod
    def _has_cluster_pair(
        successes: List[JobInstance], clusters: Dict[int, int]
    ) -> bool:
        """Do two successes come from hosts of the same suspicion cluster?"""
        seen: set = set()
        for s in successes:
            cl = clusters.get(s.host_id) if s.host_id is not None else None
            if cl is not None:
                if cl in seen:
                    return True
                seen.add(cl)
        return False

    @staticmethod
    def _largest_agreeing_group(
        app: App,
        successes: List[JobInstance],
        clusters: Optional[Dict[int, int]] = None,
    ) -> int:
        from .validator import bitwise_equal, effective_quorum_size

        viable = [s for s in successes if s.validate_state != ValidateState.INVALID]
        if len(viable) <= 1:
            return len(viable)
        cmp = app.comparator or bitwise_equal
        groups: List[List[JobInstance]] = []
        for inst in viable:
            for g in groups:
                if cmp(g[0].output, inst.output):
                    g.append(inst)
                    break
            else:
                groups.append([inst])
        if clusters:
            return max(effective_quorum_size(g, clusters) for g in groups)
        return max(len(g) for g in groups)

    # ------------------------------------------------------------------

    def _validate(self, job: Job, app: App, successes: List[JobInstance],
                  now: float, plan=None) -> None:
        result = check_set(
            successes, app.comparator, self._required_quorum(job),
            clusters=self._sus_clusters,
        )
        if result.canonical is None:
            return  # inconclusive; transitioner will top up instances
        job.canonical_instance_id = result.canonical.id
        self.metrics.jobs_validated += 1
        self._post_validation_updates(
            job, app, result.valid, result.invalid, now,
            by_replication=len(successes) >= 2, plan=plan,
        )
        job.state = JobState.SUCCESS
        job.transition_flag = True

    def _apply_decision(self, job: Job, app: App, successes: List[JobInstance],
                        now: float, plan, pos: int) -> bool:
        """Engine counterpart of :meth:`_validate`: consume the plan's
        precomputed quorum decision (digest grouping) for this job.

        Returns True when the job was decided — its SUCCESS completion and
        validate-state writes are queued for the fused finalize pass and
        the caller must stop transitioning it (scalar control-flow parity:
        ``_validate`` would have left it non-ACTIVE).
        """
        from .batch_validate import INCONCLUSIVE

        dec = plan.decisions[pos]
        if dec is not None and dec[0] is INCONCLUSIVE:
            # deferred: nothing later in this job's transition distinguishes
            # INIT from INCONCLUSIVE (top-up only excludes INVALID)
            plan.inconclusive_bulk.extend(successes)
            return False
        # DECIDED jobs are consumed by tick()'s inline fast path (its gate
        # is the exact complement of _transition's error-limit check, so a
        # DECIDED decision cannot reach here); everything else — no
        # precomputed decision, or a comparator/payload that isn't
        # digestable — runs the scalar oracle, with credit/reputation still
        # deferred through the plan so the tick-wide event order matches
        # sequential processing
        self._validate(job, app, successes, now, plan=plan)
        return job.state != JobState.ACTIVE

    def _validate_stragglers(self, job: Job, app: App, canonical: JobInstance,
                             successes: List[JobInstance], now: float,
                             plan, pos: int) -> None:
        """Late successes reported after the canonical exists (§4)."""
        digs = plan.digests(pos) if plan is not None else None
        canon_dig = None
        if digs is not None:
            for k, s in enumerate(successes):
                if s.id == canonical.id:
                    canon_dig = digs[k]
                    break
        for k, s in enumerate(successes):
            if s.id == canonical.id or s.validate_state != ValidateState.INIT:
                continue
            if canon_dig is not None:
                ok = bool(digs[k] == canon_dig)
                (plan.valid_bulk if ok else plan.invalid_bulk).append(s)
            else:
                ok = validate_against_canonical(s, canonical, app.comparator)
            self._post_validation_updates(
                job, app, [s] if ok else [], [] if ok else [s], now,
                by_replication=True, plan=plan,
            )

    def _post_validation_updates(
        self,
        job: Job,
        app: App,
        valid: List[JobInstance],
        invalid: List[JobInstance],
        now: float,
        by_replication: bool = True,
        plan=None,
    ) -> None:
        if plan is not None:
            # engine mode: defer to the fused end-of-tick flush, preserving
            # the per-job event order the scalar loop would have produced
            self._queue_event(plan, job, valid, invalid, by_replication)
            return
        # adaptive-replication reputation (§3.4): N counts only jobs
        # "validated by replication" — trusted singletons don't build it.
        if self.adaptive is not None:
            if by_replication:
                for i in valid:
                    if i.host_id is not None and i.app_version_id is not None:
                        self.adaptive.on_validated(i.host_id, i.app_version_id)
            for i in invalid:
                if i.host_id is not None and i.app_version_id is not None:
                    self.adaptive.on_invalid(i.host_id, i.app_version_id)
                i.outcome = InstanceOutcome.VALIDATE_ERROR

        # defense layer (§3.4): one finalized decision's outcome pairs feed
        # the agreement stats + quota table (valids unconditionally — the
        # by_replication gate is adaptive-reputation-specific)
        if self.defense is not None:
            self.defense.on_validation(
                [(i.host_id, i.app_version_id) for i in valid
                 if i.host_id is not None and i.app_version_id is not None],
                [(i.host_id, i.app_version_id) for i in invalid
                 if i.host_id is not None and i.app_version_id is not None],
                now,
            )

        # credit (§7): grant the outlier-robust average to all valid instances
        if self.credit is not None and valid:
            peer_vids = [v.id for v in self.store.apps[job.app_name].latest_versions()]
            claims = []
            for i in valid:
                self.credit.record(i, job)
                i.claimed_credit = self.credit.claimed_credit(i, peer_vids)
                claims.append(i.claimed_credit)
            grant = CreditSystem.grant_amount(claims)
            for i in valid:
                i.granted_credit = grant
                host = self.store.hosts.get(i.host_id) if i.host_id else None
                self.credit.grant(f"host:{i.host_id}", grant, now)
                if host is not None:
                    self.credit.grant(f"volunteer:{host.volunteer_id}", grant, now)
                self.metrics.credit_granted += grant

    # ------------------------------------------------------------------

    def _queue_event(self, plan, job: Job, valid: List[JobInstance],
                     invalid: List[JobInstance], by_replication: bool) -> None:
        """Queue one job's validation outcome onto the plan's deferred
        reputation/credit structures, in processing order — exactly the
        sequence the scalar ``_post_validation_updates`` would apply."""
        if self.adaptive is not None:
            adp_h = plan.adp_h
            adp_v = plan.adp_v
            adp_ok = plan.adp_ok
            if by_replication:
                for i in valid:
                    if i.host_id is not None and i.app_version_id is not None:
                        adp_h.append(i.host_id)
                        adp_v.append(i.app_version_id)
                        adp_ok.append(True)
            for i in invalid:
                if i.host_id is not None and i.app_version_id is not None:
                    adp_h.append(i.host_id)
                    adp_v.append(i.app_version_id)
                    adp_ok.append(False)
                plan.err_outcome.append(i)
        if self.defense is not None:
            plan.defense_events.append((
                [(i.host_id, i.app_version_id) for i in valid
                 if i.host_id is not None and i.app_version_id is not None],
                [(i.host_id, i.app_version_id) for i in invalid
                 if i.host_id is not None and i.app_version_id is not None],
            ))
        if self.credit is not None and valid:
            peers = plan.peers_cache.get(job.app_name)
            if peers is None:
                peers = plan.peers_cache[job.app_name] = [
                    v.id for v in self.store.apps[job.app_name].latest_versions()
                ]
            plan.credit_entries.append((job, valid, peers))

    def _finalize_plan(self, plan, now: float) -> None:
        """Flush the tick's deferred effects in fused passes: bulk
        validate-state writes and job completions, one vectorized
        reputation pass, and one batched credit-ingestion pass — all in
        the exact event order the scalar loop would have applied them.
        Nothing in the transition loop reads credit, reputation, or
        another job's deferred state, so the flush is observationally
        identical to inline updates."""
        store = self.store
        if plan.valid_bulk:
            store.set_validate_states(plan.valid_bulk, ValidateState.VALID)
        if plan.invalid_bulk:
            store.set_validate_states(plan.invalid_bulk, ValidateState.INVALID)
        if plan.inconclusive_bulk:
            store.set_validate_states(
                plan.inconclusive_bulk, ValidateState.INCONCLUSIVE
            )
        if plan.finish:
            store.finish_jobs(plan.finish)
        if self.adaptive is not None:
            for i in plan.err_outcome:
                i.outcome = InstanceOutcome.VALIDATE_ERROR
            if plan.adp_h:
                self.adaptive.apply_events(plan.adp_h, plan.adp_v, plan.adp_ok)
        if self.defense is not None:
            # sequential replay of the tick's decisions in scalar order:
            # the quota halve/increment fold is order-sensitive, so this is
            # bit-equal to the inline scalar calls by construction
            for vpairs, ipairs in plan.defense_events:
                self.defense.on_validation(vpairs, ipairs, now)
        if self.credit is not None and plan.credit_entries:
            entries = plan.credit_entries
            grants = self.credit.ingest_batch(entries)
            hosts = store.hosts
            by_key: Dict[str, List[float]] = {}
            # hosts repeat across the tick's instances: resolve each host's
            # accounting keys (and amount lists) once
            key_lists: Dict[Any, Tuple[List[float], Optional[List[float]]]] = {}
            metrics = self.metrics
            for (job, valid, _), grant in zip(entries, grants):
                for i in valid:
                    i.__dict__["granted_credit"] = grant  # untracked field
                    hid = i.host_id
                    pair = key_lists.get(hid)
                    if pair is None:
                        hlist = by_key.setdefault(f"host:{hid}", [])
                        host = hosts.get(hid) if hid else None
                        vlist = (
                            by_key.setdefault(f"volunteer:{host.volunteer_id}", [])
                            if host is not None
                            else None
                        )
                        pair = key_lists[hid] = (hlist, vlist)
                    pair[0].append(grant)
                    if pair[1] is not None:
                        pair[1].append(grant)
                    metrics.credit_granted += grant
            self.credit.grant_many(by_key, now)

    def _fail_job(self, job: Job, reason: str) -> None:
        job.state = JobState.FAILURE
        job.error_mask |= 1
        self.metrics.jobs_failed += 1
        # cancel any unsent instances
        for i in self.store.job_instances(job.id):
            if i.state == InstanceState.UNSENT:
                i.state = InstanceState.OVER
                i.outcome = InstanceOutcome.CANCELLED
