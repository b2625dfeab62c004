"""Defense-in-depth replica placement (§3.4).

Three cooperating server-side mechanisms close the clique quorum-defeat
hole the adversarial scenario matrix pinned (ROADMAP item 4):

1. **Work-spreading** — an agreement-statistics tracker fed from the
   validation finalize path maintains pairwise co-validation counts and
   per-host won/lost decision counts. Hosts that keep losing decisions
   (judged INVALID more often than they validate) and habitually agree
   with each other form *suspicion clusters*; dispatch never sends two
   replicas of one job to hosts in the same cluster. When the eligible
   fleet is too small to satisfy the constraint it is *relaxed* (counted,
   never deadlocked).
2. **Homogeneous redundancy** — jobs are pinned to the `hr_class` of
   their first-dispatched replica (``core/types.hr_class``; enforced by
   the scalar `_score` check and the fused HR mask column in
   `core/batch_dispatch.py`). The layer adds a *census guard*: a job is
   only pinned when its class holds at least `min_quorum` live hosts, so
   tiny classes cannot strand a job short of quorum.
3. **Host punishment** — a per-(host, app-version) daily quota (the
   paper's ``max_jobs_per_day``): halved on INVALID/error outcomes,
   incremented on VALID, reset each (virtual) day. Punished hosts are
   additionally deferred through a per-host `ExponentialBackoff` whose
   failure/success registrations ride the same validation events.

Parity contract: the layer is fed from call sites that are provably
identical across the scalar oracle and the vectorized engines — the
shared ``Scheduler._dispatch`` / ``_slow_check`` choke points on the
dispatch side, and the validation finalize path on the outcome side
(scalar ``_post_validation_updates`` inline; batch mode defers the same
(valid, invalid) host/version pairs into ``ValidationPlan.defense_events``
and replays them sequentially in ``_finalize_plan``). It consumes **no
shared RNG stream**: backoffs use their own per-host seeded generators,
so engine/oracle RNG-state identity survives.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Callable, Dict, Iterable, List, Optional, Set, Tuple

import numpy as np

from .backoff import ExponentialBackoff
from .types import (
    App,
    AppVersion,
    HRLevel,
    Host,
    InstanceOutcome,
    InstanceState,
    Job,
    hr_class,
)

if TYPE_CHECKING:  # pragma: no cover
    from .store import JobStore

__all__ = ["DefensePolicy", "DefenseLayer"]


@dataclass(frozen=True)
class DefensePolicy:
    """Knobs for the defense layer (frozen: embeddable in `ScenarioSpec`)."""

    # Homogeneous redundancy granularity applied to the project's apps.
    hr_level: HRLevel = HRLevel.COARSE
    # Host punishment (§3.4 max_jobs_per_day analogue). The quota starts
    # generous — it is a punishment device, not a throttle: honest hosts
    # never feel it, while a repeat offender is halved to quota_min within
    # a handful of INVALID decisions.
    quota_init: float = 32.0
    quota_min: float = 1.0
    quota_max: float = 64.0
    day_seconds: float = 86400.0
    # Punishment deferral: per-host exponential backoff bumped on every
    # INVALID/error outcome, reset on VALID. Zero jitter by default so
    # golden scenario bounds stay exactly reproducible.
    backoff_min: float = 1800.0
    backoff_max: float = 4 * 3600.0
    backoff_jitter: float = 0.0
    # Work-spreading: a host is *suspicious* once it lost >= suspect_lost
    # finalized decisions and has not validated at least suspect_ratio
    # times as often as it lost. The ratio keeps merely-flaky honest hosts
    # (a few percent INVALID, validating constantly) out of clusters while
    # catching colluders, who split their decisions between wins inside
    # the clique and losses against honest pairs — roughly 1:1, nowhere
    # near the exoneration ratio. Suspicious hosts sharing >=
    # spread_min_agree agreements cluster together.
    suspect_lost: int = 1
    suspect_ratio: float = 4.0
    spread_min_agree: int = 1
    # Accomplice rule: a host that never looks suspicious on its own (HR
    # pinning can pair a colluder exclusively with its partner, so it never
    # loses) still joins a cluster when one suspicious member accounts for
    # at least this fraction of its lifetime validations. Honest hosts
    # spread their wins across many partners and stay well under it.
    accomplice_frac: float = 0.5
    # Above this fleet size the relaxation scan assumes an eligible host
    # exists (honest large fleets have no clusters; the scan is O(hosts)).
    spread_scan_cap: int = 4096


@dataclass
class DefenseLayer:
    """Mutable defense state for one project server.

    All tables are purged per host via :meth:`forget_host` alongside the
    estimator/reputation purges, so churned identities leak nothing.
    """

    policy: DefensePolicy
    store: "JobStore"

    # -- host punishment: dense interned (host, app-version) quota table --
    _host_idx: Dict[int, int] = field(default_factory=dict)
    _ver_idx: Dict[int, int] = field(default_factory=dict)
    quota: np.ndarray = field(default_factory=lambda: np.zeros((0, 0)))
    sent: np.ndarray = field(default_factory=lambda: np.zeros((0, 0), dtype=np.int64))
    day: np.ndarray = field(default_factory=lambda: np.zeros((0, 0), dtype=np.int64))
    _backoff: Dict[int, ExponentialBackoff] = field(default_factory=dict)

    # -- work-spreading: agreement statistics + suspicion clusters --
    _agree: Dict[int, Dict[int, int]] = field(default_factory=dict)
    _lost: Dict[int, int] = field(default_factory=dict)
    _validated: Dict[int, int] = field(default_factory=dict)
    _cluster_of: Dict[int, int] = field(default_factory=dict)
    _clusters_dirty: bool = False

    # -- homogeneous redundancy: class census + interned class ids --
    _hr_of_host: Dict[int, Tuple] = field(default_factory=dict)
    _hr_census: Dict[Tuple, int] = field(default_factory=dict)
    _hr_ids: Dict[Tuple, int] = field(default_factory=dict)

    # -- effectiveness counters (exported into ScenarioResult reports) --
    # per-host denial attribution: which mechanism blocked which host
    denied_quota_by: Dict[int, int] = field(default_factory=dict)
    denied_spread_by: Dict[int, int] = field(default_factory=dict)
    deferred_by: Dict[int, int] = field(default_factory=dict)
    cancelled_by: Dict[int, int] = field(default_factory=dict)
    quota_denials: int = 0
    quota_deferrals: int = 0
    spread_denials: int = 0
    spread_relaxations: int = 0
    spread_cancellations: int = 0
    hr_pins: int = 0
    hr_pin_blocked: int = 0
    hr_relaxations: int = 0
    dispatches: int = 0

    # invalidates the persistent vectorized dispatch snapshot after an HR
    # unpin mutates job.hr_class behind its back (wired to Feeder.invalidate
    # by the server; the scalar oracle path ignores cache generations)
    invalidate_dispatch: Optional[Callable[[], None]] = None

    # ------------------------------------------------------------------
    # registration / churn
    # ------------------------------------------------------------------

    def on_host_added(self, host: Host) -> None:
        cls = hr_class(host, self.policy.hr_level)
        self._hr_of_host[host.id] = cls
        self._hr_census[cls] = self._hr_census.get(cls, 0) + 1

    def forget_host(self, host_id: int) -> None:
        """Purge every per-host trace (churn/Sybil: rejoin leaks nothing)."""
        cls = self._hr_of_host.pop(host_id, None)
        if cls is not None:
            n = self._hr_census.get(cls, 0) - 1
            if n > 0:
                self._hr_census[cls] = n
            else:
                self._hr_census.pop(cls, None)
        self._lost.pop(host_id, None)
        self._validated.pop(host_id, None)
        self._backoff.pop(host_id, None)
        self.denied_quota_by.pop(host_id, None)
        self.denied_spread_by.pop(host_id, None)
        self.deferred_by.pop(host_id, None)
        self.cancelled_by.pop(host_id, None)
        row = self._agree.pop(host_id, None)
        if row:
            for other in row:
                peers = self._agree.get(other)
                if peers is not None:
                    peers.pop(host_id, None)
        hr = self._host_idx.get(host_id)
        if hr is not None:
            # reset the row to the fresh-host default; the dense slot stays
            # mapped so a same-id rejoin starts from a clean slate
            self.quota[hr, :] = self.policy.quota_init
            self.sent[hr, :] = 0
            self.day[hr, :] = -1
        if host_id in self._cluster_of:
            self._clusters_dirty = True

    # ------------------------------------------------------------------
    # homogeneous redundancy
    # ------------------------------------------------------------------

    def hr_id_of(self, host: Host) -> int:
        """Interned integer id of the host's HR class (world column)."""
        cls = self._hr_of_host.get(host.id)
        if cls is None:
            cls = hr_class(host, self.policy.hr_level)
        return self._intern_hr(cls)

    def _intern_hr(self, cls: Tuple) -> int:
        hid = self._hr_ids.get(cls)
        if hid is None:
            hid = len(self._hr_ids)
            self._hr_ids[cls] = hid
        return hid

    def can_pin(self, host: Host, app: App, job: Job) -> bool:
        """Census guard: only pin a job to a class with enough live hosts
        to reach quorum (otherwise leave it unpinned — logged, not fatal)."""
        need = max(job.min_quorum, 1)
        if app.hr_level == self.policy.hr_level:
            cls = self._hr_of_host.get(host.id)
            if cls is None:
                cls = hr_class(host, app.hr_level)
            n = self._hr_census.get(cls, 0)
        else:  # census maintained at the policy level only; rare mismatch
            cls = hr_class(host, app.hr_level)
            n = sum(1 for h in self.store.hosts.values() if hr_class(h, app.hr_level) == cls)
        if n >= need:
            self.hr_pins += 1
            return True
        self.hr_pin_blocked += 1
        return False

    def tick_sweep(self, now: float, instance: int = 0, n_instances: int = 1) -> None:
        """Per-transitioner-tick enforcement sweep (shared choke point).

        Runs after the tick's validation finalize, when both validation
        engines hold identical store state, so every decision below is
        engine-identical: (1) abort in-flight co-placements inside a
        suspicion cluster (the reactive arm of work-spreading — dispatch
        checks cannot claw back replicas that were placed before the
        cluster formed), then (2) unpin HR-stuck retries.
        """
        self.cancel_clustered_inflight(now, instance, n_instances)
        self.relax_stuck_hr(instance, n_instances)

    def cancel_clustered_inflight(
        self, now: float, instance: int = 0, n_instances: int = 1
    ) -> None:
        """Server-side abort (§4 job cancellation) of same-cluster replicas.

        The clique's damage is done in the initial placement burst: hosts
        buffer work long before the first validation returns, so by the
        time agreement statistics identify a cluster, the co-placed wrong
        pairs are already in flight. For every job with >= 2 IN_PROGRESS
        replicas on hosts of one cluster, all but the first are aborted
        (OVER/ABANDONED, like a detach) and the transitioner re-issues
        them under the now-active spread constraint. A late report from
        the aborted host is ignored by the scheduler report path. Each
        abort burns one of the job's error slots, so cancellation stops
        while enough slots remain for real failures (never drives a job
        to MAX_ERROR failure)."""
        if self._clusters_dirty:
            self._rebuild_clusters()
        if not self._cluster_of:
            return
        by_job: Dict[int, List] = {}
        for inst in self.store.in_progress_instances():
            if inst.job_id % n_instances != instance:
                continue
            if inst.host_id is None:
                continue
            cl = self._cluster_of.get(inst.host_id)
            if cl is not None:
                by_job.setdefault(inst.job_id, []).append((cl, inst))
        for jid, entries in by_job.items():
            if len(entries) < 2:
                continue
            job = self.store.jobs.get(jid)
            if job is None:
                continue
            n_err = sum(
                1
                for i in self.store.job_instances(jid)
                if i.state == InstanceState.OVER
                and i.outcome
                in (
                    InstanceOutcome.CLIENT_ERROR,
                    InstanceOutcome.NO_REPLY,
                    InstanceOutcome.ABANDONED,
                    InstanceOutcome.VALIDATE_ERROR,
                )
            )
            budget = job.max_error_instances - n_err - 1
            seen_cluster: Set[int] = set()
            for cl, inst in entries:  # ascending instance id (store order)
                if cl not in seen_cluster:
                    seen_cluster.add(cl)  # first replica in the cluster stays
                    continue
                if budget <= 0:
                    break
                inst.state = InstanceState.OVER
                inst.outcome = InstanceOutcome.ABANDONED
                job.transition_flag = True
                self.spread_cancellations += 1
                if inst.host_id is not None:
                    self.cancelled_by[inst.host_id] = (
                        self.cancelled_by.get(inst.host_id, 0) + 1
                    )
                budget -= 1

    def relax_stuck_hr(self, instance: int = 0, n_instances: int = 1) -> None:
        """Unpin jobs whose HR class can no longer serve a waiting replica.

        A pinned job with an UNSENT instance is *stuck* when every live
        host of its class already holds an instance of it (one instance
        per host, §6.4) — a retry created after an error/INVALID in a
        small class would otherwise wait forever. Unpinning (logged, like
        the spread relaxation) trades comparability for liveness; the
        census guard makes this rare. Runs from the transitioner tick
        (sharded like the flagged-job pass) so both validation engines see
        identical post-finalize store state when the decision is taken.
        """
        unpinned = False
        for jid in sorted(self.store.unsent_job_ids()):
            if jid % n_instances != instance:
                continue
            job = self.store.jobs.get(jid)
            if job is None or job.hr_class is None:
                continue
            app = self.store.apps.get(job.app_name)
            if app is None or app.hr_level != self.policy.hr_level:
                continue
            n_class = self._hr_census.get(job.hr_class, 0)
            holders = self.store.hosts_with_instance(jid)
            in_class = sum(
                1 for h in holders if self._hr_of_host.get(h) == job.hr_class
            )
            if n_class <= in_class:
                job.hr_class = None
                self.hr_relaxations += 1
                unpinned = True
        if unpinned and self.invalidate_dispatch is not None:
            # the vectorized dispatch snapshot caches hr_id per slot; force
            # a rebuild so it re-reads the cleared pins (scalar parity)
            self.invalidate_dispatch()

    # ------------------------------------------------------------------
    # dispatch-side enforcement
    # ------------------------------------------------------------------

    def check_dispatch(self, job: Job, host: Host, version: AppVersion, now: float) -> bool:
        """Slow-check extension: punishment deferral, daily quota, spread."""
        hid = host.id
        bo = self._backoff.get(hid)
        if bo is not None and not bo.ready(now):
            self.quota_deferrals += 1
            self.deferred_by[hid] = self.deferred_by.get(hid, 0) + 1
            return False
        hr, vr = self._cell(hid, version.id, now)
        if self.sent[hr, vr] >= self.quota[hr, vr]:
            self.quota_denials += 1
            self.denied_quota_by[hid] = self.denied_quota_by.get(hid, 0) + 1
            return False
        cl = self.cluster_of(hid)
        if cl is not None:
            holders = self.store.hosts_with_instance(job.id)
            clash = any(h != hid and self._cluster_of.get(h) == cl for h in holders)
            if clash:
                if self._eligible_exists(job, holders):
                    self.spread_denials += 1
                    self.denied_spread_by[hid] = self.denied_spread_by.get(hid, 0) + 1
                    return False
                # eligible fleet too small: relax rather than deadlock
                self.spread_relaxations += 1
        return True

    def on_dispatch(self, job: Job, app: App, host: Host, version: AppVersion, now: float) -> None:
        hr, vr = self._cell(host.id, version.id, now)
        self.sent[hr, vr] += 1
        self.dispatches += 1

    def _eligible_exists(self, job: Job, holders: Set[int]) -> bool:
        """Is there any other host this replica could go to instead?

        Membership checks only (not quota/backoff — those are transient):
        a non-holder host outside every holder's cluster, in the job's HR
        class when pinned. Scanning is O(hosts); beyond ``spread_scan_cap``
        hosts we assume eligibility (clusters are tiny relative to such
        fleets) and keep the constraint strict.
        """
        hosts = self.store.hosts
        if len(hosts) > self.policy.spread_scan_cap:
            return True
        holder_clusters = {self._cluster_of[h] for h in holders if h in self._cluster_of}
        app = self.store.apps.get(job.app_name)
        level = app.hr_level if app is not None else HRLevel.NONE
        for h_id, h in hosts.items():
            if h_id in holders:
                continue
            if self._cluster_of.get(h_id) in holder_clusters:
                continue
            if level != HRLevel.NONE and job.hr_class is not None:
                if hr_class(h, level) != job.hr_class:
                    continue
            return True
        return False

    # ------------------------------------------------------------------
    # validation-side feedback (identical scalar / deferred-batch feed)
    # ------------------------------------------------------------------

    def on_validation(
        self,
        valid: List[Tuple[int, int]],
        invalid: List[Tuple[int, int]],
        now: float,
    ) -> None:
        """One finalized decision: (host, app-version) pairs judged VALID /
        INVALID. Called inline on the scalar path and replayed from
        ``ValidationPlan.defense_events`` in the same order on the batch
        path — bit-equal counters by construction."""
        p = self.policy
        for hid, vid in valid:
            hr, vr = self._cell_nodate(hid, vid)
            q = self.quota[hr, vr] + 1.0
            self.quota[hr, vr] = q if q < p.quota_max else p.quota_max
            self._validated[hid] = self._validated.get(hid, 0) + 1
            bo = self._backoff.get(hid)
            if bo is not None:
                bo.register_success()
        if len(valid) >= 2:
            hosts = [h for h, _ in valid]
            for i in range(len(hosts)):
                for j in range(i + 1, len(hosts)):
                    self._bump_agree(hosts[i], hosts[j])
            self._clusters_dirty = True
        judged = bool(valid)  # only count losses against actual validators
        for hid, vid in invalid:
            self._punish(hid, vid, now)
            if judged:
                self._lost[hid] = self._lost.get(hid, 0) + 1
                self._clusters_dirty = True
        if len(invalid) >= 2:
            # Colluders outvoted by an honest quorum still *agreed with each
            # other* — co-INVALID results in one decision are an agreement
            # signal too. (Independently flaky hosts can also land here, but
            # they validate far more than they lose, never turn suspicious,
            # and so the edges stay inert for them.) This is what lets
            # clusters form from the clique's losses instead of needing it
            # to win quorums first.
            hosts = [h for h, _ in invalid]
            for i in range(len(hosts)):
                for j in range(i + 1, len(hosts)):
                    self._bump_agree(hosts[i], hosts[j])
            self._clusters_dirty = True

    def on_error(self, host_id: int, app_version_id: int, now: float) -> None:
        """Non-validation failure (compute error, crash, deadline miss)."""
        self._punish(host_id, app_version_id, now)

    def _punish(self, hid: int, vid: int, now: float) -> None:
        p = self.policy
        hr, vr = self._cell_nodate(hid, vid)
        q = self.quota[hr, vr] * 0.5
        self.quota[hr, vr] = q if q > p.quota_min else p.quota_min
        bo = self._backoff.get(hid)
        if bo is None:
            bo = ExponentialBackoff(
                min_interval=p.backoff_min,
                max_interval=p.backoff_max,
                jitter=p.backoff_jitter,
                seed=hid,
            )
            self._backoff[hid] = bo
        bo.register_failure(now)

    def _bump_agree(self, a: int, b: int) -> None:
        self._agree.setdefault(a, {})[b] = self._agree.get(a, {}).get(b, 0) + 1
        self._agree.setdefault(b, {})[a] = self._agree.get(b, {}).get(a, 0) + 1

    # ------------------------------------------------------------------
    # suspicion clusters
    # ------------------------------------------------------------------

    def cluster_of(self, host_id: int) -> Optional[int]:
        if self._clusters_dirty:
            self._rebuild_clusters()
        return self._cluster_of.get(host_id)

    def clusters(self) -> Dict[int, int]:
        """host_id -> cluster id (smallest member); components of size >= 2."""
        if self._clusters_dirty:
            self._rebuild_clusters()
        return dict(self._cluster_of)

    def _suspicious(self, hid: int) -> bool:
        lost = self._lost.get(hid, 0)
        if lost < self.policy.suspect_lost:
            return False
        return self._validated.get(hid, 0) < lost * self.policy.suspect_ratio

    def _rebuild_clusters(self) -> None:
        p = self.policy
        sus = {h for h in self._lost if self._suspicious(h)}
        cluster_of: Dict[int, int] = {}
        seen: Set[int] = set()
        for h in sorted(sus):
            if h in seen:
                continue
            comp = [h]
            seen.add(h)
            stack = [h]
            while stack:
                # Only suspicious nodes expand the frontier; accomplices
                # (below) join as leaves so one shared partner cannot
                # chain two unrelated honest hosts into a cluster.
                x = stack.pop()
                for y, c in sorted(self._agree.get(x, {}).items()):
                    if c < p.spread_min_agree or y in seen:
                        continue
                    if y in sus:
                        seen.add(y)
                        comp.append(y)
                        stack.append(y)
                    elif c >= p.accomplice_frac * self._validated.get(y, 0):
                        seen.add(y)
                        comp.append(y)
            if len(comp) >= 2:
                cid = min(comp)
                for x in comp:
                    cluster_of[x] = cid
        self._cluster_of = cluster_of
        self._clusters_dirty = False

    # ------------------------------------------------------------------
    # quota table plumbing (dense interned rows, à la AdaptiveReplication)
    # ------------------------------------------------------------------

    def _cell(self, hid: int, vid: int, now: float) -> Tuple[int, int]:
        """(row, col) with the daily send counter reset applied."""
        hr, vr = self._cell_nodate(hid, vid)
        d = int(now // self.policy.day_seconds)
        if self.day[hr, vr] != d:
            self.day[hr, vr] = d
            self.sent[hr, vr] = 0
        return hr, vr

    def _cell_nodate(self, hid: int, vid: int) -> Tuple[int, int]:
        hr = self._host_idx.get(hid)
        if hr is None:
            hr = len(self._host_idx)
            self._host_idx[hid] = hr
            if hr >= self.quota.shape[0]:
                self._grow(rows=max(self.quota.shape[0] * 2, hr + 1, 16))
        vr = self._ver_idx.get(vid)
        if vr is None:
            vr = len(self._ver_idx)
            self._ver_idx[vid] = vr
            if vr >= self.quota.shape[1]:
                self._grow(cols=max(self.quota.shape[1] * 2, vr + 1, 4))
        return hr, vr

    def _grow(self, rows: Optional[int] = None, cols: Optional[int] = None) -> None:
        r = rows if rows is not None else self.quota.shape[0]
        c = cols if cols is not None else self.quota.shape[1]
        q = np.full((r, c), self.policy.quota_init, dtype=np.float64)
        s = np.zeros((r, c), dtype=np.int64)
        d = np.full((r, c), -1, dtype=np.int64)
        r0, c0 = self.quota.shape
        q[:r0, :c0] = self.quota
        s[:r0, :c0] = self.sent
        d[:r0, :c0] = self.day
        self.quota, self.sent, self.day = q, s, d

    # ------------------------------------------------------------------
    # reporting
    # ------------------------------------------------------------------

    def quota_of(self, host_id: int, app_version_id: int) -> float:
        hr = self._host_idx.get(host_id)
        vr = self._ver_idx.get(app_version_id)
        if hr is None or vr is None:
            return self.policy.quota_init
        return float(self.quota[hr, vr])

    def counters(self) -> Dict[str, int]:
        if self._clusters_dirty:
            self._rebuild_clusters()
        sizes: Dict[int, int] = {}
        for cid in self._cluster_of.values():
            sizes[cid] = sizes.get(cid, 0) + 1
        return {
            "quota_denials": self.quota_denials,
            "quota_deferrals": self.quota_deferrals,
            "spread_denials": self.spread_denials,
            "spread_relaxations": self.spread_relaxations,
            "spread_cancellations": self.spread_cancellations,
            "hr_pins": self.hr_pins,
            "hr_pin_blocked": self.hr_pin_blocked,
            "hr_relaxations": self.hr_relaxations,
            "dispatches": self.dispatches,
            "n_clusters": len(sizes),
            "cluster_sizes": sorted(sizes.values(), reverse=True),
            "suspicious_hosts": sorted(h for h in self._lost if self._suspicious(h)),
        }
