"""Vectorized batch-dispatch engine (§5.1, §6.4).

The paper's headline server-scaling claim — hundreds of dispatches per
second from one machine — rests on scoring candidates out of a shared-memory
job cache rather than the DB. The scalar ``Scheduler._candidate_list`` /
``_score`` path reproduces the *policy* faithfully but pays O(slots²) Python
per request (the skipped-count lookup rescans the cache per scored slot),
which caps the dispatch benchmark and the EmBOINC-style simulator (§9) far
below the populations where volunteer computing pays off.

This module materializes the feeder's cache into struct-of-arrays form once
per batch of requesting hosts and computes the §6.4 score for all cache
slots × one host as fused NumPy passes:

  * static per-slot arrays: size class, est. FLOP count, disk bound, delay
    bound, priority, submitter index, keyword-set index, HR-class id,
    pinned/homogeneous-version ids, target host;
  * per-host vector passes: eligibility masks (slot valid, targeted-job,
    HR-class, keyword veto), the weighted score sum, deadline/disk
    feasibility inputs (est. and availability-scaled runtimes), and a
    stable descending-score ordering (the top-k gather: the dispatch tail
    consumes candidates lazily and stops once the request is satisfied).

Scoring is bit-exact with the scalar path: every per-element operation
mirrors ``Scheduler._score`` in IEEE-754 order, group-level computations
(app-version selection, size quantiles, submitter balances, keyword scores)
call the *same* scalar helpers once per distinct group instead of once per
slot, and the dispatch tail reports slot mutations back via ``apply`` so
later requests in a batch observe taken slots, skip bumps, and HR /
homogeneous-app-version locks exactly as under sequential execution.
``tests/test_batch_dispatch.py`` asserts assignment- and metrics-level
parity with N sequential ``handle_request`` calls.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .backend import resolve_backend
from .keywords import keyword_score
from .scheduler import (
    Candidate,
    Feeder,
    ScheduleRequest,
    Scheduler,
    W_BALANCE,
    W_KEYWORD,
    W_LOCALITY,
    W_PRIORITY,
    W_SIZE_MATCH,
    W_SKIPPED,
)
from .store import JobStore
from .types import (
    AppVersion,
    HRLevel,
    Host,
    InstanceState,
    Job,
    ResourceType,
    hr_class,
)


@dataclass
class _GroupChoice:
    """Resolved app-version choice for one (app, pin, hav) slot group."""

    version: Optional[AppVersion]
    usage: Dict[ResourceType, float]
    pf: float  # proj_flops(host, version)
    size_q: int  # host's size-class quantile for the app, -1 if n/a


class BatchDispatchEngine:
    """Struct-of-arrays snapshot of the feeder cache + per-host vector scoring.

    Built once per ``Scheduler.handle_batch`` call; array positions are the
    feeder's slot positions, so the scalar scan's rotated ordering (random
    start point, §5.1) is reproduced by index arithmetic. Mutations made by
    the dispatch tail are folded back in via :meth:`apply`.
    """

    def __init__(self, store: JobStore, feeder: Feeder,
                 backend: str = "numpy",
                 shard_map=None, shard: Optional[int] = None) -> None:
        self.store = store
        self.feeder = feeder
        # federated dispatch (core/shard.py): when given, the snapshot only
        # materializes the cache positions ``shard`` owns — the validity
        # mask, the per-job slot lists and the skip bookkeeping all become
        # slice-local, mirroring the scalar scan's ownership filter. Array
        # length stays the full cache size so the rotated-scan index
        # arithmetic (and the scheduler's RNG draw over ``engine.n``) is
        # unchanged.
        self.shard_map = shard_map
        self.shard = shard
        # execution backend for the dense mask/score passes: NumPy only in
        # the port (core/backend.py)
        self.backend = resolve_backend(backend)
        # cache-content generation this snapshot was built at; the
        # scheduler's persistent-dispatch path rebuilds when it trails
        # ``feeder.version`` (dispatch-tail mutations arrive as events and
        # do not bump the generation)
        self.version = feeder.version
        slots = feeder.slots
        n = len(slots)
        self.n = n
        self.slots = list(slots)  # live CacheSlot refs, frozen positions

        self.app_names: List[str] = list(store.apps)
        self._app_index = {a: i for i, a in enumerate(self.app_names)}
        self.apps = [store.apps[a] for a in self.app_names]

        self.valid = np.zeros(n, dtype=bool)
        self.job_id = np.full(n, -1, dtype=np.int64)
        self.app_idx = np.zeros(n, dtype=np.int64)
        self.est_flop = np.zeros(n, dtype=np.float64)
        self.disk = np.zeros(n, dtype=np.float64)
        self.delay = np.zeros(n, dtype=np.float64)
        self.prio = np.zeros(n, dtype=np.float64)
        self.size_class = np.zeros(n, dtype=np.int64)
        self.target = np.full(n, -1, dtype=np.int64)
        self.pin = np.full(n, -1, dtype=np.int64)
        self.hav = np.full(n, -1, dtype=np.int64)
        self.hr_id = np.full(n, -1, dtype=np.int64)
        self.sub_idx = np.zeros(n, dtype=np.int64)
        self.kw_idx = np.zeros(n, dtype=np.int64)
        self.skips = np.zeros(n, dtype=np.float64)
        self.loc_mask = np.zeros(n, dtype=bool)  # locality app + input files
        self.input_files: List[Tuple[str, ...]] = [()] * n

        self._hr_ids: Dict[Tuple, int] = {}
        self._submitters: List[str] = []
        sub_ids: Dict[str, int] = {}
        self._kw_tuples: List[Tuple[str, ...]] = []
        kw_ids: Dict[Tuple[str, ...], int] = {}
        # job id -> ordered feeder positions still occupied by its slots
        # (taken slots included: the scalar skip lookup counts them, §6.4)
        self._job_slots: Dict[int, List[int]] = {}

        owner = shard_map.owner if shard_map is not None else None
        for i, slot in enumerate(slots):
            if slot is None:
                continue
            if owner is not None and owner[i] != shard:
                continue
            job = store.jobs.get(slot.job_id)
            if job is None:
                continue
            self._job_slots.setdefault(job.id, []).append(i)
            if slot.taken:
                continue
            inst = store.instances.get(slot.instance_id)
            if inst is None or inst.state != InstanceState.UNSENT:
                # stale slot (instance cancelled/timed out since the feeder
                # cached it): exclude it so ``valid`` is exact — the bulk
                # reject classification (cache-miss vs skip-bump) relies on
                # it. The feeder clears stale slots on every fill, so this
                # probe only matters for engines built mid-staleness.
                continue
            app = store.apps[job.app_name]
            self.valid[i] = True
            self.job_id[i] = job.id
            self.app_idx[i] = self._app_index[job.app_name]
            self.est_flop[i] = job.est_flop_count
            self.disk[i] = job.disk_bytes
            self.delay[i] = job.delay_bound
            self.prio[i] = job.priority
            self.size_class[i] = job.size_class
            if job.target_host is not None:
                self.target[i] = job.target_host
            if job.pinned_version_num is not None:
                self.pin[i] = job.pinned_version_num
            if job.hav_version_id is not None:
                self.hav[i] = job.hav_version_id
            if app.hr_level != HRLevel.NONE and job.hr_class is not None:
                self.hr_id[i] = self._intern_hr(job.hr_class)
            if job.submitter not in sub_ids:
                sub_ids[job.submitter] = len(self._submitters)
                self._submitters.append(job.submitter)
            self.sub_idx[i] = sub_ids[job.submitter]
            if job.keywords not in kw_ids:
                kw_ids[job.keywords] = len(self._kw_tuples)
                self._kw_tuples.append(job.keywords)
            self.kw_idx[i] = kw_ids[job.keywords]
            if app.uses_locality and job.input_files:
                self.loc_mask[i] = True
                self.input_files[i] = job.input_files

        # skip-bookkeeping arrays for the bulk-reject path: whether a
        # position is its job's first cached slot, and how many slots the
        # job holds (single-slot jobs — the common case — take a pure
        # array-increment fast path in bulk_skip)
        self.skip_first = np.zeros(n, dtype=bool)
        self.job_nslots = np.zeros(n, dtype=np.int64)
        for jid, positions in self._job_slots.items():
            first = slots[positions[0]]
            if first is not None:
                for p in positions:
                    self.skips[p] = first.skipped
            self.skip_first[positions[0]] = True
            for p in positions:
                self.job_nslots[p] = len(positions)

    # ------------------------------------------------------------------

    def _intern_hr(self, cls: Tuple) -> int:
        if cls not in self._hr_ids:
            self._hr_ids[cls] = len(self._hr_ids)
        return self._hr_ids[cls]

    # ------------------------------------------------------------------
    # per-host candidate generation
    # ------------------------------------------------------------------

    def candidates(
        self,
        sched: Scheduler,
        host: Host,
        req: ScheduleRequest,
        rtype: ResourceType,
        start: int,
        now: float,
    ) -> Iterator[Candidate]:
        """Vectorized equivalent of ``Scheduler._candidate_list``.

        Returns a lazy iterator of :class:`Candidate` in stable descending
        score order — identical contents and order to the scalar scan
        starting at ``start``, with ``est_rt``/``scaled_rt`` precomputed.
        """
        rows = self.candidate_rows(sched, host, req, rtype, start, now)
        if rows is None:
            return iter(())
        pos, gidx, scores, est, scaled, choices, _, _ = rows
        return self._emit(pos, gidx, scores, est, scaled, choices)

    def candidate_rows(
        self,
        sched: Scheduler,
        host: Host,
        req: ScheduleRequest,
        rtype: ResourceType,
        start: int,
        now: float,
    ):
        """The scoring pass behind :meth:`candidates`, returning the ranked
        candidate *arrays* ``(pos, group, scores, est, scaled, choices)``
        in descending-score order — the array-driven dispatch tail
        (``Scheduler._dispatch_resource_vec``) walks these directly instead
        of materializing a :class:`Candidate` per visited slot."""
        n = self.n
        if n == 0:
            return None

        # rotated scan order, then first eligible slot per job (the scalar
        # scan's seen_jobs dedupe keeps the first valid slot it encounters)
        rot = np.arange(start, start + n) % n
        elig = self.valid[rot] & ((self.target[rot] < 0) | (self.target[rot] == host.id))
        pos = rot[elig]
        if pos.size == 0:
            return None
        _, first = np.unique(self.job_id[pos], return_index=True)
        reps = pos[np.sort(first)]

        # group-level app-version selection: version choice depends only on
        # (app, pinned version, hav lock) for a given host/request/resource
        pin_r = self.pin[reps]
        hav_r = self.hav[reps]
        if (pin_r == -1).all() and (hav_r == -1).all():
            # common case (no pinning / hav locks): group key is the app
            # index alone — a plain 1-D unique, far cheaper than axis=0
            uniq1, gfirst, inv = np.unique(
                self.app_idx[reps], return_index=True, return_inverse=True
            )
            n_groups = len(uniq1)
        else:
            trip = np.stack([self.app_idx[reps], pin_r, hav_r], axis=1)
            uniq, gfirst, inv = np.unique(
                trip, axis=0, return_index=True, return_inverse=True
            )
            n_groups = uniq.shape[0]
        inv = inv.reshape(-1)
        choices: List[_GroupChoice] = []
        for g in range(n_groups):
            rep_pos = int(reps[gfirst[g]])
            app = self.apps[int(self.app_idx[rep_pos])]
            rep_job = self.store.jobs.get(int(self.job_id[rep_pos]))
            if rep_job is None:
                # rep job purged since the (persistent) snapshot was built:
                # fall back to any live member — the version choice depends
                # only on the group's shared (pin, hav) fields. _emit drops
                # the purged slots themselves.
                for alt in reps[inv == g]:
                    rep_job = self.store.jobs.get(int(self.job_id[int(alt)]))
                    if rep_job is not None:
                        break
                if rep_job is None:
                    choices.append(_GroupChoice(None, {}, 0.0, -1))
                    continue
            version, usage = sched._select_version(app, rep_job, host, req, rtype)
            if version is None:
                choices.append(_GroupChoice(None, {}, 0.0, -1))
                continue
            pf = sched.estimator.proj_flops(host, version)
            size_q = -1
            if app.multi_size and app.n_size_classes > 1:
                # same population computation as the scalar _score, once per
                # group instead of once per slot
                all_pf = [st.mean for st in sched.estimator.version.values() if st.n > 0]
                pop = [1.0 / m for m in all_pf if m > 0]
                size_q = sched.estimator.size_quantile(host, version, app.n_size_classes, pop)
            choices.append(_GroupChoice(version, usage, pf, size_q))
        g_ok = np.array([c.version is not None for c in choices], dtype=bool)
        g_pf = np.array([c.pf for c in choices], dtype=np.float64)
        g_q = np.array([c.size_q for c in choices], dtype=np.int64)

        # HR-class mask (§3.4): host's equivalence class per app, computed once
        host_hr = np.full(len(self.apps), -2, dtype=np.int64)
        for ai in np.unique(self.app_idx[reps]):
            app = self.apps[int(ai)]
            if app.hr_level != HRLevel.NONE:
                host_hr[ai] = self._intern_hr(hr_class(host, app.hr_level))
        hr_rep = self.hr_id[reps]
        host_hr_rep = host_hr[self.app_idx[reps]]

        # keyword score per distinct keyword set (§2.4): "no" keyword vetoes
        kw_val = np.zeros(len(self._kw_tuples), dtype=np.float64)
        kw_ok = np.ones(len(self._kw_tuples), dtype=bool)
        for t in np.unique(self.kw_idx[reps]):
            v = keyword_score(self._kw_tuples[int(t)], req.keyword_prefs)
            if v is None:
                kw_ok[t] = False
            else:
                kw_val[t] = v
        kvec_all = kw_val[self.kw_idx[reps]]
        kok = kw_ok[self.kw_idx[reps]]

        hr_ok = (hr_rep == -1) | (hr_rep == host_hr_rep)
        mask = g_ok[inv] & hr_ok & kok
        if not mask.any():
            return None
        r = reps[mask]
        g_r = inv[mask]

        bal_r = None
        if sched.allocator is not None:
            bal = np.zeros(len(self._submitters), dtype=np.float64)
            for s in np.unique(self.sub_idx[r]):
                bal[s] = sched.allocator.priority(self._submitters[int(s)], now)
            bal_r = bal[self.sub_idx[r]]
        pf_r = g_pf[g_r]
        res = host.resources.get(rtype)
        avail = (res.availability if res else 1.0) * host.on_fraction

        # §6.4 weighted score sum — same IEEE op order as Scheduler._score
        scores = W_KEYWORD * kvec_all[mask]
        if bal_r is not None:
            scores += W_BALANCE * bal_r
        scores += W_PRIORITY * self.prio[r]
        scores += W_SKIPPED * np.minimum(self.skips[r], 5.0)
        # fast-check inputs, vectorized: est runtime and availability-
        # scaled runtime for the whole candidate set in two array ops
        est = np.full(r.shape, np.inf, dtype=np.float64)
        pos_pf = pf_r > 0.0
        est[pos_pf] = self.est_flop[r][pos_pf] / pf_r[pos_pf]
        if avail <= 0:
            scaled = np.full(r.shape, np.inf, dtype=np.float64)
        else:
            scaled = est / avail

        # sparse locality / size-match adjustments stay host-side on both
        # backends (set intersections per row; identical += statements)
        loc_idx = np.nonzero(self.loc_mask[r])[0]
        if loc_idx.size:
            sticky = set(req.sticky_files)
            for i in loc_idx:
                files = self.input_files[int(r[i])]
                resident = len(set(files) & sticky)
                scores[i] += W_LOCALITY * (resident / len(files))
        q_r = g_q[g_r]
        size_hit = (q_r >= 0) & (self.size_class[r] == q_r)
        if size_hit.any():
            scores[size_hit] += W_SIZE_MATCH

        order = np.argsort(-scores, kind="stable")
        pos = r[order]
        return (
            pos, g_r[order], scores[order], est[order], scaled[order],
            choices, self.disk[pos], self.delay[pos],
        )

    def _emit(
        self,
        pos: np.ndarray,
        gidx: np.ndarray,
        scores: np.ndarray,
        est: np.ndarray,
        scaled: np.ndarray,
        choices: List[_GroupChoice],
    ) -> Iterator[Candidate]:
        """Lazy top-k gather: the dispatch tail stops as soon as the request
        is satisfied, so Candidate objects are only built for visited rows."""
        jobs = self.store.jobs
        for k in range(len(pos)):
            p = int(pos[k])
            job = jobs.get(int(self.job_id[p]))
            if job is None:
                continue  # purged after snapshot build: scalar scan skips it
            choice = choices[int(gidx[k])]
            yield Candidate(
                score=float(scores[k]),
                slot=self.slots[p],
                job=job,
                version=choice.version,  # type: ignore[arg-type]
                usage=choice.usage,
                est_rt=float(est[k]),
                scaled_rt=float(scaled[k]),
                index=p,
            )

    # ------------------------------------------------------------------
    # incremental state maintenance
    # ------------------------------------------------------------------

    def apply(self, events: Sequence[Tuple[str, Candidate]]) -> None:
        """Fold dispatch-tail slot mutations back into the arrays so the next
        request in the batch scores against current state (sequential parity).
        """
        for kind, cand in events:
            p = cand.index
            if p < 0:
                continue
            if kind == "skip":
                self.apply_skip(p, cand.job, cand.slot)
            elif kind == "dispatch":
                self.apply_dispatch(p, cand.job)
            elif kind == "taken":
                self.valid[p] = False

    def apply_skip(self, p: int, job: Job, slot) -> None:
        positions = self._job_slots.get(job.id)
        if positions and positions[0] == p:
            skipped = slot.skipped
            for q in positions:
                self.skips[q] = skipped

    def bulk_skip(self, bump: np.ndarray) -> None:
        """Vectorized skip-bump for a rejected-candidate prefix: increments
        every slot's counter and folds the score-relevant ``skips`` columns
        in one array op for single-slot jobs (multi-slot jobs take the
        sibling-update path). Equivalent to ``apply_skip`` per position."""
        slots = self.slots
        for p in bump.tolist():
            slots[p].skipped += 1
        first = bump[self.skip_first[bump]]
        if len(first) == 0:
            return
        single = self.job_nslots[first] == 1
        self.skips[first[single]] += 1.0
        for p in first[~single].tolist():
            positions = self._job_slots.get(int(self.job_id[p]))
            if positions and positions[0] == p:
                skipped = slots[p].skipped
                for q in positions:
                    self.skips[q] = skipped

    def apply_dispatch(self, p: int, job: Job) -> None:
        self.valid[p] = False
        positions = self._job_slots.get(job.id)
        if positions is not None:
            # the feeder cleared this slot: it no longer counts for
            # the first-slot-of-job skip lookup
            try:
                positions.remove(p)
            except ValueError:
                pass
            self.skip_first[p] = False
            if positions:
                first = self.slots[positions[0]]
                for q in positions:
                    self.skips[q] = first.skipped if first else 0.0
                    self.job_nslots[q] = len(positions)
                self.skip_first[positions[0]] = True
        self.apply_job_locks(job)
        # HR-class / homogeneous-version locks are *job*-level state checked
        # at score time, so a dispatch on this shard must also propagate
        # them into every sibling shard's live snapshot — a stale sibling
        # mask could otherwise send the job outside its locked class before
        # the next cache-generation rebuild.
        if self.shard_map is not None:
            for sib in self.feeder._engines.values():
                if sib is not self and sib.version == self.version:
                    sib.apply_job_locks(job)

    def apply_job_locks(self, job: Job) -> None:
        """Fold ``job``'s HR-class / homogeneous-app-version locks into this
        snapshot's mask arrays (for the job's slots this snapshot holds)."""
        positions = self._job_slots.get(job.id)
        if not positions:
            return
        app = self.store.apps.get(job.app_name)
        if app is None:
            return
        if app.hr_level != HRLevel.NONE and job.hr_class is not None:
            hid = self._intern_hr(job.hr_class)
            for q in positions:
                self.hr_id[q] = hid
        if job.hav_version_id is not None:
            for q in positions:
                self.hav[q] = job.hav_version_id
