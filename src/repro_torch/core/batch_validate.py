"""Vectorized validation→credit→reputation engine (§3.4, §4, §7).

The transitioner's validate pass is the last scalar per-job server hot
path: ``check_set`` runs O(n²) pairwise comparator calls per job, and the
credit/reputation updates walk Python dicts one instance at a time. This
module processes **every dirty job of a tick at once**:

  * one struct-of-arrays gather over the flagged jobs' instance rows
    (state / outcome / validate-state codes), with per-job aggregates —
    outstanding, error, success, fresh-success counts — as fused
    ``bincount`` passes;
  * payload **digests** computed once per success instance (raw IEEE bits
    for plain-float payloads; fused mantissa-truncation buckets + row hash
    for homogeneous tensor payloads; 8-byte blake2b otherwise — see
    ``validator.py`` for the digest contracts), batched per app across all
    jobs of the tick;
  * equivalence grouping as a single ``lexsort`` over ``(job, digest)``
    keys instead of pairwise comparator loops; quorum / canonical
    decisions for all candidate jobs in one boolean-mask pass, with the
    winning group chosen by (size desc, creation order asc) — exactly the
    pinned ``check_set`` grouping contract;
  * mutations and bookkeeping deferred into fused end-of-tick passes:
    bulk validate-state writes and ACTIVE→SUCCESS completions
    (``JobStore.set_validate_states`` / ``finish_jobs``), claimed credit
    via ``CreditSystem.ingest_batch`` (bit-equal to the scalar
    record/claim sequence), per-key grant replay
    (``CreditSystem.grant_many``), and reputation via
    ``AdaptiveReplication.apply_events`` (one fused reset/increment pass).

Candidate jobs come from the store's **validation-pending index** (jobs
holding a fresh OVER/SUCCESS/INIT instance) intersected with the flagged
set, so quiescent flagged jobs never pay for the digest pass.

Apps whose comparator has no digest hook (custom comparators, fuzzy with a
bad-fraction allowance) or whose payloads defeat digesting fall back to the
scalar ``check_set`` per job — results stay correct, only the speedup is
lost. ``Transitioner(batch_validate=True)`` routes through this engine;
the scalar path is kept verbatim as the parity oracle
(``tests/test_batch_validate.py``).
"""
from __future__ import annotations

from collections import Counter
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .backend import resolve_engine
from .store import JobStore
from .torch_backend import fuzzy_digest_torch
from .types import (
    App,
    InstanceOutcome,
    InstanceState,
    Job,
    JobInstance,
    ValidateState,
)
from .validator import DigestError, digest_batch_for

# dense codes for the SoA gather; error outcomes are contiguous (2..5) so
# the §4 failure-limit count is one range test
_STATE_CODE = {
    InstanceState.UNSENT: 0,
    InstanceState.IN_PROGRESS: 1,
    InstanceState.OVER: 2,
}
_OUTCOME_CODE = {
    InstanceOutcome.INIT: 0,
    InstanceOutcome.SUCCESS: 1,
    InstanceOutcome.CLIENT_ERROR: 2,
    InstanceOutcome.NO_REPLY: 3,
    InstanceOutcome.ABANDONED: 4,
    InstanceOutcome.VALIDATE_ERROR: 5,
    InstanceOutcome.CANCELLED: 6,
}
_VSTATE_CODE = {
    ValidateState.INIT: 0,
    ValidateState.VALID: 1,
    ValidateState.INVALID: 2,
    ValidateState.INCONCLUSIVE: 3,
}

# cache each code on its enum member: a plain attribute read beats a dict
# probe through the (python-level) Enum.__hash__ in the row gather
for _enum_map in (_STATE_CODE, _OUTCOME_CODE, _VSTATE_CODE):
    for _member, _c in _enum_map.items():
        _member._bv_code = _c  # type: ignore[attr-defined]

#: decision kinds
DECIDED = "decided"
INCONCLUSIVE = "inconclusive"
SCALAR = "scalar"  # comparator/payload not digestable: scalar check_set


class ValidationPlan:
    """Per-tick result of :meth:`BatchValidationEngine.prepare`.

    Exposes the per-job aggregates and precomputed quorum decisions the
    transitioner consumes instead of rescanning/recomparing instances, and
    accumulates the tick's deferred effects — validate-state writes, job
    completions, credit entries, reputation events — for the fused
    ``Transitioner._finalize_plan`` flush. Effects are appended in job
    processing order, so the flush replays exactly the event sequence the
    scalar loop would have produced.
    """

    def __init__(self, engine: "BatchValidationEngine", jobs: List[Job]) -> None:
        self.engine = engine
        self.jobs = jobs
        nj = len(jobs)
        self.refs: List[JobInstance] = []
        # per-job aggregate counts (plain lists: cheaper per-element reads
        # in the transition loop than numpy scalars)
        self.n_outstanding: List[int] = []
        self.n_error: List[int] = []
        self.n_succ: List[int] = []
        self.n_total: List[int] = []
        self.fresh: List[int] = []
        self.row_off: List[int] = [0]
        self._st: List[int] = []
        self.succ_rows: List[int] = []
        self.succ_off: List[int] = [0]
        self._succ_cache: List[Optional[List[JobInstance]]] = [None] * nj
        # pos -> (start, end) into _digall, aligned with successes(pos)
        self._dig_off: List[Optional[Tuple[int, int]]] = [None] * nj
        self._digall: Optional[np.ndarray] = None
        self.decisions: List[Optional[Tuple]] = [None] * nj
        # deferred bulk mutations & bookkeeping, in job processing order,
        # flushed by Transitioner._finalize_plan
        self.valid_bulk: List[JobInstance] = []
        self.invalid_bulk: List[JobInstance] = []
        self.inconclusive_bulk: List[JobInstance] = []
        self.finish: List[Tuple[Job, int]] = []
        self.adp_h: List[int] = []
        self.adp_v: List[int] = []
        self.adp_ok: List[bool] = []
        self.err_outcome: List[JobInstance] = []
        self.credit_entries: List[Tuple[Job, List[JobInstance], List[int]]] = []
        self.peers_cache: Dict[str, List[int]] = {}
        # defense layer (§3.4): one ((host, ver) valid pairs, invalid pairs)
        # entry per finalized decision, replayed sequentially in finalize —
        # the quota fold is order-sensitive, so replay order == scalar order
        self.defense_events: List[Tuple[List[Tuple[int, int]], List[Tuple[int, int]]]] = []

    # -- per-job views ---------------------------------------------------

    def successes(self, pos: int) -> List[JobInstance]:
        out = self._succ_cache[pos]
        if out is None:
            refs = self.refs
            out = self._succ_cache[pos] = [
                refs[r]
                for r in self.succ_rows[self.succ_off[pos]:self.succ_off[pos + 1]]
            ]
        return out

    def unsent(self, pos: int) -> List[JobInstance]:
        refs = self.refs
        st = self._st
        return [
            refs[r]
            for r in range(self.row_off[pos], self.row_off[pos + 1])
            if st[r] == 0
        ]

    def digests(self, pos: int) -> Optional[np.ndarray]:
        span = self._dig_off[pos]
        if span is None or self._digall is None:
            return None
        return self._digall[span[0]:span[1]]

    def largest_agreeing_group(self, pos: int, app: App, successes: List[JobInstance]) -> int:
        """Digest-space mirror of ``Transitioner._largest_agreeing_group``:
        max multiplicity among non-INVALID successes. Reads live
        validate_state (INIT vs INCONCLUSIVE is irrelevant here — only
        INVALID is excluded — so deferred INCONCLUSIVE writes are safe)."""
        viable = [k for k, s in enumerate(successes) if s.validate_state != ValidateState.INVALID]
        if len(viable) <= 1:
            return len(viable)
        digs = self.digests(pos)
        if digs is None:
            fn = self.engine.digest_fn(app)
            if fn is None:
                return _scalar_largest_group(app, successes)
            try:
                digs = fn([s.output for s in successes])
            except DigestError:
                return _scalar_largest_group(app, successes)
        counts = Counter(int(digs[k]) for k in viable)
        return max(counts.values())


def _scalar_largest_group(app: App, successes: List[JobInstance]) -> int:
    from .fsm import Transitioner

    return Transitioner._largest_agreeing_group(app, successes)


class BatchValidationEngine:
    """Builds a :class:`ValidationPlan` per transitioner tick."""

    def __init__(self, store: JobStore, backend: str = "numpy", device="cuda") -> None:
        self.store = store
        # "torch": homogeneous float tensor payload batches of fuzzy
        # comparators route through the kernels/quorum_compare kernel on
        # ``device`` (its plain version on the CPU); scalars/mixed payloads
        # and every other comparator keep the pure-NumPy digest path
        self.backend, self.device = resolve_engine(backend, device)
        self._digest_fns: Dict[str, Any] = {}

    def digest_fn(self, app: App):
        """Digest hook for ``app``'s comparator (cached), or None."""
        fn = self._digest_fns.get(app.name, _UNSET)
        if fn is _UNSET:
            fn = digest_batch_for(app.comparator)
            if fn is not None and self.backend == "torch":
                params = getattr(app.comparator, "fuzzy_params", None)
                if params is not None:
                    fn = fuzzy_digest_torch(fn, *params, self.device)
            self._digest_fns[app.name] = fn
        return fn

    # ------------------------------------------------------------------

    def prepare(
        self,
        jobs: List[Job],
        now: float,
        instance: int = 0,
        n_instances: int = 1,
        clusters: Optional[Dict[int, int]] = None,
    ) -> ValidationPlan:
        """The fused pre-pass over one tick's flagged jobs: gather, count,
        digest, group, decide. Pure — no store mutation happens here; the
        transitioner applies decisions job-by-job in its usual order so
        failure-limit checks and metrics keep exact scalar semantics.

        ``clusters`` is the defense layer's tick-start suspicion-cluster
        snapshot: a candidate whose successes include two hosts of one
        cluster is routed to the scalar ``check_set`` fallback, which
        applies the effective-quorum-size rule (same-cluster replicas are
        one vote). Everything else takes the fused digest path, whose
        group counts equal effective counts when no two members share a
        cluster.
        """
        store = self.store
        plan = ValidationPlan(self, jobs)
        nj = len(jobs)
        by_job = store._by_job
        instances = store.instances

        refs = plan.refs
        jp: List[int] = []
        sc: List[int] = []
        oc: List[int] = []
        vc: List[int] = []
        refs_append = refs.append
        jp_append = jp.append
        sc_append = sc.append
        oc_append = oc.append
        vc_append = vc.append
        for p, job in enumerate(jobs):
            for iid in by_job.get(job.id, ()):
                inst = instances[iid]
                refs_append(inst)
                jp_append(p)
                sc_append(inst.state._bv_code)
                oc_append(inst.outcome._bv_code)
                vc_append(inst.validate_state._bv_code)
        plan._st = sc

        n = len(refs)
        jparr = np.array(jp, dtype=np.int64) if n else np.zeros(0, dtype=np.int64)
        st = np.array(sc, dtype=np.int8) if n else np.zeros(0, dtype=np.int8)
        ot = np.array(oc, dtype=np.int8) if n else np.zeros(0, dtype=np.int8)
        vt = np.array(vc, dtype=np.int8) if n else np.zeros(0, dtype=np.int8)

        over = st == 2
        succ_mask = over & (ot == 1)
        err_mask = over & (ot >= 2) & (ot <= 5)
        fresh_mask = succ_mask & (vt == 0)

        n_succ = np.bincount(jparr[succ_mask], minlength=nj)
        n_fresh = np.bincount(jparr[fresh_mask], minlength=nj)
        plan.n_outstanding = np.bincount(jparr[st <= 1], minlength=nj).tolist()
        plan.n_error = np.bincount(jparr[err_mask], minlength=nj).tolist()
        plan.n_succ = n_succ.tolist()
        plan.fresh = n_fresh.tolist()
        plan.n_total = np.bincount(jparr, minlength=nj).tolist()
        plan.row_off = np.searchsorted(jparr, np.arange(nj + 1)).tolist()

        succ_rows = np.flatnonzero(succ_mask)
        succ_jobs = jparr[succ_rows]
        plan.succ_rows = succ_rows.tolist()
        plan.succ_off = np.searchsorted(succ_jobs, np.arange(nj + 1)).tolist()

        # -- candidate selection: drain the validation-pending index -------
        vp = store.pending_validation(instance, n_instances)
        has_canon = np.fromiter(
            (j.canonical_instance_id is not None for j in jobs), bool, nj
        )
        in_vp = np.fromiter((j.id in vp for j in jobs), bool, nj)
        quorum = np.fromiter((j.min_quorum for j in jobs), np.int64, nj)
        has_fresh = in_vp & (n_fresh > 0)
        candidates = ~has_canon & has_fresh & (n_succ >= quorum)
        stragglers = has_canon & has_fresh

        # -- defense work-spreading veto (§3.4): scalar-route candidates
        #    with a same-cluster success pair so effective-quorum counting
        #    applies (straggler validation has no quorum logic — fused) ----
        if clusters:
            for p in np.flatnonzero(candidates & (n_succ >= 2)).tolist():
                seen: set = set()
                for s in plan.successes(p):
                    cl = (
                        clusters.get(s.host_id)
                        if s.host_id is not None
                        else None
                    )
                    if cl is not None:
                        if cl in seen:
                            plan.decisions[p] = _SCALAR_DECISION
                            candidates[p] = False
                            break
                        seen.add(cl)

        # -- digest pass ---------------------------------------------------
        need_digest = (candidates & (n_succ >= 2)) | stragglers
        dig_pos = np.flatnonzero(need_digest)
        djob = np.zeros(0, dtype=np.int64)
        digall: Optional[np.ndarray] = None
        decisions = plan.decisions
        if dig_pos.size:
            sel = np.isin(succ_jobs, dig_pos)
            drows = succ_rows[sel].tolist()
            djob = succ_jobs[sel]
            doff = np.searchsorted(djob, np.arange(nj + 1)).tolist()
            digall = np.zeros(len(drows), dtype=np.int64)
            # batch the digest hook per app across every job of the tick
            scalar_pos: set = set()
            app_codes: Dict[str, int] = {}
            pos_code = np.fromiter(
                (
                    app_codes.setdefault(jobs[int(p)].app_name, len(app_codes))
                    for p in dig_pos
                ),
                np.int64,
                len(dig_pos),
            )
            if len(app_codes) > 1:
                counts = np.diff(np.asarray(doff))[dig_pos]
                row_app = np.repeat(pos_code, counts)
            for app_name, code in app_codes.items():
                idxs = (
                    range(len(djob))
                    if len(app_codes) == 1
                    else np.flatnonzero(row_app == code).tolist()
                )
                fn = self.digest_fn(store.apps[app_name])
                if fn is not None:
                    try:
                        digall[list(idxs)] = fn([refs[drows[k]].output for k in idxs])
                        continue
                    except DigestError:
                        pass
                for k in idxs:
                    scalar_pos.add(int(djob[k]))
            dig_off = plan._dig_off
            for p in dig_pos.tolist():
                if p in scalar_pos:
                    decisions[p] = _SCALAR_DECISION
                else:
                    dig_off[p] = (doff[p], doff[p + 1])
            plan._digall = digall

        # -- quorum/canonical decisions: one mask pass ---------------------
        # winner per job = largest (job, digest) group, ties to the group
        # whose first member appears earliest (the pinned check_set
        # grouping-order contract). Winner membership for *every* job is
        # extracted with one global boolean mask — no per-job numpy calls.
        wcount_l: List[int] = []
        members_all: List[int] = []
        moff: List[int] = []
        if digall is not None and djob.size:
            if scalar_pos:
                scal_mask = np.zeros(nj, dtype=bool)
                scal_mask[list(scalar_pos)] = True
                keep = ~scal_mask[djob]
            else:
                keep = np.ones(len(djob), dtype=bool)
            cj = djob[keep]
            cd = digall[keep]
            crow = np.flatnonzero(keep)  # kept index -> djob-space index
            if cj.size:
                order = np.lexsort((cd, cj))  # stable: ties keep success order
                js = cj[order]
                ds = cd[order]
                new = np.r_[True, (js[1:] != js[:-1]) | (ds[1:] != ds[:-1])]
                gs = np.flatnonzero(new)
                gc = np.diff(np.r_[gs, len(js)])
                gj = js[gs]
                gid = np.cumsum(new) - 1  # group id per sorted row
                gfirst = crow[order[gs]]  # earliest success row of each group
                worder = np.lexsort((gfirst, -gc, gj))
                uj, first = np.unique(gj[worder], return_index=True)
                winner_g = worder[first]  # winning group per job (aligned uj)
                wcount = np.zeros(nj, dtype=np.int64)
                wcount[uj] = gc[winner_g]
                wcount_l = wcount.tolist()
                win_of_job = np.full(nj, -1, dtype=np.int64)
                win_of_job[uj] = winner_g
                winner_mask = win_of_job[js] == gid
                # djob-space indices of winner members, ascending within
                # each job (stable lexsort keeps success order inside runs)
                members_all = crow[order[winner_mask]].tolist()
                moff = np.searchsorted(
                    js[winner_mask], np.arange(nj + 1)
                ).tolist()

        n_succ_l = plan.n_succ
        dig_off = plan._dig_off
        for p in np.flatnonzero(candidates).tolist():
            if decisions[p] is not None:  # scalar fallback
                continue
            q = quorum[p]
            succ = plan.successes(p)
            if n_succ_l[p] == 1:
                # a lone success trivially forms the (only) group
                decisions[p] = (
                    (DECIDED, succ[0], succ, _EMPTY) if 1 >= q
                    else _INCONCLUSIVE_DECISION
                )
                continue
            g_count = wcount_l[p] if wcount_l else 0
            if g_count == 0:
                continue
            if g_count < q:
                decisions[p] = _INCONCLUSIVE_DECISION
                continue
            span = dig_off[p]
            if g_count == span[1] - span[0]:
                decisions[p] = (DECIDED, succ[0], succ, _EMPTY)
            else:
                o1 = span[0]
                vset = set(members_all[moff[p]:moff[p + 1]])
                valid: List[JobInstance] = []
                invalid: List[JobInstance] = []
                for k in range(len(succ)):
                    (valid if k + o1 in vset else invalid).append(succ[k])
                decisions[p] = (DECIDED, valid[0], valid, invalid)

        return plan


_UNSET = object()
_EMPTY: List[JobInstance] = []
_SCALAR_DECISION = (SCALAR, None, None, None)
_INCONCLUSIVE_DECISION = (INCONCLUSIVE, None, None, None)
