"""The credit system (§7).

One unit of credit = one day of a 1-GFLOPS (Whetstone) CPU. For a completed
instance J:

  PFC(J) = sum_r runtime(J) * usage(r) * peak_flops(r)

Claimed credit is PFC times two normalization factors:

  * version normalization: avg-PFC of the most efficient version divided by
    this version's avg-PFC (credit is independent of version efficiency);
  * host normalization: the app version's avg-PFC divided by this
    (host, version)'s avg-PFC (credit is independent of host efficiency).

Granted credit is an outlier-robust weighted average over the instances of a
replicated job, granted equally to all instances. Cross-project credit sums a
volunteer's credit over projects via stable cross-project IDs (CPIDs).
"""
from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

from .estimation import OnlineStats
from .types import AppVersion, Host, Job, JobInstance, ResourceType

SECONDS_PER_DAY = 86400.0
GFLOP = 1e9
#: FLOPs per credit unit: one day at 1 GFLOPS.
COBBLESTONE_SCALE = SECONDS_PER_DAY * GFLOP


def peak_flop_count(
    runtime: float, usage: Dict[ResourceType, float], host: Host
) -> float:
    """PFC(J) (§7)."""
    pfc = 0.0
    for rtype, amount in usage.items():
        res = host.resources.get(rtype)
        if res is not None:
            pfc += runtime * amount * res.peak_flops
    return pfc


@dataclass
class CreditSystem:
    """Adaptive credit with version & host normalization (§7)."""

    min_samples: int = 3
    # statistics of PFC(J)/est_flop_count(J)
    version_stats: Dict[int, OnlineStats] = field(default_factory=dict)
    # deliberately retained across host removal: straggler instances that
    # report after their host departed still need the (host, version)
    # normalization history for fair credit (§7; see the rationale on
    # ProjectServer.remove_host).
    host_version_stats: Dict[Tuple[int, int], OnlineStats] = field(default_factory=dict)  # reprolint: ignore[purge-complete]
    # totals (per host / volunteer / team), plus exponentially-weighted recent
    total: Dict[str, float] = field(default_factory=dict)
    recent: Dict[str, float] = field(default_factory=dict)
    recent_tau: float = 7 * 86400.0  # half-life-ish decay constant
    _recent_t: Dict[str, float] = field(default_factory=dict)

    # ---- statistics ----

    def record(self, instance: JobInstance, job: Job) -> None:
        if job.est_flop_count <= 0 or instance.peak_flop_count <= 0:
            return
        x = instance.peak_flop_count / job.est_flop_count
        assert instance.app_version_id is not None and instance.host_id is not None
        self.version_stats.setdefault(instance.app_version_id, OnlineStats()).add(x)
        self.host_version_stats.setdefault(
            (instance.host_id, instance.app_version_id), OnlineStats()
        ).add(x)

    def _version_norm(self, app_version_id: int, peer_version_ids: Iterable[int]) -> float:
        """Most-efficient-version avg-PFC / this version's avg-PFC."""
        mine = self.version_stats.get(app_version_id)
        if mine is None or mine.n < self.min_samples or mine.mean <= 0:
            return 1.0
        best = mine.mean
        for vid in peer_version_ids:
            st = self.version_stats.get(vid)
            if st is not None and st.n >= self.min_samples and 0 < st.mean < best:
                best = st.mean
        return best / mine.mean

    def _host_norm(self, host_id: int, app_version_id: int) -> float:
        hv = self.host_version_stats.get((host_id, app_version_id))
        v = self.version_stats.get(app_version_id)
        if (
            hv is None or v is None
            or hv.n < self.min_samples or v.n < self.min_samples
            or hv.mean <= 0 or v.mean <= 0
        ):
            return 1.0
        return v.mean / hv.mean

    # ---- claiming & granting ----

    def claimed_credit(
        self,
        instance: JobInstance,
        peer_version_ids: Iterable[int] = (),
    ) -> float:
        assert instance.app_version_id is not None and instance.host_id is not None
        pfc = instance.peak_flop_count
        pfc *= self._version_norm(instance.app_version_id, peer_version_ids)
        pfc *= self._host_norm(instance.host_id, instance.app_version_id)
        return pfc / COBBLESTONE_SCALE

    @staticmethod
    def grant_amount(claimed: List[float]) -> float:
        """Outlier-robust combination of claimed credits (§7): drop the
        high/low extremes when >2 claims, then average.

        A claim of exactly zero is legitimate (a valid instance whose PFC
        happened to be zero — e.g. a non-CPU-intensive app) and belongs in
        the trim set; only *negative* values are unset/error sentinels and
        are excluded. (The old ``c > 0`` filter silently dropped zero
        claims from the trim, skewing the average upward, and fell through
        to the empty-claims 0.0 fallback when every claim was zero.)
        """
        vals = sorted(c for c in claimed if c >= 0.0)
        if not vals:
            return 0.0
        if len(vals) > 2:
            vals = vals[1:-1]
        return sum(vals) / len(vals)

    def ingest_batch(
        self,
        entries: List[Tuple[Job, List[JobInstance], List[int]]],
    ) -> List[float]:
        """Batched stats ingestion for the batch validation engine (§7).

        For every ``(job, valid_instances, peer_version_ids)`` entry — in
        order — records the PFC sample and computes claimed credit for each
        instance (setting ``instance.claimed_credit``), then returns the
        per-job grant amounts. The float operations and their order are
        *identical* to the scalar ``record()`` / ``claimed_credit()`` /
        ``grant_amount()`` sequence, so engine and oracle grant bit-equal
        credit; the batching win is hoisted lookups and no per-call
        ``setdefault`` allocations across the tick's whole validated set.
        """
        vstats = self.version_stats
        hvstats = self.host_version_stats
        ms = self.min_samples
        grants: List[float] = []
        # scanning a version's own entry can never lower ``best`` below its
        # own mean, so the peer scan only needs the *other* versions
        others_cache: Dict[Tuple[int, Optional[int]], List[int]] = {}
        for job, valid, peers in entries:
            est = job.est_flop_count
            claims: List[float] = []
            for inst in valid:
                pfc = inst.peak_flop_count
                vid = inst.app_version_id
                hid = inst.host_id
                vstat = vstats.get(vid)
                hkey = (hid, vid)
                hstat = hvstats.get(hkey)
                if est > 0 and pfc > 0:
                    x = pfc / est
                    if vstat is None:
                        vstat = vstats[vid] = OnlineStats()
                    vstat.n = n = vstat.n + 1
                    delta = x - vstat.mean
                    vstat.mean += delta / n
                    vstat._m2 += delta * (x - vstat.mean)
                    if hstat is None:
                        hstat = hvstats[hkey] = OnlineStats()
                    hstat.n = n = hstat.n + 1
                    delta = x - hstat.mean
                    hstat.mean += delta / n
                    hstat._m2 += delta * (x - hstat.mean)
                # inlined claimed_credit (same op order: pfc*vn, *hn, /scale)
                c = pfc
                if vstat is not None and vstat.n >= ms and vstat.mean > 0:
                    okey = (id(peers), vid)
                    others = others_cache.get(okey)
                    if others is None:
                        others = others_cache[okey] = [p for p in peers if p != vid]
                    best = vstat.mean
                    for pid in others:
                        stp = vstats.get(pid)
                        if stp is not None and stp.n >= ms and 0 < stp.mean < best:
                            best = stp.mean
                    c *= best / vstat.mean
                if not (
                    hstat is None or vstat is None
                    or hstat.n < ms or vstat.n < ms
                    or hstat.mean <= 0 or vstat.mean <= 0
                ):
                    c *= vstat.mean / hstat.mean
                c = c / COBBLESTONE_SCALE
                inst.__dict__["claimed_credit"] = c  # untracked field
                claims.append(c)
            grants.append(self.grant_amount(claims))
        return grants

    def grant_many(self, by_key: Dict[str, List[float]], now: float) -> None:
        """Replay one tick's grants grouped per key, in per-key event order.

        Float-identical to calling :meth:`grant` once per amount at the
        same ``now``: only a key's own sequence touches its accumulators,
        so grouping by key cannot change any result — the first grant
        applies the decay, the rest add (``now == last`` after the first).
        """
        total = self.total
        recent = self.recent
        recent_t = self._recent_t
        for key, amounts in by_key.items():
            t = total.get(key, 0.0)
            last = recent_t.get(key)
            prev = recent.get(key, 0.0)
            if last is not None and now > last:
                prev *= math.exp(-(now - last) / self.recent_tau)
            for a in amounts:
                t += a
                prev += a
            total[key] = t
            recent[key] = prev
            recent_t[key] = now

    def grant(self, key: str, amount: float, now: float = 0.0) -> None:
        """Credit a host/volunteer/team accounting key."""
        self.total[key] = self.total.get(key, 0.0) + amount
        # exponentially-weighted recent average credit (per §7)
        last = self._recent_t.get(key)
        prev = self.recent.get(key, 0.0)
        if last is not None and now > last:
            decay = math.exp(-(now - last) / self.recent_tau)
            prev *= decay
        self.recent[key] = prev + amount
        self._recent_t[key] = now


# ---------------------------------------------------------------------------
# Cross-project credit (§7)
# ---------------------------------------------------------------------------


def volunteer_cpid(email: str) -> str:
    """Cross-project volunteer ID: based on email but can't be inverted."""
    return hashlib.sha256(("boinc-cpid:" + email.strip().lower()).encode()).hexdigest()[:32]


def host_cpid_consensus(candidate_cpids: Iterable[str]) -> str:
    """Consensus host CPID across projects: deterministic least element."""
    cands = sorted(set(candidate_cpids))
    if not cands:
        raise ValueError("no candidate CPIDs")
    return cands[0]


def collate_cross_project(
    exports: Dict[str, Dict[str, float]]
) -> Dict[str, float]:
    """Combine per-project exported credit keyed by CPID (3rd-party stats
    sites, §7): exports[project][cpid] -> credit."""
    out: Dict[str, float] = {}
    for per_project in exports.values():
        for cpid, credit in per_project.items():
            out[cpid] = out.get(cpid, 0.0) + credit
    return out
