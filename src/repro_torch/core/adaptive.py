"""Adaptive replication (§3.4).

"The BOINC server maintains, for each (host, app version) pair, a count N of
the number of consecutive jobs that were validated by replication. Once N
exceeds a threshold, jobs sent to that host with that app version are
replicated only some of the time; the probability of replication goes to
zero as N increases. Adaptive replication can achieve a low bound on the
error rate ... while imposing only a small throughput overhead."

Reputation is kept at (host, app version) granularity because "some
computers are reliable for CPU jobs but unreliable for GPU jobs".

**Array backing.** The reputation table is a dense int64 array over
interned (host, app version) indices rather than a per-pair dict, so the
batch validation engine can reset/increment a whole tick's worth of
validation outcomes in fused passes (:meth:`apply_events`) and the
scheduler can draw a tick's replication decisions as one RNG batch
(:meth:`prefetch_draws` / :meth:`should_replicate_batch`). The scalar
methods (``on_validated`` / ``on_invalid`` / ``should_replicate``) operate
on the same table, one cell at a time, and consume the same RNG stream —
batched and sequential use are therefore interchangeable mid-run.
"""
from __future__ import annotations

import random
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Sequence, Tuple

import numpy as np


@dataclass
class AdaptiveReplication:
    """Per-(host, app-version) reputation and replication decisions."""

    threshold: int = 10  # N must exceed this before replication is relaxed
    min_probability: float = 0.01  # floor: spot checks never fully stop
    seed: int = 0
    _rng: random.Random = field(default=None, repr=False)  # type: ignore[assignment]
    _host_idx: Dict[int, int] = field(default_factory=dict, repr=False)
    _ver_idx: Dict[int, int] = field(default_factory=dict, repr=False)
    _table: np.ndarray = field(default=None, repr=False)  # type: ignore[assignment]
    # RNG draws prefetched by prefetch_draws; consumed FIFO, so batched and
    # per-call users see the identical stream the bare RNG would produce
    _draws: Deque[float] = field(default_factory=deque, repr=False)

    def __post_init__(self) -> None:
        self._rng = random.Random(self.seed)
        if self._table is None:
            self._table = np.zeros((0, 0), dtype=np.int64)

    # ---- interning / table growth ----

    def _index(self, host_id: int, app_version_id: int) -> Tuple[int, int]:
        hi = self._host_idx.get(host_id)
        if hi is None:
            hi = self._host_idx[host_id] = len(self._host_idx)
        vi = self._ver_idx.get(app_version_id)
        if vi is None:
            vi = self._ver_idx[app_version_id] = len(self._ver_idx)
        rows, cols = self._table.shape
        if hi >= rows or vi >= cols:
            grown = np.zeros(
                (max(rows * 2, hi + 1, 16), max(cols * 2, vi + 1, 16)),
                dtype=np.int64,
            )
            grown[:rows, :cols] = self._table
            self._table = grown
        return hi, vi

    @property
    def consecutive_valid(self) -> Dict[Tuple[int, int], int]:
        """Read-only dict *snapshot* of the dense table (nonzero
        reputations), for tests/demos/stats exports — mutations go through
        ``on_validated``/``on_invalid``/``apply_events``. O(nonzero
        cells)."""
        hosts = {hi: h for h, hi in self._host_idx.items()}
        vers = {vi: v for v, vi in self._ver_idx.items()}
        return {
            (hosts[int(hi)], vers[int(vi)]): int(self._table[hi, vi])
            for hi, vi in zip(*np.nonzero(self._table))
        }

    def key(self, host_id: int, app_version_id: int) -> Tuple[int, int]:
        return (host_id, app_version_id)

    # ---- scalar path (one cell at a time) ----

    def reputation(self, host_id: int, app_version_id: int) -> int:
        hi = self._host_idx.get(host_id)
        vi = self._ver_idx.get(app_version_id)
        if hi is None or vi is None:
            return 0
        return int(self._table[hi, vi])

    def replication_probability(self, host_id: int, app_version_id: int) -> float:
        """P(replicate a job sent to this host with this version)."""
        n = self.reputation(host_id, app_version_id)
        if n <= self.threshold:
            return 1.0
        # goes to zero as N increases, floored at min_probability
        return max(self.min_probability, self.threshold / float(n))

    def should_replicate(self, host_id: int, app_version_id: int) -> bool:
        p = self.replication_probability(host_id, app_version_id)
        return self._next_draw() < p

    def on_validated(self, host_id: int, app_version_id: int) -> None:
        hi, vi = self._index(host_id, app_version_id)
        self._table[hi, vi] += 1

    def on_invalid(self, host_id: int, app_version_id: int) -> None:
        """Any invalid/errored result resets reputation to zero."""
        hi, vi = self._index(host_id, app_version_id)
        self._table[hi, vi] = 0

    def forget_host(self, host_id: int) -> None:
        """Churn cleanup (§4): zero a departed host's reputation row. The
        dense row index stays interned (late-arriving results may still
        re-earn entries harmlessly), but the accumulated counts are
        cleared — a returning host id starts from zero reputation."""
        hi = self._host_idx.get(host_id)
        if hi is not None and hi < self._table.shape[0]:
            self._table[hi, :] = 0

    def expected_overhead(self, host_id: int, app_version_id: int) -> float:
        """Expected replication factor for this pair: 1 + p (one extra
        instance with probability p). The paper's claim is this -> ~1."""
        return 1.0 + self.replication_probability(host_id, app_version_id)

    # ---- RNG draw batching ----

    def _next_draw(self) -> float:
        return self._draws.popleft() if self._draws else self._rng.random()

    def prefetch_draws(self, n: int) -> None:
        """Pull ``n`` uniforms from the RNG now; subsequent decisions pop
        them FIFO. Because the cache preserves stream order, any prefetch
        size leaves every decision's draw identical to unbatched use."""
        if n > 0:
            self._draws.extend(self._rng.random() for _ in range(n))

    # ---- batched path (the validation engine / batch scheduler) ----

    def _gather_indices(
        self, host_ids: Sequence[int], ver_ids: Sequence[int]
    ) -> Tuple[np.ndarray, np.ndarray]:
        hidx = self._host_idx
        vidx = self._ver_idx
        hi = np.fromiter((hidx.get(h, -1) for h in host_ids), np.int64, len(host_ids))
        vi = np.fromiter((vidx.get(v, -1) for v in ver_ids), np.int64, len(ver_ids))
        return hi, vi

    def reputations(
        self, host_ids: Sequence[int], ver_ids: Sequence[int]
    ) -> np.ndarray:
        """Vectorized reputation gather (unknown pairs read 0)."""
        hi, vi = self._gather_indices(host_ids, ver_ids)
        known = (hi >= 0) & (vi >= 0)
        out = np.zeros(len(host_ids), dtype=np.int64)
        if known.any():
            out[known] = self._table[hi[known], vi[known]]
        return out

    def replication_probabilities(
        self, host_ids: Sequence[int], ver_ids: Sequence[int]
    ) -> np.ndarray:
        n = self.reputations(host_ids, ver_ids)
        p = np.ones(len(n), dtype=np.float64)
        relaxed = n > self.threshold
        if relaxed.any():
            p[relaxed] = np.maximum(
                self.min_probability, self.threshold / n[relaxed].astype(np.float64)
            )
        return p

    def should_replicate_batch(
        self, host_ids: Sequence[int], ver_ids: Sequence[int]
    ) -> np.ndarray:
        """One decision per pair, consuming one draw per pair in order —
        element i equals ``should_replicate(host_ids[i], ver_ids[i])``."""
        p = self.replication_probabilities(host_ids, ver_ids)
        draws = np.fromiter(
            (self._next_draw() for _ in range(len(p))), np.float64, len(p)
        )
        return draws < p

    def apply_events(
        self,
        host_ids: Sequence[int],
        ver_ids: Sequence[int],
        valid: Sequence[bool],
    ) -> None:
        """Apply an *ordered* sequence of validation outcomes in one fused
        pass: element i is ``on_validated(host_ids[i], ver_ids[i])`` when
        ``valid[i]`` else ``on_invalid(...)``, and the final table state is
        identical to applying them one by one. Per pair, the closed form
        is: the count of valid events after the pair's last invalid event,
        added to the prior reputation only if the pair saw no invalid.
        """
        m = len(host_ids)
        if m == 0:
            return
        hidx = self._host_idx
        vidx = self._ver_idx
        pairs: List[Tuple[int, int]] = []
        for h, v in zip(host_ids, ver_ids):
            hi = hidx.get(h)
            vi = vidx.get(v)
            if hi is None or vi is None:
                hi, vi = self._index(h, v)
            pairs.append((hi, vi))
        ncols = self._table.shape[1]
        flat = np.fromiter((hi * ncols + vi for hi, vi in pairs), np.int64, m)
        ok = np.asarray(valid, dtype=bool)
        seq = np.arange(m, dtype=np.int64)
        order = np.argsort(flat, kind="stable")
        fs = flat[order]
        starts = np.flatnonzero(np.r_[True, fs[1:] != fs[:-1]])
        counts = np.diff(np.r_[starts, m])
        gids = np.repeat(np.arange(len(starts)), counts)
        inv_seq = np.where(~ok, seq, -1)[order]
        last_inv = np.maximum.reduceat(inv_seq, starts)
        valid_after = ok[order] & (seq[order] > last_inv[gids])
        n_after = np.bincount(gids, weights=valid_after, minlength=len(starts))
        ukeys = fs[starts]
        flat_table = self._table.reshape(-1)
        base = flat_table[ukeys]
        flat_table[ukeys] = np.where(
            last_inv >= 0, n_after, base + n_after
        ).astype(np.int64)
