"""Shard-aware federated dispatch (§5.1 scale-out).

The paper scales a BOINC server by running multiple scheduler instances
against one shared-memory job cache. This module adds the partitioning
layer that makes those instances *federated* rather than merely concurrent:

  * a stable **host→shard affinity** — every host is served by exactly one
    scheduler instance (``shard_of``), pinned overrides allowed — so a
    coalesced ``rpc_batch`` runs one vectorized ``handle_batch`` pass per
    shard instead of falling back to sequential per-request dispatch;
  * a **slot-ownership map** over the feeder cache — position ``i`` belongs
    to shard ``i % n_shards`` until migrated — giving each shard its own
    cache slice and therefore its own persistent
    :class:`~repro_torch.core.batch_dispatch.BatchDispatchEngine` snapshot (keyed
    off the existing ``Feeder.version`` contract);
  * deterministic **work migration**: a starved shard (fewer live slots
    than ``ShardPolicy.low_watermark``) steals the lowest-index live slots
    from donor shards in ring order until it reaches
    ``ShardPolicy.refill_target``, never drawing a donor below the
    watermark. Every migration reassigns ownership and bumps the feeder's
    cache generation so all shard snapshots rebuild against the new map.

Parity contract: single-shard configs never construct a ShardMap, so they
stay bit-identical to the unsharded goldens; multi-shard assignment
equivalence is pinned by ``tests/test_shard_dispatch.py`` (union of
per-shard assignments == sequential affinity-routed dispatch under a pinned
affinity map equal to round-robin order).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class ShardPolicy:
    """Work-migration knobs. ``low_watermark=0`` disables migration (no
    shard is ever considered starved) — the parity tests use that to keep
    sequential and batched twins byte-for-byte comparable."""

    low_watermark: int = 4  # a shard is starved below this many live slots
    refill_target: int = 8  # steal until the starved shard holds this many
    max_moves: int = 64  # per-rebalance cap on stolen slots


@dataclass
class ShardStats:
    """Per-shard utilization counters (reported by the service layer and
    the RPC benchmark's per-shard utilization rows)."""

    requests: int = 0
    dispatched: int = 0
    migrations_in: int = 0
    migrations_out: int = 0


@dataclass
class ShardMap:
    """Host→shard affinity + feeder-cache slot ownership + migration."""

    n_shards: int
    cache_size: int
    # pinned host_id → shard overrides; unlisted hosts use host_id % n_shards
    affinity: Optional[Dict[int, int]] = None
    policy: ShardPolicy = field(default_factory=ShardPolicy)
    # slot position -> owning shard; initialized round-robin so every shard
    # gets an interleaved slice of whatever the feeder interleaves
    owner: np.ndarray = field(init=False, repr=False)
    stats: List[ShardStats] = field(init=False, repr=False)
    _owned: Dict[int, List[int]] = field(default_factory=dict, init=False, repr=False)

    def __post_init__(self) -> None:
        assert self.n_shards >= 1
        self.owner = np.arange(self.cache_size, dtype=np.int64) % self.n_shards
        self.stats = [ShardStats() for _ in range(self.n_shards)]

    # ------------------------------------------------------------------
    # affinity
    # ------------------------------------------------------------------

    def shard_of(self, host_id: int) -> int:
        """Stable host→shard affinity: pinned override, else modulo."""
        if self.affinity is not None:
            pinned = self.affinity.get(host_id)
            if pinned is not None:
                return pinned % self.n_shards
        return host_id % self.n_shards

    def forget_host(self, host_id: int) -> None:
        """Churn purge: drop the host's pinned affinity override (the
        modulo fallback is stateless). A host that rejoins under the same
        id is served by ``host_id % n_shards`` unless re-pinned."""
        if self.affinity is not None:
            self.affinity.pop(host_id, None)

    # ------------------------------------------------------------------
    # slot ownership
    # ------------------------------------------------------------------

    def owned_positions(self, shard: int) -> List[int]:
        """Ascending cache positions owned by ``shard`` (cached; the cache
        is dropped whenever migration rewrites the ownership map)."""
        cached = self._owned.get(shard)
        if cached is None:
            cached = np.flatnonzero(self.owner == shard).tolist()
            self._owned[shard] = cached
        return cached

    def live_count(self, feeder, shard: int) -> int:
        """Live (resident, not taken) slots currently owned by ``shard``.
        Between feeder fills every resident slot references a dispatchable
        instance (the feeder clears stale slots on fill), so this is the
        shard's dispatchable supply."""
        slots = feeder.slots
        return sum(
            1
            for p in self.owned_positions(shard)
            if slots[p] is not None and not slots[p].taken
        )

    # ------------------------------------------------------------------
    # work migration
    # ------------------------------------------------------------------

    def rebalance(self, feeder, shard: int) -> int:
        """Deterministic work migration for a starved shard.

        If ``shard`` holds fewer than ``policy.low_watermark`` live slots,
        steal the lowest-index live slots from donors in ring order
        (``shard+1, shard+2, …`` mod n) until it holds
        ``policy.refill_target`` (or ``policy.max_moves`` / donors run
        dry); donors are never drawn below the watermark. Returns the
        number of slots moved; any move bumps the feeder's cache
        generation so every shard's persistent engine snapshot rebuilds
        against the new ownership map.
        """
        pol = self.policy
        if pol.low_watermark <= 0 or self.n_shards < 2:
            return 0
        my_live = self.live_count(feeder, shard)
        if my_live >= pol.low_watermark:
            return 0
        slots = feeder.slots
        moved = 0
        for step in range(1, self.n_shards):
            if my_live >= pol.refill_target or moved >= pol.max_moves:
                break
            donor = (shard + step) % self.n_shards
            donor_live = [
                p
                for p in self.owned_positions(donor)
                if slots[p] is not None and not slots[p].taken
            ]
            while (
                my_live < pol.refill_target
                and moved < pol.max_moves
                and len(donor_live) > pol.low_watermark
            ):
                p = donor_live.pop(0)  # lowest-index live donor slot
                self.owner[p] = shard
                moved += 1
                my_live += 1
                self.stats[shard].migrations_in += 1
                self.stats[donor].migrations_out += 1
        if moved:
            self._owned.clear()
            feeder.invalidate()
        return moved

    # ------------------------------------------------------------------
    # utilization
    # ------------------------------------------------------------------

    def note(self, shard: int, requests: int = 0, dispatched: int = 0) -> None:
        st = self.stats[shard]
        st.requests += requests
        st.dispatched += dispatched

    def utilization(self) -> List[Dict[str, int]]:
        """Per-shard counters + current slot ownership, for the service
        layer's ``stats()`` and ``BENCH_rpc.json``'s utilization rows."""
        counts = np.bincount(self.owner, minlength=self.n_shards)
        return [
            {
                "shard": k,
                "requests": st.requests,
                "dispatched": st.dispatched,
                "migrations_in": st.migrations_in,
                "migrations_out": st.migrations_out,
                "owned_slots": int(counts[k]),
            }
            for k, st in enumerate(self.stats)
        ]
