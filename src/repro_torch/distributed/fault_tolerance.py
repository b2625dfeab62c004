"""Fleet-level fault tolerance: heartbeats, churn, elastic mesh selection.

The paper's host-churn handling (deadline + retry, §4) covers *job*-level
faults; this module covers *fleet*-level reconfiguration for the synchronous
SPMD layer: when workers join/leave, pick the largest supported mesh from
the live worker set, restart from the last checkpoint, and rescale
per-worker microbatches so the global batch is preserved (BOINC's multi-size
jobs, §3.5, applied to elasticity).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass
class WorkerHealth:
    worker_id: int
    last_heartbeat: float = 0.0
    consecutive_misses: int = 0
    alive: bool = True


@dataclass
class HeartbeatMonitor:
    """Deadline-style liveness: a worker missing ``max_misses`` heartbeat
    periods is declared dead (exactly the paper's delay_bound logic applied
    at the transport layer)."""

    period: float = 10.0
    max_misses: int = 3
    workers: Dict[int, WorkerHealth] = field(default_factory=dict)

    def register(self, worker_id: int, now: float) -> None:
        self.workers[worker_id] = WorkerHealth(worker_id, last_heartbeat=now)

    def heartbeat(self, worker_id: int, now: float) -> None:
        w = self.workers.setdefault(worker_id, WorkerHealth(worker_id))
        w.last_heartbeat = now
        w.consecutive_misses = 0
        w.alive = True

    def sweep(self, now: float) -> List[int]:
        """Returns workers newly declared dead."""
        died = []
        for w in self.workers.values():
            if not w.alive:
                continue
            missed = int((now - w.last_heartbeat) / self.period)
            w.consecutive_misses = missed
            if missed >= self.max_misses:
                w.alive = False
                died.append(w.worker_id)
        return died

    def live(self) -> List[int]:
        return [w.worker_id for w in self.workers.values() if w.alive]


# ---------------------------------------------------------------------------
# Elastic mesh selection
# ---------------------------------------------------------------------------

#: supported (data, model) meshes per pod, largest first. The model axis is
#: fixed by the arch's TP requirement; elasticity happens on data/pod axes.
def candidate_meshes(
    n_chips: int, model_axis: int = 16, pods: int = 1
) -> List[Tuple[int, ...]]:
    out = []
    per_pod = n_chips // max(pods, 1)
    data = per_pod // model_axis
    # drop to the largest power-of-two data axis that fits
    d = 1 << int(math.floor(math.log2(data))) if data >= 1 else 0
    while d >= 1:
        if pods > 1:
            out.append((pods, d, model_axis))
        else:
            out.append((d, model_axis))
        d //= 2
    return out


@dataclass
class ElasticPlan:
    mesh_shape: Tuple[int, ...]
    microbatch_per_worker: int
    grad_accum_steps: int


def plan_elastic_config(
    live_chips: int,
    global_batch: int,
    model_axis: int = 16,
    pods: int = 1,
) -> Optional[ElasticPlan]:
    """Largest runnable mesh for the live chip count + batch rescale.

    Keeps the global batch constant by raising gradient-accumulation steps
    when the data axis shrinks (preserving optimization semantics across
    elasticity events)."""
    meshes = candidate_meshes(live_chips, model_axis, pods)
    for shape in meshes:
        data_ways = shape[0] * shape[1] if len(shape) == 3 else shape[0]
        if data_ways == 0:
            continue
        if global_batch % data_ways != 0:
            continue
        per = global_batch // data_ways
        # bound per-worker microbatch; accumulate if too large
        accum = 1
        while per > 64:
            if per % 2:
                break
            per //= 2
            accum *= 2
        return ElasticPlan(mesh_shape=shape, microbatch_per_worker=per, grad_accum_steps=accum)
    return None


# ---------------------------------------------------------------------------
# Straggler mitigation at the step level
# ---------------------------------------------------------------------------


@dataclass
class StragglerPolicy:
    """Deadline-based re-dispatch (§4) for step tasks: a microbatch job that
    hasn't returned within ``factor`` x the running mean step time is
    re-dispatched to the fastest idle host (§3.5 job-size matching)."""

    factor: float = 3.0
    min_samples: int = 8
    _mean: float = 0.0
    _n: int = 0

    def observe(self, runtime: float) -> None:
        self._n += 1
        self._mean += (runtime - self._mean) / self._n

    def deadline(self, now: float) -> float:
        if self._n < self.min_samples:
            return now + 3600.0
        return now + self.factor * self._mean

    @property
    def mean_runtime(self) -> float:
        return self._mean
