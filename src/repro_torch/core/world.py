"""Persistent columnar world state for the EmBOINC-style simulator (§9).

``simulator.GridSimulation`` models a volunteer host population driving the
real server code in virtual time. Through PR 4 every *engine* around it was
vectorized (dispatch, daemons, client scheduling, validation), but the
simulation *world* itself — which hosts are up, what every host is running,
how far along each running instance is — lived in per-host Python dicts
mutated one event at a time, and every batch engine re-materialized its
inputs from those objects on every call.

This module is the struct-of-arrays replacement: :class:`HostArrays` owns
the population's columnar state and is maintained **incrementally at
mutation time** (observer-style, like ``store.py``'s indexes):

  * per-host columns: ``alive`` (churn status), ``available``, ``gen``
    (completion-event generation counters), ``last_update``, and the
    per-host metric accumulators (``busy`` CPU-seconds, ``flops`` done,
    ``capacity``);
  * a slot-major ``[max_jobs, n_hosts]`` queue matrix mirroring every
    client's job queue — static per-job fields written once on arrival
    (estimates, deadline, working set, usage), dynamic fields (accrued
    runtime, fraction done, run state, slice start) advanced in place;
  * per-host object mirrors (``queue_jobs``, ``row_of``) so scalar code and
    the vectorized passes address the same jobs.

Both simulator modes run on these arrays. The scalar oracle
(``vector_world=False``) performs the identical IEEE-754 operations one
host at a time through :meth:`advance_host`; the vectorized loop
(``vector_world=True``) advances a whole batch of event-sharing hosts in
one fused pass (:meth:`advance_batch`) and detects completions as a single
mask over the accrual matrix (:meth:`completed_rows_batch`). Because both
paths touch the same cells with the same operations in the same per-cell
order, whole-simulation results are bit-identical (asserted across the
scenario matrix by ``tests/test_world.py``).

Accrual is **clamped**: a running instance is charged at most the work it
has left (``actual_total - accrued``), so an availability or RPC event
landing after the nominal finish time — guaranteed under epoch-quantized
event times — cannot inflate runtimes, busy-time, or REC debits past the
instance's actual cost.

:class:`ExpDrawCache` supports the vectorized loop's availability
sampling: uniforms are prefetched from the simulation's ``random.Random``
in scalar event order and consumed FIFO (the pattern ``adaptive.py`` uses
for replication draws), so batched processing sees the exact draw sequence
the per-event oracle would — the exponential transform mirrors
``random.Random.expovariate`` term for term.
"""
from __future__ import annotations

import math
import random
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence, TYPE_CHECKING

import numpy as np

from . import torch_backend
from .backend import resolve_engine
from .client import RunState
from .types import ResourceType

if TYPE_CHECKING:  # pragma: no cover
    from .client import Client, ClientJob

_RUNNING = RunState.RUNNING
_DONE = RunState.DONE


class ExpDrawCache:
    """FIFO uniform-draw cache reproducing ``random.Random.expovariate``.

    ``prefetch`` pulls ``n`` uniforms from the RNG *now* in stream order;
    ``draw`` pops them FIFO (falling back to the live RNG when empty) and
    applies the exact CPython transform ``-log(1 - u) / lambd``. Any
    prefetch size therefore leaves every draw bit-identical to unbatched
    ``rng.expovariate(lambd)`` use.
    """

    __slots__ = ("_draws",)

    def __init__(self) -> None:
        self._draws: Deque[float] = deque()

    def prefetch(self, rng: random.Random, n: int) -> None:
        if n > 0:
            self._draws.extend(rng.random() for _ in range(n))

    def draw(self, rng: random.Random, lambd: float) -> float:
        u = self._draws.popleft() if self._draws else rng.random()
        return -math.log(1.0 - u) / lambd

    def __len__(self) -> int:
        return len(self._draws)


class HostArrays:
    """Columnar world state over a (dense-indexed) host population."""

    _Q0 = 8  # initial queue-matrix depth; doubled on demand

    def __init__(self, backend: str = "numpy", device="cuda") -> None:
        # "torch": the accrual/completion passes run against column mirrors
        # resident on ``device`` (core.torch_backend.WorldDeviceMirror) kept
        # current by the _touch dirty-range hooks below; bit-identical to
        # the NumPy passes (4th parity axis)
        self.backend, self.device = resolve_engine(backend, device)
        self._mirror = (
            torch_backend.WorldDeviceMirror(self.device) if self.backend == "torch" else None
        )
        self.n = 0  # registered hosts (dense slots, never reused)
        self._cap = 0
        self.index: Dict[int, int] = {}  # host_id -> dense slot
        self.ids = np.zeros(0, dtype=np.int64)
        # -- per-host state columns --
        self.alive = np.zeros(0, dtype=bool)
        self.available = np.zeros(0, dtype=bool)
        self.gen = np.zeros(0, dtype=np.int64)
        self.last_update = np.zeros(0, dtype=np.float64)
        # -- per-host metric accumulators (kept across churn) --
        self.busy = np.zeros(0, dtype=np.float64)
        self.flops = np.zeros(0, dtype=np.float64)
        self.capacity = np.zeros(0, dtype=np.float64)
        self.cap_ncpu = np.zeros(0, dtype=np.float64)  # CPU instances (capacity)
        # -- per-host client statics (engine snapshot columns) --
        self.ram = np.zeros(0, dtype=np.float64)
        self.ram_frac = np.zeros(0, dtype=np.float64)
        self.b_hi = np.zeros(0, dtype=np.float64)
        self.time_slice = np.zeros(0, dtype=np.float64)
        self.sched_ncpu = np.zeros(0, dtype=np.float64)  # §6.1 usable CPUs
        # -- defense-layer columns (§3.4): interned HR class id and current
        # suspicion-cluster id (synced from DefenseLayer); -1 = none --
        self.hr_id = np.zeros(0, dtype=np.int64)
        self.suspect_cluster = np.zeros(0, dtype=np.int64)
        # per-resource-type instance counts / presence (grown lazily)
        self.rtypes: List[ResourceType] = [ResourceType.CPU]
        self.nins: Dict[ResourceType, np.ndarray] = {
            ResourceType.CPU: np.zeros(0, dtype=np.float64)
        }
        self.has: Dict[ResourceType, np.ndarray] = {
            ResourceType.CPU: np.zeros(0, dtype=bool)
        }
        # -- slot-major queue matrix [Q, H] --
        self._q = 0  # current depth
        self.q_count = np.zeros(0, dtype=np.int64)
        self.q_estf = self._qz()
        self.q_efc = self._qz()
        self.q_frac = self._qz()
        self.q_runtime = self._qz()  # == accrued: the sim advances both as one
        self.q_total = self._qz()  # actual runtime drawn at dispatch
        self.q_dl = self._qz()
        self.q_wss = self._qz()
        self.q_slice = self._qz()
        self.q_chk = self._qz()
        self.q_weight = self._qz()  # max(sum(usage), 1): REC debit weight
        self.q_running = self._qz(bool)
        self.q_exact = self._qz(bool)
        self.q_nci = self._qz(bool)
        self.q_usage: Dict[ResourceType, np.ndarray] = {ResourceType.CPU: self._qz()}
        # -- per-host object mirrors --
        self.clients: List[Optional["Client"]] = []
        self.queue_jobs: List[List["ClientJob"]] = []
        self.row_of: List[Dict[int, int]] = []  # instance_id -> queue row
        self.project: List[Optional[str]] = []  # single attached project
        self.multi: List[bool] = []  # >1 project or mixed-project queue
        self.dirty: set = set()  # host ids needing object->column resync
        self.draws = ExpDrawCache()

    # ------------------------------------------------------------------
    # growth
    # ------------------------------------------------------------------

    def _qz(self, dtype=np.float64) -> np.ndarray:
        return np.zeros((self._q, self._cap), dtype=dtype)

    def _q_fields(self):
        yield from (
            "q_estf", "q_efc", "q_frac", "q_runtime", "q_total", "q_dl",
            "q_wss", "q_slice", "q_chk", "q_weight", "q_running", "q_exact",
            "q_nci",
        )

    def _grow_hosts(self, need: int) -> None:
        cap = max(self._cap * 2, need, 16)
        for name in (
            "ids", "alive", "available", "gen", "last_update", "busy",
            "flops", "capacity", "cap_ncpu", "ram", "ram_frac", "b_hi",
            "time_slice", "sched_ncpu", "hr_id", "suspect_cluster",
        ):
            old = getattr(self, name)
            new = np.zeros(cap, dtype=old.dtype)
            new[: old.shape[0]] = old
            setattr(self, name, new)
        # -1 sentinels for the defense columns' fresh slots
        self.hr_id[self._cap:] = -1
        self.suspect_cluster[self._cap:] = -1
        for d in (self.nins, self.has):
            for rt, old in d.items():
                new = np.zeros(cap, dtype=old.dtype)
                new[: old.shape[0]] = old
                d[rt] = new
        for name in self._q_fields():
            old = getattr(self, name)
            new = np.zeros((self._q, cap), dtype=old.dtype)
            new[:, : old.shape[1]] = old
            setattr(self, name, new)
        for rt, old in self.q_usage.items():
            new = np.zeros((self._q, cap), dtype=old.dtype)
            new[:, : old.shape[1]] = old
            self.q_usage[rt] = new
        oldc = self.q_count
        self.q_count = np.zeros(cap, dtype=np.int64)
        self.q_count[: oldc.shape[0]] = oldc
        self._cap = cap

    def _grow_queue(self, need: int) -> None:
        q = max(self._q * 2, need, self._Q0)
        for name in self._q_fields():
            old = getattr(self, name)
            new = np.zeros((q, self._cap), dtype=old.dtype)
            new[: old.shape[0]] = old
            setattr(self, name, new)
        for rt, old in self.q_usage.items():
            new = np.zeros((q, self._cap), dtype=old.dtype)
            new[: old.shape[0]] = old
            self.q_usage[rt] = new
        self._q = q

    def _ensure_rtype(self, rt: ResourceType) -> None:
        if rt not in self.nins:
            self.rtypes.append(rt)
            self.nins[rt] = np.zeros(self._cap, dtype=np.float64)
            self.has[rt] = np.zeros(self._cap, dtype=bool)
            self.q_usage[rt] = np.zeros((self._q, self._cap), dtype=np.float64)

    def _touch(self, i: int) -> None:
        """Dirty-range hook (backend="torch"): dense slot ``i``'s mirrored
        queue columns changed host-side; re-upload before the next device
        pass. Host-array growth/compaction is caught separately by the
        mirror's shape check, so only per-slot writers need to call this."""
        if self._mirror is not None:
            self._mirror.mark(i)

    # ------------------------------------------------------------------
    # registration / churn
    # ------------------------------------------------------------------

    def add_host(self, host_id: int, client: "Client", cap_ncpu: float, hr_id: int = -1) -> int:
        """Register a host and mirror its client's static columns."""
        if host_id in self.index:
            raise ValueError(f"host {host_id} already registered")
        i = self.n
        if i >= self._cap:
            self._grow_hosts(i + 1)
        self.n += 1
        self.index[host_id] = i
        self.ids[i] = host_id
        self.alive[i] = True
        self.available[i] = True
        self.gen[i] = 0
        self.last_update[i] = 0.0
        self.cap_ncpu[i] = cap_ncpu
        self.hr_id[i] = hr_id
        self.suspect_cluster[i] = -1
        self.clients.append(client)
        self.queue_jobs.append([])
        self.row_of.append({})
        names = list(client.projects)
        self.project.append(names[0] if len(names) == 1 else None)
        self.multi.append(len(names) > 1)
        self.refresh_client_statics(host_id)
        return i

    def refresh_client_statics(self, host_id: int) -> None:
        """(Re)mirror a client's per-host engine columns (prefs, resources).
        These are immutable during a simulation; call again if mutated."""
        i = self.index[host_id]
        c = self.clients[i]
        self.ram[i] = c.ram_bytes
        self.ram_frac[i] = c.prefs.ram_limit_fraction
        self.b_hi[i] = c.prefs.b_hi
        self.time_slice[i] = c.prefs.time_slice
        cpu = c.resources.get(ResourceType.CPU)
        self.sched_ncpu[i] = c.n_usable_cpus or (cpu.ninstances if cpu else 1)
        for rt in c.resources:
            self._ensure_rtype(rt)
        for rt in self.rtypes:
            res = c.resources.get(rt)
            self.nins[rt][i] = res.ninstances if res is not None else 0
            self.has[rt][i] = res is not None

    def remove_host(self, host_id: int) -> None:
        """Churn (§4): permanently drop the host's live state. Metric
        accumulators (busy/flops/capacity) are deliberately retained; every
        queue/running column and object mirror is purged so long-churn runs
        hold no per-departed-host state."""
        i = self.index.get(host_id)
        if i is None:
            return
        cnt = int(self.q_count[i])
        if cnt:
            for name in self._q_fields():
                getattr(self, name)[:cnt, i] = 0
            for col in self.q_usage.values():
                col[:cnt, i] = 0
            self.q_count[i] = 0
            self._touch(i)
        self.alive[i] = False
        self.available[i] = False
        self.hr_id[i] = -1
        self.suspect_cluster[i] = -1
        self.clients[i] = None
        self.queue_jobs[i] = []
        self.row_of[i] = {}
        self.project[i] = None
        self.dirty.discard(host_id)

    # ------------------------------------------------------------------
    # simple per-host accessors
    # ------------------------------------------------------------------

    def is_available(self, host_id: int) -> bool:
        i = self.index.get(host_id)
        return bool(self.available[i]) if i is not None else False

    def set_available(self, host_id: int, flag: bool) -> None:
        self.available[self.index[host_id]] = flag

    def gen_of(self, host_id: int) -> int:
        i = self.index.get(host_id)
        return int(self.gen[i]) if i is not None else 0

    def bump_gen(self, host_id: int) -> int:
        i = self.index[host_id]
        self.gen[i] += 1
        return int(self.gen[i])

    def get_accrued(self, host_id: int, instance_id: int) -> float:
        i = self.index[host_id]
        return float(self.q_runtime[self.row_of[i][instance_id], i])

    def set_accrued(self, host_id: int, instance_id: int, value: float) -> None:
        i = self.index[host_id]
        self.q_runtime[self.row_of[i][instance_id], i] = value
        self._touch(i)

    def get_total(self, host_id: int, instance_id: int) -> float:
        i = self.index[host_id]
        return float(self.q_total[self.row_of[i][instance_id], i])

    # ------------------------------------------------------------------
    # queue mutation (observer hooks called by the simulator)
    # ------------------------------------------------------------------

    def add_job(self, host_id: int, job: "ClientJob", actual_total: float) -> None:
        """Mirror a newly received job into the queue matrix."""
        i = self.index[host_id]
        row = int(self.q_count[i])
        if row >= self._q:
            self._grow_queue(row + 1)
        self.q_estf[row, i] = job.est_flops
        self.q_efc[row, i] = job.est_flop_count
        self.q_frac[row, i] = job.fraction_done
        self.q_runtime[row, i] = job.runtime
        self.q_total[row, i] = actual_total
        self.q_dl[row, i] = job.deadline
        self.q_wss[row, i] = job.est_wss
        self.q_slice[row, i] = job.slice_start
        self.q_chk[row, i] = job.checkpoint_time
        self.q_weight[row, i] = max(sum(job.usage.values()), 1.0)
        self.q_running[row, i] = job.state == _RUNNING
        self.q_exact[row, i] = job.fraction_done_exact
        self.q_nci[row, i] = job.non_cpu_intensive
        for rt, u in job.usage.items():
            self._ensure_rtype(rt)
        for rt in self.rtypes:
            self.q_usage[rt][row, i] = job.usage.get(rt, 0.0)
        self.queue_jobs[i].append(job)
        self.row_of[i][job.instance_id] = row
        self.q_count[i] = row + 1
        self._touch(i)
        if self.project[i] is not None and job.project != self.project[i]:
            self.multi[i] = True

    def remove_rows(self, host_id: int, rows: np.ndarray) -> None:
        """Drop queue rows (completed jobs), compacting the columns and
        zeroing the freed tail so padding cells stay exactly 0."""
        i = self.index[host_id]
        cnt = int(self.q_count[i])
        if len(rows) == 0:
            return
        mask = np.ones(cnt, dtype=bool)
        mask[rows] = False
        keep = np.flatnonzero(mask)
        newc = len(keep)
        for name in self._q_fields():
            col = getattr(self, name)
            col[:newc, i] = col[keep, i]
            col[newc:cnt, i] = 0
        for col in self.q_usage.values():
            col[:newc, i] = col[keep, i]
            col[newc:cnt, i] = 0
        jobs = self.queue_jobs[i]
        self.queue_jobs[i] = [jobs[r] for r in keep]
        self.row_of[i] = {
            j.instance_id: r for r, j in enumerate(self.queue_jobs[i])
        }
        self.q_count[i] = newc
        self._touch(i)

    def sync_run_state(self, host_id: int) -> None:
        """Re-mirror run-state-dependent columns after a (re)schedule
        mutated job states through ``Client._apply_run_set``."""
        i = self.index[host_id]
        q_running = self.q_running
        q_slice = self.q_slice
        q_chk = self.q_chk
        for row, j in enumerate(self.queue_jobs[i]):
            q_running[row, i] = j.state == _RUNNING
            q_slice[row, i] = j.slice_start
            q_chk[row, i] = j.checkpoint_time
        self._touch(i)

    def mark_dirty(self, host_id: int) -> None:
        """Flag a host whose ``ClientJob`` objects were mutated outside the
        simulator/engine hooks; its columns are rebuilt from the objects on
        the next snapshot (the dirty-host refresh contract)."""
        self.dirty.add(host_id)

    def resync_host(self, host_id: int) -> None:
        """Dirty-host refresh: rebuild the host's queue columns from its
        ``ClientJob`` objects (object fields win; ``actual_total`` — which
        exists only world-side — is carried over by instance id)."""
        i = self.index[host_id]
        cnt = int(self.q_count[i])
        totals = {
            j.instance_id: float(self.q_total[r, i])
            for r, j in enumerate(self.queue_jobs[i])
        }
        for name in self._q_fields():
            getattr(self, name)[:cnt, i] = 0
        for col in self.q_usage.values():
            col[:cnt, i] = 0
        client = self.clients[i]
        jobs = [j for j in client.jobs if j.state != _DONE] if client else []
        self.queue_jobs[i] = []
        self.row_of[i] = {}
        self.q_count[i] = 0
        self._touch(i)  # covers the zeroing even when no jobs re-add below
        for j in jobs:
            self.add_job(host_id, j, totals.get(j.instance_id, 0.0))
        self.dirty.discard(host_id)

    def sync_objects(self, host_ids: Sequence[int]) -> None:
        """Column->object sync: write authoritative accrual state back onto
        the ``ClientJob`` objects (used before falling back to an
        object-based snapshot). Every row is synced — preempted jobs carry
        accrual from earlier run periods too."""
        for h in host_ids:
            i = self.index[h]
            q_runtime = self.q_runtime
            q_frac = self.q_frac
            for row, j in enumerate(self.queue_jobs[i]):
                j.runtime = float(q_runtime[row, i])
                j.fraction_done = float(q_frac[row, i])

    # ------------------------------------------------------------------
    # accrual: scalar oracle and fused batch, identical per-cell math
    # ------------------------------------------------------------------

    def running_rows(self, host_id: int) -> np.ndarray:
        i = self.index[host_id]
        return np.flatnonzero(self.q_running[: self.q_count[i], i])

    def advance_host(self, host_id: int, t: float) -> None:
        """Scalar-oracle accrual for one host's running set: clamped
        charge of ``min(dt, actual_total - accrued)`` per running job, in
        queue-row order."""
        i = self.index.get(host_id)
        if i is None:
            return
        last = self.last_update[i]
        self.last_update[i] = t
        if not self.available[i] or not self.alive[i]:
            return
        cnt = int(self.q_count[i])
        if cnt == 0:
            return
        dt = t - last
        if dt <= 0:
            return
        rows = np.flatnonzero(self.q_running[:cnt, i])
        if rows.size == 0:
            return
        self._touch(i)  # mutates q_runtime/q_frac/busy below
        client = self.clients[i]
        q_runtime = self.q_runtime
        q_total = self.q_total
        jobs = self.queue_jobs[i]
        for row in rows:
            cj = jobs[row]
            total = q_total[row, i]
            rem = total - q_runtime[row, i]
            if rem < 0.0:
                rem = 0.0
            eff = dt if dt < rem else rem
            run = q_runtime[row, i] + eff
            q_runtime[row, i] = run
            cj.runtime = float(run)
            denom = total if total > 1e-9 else 1e-9
            frac = run / denom
            if frac > 1.0:
                frac = 1.0
            self.q_frac[row, i] = frac
            cj.fraction_done = float(frac)
            self.busy[i] += eff * self.q_usage[ResourceType.CPU][row, i]
            if client is not None:
                # REC debiting (§6.1): priorities must move with usage —
                # clamped to the work actually performed
                client.rec.debit(cj.project, eff * self.q_weight[row, i], t)

    def advance_batch(self, host_ids: Sequence[int], t: float) -> None:
        """Fused accrual for all hosts sharing an event time: one clamped
        array pass per occupied queue row, touching each (row, host) cell
        with the same IEEE operations — in the same per-cell order — as
        :meth:`advance_host`. Multi-project hosts (whose REC debits must
        stay per-job sequential to be bit-identical) are routed through the
        scalar path; the simulator's single-project populations never are."""
        if not host_ids:
            return
        index = self.index
        fused: List[int] = []
        for h in host_ids:
            i = index.get(h)
            if i is None:
                continue
            if self.multi[i]:
                self.advance_host(h, t)
            else:
                fused.append(i)
        if not fused:
            return
        idx = np.fromiter(fused, np.int64, len(fused))
        dt = t - self.last_update[idx]
        self.last_update[idx] = t
        act = (
            self.available[idx]
            & self.alive[idx]
            & (dt > 0.0)
            & (self.q_count[idx] > 0)
        )
        if not act.any():
            return
        sub = idx[act]
        dts = dt[act]
        debit, touched = self._advance_cols(sub, dts)
        if touched.any():
            clients = self.clients
            projects = self.project
            for j in np.flatnonzero(touched):
                i = int(sub[j])
                c = clients[i]
                if c is not None and projects[i] is not None:
                    c.rec.debit(projects[i], float(debit[j]), t)

    def _advance_cols(self, sub: np.ndarray, dts: np.ndarray):
        """The fused accrual pass over active dense slots ``sub``: returns
        (per-slot REC debit totals, touched mask). Backend-dispatched —
        this is the kernel the 1M-host bench times in isolation."""
        if self._mirror is not None:
            # device accrual: same per-cell IEEE ops and k-sequential
            # accumulation order as the loop below, the eff·usage and
            # eff·weight products rounded before the fold (core.torch_backend)
            debit, touched = self._mirror.advance(self, sub, dts)
        else:
            K = int(self.q_count[sub].max())
            cpu_u = self.q_usage[ResourceType.CPU]
            debit = np.zeros(len(sub), dtype=np.float64)
            touched = np.zeros(len(sub), dtype=bool)
            for k in range(K):
                m = self.q_running[k, sub]
                if not m.any():
                    continue
                s2 = sub[m]
                d2 = dts[m]
                tot = self.q_total[k, s2]
                run = self.q_runtime[k, s2]
                rem = tot - run
                rem = np.where(rem < 0.0, 0.0, rem)
                eff = np.where(d2 < rem, d2, rem)
                run = run + eff
                self.q_runtime[k, s2] = run
                denom = np.where(tot > 1e-9, tot, 1e-9)
                frac = run / denom
                self.q_frac[k, s2] = np.where(frac > 1.0, 1.0, frac)
                self.busy[s2] += eff * cpu_u[k, s2]
                debit[m] += eff * self.q_weight[k, s2]
                touched |= m
        return debit, touched

    # ------------------------------------------------------------------
    # completion detection
    # ------------------------------------------------------------------

    def completed_rows(self, host_id: int) -> np.ndarray:
        """Queue rows of running jobs that have accrued their full cost."""
        i = self.index[host_id]
        cnt = int(self.q_count[i])
        if cnt == 0:
            return np.zeros(0, dtype=np.int64)
        col = slice(0, cnt)
        return np.flatnonzero(
            self.q_running[col, i]
            & (self.q_runtime[col, i] >= self.q_total[col, i] - 1e-6)
        )

    def completed_rows_batch(
        self, host_ids: Sequence[int]
    ) -> Dict[int, np.ndarray]:
        """Fused completion detection: one mask over the accrual matrix for
        every given host, returned as per-host row arrays."""
        index = self.index
        live = [(h, index[h]) for h in host_ids if h in index]
        if not live:
            return {}
        idx = np.fromiter((i for _, i in live), np.int64, len(live))
        counts = self.q_count[idx]
        K = int(counts.max()) if len(idx) else 0
        if K == 0:
            return {h: np.zeros(0, dtype=np.int64) for h, _ in live}
        if self._mirror is not None:
            sub = self._mirror.completed_mask(self, idx, counts)[:K]
        else:
            sub = self.q_running[:K, idx] & (
                self.q_runtime[:K, idx] >= self.q_total[:K, idx] - 1e-6
            )
            sub &= np.arange(K)[:, None] < counts[None, :]
        out: Dict[int, np.ndarray] = {}
        rows, cols = np.nonzero(sub.T)  # host-major
        split = np.searchsorted(rows, np.arange(len(idx) + 1))
        for j, (h, _) in enumerate(live):
            out[h] = cols[split[j]: split[j + 1]]
        return out

    # ------------------------------------------------------------------
    # metric totals (shared by both simulator modes)
    # ------------------------------------------------------------------

    def add_capacity(self, dt: float) -> None:
        n = self.n
        alive = self.alive[:n]
        self.capacity[:n][alive] += self.cap_ncpu[:n][alive] * dt

    def busy_total(self) -> float:
        return float(np.add.reduce(self.busy[: self.n]))

    def flops_total(self) -> float:
        return float(np.add.reduce(self.flops[: self.n]))

    def capacity_total(self) -> float:
        return float(np.add.reduce(self.capacity[: self.n]))

    # ------------------------------------------------------------------
    # invariants (the simulator's audit calls this, like store.check_invariants)
    # ------------------------------------------------------------------

    def check_invariants(self, strict_dynamic: bool = False) -> None:
        """Column <-> object agreement. ``strict_dynamic`` additionally
        checks accrual columns against object attributes (valid in scalar
        mode, where both are advanced together; the vectorized loop leaves
        object runtime/fraction intentionally stale until completion)."""
        for h, i in self.index.items():
            cnt = int(self.q_count[i])
            jobs = self.queue_jobs[i]
            assert len(jobs) == cnt, f"host {h}: queue length mismatch"
            if not self.alive[i]:
                assert cnt == 0, f"churned host {h} retains queue rows"
                assert self.clients[i] is None, f"churned host {h} retains client"
                continue
            assert self.row_of[i] == {
                j.instance_id: r for r, j in enumerate(jobs)
            }, f"host {h}: row index mismatch"
            for r, j in enumerate(jobs):
                assert j.state != _DONE, f"host {h}: DONE job resident in queue"
                assert self.q_running[r, i] == (j.state == _RUNNING), (
                    f"host {h} row {r}: run-state column stale"
                )
                assert self.q_dl[r, i] == j.deadline
                assert self.q_estf[r, i] == j.est_flops
                if strict_dynamic:
                    assert self.q_runtime[r, i] == j.runtime, (
                        f"host {h} row {r}: runtime column diverged"
                    )
                    assert self.q_frac[r, i] == j.fraction_done
            # freed tail must be exactly zero (engine padding contract)
            if cnt < self._q:
                assert not self.q_running[cnt:, i].any()
                assert not self.q_estf[cnt:, i].any()
