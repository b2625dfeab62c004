"""Vectorized host-population client engine (§6.1–6.2, §9).

The EmBOINC-style emulator (§9) exists to model *large* volunteer
populations, but the client half of the paper — weighted-round-robin
resource scheduling with the deadline-miss WRR simulation (§6.1, Fig. 5)
and buffer-watermark work fetch (§6.2) — was scalar Python executed once
per host per event. After PR 1 vectorized server dispatch and PR 2 made
daemon passes O(dirty), the per-host ``wrr_simulate`` / ``Client.schedule``
calls dominate simulator tick cost and cap populations orders of magnitude
below the million-host target.

This module is the third leg of the scalar-oracle + vectorized-engine
architecture: it materializes a set of clients' job queues into
struct-of-arrays form (jobs padded to a per-host ragged layout, slot-major
``[max_jobs, n_hosts]`` so every per-slot pass runs over contiguous rows)
once per tick and runs, for *all hosts sharing the tick*, as fused NumPy
passes:

  * the **WRR simulation**: per-event greedy maximal sets under CPU/GPU/RAM
    feasibility masks, fluid busy-time accounting, deadline-miss
    prediction, and per-resource shortfall / idle / queue-duration /
    saturation outputs;
  * the **run-set selection** of ``Client.schedule``: the §6.1 ordering key
    (EDF-for-misses, GPU-first, mid-slice, CPU width, per-project priority
    broadcast) as one stable global ``np.lexsort``, then the greedy maximal
    feasible set as per-rank vector passes;
  * **work fetch**: the buffer-watermark test (§6.2) over the batched WRR
    outputs, mirroring ``Client._requests_from_sim`` per host.

Every per-element operation mirrors the scalar path in IEEE-754 order:
sequential Python ``sum``/``min`` folds map to ``np.add.reduce`` /
``np.minimum.reduce`` along the slot axis (bitwise-identical row-sequential
accumulation), masked selects use ``x * mask`` / ``reduce(where=...)``
forms that add exact zeros, and the rare inputs where Python's ``min``/
``max`` NaN semantics could diverge (infinite remaining estimates, i.e.
``est_flops <= 0``) fall back to exact ``np.where`` folds. The engine is
therefore *bit-exact* with the scalar oracle: identical run sets,
deadline-miss sets, and work requests. ``tests/test_batch_client.py``
asserts it, ``benchmarks/bench_clients.py`` measures the speedup
(acceptance floor: ≥10× client tick cost at the 10k-host population).
Client state mutations (miss flags, run/preempt transitions) go through
the same ``Client`` helpers as the scalar path.

Known scalar-oracle degeneracy inherited by design: duplicate
``instance_id`` values within one queue share a remaining-time entry in
``wrr_simulate``; the engine keeps per-slot remaining times, so parity is
scoped to queues with unique instance ids (always true for
server-dispatched work).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, TYPE_CHECKING

import numpy as np

from .backend import resolve_backend
from .client import Client, ClientJob, RunState, WorkRequest, WRRResult
from .scheduler import ResourceRequest
from .types import ResourceType

if TYPE_CHECKING:  # pragma: no cover
    from .world import HostArrays

_MAX_EVENTS = 10_000  # mirrors wrr_simulate's event cap

_GPU_LIKE = (ResourceType.GPU, ResourceType.TPU)

# per-job build-row fields (queue order), before the per-resource usage tail
_NFIELDS = 12


class _Snapshot:
    """SoA view of a set of clients' live queues at one tick.

    Per-job arrays are slot-major ``[J, H]`` (slot k of every host is a
    contiguous row) in *queue order*; ``perm`` maps WRR rank → queue slot.
    """

    __slots__ = (
        "clients", "queued", "prios", "H", "J", "rtypes",
        "live", "rem", "dl", "wss", "nci", "run_state", "slice_start",
        "chk_time", "prio_j", "usage", "cu", "gpu", "perm", "has_inf",
        "identity_perm",
        "nins", "has", "all_has", "client_rtypes", "ram", "ram_frac",
        "horizon", "ts", "ncpu",
    )


class _WRROut:
    """Raw per-host WRR outputs ([H] arrays keyed by resource type)."""

    __slots__ = ("misses", "shortfall", "idle", "queue_dur", "saturated")

    def __init__(self, misses, shortfall, idle, queue_dur, saturated):
        self.misses = misses
        self.shortfall = shortfall
        self.idle = idle
        self.queue_dur = queue_dur
        self.saturated = saturated


class BatchClientEngine:
    """Fused-pass WRR simulation + run-set selection over a host population.

    Stateless between calls: every entry point snapshots the given clients'
    queues (their state changes every tick) and runs the vector passes.
    ``schedule_batch`` / ``tick_batch`` apply the same mutations as
    ``Client.schedule`` via ``Client._set_miss_flags`` /
    ``Client._apply_run_set``.
    """

    def __init__(self, backend: str = "numpy") -> None:
        # NumPy only in the port (core/backend.py)
        self.backend = resolve_backend(backend)

    # ------------------------------------------------------------------
    # snapshot construction
    # ------------------------------------------------------------------

    def _snapshot(
        self, clients: Sequence[Client], now: float, accrue_empty: bool = True
    ) -> _Snapshot:
        s = _Snapshot()
        s.clients = list(clients)
        H = len(s.clients)
        s.H = H
        # priority accrual side effects are identical to the scalar path:
        # Client.needs_work calls project_priorities(now) unconditionally,
        # but Client.schedule early-returns *before* accrual on an empty
        # queue — schedule_batch passes accrue_empty=False to mirror that
        # (an accrual at an intermediate time changes float association)
        s.prios = [
            c.project_priorities(now)
            if (accrue_empty or any(j.state != RunState.DONE for j in c.jobs))
            else {}
            for c in s.clients
        ]

        # resource-type universe: client resources ∪ job usage keys (the
        # CPU identity test skips hashing on the dominant CPU-only case)
        rt_seen: Dict[ResourceType, None] = {}
        rt_cpu = ResourceType.CPU
        rt_seen.setdefault(rt_cpu, None)
        for c in s.clients:
            for rt in c.resources:
                rt_seen.setdefault(rt, None)
        for c in s.clients:
            for j in c.jobs:
                for rt in j.usage:
                    if rt is not rt_cpu and rt not in rt_seen:
                        rt_seen[rt] = None
        rtypes = list(rt_seen)
        s.rtypes = rtypes
        R = len(rtypes)

        flat: List[float] = []
        ext = flat.extend
        perm_rows: List[Sequence[int]] = []
        s.queued = []
        running_state = RunState.RUNNING
        done_state = RunState.DONE
        # specialize the usage-column tail for the common 1–2 resource cases
        rt0 = rtypes[0] if R > 0 else None
        rt1 = rtypes[1] if R > 1 else None
        for c, pr in zip(s.clients, s.prios):
            q: List[ClientJob] = []
            qappend = q.append
            multi = len(pr) > 1
            if multi:
                prs: List[float] = []
                prappend = prs.append
            else:
                # single attached project: constant priority, FIFO WRR order
                # (jobs of detached projects fall back to 0.0 — tracked as
                # orphan indices so the WRR sort still happens when needed)
                pr_name, pr_val = next(iter(pr.items()), (None, 0.0))
                orphans: List[int] = []
            k = 0
            for j in c.jobs:
                if j.state == done_state:
                    continue
                qappend(j)
                if multi:
                    pj = pr.get(j.project, 0.0)
                    prappend(pj)
                elif j.project == pr_name:
                    pj = pr_val
                else:
                    pj = 0.0
                    orphans.append(k)
                # usage columns via items() + identity tests: enum keys hash
                # through a Python-level __hash__, identity is free
                u = j.usage
                if R <= 2:
                    u0 = u1 = 0.0
                    for rt, v in u.items():
                        if rt is rt0:
                            u0 = v
                        elif rt is rt1:
                            u1 = v
                    ext((
                        j.est_flops, j.est_flop_count, j.fraction_done,
                        j.fraction_done_exact, j.runtime, j.deadline,
                        j.est_wss, j.non_cpu_intensive,
                        j.slice_start, j.checkpoint_time,
                        j.state == running_state, pj, u0, u1,
                    ) if R == 2 else (
                        j.est_flops, j.est_flop_count, j.fraction_done,
                        j.fraction_done_exact, j.runtime, j.deadline,
                        j.est_wss, j.non_cpu_intensive,
                        j.slice_start, j.checkpoint_time,
                        j.state == running_state, pj, u0,
                    ))
                else:
                    ext((
                        j.est_flops, j.est_flop_count, j.fraction_done,
                        j.fraction_done_exact, j.runtime, j.deadline,
                        j.est_wss, j.non_cpu_intensive,
                        j.slice_start, j.checkpoint_time,
                        j.state == running_state, pj,
                    ) + tuple(u.get(rt, 0.0) for rt in rtypes))
                k += 1
            s.queued.append(q)
            if not multi:
                prs = []
                if orphans and pr_val != 0.0:
                    prs = [pr_val] * k
                    for i in orphans:
                        prs[i] = 0.0
            if len(set(prs)) > 1:
                # WRR order: by project priority, stable FIFO inside a project
                perm_rows.append(
                    sorted(range(k), key=prs.__getitem__, reverse=True)
                )
            else:
                perm_rows.append(())  # identity — perm rows pre-filled
        s.identity_perm = all(not p for p in perm_rows)

        counts = (
            np.fromiter(map(len, s.queued), np.int64, H)
            if H
            else np.zeros(0, np.int64)
        )
        J = int(counts.max()) if H else 0
        s.J = J

        nf = _NFIELDS + R
        # ragged-layout mask: rows were appended host-major in queue order
        mask_hm = (
            np.arange(J)[None, :] < counts[:, None]
            if J
            else np.zeros((H, 0), dtype=bool)
        )
        s.live = np.ascontiguousarray(mask_hm.T)
        s.perm = (
            np.tile(np.arange(J, dtype=np.int64)[:, None], (1, H))
            if J
            else np.zeros((0, H), np.int64)
        )
        for h, p in enumerate(perm_rows):
            if p:
                s.perm[: len(p), h] = np.fromiter(p, np.int64, len(p))

        if flat:
            m = np.asarray(flat, dtype=np.float64).reshape(-1, nf)
            # one boolean-mask scatter for every per-job column, then one
            # transpose into the slot-major layout the passes consume
            big = np.zeros((nf, H, J))
            big[:, mask_hm] = m.T
            big = np.ascontiguousarray(big.transpose(0, 2, 1))
            (ef, efc, fd, exact_f, runtime, dl, wss, nci_f,
             slice_start, chk_time, run_f, prio_j) = big[:_NFIELDS]
            s.dl = dl
            s.wss = wss
            s.nci = nci_f > 0.5
            s.run_state = run_f > 0.5
            s.slice_start = slice_start
            s.chk_time = chk_time
            s.prio_j = prio_j
            s.usage = {rt: big[_NFIELDS + i] for i, rt in enumerate(rtypes)}
            exact = exact_f > 0.5
            # remaining_estimate, vectorized in the scalar path's IEEE order
            with np.errstate(divide="ignore", invalid="ignore"):
                static = np.where(ef > 0.0, efc / ef, np.inf)
                dynamic = np.where(fd > 0.0, runtime / fd, 0.0)
                total = np.where(exact, dynamic, fd * dynamic + (1.0 - fd) * static)
                d = total - runtime
                # fd <= 0 short-circuits to the static total, *without* the
                # max(0, total - runtime) clamp — mirror that exactly; the
                # d > 0 select also reproduces Python max(0.0, nan) == 0.0
                rem = np.where(fd > 0.0, np.where(d > 0.0, d, 0.0), static)
            s.rem = np.maximum(rem, 1e-9)
            # padding slots are inf by construction (ef=0) — only *live*
            # infinite estimates force the NaN-exact slow folds
            s.has_inf = bool(np.isinf(s.rem[s.live]).any())
        else:
            z = np.zeros((J, H))
            s.rem = z
            s.dl = z
            s.wss = z
            s.nci = np.zeros((J, H), dtype=bool)
            s.run_state = np.zeros((J, H), dtype=bool)
            s.slice_start = z
            s.chk_time = z
            s.prio_j = z
            s.usage = {rt: np.zeros((J, H)) for rt in rtypes}
            s.has_inf = False

        s.client_rtypes = [list(c.resources) for c in s.clients]
        s.nins = {}
        s.has = {}
        for rt in rtypes:
            s.nins[rt] = np.fromiter(
                (c.resources[rt].ninstances if rt in c.resources else 0
                 for c in s.clients),
                np.float64, H,
            )
            s.has[rt] = np.fromiter(
                (rt in c.resources for c in s.clients), np.bool_, H
            )
        s.ram = np.fromiter((c.ram_bytes for c in s.clients), np.float64, H)
        s.ram_frac = np.fromiter(
            (c.prefs.ram_limit_fraction for c in s.clients), np.float64, H
        )
        s.horizon = np.fromiter((c.prefs.b_hi for c in s.clients), np.float64, H)
        s.ts = np.fromiter((c.prefs.time_slice for c in s.clients), np.float64, H)
        s.ncpu = np.fromiter(
            (c.n_usable_cpus
             or (c.resources[ResourceType.CPU].ninstances
                 if ResourceType.CPU in c.resources else 1)
             for c in s.clients),
            np.float64, H,
        )
        s.all_has = {rt: bool(s.has[rt].all()) for rt in rtypes}
        s.cu = s.usage.get(ResourceType.CPU, np.zeros((J, H)))
        gpu = np.zeros((J, H), dtype=bool)
        for rt in _GPU_LIKE:
            if rt in s.usage:
                gpu |= s.usage[rt] > 0.0
        s.gpu = gpu
        return s

    # ------------------------------------------------------------------
    # world-backed snapshot: persistent columns, no per-job rebuild
    # ------------------------------------------------------------------

    def _snapshot_world(
        self,
        world: "HostArrays",
        host_ids: Sequence[int],
        now: float,
        accrue_empty: bool = True,
    ) -> _Snapshot:
        """Build a :class:`_Snapshot` from the simulator's persistent world
        columns (``core/world.py``) instead of re-materializing every
        ``ClientJob`` object: the per-job fields were mirrored into the
        slot-major ``[max_jobs, n_hosts]`` matrix at mutation time, so the
        snapshot is a set of column gathers plus the shared
        remaining-estimate formula — bit-identical to :meth:`_snapshot`
        over the same queues.

        Dirty-host refresh contract: hosts whose ``ClientJob`` objects were
        mutated outside the simulator/engine hooks (``world.mark_dirty``)
        get their columns rebuilt from the objects first. Multi-project
        hosts (whose WRR priority ordering needs the per-job project map)
        fall back to the object snapshot after a column->object sync.
        """
        if world.dirty:
            for h in host_ids:
                if h in world.dirty:
                    world.resync_host(h)
        idx_l = [world.index[h] for h in host_ids]
        clients = [world.clients[i] for i in idx_l]
        if any(
            world.multi[i] or world.clients[i] is None
            or len(world.clients[i].projects) > 1
            for i in idx_l
        ):
            world.sync_objects(host_ids)
            return self._snapshot(clients, now, accrue_empty)

        s = _Snapshot()
        s.clients = clients
        H = len(clients)
        s.H = H
        idx = np.fromiter(idx_l, np.int64, H) if H else np.zeros(0, np.int64)
        counts = world.q_count[idx]
        # priority accrual side effects mirror the object path: needs_work
        # accrues unconditionally, schedule skips empty queues
        s.prios = [
            c.project_priorities(now)
            if (accrue_empty or counts[k] > 0)
            else {}
            for k, c in enumerate(clients)
        ]
        rtypes = list(world.rtypes)
        s.rtypes = rtypes
        J = int(counts.max()) if H else 0
        s.J = J
        s.live = (
            np.arange(J)[:, None] < counts[None, :]
            if J
            else np.zeros((0, H), dtype=bool)
        )
        s.perm = (
            np.tile(np.arange(J, dtype=np.int64)[:, None], (1, H))
            if J
            else np.zeros((0, H), np.int64)
        )
        s.identity_perm = True  # single project per host: WRR order is FIFO

        ef = world.q_estf[:J, idx]
        efc = world.q_efc[:J, idx]
        fd = world.q_frac[:J, idx]
        runtime = world.q_runtime[:J, idx]
        exact = world.q_exact[:J, idx]
        s.dl = world.q_dl[:J, idx]
        s.wss = world.q_wss[:J, idx]
        s.nci = world.q_nci[:J, idx]
        s.run_state = world.q_running[:J, idx]
        s.slice_start = world.q_slice[:J, idx]
        s.chk_time = world.q_chk[:J, idx]
        pv = np.fromiter(
            (next(iter(p.values()), 0.0) for p in s.prios), np.float64, H
        )
        s.prio_j = np.where(s.live, pv[None, :], 0.0)
        s.usage = {rt: world.q_usage[rt][:J, idx] for rt in rtypes}
        # remaining_estimate — the same fused formula (and the same IEEE op
        # order) as the object snapshot; padding cells are exact zeros by
        # the world's compaction contract, so they evaluate to inf just as
        # the object path's zero-padded rows do
        with np.errstate(divide="ignore", invalid="ignore"):
            static = np.where(ef > 0.0, efc / ef, np.inf)
            dynamic = np.where(fd > 0.0, runtime / fd, 0.0)
            total = np.where(exact, dynamic, fd * dynamic + (1.0 - fd) * static)
            d = total - runtime
            rem = np.where(fd > 0.0, np.where(d > 0.0, d, 0.0), static)
        s.rem = np.maximum(rem, 1e-9)
        s.has_inf = bool(np.isinf(s.rem[s.live]).any()) if J else False

        s.queued = [world.queue_jobs[i] for i in idx_l]
        s.client_rtypes = [list(c.resources) for c in clients]
        s.nins = {rt: world.nins[rt][idx] for rt in rtypes}
        s.has = {rt: world.has[rt][idx] for rt in rtypes}
        s.all_has = {rt: bool(s.has[rt].all()) for rt in rtypes}
        s.ram = world.ram[idx]
        s.ram_frac = world.ram_frac[idx]
        s.horizon = world.b_hi[idx]
        s.ts = world.time_slice[idx]
        s.ncpu = world.sched_ncpu[idx]
        s.cu = s.usage.get(ResourceType.CPU, np.zeros((J, H)))
        gpu = np.zeros((J, H), dtype=bool)
        for rt in _GPU_LIKE:
            if rt in s.usage:
                gpu |= s.usage[rt] > 0.0
        s.gpu = gpu
        return s

    # ------------------------------------------------------------------
    # fused WRR simulation (§6.1, Fig. 5)
    # ------------------------------------------------------------------

    def _greedy(self, s, order_live, active, u_w, u_eps, u_zero, wss_w,
                row_counts=None):
        """One greedy maximal-set pass in WRR order: per-slot feasibility
        under per-resource caps + RAM (columns masked by ``active`` if
        given). Returns the chosen [J, H] mask and the leftover caps (for
        the idle computation). ``row_counts`` (live candidates per WRR
        rank, maintained by the event loop) short-circuits exhausted rows
        without touching the arrays."""
        J = s.J
        rtypes = s.rtypes
        cap = {rt: s.nins[rt].copy() for rt in rtypes}
        ram_left = s.ram.copy()
        running = np.zeros((J, s.H), dtype=bool)
        buf = np.empty(s.H, dtype=bool)
        feas = np.empty(s.H, dtype=bool)
        for k in range(J):
            if row_counts is not None and not row_counts[k]:
                continue
            if active is None:
                np.copyto(feas, order_live[k])
            else:
                np.logical_and(order_live[k], active, out=feas)
            if not feas.any():
                continue
            for rt in rtypes:
                np.greater_equal(cap[rt], u_eps[rt][k], out=buf)
                np.logical_or(buf, u_zero[rt][k], out=buf)
                np.logical_and(feas, buf, out=feas)
            np.logical_and(feas, wss_w[k] <= ram_left, out=feas)
            if feas.any():
                for rt in rtypes:
                    sel = feas if s.all_has[rt] else (feas & s.has[rt])
                    np.subtract(cap[rt], u_w[rt][k], out=cap[rt], where=sel)
                np.subtract(ram_left, wss_w[k], out=ram_left, where=feas)
                running[k] = feas  # copies the buffer's current values
        return running, cap

    def _wrr_raw(self, s: _Snapshot, now: float) -> _WRROut:
        H, J = s.H, s.J
        rtypes = s.rtypes

        if s.identity_perm:
            # queue order == WRR order on every host: no gathers needed
            # (rem is copied — the event loop decrements it in place)
            def wgather(a):
                return a
        else:
            def wgather(a):
                # WRR-rank-major gather: row k holds each host's rank-k job
                return np.take_along_axis(a, s.perm, axis=0) if J else a

        live_w = wgather(s.live)
        rem_w = s.rem.copy() if s.identity_perm else wgather(s.rem)
        dl_w = wgather(s.dl)
        wss_w = wgather(s.wss)
        u_w = {rt: wgather(s.usage[rt]) for rt in rtypes}
        # loop invariants, hoisted: u - 1e-12 thresholds and u <= 0 masks
        u_eps = {rt: u_w[rt] - 1e-12 for rt in rtypes}
        u_zero = {rt: u_w[rt] <= 0.0 for rt in rtypes}

        # queue_dur: remaining time per resource over all live queued jobs —
        # reduce(where=) accumulates row-sequentially, i.e. in WRR order,
        # bitwise-identical to the scalar summation
        qd = {}
        for rt in rtypes:
            sel = live_w & ~u_zero[rt] & s.has[rt][None, :]
            qd[rt] = (
                np.add.reduce(rem_w, axis=0, where=sel) if J else np.zeros(H)
            )

        busy = {rt: np.zeros(H) for rt in rtypes}
        t = np.zeros(H)
        not_done = live_w.copy()
        active = live_w.any(axis=0) if J else np.zeros(H, dtype=bool)
        # live candidates per WRR rank, decremented as jobs finish: lets the
        # greedy skip exhausted rows (most of a ragged batch's padding)
        row_counts = not_done.sum(axis=1)  # reprolint: ignore[parity-float] (bool count, integer-exact)
        miss_events: List[Tuple[np.ndarray, np.ndarray]] = []

        cap0 = None  # leftover caps of the *first* greedy (the idle set)
        # degenerate-host early exit: a host whose dt goes non-finite (an
        # infinite remaining estimate) reaches a fixed point — its running
        # set is static, rem stays inf/NaN, and after two more events t and
        # busy stop changing — so it can be frozen instead of spinning the
        # scalar oracle's 10k-event cap (outputs stay bit-identical)
        stall = np.zeros(H, dtype=np.int64)
        ev = 0
        while active.any() and ev < _MAX_EVENTS:
            ev += 1
            # greedy maximal set in WRR order under resource + RAM caps
            running, cap = self._greedy(
                s, not_done, active, u_w, u_eps, u_zero, wss_w,
                row_counts=row_counts,
            )
            if ev == 1:
                # the scalar idle computation re-runs the greedy over the
                # initial pending set — identical to this first event's pass
                cap0 = cap
            act = active & running.any(axis=0)
            active = act
            if not act.any():
                break
            # running slots as index pairs (row-major == WRR order per host):
            # the event tail works on these ~|running| entries instead of
            # full [J, H] matrices — completions are sparse
            rk, rh = np.nonzero(running)
            run_rem = rem_w[rk, rh]
            # dt = min remaining over the running set; Python min() folds
            # left-to-right, but min is order-independent without NaNs —
            # NaNs require an inf remaining estimate (see has_inf)
            if not s.has_inf:
                dt = np.minimum.reduce(
                    rem_w, axis=0, where=running, initial=np.inf
                )
                # lanes with no running job got the inf initial; zero them
                # (every accumulator update below is gated to active lanes)
                dt[~act] = 0.0
            else:
                dt = np.zeros(H)
                started = np.zeros(H, dtype=bool)
                for k in range(J):
                    mask = running[k]
                    if not mask.any():
                        continue
                    v = rem_w[k]
                    dt = np.where(
                        mask & ~started, v, np.where(mask & (v < dt), v, dt)
                    )
                    started |= mask
            dt = np.maximum(dt, 1e-9)  # NaN-exact: matches Python max(dt, 1e-9)
            # fluid busy accounting inside the horizon (old t, like scalar)
            h_minus_t = s.horizon - t
            if not s.has_inf:
                within = np.maximum(np.minimum(dt, h_minus_t), 0.0)
            else:  # Python min/max NaN semantics
                inner = np.where(dt < h_minus_t, dt, h_minus_t)
                within = np.where(inner > 0.0, inner, 0.0)
            for rt in rtypes:
                # bincount accumulates in input (row-major == WRR) order —
                # bitwise-identical to the scalar's sequential sum
                used = np.bincount(rh, weights=u_w[rt][rk, rh], minlength=H)
                m = np.minimum(used, s.nins[rt])  # min(used, ninstances)
                np.add(busy[rt], m * within, out=busy[rt], where=act)
            np.add(t, dt, out=t, where=act)
            # completions & deadline misses (with the updated t, like scalar)
            with np.errstate(invalid="ignore"):  # inf - inf on degenerate rem
                run_rem -= dt[rh]
            rem_w[rk, rh] = run_rem
            dsel = run_rem <= 1e-9
            if dsel.any():
                dk, dh = rk[dsel], rh[dsel]
                not_done[dk, dh] = False
                np.subtract.at(row_counts, dk, 1)
                msel = (now + t[dh]) > dl_w[dk, dh]
                if msel.any():
                    miss_events.append((dk[msel], dh[msel]))
            if s.has_inf:
                stall[act & ~np.isfinite(dt)] += 1
                active = active & (stall < 3)

        # assemble per-host miss lists: event order, then never-scheduled
        # (infeasible) jobs in WRR order, deduplicated like the scalar path
        misses: List[List[int]] = [[] for _ in range(H)]
        for ks, hs in miss_events:
            for k, h in zip(ks.tolist(), hs.tolist()):
                misses[h].append(s.queued[h][s.perm[k, h]].instance_id)
        if not_done.any():
            left_miss = not_done & ((now + t)[None, :] + rem_w > dl_w)
            for k, h in zip(*np.nonzero(left_miss)):
                iid = s.queued[h][s.perm[k, h]].instance_id
                if iid not in misses[h]:
                    misses[h].append(iid)

        # idle-now: leftover caps of the greedy over the initial queue; with
        # no active host the greedy never ran and everything is idle
        if cap0 is None:
            cap0 = {rt: s.nins[rt].copy() for rt in rtypes}

        shortfall = {}
        idle = {}
        saturated = {}
        for rt in rtypes:
            shortfall[rt] = np.maximum(s.horizon * s.nins[rt] - busy[rt], 0.0)
            idle[rt] = np.maximum(cap0[rt], 0.0)
            saturated[rt] = busy[rt] / np.maximum(s.nins[rt], 1.0)
        return _WRROut(misses, shortfall, idle, qd, saturated)

    def _wrap_results(self, s: _Snapshot, raw: _WRROut) -> List[WRRResult]:
        out: List[WRRResult] = []
        for h in range(s.H):
            rts = s.client_rtypes[h]
            out.append(
                WRRResult(
                    deadline_misses=raw.misses[h],
                    shortfall={rt: float(raw.shortfall[rt][h]) for rt in rts},
                    idle_instances={rt: float(raw.idle[rt][h]) for rt in rts},
                    queue_dur={rt: float(raw.queue_dur[rt][h]) for rt in rts},
                    saturated_until={rt: float(raw.saturated[rt][h]) for rt in rts},
                )
            )
        return out

    def _needs_from_raw(
        self, s: _Snapshot, raw: _WRROut
    ) -> List[Dict[ResourceType, ResourceRequest]]:
        """Buffer-watermark test (§6.2) per host off the raw arrays —
        mirrors ``Client._requests_from_sim`` exactly (same comparison,
        same resource iteration order, same floats)."""
        out: List[Dict[ResourceType, ResourceRequest]] = []
        short, idle, qd, sat = raw.shortfall, raw.idle, raw.queue_dur, raw.saturated
        for h, c in enumerate(s.clients):
            b_lo = c.prefs.b_lo
            d: Dict[ResourceType, ResourceRequest] = {}
            for rt in s.client_rtypes[h]:
                if sat[rt][h] < b_lo:
                    d[rt] = ResourceRequest(
                        req_runtime=float(short[rt][h]),
                        req_idle=float(idle[rt][h]),
                        queue_dur=float(qd[rt][h]),
                    )
            out.append(d)
        return out

    # ------------------------------------------------------------------
    # fused run-set selection (§6.1 ordering + greedy maximal feasible set)
    # ------------------------------------------------------------------

    def _run_set_pass(
        self, s: _Snapshot, miss_lists: Sequence[List[int]], now: float
    ) -> List[List[ClientJob]]:
        H, J = s.H, s.J
        if J == 0:
            return [[] for _ in range(H)]
        rtypes = s.rtypes

        # set deadline-miss flags through the same scalar helper, collecting
        # the values for the ordering-key arrays as we go
        miss_q = np.zeros((J, H), dtype=bool)
        for h, (c, q, ms) in enumerate(zip(s.clients, s.queued, miss_lists)):
            mset = set(ms)
            c._set_miss_flags(q, mset)
            if mset:
                for k, j in enumerate(q):
                    if j.deadline_miss:
                        miss_q[k, h] = True

        # §6.1 ordering key as one stable global lexsort (host-major)
        k1 = 2.0 - s.live  # 2: padding last, 1: live, 0: predicted miss
        k1[miss_q] = 0.0
        k2 = np.zeros((J, H))
        k2[miss_q] = s.dl[miss_q]
        in_slice = s.run_state & ((now - s.slice_start) < s.ts[None, :])
        # GPU-first and mid-slice are both {0,1} keys: 2·k3 + k4 preserves
        # the (k3, k4) lexicographic order in a single key
        k34 = 2.0 * s.gpu + (
            in_slice | (s.run_state & (s.chk_time <= s.slice_start))
        )
        np.subtract(3.0, k34, out=k34)
        k5 = -s.cu
        k6 = -s.prio_j
        # arrays are [J, H]: transpose before raveling so the sort is
        # host-major with the original queue order as the stable tiebreak
        hidx = np.repeat(np.arange(H), J)
        flat = np.lexsort((
            k6.T.ravel(), k5.T.ravel(), k34.T.ravel(),
            k2.T.ravel(), k1.T.ravel(), hidx,
        ))
        # sidx[r, h]: queue slot of host h's rank-r job
        sidx = (flat.reshape(H, J) - np.arange(H)[:, None] * J).astype(np.int64).T

        def sgather(a):
            return np.take_along_axis(a, sidx, axis=0)

        live_s = sgather(s.live)
        cu_s = sgather(s.cu)
        wss_s = sgather(s.wss)
        gpu_s = sgather(s.gpu)
        nci_s = sgather(s.nci)
        u_s = {rt: sgather(s.usage[rt]) for rt in rtypes if rt != ResourceType.CPU}

        # ram * ram_frac is computed here in NumPy on both backends: the
        # product must be materialized before it ever meets the greedy's
        # subtract chain (FMA staging contract, see core/jax_backend)
        ram0 = s.ram * s.ram_frac
        rhs1 = s.ncpu + 1e-12
        rhs2 = (s.ncpu + 1.0) + 1e-12
        cap = {rt: s.nins[rt].copy() for rt in u_s}
        cpu_cpu = np.zeros(H)
        cpu_all = np.zeros(H)
        ram_left = ram0
        chosen = np.zeros((J, H), dtype=bool)
        buf = np.empty(H, dtype=bool)
        for r in range(J):
            lv = live_s[r]
            if not lv.any():
                continue
            cu = cu_s[r]
            gpu_r = gpu_s[r]
            feas = lv.copy()
            for rt, u in u_s.items():
                # u > 0 gate: the scalar loop only visits usage keys the
                # job actually carries, and real usage dicts hold
                # positive entries
                np.less(cap[rt], u[r] - 1e-12, out=buf)
                np.logical_and(buf, u[r] > 0.0, out=buf)
                np.logical_and(feas, ~buf, out=feas)
            np.logical_and(feas, ~(~gpu_r & ((cpu_cpu + cu) > rhs1)), out=feas)
            np.logical_and(feas, (cpu_all + cu) <= rhs2, out=feas)
            np.logical_and(feas, wss_s[r] <= ram_left, out=feas)
            np.logical_or(feas, nci_s[r] & lv, out=feas)  # §3.5: always run
            if not feas.any():
                continue
            chosen[r] = feas
            for rt, u in u_s.items():
                sel = feas if s.all_has[rt] else (feas & s.has[rt])
                np.subtract(cap[rt], u[r], out=cap[rt], where=sel)
            np.add(cpu_cpu, cu, out=cpu_cpu, where=feas & ~gpu_r)
            np.add(cpu_all, cu, out=cpu_all, where=feas)
            np.subtract(ram_left, wss_s[r], out=ram_left, where=feas)

        out: List[List[ClientJob]] = [[] for _ in range(H)]
        for r, h in zip(*np.nonzero(chosen)):
            out[h].append(s.queued[h][sidx[r, h]])
        return out

    def _apply_run_sets(
        self, s: _Snapshot, miss_lists: Sequence[List[int]], now: float
    ) -> List[List[ClientJob]]:
        run_sets = self._run_set_pass(s, miss_lists, now)
        out: List[List[ClientJob]] = []
        for c, q, chosen in zip(s.clients, s.queued, run_sets):
            if not q:
                c.running = []
                out.append([])
                continue
            out.append(c._apply_run_set(chosen, now))
        return out

    # ------------------------------------------------------------------
    # public entry points
    # ------------------------------------------------------------------

    def wrr_batch(self, clients: Sequence[Client], now: float) -> List[WRRResult]:
        """Batched ``wrr_simulate`` over each client's live queue."""
        s = self._snapshot(clients, now)
        return self._wrap_results(s, self._wrr_raw(s, now))

    def schedule_batch(
        self, clients: Sequence[Client], now: float
    ) -> List[List[ClientJob]]:
        """Batched ``Client.schedule``: applies the same state mutations
        (miss flags, run/preempt transitions) and returns each run set."""
        s = self._snapshot(clients, now, accrue_empty=False)
        raw = self._wrr_raw(s, now)
        return self._apply_run_sets(s, raw.misses, now)

    def needs_work_batch(
        self, clients: Sequence[Client], now: float
    ) -> List[Dict[ResourceType, ResourceRequest]]:
        """Batched ``Client.needs_work``: one fused WRR pass, then each
        host's buffer-watermark test over its own result."""
        s = self._snapshot(clients, now)
        return self._needs_from_raw(s, self._wrr_raw(s, now))

    def choose_fetch_batch(
        self, clients: Sequence[Client], now: float
    ) -> List[Optional[WorkRequest]]:
        """Batched ``Client.choose_fetch_project``."""
        needs = self.needs_work_batch(clients, now)
        return [
            c.choose_fetch_project(now, needs=n) for c, n in zip(clients, needs)
        ]

    def tick_batch(
        self, clients: Sequence[Client], now: float
    ) -> Tuple[List[List[ClientJob]], List[Dict[ResourceType, ResourceRequest]]]:
        """One full client tick (reschedule + work-fetch test) for the whole
        population off a single snapshot and WRR pass. The WRR inputs are
        unchanged by run-set transitions, so sharing the pass is exact."""
        s = self._snapshot(clients, now)
        raw = self._wrr_raw(s, now)
        run_sets = self._apply_run_sets(s, raw.misses, now)
        return run_sets, self._needs_from_raw(s, raw)

    # ------------------------------------------------------------------
    # world-backed entry points (persistent columns; see _snapshot_world)
    # ------------------------------------------------------------------

    def needs_work_world(
        self, world: "HostArrays", host_ids: Sequence[int], now: float
    ) -> List[Dict[ResourceType, ResourceRequest]]:
        """Batched ``Client.needs_work`` straight off the world columns."""
        s = self._snapshot_world(world, host_ids, now)
        return self._needs_from_raw(s, self._wrr_raw(s, now))

    def schedule_world(
        self, world: "HostArrays", host_ids: Sequence[int], now: float
    ) -> List[List[ClientJob]]:
        """Batched ``Client.schedule`` off the world columns; the run-set
        mutations are applied to the ``ClientJob`` objects and the world's
        run-state columns are re-synced."""
        s = self._snapshot_world(world, host_ids, now, accrue_empty=False)
        raw = self._wrr_raw(s, now)
        out = self._apply_run_sets(s, raw.misses, now)
        for h in host_ids:
            world.sync_run_state(h)
        return out
