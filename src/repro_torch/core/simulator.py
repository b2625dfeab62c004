"""EmBOINC-style virtual-time emulator (§9).

"researchers began using emulation — simulators using the actual BOINC code
to model client and server behavior ... EmBOINC combines a simulator of a
large population of volunteer hosts (driven either by trace data or by a
random model) with an emulator of a project server — that is, the actual
server software ... using virtual time instead of real time."

This module does exactly that: a deterministic event-driven simulator whose
host population drives the *actual* ``ProjectServer`` / ``Client`` /
``Scheduler`` / ``Transitioner`` code in virtual time. All paper-claim
benchmarks and the integration tests run on it.

Two event loops share one world. Per-host state (availability,
generation counters, running-instance accrual, the mirrored client queues)
lives in the persistent columnar :class:`~repro_torch.core.world.HostArrays`
(``core/world.py``), maintained incrementally at mutation time. The
**scalar oracle** (``vector_world=False``) pops one event at a time and
performs per-host operations against those columns — the parity reference.
The **vectorized loop** (``vector_world=True``) drains maximal runs of
same-timestamp, same-kind events (exactly the grouping the oracle's
coalescing produces, so cross-mode event order is identical), advances
accrual for every affected host in one fused array pass, detects
completions as a single mask over the accrual matrix, samples availability
toggles from FIFO-prefetched exponential draw batches, routes every
scheduler RPC through the persistent vectorized dispatch snapshot, and
feeds the batch client engine straight from the world columns. Whole-run
results — SimMetrics, job states, granted credit — are bit-identical
between the two loops (``tests/test_world.py``).

``epoch`` quantizes event times up to a fixed grid (0 disables). Both
loops share the quantization, so parity holds at any epoch; with it, event
coalescing — and therefore the vectorized loop's advantage — grows with
the population (``benchmarks/bench_world.py``).
"""
from __future__ import annotations

import heapq
import math
import random
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from .batch_client import BatchClientEngine
from .client import (
    Client,
    ClientJob,
    ClientPrefs,
    ClientResource,
    ProjectAttachment,
    RunState,
)
from .credit import peak_flop_count
from .scheduler import CompletedResult, ResourceRequest, ScheduleRequest
from .server import ProjectServer
from .types import (
    Host,
    InstanceOutcome,
    Platform,
    ProcessingResource,
    ResourceType,
    ValidateState,
)
from .world import HostArrays

# ---------------------------------------------------------------------------
# Host population model (EmBOINC's "random model")
# ---------------------------------------------------------------------------


@dataclass
class HostSpec:
    """Behavioural model of one volunteer host."""

    host: Host
    efficiency: float = 0.5  # actual/peak FLOPS (§7: varies ~2x between hosts)
    runtime_noise: float = 0.1  # lognormal sigma on job runtimes
    error_prob: float = 0.0  # hardware flakiness: wrong output
    crash_prob: float = 0.0  # app crash: CLIENT_ERROR
    malicious: bool = False  # intentionally wrong results (§3.4)
    cheat_prob: float = 1.0  # if malicious, P(fake result)
    avail_on_mean: float = 8 * 3600.0  # §1.1: availability ~60%/40%
    avail_off_mean: float = 4 * 3600.0
    churn_time: Optional[float] = None  # permanent departure (device churn)
    rpc_poll: float = 600.0
    # -- scenario-layer extensions (core/scenarios.py) --
    # Colluding clique id: malicious hosts sharing a group fabricate the
    # *identical* wrong payload per job, so they validate each other
    # (quorum defeat, §3.4's attack model). None => independent corruption.
    collusion_group: Optional[int] = None
    # Credit farming: reported peak_flop_count is inflated by this factor
    # (the §7 normalization/outlier-robust grant is the defense under test).
    claim_factor: float = 1.0
    # Trace-replayed availability: absolute toggle times (host starts
    # online; each time flips the state). When set, availability is driven
    # entirely by this schedule — no RNG draws — so trace-driven runs keep
    # scalar/vector RNG-stream parity trivially. Exhausted schedules leave
    # the host in its final state.
    avail_schedule: Optional[Tuple[float, ...]] = None


def make_population(
    n_hosts: int,
    seed: int = 0,
    cpu_flops: float = 16.5e9,  # paper §1.1: average 16.5 CPU GigaFLOPS
    gpu_fraction: float = 0.0,
    gpu_flops: float = 1e12,
    ncpus: int = 4,
    error_prob: float = 0.0,
    malicious_fraction: float = 0.0,
    availability: float = 1.0,
    churn_rate: float = 0.0,  # departures per host per simulated second
    horizon: float = 0.0,
    speed_spread: float = 0.5,
) -> List[HostSpec]:
    """Random host population: heterogeneous speeds (lognormal), OSes per the
    paper's 85/7/7 Windows/Mac/Linux split, optional GPUs, availability and
    churn processes, and a malicious subset."""
    rng = random.Random(seed)
    out: List[HostSpec] = []
    for i in range(n_hosts):
        r = rng.random()
        os_name = "windows" if r < 0.85 else ("mac" if r < 0.92 else "linux")
        speed = cpu_flops * math.exp(rng.gauss(0.0, speed_spread))
        resources = {
            ResourceType.CPU: ProcessingResource(
                rtype=ResourceType.CPU,
                ninstances=ncpus,
                peak_flops=speed,
                availability=availability,
            )
        }
        platforms = [Platform(os_name, "x86_64")]
        if rng.random() < gpu_fraction:
            resources[ResourceType.GPU] = ProcessingResource(
                rtype=ResourceType.GPU,
                ninstances=1,
                peak_flops=gpu_flops * math.exp(rng.gauss(0.0, speed_spread)),
                availability=availability,
            )
        host = Host(
            id=i + 1,
            platforms=tuple(platforms),
            resources=resources,
            cpu_vendor=rng.choice(["genuineintel", "authenticamd"]),
            cpu_model=f"model{rng.randrange(4)}",
            os_version=f"{os_name}-10.{rng.randrange(3)}",
            on_fraction=availability,
            volunteer_id=i + 1,
        )
        churn_time = None
        if churn_rate > 0.0 and horizon > 0.0:
            t = rng.expovariate(churn_rate)
            if t < horizon:
                churn_time = t
        if availability >= 1.0:
            on_mean, off_mean = 1e18, 1.0
        else:
            on_mean = 8 * 3600.0
            off_mean = on_mean * (1.0 - availability) / max(availability, 1e-6)
        out.append(
            HostSpec(
                host=host,
                efficiency=rng.uniform(0.35, 0.7),
                runtime_noise=0.08,
                error_prob=error_prob,
                crash_prob=0.0,
                malicious=(rng.random() < malicious_fraction),
                avail_on_mean=on_mean,
                avail_off_mean=off_mean,
                churn_time=churn_time,
                rpc_poll=600.0,
            )
        )
    return out


# ---------------------------------------------------------------------------
# The simulation
# ---------------------------------------------------------------------------

_RPC = "rpc"
_COMPLETE = "complete"
_AVAIL = "avail"
_CHURN = "churn"
_SERVER = "server"
_CALLBACK = "callback"


class _RunningJob:
    """A started instance, viewed through the world's accrual columns.

    ``accrued`` and ``actual_total`` live in ``HostArrays`` (slot-major
    accrual matrix); this object is the per-instance handle scalar code and
    tests address them through.
    """

    __slots__ = ("world", "host_id", "client_job", "started_at")

    def __init__(
        self,
        world: HostArrays,
        host_id: int,
        client_job: ClientJob,
        started_at: float = 0.0,
    ) -> None:
        self.world = world
        self.host_id = host_id
        self.client_job = client_job
        self.started_at = started_at

    @property
    def accrued(self) -> float:
        return self.world.get_accrued(self.host_id, self.client_job.instance_id)

    @accrued.setter
    def accrued(self, value: float) -> None:
        self.world.set_accrued(self.host_id, self.client_job.instance_id, value)

    @property
    def actual_total(self) -> float:
        return self.world.get_total(self.host_id, self.client_job.instance_id)


@dataclass
class SimMetrics:
    completed_instances: int = 0
    correct_accepted: int = 0
    wrong_accepted: int = 0  # accepted-as-canonical but wrong (error rate)
    instances_executed: int = 0
    rpcs: int = 0
    rpcs_with_work: int = 0
    rpcs_requesting_work: int = 0
    busy_cpu_seconds: float = 0.0
    capacity_cpu_seconds: float = 0.0
    flops_done: float = 0.0

    @property
    def replication_overhead(self) -> float:
        if self.completed_instances == 0:
            return 0.0
        jobs = max(1, self.correct_accepted + self.wrong_accepted)
        return self.instances_executed / jobs

    @property
    def error_rate(self) -> float:
        tot = self.correct_accepted + self.wrong_accepted
        return self.wrong_accepted / tot if tot else 0.0

    @property
    def idle_fraction(self) -> float:
        if self.capacity_cpu_seconds <= 0:
            return 0.0
        return 1.0 - self.busy_cpu_seconds / self.capacity_cpu_seconds


class GridSimulation:
    """Drives real server+client code with a synthetic population (§9)."""

    def __init__(
        self,
        server: ProjectServer,
        population: List[HostSpec],
        seed: int = 0,
        server_tick_period: float = 60.0,
        ground_truth: Optional[Callable[[int], Any]] = None,
        executor: Optional[Callable[[Any, Host], Any]] = None,
        corruptor: Optional[Callable[[Any, random.Random], Any]] = None,
        coalesce_rpcs: bool = True,
        batch_clients: bool = True,
        vector_world: bool = True,
        epoch: float = 0.0,
        backend: str = "numpy",
    ) -> None:
        self.server = server
        self.specs: Dict[int, HostSpec] = {s.host.id: s for s in population}
        self.rng = random.Random(seed)
        self.server_tick_period = server_tick_period
        # same-tick scheduler RPCs are coalesced into one vectorized
        # batch-dispatch pass (server.rpc_batch). Dispatch decisions are
        # identical to sequential RPCs; the simulation's own stochastic
        # draws (result corruption, runtime noise) can interleave
        # differently when a coalesced batch carries completion reports,
        # because all requests are built before any reply is applied.
        self.coalesce_rpcs = coalesce_rpcs
        # client half of the same architecture (§6.1–6.2): work-fetch
        # decisions and run-set reschedules for hosts sharing a tick go
        # through the vectorized host-population engine. Bit-exact with the
        # scalar per-host path (tests/test_batch_client.py).
        self.batch_clients = batch_clients
        # epoch-batched vectorized event loop over the columnar world state
        # (see module docstring); False selects the scalar per-event oracle.
        # The vectorized loop implies RPC coalescing and the batch client
        # engine, and turns on the server's persistent-snapshot dispatch.
        self.vector_world = vector_world
        # event-time quantization grid (0 = continuous): every scheduled
        # event lands on the next multiple of ``epoch``. Applied in both
        # loops, so scalar-vs-vector parity holds at any epoch.
        self.epoch = epoch
        # execution backend for the client/world batch engines ("numpy" |
        # "jax"); engine outputs are bit-identical either way (4th parity
        # axis in core/scenarios.run_parity). The server-side engines get
        # their backend via ProjectServer(engine_backend=...).
        self.backend = backend
        self.client_engine = BatchClientEngine(backend=backend)
        self.world = HostArrays(backend=backend)
        self.ground_truth = ground_truth or (lambda job_id: float(job_id) * 1.5)
        # real-compute hook (grid runtime): executor(job, host) -> output
        self.executor = executor
        self.corruptor = corruptor
        self.now = 0.0
        self.metrics = SimMetrics()
        self._heap: List[Tuple[float, int, str, int]] = []
        self._seq = 0
        self._event_gen: Dict[int, int] = {}
        self.clients: Dict[int, Client] = {}
        self.running: Dict[int, Dict[int, _RunningJob]] = {}
        # iid -> (version_id, actual_total) for *resident* (dispatched, not
        # yet completed) instances; entries are dropped at completion and
        # at churn so the map stays O(in-flight work)
        self._instance_meta: Dict[int, Tuple[int, float]] = {}
        # lifetime sum of drawn actual runtimes (clamped-accrual invariant:
        # busy_cpu_seconds can never exceed this)
        self._dispatched_actual_total = 0.0
        self._wrong_outputs: Dict[int, bool] = {}  # iid -> output was wrong
        self._completed_ok = 0  # instances that ran to completion (SUCCESS reports)
        self._callbacks: Dict[int, Callable[[float], None]] = {}
        self._capacity_accounted = 0.0
        # remaining trace-schedule toggle times per host (consumed FIFO)
        self._avail_sched: Dict[int, "deque[float]"] = {}
        if vector_world:
            server.set_vector_dispatch(True)

        for spec in population:
            self._register_host(spec, 0.0)
        self._push(0.0, _SERVER, 0)

    def _register_host(self, spec: HostSpec, now: float) -> None:
        host = spec.host
        self.specs[host.id] = spec
        self.server.add_host(host)
        resources = {
            rt: ClientResource(rt, r.ninstances, r.peak_flops, r.availability)
            for rt, r in host.resources.items()
        }
        client = Client(
            host_id=host.id,
            resources=resources,
            prefs=ClientPrefs(buffer_lo_days=0.05, buffer_hi_days=0.2),
            ram_bytes=host.ram_bytes,
        )
        rtypes = tuple(host.resources.keys())
        client.attach(ProjectAttachment(name=self.server.name, resource_types=rtypes))
        self.clients[host.id] = client
        self.running[host.id] = {}
        cpu = host.resources.get(ResourceType.CPU)
        defense = self.server.defense
        self.world.add_host(
            host.id,
            client,
            cpu.ninstances if cpu else 0.0,
            hr_id=defense.hr_id_of(host) if defense is not None else -1,
        )
        self._push(now + self.rng.uniform(0.0, spec.rpc_poll), _RPC, host.id)
        if spec.avail_schedule is not None:
            # trace replay: availability toggles come from the schedule,
            # never from the RNG stream (scalar/vector draw parity)
            sched = deque(t for t in spec.avail_schedule if t > now)
            self._avail_sched[host.id] = sched
            if sched:
                self._push(sched.popleft(), _AVAIL, host.id)
        elif spec.avail_off_mean > 0 and spec.avail_on_mean < 1e17:
            self._push(now + self.rng.expovariate(1.0 / spec.avail_on_mean), _AVAIL, host.id)
        if spec.churn_time is not None:
            self._push(spec.churn_time, _CHURN, host.id)

    def add_host_spec(self, spec: HostSpec, now: float) -> None:
        """Register a volunteer mid-run (device arrival — or a Sybil
        churn-and-rejoin identity presenting a fresh host id, §3.4). The
        host id must be unused: churned slots are never recycled, which is
        exactly what makes Sybil identity-shedding observable."""
        if spec.host.id in self.world.index:
            raise ValueError(f"host id {spec.host.id} was already registered")
        self._register_host(spec, now)

    # -- event plumbing --

    def _quantize(self, t: float) -> float:
        e = self.epoch
        if e > 0.0:
            return math.ceil(t / e) * e
        return t

    def _push(self, t: float, kind: str, host_id: int, gen: int = -1) -> None:
        self._seq += 1
        heapq.heappush(self._heap, (self._quantize(t), self._seq, kind, host_id))
        if kind == _COMPLETE:
            self._event_gen[self._seq] = gen

    def schedule_callback(self, t: float, fn: Callable[[float], None]) -> None:
        """Run ``fn(now)`` at virtual time ``t`` (streamed job submission,
        daemon outages, elasticity experiments...)."""
        self._seq += 1
        heapq.heappush(self._heap, (self._quantize(t), self._seq, _CALLBACK, 0))
        self._callbacks[self._seq] = fn

    # -- main loop --

    def run(self, horizon: float) -> SimMetrics:
        if self.vector_world:
            self._run_vector(horizon)
        else:
            self._run_scalar(horizon)
        self.now = horizon
        # capacity accounting (incremental: run() may be called in windows)
        dt_cap = horizon - self._capacity_accounted
        if dt_cap > 0:
            self.world.add_capacity(dt_cap)
            self._capacity_accounted = horizon
        # metric accumulators live in per-host world columns; the totals are
        # reduced in fixed host order so both loops produce the same floats
        self.metrics.capacity_cpu_seconds = self.world.capacity_total()
        self.metrics.busy_cpu_seconds = self.world.busy_total()
        self.metrics.flops_done = self.world.flops_total()
        self.server.tick(horizon)
        return self.metrics

    def _run_scalar(self, horizon: float) -> None:
        """The per-event oracle loop (the parity reference)."""
        while self._heap and self._heap[0][0] <= horizon:
            t, seq, kind, host_id = heapq.heappop(self._heap)
            if host_id:
                self._advance_running(host_id, t)
            self.now = t
            if kind == _SERVER:
                self.server.tick(t)
                self._push(t + self.server_tick_period, _SERVER, 0)
            elif kind == _RPC:
                batch = [host_id]
                if self.coalesce_rpcs:
                    # coalesce same-tick scheduler RPCs into one batch pass
                    while (
                        self._heap
                        and self._heap[0][0] == t
                        and self._heap[0][2] == _RPC
                    ):
                        _, _, _, hid2 = heapq.heappop(self._heap)
                        self._advance_running(hid2, t)
                        batch.append(hid2)
                if len(batch) == 1:
                    self._handle_rpc(host_id, t)
                else:
                    self._handle_rpc_batch(batch, t)
            elif kind == _COMPLETE:
                valid = self._event_gen.pop(seq, -1) == self.world.gen_of(host_id)
                hids = [host_id] if valid else []
                if self.batch_clients:
                    # coalesce same-tick completions into one batched
                    # reschedule pass over the affected hosts
                    while (
                        self._heap
                        and self._heap[0][0] == t
                        and self._heap[0][2] == _COMPLETE
                    ):
                        _, seq2, _, hid2 = heapq.heappop(self._heap)
                        self._advance_running(hid2, t)
                        if self._event_gen.pop(seq2, -1) == self.world.gen_of(hid2):
                            hids.append(hid2)
                    hids = list(dict.fromkeys(hids))
                if len(hids) == 1:
                    self._handle_completions(hids[0], t)
                elif hids:
                    self._handle_completions_batch(hids, t)
            elif kind == _AVAIL:
                self._toggle_availability(host_id, t)
            elif kind == _CHURN:
                self._churn(host_id, t)
            elif kind == _CALLBACK:
                fn = self._callbacks.pop(seq, None)
                if fn is not None:
                    fn(t)

    def _run_vector(self, horizon: float) -> None:
        """The epoch-batched vectorized loop. Drains maximal runs of
        same-timestamp, same-kind events (the identical grouping the oracle
        loop's coalescing produces), advances every affected host in one
        fused world pass, then handles the run through the batch engines.
        All RNG consumers execute in the oracle's per-event order, so
        whole-run results are bit-identical to :meth:`_run_scalar`."""
        heap = self._heap
        world = self.world
        while heap and heap[0][0] <= horizon:
            t, seq, kind, host_id = heapq.heappop(heap)
            if kind == _SERVER:
                self.now = t
                self.server.tick(t)
                self._push(t + self.server_tick_period, _SERVER, 0)
                continue
            if kind == _CALLBACK:
                self.now = t
                fn = self._callbacks.pop(seq, None)
                if fn is not None:
                    fn(t)
                continue
            run = [(seq, host_id)]
            while heap and heap[0][0] == t and heap[0][2] == kind:
                _, s2, _, h2 = heapq.heappop(heap)
                run.append((s2, h2))
            # one fused accrual pass for every host sharing the event time
            # (duplicates deduped: the oracle's repeat advances are no-ops)
            world.advance_batch(list(dict.fromkeys(h for _, h in run)), t)
            self.now = t
            if kind == _RPC:
                self._handle_rpc_batch([h for _, h in run], t)
            elif kind == _COMPLETE:
                hids = [
                    h
                    for s, h in run
                    if self._event_gen.pop(s, -1) == world.gen_of(h)
                ]
                hids = list(dict.fromkeys(hids))
                if hids:
                    self._handle_completions_batch(hids, t)
            elif kind == _AVAIL:
                self._avail_run(run, t)
            elif kind == _CHURN:
                for _, h in run:
                    self._churn(h, t)

    # -- host availability & churn --

    def _toggle_scheduled(self, host_id: int, t: float) -> None:
        """Trace-schedule toggle: flip the state, push the next scheduled
        time (if any), and touch no RNG stream."""
        world = self.world
        on = world.is_available(host_id)
        world.set_available(host_id, not on)
        world.bump_gen(host_id)  # invalidate completion events
        if not on:
            self._reschedule_completions(host_id, t)
        sched = self._avail_sched.get(host_id)
        if sched:
            self._push(sched.popleft(), _AVAIL, host_id)

    def _toggle_availability(self, host_id: int, t: float) -> None:
        spec = self.specs.get(host_id)
        if spec is None:
            return
        if spec.avail_schedule is not None:
            self._toggle_scheduled(host_id, t)
            return
        world = self.world
        on = world.is_available(host_id)
        world.set_available(host_id, not on)
        world.bump_gen(host_id)  # invalidate completion events
        if on:
            nxt = self.rng.expovariate(1.0 / spec.avail_off_mean)
        else:
            nxt = self.rng.expovariate(1.0 / spec.avail_on_mean)
            self._reschedule_completions(host_id, t)
        self._push(t + nxt, _AVAIL, host_id)

    def _avail_run(self, run: List[Tuple[int, int]], t: float) -> None:
        """A same-timestamp run of availability toggles: the exponential
        next-toggle draws are prefetched as one uniform batch and consumed
        FIFO, reproducing the oracle's ``rng.expovariate`` stream exactly;
        the toggles themselves apply sequentially in event order.
        Trace-scheduled hosts consume no draws (in either loop), so they
        are excluded from the prefetch count."""
        specs = self.specs
        world = self.world
        world.draws.prefetch(
            self.rng,
            sum(
                1
                for _, h in run
                if (s := specs.get(h)) is not None and s.avail_schedule is None
            ),
        )
        for _, host_id in run:
            spec = specs.get(host_id)
            if spec is None:
                continue
            if spec.avail_schedule is not None:
                self._toggle_scheduled(host_id, t)
                continue
            on = world.is_available(host_id)
            world.set_available(host_id, not on)
            world.bump_gen(host_id)
            if on:
                nxt = world.draws.draw(self.rng, 1.0 / spec.avail_off_mean)
            else:
                nxt = world.draws.draw(self.rng, 1.0 / spec.avail_on_mean)
                self._reschedule_completions(host_id, t)
            self._push(t + nxt, _AVAIL, host_id)

    def _churn(self, host_id: int, t: float) -> None:
        """Permanent departure: in-progress instances will hit their
        deadlines and be retried on other hosts (§4). Every per-host trace
        — specs, client, running set, world columns, undelivered instance
        metadata — is purged, so long-churn runs don't leak state."""
        self.specs.pop(host_id, None)
        self.clients.pop(host_id, None)
        self.running.pop(host_id, None)
        self._avail_sched.pop(host_id, None)
        i = self.world.index.get(host_id)
        if i is not None:
            for j in self.world.queue_jobs[i]:
                self._instance_meta.pop(j.instance_id, None)
        self.world.remove_host(host_id)
        self.server.remove_host(host_id, t)

    # -- execution model --

    def _advance_running(self, host_id: int, t: float) -> None:
        if host_id == 0:
            return
        # clamped columnar accrual (world.advance_host performs the same
        # per-cell IEEE ops as the fused vector pass)
        self.world.advance_host(host_id, t)

    def _reschedule_completions(self, host_id: int, t: float) -> None:
        """(Re)issue completion events for the host's running set."""
        world = self.world
        gen = world.bump_gen(host_id)
        i = world.index[host_id]
        q_total = world.q_total
        q_runtime = world.q_runtime
        for row in world.running_rows(host_id):
            remaining = max(0.0, float(q_total[row, i] - q_runtime[row, i]))
            self._push(t + remaining, _COMPLETE, host_id, gen)

    def _mark_completions(
        self, host_id: int, t: float, rows=None
    ) -> Optional[bool]:
        """Flip finished running jobs to DONE; returns None if the host is
        gone/unavailable, else whether anything completed. ``rows`` may
        carry precomputed completion rows (the vectorized loop's fused
        detection mask)."""
        spec = self.specs.get(host_id)
        client = self.clients.get(host_id)
        world = self.world
        if spec is None or client is None or not world.is_available(host_id):
            return None
        if rows is None:
            rows = world.completed_rows(host_id)
        if len(rows) == 0:
            return False
        i = world.index[host_id]
        running = self.running[host_id]
        done_ids = set()
        for row in rows:
            cj = world.queue_jobs[i][row]
            running.pop(cj.instance_id, None)
            cj.state = RunState.DONE
            cj.fraction_done = 1.0
            # authoritative accrual lives in the world column; sync the
            # object before it is reported (CompletedResult.runtime)
            cj.runtime = float(world.q_runtime[row, i])
            client.completed.append(cj)
            self.metrics.instances_executed += 1
            world.flops[i] += world.q_efc[row, i]
            self._instance_meta.pop(cj.instance_id, None)
            done_ids.add(cj.instance_id)
        client.jobs = [j for j in client.jobs if j.instance_id not in done_ids]
        client.running = [j for j in client.running if j.instance_id not in done_ids]
        world.remove_rows(host_id, rows)
        return True

    def _handle_completions(self, host_id: int, t: float) -> None:
        marked = self._mark_completions(host_id, t)
        if marked is None:
            return
        if marked:
            self._start_jobs(host_id, t)
        client = self.clients[host_id]
        # report opportunistically (deferred batching handled in _handle_rpc)
        if client.completed and client.should_report(self.server.name, t):
            self._do_rpc(host_id, t, force_report=True)

    def _handle_completions_batch(self, host_ids: List[int], t: float) -> None:
        """Coalesced same-tick completions: mark every host's finished jobs,
        run one batched reschedule for the affected hosts, then do the
        per-host opportunistic report RPCs in the original event order (the
        same server-visible order as sequential handling — client state is
        host-local, so deferring the reschedules cannot change outcomes).
        The vectorized loop detects completions as one fused mask over the
        accrual matrix and precomputes the reporters' work-fetch decisions
        in one engine pass; the report RPCs themselves stay sequential so
        every RNG draw happens in oracle order."""
        live: List[int] = []
        to_start: List[int] = []
        vw = self.vector_world
        detected = self.world.completed_rows_batch(host_ids) if vw else {}
        for hid in host_ids:
            marked = self._mark_completions(hid, t, rows=detected.get(hid))
            if marked is None:
                continue
            live.append(hid)
            if marked:
                to_start.append(hid)
        self._start_jobs_batch(to_start, t)
        name = self.server.name
        reporters = [
            hid
            for hid in live
            if (c := self.clients.get(hid)) is not None
            and c.completed
            and c.should_report(name, t)
        ]
        if not reporters:
            return
        needs_map: Dict[int, Dict[ResourceType, ResourceRequest]] = {}
        if vw:
            if len(reporters) > 1:
                needs_map = dict(zip(
                    reporters,
                    self.client_engine.needs_work_world(self.world, reporters, t),
                ))
            else:
                # a one-host engine pass costs more than the scalar oracle
                # call; sync the accrual columns onto the objects and let
                # _build_request take the (bit-identical) scalar path
                self.world.sync_objects(reporters)
        # one coalesced dispatch pass for the whole run's report RPCs (the
        # request builds and reply applications stay sequential per host,
        # so every RNG draw happens in the same order in both loops)
        pending: List[Tuple[int, ScheduleRequest]] = []
        for hid in reporters:
            request = self._build_request(
                hid, t, force_report=True, needs=needs_map.get(hid)
            )
            if request is not None:
                pending.append((hid, request))
        replies = self.server.rpc_batch([r for _, r in pending], t)
        to_start = [
            hid
            for (hid, request), reply in zip(pending, replies)
            if self._apply_reply(hid, request, reply, t, start=False)
        ]
        self._start_jobs_batch(to_start, t)

    def _start_jobs(self, host_id: int, t: float) -> None:
        self._start_jobs_batch([host_id], t)

    def _start_jobs_batch(self, host_ids: List[int], t: float) -> None:
        if not host_ids:
            return
        if self.vector_world:
            if len(host_ids) == 1:
                # one-host reschedule: the scalar oracle call is cheaper
                # than an engine pass and bit-identical to it
                hid = host_ids[0]
                self.world.sync_objects(host_ids)
                chosen_lists = [self.clients[hid].schedule(t)]
                self.world.sync_run_state(hid)
            else:
                # fused run-set selection straight off the world columns
                chosen_lists = self.client_engine.schedule_world(
                    self.world, host_ids, t
                )
        else:
            clients = [self.clients[h] for h in host_ids]
            if self.batch_clients and len(clients) > 1:
                chosen_lists = self.client_engine.schedule_batch(clients, t)
            else:
                chosen_lists = [c.schedule(t) for c in clients]
            for host_id in host_ids:
                self.world.sync_run_state(host_id)
        for host_id, chosen in zip(host_ids, chosen_lists):
            running = self.running[host_id]
            for cj in chosen:
                if cj.instance_id not in running:
                    running[cj.instance_id] = _RunningJob(
                        world=self.world,
                        host_id=host_id,
                        client_job=cj,
                        started_at=t,
                    )
            self._reschedule_completions(host_id, t)

    # -- RPC path --

    def _handle_rpc(self, host_id: int, t: float) -> None:
        spec = self.specs.get(host_id)
        if spec is None:
            return
        # push the next poll *before* handling (the batch path's order), so
        # event sequence numbers — and therefore same-timestamp tie-breaks —
        # are identical whether a poll was handled alone or in a batch
        self._push(t + spec.rpc_poll, _RPC, host_id)
        if self.world.is_available(host_id):
            self._do_rpc(host_id, t)

    def _do_rpc(
        self,
        host_id: int,
        t: float,
        force_report: bool = False,
        needs: Optional[Dict[ResourceType, ResourceRequest]] = None,
    ) -> None:
        request = self._build_request(host_id, t, force_report, needs=needs)
        if request is None:
            return
        reply = self.server.rpc(request, t)
        self._apply_reply(host_id, request, reply, t)

    def _handle_rpc_batch(self, host_ids: List[int], t: float) -> None:
        """Coalesced form of ``_handle_rpc``: build every host's request
        (work-fetch decisions precomputed in one fused WRR pass over the
        whole batch), dispatch them in one ``rpc_batch`` call, apply replies
        in the same order the sequential loop would have, then run one
        batched reschedule for every host that received jobs. The
        vectorized world reads the WRR inputs from the persistent columns;
        the object-snapshot engine and per-host scalar fallbacks remain for
        the oracle loop."""
        world = self.world
        needs_map: Dict[int, Dict[ResourceType, "ResourceRequest"]] = {}
        if self.vector_world:
            avail = [
                hid
                for hid in host_ids
                if hid in self.specs and world.is_available(hid)
            ]
            if len(avail) > 1:
                needs_map = dict(zip(
                    avail,
                    self.client_engine.needs_work_world(world, avail, t),
                ))
            elif avail:
                world.sync_objects(avail)  # scalar needs path, bit-identical
        elif self.batch_clients:
            avail = [
                hid
                for hid in host_ids
                if hid in self.specs and world.is_available(hid)
            ]
            if len(avail) > 1:
                batched = self.client_engine.needs_work_batch(
                    [self.clients[h] for h in avail], t
                )
                needs_map = dict(zip(avail, batched))
        pending: List[Tuple[int, ScheduleRequest]] = []
        for hid in host_ids:
            spec = self.specs.get(hid)
            if spec is None:
                continue
            if world.is_available(hid):
                request = self._build_request(hid, t, needs=needs_map.get(hid))
                if request is not None:
                    pending.append((hid, request))
            self._push(t + spec.rpc_poll, _RPC, hid)
        replies = self.server.rpc_batch([r for _, r in pending], t)
        if self.vector_world or self.batch_clients:
            to_start = [
                hid
                for (hid, request), reply in zip(pending, replies)
                if self._apply_reply(hid, request, reply, t, start=False)
            ]
            self._start_jobs_batch(to_start, t)
        else:
            for (hid, request), reply in zip(pending, replies):
                self._apply_reply(hid, request, reply, t)

    def _build_request(
        self,
        host_id: int,
        t: float,
        force_report: bool = False,
        needs: Optional[Dict[ResourceType, ResourceRequest]] = None,
    ) -> Optional[ScheduleRequest]:
        spec = self.specs[host_id]
        client = self.clients[host_id]
        host = spec.host

        fetch = client.choose_fetch_project(t, needs=needs)
        reqs: Dict[ResourceType, ResourceRequest] = {}
        if fetch is not None and fetch.project == self.server.name:
            reqs = fetch.requests
        want_report = force_report or client.should_report(self.server.name, t)
        if not reqs and not want_report:
            return None

        completed: List[CompletedResult] = []
        if want_report:
            for cj in client.take_completed(self.server.name):
                completed.append(self._make_result(spec, cj, t))

        request = ScheduleRequest(
            host_id=host_id,
            requests=reqs,
            completed=completed,
            usable_disk=host.disk_free_bytes,
        )
        self.metrics.rpcs += 1
        if reqs:
            self.metrics.rpcs_requesting_work += 1
        return request

    def _apply_reply(
        self,
        host_id: int,
        request: ScheduleRequest,
        reply,
        t: float,
        start: bool = True,
    ) -> bool:
        """Apply one scheduler reply; returns True when jobs arrived.
        ``start=False`` defers the reschedule to a batched pass."""
        spec = self.specs.get(host_id)
        client = self.clients.get(host_id)
        if spec is None or client is None:
            return False
        host = spec.host
        reqs = request.requests
        proj = client.projects.get(self.server.name)
        if reply.jobs:
            self.metrics.rpcs_with_work += 1
            if proj:
                for rt in host.resources:
                    proj.backoff_for(rt).register_success()
        elif reqs and proj:
            for rt in reqs:
                proj.backoff_for(rt).register_failure(t)

        for dj in reply.jobs:
            ev = dj.version.plan_class.evaluate(host)
            usage = ev[0] if ev else {ResourceType.CPU: 1.0}
            actual = self._draw_runtime(spec, dj.job.est_flop_count, usage)
            cj = ClientJob(
                instance_id=dj.instance.id,
                job_id=dj.job.id,
                project=self.server.name,
                app_name=dj.job.app_name,
                usage=usage,
                est_flops=dj.est_flops,
                est_flop_count=dj.job.est_flop_count,
                deadline=dj.instance.deadline,
                est_wss=dj.job.ram_bytes,
                received_time=t,
            )
            client.jobs.append(cj)
            self._instance_meta[cj.instance_id] = (dj.version.id, actual)
            self._dispatched_actual_total += actual
            self.world.add_job(host_id, cj, actual)
        if reply.jobs and start:
            self._start_jobs(host_id, t)
        return bool(reply.jobs)

    def _draw_runtime(self, spec: HostSpec, est_flop_count: float, usage: Dict[ResourceType, float]) -> float:
        pf = spec.host.peak_flops(usage)
        if pf <= 0:
            return float("inf")
        base = est_flop_count / (pf * spec.efficiency)
        noise = math.exp(self.rng.gauss(0.0, spec.runtime_noise))
        return base * noise

    def _make_result(self, spec: HostSpec, cj: ClientJob, t: float) -> CompletedResult:
        job = self.server.store.jobs.get(cj.job_id)
        crashed = self.rng.random() < spec.crash_prob
        if crashed:
            self._wrong_outputs[cj.instance_id] = False
            return CompletedResult(
                instance_id=cj.instance_id,
                outcome=InstanceOutcome.CLIENT_ERROR,
                runtime=cj.runtime,
                exit_code=1,
            )
        if self.executor is not None:
            truth = self.executor(job, spec.host)
        else:
            truth = self.ground_truth(cj.job_id)
        wrong = False
        if spec.malicious and self.rng.random() < spec.cheat_prob:
            if spec.collusion_group is not None:
                output, wrong = self._collude(spec.collusion_group, cj, truth), True
            else:
                output, wrong = self._corrupt(truth), True
        elif self.rng.random() < spec.error_prob:
            output, wrong = self._corrupt(truth), True
        else:
            output = truth
        self._wrong_outputs[cj.instance_id] = wrong
        self._completed_ok += 1
        pfc = peak_flop_count(cj.runtime, cj.usage, spec.host)
        if spec.claim_factor != 1.0:
            # credit farming (§7 attack model): the host reports inflated
            # peak FLOPS; validation still sees the *correct* output
            pfc *= spec.claim_factor
        return CompletedResult(
            instance_id=cj.instance_id,
            outcome=InstanceOutcome.SUCCESS,
            runtime=cj.runtime,
            peak_flop_count=pfc,
            output=output,
        )

    def _corrupt(self, truth: Any) -> Any:
        if self.corruptor is not None:
            return self.corruptor(truth, self.rng)
        if isinstance(truth, float):
            return truth + self.rng.uniform(1.0, 2.0)
        return ("corrupt", self.rng.random())

    def _collude(self, group: int, cj: ClientJob, truth: Any) -> Any:
        """Colluding-clique payload (§3.4 attack model): a deterministic
        function of (group, job) — every clique member fabricates the
        *identical* wrong result, so replicated instances landing on two
        clique hosts agree and can win the quorum. Consumes no RNG draws
        (the decision draw in ``_make_result`` already happened), so both
        event loops see identical streams."""
        if isinstance(truth, float):
            return truth + 64.0 + float(group)
        return ("collude", group, cj.job_id)

    def was_wrong(self, instance_id: int) -> bool:
        """Whether the given instance returned a wrong output (ground truth
        known only to the emulator — used by the scenario layer to measure
        error credit and quorum defeats)."""
        return self._wrong_outputs.get(instance_id, False)

    # -- end-of-run audit --

    def audit_validation(self) -> None:
        """Count canonical results that were wrong (accepted-error rate)."""
        store = self.server.store
        counted = set()
        for job in list(store.jobs.values()):
            if job.canonical_instance_id is None or job.id in counted:
                continue
            counted.add(job.id)
            wrong = self._wrong_outputs.get(job.canonical_instance_id, False)
            if wrong:
                self.metrics.wrong_accepted += 1
            else:
                self.metrics.correct_accepted += 1
        # explicit counter of instances that ran to completion — CLIENT_ERROR
        # crashes are reported but never completed, so they don't count
        self.metrics.completed_instances = self._completed_ok
        # the audit doubles as the store's index/scan consistency check
        if store.use_indexes:
            store.check_invariants()
        # ... and the world's column <-> object consistency check (the
        # scalar loop keeps object accrual in lockstep with the columns)
        self.world.check_invariants(strict_dynamic=not self.vector_world)
        # persist the defense layer's final suspicion clusters into the
        # world column (deterministic: cluster ids are smallest-member ids)
        defense = self.server.defense
        if defense is not None:
            clusters = defense.clusters()
            world = self.world
            for host_id, slot in world.index.items():
                if world.alive[slot]:
                    world.suspect_cluster[slot] = clusters.get(host_id, -1)
        self._audit_validate_states()

    def _audit_validate_states(self) -> None:
        """Engine-vs-oracle validation audit: re-check every resident
        validated job's partition against the scalar comparator.

        Whichever path assigned the states (the batch engine's digest
        grouping or the scalar ``check_set``), the §3.4/§4 contract holds:
        the canonical instance is VALID, and every other VALID success
        matches the canonical under the app comparator (both paths compare
        members against the winning group's representative). The converse
        — INVALID implies comparator mismatch with the canonical — is only
        an invariant for exact (bitwise) comparators: greedy grouping may
        never have compared an invalid member against the canonical when a
        fuzzy tolerance relation is non-transitive.
        """
        store = self.server.store
        from .validator import bitwise_equal

        for job in store.jobs.values():
            if job.canonical_instance_id is None:
                continue
            canonical = store.instances.get(job.canonical_instance_id)
            if canonical is None:
                continue
            app = store.apps[job.app_name]
            cmp = app.comparator or bitwise_equal
            assert canonical.validate_state == ValidateState.VALID, (
                f"job {job.id}: canonical instance not VALID"
            )
            for inst in store.job_instances(job.id):
                if (
                    inst.id == canonical.id
                    or inst.outcome != InstanceOutcome.SUCCESS
                ):
                    continue
                if inst.validate_state == ValidateState.VALID:
                    assert cmp(canonical.output, inst.output), (
                        f"job {job.id}: VALID instance {inst.id} disagrees "
                        f"with canonical"
                    )
                elif (
                    inst.validate_state == ValidateState.INVALID
                    and app.comparator is None
                ):
                    assert not cmp(canonical.output, inst.output), (
                        f"job {job.id}: INVALID instance {inst.id} agrees "
                        f"with canonical (bitwise)"
                    )
