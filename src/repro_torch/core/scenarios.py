"""Trace-driven & adversarial scenario generation (§3.4, §9; ROADMAP item 4).

The 7-scenario matrix that guarded PRs 1–5 was hand-written and synthetic:
flat exponential availability, independently-corrupting malicious hosts,
memoryless churn. Real volunteer populations (cf. "The Computational and
Storage Potential of Volunteer Computing") have diurnal timezone waves,
heavy-tailed sessions, and correlated outages — and the paper's §3.4
replication/adaptive-validation design exists precisely to defeat *hostile*
populations the old matrix could not express: colluding cliques that return
matching wrong results, Sybil churn-and-rejoin identities that shed
reputation, and credit-farming hosts that inflate claims.

This module is the declarative workload layer over the emulator:

  * :class:`ScenarioSpec` — a frozen dataclass naming the whole scenario:
    fleet size/shape, workload, server policy, plus optional adversarial /
    trace layers (:class:`TraceReplay`, :class:`Outage`, :class:`Clique`,
    :class:`Sybil`, :class:`CreditFarm`, correlated failures);
  * :func:`generate_population` — a **pure function of (spec, spec.seed)**:
    the same spec always yields field-identical ``HostSpec`` lists (and
    therefore identical ``HostArrays`` columns and event streams — pinned
    by a hypothesis property in ``tests/test_scenarios.py``);
  * :func:`build` / :func:`run_spec` — construct the ``ProjectServer`` +
    ``GridSimulation`` pair for any engine-axis combination (and engine
    backend and device) and run it;
  * :func:`run_parity` — the golden harness: every scenario is executed on
    all four engine axes (batch-validate on/off, vectorized world on/off,
    torch engines vs NumPy engines) and the results are asserted identical
    — SimMetrics, server counts, credit totals, per-instance validate
    states, per-job states — before any golden bound is checked;
  * :class:`ScenarioResult` — adversarial effectiveness measures on top of
    ``SimMetrics``: error credit (credit granted on jobs whose canonical
    was wrong), per-host-set credit shares, clique quorum wins.

Availability trace replay lives in ``repro_torch.data.traces`` (fit from
the bundled session trace); this module only assigns the synthesized toggle
schedules onto host specs.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

from ..data import traces
from .backend import resolve_engine
from .defense import DefensePolicy
from .server import ProjectServer
from .simulator import GridSimulation, HostSpec, SimMetrics, make_population
from .types import (
    App,
    AppVersion,
    HRLevel,
    Job,
    Platform,
    ProcessingResource,
    default_cpu_plan_class,
    gpu_plan_class,
    next_id,
    reset_ids,
)
from .validator import fuzzy_comparator

DAY = 86400.0
HOUR = 3600.0

#: Timezone offsets (hours) the trace layer spreads hosts across.
TZ_OFFSETS: Tuple[float, ...] = (-8.0, -5.0, 0.0, 2.0, 5.5, 9.0)

# distinct deterministic salts so each layer's host sample is independent
_SALT_OUTAGE = 0x5BD1E995
_SALT_CLIQUE = 0x9E3779B9
_SALT_FARM = 0xC2B2AE35


# ---------------------------------------------------------------------------
# layer specs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TraceReplay:
    """Replay availability fitted from the bundled session trace: diurnal
    timezone waves + heavy-tailed (lognormal) session lengths."""

    n_timezones: int = 3
    diurnal: bool = True  # modulate off-gaps by the trace's hourly profile
    scale: float = 1.0  # stretch/compress all session lengths


@dataclass(frozen=True)
class Outage:
    """Correlated outage: a host fraction loses power simultaneously."""

    start: float
    duration: float
    fraction: float = 0.5


@dataclass(frozen=True)
class Clique:
    """Colluding malicious hosts fabricating identical wrong payloads, so
    replicas landing inside the clique validate each other (§3.4)."""

    size: int = 3
    cheat_prob: float = 1.0
    group: int = 1


@dataclass(frozen=True)
class Sybil:
    """Churn-and-rejoin: a malicious host departs and returns under fresh
    host ids, shedding whatever reputation its old identity earned."""

    host_index: int = 0  # 0-based index into the generated population
    churn_at: float = 0.75 * DAY
    rejoin_at: float = 1.0 * DAY
    rejoins: int = 1  # serial fresh identities after the first departure
    period: float = 0.5 * DAY  # spacing between serial identities
    dwell_fraction: float = 0.75  # lifetime of each non-final identity
    cheat_prob: float = 1.0


@dataclass(frozen=True)
class CreditFarm:
    """Hosts inflating their claimed peak-FLOP counts by ``factor`` while
    returning correct outputs (§7's normalization is the defense)."""

    count: int = 2
    factor: float = 8.0


@dataclass(frozen=True)
class ScenarioSpec:
    """One fully-declared, seed-deterministic scenario."""

    name: str
    seed: int = 1  # population/generation seed
    sim_seed: int = 3  # simulation event/noise seed
    n_hosts: int = 12
    n_jobs: int = 60
    horizon: float = 2 * DAY
    # server / app policy
    adaptive: bool = False
    gpu: bool = False
    min_quorum: int = 2
    delay_bound: float = 4 * HOUR
    est_hours: float = 0.2
    waves: int = 1
    wave_period: float = 6 * HOUR
    # base population model (make_population passthrough)
    availability: float = 1.0
    error_prob: float = 0.0
    malicious_fraction: float = 0.0
    churn_rate: float = 0.0
    gpu_fraction: float = 0.0
    ncpus: int = 4
    # workload / adversarial layers
    trace: Optional[TraceReplay] = None
    outage: Optional[Outage] = None
    clique: Optional[Clique] = None
    sybil: Optional[Sybil] = None
    farm: Optional[CreditFarm] = None
    # error_prob assigned to the least-available quartile of the fleet
    # (failures correlated with poor availability), 0 disables
    correlated_failures: float = 0.0
    # defense-in-depth replica placement (§3.4): work-spreading suspicion
    # clusters, HR-class census pinning, per-(host, version) daily quota +
    # punishment backoff. None (the default) keeps every pre-existing
    # golden byte-identical.
    defense: Optional[DefensePolicy] = None


# ---------------------------------------------------------------------------
# population generation — pure in (spec, spec.seed)
# ---------------------------------------------------------------------------


def _sample(spec: ScenarioSpec, salt: int, k: int, exclude: Sequence[int] = ()) -> List[int]:
    """Deterministic k-subset of host indices for one adversarial layer."""
    pool = [i for i in range(spec.n_hosts) if i not in set(exclude)]
    rng = random.Random(spec.seed * 1_000_003 + salt)
    return sorted(rng.sample(pool, min(k, len(pool))))


def _host_rng(spec: ScenarioSpec, index: int) -> random.Random:
    # int-arithmetic seed (never hash()): deterministic across processes
    return random.Random(spec.seed * 2_654_435_761 + 97 * index + 13)


def _schedule_on_fraction(s: HostSpec, horizon: float) -> float:
    if s.avail_schedule is None:
        return s.avail_on_mean / (s.avail_on_mean + s.avail_off_mean)
    ivals = traces.toggles_to_intervals(s.avail_schedule, horizon)
    return sum(b - a for a, b in ivals) / horizon


def generate_population(spec: ScenarioSpec) -> List[HostSpec]:
    """Generate the scenario's host population. Pure: same spec (including
    its seed) => field-identical list, no global state touched."""
    pop = make_population(
        spec.n_hosts,
        seed=spec.seed,
        gpu_fraction=spec.gpu_fraction,
        ncpus=spec.ncpus,
        error_prob=spec.error_prob,
        malicious_fraction=spec.malicious_fraction,
        availability=spec.availability,
        churn_rate=spec.churn_rate,
        horizon=spec.horizon,
    )
    # -- trace replay: per-host toggle schedules, timezones round-robin --
    if spec.trace is not None:
        tz_count = max(1, spec.trace.n_timezones)
        step = max(1, len(TZ_OFFSETS) // tz_count)
        zones = [TZ_OFFSETS[(j * step) % len(TZ_OFFSETS)] for j in range(tz_count)]
        fit = traces.fit_trace(traces.load_bundled_trace())
        for i, s in enumerate(pop):
            s.avail_schedule = traces.synthesize_toggles(
                fit,
                _host_rng(spec, i),
                spec.horizon,
                tz_offset=zones[i % tz_count],
                scale=spec.trace.scale,
                diurnal=spec.trace.diurnal,
            )
    # -- correlated outage: forced-off window spliced into schedules --
    if spec.outage is not None:
        o = spec.outage
        hit = _sample(spec, _SALT_OUTAGE, int(math.ceil(o.fraction * spec.n_hosts)))
        for i in hit:
            s = pop[i]
            s.avail_schedule = traces.apply_outage(
                s.avail_schedule or (), o.start, o.start + o.duration, spec.horizon
            )
    # -- colluding clique --
    if spec.clique is not None:
        c = spec.clique
        for i in _sample(spec, _SALT_CLIQUE, c.size):
            s = pop[i]
            s.malicious = True
            s.cheat_prob = c.cheat_prob
            s.collusion_group = c.group
    # -- credit farmers (never clique members: separate attack surfaces) --
    if spec.farm is not None:
        clique_ids = (
            _sample(spec, _SALT_CLIQUE, spec.clique.size) if spec.clique else []
        )
        for i in _sample(spec, _SALT_FARM, spec.farm.count, exclude=clique_ids):
            pop[i].claim_factor = spec.farm.factor
    # -- failures correlated with poor availability --
    if spec.correlated_failures > 0.0:
        ranked = sorted(
            range(spec.n_hosts),
            key=lambda i: (_schedule_on_fraction(pop[i], spec.horizon), i),
        )
        for i in ranked[: max(1, spec.n_hosts // 4)]:
            pop[i].error_prob = spec.correlated_failures
    # -- Sybil attacker: mark + schedule the first departure --
    if spec.sybil is not None:
        sy = spec.sybil
        s = pop[sy.host_index]
        s.malicious = True
        s.cheat_prob = sy.cheat_prob
        s.collusion_group = None
        s.churn_time = sy.churn_at
    return pop


# ---------------------------------------------------------------------------
# Sybil identity chain
# ---------------------------------------------------------------------------

#: Base host id for Sybil rejoin identities — far above make_population's
#: 1..n_hosts range so fresh identities can never collide.
SYBIL_ID_BASE = 100_000


def sybil_identity_ids(spec: ScenarioSpec) -> List[int]:
    """The fresh host ids the Sybil attacker will present, in order."""
    if spec.sybil is None:
        return []
    return [SYBIL_ID_BASE + k + 1 for k in range(spec.sybil.rejoins)]


def _sybil_respec(attacker: HostSpec, new_id: int, churn_time: Optional[float]) -> HostSpec:
    """The attacker's machine under a fresh identity: identical hardware
    and behaviour, new host/volunteer id, zero history."""
    h = attacker.host
    host = replace(
        h,
        id=new_id,
        volunteer_id=new_id,
        resources={rt: replace(r) for rt, r in h.resources.items()},
    )
    return HostSpec(
        host=host,
        efficiency=attacker.efficiency,
        runtime_noise=attacker.runtime_noise,
        error_prob=attacker.error_prob,
        crash_prob=attacker.crash_prob,
        malicious=attacker.malicious,
        cheat_prob=attacker.cheat_prob,
        avail_on_mean=attacker.avail_on_mean,
        avail_off_mean=attacker.avail_off_mean,
        churn_time=churn_time,
        rpc_poll=attacker.rpc_poll,
        collusion_group=attacker.collusion_group,
        claim_factor=attacker.claim_factor,
    )


def _install_sybil(spec: ScenarioSpec, sim: GridSimulation, attacker: HostSpec) -> None:
    sy = spec.sybil
    assert sy is not None
    ids = sybil_identity_ids(spec)
    for k, new_id in enumerate(ids):
        arrive = sy.rejoin_at + k * sy.period
        if arrive >= spec.horizon:
            break
        churn_time: Optional[float] = None
        if k < len(ids) - 1:
            churn_time = arrive + sy.dwell_fraction * sy.period
        new_spec = _sybil_respec(attacker, new_id, churn_time)
        sim.schedule_callback(
            arrive, lambda t, s=new_spec: sim.add_host_spec(s, t)
        )


# ---------------------------------------------------------------------------
# server / simulation construction
# ---------------------------------------------------------------------------


def build_server(
    spec: ScenarioSpec, batch_validate: bool, backend: str = "numpy",
    device="cuda",
) -> ProjectServer:
    server = ProjectServer(
        name="p",
        purge_delay=1e18,
        batch_validate=batch_validate,
        engine_backend=backend,
        engine_device=device,
        defense_policy=spec.defense,
    )
    app = App(
        name="w",
        min_quorum=spec.min_quorum,
        init_ninstances=spec.min_quorum,
        delay_bound=spec.delay_bound,
        adaptive_replication=spec.adaptive,
        comparator=fuzzy_comparator(rtol=1e-6, atol=1e-9),
        hr_level=spec.defense.hr_level if spec.defense is not None else HRLevel.NONE,
    )
    for osn in ("windows", "mac", "linux"):
        app.add_version(
            AppVersion(
                id=next_id("appver"),
                app_name="w",
                platform=Platform(osn, "x86_64"),
                version_num=1,
                plan_class=default_cpu_plan_class(),
            )
        )
        if spec.gpu:
            app.add_version(
                AppVersion(
                    id=next_id("appver"),
                    app_name="w",
                    platform=Platform(osn, "x86_64"),
                    version_num=1,
                    plan_class=gpu_plan_class(),
                )
            )
    server.add_app(app)
    return server


def build(
    spec: ScenarioSpec,
    batch_validate: bool = True,
    vector_world: bool = True,
    epoch: float = 0.0,
    backend: str = "numpy",
    device="cuda",
) -> Tuple[ProjectServer, GridSimulation, List[HostSpec]]:
    """Construct the (server, simulation) pair for one engine-axis setting,
    with job waves and Sybil arrivals installed as virtual-time callbacks.
    ``device`` is the torch engines' (ignored by NumPy)."""
    reset_ids()
    server = build_server(spec, batch_validate, backend=backend, device=device)
    pop = generate_population(spec)
    sim = GridSimulation(
        server, pop, seed=spec.sim_seed, vector_world=vector_world, epoch=epoch,
        backend=backend, device=device,
    )
    per_wave = spec.n_jobs // spec.waves

    def submit(now: float) -> None:
        for _ in range(per_wave):
            server.submit_job(
                Job(
                    id=next_id("job"),
                    app_name="w",
                    est_flop_count=spec.est_hours * 3600 * 16.5e9,
                ),
                now,
            )

    if spec.waves == 1:
        submit(0.0)
    else:
        for w in range(spec.waves):
            sim.schedule_callback(w * spec.wave_period, submit)
    if spec.sybil is not None:
        _install_sybil(spec, sim, pop[spec.sybil.host_index])
    return server, sim, pop


# ---------------------------------------------------------------------------
# execution + golden/parity harness
# ---------------------------------------------------------------------------


@dataclass
class ScenarioResult:
    """One scenario run plus its adversarial effectiveness measures."""

    spec: ScenarioSpec
    server: ProjectServer
    sim: GridSimulation
    metrics: SimMetrics
    population: List[HostSpec] = field(default_factory=list)

    # -- host-set helpers --

    def clique_host_ids(self) -> List[int]:
        if self.spec.clique is None:
            return []
        return [i + 1 for i in _sample(self.spec, _SALT_CLIQUE, self.spec.clique.size)]

    def farm_host_ids(self) -> List[int]:
        if self.spec.farm is None:
            return []
        clique_ids = (
            _sample(self.spec, _SALT_CLIQUE, self.spec.clique.size)
            if self.spec.clique
            else []
        )
        return [
            i + 1
            for i in _sample(
                self.spec, _SALT_FARM, self.spec.farm.count, exclude=clique_ids
            )
        ]

    # -- adversarial effectiveness measures --

    def wrong_credit(self) -> float:
        """Error credit: total credit granted on jobs whose canonical
        result was wrong — what the adversary's lies actually earned."""
        total = 0.0
        store = self.server.store
        for job in store.jobs.values():
            cid = job.canonical_instance_id
            if cid is None or not self.sim.was_wrong(cid):
                continue
            for inst in store.job_instances(job.id):
                total += max(0.0, inst.granted_credit)
        return total

    def credit_of_hosts(self, host_ids: Sequence[int]) -> float:
        totals = self.server.credit.total
        return sum(totals.get(f"host:{h}", 0.0) for h in host_ids)

    def mean_honest_host_credit(self) -> float:
        bad = set(self.clique_host_ids()) | set(self.farm_host_ids())
        if self.spec.sybil is not None:
            bad.add(self.spec.sybil.host_index + 1)
            bad.update(sybil_identity_ids(self.spec))
        honest = [
            s.host.id for s in self.population
            if s.host.id not in bad and not s.malicious
        ]
        if not honest:
            return 0.0
        return self.credit_of_hosts(honest) / len(honest)

    def clique_quorum_wins(self) -> int:
        """Jobs whose accepted canonical came from a clique host and was
        wrong — successful quorum defeats."""
        clique = set(self.clique_host_ids())
        store = self.server.store
        wins = 0
        for job in store.jobs.values():
            cid = job.canonical_instance_id
            if cid is None:
                continue
            inst = store.instances.get(cid)
            if inst is not None and inst.host_id in clique and self.sim.was_wrong(cid):
                wins += 1
        return wins

    def report(self) -> Dict[str, object]:
        m = self.metrics
        counts = self.server.counts()
        out: Dict[str, object] = {
            "name": self.spec.name,
            "seed": self.spec.seed,
            "n_hosts": self.spec.n_hosts,
            "n_jobs": self.spec.n_jobs,
            "metrics": {
                "jobs_success": counts["jobs_success"],
                "jobs_failure": counts["jobs_failure"],
                "completed_instances": m.completed_instances,
                "instances_executed": m.instances_executed,
                "correct_accepted": m.correct_accepted,
                "wrong_accepted": m.wrong_accepted,
                "error_rate": m.error_rate,
                "replication_overhead": m.replication_overhead,
                "idle_fraction": m.idle_fraction,
                "rpcs": m.rpcs,
                "credit_total": sum(
                    v for k, v in self.server.credit.total.items()
                    if k.startswith("host:")
                ),
            },
        }
        extras: Dict[str, object] = {}
        if self.spec.clique is not None:
            extras["clique_hosts"] = self.clique_host_ids()
            extras["clique_quorum_wins"] = self.clique_quorum_wins()
            extras["clique_credit"] = self.credit_of_hosts(self.clique_host_ids())
        if self.spec.farm is not None:
            extras["farm_hosts"] = self.farm_host_ids()
            extras["farm_credit"] = self.credit_of_hosts(self.farm_host_ids())
        if self.spec.clique is not None or self.spec.sybil is not None:
            extras["wrong_credit"] = self.wrong_credit()
        if self.spec.farm is not None or self.spec.clique is not None:
            extras["mean_honest_host_credit"] = self.mean_honest_host_credit()
        if self.spec.sybil is not None:
            extras["sybil_ids"] = sybil_identity_ids(self.spec)
        if extras:
            out["adversarial"] = extras
        defense = self.server.defense
        if defense is not None:
            d: Dict[str, object] = dict(defense.counters())
            clique = self.clique_host_ids()
            if clique:
                # why the clique was contained, per mechanism: dispatches it
                # was denied by quota/backoff/spread, and whether its hosts
                # ended up inside suspicion clusters
                clusters = defense.clusters()
                d["clique_hosts_clustered"] = sorted(
                    h for h in clique if h in clusters
                )
                d["clique_quota_denials"] = sum(
                    defense.denied_quota_by.get(h, 0) for h in clique
                )
                d["clique_deferrals"] = sum(
                    defense.deferred_by.get(h, 0) for h in clique
                )
                d["clique_spread_denials"] = sum(
                    defense.denied_spread_by.get(h, 0) for h in clique
                )
            out["defense"] = d
        return out


def run_spec(
    spec: ScenarioSpec,
    batch_validate: bool = True,
    vector_world: bool = True,
    epoch: float = 0.0,
    backend: str = "numpy",
    device="cuda",
) -> ScenarioResult:
    server, sim, pop = build(spec, batch_validate, vector_world, epoch, backend, device)
    m = sim.run(spec.horizon)
    sim.audit_validation()
    return ScenarioResult(spec=spec, server=server, sim=sim, metrics=m, population=pop)


def _instance_states(server: ProjectServer) -> Dict[int, Tuple[object, float]]:
    return {
        i: (x.validate_state, x.granted_credit)
        for i, x in server.store.instances.items()
    }


def _first_divergence(a: Dict, b: Dict) -> Optional[str]:
    """First differing key (sorted) between two flat dicts, described."""
    for k in sorted(set(a) | set(b), key=str):
        if k not in a:
            return f"{k!r} only in B (B={b[k]!r})"
        if k not in b:
            return f"{k!r} only in A (A={a[k]!r})"
        if a[k] != b[k]:
            return f"{k!r}: A={a[k]!r} B={b[k]!r}"
    return None


def assert_results_identical(
    a: ScenarioResult, b: ScenarioResult, what: str, job_states: bool = False
) -> None:
    """4-axis parity contract. ``what`` names the engine axis under test
    (A = full engines, B = the oracle for that axis); on divergence the
    failure message pinpoints the first differing field/key/instance so
    the break is localizable without re-running the matrix."""

    def fail(section: str, detail: str) -> str:
        return (
            f"[parity] scenario {a.spec.name!r}, axis '{what}': "
            f"{section} diverged first at {detail}"
        )

    d = _first_divergence(vars(a.metrics), vars(b.metrics))
    assert d is None, fail("SimMetrics", d)
    d = _first_divergence(a.server.counts(), b.server.counts())
    assert d is None, fail("server counts", d)
    d = _first_divergence(a.server.credit.total, b.server.credit.total)
    assert d is None, fail("credit totals", d)
    d = _first_divergence(_instance_states(a.server), _instance_states(b.server))
    assert d is None, fail("instance (validate_state, granted_credit)", d)
    if job_states:
        d = _first_divergence(
            {j: x.state for j, x in a.server.store.jobs.items()},
            {j: x.state for j, x in b.server.store.jobs.items()},
        )
        assert d is None, fail("job states", d)


def run_parity(spec: ScenarioSpec, epoch: float = 0.0, device="cuda") -> ScenarioResult:
    """Run the scenario on all engine axes and assert identity: the
    batch-validation engine vs the scalar validation oracle (vector world
    on), the vectorized world loop vs the scalar event loop (batch
    validate on), and the full engine stack on the torch backend on
    ``device`` vs the NumPy engines (the 4th axis, never skipped; the torch
    engines are bit-identical, so the assertion is the same exact-equality
    check as the other axes). Without a card the default device raises
    before anything runs; pass ``device="cpu"`` to run on the CPU. Returns
    the full-engine run for golden-bound assertions."""
    _, device = resolve_engine("torch", device)
    full = run_spec(spec, batch_validate=True, vector_world=True, epoch=epoch)
    oracle_v = run_spec(spec, batch_validate=False, vector_world=True, epoch=epoch)
    assert_results_identical(full, oracle_v, "validation engine vs scalar oracle")
    oracle_w = run_spec(spec, batch_validate=True, vector_world=False, epoch=epoch)
    assert_results_identical(
        full, oracle_w, "vector world vs scalar event loop", job_states=True
    )
    torch_full = run_spec(
        spec, batch_validate=True, vector_world=True, epoch=epoch,
        backend="torch", device=device,
    )
    assert_results_identical(
        full, torch_full, "torch backend vs numpy engines", job_states=True
    )
    return full
