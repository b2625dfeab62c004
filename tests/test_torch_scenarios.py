"""The port's scenario layer against the reference's, on the CPU (part 1).

- The first half of the reference's scenario matrix
  (``tests/test_scenarios.py``, by sorted name; the second half is in
  ``test_torch_scenarios_matrix.py``, with the port's own ``run_parity``):
  each scenario runs through the
  reference's ``run_spec``, the port's NumPy ``run_spec`` and the port's
  ``run_spec(backend="torch", device="cpu")``, and all three are identical
  field by field: SimMetrics, server counts, credit totals, each instance's
  validate state and granted credit, each job's state and the scenario
  report.
- A tensor-payload scenario (12 hosts, 40 jobs, 64-element f64 results from
  the simulator's ``executor``, corruptions far outside the tolerance from
  its ``corruptor``): identical across the reference's NumPy and ``jax``
  engines and the port's NumPy and torch engines; the torch run's digests
  go through ``quorum_group_codes``.
- ``generate_population`` on the reference's corner sweep, the bundled
  trace's fit and bytes, and ``BoincSimConfig``, equal across the packages.
- The twin of ``test_defense_never_deadlocks`` as a parity property: the
  port leaves exactly the jobs, states and ``instances_unsent`` the
  reference leaves, at the reference's corners, at its known falsifying
  example (where both leave one instance unsent) and under a seeded
  hypothesis search (``derandomize=True, database=None``: nothing is read
  from or written to ``.hypothesis/``).
"""
import dataclasses
import enum
import importlib
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.configs import boinc_sim as j_boinc_sim  # noqa: E402
from repro.core import scenarios as j_scen  # noqa: E402
from repro.core.defense import DefensePolicy as JDefensePolicy  # noqa: E402
from repro.data import traces as j_traces  # noqa: E402
from repro_torch.configs import boinc_sim  # noqa: E402
from repro_torch.core import scenarios  # noqa: E402
from repro_torch.core import torch_backend  # noqa: E402
from repro_torch.data import traces  # noqa: E402
from test_scenarios import SCENARIOS  # noqa: E402

CPU = torch.device("cpu")
NAMES = sorted(SCENARIOS)
FIRST_HALF = NAMES[: len(NAMES) // 2]
SECOND_HALF = NAMES[len(NAMES) // 2:]


# ---------------------------------------------------------------------------
# reference objects -> the port's, results -> plain comparable values
# ---------------------------------------------------------------------------


def to_port(x):
    """The port's twin of a reference spec value: dataclasses and enums
    rebuilt from the same-named class of the port's same-named module."""
    if isinstance(x, enum.Enum) or dataclasses.is_dataclass(x):
        mod = importlib.import_module(type(x).__module__.replace("repro.", "repro_torch.", 1))
        cls = getattr(mod, type(x).__name__)
        if isinstance(x, enum.Enum):
            return cls[x.name]
        return cls(**{f.name: to_port(getattr(x, f.name)) for f in dataclasses.fields(x)})
    if isinstance(x, (list, tuple)):
        return type(x)(to_port(v) for v in x)
    return x


def plain(x):
    """A package-free value to compare: enums by name, dataclasses as
    (class name, fields), NaN as a string (so that it equals itself)."""
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.name)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, tuple((f.name, plain(getattr(x, f.name)))
                                        for f in dataclasses.fields(x)))
    if isinstance(x, dict):
        return {plain(k): plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(plain(v) for v in x)
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    return x


def result_fields(r):
    """Every field the parity contract compares, plus the scenario report."""
    server = r.server
    return {
        "metrics": plain(vars(r.metrics)),
        "counts": plain(server.counts()),
        "credit": plain(dict(server.credit.total)),
        "instances": plain({i: (x.validate_state, x.granted_credit)
                            for i, x in server.store.instances.items()}),
        "jobs": plain({j: x.state for j, x in server.store.jobs.items()}),
        "report": plain(r.report()),
    }


def assert_same(got, want, what):
    g, w = result_fields(got), result_fields(want)
    for key in w:
        assert g[key] == w[key], f"{what}: {key} differ"


def run_three(spec, **kw):
    """The reference's NumPy run, the port's NumPy run and the port's torch
    run (on the CPU) of one reference spec; all three identical."""
    ref = j_scen.run_spec(spec, **kw)
    pspec = to_port(spec)
    port_np = scenarios.run_spec(pspec, **kw)
    port_t = scenarios.run_spec(pspec, backend="torch", device=CPU, **kw)
    assert_same(port_np, ref, f"{spec.name}: port numpy vs reference")
    assert_same(port_t, port_np, f"{spec.name}: port torch vs port numpy")
    scenarios.assert_results_identical(port_np, port_t, "torch backend vs numpy engines",
                                       job_states=True)
    return ref, port_np, port_t


# ---------------------------------------------------------------------------
# the matrix, first half
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", FIRST_HALF)
def test_scenario_matrix_across_packages(name):
    spec, check = SCENARIOS[name]
    ref, _, _ = run_three(spec)
    check(ref)  # the reference's golden bounds, on the result all three share


# ---------------------------------------------------------------------------
# tensor payloads through the validation engine
# ---------------------------------------------------------------------------

PAYLOAD = 64


def payload_executor(n):
    """Each job's result: an n-element f64 vector drawn from a generator
    seeded by the job id, so every replica agrees exactly."""

    def execute(job, host):
        return np.random.default_rng(job.id).standard_normal(n)

    return execute


def payload_corruptor(truth, rng):
    """A corruption far outside the comparator's tolerance (the digest
    contract): one draw from the simulation's stream added to every element."""
    return truth + rng.uniform(1.0, 2.0)


def payload_spec(mod, n_hosts=12, n_jobs=40):
    return mod.ScenarioSpec(name="tensor_payloads", seed=5, n_hosts=n_hosts, n_jobs=n_jobs,
                            error_prob=0.05, malicious_fraction=0.1)


def run_payloads(mod, spec, n=PAYLOAD, **kw):
    server, sim, pop = mod.build(spec, **kw)
    sim.executor = payload_executor(n)
    sim.corruptor = payload_corruptor
    m = sim.run(spec.horizon)
    sim.audit_validation()
    return mod.ScenarioResult(spec=spec, server=server, sim=sim, metrics=m, population=pop)


def test_tensor_payload_scenario_four_ways(monkeypatch):
    grouped = []
    real = torch_backend.quorum_group_codes

    def counting(mat, rtol, atol, device):
        grouped.append(mat.shape)
        return real(mat, rtol, atol, device)

    monkeypatch.setattr(torch_backend, "quorum_group_codes", counting)
    ref_np = run_payloads(j_scen, payload_spec(j_scen))
    ref_jax = run_payloads(j_scen, payload_spec(j_scen), backend="jax")
    port_np = run_payloads(scenarios, payload_spec(scenarios))
    port_t = run_payloads(scenarios, payload_spec(scenarios), backend="torch", device=CPU)
    assert_same(ref_jax, ref_np, "reference jax vs reference numpy")
    assert_same(port_np, ref_np, "port numpy vs reference numpy")
    assert_same(port_t, ref_np, "port torch vs reference numpy")
    assert grouped and all(shape[1] == PAYLOAD for shape in grouped)
    m = port_t.metrics
    assert port_t.server.counts()["jobs_success"] == 40
    assert m.wrong_accepted == 0 and m.error_rate == 0.0
    # corrupted replicas were rejected by the digests, so there were some
    assert any(port_t.sim.was_wrong(i) for i in port_t.server.store.instances)


# ---------------------------------------------------------------------------
# generation, traces, configuration
# ---------------------------------------------------------------------------

GENERATION_CORNERS = [
    (0, 4, False, False, False, False),
    (1, 12, True, False, False, False),
    (2, 12, False, True, False, False),
    (3, 12, False, False, True, False),
    (4, 12, False, False, False, True),
    (5, 8, True, True, True, False),
    (6, 14, True, True, True, True),
    (982451653, 5, True, False, True, True),
]


def _spec_from(mod, seed, n_hosts, with_trace, with_clique, with_farm, with_sybil):
    return mod.ScenarioSpec(
        name="prop", seed=seed, n_hosts=n_hosts, n_jobs=8,
        trace=mod.TraceReplay(n_timezones=2) if with_trace else None,
        clique=mod.Clique(size=min(3, n_hosts - 1)) if with_clique else None,
        farm=mod.CreditFarm(count=2) if with_farm else None,
        sybil=mod.Sybil() if with_sybil else None,
        adaptive=with_sybil,
    )


@pytest.mark.parametrize("corner", GENERATION_CORNERS)
def test_generate_population_matches_reference(corner):
    want = j_scen.generate_population(_spec_from(j_scen, *corner))
    got = scenarios.generate_population(_spec_from(scenarios, *corner))
    assert [plain(vars(s)) for s in got] == [plain(vars(s)) for s in want]
    # and the built simulations start from the same world and event stream
    _, sim_j, _ = j_scen.build(_spec_from(j_scen, *corner))
    _, sim_t, _ = scenarios.build(_spec_from(scenarios, *corner))
    assert sim_t.world.index == sim_j.world.index
    for col in ("ids", "alive", "available", "flops", "cap_ncpu", "ram", "b_hi", "time_slice"):
        np.testing.assert_array_equal(getattr(sim_t.world, col), getattr(sim_j.world, col), col)
    assert sorted(sim_t._heap) == sorted(sim_j._heap)


def test_bundled_trace_and_its_fit_match_reference():
    with open(traces._BUNDLED, "rb") as f, open(j_traces._BUNDLED, "rb") as g:
        assert f.read() == g.read()
    assert os.path.dirname(traces._BUNDLED) == os.path.dirname(traces.__file__)
    sessions = traces.load_bundled_trace()
    assert [tuple(s) for s in sessions] == [tuple(s) for s in j_traces.load_bundled_trace()]
    fit, j_fit = traces.fit_trace(sessions), j_traces.fit_trace(j_traces.load_bundled_trace())
    assert plain(fit) == plain(j_fit)
    import random

    got = traces.synthesize_toggles(fit, random.Random(7), 3 * 86400.0, tz_offset=5.5)
    want = j_traces.synthesize_toggles(j_fit, random.Random(7), 3 * 86400.0, tz_offset=5.5)
    assert got == want
    assert traces.apply_outage(got, 1e4, 5e4, 3 * 86400.0) == j_traces.apply_outage(
        want, 1e4, 5e4, 3 * 86400.0)


def test_boinc_sim_config_matches_reference():
    assert dataclasses.asdict(boinc_sim.CONFIG) == dataclasses.asdict(j_boinc_sim.CONFIG)
    assert ([f.name for f in dataclasses.fields(boinc_sim.BoincSimConfig)]
            == [f.name for f in dataclasses.fields(j_boinc_sim.BoincSimConfig)])


# ---------------------------------------------------------------------------
# the deadlock twin: the port drains (or wedges) exactly as the reference
# ---------------------------------------------------------------------------


def _drain_spec(mod, policy, seed, n_hosts, n_jobs, error_prob, with_trace):
    return mod.ScenarioSpec(
        name="defense_drain", seed=seed, n_hosts=n_hosts, n_jobs=n_jobs,
        error_prob=error_prob,
        trace=mod.TraceReplay(n_timezones=2) if with_trace else None,
        horizon=3 * mod.DAY if with_trace else 2 * mod.DAY,
        defense=policy,
    )


def drain_parity(seed, n_hosts, n_jobs, error_prob, with_trace):
    """The reference's and the port's torch-engine run of one defended
    drain scenario leave the same jobs, states and counts."""
    from repro_torch.core.defense import DefensePolicy

    ref = j_scen.run_spec(_drain_spec(j_scen, JDefensePolicy(), seed, n_hosts, n_jobs,
                                      error_prob, with_trace))
    got = scenarios.run_spec(_drain_spec(scenarios, DefensePolicy(), seed, n_hosts, n_jobs,
                                         error_prob, with_trace), backend="torch", device=CPU)
    assert_same(got, ref, "defense drain: port torch vs reference")
    return ref, got


@pytest.mark.parametrize(
    "seed,n_hosts,n_jobs,error_prob,with_trace",
    [
        (0, 4, 8, 0.0, False),
        (1, 6, 12, 0.1, False),
        (2, 12, 20, 0.05, False),
        (3, 12, 16, 0.05, True),
        (4, 5, 10, 0.15, True),
    ],
)
def test_defense_drain_parity_corners(seed, n_hosts, n_jobs, error_prob, with_trace):
    ref, got = drain_parity(seed, n_hosts, n_jobs, error_prob, with_trace)
    assert got.server.counts()["jobs_success"] == n_jobs
    assert got.server.counts()["instances_unsent"] == 0


def test_defense_drain_known_wedge_is_shared():
    """The reference's known falsifying example of its drain property: 17 of
    18 jobs succeed and one instance stays unsent, in both packages."""
    ref, got = drain_parity(0, 4, 18, 0.1, False)
    for r in (ref, got):
        c = r.server.counts()
        assert c["jobs_success"] == 17 and c["instances_unsent"] == 1, c


@settings(max_examples=8, deadline=None, derandomize=True, database=None)
@given(
    seed=st.integers(min_value=0, max_value=10**6),
    n_hosts=st.integers(min_value=4, max_value=14),
    n_jobs=st.integers(min_value=4, max_value=20),
    error_prob=st.sampled_from([0.0, 0.02, 0.1]),
    with_trace=st.booleans(),
)
def test_defense_drain_parity_search(seed, n_hosts, n_jobs, error_prob, with_trace):
    drain_parity(seed, n_hosts, n_jobs, error_prob, with_trace)
