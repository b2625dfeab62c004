"""The port's torch engine backend against the NumPy engines and the
reference's, on the CPU (the twin of ``tests/test_jax_backend.py``).

- the dispatch score/estimate pass, the eligibility scan and the group mask
  against inline NumPy replicas of the engine's exact IEEE op order, as
  seeded sweeps (and seeded hypothesis searches: ``derandomize=True,
  database=None``, so nothing is read from or written to ``.hypothesis/``);
- fleet-level WRR, run-set and work-need identity between
  ``BatchClientEngine()`` and ``BatchClientEngine(backend="torch",
  device="cpu")``, and the port's NumPy engine against the reference's, on
  feature-dense random fleets;
- digest partitions from the port's ``quorum_group_codes`` (the
  ``quorum_compare`` plain version on the CPU) equal to the reference's
  (its Pallas kernel in interpret mode) on the same matrices, with the
  -0.0 and NaN corners;
- the world mirror's dirty upload after each mutation kind, its full
  re-upload on queue growth, and a NumPy twin world that stays bitwise
  identical.

Marked ``gpu`` (skipped without a card): ``dispatch_scores`` with
``avail = 0.35`` on inputs where ``x / 0.35 != x * (1/0.35)`` for many
elements, which only the card can fail (torch divides exactly by a Python
float on the CPU); the client engine and the world twin on the card.
"""
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.core import BatchClientEngine as JBatchClientEngine  # noqa: E402
from repro.core import client as j_client  # noqa: E402
from repro.core.jax_backend import quorum_group_codes as j_quorum_group_codes  # noqa: E402
from repro_torch.core import BatchClientEngine, ResourceType  # noqa: E402
from repro_torch.core import client as t_client  # noqa: E402
from repro_torch.core.backend import BACKENDS, resolve_backend, resolve_engine  # noqa: E402
from repro_torch.core.scheduler import W_BALANCE, W_KEYWORD, W_PRIORITY, W_SKIPPED  # noqa: E402
from repro_torch.core.torch_backend import (  # noqa: E402
    dispatch_elig,
    dispatch_group_mask,
    dispatch_scores,
    quorum_group_codes,
)
from repro_torch.core.world import HostArrays  # noqa: E402

CPU_DEV = torch.device("cpu")
WEIGHTS = (W_KEYWORD, W_BALANCE, W_PRIORITY, W_SKIPPED)


def hyp(prop, **kw):
    """A seeded hypothesis search over the seed of a seeded property."""

    def search(seed):
        prop(seed)

    return settings(deadline=None, derandomize=True, database=None, **kw)(
        given(st.integers(0, 2**31 - 1))(search)
    )


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the torch engines' device runs only on the card")
    return torch.device("cuda")


def test_resolve_backend():
    assert BACKENDS == ("numpy", "torch")
    assert resolve_backend("numpy") == "numpy"
    assert resolve_backend("torch") == "torch"
    with pytest.raises(ValueError, match="unknown backend"):
        resolve_backend("jax")
    # NumPy ignores the device; torch resolves it
    assert resolve_engine("numpy", "cuda") == ("numpy", None)
    assert resolve_engine("numpy", "no-such-device") == ("numpy", None)
    assert resolve_engine("torch", "cpu") == ("torch", CPU_DEV)
    with pytest.raises(ValueError, match="unknown backend"):
        resolve_engine("jax", "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_engine("torch")


# ---------------------------------------------------------------------------
# dispatch passes vs inline NumPy replicas
# ---------------------------------------------------------------------------


def _numpy_scores(kvec, bal, prio, skips, flop, pf, avail):
    """Inline replica of BatchDispatchEngine.candidate_rows' NumPy branch."""
    n = len(prio)
    scores = W_KEYWORD * kvec
    if bal is not None:
        scores += W_BALANCE * bal
    scores += W_PRIORITY * prio
    scores += W_SKIPPED * np.minimum(skips, 5.0)
    est = np.full(n, np.inf, dtype=np.float64)
    pos = pf > 0.0
    est[pos] = flop[pos] / pf[pos]
    if avail <= 0:
        scaled = np.full(n, np.inf, dtype=np.float64)
    else:
        scaled = est / avail
    return scores, est, scaled


def _score_inputs(seed):
    rs = np.random.RandomState(seed)
    n = int(rs.randint(1, 65))
    kvec = rs.rand(n) < 0.5
    bal = rs.uniform(-10, 10, n) if rs.rand() < 0.5 else None
    prio = rs.uniform(-5, 5, n)
    skips = rs.randint(0, 9, n).astype(np.float64)
    flop = rs.uniform(1e9, 1e14, n)
    pf = np.where(rs.rand(n) < 0.2, 0.0, rs.uniform(1e8, 1e11, n))
    avail = float(rs.choice([0.0, 0.35, 1.0]))
    return kvec, bal, prio, skips, flop, pf, avail


def _prop_dispatch_scores(seed, device=CPU_DEV):
    """Device score/est/scaled == the engine's NumPy branch, bit for bit."""
    args = _score_inputs(seed)
    want = _numpy_scores(*args)
    got = dispatch_scores(*args, WEIGHTS, device)
    for g, w in zip(got, want):
        assert g.dtype == np.float64
        np.testing.assert_array_equal(g, w)
        assert np.array_equal(np.signbit(g), np.signbit(w))


def _prop_dispatch_elig(seed):
    """Rotated eligibility scan == the NumPy roll/compare pipeline."""
    rs = np.random.RandomState(seed)
    n = int(rs.randint(1, 129))
    valid = rs.rand(n) < 0.7
    target = np.where(rs.rand(n) < 0.6, -1, rs.randint(1, 5, n)).astype(np.int64)
    start = int(rs.randint(0, n))
    host_id = int(rs.randint(1, 5))
    rot = np.arange(start, start + n) % n
    want = valid[rot] & ((target[rot] < 0) | (target[rot] == host_id))
    got = dispatch_elig(valid, target, start, host_id, CPU_DEV)
    assert got.dtype == bool
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(30))
def test_dispatch_scores_matches_numpy(seed):
    _prop_dispatch_scores(seed)


@pytest.mark.parametrize("seed", range(20))
def test_dispatch_elig_matches_numpy(seed):
    _prop_dispatch_elig(seed)


@pytest.mark.parametrize("seed", range(8))
def test_dispatch_group_mask_matches_numpy(seed):
    rs = np.random.RandomState(seed)
    n = int(rs.randint(1, 65))
    g_ok = rs.rand(n) < 0.8
    kok = rs.rand(n) < 0.8
    hr_rep = np.where(rs.rand(n) < 0.5, -1, rs.randint(0, 3, n)).astype(np.int64)
    host_hr = rs.randint(-2, 3, n).astype(np.int64)
    want = g_ok & ((hr_rep == -1) | (hr_rep == host_hr)) & kok
    np.testing.assert_array_equal(dispatch_group_mask(g_ok, hr_rep, host_hr, kok, CPU_DEV), want)


test_dispatch_scores_hypothesis = hyp(_prop_dispatch_scores, max_examples=60)
test_dispatch_elig_hypothesis = hyp(_prop_dispatch_elig, max_examples=40)


def _division_trap_inputs(n=512):
    """Scores whose ``est / 0.35`` differs from ``est * (1/0.35)`` at many
    elements: integer flops over pf = 1, so est is exact."""
    rs = np.random.RandomState(35)
    flop = rs.randint(1, 2**40, n).astype(np.float64)
    pf = np.ones(n)
    kvec = (rs.rand(n) < 0.5).astype(np.float64)
    return kvec, rs.uniform(-10, 10, n), rs.uniform(-5, 5, n), rs.randint(0, 9, n).astype(np.float64), flop, pf


def test_division_trap_inputs_tell_the_two_divisions_apart():
    *_, flop, pf = _division_trap_inputs()
    est = flop / pf
    differ = int((est / 0.35 != est * (1 / 0.35)).sum())
    assert differ > len(est) // 10, differ
    # on the CPU torch divides exactly, even by a Python float
    t = torch.from_numpy(est)
    np.testing.assert_array_equal((t / 0.35).numpy(), est / 0.35)


@pytest.mark.gpu
def test_dispatch_scores_divide_exactly_on_the_card(cuda):
    """A division by a Python float on the card multiplies by its
    reciprocal; the engine divides by a device tensor, so its scaled
    runtimes equal NumPy's ``est / 0.35`` at every element."""
    kvec, bal, prio, skips, flop, pf = _division_trap_inputs()
    want = _numpy_scores(kvec, bal, prio, skips, flop, pf, 0.35)
    got = dispatch_scores(kvec, bal, prio, skips, flop, pf, 0.35, WEIGHTS, cuda)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for seed in range(30):
        _prop_dispatch_scores(seed, cuda)


# ---------------------------------------------------------------------------
# client engine: WRR + run-set identity on random fleets
# ---------------------------------------------------------------------------


def make_clients(mod, n, seed, max_jobs=12, allow_inf=True):
    """``tests/test_batch_client.make_clients`` over the client classes of
    ``mod`` (the reference's ``repro.core.client`` or the port's): the same
    feature-dense random population from the same draws."""
    CPU, GPU = mod.ResourceType.CPU, mod.ResourceType.GPU
    rng = random.Random(seed)
    clients = []
    for h in range(n):
        res = {CPU: mod.ClientResource(CPU, rng.choice([1, 2, 4, 8]), rng.uniform(1e9, 4e10))}
        if rng.random() < 0.4:
            res[GPU] = mod.ClientResource(GPU, rng.choice([1, 2]), 1e12)
        c = mod.Client(
            host_id=h + 1,
            resources=res,
            prefs=mod.ClientPrefs(
                buffer_lo_days=rng.choice([0.02, 0.1]),
                buffer_hi_days=rng.choice([0.1, 0.5]),
            ),
            ram_bytes=rng.choice([1e9, 4e9, 8e9]),
        )
        c.attach(mod.ProjectAttachment(name="p", resource_share=100.0))
        if rng.random() < 0.5:
            c.attach(mod.ProjectAttachment(name="q", resource_share=rng.choice([50.0, 300.0])))
            if rng.random() < 0.5:
                c.rec.debit("p", rng.uniform(0, 1e5), 0.0)
        flops_choices = [1e9, 2e10] + ([0.0] if allow_inf else [])
        for i in range(rng.randrange(0, max_jobs)):
            usage = {CPU: rng.choice([0.5, 1.0, 2.0])}
            if GPU in res and rng.random() < 0.4:
                usage[GPU] = 1.0
            proj = "q" if ("q" in c.projects and rng.random() < 0.5) else "p"
            c.jobs.append(mod.ClientJob(
                instance_id=h * 1000 + i,
                job_id=h * 1000 + i,
                project=proj,
                app_name="a",
                usage=usage,
                est_flops=rng.choice(flops_choices),
                est_flop_count=rng.uniform(1e11, 5e13),
                deadline=rng.uniform(0.0, 2 * 86400.0),
                est_wss=rng.choice([0.0, 0.5e9, 2e9]),
                fraction_done=rng.choice([0.0, 0.3, 0.99]),
                fraction_done_exact=rng.random() < 0.3,
                runtime=rng.uniform(0, 3600),
                state=rng.choice([
                    mod.RunState.UNSTARTED, mod.RunState.RUNNING,
                    mod.RunState.PREEMPTED, mod.RunState.DONE,
                ]),
                slice_start=rng.uniform(0, 1000),
                checkpoint_time=rng.uniform(0, 1000),
                non_cpu_intensive=rng.random() < 0.1,
            ))
        clients.append(c)
    return clients


def _by_name(d):
    return {rt.name: v for rt, v in d.items()}


def _wrr_sig(r):
    return (list(r.deadline_misses), _by_name(r.shortfall), _by_name(r.idle_instances),
            _by_name(r.queue_dur), _by_name(r.saturated_until))


def _jobs_sig(js):
    return [(j.instance_id, j.state, j.slice_start, j.deadline_miss) for j in js]


def _needs_sig(d):
    return {rt.name: (r.req_runtime, r.req_idle, r.queue_dur) for rt, r in d.items()}


def _client_pass(engine, fleet, now):
    wrr = [_wrr_sig(r) for r in engine.wrr_batch(fleet, now)]
    runs = [_jobs_sig(r) for r in engine.schedule_batch(fleet, now)]
    state = [(_jobs_sig(c.jobs), _jobs_sig(c.running)) for c in fleet]
    needs = [_needs_sig(d) for d in engine.needs_work_batch(fleet, now)]
    return wrr, runs, state, needs


def _client_identity(seed, device=CPU_DEV, n=25):
    """Twin fleets through ``backend="numpy"`` and ``backend="torch"``:
    identical WRR floats and miss lists, run sets (content, order, applied
    state, slice stamps) and work needs; the port's NumPy engine equal to
    the reference's on a third twin."""
    now = 500.0
    allow_inf = bool(seed % 2)
    got = _client_pass(BatchClientEngine(backend="torch", device=device),
                       make_clients(t_client, n, seed, allow_inf=allow_inf), now)
    want = _client_pass(BatchClientEngine(), make_clients(t_client, n, seed, allow_inf=allow_inf), now)
    ref = _client_pass(JBatchClientEngine(), make_clients(j_client, n, seed, allow_inf=allow_inf), now)
    assert got == want
    assert want == ref


@pytest.mark.parametrize("seed", range(6))
def test_client_engine_backend_identity(seed):
    _client_identity(seed)


test_client_engine_hypothesis = hyp(_client_identity, max_examples=6)


def _prop_wrr_greedy(seed):
    """One WRR greedy pass of ``WRRGreedyContext`` == the NumPy engine's
    ``_greedy`` on random inputs that reach every op-skipping rule: ranks
    whose usage is all +0.0, all <= 0 or mixed, -0.0 usages, infinite ones
    (no folding of the ``u <= 0`` test), working sets all +0.0 by rank,
    negative RAM (no skipping of the RAM test) and hosts without a
    resource. Running sets and caps bit for bit (NaN, signs included)."""
    from types import SimpleNamespace

    from repro_torch.core.torch_backend import WRRGreedyContext

    rs = np.random.RandomState(seed)
    J, H = int(rs.randint(1, 12)), int(rs.randint(1, 9))
    rtypes = [ResourceType.CPU, ResourceType.GPU][: int(rs.randint(1, 3))]
    u_w, u_eps, u_zero = {}, {}, {}
    for rt in rtypes:
        u = rs.choice([0.0, 0.5, 1.0, 2.0], size=(J, H))
        u[rs.rand(J) < 0.3] = 0.0
        u[rs.rand(J, H) < 0.1] = -0.0
        if rs.rand() < 0.3:
            u[rs.rand(J, H) < 0.1] = rs.choice([np.inf, -np.inf])
        u_w[rt], u_eps[rt], u_zero[rt] = u, u - 1e-12, u <= 0.0
    wss = rs.choice([0.0, 1e9, 3e9], size=(J, H))
    wss[rs.rand(J) < 0.5] = 0.0
    ram = rs.choice([2e9, 4e9, 8e9], size=H)
    if rs.rand() < 0.3:
        ram[0] = -1.0
    has = {rt: rs.rand(H) < (1.0 if rt == ResourceType.CPU else 0.6) for rt in rtypes}
    s = SimpleNamespace(
        J=J, H=H, rtypes=rtypes, has=has, all_has={rt: bool(has[rt].all()) for rt in rtypes},
        nins={rt: rs.choice([1.0, 2.0, 4.0], size=H) for rt in rtypes}, ram=ram)
    order_live = rs.rand(J, H) < 0.7
    active = rs.rand(H) < 0.8
    row_counts = order_live.sum(axis=1)
    want_run, want_cap = BatchClientEngine._greedy(
        None, s, order_live, active, u_w, u_eps, u_zero, wss, row_counts=row_counts)
    ctx = WRRGreedyContext(s, u_w, u_eps, u_zero, wss, CPU_DEV)
    got_run, got_cap = ctx.greedy(order_live, active, row_counts)
    np.testing.assert_array_equal(got_run, want_run)
    for rt in rtypes:
        np.testing.assert_array_equal(got_cap[rt], want_cap[rt])
        assert np.array_equal(np.signbit(got_cap[rt]), np.signbit(want_cap[rt]))


@pytest.mark.parametrize("seed", range(40))
def test_wrr_greedy_matches_numpy(seed):
    _prop_wrr_greedy(seed)


# ---------------------------------------------------------------------------
# quorum_compare digest partitions vs the reference's Pallas grouping
# ---------------------------------------------------------------------------


def _partition(codes):
    """Label-free view of a grouping: sorted tuple-of-tuples of indices."""
    groups = {}
    for i, c in enumerate(codes):
        groups.setdefault(int(c), []).append(i)
    return sorted(tuple(v) for v in groups.values())


_TOL_BANDS = [(1e-5, 1e-8), (1e-6, 1e-9), (1e-4, 1e-6)]


def _digest_matrix(seed):
    """The reference test's matrices: groups far outside each other's
    tolerance (the digest contract), exact zeros flipped to -0.0 in some
    replicas, and a NaN row half the time."""
    rs = np.random.RandomState(seed)
    d = int(rs.randint(4, 49))
    n_groups = int(rs.randint(1, 4))
    rtol, atol = _TOL_BANDS[int(rs.randint(0, len(_TOL_BANDS)))]
    rows = []
    for g in range(n_groups):
        base = rs.standard_normal(d) * 10.0
        if rs.rand() < 0.5:
            base[rs.rand(d) < 0.3] = 0.0
        base = base + g * (1000.0 * (atol + rtol * 20.0) + 5.0)
        for _ in range(int(rs.randint(1, 4))):
            row = base.copy()
            if rs.rand() < 0.5:
                row[row == 0.0] = -0.0
            rows.append(row)
    if rs.rand() < 0.5:
        bad = rs.standard_normal(d)
        bad[int(rs.randint(0, d))] = np.nan
        rows.append(bad)
    return np.stack(rows)[rs.permutation(len(rows))].astype(np.float64), rtol, atol


def _prop_digest_buckets(seed):
    mat, rtol, atol = _digest_matrix(seed)
    got = _partition(quorum_group_codes(mat, rtol, atol, CPU_DEV))
    want = _partition(j_quorum_group_codes(mat, rtol, atol))
    assert got == want


@pytest.mark.parametrize("seed", range(12))
def test_quorum_digest_buckets_match_reference(seed):
    _prop_digest_buckets(seed)


test_quorum_digest_hypothesis = hyp(_prop_digest_buckets, max_examples=15)


def test_quorum_digest_negative_zero_and_nan_exact():
    """A -0.0 replica groups with its +0.0 twin; every NaN-carrying replica
    is its own group; the labels are the reference's, NaN sentinels apart."""
    a = np.array([0.0, 1.0, 2.0, 3.0])
    b = a.copy()
    b[0] = -0.0
    c = a + 100.0
    nan1 = a.copy()
    nan1[2] = np.nan
    nan2 = nan1.copy()
    mat = np.stack([a, b, c, nan1, nan2])
    codes = quorum_group_codes(mat, 1e-5, 1e-8, CPU_DEV)
    assert codes[0] == codes[1] == 0 and codes[2] == 1
    assert len({int(x) for x in codes}) == 4  # {a,b}, {c}, {nan1}, {nan2}
    assert codes[3] != codes[4] and codes[4] == codes[3] + 1  # sentinels in row order
    want = j_quorum_group_codes(mat, 1e-5, 1e-8)
    np.testing.assert_array_equal(codes[:3], want[:3])
    assert _partition(codes) == _partition(want)


def test_quorum_digest_counts_the_kernel_on_the_card_only():
    from repro_torch.kernels.quorum_compare import ops as quorum_ops

    before = quorum_ops.launches
    quorum_group_codes(np.stack([np.ones(8), np.ones(8) + 3.0]), 1e-6, 1e-9, CPU_DEV)
    assert quorum_ops.launches == before  # the plain version: no launch counted


# ---------------------------------------------------------------------------
# world device mirror: dirty-upload regression
# ---------------------------------------------------------------------------

CPU = ResourceType.CPU


def _mk_world(backend, n_hosts=6, seed=11, device=CPU_DEV):
    rng = random.Random(seed)
    world = HostArrays(backend=backend, device=device)
    for h in range(n_hosts):
        client = t_client.Client(
            host_id=h + 1,
            resources={CPU: t_client.ClientResource(CPU, 4, 1e10)},
            prefs=t_client.ClientPrefs(),
        )
        client.attach(t_client.ProjectAttachment(name="p"))
        world.add_host(h + 1, client, 4)
        for k in range(rng.randrange(1, 5)):
            cj = t_client.ClientJob(
                instance_id=h * 100 + k,
                job_id=h * 100 + k,
                project="p",
                app_name="w",
                usage={CPU: rng.choice([0.5, 1.0, 2.0])},
                est_flops=1e10,
                est_flop_count=1e13,
                deadline=1e9,
                state=rng.choice([t_client.RunState.RUNNING, t_client.RunState.PREEMPTED]),
            )
            client.jobs.append(cj)
            world.add_job(h + 1, cj, actual_total=rng.uniform(40.0, 200.0))
        world.sync_run_state(h + 1)
    return world


def _assert_mirror_matches_host(world):
    """After a sync flush every device column equals its host column: the
    incremental dirty-range upload equals a from-scratch upload."""
    m = world._mirror
    m.sync(world)
    assert not m.dirty and not m.all_dirty
    for name in ("q_total", "q_runtime", "q_frac", "q_running", "q_weight", "busy"):
        dev = getattr(m, name)
        assert dev.device.type == world.device.type, name
        np.testing.assert_array_equal(dev.cpu().numpy(), getattr(world, name), err_msg=name)
    np.testing.assert_array_equal(m.q_cpu.cpu().numpy(), world.q_usage[CPU])


def _extra_job(iid, state, usage=1.0):
    return t_client.ClientJob(
        instance_id=iid, job_id=iid, project="p", app_name="w",
        usage={CPU: usage}, est_flops=1e10, est_flop_count=1e13,
        deadline=1e9, state=state,
    )


def test_dirty_upload_after_each_mutation_kind():
    """Drive every ``_touch`` writer between device passes; the device
    columns must match the host arrays after each pass."""
    world = _mk_world("torch")
    ids = list(world.index)
    world.advance_batch(ids, 30.0)
    _assert_mirror_matches_host(world)

    # set_accrued + sync_run_state
    world.set_accrued(1, 0, 7.25)
    for j in world.clients[world.index[2]].jobs:
        j.state = t_client.RunState.RUNNING
    world.sync_run_state(2)
    world.advance_batch(ids, 60.0)
    _assert_mirror_matches_host(world)

    # dirty-host refresh: mutate objects out of band, then resync
    c3 = world.clients[world.index[3]]
    if c3.jobs:
        c3.jobs[0].state = t_client.RunState.DONE
    world.mark_dirty(3)
    world.resync_host(3)
    _assert_mirror_matches_host(world)

    # churn: remove a host, add a job elsewhere
    world.remove_host(4)
    extra = _extra_job(9999, t_client.RunState.RUNNING)
    world.clients[world.index[5]].jobs.append(extra)
    world.add_job(5, extra, actual_total=55.0)
    world.sync_run_state(5)
    world.advance_batch([h for h in ids if h != 4], 95.0)
    _assert_mirror_matches_host(world)

    # the completion path reads through the same mirror
    done = world.completed_rows_batch([h for h in ids if h != 4])
    for h, rows in done.items():
        i = world.index[h]
        cnt = int(world.q_count[i])
        want = np.flatnonzero(
            world.q_running[:cnt, i]
            & (world.q_runtime[:cnt, i] >= world.q_total[:cnt, i] - 1e-6)
        )
        np.testing.assert_array_equal(rows, want, err_msg=str(h))
    _assert_mirror_matches_host(world)

    # removing completed rows compacts a host's queue columns
    for h, rows in done.items():
        if len(rows):
            world.remove_rows(h, rows)
    world.advance_batch([h for h in ids if h != 4], 400.0)
    _assert_mirror_matches_host(world)


def test_queue_growth_forces_full_reupload():
    """Growing the queue matrix reallocates host storage; the mirror's
    shape check must catch it and re-upload everything."""
    world = _mk_world("torch", n_hosts=2)
    world.advance_batch([1, 2], 10.0)
    q_before = world.q_total.shape
    c = world.clients[world.index[1]]
    for k in range(world._q + 1):  # force at least one _grow_queue
        cj = _extra_job(5000 + k, t_client.RunState.PREEMPTED, usage=0.5)
        c.jobs.append(cj)
        world.add_job(1, cj, actual_total=80.0)
    assert world.q_total.shape != q_before
    world.advance_batch([1, 2], 40.0)
    assert world._mirror._shape == world.q_total.shape
    _assert_mirror_matches_host(world)


def _drive_world(backend, device=CPU_DEV):
    world = _mk_world(backend, seed=23, device=device)
    ids = list(world.index)
    for t in (15.0, 47.5, 160.0, 500.0):
        world.advance_batch(ids, t)
        if t == 47.5:
            # host 2's first job has instance id 100 (h=1, k=0)
            if 100 in world.row_of[world.index[2]]:
                world.set_accrued(2, 100, 3.5)
            world.remove_host(6)
            ids = [h for h in ids if h != 6]
        if t == 160.0:
            done = world.completed_rows_batch(ids)
            for h, rows in done.items():
                if len(rows):
                    world.remove_rows(h, rows)
    return world


def _assert_world_twins(wn, wt):
    for name in ("q_runtime", "q_frac", "busy", "q_count"):
        np.testing.assert_array_equal(getattr(wn, name), getattr(wt, name), err_msg=name)
    for cn, ct in zip(wn.clients, wt.clients):
        if cn is None or ct is None:
            assert cn is None and ct is None
            continue
        recs_n = {k: (a.balance, a.total_used) for k, a in cn.rec.accounts.items()}
        recs_t = {k: (a.balance, a.total_used) for k, a in ct.rec.accounts.items()}
        assert recs_n == recs_t


def test_world_backend_twin_parity():
    """A NumPy twin driven through the identical mutation/tick sequence
    stays bitwise identical in accrual state and REC debits."""
    _assert_world_twins(_drive_world("numpy"), _drive_world("torch"))


@pytest.mark.gpu
def test_engines_on_the_card_match_numpy(cuda):
    """The client engine and the world twin on the card, bit for bit."""
    for seed in range(3):
        _client_identity(seed, cuda, n=200)
    _assert_world_twins(_drive_world("numpy"), _drive_world("torch", cuda))
    world = _mk_world("torch", device=cuda)
    world.advance_batch(list(world.index), 30.0)
    _assert_mirror_matches_host(world)


def test_persistent_dispatch_engine_follows_backend_and_device():
    """The scheduler's cached dispatch snapshot is rebuilt when the engine
    backend or the device it was built for differs from the scheduler's."""
    from repro_torch.core import ProjectServer

    server = ProjectServer(name="p", vector_dispatch=True)
    sched = server.schedulers[0]
    first = sched._persistent_engine()
    assert first.backend == "numpy" and first.device is None
    assert sched._persistent_engine() is first
    sched.engine_backend, sched.engine_device = "torch", "cpu"
    second = sched._persistent_engine()
    assert second is not first and second.backend == "torch" and second.device == CPU_DEV
    assert sched._persistent_engine() is second
    second.device = torch.device("cuda")  # as if built for the card
    third = sched._persistent_engine()
    assert third is not second and third.device == CPU_DEV
