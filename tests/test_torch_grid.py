"""The port's volunteer-grid trainer against the reference's, on the CPU.

* ``grad_comparator``: the port's (quorum_compare counts, ``torch.isclose``
  for non-finite leaves) against the reference's (``np.isclose``) on crafted
  leaves: values one f32 step either side of the tolerance, NaN, ±inf,
  equal infinities, overflowing differences, shape and leaf-count
  mismatches. Verdicts are compared over a sweep of ``max_bad_fraction``,
  so equal verdicts mean equal counts.
* ``_grad_corruptor``: the same leaf is corrupted by the same factor from
  the same ``random.Random`` state.
* The seeded grid run of ``benchmarks/bench_grid_train.py`` (smoke qwen3 at
  2 layers, d=64, seq 64, batch 4, 2 shards, seed 3, 12 steps, 8 hosts, 5%
  error, 15% malicious, 90% availability), at f32 from the reference's
  initial parameters: steps, every ``SimMetrics`` field, credit, retries and
  virtual time identical; losses to rtol 1e-5 (measured max abs difference
  9.5e-7 on losses near 6). The same run for ``mamba2-smoke`` (2 layers,
  d = 64, N = 16, heads of 16) at f32, its SSD scans differentiated through
  the ``ssd_scan`` op: everything identical, losses to rtol 1e-5.

Marked ``gpu``: the seeded 4-step run of the qwen3 and mamba2 smoke configs
on the card against the CPU (the mamba2 run through the ssd_scan backward
kernels).
"""
import dataclasses
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_get_smoke_config  # noqa: E402
from repro.core import reset_ids as j_reset_ids  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.runtime import GridTrainer as JGridTrainer  # noqa: E402
from repro.runtime import grid_runtime as j_grid  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import backend, reset_ids  # noqa: E402
from repro_torch.data import DataConfig  # noqa: E402
from repro_torch.kernels.quorum_compare import ops as quorum_ops  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.runtime import GridTrainer, grid_runtime  # noqa: E402

RTOL, ATOL = 1e-4, 1e-6  # grad_comparator's defaults in both packages
LOSS_RTOL = 1e-5
STEPS_SSM = 12


def _boundary_leaf(seed):
    """Replicas one f32 step inside and outside isclose's tolerance."""
    b = (np.random.default_rng(seed).standard_normal(512) * np.logspace(-9, 4, 512)).astype(np.float32)
    tol = np.float32(ATOL) + np.float32(RTOL) * np.abs(b)
    a = np.concatenate([b + tol, np.nextafter(b + tol, np.float32(np.inf)),
                        np.nextafter(b - tol, np.float32(-np.inf)), b - tol]).astype(np.float32)
    return a, np.concatenate([b] * 4)


def _with(values, n=64, seed=1):
    """A leaf of n finite values with ``values`` written over its head."""
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    x[: len(values)] = values
    return x


INF, NAN, BIG = np.inf, np.nan, 3e38
CASES = {
    "identical": lambda: (_with([]), _with([])),
    "boundary": lambda: _boundary_leaf(0),
    "nan_in_a": lambda: (_with([NAN]), _with([])),
    "nan_in_b": lambda: (_with([]), _with([NAN])),
    "nan_in_both": lambda: (_with([NAN]), _with([NAN])),
    "equal_infinities": lambda: (_with([INF, -INF]), _with([INF, -INF])),
    "opposite_infinities": lambda: (_with([INF, -INF]), _with([-INF, INF])),
    "inf_vs_finite": lambda: (_with([INF, 2.0]), _with([1.0, -INF])),
    "overflowing_difference": lambda: (_with([BIG, -BIG]), _with([-BIG, BIG])),
    "mixed": lambda: (_with([NAN, INF, 1.5, -INF]), _with([1.0, INF, 1.5001, 7.0])),
}


def _verdicts(tree_a, tree_b, total):
    fractions = [0.0, 1e-6] + [(j + 0.5) / total for j in range(12)]
    ref = [j_grid.grad_comparator(max_bad_fraction=f)({"grads": tree_a}, {"grads": tree_b})
           for f in fractions]
    ta, tb = (jax.tree_util.tree_map(torch.from_numpy, t) for t in (tree_a, tree_b))
    got = [grid_runtime.grad_comparator(max_bad_fraction=f)({"grads": ta}, {"grads": tb})
           for f in fractions]
    return got, ref


@pytest.mark.parametrize("case", sorted(CASES))
def test_grad_comparator_matches_reference(case):
    a, b = CASES[case]()
    # the crafted leaf beside a clean one, as in a gradient tree
    clean = _with([], n=33, seed=4)
    tree_a, tree_b = {"w": {"x": a}, "b": clean}, {"w": {"x": b}, "b": clean.copy()}
    launches = quorum_ops.launches
    got, ref = _verdicts(tree_a, tree_b, a.size + clean.size)
    assert got == ref
    assert quorum_ops.launches == launches  # CPU tensors: the plain version


def test_grad_comparator_boundary_counts_exactly():
    a, b = _boundary_leaf(1)
    want = int(np.count_nonzero(~np.isclose(a, b, rtol=RTOL, atol=ATOL)))
    n_bad, _ = quorum_ops.quorum_compare(torch.from_numpy(a), torch.from_numpy(b), rtol=RTOL, atol=ATOL)
    assert int(n_bad) == want and 0 < want < a.size


def test_grad_comparator_rejects_mismatched_trees():
    x = np.ones(8, np.float32)
    for ta, tb in (({"a": x}, {"a": x[:4]}), ({"a": x, "b": x}, {"a": x})):
        got, ref = _verdicts(ta, tb, 8)
        assert got == ref and not any(got)


def test_corruptor_picks_the_reference_leaf():
    shapes = {"layers": {"mlp": {"up": (3, 4), "gate": (3, 4)}, "attn_norm": {"scale": (4,)}},
              "embed": {"embedding": (5, 4)}, "final_norm": {"scale": (4,)}}
    tree = jax.tree_util.tree_map(lambda s: np.random.default_rng(len(s)).standard_normal(s).astype(np.float32),
                                  shapes, is_leaf=lambda x: isinstance(x, tuple))
    for seed in range(6):
        want = j_grid._grad_corruptor({"grads": tree, "loss": 1.0}, random.Random(seed))
        got = grid_runtime._grad_corruptor(
            {"grads": jax.tree_util.tree_map(torch.from_numpy, tree), "loss": 1.0}, random.Random(seed))
        assert got["loss"] == 1.0
        for w, g in zip(jax.tree_util.tree_leaves(want["grads"]),
                        jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, got["grads"]))):
            np.testing.assert_array_equal(g, w)


def test_engine_backends_are_numpy_only():
    # the grid trainer's middleware runs the NumPy engines (the default);
    # the port's other engine backend is "torch", and "jax" is the reference's
    assert backend.resolve_backend("numpy") == "numpy"
    assert backend.resolve_backend("torch") == "torch"
    assert backend.resolve_engine("numpy", "cuda") == ("numpy", None)
    with pytest.raises(ValueError, match="unknown backend"):
        backend.resolve_backend("jax")


def test_trainer_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the trainer runs on it")
    cfg = get_smoke_config("qwen3-0.6b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GridTrainer(cfg, DataConfig(vocab=cfg.vocab, seq_len=8, batch_size=1), AdamWConfig(), n_steps=1)


def _smoke(module, arch):
    """The smoke config of ``arch`` at f32; qwen3 cut to 2 layers at d = 64."""
    dtype = jnp.float32 if module is j_get_smoke_config else torch.float32
    if arch == "qwen3-0.6b":
        return module(arch).scaled(n_layers=2, d_model=64, dtype=dtype)
    return module(arch).scaled(dtype=dtype)


def _run_both(steps, arch="qwen3-0.6b"):
    j_reset_ids()
    jcfg = _smoke(j_get_smoke_config, arch)
    kw = dict(n_steps=steps, n_hosts=8, seed=0, adaptive_replication=True, error_prob=0.05,
              malicious_fraction=0.15, availability=0.9)
    jt = JGridTrainer(jcfg, JDataConfig(vocab=jcfg.vocab, seq_len=64, batch_size=4, n_shards=2, seed=3),
                      JAdamWConfig(lr=1e-3, warmup_steps=5, total_steps=40), **kw)
    params = jax.tree_util.tree_map(np.asarray, jt.params)  # exists before run()
    want = jt.run()
    reset_ids()
    tcfg = _smoke(get_smoke_config, arch)
    tt = GridTrainer(tcfg, DataConfig(vocab=tcfg.vocab, seq_len=64, batch_size=4, n_shards=2, seed=3),
                     AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=40),
                     params=params_from_jax(params, "cpu"), device="cpu", **kw)
    return tt.run(), want


def _assert_same_run(got, want, steps, loss_rtol):
    assert got.steps_completed == want.steps_completed == steps
    assert dataclasses.asdict(got.metrics) == dataclasses.asdict(want.metrics)
    assert got.metrics.wrong_accepted == 0
    assert got.credit_total == want.credit_total
    assert got.jobs_retried == want.jobs_retried
    assert got.virtual_time == want.virtual_time
    np.testing.assert_allclose(got.losses, want.losses, rtol=loss_rtol, atol=0)


def test_grid_run_matches_reference():
    got, want = _run_both(12)
    _assert_same_run(got, want, 12, LOSS_RTOL)
    assert got.final_loss < got.losses[0]


def test_ssm_grid_run_matches_reference():
    got, want = _run_both(STEPS_SSM, "mamba2-130m")
    _assert_same_run(got, want, STEPS_SSM, LOSS_RTOL)
    assert got.final_loss < got.losses[0]


def _runs_on_cpu_and_card(cfg, counter):
    """The same seeded 4-step grid run of ``cfg`` on the CPU and on the card,
    from the same parameters; ``counter()`` (a launch count) must move on
    the card only."""
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("no CUDA card of capability 9.0: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = []
    for device in ("cpu", "cuda"):
        reset_ids()
        params = GridTrainer(cfg, DataConfig(vocab=cfg.vocab, seq_len=64, batch_size=4), AdamWConfig(),
                             n_steps=1, device="cpu").params
        t = GridTrainer(cfg, DataConfig(vocab=cfg.vocab, seq_len=64, batch_size=4, n_shards=2, seed=3),
                        AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=40), n_steps=4, n_hosts=8,
                        seed=0, error_prob=0.05, malicious_fraction=0.15, availability=0.9,
                        params=params, device=device)
        launches = counter()
        runs.append(t.run())
        assert (counter() > launches) == (device == "cuda")
    cpu, card = runs
    assert card.steps_completed == cpu.steps_completed == 4
    assert dataclasses.asdict(card.metrics) == dataclasses.asdict(cpu.metrics)
    np.testing.assert_allclose(card.losses, cpu.losses, rtol=1e-4)


@pytest.mark.gpu
def test_grid_run_on_the_card_matches_the_cpu():
    _runs_on_cpu_and_card(_smoke(get_smoke_config, "qwen3-0.6b"), lambda: quorum_ops.launches)


@pytest.mark.gpu
def test_ssm_grid_run_on_the_card_matches_the_cpu():
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    _runs_on_cpu_and_card(_smoke(get_smoke_config, "mamba2-130m"), lambda: ssd_ops.launches_bwd)
