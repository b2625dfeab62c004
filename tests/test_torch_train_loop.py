"""The port's training loop against the reference's, on the CPU.

Smoke qwen3 at 2 layers, d=64, f32 compute, ``DataConfig(seq_len=32,
batch_size=4, seed=1)``, ``AdamWConfig(lr=1e-3, warmup_steps=2,
total_steps=20)`` (the case of ``tests/test_coordinator.py``'s elastic
scenario):

* the reference's ``train`` and the port's, started from the reference's
  initial parameters, run 6 steps with a checkpoint every 3: losses to
  rtol 1e-5;
* the port resumes from the reference's step-6 checkpoint and runs to step
  10, and the reference resumes from the port's: each gives the reference's
  own resumed losses to rtol 1e-5;
* the elastic restart scenario (checkpoint, shrink the mesh plan, resume)
  on the port, with the port's ``plan_elastic_config``;
* ``mamba2-smoke`` at f32 on the same data and optimizer: 4 steps of each
  package's ``train`` from the reference's initial parameters, losses to
  rtol 1e-5.
"""
import os
import shutil
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_get_smoke_config  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import model_spec as j_model_spec  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.runtime import train as j_train  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data import DataConfig  # noqa: E402
from repro_torch.distributed import plan_elastic_config  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.runtime import TrainResult, train  # noqa: E402

LOSS_RTOL = 1e-5
SCALE = dict(n_layers=2, d_model=64)
DATA = dict(seq_len=32, batch_size=4, seed=1)
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=20)


def _configs():
    jc = j_get_smoke_config("qwen3-0.6b").scaled(dtype=jnp.float32, **SCALE)
    tc = get_smoke_config("qwen3-0.6b").scaled(dtype=torch.float32, **SCALE)
    return jc, tc


def _ref_train(steps, d):
    jc, _ = _configs()
    return j_train(jc, JDataConfig(vocab=jc.vocab, **DATA), JAdamWConfig(**OPT), steps=steps,
                   checkpoint_dir=d, checkpoint_period=3, log_every=0)


def _port_train(steps, d, **kw):
    _, tc = _configs()
    return train(tc, DataConfig(vocab=tc.vocab, **DATA), AdamWConfig(**OPT), steps=steps,
                 checkpoint_dir=d, checkpoint_period=3, log_every=0, device="cpu", **kw)


@pytest.fixture(scope="module")
def runs():
    """The reference's 6 steps and its resume to 10; a copy of its step-6
    checkpoint taken between the two; the port's 6 steps from the
    reference's initial parameters."""
    root = tempfile.mkdtemp()
    try:
        ref_dir, copy_dir, port_dir = (os.path.join(root, n) for n in ("ref", "copy", "port"))
        r6 = _ref_train(6, ref_dir)
        shutil.copytree(ref_dir, copy_dir)
        r10 = _ref_train(10, ref_dir)
        jc, _ = _configs()
        init = jax.tree_util.tree_map(np.array, j_init_params(jax.random.PRNGKey(0), j_model_spec(jc)))
        p6 = _port_train(6, port_dir, params=init)
        yield dict(r6=r6, r10=r10, p6=p6, copy_dir=copy_dir, port_dir=port_dir)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def test_losses_match_reference(runs):
    r6, p6 = runs["r6"], runs["p6"]
    assert isinstance(p6, TrainResult) and p6.steps == 6 and p6.restored_from is None
    np.testing.assert_allclose(p6.losses, r6.losses, rtol=LOSS_RTOL)
    assert len(p6.step_seconds) == 6 and len(p6.save_seconds) == 2  # steps 3 and 6
    assert sorted(os.listdir(runs["port_dir"])) == ["step_0000000003", "step_0000000006"]


def test_port_resumes_from_reference_checkpoint(runs):
    p10 = _port_train(10, runs["copy_dir"])
    assert p10.restored_from == 6 and p10.steps == 4 and p10.restore_seconds is not None
    np.testing.assert_allclose(p10.losses, runs["r10"].losses, rtol=LOSS_RTOL)


def test_reference_resumes_from_port_checkpoint(runs):
    r10 = _ref_train(10, runs["port_dir"])
    assert r10.restored_from == 6 and r10.steps == 4
    np.testing.assert_allclose(r10.losses, runs["r10"].losses, rtol=LOSS_RTOL)


def test_checkpoint_then_smaller_mesh_resume():
    """Churn half the fleet: plan a smaller mesh, restore the checkpoint,
    keep training (the reference's fleet-level restart scenario)."""
    cfg = get_smoke_config("qwen3-0.6b").scaled(**SCALE)
    dc = DataConfig(vocab=cfg.vocab, **DATA)
    oc = AdamWConfig(**OPT)
    with tempfile.TemporaryDirectory() as d:
        r1 = train(cfg, dc, oc, steps=6, checkpoint_dir=d, checkpoint_period=3, log_every=0,
                   device="cpu")
        plan = plan_elastic_config(live_chips=128, global_batch=256, model_axis=16)
        assert plan is not None
        assert plan.mesh_shape[0] * plan.microbatch_per_worker * plan.grad_accum_steps == 256
        r2 = train(cfg, dc, oc, steps=10, checkpoint_dir=d, checkpoint_period=3, log_every=0,
                   device="cpu")
        assert r2.restored_from == 6
        assert r2.final_loss < r1.losses[0]


def test_train_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: train runs on it")
    cfg = get_smoke_config("qwen3-0.6b").scaled(**SCALE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(cfg, DataConfig(vocab=cfg.vocab, **DATA), AdamWConfig(**OPT), steps=1, log_every=0)


def test_ssm_losses_match_reference():
    jc = j_get_smoke_config("mamba2-130m").scaled(dtype=jnp.float32)
    tc = get_smoke_config("mamba2-130m").scaled(dtype=torch.float32)
    want = j_train(jc, JDataConfig(vocab=jc.vocab, **DATA), JAdamWConfig(**OPT), steps=4, log_every=0)
    init = jax.tree_util.tree_map(np.array, j_init_params(jax.random.PRNGKey(0), j_model_spec(jc)))
    got = train(tc, DataConfig(vocab=tc.vocab, **DATA), AdamWConfig(**OPT), steps=4, log_every=0,
                params=init, device="cpu")
    assert got.steps == 4 and len(got.losses) == 4
    np.testing.assert_allclose(got.losses, want.losses, rtol=LOSS_RTOL)
    assert got.final_loss < got.losses[0]
