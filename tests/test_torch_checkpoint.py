"""The port's checkpointer and fault-tolerance copy against the reference's,
on the CPU.

* Cross-reading: the reference saves ``{"params", "opt"}`` (the train
  loop's trees: qwen3 smoke params at 2 layers, d=64, and an AdamW state
  after one update) and the port restores them; the port saves the same
  values and the reference restores them. Values are array-equal, the
  AdamW count comes back as the port's ``int`` and the reference's 0-d
  int32 array, and both packages write the same npz key sets, dtypes and
  shapes and the same manifest fields.
* The checksum, ``keep`` and policy cases of ``tests/test_substrate.py``
  (``TestCheckpoint``) on the port's checkpointer, and its
  ``TestFaultTolerance`` cases on the port's copy of ``fault_tolerance``.
"""
import json
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.configs import get_smoke_config as j_get_smoke_config  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import model_spec as j_model_spec  # noqa: E402
from repro.optim import adamw as j_adamw  # noqa: E402
from repro_torch.checkpoint import Checkpointer, CheckpointPolicy  # noqa: E402
from repro_torch.distributed import (  # noqa: E402
    HeartbeatMonitor,
    StragglerPolicy,
    candidate_meshes,
    plan_elastic_config,
)
from repro_torch.models import params_from_jax  # noqa: E402
from repro_torch.models.layers import tree_leaves  # noqa: E402
from repro_torch.optim import AdamWState  # noqa: E402


@pytest.fixture(scope="module")
def ref_trees():
    """The reference's train-loop trees after one AdamW update, as numpy."""
    cfg = j_get_smoke_config("qwen3-0.6b").scaled(n_layers=2, d_model=64)
    params = j_init_params(jax.random.PRNGKey(0), j_model_spec(cfg))
    grads = jax.tree_util.tree_map(lambda p: jnp.full_like(p, 0.01), params)
    params, opt, _ = j_adamw.apply_updates(j_adamw.AdamWConfig(), params, grads,
                                           j_adamw.init_state(params))
    return jax.tree_util.tree_map(np.asarray, {"params": params, "opt": opt})


def _port_trees(trees):
    opt = trees["opt"]
    return {"params": params_from_jax(trees["params"], "cpu"),
            "opt": AdamWState(count=int(opt.count), mu=params_from_jax(opt.mu, "cpu"),
                              nu=params_from_jax(opt.nu, "cpu"))}


def _zero_templates(trees):
    return _port_trees(jax.tree_util.tree_map(np.zeros_like, trees))


def _assert_trees_equal(port_tree, ref_tree):
    got = [x.numpy() for x in tree_leaves(port_tree)]
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(ref_tree)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_port_restores_reference_checkpoint(ref_trees):
    templates = _zero_templates(ref_trees)
    with tempfile.TemporaryDirectory() as d:
        JCheckpointer(d).save(5, ref_trees)
        step, out = Checkpointer(d).restore(templates)
    assert step == 5
    _assert_trees_equal(out["params"], ref_trees["params"])
    assert isinstance(out["opt"], AdamWState) and out["opt"].count == 1
    assert isinstance(out["opt"].count, int)
    _assert_trees_equal(out["opt"].mu, ref_trees["opt"].mu)
    _assert_trees_equal(out["opt"].nu, ref_trees["opt"].nu)


def test_reference_restores_port_checkpoint(ref_trees):
    port = _port_trees(ref_trees)
    templates = jax.tree_util.tree_map(np.zeros_like, ref_trees)
    with tempfile.TemporaryDirectory() as d:
        Checkpointer(d).save(7, port)
        step, out = JCheckpointer(d).restore(templates)
    assert step == 7
    assert out["opt"].count.dtype == np.int32 and int(out["opt"].count) == 1
    for g, w in zip(jax.tree_util.tree_leaves(out), jax.tree_util.tree_leaves(ref_trees)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_both_packages_write_the_same_files(ref_trees):
    port = _port_trees(ref_trees)
    with tempfile.TemporaryDirectory() as a, tempfile.TemporaryDirectory() as b:
        ja = JCheckpointer(a).save(3, ref_trees)
        tb = Checkpointer(b).save(3, port)
        assert os.path.basename(ja) == os.path.basename(tb) == "step_0000000003"
        assert sorted(os.listdir(ja)) == sorted(os.listdir(tb)) == ["manifest.json", "opt.npz",
                                                                    "params.npz"]
        for name in ("params", "opt"):
            with np.load(os.path.join(ja, f"{name}.npz")) as za, \
                    np.load(os.path.join(tb, f"{name}.npz")) as zb:
                assert sorted(za.files) == sorted(zb.files)
                for k in za.files:
                    assert za[k].dtype == zb[k].dtype and za[k].shape == zb[k].shape, k
                    np.testing.assert_array_equal(za[k], zb[k])
        with open(os.path.join(ja, "manifest.json")) as f:
            ma = json.load(f)
        with open(os.path.join(tb, "manifest.json")) as f:
            mb = json.load(f)
    assert set(ma) == set(mb) == {"step", "time", "files", "meta"}
    assert ma["files"].keys() == mb["files"].keys()
    for name in ma["files"]:
        assert set(ma["files"][name]) == set(mb["files"][name]) == {"file", "sha256", "n_arrays"}
        assert ma["files"][name]["n_arrays"] == mb["files"][name]["n_arrays"]
    assert mb["files"]["opt"]["n_arrays"] == 1 + 2 * mb["files"]["params"]["n_arrays"]


def test_bfloat16_leaf_raises():
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(TypeError, match="bfloat16"):
            Checkpointer(d).save(1, {"t": {"x": torch.zeros(3, dtype=torch.bfloat16)}})


class TestCheckpoint:
    def test_save_restore_roundtrip(self):
        with tempfile.TemporaryDirectory() as d:
            ck = Checkpointer(d)
            tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3), "n": np.asarray(3),
                    "c": 4}
            ck.save(10, {"params": tree})
            step, out = ck.restore({"params": {"w": torch.zeros(2, 3, dtype=torch.float64),
                                               "n": np.asarray(0), "c": 0}})
            assert step == 10
            assert out["params"]["w"].dtype == torch.float64  # the template's dtype
            np.testing.assert_array_equal(out["params"]["w"].numpy(), tree["w"].numpy())
            assert int(out["params"]["n"]) == 3 and out["params"]["c"] == 4

    def test_gc_keeps_latest(self):
        with tempfile.TemporaryDirectory() as d:
            ck = Checkpointer(d, keep=2)
            for s in (1, 2, 3, 4):
                ck.save(s, {"t": {"x": torch.zeros(1)}})
            assert ck.latest_step() == 4
            assert len(ck._steps()) == 2

    def test_checksum_validation(self):
        with tempfile.TemporaryDirectory() as d:
            ck = Checkpointer(d)
            path = ck.save(1, {"t": {"x": torch.ones(4, dtype=torch.float64)}})
            # corrupt the file (hash validation, §2.2/§3.10)
            fpath = os.path.join(path, "t.npz")
            with open(fpath, "r+b") as f:
                f.seek(30)
                f.write(b"\x00\x01\x02")
            with pytest.raises(IOError):
                ck.restore({"t": {"x": torch.zeros(4, dtype=torch.float64)}})

    def test_policy_cadence(self):
        p = CheckpointPolicy(period_steps=10)
        assert not p.should_checkpoint(5)
        assert p.should_checkpoint(10)


class TestFaultTolerance:
    def test_heartbeat_death_detection(self):
        mon = HeartbeatMonitor(period=10.0, max_misses=3)
        mon.register(1, 0.0)
        mon.register(2, 0.0)
        mon.heartbeat(1, 25.0)
        died = mon.sweep(35.0)
        assert died == [2]
        assert mon.live() == [1]

    def test_elastic_plan_preserves_global_batch(self):
        plan = plan_elastic_config(live_chips=256, global_batch=256, model_axis=16)
        assert plan is not None
        data_ways = plan.mesh_shape[0]
        assert data_ways * plan.microbatch_per_worker * plan.grad_accum_steps == 256
        # lose half the fleet: still plannable
        plan2 = plan_elastic_config(live_chips=128, global_batch=256, model_axis=16)
        assert plan2 is not None
        assert plan2.mesh_shape[0] == 8

    def test_candidate_meshes_shrink(self):
        shapes = candidate_meshes(256, model_axis=16)
        assert shapes[0] == (16, 16)
        assert (1, 16) in shapes

    def test_straggler_deadline_adapts(self):
        sp = StragglerPolicy(factor=3.0, min_samples=2)
        sp.observe(10.0)
        sp.observe(20.0)
        assert sp.deadline(100.0) == pytest.approx(100.0 + 45.0)

    def test_plans_equal_the_reference(self):
        from repro.distributed import candidate_meshes as j_candidate_meshes
        from repro.distributed import plan_elastic_config as j_plan

        for chips in (1, 16, 100, 128, 256, 1000):
            for pods in (1, 2):
                assert candidate_meshes(chips, 16, pods) == j_candidate_meshes(chips, 16, pods)
                for batch in (64, 256, 300):
                    got, want = plan_elastic_config(chips, batch, 16, pods), j_plan(chips, batch, 16, pods)
                    assert (got is None) == (want is None)
                    if got is not None:
                        assert (got.mesh_shape, got.microbatch_per_worker, got.grad_accum_steps) == \
                            (want.mesh_shape, want.microbatch_per_worker, want.grad_accum_steps)
