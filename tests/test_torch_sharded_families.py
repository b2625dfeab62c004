"""The sharded train step on a (4, 2) ("data", "model") mesh for the other
constraint sites, as ``test_torch_sharded_step.py`` holds qwen3-0.6b's:
mamba2-130m (the "chunks" and "mlp" constraints, ssd_scan on the mesh) and
qwen3-moe-235b-a22b (the "experts" constraints, the routing's indices made
whole) smoke configs in f32 without remat, 8 ranks simulated in one
process. The sharded loss lies within 5e-3 of the reference's single-device
``train_loss`` (the reference test's bound), and the sharded step matches
the port's unsharded one at ``test_torch_sharded_step.py``'s tolerances,
whose update check fails a step that skips its update or flips its sign.
"""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from test_torch_sharded_step import (  # noqa: E402
    check_planted_faults_fail,
    check_reference_loss,
    check_unsharded_step,
    sharded_and_unsharded,
)


@pytest.fixture(scope="module", params=["mamba2-130m", "qwen3-moe-235b-a22b"])
def run(request):
    return sharded_and_unsharded(request.param)


def test_sharded_loss_matches_the_reference_single_device_loss(run):
    check_reference_loss(run)


def test_sharded_step_matches_the_unsharded_step(run):
    check_unsharded_step(run)


def test_update_check_catches_a_skipped_or_flipped_update(run):
    check_planted_faults_fail(run)
