"""The sharded train step on a (4, 2) ("data", "model") mesh, on the CPU in
one process: twin of ``tests/test_sharding.py::test_multidevice_train_step_matches_single_device``.

The reference runs its step on 8 fake XLA devices in a subprocess; here the
8 ranks of a ``fake`` process group are simulated in this process
(``launch.mesh.simulated_ranks``: ``LocalTensorMode``, which runs every
rank's shard of each op and computes the collectives from the shards), so
no subprocess, port or socket is used. For the qwen3-0.6b smoke config in
f32 without remat (``test_torch_sharded_families.py`` holds mamba2-130m
and qwen3-moe-235b-a22b the same way, in a file of its own to keep each
file's time small), from the reference's ``init_params(PRNGKey(0))`` and
``global_batch`` (64 tokens x 8 sequences, seed 3):

* the sharded loss lies within the reference test's 5e-3 of the
  reference's single-device ``train_loss``;
* against the port's own unsharded step from the same parameters: the loss
  to 1e-5 (relative), every first moment (AdamW's ``mu``, 0.1 x the clipped
  gradient) to 1e-4 of its leaf's largest entry (the same sums in other
  orders), and every parameter's update (``p8 - p0`` against ``p1 - p0``)
  to 0.1 x the first step's learning rate lr beyond what the two steps'
  gradients explain. AdamW's first update is
  ``-lr * (g / (|g| + eps) + wd * p)``, about lr in size on every element;
  the two gradients (``mu / (1 - b1)``) explain
  ``lr * |s(g8) - s(g1)|`` of the difference, ``s(g) = g / (|g| + eps)``:
  nothing where the gradient is settled, up to 2 x lr where it is rounding
  noise near 0 or near eps. A step that skips its update, or applies it
  with the wrong sign, fails
  (``test_update_check_catches_a_skipped_or_flipped_update``);
* the params, moments and batch sit on the placements the sharding rules
  give (``shardings_from_specs``).

The kernel wrappers are held on DTensors of chosen placements against their
plain versions on whole tensors, forward and backward: rows kept, a split
last dimension gathered (rmsnorm), K/V following the query heads or raising
(flash attention), the sequence gathered (ssd_scan). No process group is
left initialised after any test.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro.configs import get_smoke_config as ref_get_smoke_config  # noqa: E402
from repro.data import DataConfig as RefDataConfig  # noqa: E402
from repro.data import global_batch as ref_global_batch  # noqa: E402
from repro.models import init_params as ref_init_params  # noqa: E402
from repro.models import model_spec as ref_model_spec  # noqa: E402
from repro.models import train_loss as ref_train_loss  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data import DataConfig, global_batch  # noqa: E402
from repro_torch.distributed.sharding import shardings_from_specs  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.rmsnorm.ops import rmsnorm  # noqa: E402
from repro_torch.kernels.ssd_scan.ops import ssd_scan  # noqa: E402
from repro_torch.kernels.swiglu.ops import swiglu  # noqa: E402
from repro_torch.launch.mesh import make_mesh, simulated_ranks, single_device_mesh  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402
from repro_torch.models.layers import tree_leaves  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, init_state, lr_at  # noqa: E402
from repro_torch.runtime.step_builder import build_step  # noqa: E402

MESH, AXES = (4, 2), ("data", "model")
WORLD = 8
SHAPE = ShapeConfig("t", 64, 8, "train")


def _whole(t):
    """A DTensor's (or a simulated rank's) value as one plain tensor."""
    if hasattr(t, "full_tensor"):
        t = t.full_tensor()
    if hasattr(t, "reconcile"):
        t = t.reconcile()
    return t.detach()


@pytest.fixture
def ranks():
    """The 8 ranks of a fake process group in this process: the (4, 2) mesh
    over them and the mode that simulates them; the group is destroyed on
    teardown."""
    with simulated_ranks(WORLD) as mode:
        yield make_mesh(MESH, AXES, "cpu"), mode
    assert not dist.is_initialized()


def sharded_and_unsharded(arch):
    """One arch: the reference's single-device loss, and the port's unsharded
    and sharded train steps from the same parameters and batch."""
    rcfg = ref_get_smoke_config(arch).scaled(dtype=jnp.float32, remat=False)
    ref_params = ref_init_params(jax.random.PRNGKey(0), ref_model_spec(rcfg))
    ref_batch = ref_global_batch(RefDataConfig(vocab=rcfg.vocab, seq_len=64, batch_size=8, seed=3), 0)
    ref_loss, _ = ref_train_loss(ref_params, rcfg, {k: jnp.asarray(v) for k, v in ref_batch.items()})

    cfg = get_smoke_config(arch).scaled(dtype=torch.float32, remat=False)
    batch_np = global_batch(DataConfig(vocab=cfg.vocab, seq_len=64, batch_size=8, seed=3), 0)
    assert all(np.array_equal(batch_np[k], ref_batch[k]) for k in ref_batch)
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch_np.items()}
    params_np = jax.tree_util.tree_map(np.asarray, ref_params)

    params = params_from_jax(params_np, "cpu")
    one = build_step(cfg, SHAPE, single_device_mesh("cpu"), donate=False)
    p1, o1, m1 = one(params, init_state(params), batch)

    params = params_from_jax(params_np, "cpu")
    with simulated_ranks(WORLD):
        mesh = make_mesh(MESH, AXES, "cpu")
        bundle = build_step(cfg, SHAPE, mesh, donate=False)
        p8, o8, m8 = bundle(params, init_state(params), batch)
        placed = {
            "params": [tuple(t.placements) for t in tree_leaves(p8)],
            "mu": [tuple(t.placements) for t in tree_leaves(o8.mu)],
            "want": [tuple(p) for p in tree_leaves(shardings_from_specs(mesh, bundle.param_pspecs))],
            "batch": [tuple(p) for p in bundle.in_shardings[2].values()],
        }
        sharded = {"loss": float(_whole(m8["loss"])), "params": [_whole(t) for t in tree_leaves(p8)],
                   "mu": [_whole(t) for t in tree_leaves(o8.mu)]}
    assert not dist.is_initialized()
    return {"arch": arch, "ref_loss": float(ref_loss), "loss": float(m1["loss"]),
            "params0": tree_leaves(params_from_jax(params_np, "cpu")), "params": tree_leaves(p1),
            "mu": tree_leaves(o1.mu), "sharded": sharded, "placed": placed}


def check_reference_loss(run):
    assert abs(run["sharded"]["loss"] - run["ref_loss"]) < 5e-3, (run["arch"], run["sharded"]["loss"],
                                                                   run["ref_loss"])


def unexplained_update(params0, want, got, mu, mu_got, cfg):
    """The largest difference between two first AdamW steps' updates of the
    parameters (``got - p0`` against ``want - p0``) beyond the part that
    their first moments (``mu``, ``mu_got``) explain."""
    lr = float(lr_at(cfg, 1))

    def direction(m):  # g / (|g| + eps) of g = m / (1 - b1): the first update's direction
        return m / (m.abs() + (1 - cfg.b1) * cfg.eps)

    worst = 0.0
    for p0, w, g, m1, m8 in zip(params0, want, got, mu, mu_got):
        explained = lr * (direction(m8) - direction(m1)).abs()
        worst = max(worst, float(((g - p0) - (w - p0)).abs().sub(explained).max()))
    return worst


def check_unsharded_step(run):
    sharded = run["sharded"]
    assert abs(sharded["loss"] - run["loss"]) <= 1e-5 * abs(run["loss"])
    for want, got in zip(run["mu"], sharded["mu"]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-4 * float(want.abs().max()) + 1e-12)
    cfg = AdamWConfig()
    lr = float(lr_at(cfg, 1))
    worst = unexplained_update(run["params0"], run["params"], sharded["params"], run["mu"], sharded["mu"], cfg)
    assert worst <= 0.1 * lr, f"an update differs by {worst / lr:.3g} x lr beyond its gradient's part"


@pytest.fixture(scope="module")
def run():
    return sharded_and_unsharded("qwen3-0.6b")


def test_sharded_loss_matches_the_reference_single_device_loss(run):
    check_reference_loss(run)


def test_sharded_step_matches_the_unsharded_step(run):
    check_unsharded_step(run)


def check_planted_faults_fail(run):
    """A sharded step that returns its parameters as they were, or applies
    the update with the wrong sign, fails ``check_unsharded_step``."""
    p0, p1 = run["params0"], run["params"]
    for bad in ([p.clone() for p in p0], [2 * a - b for a, b in zip(p0, p1)]):
        with pytest.raises(AssertionError, match="update differs"):
            check_unsharded_step({**run, "sharded": {**run["sharded"], "params": bad}})


def test_update_check_catches_a_skipped_or_flipped_update(run):
    check_planted_faults_fail(run)


def test_sharded_state_sits_on_the_rules_placements(run):
    from torch.distributed.tensor import Shard

    placed = run["placed"]
    assert placed["params"] == placed["want"] and placed["mu"] == placed["want"]
    assert any(Shard(0) in p and Shard(1) in p for p in placed["want"])  # FSDP and TP at once
    assert all(p[0] == Shard(0) for p in placed["batch"])  # the batch over "data"


def _dt(t, mesh, placements):
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, mesh.device_mesh, placements).requires_grad_()


def _plain_and_sharded(fn, inputs, placements, ranks, cot):
    """``fn`` on whole tensors (the simulation off) and on DTensors of
    ``placements``: the output and the input gradients of ``sum(out * cot)``
    as numpy arrays, the sharded ones made whole; and the output's
    placements."""
    mesh, mode = ranks
    with mode.disable():
        leaves = [t.clone().requires_grad_() for t in inputs]
        out = fn(*leaves)
        (out * cot).sum().backward()
        want = [out.detach().numpy()] + [t.grad.numpy() for t in leaves]
    dts = [_dt(t, mesh, pl) for t, pl in zip(inputs, placements)]
    out_d = fn(*dts)
    (out_d * _dt(cot, mesh, out_d.placements).detach()).sum().backward()
    got = [_whole(out_d).numpy()] + [_whole(t.grad).numpy() for t in dts]
    return want, got, out_d.placements


def _close(want, got, rtol, atol):
    for w, o in zip(want, got):
        np.testing.assert_allclose(o, w, rtol=rtol, atol=atol)


def test_kernel_wrappers_on_local_shards(ranks):
    from torch.distributed.tensor import Replicate, Shard

    g = torch.Generator().manual_seed(0)
    rep = (Replicate(), Replicate())

    def rnd(*shape):  # one tensor for every rank, not one a rank
        with ranks[1].disable():
            return torch.randn(*shape, generator=g)

    x, scale = rnd(8, 6, 16), rnd(16) + 1.0
    for pl in [(Shard(0), Shard(1)), (Shard(0), Shard(2))]:  # rows; a split width, gathered
        want, got, out_pl = _plain_and_sharded(lambda a, s: rmsnorm(a, s), [x, scale], [pl, rep],
                                               ranks, rnd(8, 6, 16))
        assert out_pl == (Shard(0), Shard(1) if pl[1] == Shard(1) else Replicate())
        _close(want, got, 1e-5, 1e-5)

    gate, up = rnd(8, 6, 10), rnd(8, 6, 10)
    want, got, _ = _plain_and_sharded(swiglu, [gate, up], [(Shard(0), Shard(2)), (Shard(1), Replicate())],
                                      ranks, rnd(8, 6, 10))
    _close(want, got, 1e-5, 1e-6)

    q, k, v = rnd(4, 12, 4, 8), rnd(4, 12, 2, 8), rnd(4, 12, 2, 8)
    heads = (Shard(0), Shard(2))
    want, got, out_pl = _plain_and_sharded(flash_attention, [q, k, v], [heads, (Shard(0), Shard(1)), rep],
                                           ranks, rnd(4, 12, 4, 8))
    assert out_pl == heads
    _close(want, got, 1e-5, 1e-5)
    mesh = ranks[0]
    with pytest.raises(ValueError, match="KV heads"):  # one KV head cannot split two ways
        flash_attention(_dt(q, mesh, heads), _dt(k[:, :, :1], mesh, rep), _dt(v[:, :, :1], mesh, rep))


def test_ssd_scan_on_local_shards_gathers_the_sequence(ranks):
    from torch.distributed.tensor import Replicate, Shard

    g = torch.Generator().manual_seed(1)
    b, s, h, p, gr, n = 4, 32, 4, 8, 2, 8
    with ranks[1].disable():  # one tensor for every rank, not one a rank
        x = torch.randn(b, s, h, p, generator=g)
        dt = torch.rand(b, s, h, generator=g) * 0.1 + 0.01
        A = -torch.rand(h, generator=g) - 0.5
        Bm, Cm = torch.randn(b, s, gr, n, generator=g), torch.randn(b, s, gr, n, generator=g)
        cot = torch.randn(b, s, h, p, generator=g)
    chunks = (Shard(0), Shard(1))  # the reference's ("batch", "chunks") split
    rep = (Replicate(), Replicate())

    def scan(*a):
        return ssd_scan(*a, block_q=8)[0]

    want, got, out_pl = _plain_and_sharded(scan, [x, dt, A, Bm, Cm], [chunks, chunks, rep, chunks, chunks],
                                           ranks, cot)
    assert out_pl == (Shard(0), Replicate())
    _close(want, got, 1e-4, 1e-5)


def test_gqa_repeats_kv_heads_that_cannot_follow_the_query_heads(ranks):
    # 4 query heads split over "model", 1 KV head that cannot be: K and V
    # are repeated to 4 heads and split as the queries (the reference's
    # sharded gather), and the output equals the unsharded attention's
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed.logical import logical_sharding_scope
    from repro_torch.distributed.sharding import distribute_tree, make_rules, param_specs
    from repro_torch.models.attention import AttnConfig, gqa_forward, gqa_spec
    from repro_torch.models.layers import init_params

    mesh, mode = ranks
    cfg = AttnConfig(n_heads=4, n_kv_heads=1, head_dim=8)
    spec = gqa_spec(16, 4, 1, 8)
    with mode.disable():
        params = init_params(torch.Generator().manual_seed(2), spec, device="cpu")
        x = torch.randn(4, 6, 16, generator=torch.Generator().manual_seed(3))
        pos = torch.arange(6)[None, :].expand(4, 6)
        want, _ = gqa_forward(params, x, cfg, pos)
    rules = make_rules(mesh)
    dparams = distribute_tree(mesh, params, shardings_from_specs(mesh, param_specs(rules, spec)))
    dx = _dt(x, mesh, (Shard(0), Replicate())).detach()
    with logical_sharding_scope(rules.spec_for):
        from torch.distributed.tensor.experimental import implicit_replication

        with implicit_replication():
            got, _ = gqa_forward(dparams, dx, cfg, pos)
    np.testing.assert_allclose(_whole(got).numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


def test_no_process_group_is_left_behind():
    assert not dist.is_initialized()
    with simulated_ranks(2):
        assert dist.is_initialized() and dist.get_world_size() == 2
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="world size 8"):
        make_mesh(MESH, AXES, "cpu")  # no group: the mesh says what it needs
