"""The port's training path against the reference's, on the CPU.

Both packages run from the same parameters (the reference's ``init_params``,
loaded with ``params_from_jax``) and the same ``make_batch`` batches, at f32
compute: the data pipeline byte for byte; the cross-entropy; ``train_loss``
and the gradient step (loss and every gradient leaf) with the CE chunked and
not, remat on and off; one and two AdamW updates (params, moments,
``lr``, ``grad_norm``); and the train step. The grad step also at the
default bf16 compute, for qwen3-smoke and hubert-smoke (frame embeddings),
loosely: each leaf within twice the reference's own bf16 error (see
``test_bf16_grad_step_matches_reference_loosely``). Tolerances: rtol=atol=1e-5 for
losses, optimizer state and learning rates, rtol=1e-4 with atol=1e-6 for
gradient leaves (f32 sums over 256 tokens taken in other orders), atol=1e-5
for the parameters after a train step (see ``test_train_step_matches``).

``remat_policy`` as the reference reads it: an unknown name raises
``KeyError``; under "nothing", "dots_nb" and "dots" the grads of the qwen3
and qwen3-moe smoke configs (remat on) equal the reference's under the same
policy, at the gradient tolerance above, and each other bit for bit (a
policy only chooses what is saved and what is computed again), and so do
the zamba2-smoke hybrid stack's (its groups and tail checkpointed).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_smoke_config as j_get_smoke_config  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import make_batch as j_make_batch  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import model_spec as j_model_spec  # noqa: E402
from repro.models.layers import cross_entropy_from_logits as j_ce  # noqa: E402
from repro.optim import adamw as j_adamw  # noqa: E402
from repro.runtime.step_builder import make_grad_step as j_make_grad_step  # noqa: E402
from repro.runtime.step_builder import make_train_step as j_make_train_step  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.data import DataConfig, DataShard, make_batch  # noqa: E402
from repro_torch.models import init_params, model_spec, params_from_jax  # noqa: E402
from repro_torch.models.layers import (  # noqa: E402
    cross_entropy_from_logits,
    tree_leaves,
    tree_unflatten,
)
from repro_torch.models.transformer import train_loss  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import make_grad_step, make_train_step  # noqa: E402

ARCH = "qwen3-0.6b"
SEQ, BATCH = 64, 4
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _np(x):
    return np.asarray(x.detach().float().cpu() if isinstance(x, torch.Tensor) else x, np.float32)


def _leaves(tree):
    return [_np(x) for x in tree_leaves(tree)]


def _configs(**overrides):
    jc = j_get_smoke_config(ARCH).scaled(dtype=jnp.float32, **overrides)
    tc = get_smoke_config(ARCH).scaled(dtype=torch.float32, **overrides)
    return jc, tc


@pytest.fixture(scope="module")
def ref_params():
    params = j_init_params(jax.random.PRNGKey(0), j_model_spec(j_get_smoke_config(ARCH)))
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def batch():
    return j_make_batch(JDataConfig(vocab=512, seq_len=SEQ, batch_size=BATCH, seed=3), 1, 2)


def _torch_batch(batch):
    return {k: torch.from_numpy(v.astype(np.int64)) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# data, config, cross-entropy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shard,step", [(0, 0), (1, 5), (3, 17)])
def test_make_batch_is_byte_identical(shard, step):
    kw = dict(vocab=151936, seq_len=96, batch_size=3, seed=11, n_shards=4)
    want = j_make_batch(JDataConfig(**kw), shard, step)
    got = make_batch(DataConfig(**kw), shard, step)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k
    shard_iter = DataShard(DataConfig(**kw), shard, step)
    assert next(shard_iter)["tokens"].tobytes() == want["tokens"].tobytes()


@pytest.mark.parametrize("getters", [(j_get_config, get_config), (j_get_smoke_config, get_smoke_config)])
def test_flop_accounting_matches(getters):
    jc, tc = (g(ARCH) for g in getters)
    assert tc.active_param_count() == jc.active_param_count()
    assert tc.train_flops_per_token() == jc.train_flops_per_token()


@pytest.mark.parametrize("valid_vocab,masked,reduce", [(0, False, True), (200, False, True),
                                                       (200, True, True), (200, True, False)])
def test_cross_entropy_matches(valid_vocab, masked, reduce):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((2, 7, 256)) * 3).astype(np.float32)
    labels = rng.integers(0, 200, size=(2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) > 0.3).astype(np.float32) if masked else None
    want = j_ce(jnp.asarray(logits), jnp.asarray(labels), None if mask is None else jnp.asarray(mask),
                valid_vocab=valid_vocab, reduce=reduce)
    got = cross_entropy_from_logits(torch.from_numpy(logits), torch.from_numpy(labels),
                                    None if mask is None else torch.from_numpy(mask),
                                    valid_vocab=valid_vocab, reduce=reduce)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# gradient step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("remat,ce_chunk", [(False, 512), (True, 512), (True, 16)])
def test_grad_step_matches(ref_params, batch, remat, ce_chunk):
    # ce_chunk=16 at SEQ=64 takes the chunked, rematerialized CE branch
    jc, tc = _configs(remat=remat, ce_chunk=ce_chunk)
    j_grads, j_metrics = jax.jit(j_make_grad_step(jc))(
        jax.tree_util.tree_map(jnp.asarray, ref_params), {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_jax(ref_params, "cpu")
    before = [p.clone() for p in tree_leaves(params)]
    grads, metrics = make_grad_step(tc)(params, _torch_batch(batch))
    for k in ("loss", "ce", "aux"):
        np.testing.assert_allclose(_np(metrics[k]), np.asarray(j_metrics[k]), rtol=1e-5, atol=1e-5)
    assert all(torch.equal(p, q) for p, q in zip(tree_leaves(params), before))  # params untouched
    assert jax.tree_util.tree_structure(j_grads) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, {k: v for k, v in grads.items()}))
    for g, w in zip(_leaves(grads), jax.tree_util.tree_leaves(j_grads)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, np.asarray(w), **GRAD_TOL)


# ---------------------------------------------------------------------------
# AdamW and the train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("schedule", ["cosine", "wsd", "constant"])
def test_lr_schedule_matches(schedule):
    jcfg = j_adamw.AdamWConfig(warmup_steps=10, total_steps=50, schedule=schedule)
    tcfg = adamw.AdamWConfig(warmup_steps=10, total_steps=50, schedule=schedule)
    for step in (0, 1, 9, 10, 30, 45, 50, 80):
        want = float(j_adamw.lr_at(jcfg, jnp.asarray(step, jnp.int32)))
        np.testing.assert_allclose(float(adamw.lr_at(tcfg, step)), want, rtol=1e-6)


@pytest.mark.parametrize("clip_norm", [1.0, 0.0])
def test_apply_updates_matches(clip_norm):
    rng = np.random.default_rng(5)
    shapes = {"a": {"w": (6, 5), "s": (5,)}, "b": (3, 4, 2)}
    mk = lambda scale: jax.tree_util.tree_map(  # noqa: E731
        lambda shp: (rng.standard_normal(shp) * scale).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple))
    params, grads1, grads2 = mk(1.0), mk(0.7), mk(0.2)
    jcfg = j_adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=clip_norm)
    tcfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=clip_norm)
    jp, js = jax.tree_util.tree_map(jnp.asarray, params), j_adamw.init_state(params)
    tp = params_from_jax(params, "cpu")
    ts = adamw.init_state(tp)
    for g in (grads1, grads2):
        jp, js, jm = j_adamw.apply_updates(jcfg, jp, jax.tree_util.tree_map(jnp.asarray, g), js)
        tg = params_from_jax(g, "cpu")
        tp2, ts, tm = adamw.apply_updates(tcfg, tp, tg, ts)
        assert tp2 is tp  # updated in place
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tg), tree_leaves(params_from_jax(g, "cpu"))))
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
        assert ts.count == int(js.count)
        for got, want in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
            for a, b in zip(_leaves(got), jax.tree_util.tree_leaves(want)):
                np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-7)


def test_train_step_matches(ref_params, batch):
    jc, tc = _configs()
    jcfg, tcfg = j_adamw.AdamWConfig(lr=1e-3, warmup_steps=1), adamw.AdamWConfig(lr=1e-3, warmup_steps=1)
    jp = jax.tree_util.tree_map(jnp.asarray, ref_params)
    jp, _, jm = jax.jit(j_make_train_step(jc, jcfg))(
        jp, j_adamw.init_state(jp), {k: jnp.asarray(v) for k, v in batch.items()})
    tp = params_from_jax(ref_params, "cpu")
    tp, ts, tm = make_train_step(tc, tcfg)(tp, adamw.init_state(tp), _torch_batch(batch))
    assert ts.count == 1
    for k in ("loss", "ce", "aux", "lr", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-6)
    # the first AdamW step is about lr * g / (|g| + eps): where |g| is near eps
    # (1e-8) the gradient's last bits move the update, whose size is lr = 1e-3
    for a, b in zip(_leaves(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", [ARCH, "hubert-xlarge"])
def test_bf16_grad_step_matches_reference_loosely(arch):
    # at bf16 compute the two packages round at other points (the port's
    # kernels once, from f32; the reference's SwiGLU in bf16, ROADMAP Queue
    # C 3), so neither equals the other: each lies its own rounding error
    # from the f32 result. If the port rounds no more than the reference,
    # the two differ by at most twice the reference's own error, taken
    # against its f32 grad step on the same batch (and a floor of 1e-3 of
    # the leaf's largest entry, bf16's half step); the loss likewise
    j_cfg = j_get_smoke_config(arch)
    params = jax.tree_util.tree_map(np.asarray, j_init_params(jax.random.PRNGKey(0), j_model_spec(j_cfg)))
    embeds = {"input_mode": "embeds", "d_model": j_cfg.d_model} if j_cfg.input_mode == "embeds" else {}
    batch = j_make_batch(JDataConfig(vocab=j_cfg.vocab, seq_len=SEQ, batch_size=BATCH, seed=3, **embeds),
                         1, 2)
    j_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    t_batch = {k: torch.from_numpy(v.astype(np.int64) if v.dtype.kind == "i" else v)
               for k, v in batch.items()}
    (j32, j32_m), (j16, j16_m) = (jax.jit(j_make_grad_step(j_cfg.scaled(dtype=dt)))(params, j_batch)
                                  for dt in (jnp.float32, jnp.bfloat16))
    t16, t16_m = make_grad_step(get_smoke_config(arch))(params_from_jax(params, "cpu"), t_batch)
    assert get_smoke_config(arch).dtype == torch.bfloat16
    ref_err = abs(float(j16_m["loss"]) - float(j32_m["loss"]))
    assert abs(float(t16_m["loss"]) - float(j16_m["loss"])) <= 2 * ref_err + 1e-3 * float(j32_m["loss"])
    leaves = zip(_leaves(t16), jax.tree_util.tree_leaves(j16), jax.tree_util.tree_leaves(j32))
    for i, (got, want, exact) in enumerate(leaves):
        want, exact = np.asarray(want, np.float32), np.asarray(exact)
        assert got.shape == want.shape == exact.shape
        bound = 2 * np.abs(want - exact).max() + 1e-3 * np.abs(exact).max()
        assert np.abs(got - want).max() <= bound, f"leaf {i}: {np.abs(got - want).max()} > {bound}"


def test_config_fields_unchanged_by_training_flags():
    # remat and ce_chunk are config fields of both packages, with the same defaults
    jc, tc = j_get_config(ARCH), get_config(ARCH)
    for f in ("remat", "ce_chunk", "remat_policy"):
        assert getattr(tc, f) == getattr(jc, f)
    assert {f.name for f in dataclasses.fields(tc)} == {f.name for f in dataclasses.fields(jc)}


@pytest.mark.gpu
def test_grad_step_on_the_card_matches_the_cpu(ref_params, batch):
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("no CUDA card of capability 9.0: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.swiglu import ops as swiglu_ops

    _, tc = _configs(remat=True, ce_chunk=16)
    step = make_grad_step(tc)
    cpu_grads, cpu_m = step(params_from_jax(ref_params, "cpu"), _torch_batch(batch))
    before = [m.launches_bwd for m in (rms_ops, swiglu_ops, flash_ops)]
    grads, m = step(params_from_jax(ref_params, "cuda"),
                    {k: v.cuda() for k, v in _torch_batch(batch).items()})
    torch.cuda.synchronize()
    assert all(mod.launches_bwd > b for mod, b in zip((rms_ops, swiglu_ops, flash_ops), before))
    np.testing.assert_allclose(float(m["loss"]), float(cpu_m["loss"]), rtol=1e-5)
    for g, w in zip(_leaves(grads), _leaves(cpu_grads)):
        np.testing.assert_allclose(g, w, **GRAD_TOL)


# ---------------------------------------------------------------------------
# remat policies
# ---------------------------------------------------------------------------

POLICIES = ["nothing", "dots_nb", "dots"]


def test_unknown_remat_policy_raises_as_the_reference_does(ref_params, batch):
    jc, tc = _configs(remat=True, remat_policy="bogus")
    with pytest.raises(KeyError, match="bogus"):
        j_make_grad_step(jc)(jax.tree_util.tree_map(jnp.asarray, ref_params),
                             {k: jnp.asarray(v) for k, v in batch.items()})
    with pytest.raises(KeyError, match="bogus"):
        make_grad_step(tc)(params_from_jax(ref_params, "cpu"), _torch_batch(batch))
    # read only where layers are rematerialized, as in the reference
    make_grad_step(tc.scaled(remat=False))(params_from_jax(ref_params, "cpu"), _torch_batch(batch))


@pytest.mark.parametrize("arch", [ARCH, "qwen3-moe-235b-a22b"])
def test_remat_policies_match_reference_and_each_other(batch, arch):
    j_base = j_get_smoke_config(arch).scaled(dtype=jnp.float32, remat=True)
    t_base = get_smoke_config(arch).scaled(dtype=torch.float32, remat=True)
    tree = jax.tree_util.tree_map(np.asarray, j_init_params(jax.random.PRNGKey(0), j_model_spec(j_base)))
    j_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    first = None
    for policy in POLICIES:
        j_grads, j_m = jax.jit(j_make_grad_step(j_base.scaled(remat_policy=policy)))(
            jax.tree_util.tree_map(jnp.asarray, tree), j_batch)
        grads, m = make_grad_step(t_base.scaled(remat_policy=policy))(
            params_from_jax(tree, "cpu"), _torch_batch(batch))
        for k in ("loss", "ce", "aux"):
            np.testing.assert_allclose(_np(m[k]), np.asarray(j_m[k]), rtol=1e-5, atol=1e-5)
        for g, w in zip(_leaves(grads), jax.tree_util.tree_leaves(j_grads)):
            np.testing.assert_allclose(g, np.asarray(w), **GRAD_TOL, err_msg=policy)
        if first is None:
            first = (m, tree_leaves(grads))
            continue
        assert all(torch.equal(m[k], first[0][k]) for k in m), policy
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(grads), first[1])), policy


def test_remat_policies_choose_what_is_computed_again():
    # the products the backward runs: the layers' recomputed ones go where a
    # policy saves them ("dots_nb": the projections' mm; "dots": the
    # experts' bmm too), so the bit-equality above is not a policy ignored
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountProducts(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = {"mm": 0, "bmm": 0}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if name in self.n:
                self.n[name] += 1
            return func(*args, **(kwargs or {}))

    counted = {}
    for policy in POLICIES:
        cfg = get_smoke_config("qwen3-moe-235b-a22b").scaled(dtype=torch.float32, remat=True,
                                                              remat_policy=policy)
        leaves = [p.requires_grad_() for p in tree_leaves(
            init_params(torch.Generator().manual_seed(0), model_spec(cfg), device="cpu"))]
        toks = torch.randint(0, cfg.vocab, (2, SEQ), generator=torch.Generator().manual_seed(1))
        loss, _ = train_loss(tree_unflatten(model_spec(cfg), leaves), cfg,
                             {"tokens": toks, "labels": toks})
        with CountProducts() as c:
            torch.autograd.grad(loss, leaves)
        counted[policy] = c.n
    assert counted["dots_nb"]["mm"] < counted["nothing"]["mm"]
    assert counted["dots_nb"]["bmm"] == counted["nothing"]["bmm"]
    assert counted["dots"]["mm"] == counted["dots_nb"]["mm"]
    # 2 layers x the experts' gate and up products
    assert counted["dots"]["bmm"] <= counted["dots_nb"]["bmm"] - 2 * 2


def test_remat_policies_agree_on_the_hybrid_stack():
    # zamba2-smoke: the groups' checkpoints and the tail's take the policy too
    cfg = get_smoke_config("zamba2-1.2b").scaled(dtype=torch.float32, remat=True)
    params = init_params(torch.Generator().manual_seed(0), model_spec(cfg), device="cpu")
    data = make_batch(DataConfig(vocab=cfg.vocab, seq_len=SEQ, batch_size=2, seed=1), 0, 0)
    runs = [make_grad_step(cfg.scaled(remat_policy=p))(params, _torch_batch(data)) for p in POLICIES]
    for grads, m in runs[1:]:
        assert torch.equal(m["loss"], runs[0][1]["loss"])
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(grads), tree_leaves(runs[0][0])))
