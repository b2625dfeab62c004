"""The frontend families (vlm ``pixtral-12b``, audio ``hubert-xlarge``)
against the reference, on the CPU at the smoke size.

Both packages run from the same parameters (the reference's ``init_params``,
loaded with ``params_from_jax``) and the same numpy-made embeddings and
tokens, at f32:

* hubert-smoke's ``make_encoder_step`` logits over a sequence of 37 frames
  (not a multiple of any attention tile), non-causal: a norm-wise relative
  error of at most 1e-5, and each element to rtol=atol=1e-4 (element by
  element both packages lie 1-2e-5 of the largest logit from the float64
  result, the norm-wise error between them is 4e-6); its grad step from an
  ``embeds`` batch against ``jax.value_and_grad`` of the reference's
  ``train_loss``: the loss to 1e-5, each gradient leaf to rtol 1e-4 with
  atol 1e-4 of the leaf's largest entry (``tests/test_torch_moe.py``'s
  gradient tolerance);
* pixtral-smoke's prefill from patch embeddings and four decode steps from
  tokens: logits and K/V caches to rtol=atol=1e-4
  (``tests/test_torch_model.py``'s f32 tolerance); its grad step from
  ``embeds`` as hubert's; and ``BatchServer``'s token streams, which must be
  identical;
* ``input_specs`` for every arch and every cell ``cell_supported`` admits:
  the same nesting, shapes and dtypes;
* the stubs: ``frame_embeddings`` is the reference's formula on the port's
  own draws; both stubs match the reference's in mean (0), variance (1 for
  patches, 0.5 for frames) and lag-1 autocorrelation along the sequence (0
  and 0.5) within 1e-2 over 8 x 4096 x 64 draws (each estimate's standard
  error is below 1.5e-3); equal generators give equal bits;
* a seeded hubert-smoke ``GridTrainer`` run (8 steps, 2 shards of 4 x 64
  frames, 8 hosts, 5% error, 15% malicious): steps, every ``SimMetrics``
  field, credit, retries and virtual time identical, losses to rtol 1e-5
  (``tests/test_torch_grid.py``'s pattern).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_smoke_config as j_get_smoke_config  # noqa: E402
from repro.core import reset_ids as j_reset_ids  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import make_batch as j_make_batch  # noqa: E402
from repro.models import SHAPES as J_SHAPES  # noqa: E402
from repro.models import cell_supported as j_cell_supported  # noqa: E402
from repro.models import frontends as j_frontends  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import model_spec as j_model_spec  # noqa: E402
from repro.models.transformer import init_cache as j_init_cache  # noqa: E402
from repro.models.transformer import train_loss as j_train_loss  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.runtime import GridTrainer as JGridTrainer  # noqa: E402
from repro.runtime import serve_loop as j_serve  # noqa: E402
from repro.runtime.step_builder import input_specs as j_input_specs  # noqa: E402
from repro.runtime.step_builder import make_decode_step as j_make_decode_step  # noqa: E402
from repro.runtime.step_builder import make_encoder_step as j_make_encoder_step  # noqa: E402
from repro.runtime.step_builder import make_prefill_step as j_make_prefill_step  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core import reset_ids  # noqa: E402
from repro_torch.data import DataConfig  # noqa: E402
from repro_torch.models import SHAPES, frontends, init_cache, params_from_jax  # noqa: E402
from repro_torch.models.layers import tree_leaves  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    GridTrainer,
    input_specs,
    make_decode_step,
    make_encoder_step,
    make_grad_step,
    make_prefill_step,
    serve_loop,
)

HUBERT, PIXTRAL = "hubert-xlarge", "pixtral-12b"
TOL = 1e-4  # f32 logits and caches, as tests/test_torch_model.py


def _np(x):
    return np.asarray(x.detach().float().cpu() if isinstance(x, torch.Tensor) else x, np.float32)


def _setup(arch):
    """Both packages' f32 smoke configs and the reference's parameters, as
    numpy (reference) and as the port's tree."""
    jc = j_get_smoke_config(arch).scaled(dtype=jnp.float32)
    tc = get_smoke_config(arch).scaled(dtype=torch.float32)
    params = jax.tree_util.tree_map(np.asarray, j_init_params(jax.random.PRNGKey(0), j_model_spec(jc)))
    return jc, tc, params, params_from_jax(params, "cpu")


def _embeds(seed, b, s, d):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


def _assert_grads_close(grads, j_grads):
    j_leaves = jax.tree_util.tree_leaves(j_grads)
    assert len(tree_leaves(grads)) == len(j_leaves)
    for g, w in zip(tree_leaves(grads), j_leaves):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(_np(g), w, rtol=1e-4, atol=1e-4 * np.abs(w).max())


# ---------------------------------------------------------------------------
# hubert: the encoder step and a grad step from frame embeddings
# ---------------------------------------------------------------------------


def test_hubert_encoder_logits_match_reference():
    jc, tc, params, port = _setup(HUBERT)
    assert not tc.causal and not tc.has_decode
    x = _embeds(1, 2, 37, jc.d_model)  # 37 frames: no multiple of a tile
    want = np.asarray(jax.jit(j_make_encoder_step(jc))(params, {"embeds": jnp.asarray(x)}))
    got = make_encoder_step(tc)(port, {"embeds": torch.from_numpy(x)})
    assert got.shape == want.shape == (2, 37, jc.padded_vocab)
    assert np.linalg.norm(_np(got) - want) <= 1e-5 * np.linalg.norm(want)
    np.testing.assert_allclose(_np(got), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", [HUBERT, PIXTRAL])
def test_grad_step_from_embeds_matches_reference(arch):
    jc, tc, params, port = _setup(arch)
    batch = j_make_batch(JDataConfig(vocab=jc.vocab, seq_len=48, batch_size=2, seed=3,
                                     input_mode="embeds", d_model=jc.d_model), 0, 0)
    assert sorted(batch) == ["embeds", "labels"] and batch["labels"].max() < jc.vocab
    (j_loss, j_parts), j_grads = jax.jit(jax.value_and_grad(
        lambda p, b: j_train_loss(p, jc, b), has_aux=True))(params, {k: jnp.asarray(v)
                                                                    for k, v in batch.items()})
    grads, m = make_grad_step(tc)(port, {"embeds": torch.from_numpy(batch["embeds"]),
                                         "labels": torch.from_numpy(batch["labels"].astype(np.int64))})
    np.testing.assert_allclose(float(m["loss"]), float(j_loss), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(m["ce"]), float(j_parts["ce"]), rtol=1e-5, atol=1e-5)
    _assert_grads_close(grads, j_grads)


# ---------------------------------------------------------------------------
# pixtral: prefill from patch embeddings, decode from tokens, serving
# ---------------------------------------------------------------------------


def test_pixtral_prefill_from_embeddings_then_decode_matches_reference():
    jc, tc, params, port = _setup(PIXTRAL)
    b, s, max_seq = 2, 20, 48
    x = _embeds(2, b, s, jc.d_model)
    j_logits, j_cache = jax.jit(j_make_prefill_step(jc))(
        params, {"embeds": jnp.asarray(x)}, j_init_cache(jc, b, max_seq))
    logits, cache = make_prefill_step(tc)(port, {"embeds": torch.from_numpy(x)},
                                          init_cache(tc, b, max_seq, device="cpu"))
    assert logits.shape == j_logits.shape == (b, 1, jc.padded_vocab)
    np.testing.assert_allclose(_np(logits), np.asarray(j_logits), rtol=TOL, atol=TOL)
    j_decode, decode = jax.jit(j_make_decode_step(jc)), make_decode_step(tc)
    rng = np.random.default_rng(4)
    for step in range(4):
        for leaf in ("k", "v"):
            np.testing.assert_allclose(_np(cache["layers"][leaf]), np.asarray(j_cache["layers"][leaf]),
                                       rtol=TOL, atol=TOL, err_msg=f"{leaf} before step {step}")
        toks = rng.integers(0, jc.vocab, size=(b, 1)).astype(np.int32)
        j_logits, j_cache = j_decode(params, jnp.asarray(toks), j_cache, jnp.asarray(s + step, jnp.int32))
        logits, cache = decode(port, torch.as_tensor(toks, dtype=torch.long), cache, s + step)
        np.testing.assert_allclose(_np(logits), np.asarray(j_logits), rtol=TOL, atol=TOL,
                                   err_msg=f"step {step}")
    for leaf in ("k", "v"):
        np.testing.assert_allclose(_np(cache["layers"][leaf]), np.asarray(j_cache["layers"][leaf]),
                                   rtol=TOL, atol=TOL, err_msg=leaf)


def _requests(module, vocab, n=8, max_new=10):
    rng = np.random.default_rng(0)
    return [module.Request(id=i, prompt=rng.integers(0, vocab, size=int(rng.integers(4, 24))).astype(np.int32),
                           max_new_tokens=max_new, deadline=float(rng.integers(1, 100)))
            for i in range(n)]


def test_pixtral_token_streams_match_reference():
    # the reference's BatchServer serves a vlm from token prompts (it has no
    # embeddings path), and so does the port's
    jc, tc, params, port = _setup(PIXTRAL)
    j_server = j_serve.BatchServer(jc, jax.tree_util.tree_map(jnp.asarray, params), batch_slots=4,
                                   max_seq=128)
    t_server = serve_loop.BatchServer(tc, port, batch_slots=4, max_seq=128, device="cpu")
    j_reqs, t_reqs = _requests(j_serve, jc.vocab), _requests(serve_loop, tc.vocab)
    for a, b in zip(j_reqs, t_reqs):
        j_server.submit(a)
        t_server.submit(b)
    jm, tm = j_server.run(), t_server.run()
    assert [r.tokens_out for r in t_reqs] == [r.tokens_out for r in j_reqs]
    assert (tm.requests_done, tm.tokens_generated, tm.decode_steps) == (
        jm.requests_done, jm.tokens_generated, jm.decode_steps)
    assert tm.requests_done == 8


def test_server_refuses_the_encoder_and_takes_a_tree_when_asked():
    _, tc, _, port = _setup(HUBERT)
    with pytest.raises(ValueError, match="encoder-only"):
        serve_loop.BatchServer(tc, port, device="cpu")
    _, tc, _, port = _setup(PIXTRAL)
    n_leaves = len(tree_leaves(port))
    kept = serve_loop.BatchServer(tc, port, device="cpu")
    assert len(tree_leaves(port)) == n_leaves  # the caller's tree stays whole
    taken = serve_loop.BatchServer(tc, port, device="cpu", take_params=True)
    assert port == {}  # every leaf went to the server
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(kept.params), tree_leaves(taken.params)))


# ---------------------------------------------------------------------------
# input_specs
# ---------------------------------------------------------------------------


def _spec_tree(tree):
    """The reference's ShapeDtypeStruct tree as nested (shape, dtype name)."""
    if isinstance(tree, dict):
        return {k: _spec_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple):  # the port's leaf
        return tuple(tree[0]), str(tree[1]).removeprefix("torch.")
    return tuple(tree.shape), jnp.dtype(tree.dtype).name


def _cells():
    cells = []
    for arch in J_ARCHS:
        for i, shape in enumerate(J_SHAPES):
            if j_cell_supported(j_get_config(arch), shape)[0]:
                cells.append(pytest.param(arch, i, id=f"{arch}-{shape.name}"))
    return cells


@pytest.mark.parametrize("arch,shape_index", _cells())
def test_input_specs_match_reference(arch, shape_index):
    want = _spec_tree(j_input_specs(j_get_config(arch), J_SHAPES[shape_index]))
    got = _spec_tree(input_specs(get_config(arch), SHAPES[shape_index]))
    assert got == want
    assert list(got) == list(want)  # the same keys in the same order


# ---------------------------------------------------------------------------
# the stubs
# ---------------------------------------------------------------------------

STAT_SHAPE = (8, 4096, 64)


def _stats(x):
    """Mean, variance and lag-1 autocorrelation along the sequence axis."""
    x = np.asarray(x, np.float64)
    a, b = x[:, :-1].ravel(), x[:, 1:].ravel()
    return x.mean(), x.var(), np.corrcoef(a, b)[0, 1]


def test_frame_embeddings_are_the_reference_formula_on_their_draws():
    b, s, d = 3, 11, 8
    got = frontends.frame_embeddings(torch.Generator().manual_seed(5), b, s, d, dtype=torch.float32,
                                     device="cpu")
    x = torch.randn((b, s, d), generator=torch.Generator().manual_seed(5)).numpy()
    want = np.float32(0.5) * x + np.float32(0.5) * np.roll(x, 1, axis=1)  # wraps around
    np.testing.assert_array_equal(got.numpy(), want)
    bf = frontends.frame_embeddings(torch.Generator().manual_seed(5), b, s, d, device="cpu")
    assert bf.dtype == torch.bfloat16 and torch.equal(bf, got.to(torch.bfloat16))
    shape, dtype = frontends.embed_input_spec(b, s, d)
    assert shape == (b, s, d) and dtype == torch.bfloat16 and tuple(bf.shape) == shape


@pytest.mark.parametrize("stub,var,lag1", [("patch_embeddings", 1.0, 0.0),
                                           ("frame_embeddings", 0.5, 0.5)])
def test_stubs_match_reference_statistics(stub, var, lag1):
    got = getattr(frontends, stub)(torch.Generator().manual_seed(0), *STAT_SHAPE, dtype=torch.float32,
                                   device="cpu")
    want = getattr(j_frontends, stub)(jax.random.PRNGKey(0), *STAT_SHAPE, dtype=jnp.float32)
    assert tuple(got.shape) == want.shape == STAT_SHAPE
    for stats in (_stats(got.numpy()), _stats(want)):
        np.testing.assert_allclose(stats, (0.0, var, lag1), atol=1e-2)


@pytest.mark.parametrize("stub", ["patch_embeddings", "frame_embeddings"])
def test_stubs_repeat_from_equal_generators(stub):
    fn = getattr(frontends, stub)
    a = fn(torch.Generator().manual_seed(7), 2, 33, 16, device="cpu")
    b = fn(torch.Generator().manual_seed(7), 2, 33, 16, device="cpu")
    c = fn(torch.Generator().manual_seed(8), 2, 33, 16, device="cpu")
    assert a.dtype == torch.bfloat16 and torch.equal(a, b) and not torch.equal(a, c)


def test_stubs_run_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the stubs run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        frontends.patch_embeddings(torch.Generator(), 1, 4, 8)


# ---------------------------------------------------------------------------
# a seeded hubert-smoke grid run
# ---------------------------------------------------------------------------

GRID_STEPS = 8


def test_hubert_grid_run_matches_reference():
    kw = dict(n_steps=GRID_STEPS, n_hosts=8, seed=0, adaptive_replication=True, error_prob=0.05,
              malicious_fraction=0.15, availability=0.9)
    data = dict(seq_len=64, batch_size=4, n_shards=2, seed=3, input_mode="embeds")
    j_reset_ids()
    jc = j_get_smoke_config(HUBERT).scaled(dtype=jnp.float32)
    jt = JGridTrainer(jc, JDataConfig(vocab=jc.vocab, d_model=jc.d_model, **data),
                      JAdamWConfig(lr=1e-3, warmup_steps=5, total_steps=40), **kw)
    params = jax.tree_util.tree_map(np.asarray, jt.params)
    want = jt.run()
    reset_ids()
    tc = get_smoke_config(HUBERT).scaled(dtype=torch.float32)
    got = GridTrainer(tc, DataConfig(vocab=tc.vocab, d_model=tc.d_model, **data),
                      AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=40),
                      params=params_from_jax(params, "cpu"), device="cpu", **kw).run()
    assert got.steps_completed == want.steps_completed == GRID_STEPS
    assert dataclasses.asdict(got.metrics) == dataclasses.asdict(want.metrics)
    assert got.metrics.wrong_accepted == 0
    assert got.credit_total == want.credit_total
    assert got.jobs_retried == want.jobs_retried
    assert got.virtual_time == want.virtual_time
    # the stub's frames carry nothing of the labels: the loss need not fall
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5, atol=0)
