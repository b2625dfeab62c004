"""The port's MoE layer and the moe stack against the reference's, on the
CPU at the smoke sizes (``qwen3-moe-smoke``: 8 experts top-2 with
qk-norm; ``llama4-smoke``: 4 experts top-1 and a shared expert).

Both packages run from the same parameters (the reference's ``init_params``,
loaded with ``params_from_jax``) and the same numpy-made inputs, at f32
compute. Held here: the capacity and the per-block positions (integers,
equal); the top-k rule on tied probabilities (equal to ``jax.lax.top_k``'s:
lower index first); ``moe_forward``'s output and aux loss with the
assignment count divisible by the 16 dispatch blocks and not, with a
capacity factor that drops assignments, and with tied router columns
(rtol=atol=1e-5); the no-cache logits and the prefill-then-decode logits
with dropless capacity (1e-4; the twin of the reference's
``tests/test_models.py::test_moe_decode_matches_with_dropless_capacity``,
since capacity, and so what is dropped, depends on the token count); and
one gradient step, loss, ce, aux (1e-5) and every gradient leaf (rtol=1e-4
and atol 1e-4 of the leaf's largest entry: at llama4-smoke both packages'
f32 embedding gradients lie about 5e-5 of its largest entry from the
reference's float64 gradient, so that is how far apart f32 can put them).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_get_smoke_config  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import make_batch as j_make_batch  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import model_spec as j_model_spec  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.models.transformer import init_cache as j_init_cache  # noqa: E402
from repro.models.transformer import moe_config as j_moe_config  # noqa: E402
from repro.runtime.step_builder import make_grad_step as j_make_grad_step  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import forward, init_cache, params_from_jax  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.layers import tree_leaves  # noqa: E402
from repro_torch.models.transformer import moe_config  # noqa: E402
from repro_torch.runtime import make_grad_step  # noqa: E402

ARCHS = ["qwen3-moe-235b-a22b", "llama4-scout-17b-a16e"]
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else x, np.float32)


def _configs(arch, **overrides):
    return (j_get_smoke_config(arch).scaled(dtype=jnp.float32, **overrides),
            get_smoke_config(arch).scaled(dtype=torch.float32, **overrides))


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    arch = request.param
    params = j_init_params(jax.random.PRNGKey(0), j_model_spec(j_get_smoke_config(arch)))
    params = jax.tree_util.tree_map(np.asarray, params)
    return arch, params


def _layer_moe(params, layer=0):
    return {k: v[layer] for k, v in params["layers"]["moe"].items()}


def _x(seed, b, s, d):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


def _moe_both(arch, params, x, **overrides):
    jc, tc = _configs(arch, **overrides)
    lp = _layer_moe(params)
    j_out, j_aux = jax.jit(lambda p, v: j_moe.moe_forward(p, v, j_moe_config(jc)))(
        jax.tree_util.tree_map(jnp.asarray, lp), jnp.asarray(x))
    out, aux = moe.moe_forward(params_from_jax(lp, "cpu"), torch.from_numpy(x), moe_config(tc))
    return (out, aux), (j_out, j_aux), moe_config(tc)


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flatten(v, f"{prefix}{k}/").items()}
    return {prefix[:-1]: tree}


def test_params_from_jax_keeps_the_moe_tree(setup):
    # the stacked (L, E, d, f) expert weights cross bit for bit, key for key
    arch, params = setup
    cfg = get_smoke_config(arch)
    want, got = _flatten(params), _flatten(params_from_jax(params, "cpu"))
    assert sorted(got) == sorted(want)
    for key, arr in want.items():
        assert tuple(got[key].shape) == arr.shape, key
        np.testing.assert_array_equal(got[key].numpy(), arr, err_msg=key)
    assert got["layers/moe/w_gate"].shape == (cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_expert)
    assert ("layers/moe/shared_gate" in got) == bool(cfg.n_shared_experts)


# ---------------------------------------------------------------------------
# routing pieces: capacity, positions, top-k ties
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_tokens", [1, 4, 37, 64, 700, 4096])
def test_capacity_matches_reference(setup, n_tokens):
    arch, _ = setup
    jc, tc = _configs(arch)
    for cf in (0.1, 1.25, 4.0):
        assert moe.capacity(n_tokens, moe_config(tc.scaled(capacity_factor=cf))) == \
            j_moe.capacity(n_tokens, j_moe_config(jc.scaled(capacity_factor=cf)))


@pytest.mark.parametrize("n_tokens", [1, 4, 37, 64, 700, 4096])
def test_dispatch_shape_follows_reference_rule(setup, n_tokens):
    # the reference's moe_forward: 16 blocks when they divide the n_tokens * k
    # assignments, else 1, each of max(8, ceil(capacity / blocks)) slots
    arch, _ = setup
    jc, tc = _configs(arch)
    for cf in (0.1, 1.25, 4.0):
        jm = j_moe_config(jc.scaled(capacity_factor=cf))
        blocks = jm.dispatch_blocks if (n_tokens * jm.top_k) % jm.dispatch_blocks == 0 else 1
        want = (blocks, max(8, -(-j_moe.capacity(n_tokens, jm) // blocks)))
        assert moe.dispatch_shape(n_tokens, moe_config(tc.scaled(capacity_factor=cf))) == want


def test_dispatch_shape_of_full_width_qwen3_moe():
    # a 700-token prefill and a 4-slot decode step both fill 16 blocks of 8
    # slots an expert: 128 x 128 = 16 384 expert rows
    mcfg = moe_config(get_config("qwen3-moe-235b-a22b"))
    assert moe.dispatch_shape(700, mcfg) == (16, 8)
    assert moe.dispatch_shape(4, mcfg) == (16, 8)


@pytest.mark.parametrize("n,blocks", [(64, 16), (74, 1), (5600, 16)])
def test_positions_match_reference(n, blocks):
    flat_e = np.random.default_rng(n).integers(0, 8, size=n).astype(np.int32)
    want = j_moe._position_in_expert_blocked(jnp.asarray(flat_e), 8, blocks)
    got = moe._position_in_expert_blocked(torch.from_numpy(flat_e.astype(np.int64)), 8, blocks)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_top_k_breaks_ties_as_jax_does():
    # lower index first among equal probabilities, as jax.lax.top_k; torch.topk
    # picks another order
    probs = np.array([[0.1, 0.3, 0.3, 0.3, 0.0, 0.3]], np.float32)
    rng = np.random.default_rng(1)
    tied = (rng.integers(0, 4, size=(64, 16)) / 4.0).astype(np.float32)  # many ties
    for p, k in ((probs, 3), (tied, 1), (tied, 2), (tied, 8)):
        want_w, want_e = jax.lax.top_k(jnp.asarray(p), k)
        got_w, got_e = moe.top_k(torch.from_numpy(p), k)
        np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
        np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    assert moe.top_k(torch.from_numpy(probs), 3)[1].tolist() == [[1, 2, 3]]


# ---------------------------------------------------------------------------
# moe_forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,s", [(2, 16), (1, 37)], ids=["blocks16", "blocks1"])
def test_moe_forward_matches_reference(setup, b, s):
    arch, params = setup
    x = _x(b * s, b, s, 64)
    (out, aux), (j_out, j_aux), mcfg = _moe_both(arch, params, x)
    n = b * s * mcfg.top_k
    assert (n % mcfg.dispatch_blocks == 0) == (s == 16)  # both dispatch-block branches
    np.testing.assert_allclose(_np(out), np.asarray(j_out), **TOL)
    np.testing.assert_allclose(float(aux), float(j_aux), **TOL)


def test_moe_forward_drops_like_the_reference(setup):
    arch, params = setup
    # 100 tokens (one dispatch block): 8 slots an expert, about 25 (top-2
    # of 8) or 25 (top-1 of 4) assignments each
    x = _x(5, 2, 50, 64)
    (out, aux), (j_out, j_aux), mcfg = _moe_both(arch, params, x, capacity_factor=0.1)
    # assignments were dropped: their tokens' outputs lose a term
    full_out, full_aux = moe.moe_forward(params_from_jax(_layer_moe(params), "cpu"),
                                         torch.from_numpy(x),
                                         dataclasses.replace(mcfg, capacity_factor=100.0))
    assert not torch.allclose(out, full_out)
    assert float(aux) == float(full_aux)  # the aux loss does not depend on capacity
    np.testing.assert_allclose(_np(out), np.asarray(j_out), **TOL)
    np.testing.assert_allclose(float(aux), float(j_aux), **TOL)


def test_moe_forward_with_tied_router_columns(setup):
    # experts 1 and 3 copy experts 0 and 2's router columns: every token's
    # probabilities tie in pairs, and the chosen experts and their order
    # must be jax.lax.top_k's
    arch, params = setup
    params = jax.tree_util.tree_map(np.copy, params)
    router = params["layers"]["moe"]["router"]
    router[:, :, 1] = router[:, :, 0]
    router[:, :, 3] = router[:, :, 2]
    x = _x(9, 2, 16, 64)
    jc, tc = _configs(arch)
    xf = torch.from_numpy(x.reshape(-1, 64))
    _, top_e, probs = moe.route(xf, torch.from_numpy(router[0]), moe_config(tc))
    p = probs.numpy()
    assert np.array_equal(p[:, 1], p[:, 0]) and np.array_equal(p[:, 3], p[:, 2])
    j_logits = jnp.asarray(x.reshape(-1, 64)) @ jnp.asarray(router[0])
    j_probs = jax.nn.softmax(j_logits.astype(jnp.float32), axis=-1)
    assert np.array_equal(np.asarray(j_probs)[:, 1], np.asarray(j_probs)[:, 0])
    _, j_top_e = jax.lax.top_k(j_probs, jc.top_k)
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(j_top_e))
    # the tie decides: with top-1, expert 0 or 2 wins every tied pair
    (out, aux), (j_out, j_aux), _ = _moe_both(arch, params, x)
    np.testing.assert_allclose(_np(out), np.asarray(j_out), **TOL)
    np.testing.assert_allclose(float(aux), float(j_aux), **TOL)


# ---------------------------------------------------------------------------
# the moe stack: forward, prefill then decode, gradients
# ---------------------------------------------------------------------------


def test_forward_without_cache_matches_reference(setup):
    arch, params = setup
    jc, tc = _configs(arch)
    toks = np.random.default_rng(3).integers(0, jc.vocab, size=(2, 37)).astype(np.int32)
    j_logits, _, j_aux = jax.jit(lambda p, t: j_forward(p, jc, tokens=t))(params, jnp.asarray(toks))
    logits, cache, aux = forward(params_from_jax(params, "cpu"), tc, torch.as_tensor(toks).long())
    assert cache is None and logits.shape == (2, 37, jc.padded_vocab)
    np.testing.assert_allclose(_np(logits), np.asarray(j_logits), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(aux), float(j_aux), **TOL)


def test_prefill_then_decode_with_dropless_capacity(setup):
    # capacity depends on the token count, so a prefill of 16 tokens and a
    # decode step of 2 drop differently; with capacity for every assignment
    # the decode step equals the full forward's last position, in both
    # packages, and the port's equals the reference's
    arch, params = setup
    cfg0 = get_smoke_config(arch)
    cf = float(cfg0.n_experts) / cfg0.top_k
    jc, tc = _configs(arch, capacity_factor=cf)
    toks = np.random.default_rng(4).integers(0, jc.vocab, size=(2, 17)).astype(np.int32)
    tp = params_from_jax(params, "cpu")
    jt, tt = jnp.asarray(toks), torch.as_tensor(toks).long()
    j_full, _, _ = j_forward(params, jc, tokens=jt)
    j_cache = j_init_cache(jc, 2, 32)
    _, j_cache, _ = j_forward(params, jc, tokens=jt[:, :16], cache=j_cache, cache_index=jnp.asarray(0))
    j_dec, j_cache, _ = j_forward(params, jc, tokens=jt[:, 16:17], cache=j_cache,
                                  cache_index=jnp.asarray(16))
    full, _, _ = forward(tp, tc, tt)
    cache = init_cache(tc, 2, 32, device="cpu")
    _, cache, _ = forward(tp, tc, tt[:, :16], cache=cache, cache_index=0)
    dec, cache, _ = forward(tp, tc, tt[:, 16:17], cache=cache, cache_index=16)
    a, b = _np(full[:, 16, : tc.vocab]), _np(dec[:, 0, : tc.vocab])
    assert np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-9) < 2e-3  # the reference test's bound
    np.testing.assert_allclose(_np(dec), np.asarray(j_dec), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(full), np.asarray(j_full), rtol=1e-4, atol=1e-4)
    for leaf in ("k", "v"):
        np.testing.assert_allclose(_np(cache["layers"][leaf]), np.asarray(j_cache["layers"][leaf]),
                                   rtol=1e-4, atol=1e-4, err_msg=leaf)


@pytest.mark.parametrize("seq", [64, 37], ids=["blocks16", "blocks1"])
def test_grad_step_matches_reference(setup, seq):
    # the loss is ce + aux (the layers' load-balancing losses, summed)
    arch, params = setup
    jc, tc = _configs(arch)
    batch = j_make_batch(JDataConfig(vocab=jc.vocab, seq_len=seq, batch_size=2, seed=3), 0, 0)
    j_grads, j_m = jax.jit(j_make_grad_step(jc))(
        jax.tree_util.tree_map(jnp.asarray, params), {k: jnp.asarray(v) for k, v in batch.items()})
    grads, m = make_grad_step(tc)(params_from_jax(params, "cpu"),
                                  {k: torch.from_numpy(v.astype(np.int64)) for k, v in batch.items()})
    assert float(m["aux"]) > 0
    for k in ("loss", "ce", "aux"):
        np.testing.assert_allclose(float(m[k]), float(j_m[k]), **TOL, err_msg=k)
    leaves = tree_leaves(grads)
    j_leaves = jax.tree_util.tree_leaves(j_grads)
    assert len(leaves) == len(j_leaves)
    for g, w in zip(leaves, j_leaves):
        assert tuple(g.shape) == w.shape
        w = np.asarray(w)
        np.testing.assert_allclose(_np(g), w, rtol=1e-4, atol=1e-4 * np.abs(w).max())
