"""The port's MLA attention and the minicpm3 stack against the reference's,
on the CPU at the smoke size (``minicpm3-smoke``: 4 heads, q/k heads of
16 + 8 = 24 lanes, V heads of 16, latent ranks 32 and 16).

Both packages run from the same parameters (the reference's ``init_params``,
loaded with ``params_from_jax``) and the same numpy-made inputs, at f32
compute. Held here, to rtol=atol=1e-4 (1e-5 for one layer): ``mla_forward``
without a cache, and with one (the prefill's output and the latent and
RoPE-key cache leaves it writes); the absorbed decode step against the
reference's and against the full forward's last position (the reference
test's bound, 2e-3 of the largest logit, and 1e-4 here); the cache shapes
and dtypes; and one gradient step, loss to 1e-5 and every gradient leaf to
rtol=1e-4 with atol 1e-4 of the leaf's largest entry (the bound of
``tests/test_torch_moe.py``; f32 rounding at these sizes).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_smoke_config as j_get_smoke_config  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import make_batch as j_make_batch  # noqa: E402
from repro.models import attention as j_attention  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import model_spec as j_model_spec  # noqa: E402
from repro.models.transformer import cache_spec as j_cache_spec  # noqa: E402
from repro.models.transformer import init_cache as j_init_cache  # noqa: E402
from repro.models.transformer import mla_config as j_mla_config  # noqa: E402
from repro.runtime.step_builder import make_grad_step as j_make_grad_step  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import cache_spec, forward, init_cache, params_from_jax  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.layers import tree_leaves  # noqa: E402
from repro_torch.models.transformer import mla_config  # noqa: E402
from repro_torch.runtime import make_grad_step  # noqa: E402

ARCH = "minicpm3-4b"
TOL = dict(rtol=1e-4, atol=1e-4)


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else x, np.float32)


def _configs(**overrides):
    return (j_get_smoke_config(ARCH).scaled(dtype=jnp.float32, **overrides),
            get_smoke_config(ARCH).scaled(dtype=torch.float32, **overrides))


@pytest.fixture(scope="module")
def ref_params():
    params = j_init_params(jax.random.PRNGKey(0), j_model_spec(j_get_smoke_config(ARCH)))
    return jax.tree_util.tree_map(np.asarray, params)


def _layer_attn(params, layer=0):
    return {k: v[layer] for k, v in params["layers"]["attn"].items()}


def test_params_from_jax_keeps_the_mla_tree(ref_params):
    got = params_from_jax(ref_params, "cpu")["layers"]["attn"]
    want = ref_params["layers"]["attn"]
    assert sorted(got) == sorted(want) == ["kv_a_norm", "q_a_norm", "wk_b", "wkv_a", "wo", "wq_a",
                                           "wq_b", "wv_b"]
    for key, arr in want.items():
        assert tuple(got[key].shape) == arr.shape, key
        np.testing.assert_array_equal(got[key].numpy(), arr, err_msg=key)
    assert got["wq_b"].shape == (2, 32, 4, 24) and got["wkv_a"].shape == (2, 64, 16 + 8)


@pytest.mark.parametrize("with_cache", [False, True], ids=["no_cache", "prefill"])
def test_mla_forward_matches_reference(ref_params, with_cache):
    jc, tc = _configs()
    jm, tm = j_mla_config(jc), mla_config(tc)
    assert tm.qk_nope_dim + tm.qk_rope_dim == 24 and tm.v_head_dim == 16
    lp = _layer_attn(ref_params)
    b, s, max_seq = 2, 21, 32
    x = np.random.default_rng(1).standard_normal((b, s, jc.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s)[None], (b, s))
    if with_cache:
        cache = {k: np.asarray(v)[0] for k, v in j_init_cache(jc, b, max_seq)["layers"].items()}
    else:
        cache = None
    j_out, j_cache = j_attention.mla_forward(
        jax.tree_util.tree_map(jnp.asarray, lp), jnp.asarray(x), jm, jnp.asarray(pos),
        None if cache is None else {k: jnp.asarray(v) for k, v in cache.items()},
        None if cache is None else jnp.asarray(0))
    t_cache = None if cache is None else {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    out, got_cache = attention.mla_forward(params_from_jax(lp, "cpu"), torch.from_numpy(x), tm,
                                           torch.from_numpy(pos.copy()), t_cache,
                                           None if cache is None else 0)
    np.testing.assert_allclose(_np(out), np.asarray(j_out), rtol=1e-5, atol=1e-5)
    if with_cache:
        assert got_cache is t_cache  # written in place
        for leaf in ("c_kv", "k_pe"):
            np.testing.assert_allclose(_np(got_cache[leaf]), np.asarray(j_cache[leaf]),
                                       rtol=1e-5, atol=1e-5, err_msg=leaf)
    else:
        assert got_cache is None and j_cache is None


def test_cache_shapes_match_reference():
    for getter, j_getter in ((get_smoke_config, j_get_smoke_config),
                             (get_config, j_get_config)):
        tc, jc = getter(ARCH), j_getter(ARCH)
        got, want = cache_spec(tc, 3, 40), j_cache_spec(jc, 3, 40)
        assert sorted(got["layers"]) == sorted(want["layers"]) == ["c_kv", "k_pe"]
        for leaf, (shape, dt) in got["layers"].items():
            assert shape == want["layers"][leaf].shape, leaf
            assert str(dt).removeprefix("torch.") == jnp.dtype(want["layers"][leaf].dtype).name
    assert cache_spec(get_config(ARCH), 1, 1024)["layers"]["c_kv"][0] == (62, 1, 1024, 256)


def test_absorbed_decode_matches_reference_and_full_forward(ref_params):
    jc, tc = _configs()
    toks = np.random.default_rng(2).integers(0, jc.vocab, size=(2, 17)).astype(np.int32)
    jt, tt = jnp.asarray(toks), torch.as_tensor(toks).long()
    tp = params_from_jax(ref_params, "cpu")
    j_cache = j_init_cache(jc, 2, 32)
    _, j_cache, _ = j_forward(ref_params, jc, tokens=jt[:, :16], cache=j_cache,
                              cache_index=jnp.asarray(0))
    j_dec, j_cache, _ = j_forward(ref_params, jc, tokens=jt[:, 16:17], cache=j_cache,
                                  cache_index=jnp.asarray(16))
    full, _, _ = forward(tp, tc, tt)
    cache = init_cache(tc, 2, 32, device="cpu")
    _, cache, _ = forward(tp, tc, tt[:, :16], cache=cache, cache_index=0)
    dec, cache, aux = forward(tp, tc, tt[:, 16:17], cache=cache, cache_index=16)
    assert float(aux) == 0.0
    np.testing.assert_allclose(_np(dec), np.asarray(j_dec), **TOL)
    for leaf in ("c_kv", "k_pe"):
        np.testing.assert_allclose(_np(cache["layers"][leaf]), np.asarray(j_cache["layers"][leaf]),
                                   **TOL, err_msg=leaf)
    a, b = _np(full[:, 16, : tc.vocab]), _np(dec[:, 0, : tc.vocab])
    assert np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-9) < 2e-3  # the reference test's bound
    np.testing.assert_allclose(b, a, **TOL)


def test_forward_without_cache_matches_reference(ref_params):
    jc, tc = _configs()
    toks = np.random.default_rng(3).integers(0, jc.vocab, size=(2, 37)).astype(np.int32)
    j_logits, _, _ = jax.jit(lambda p, t: j_forward(p, jc, tokens=t))(ref_params, jnp.asarray(toks))
    logits, cache, _ = forward(params_from_jax(ref_params, "cpu"), tc, torch.as_tensor(toks).long())
    assert cache is None and logits.shape == (2, 37, jc.padded_vocab)
    np.testing.assert_allclose(_np(logits), np.asarray(j_logits), **TOL)


def test_grad_step_matches_reference(ref_params):
    jc, tc = _configs()
    batch = j_make_batch(JDataConfig(vocab=jc.vocab, seq_len=64, batch_size=2, seed=3), 0, 0)
    j_grads, j_m = jax.jit(j_make_grad_step(jc))(
        jax.tree_util.tree_map(jnp.asarray, ref_params), {k: jnp.asarray(v) for k, v in batch.items()})
    grads, m = make_grad_step(tc)(params_from_jax(ref_params, "cpu"),
                                  {k: torch.from_numpy(v.astype(np.int64)) for k, v in batch.items()})
    for k in ("loss", "ce", "aux"):
        np.testing.assert_allclose(float(m[k]), float(j_m[k]), rtol=1e-5, atol=1e-5, err_msg=k)
    leaves, j_leaves = tree_leaves(grads), jax.tree_util.tree_leaves(j_grads)
    assert len(leaves) == len(j_leaves) == 15  # embed, final norm, 8 attention + 2 norms + 3 mlp
    for g, w in zip(leaves, j_leaves):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(_np(g), w, rtol=1e-4, atol=1e-4 * np.abs(w).max())
