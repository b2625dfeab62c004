"""The port's model against the reference's, on the CPU at the smoke size.

Both packages run from the same parameters (the reference's ``init_params``,
loaded with ``params_from_jax``) and the same numpy-made tokens: prefill
logits and cache, then three decode steps, at f32 (rtol=atol=1e-4 for every
element) and at the default bf16 compute (2e-2: bf16 rounds at other points
in the two frameworks, for example the reference's SwiGLU runs in bf16 and
the port's in f32). At bf16 the logits are held element by element; the KV
cache, whose entries reach |x| ~ 20 where one bf16 step is 0.125, is held to
2e-2 of its largest entry, because both packages are that far from the f32
result there.
Configs of every arch (all ten are ported), full and smoke, are compared
field by field, with ``param_count()`` and ``train_flops_per_token()``;
the derived properties, ``decode_flops_per_token`` and ``cell_supported`` over every
arch and shape cell; and the smoke configs of the two other dense GQA archs
(phi4-mini, command-r-plus: logits, loss and gradients at f32, the
gradient leaves to rtol=1e-4 with atol 1e-4 of the leaf's largest entry).
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
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import SHAPES as J_SHAPES  # noqa: E402
from repro.models import cell_supported as j_cell_supported  # noqa: E402
from repro.models import model_spec as j_model_spec  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import make_batch as j_make_batch  # noqa: E402
from repro.runtime.step_builder import make_grad_step as j_make_grad_step  # noqa: E402
from repro.models.transformer import init_cache as j_init_cache  # noqa: E402
from repro.runtime import make_decode_step as j_make_decode_step  # noqa: E402
from repro.runtime import make_prefill_step as j_make_prefill_step  # noqa: E402
from repro_torch.configs import ARCHS, PORTED, get_config, get_smoke_config  # noqa: E402
from repro_torch.models import (  # noqa: E402
    SHAPES,
    ModelConfig,
    cell_supported,
    forward,
    get_shape,
    init_cache,
    init_params,
    model_spec,
    params_from_jax,
)
from repro_torch.models.layers import tree_leaves  # noqa: E402
from repro_torch.runtime import make_decode_step, make_grad_step, make_prefill_step  # noqa: E402

ARCH = "qwen3-0.6b"
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4), "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def _assert_cache_close(actual, desired, tol, scaled, msg=""):
    a, d = _np(actual), _np(desired)
    if scaled:
        err, scale = np.abs(a - d).max(), np.abs(d).max()
        assert err <= tol * scale, f"{msg}: max abs err {err} > {tol} * max |x| {scale}"
    else:
        np.testing.assert_allclose(a, d, rtol=tol, atol=tol, err_msg=msg)


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


@pytest.fixture(scope="module")
def ref_params():
    cfg = j_get_smoke_config(ARCH)
    params = j_init_params(jax.random.PRNGKey(0), j_model_spec(cfg))
    return jax.tree_util.tree_map(np.asarray, params)


# ---------------------------------------------------------------------------
# Config parity
# ---------------------------------------------------------------------------


# ids: "full"/"smoke" for qwen3 (as before the other archs were ported),
# "full-<arch>"/"smoke-<arch>" for the others
CONFIG_CASES = [
    pytest.param(getters, arch, id=kind if arch == ARCH else f"{kind}-{arch}")
    for arch in PORTED
    for kind, getters in (("full", (j_get_config, get_config)),
                          ("smoke", (j_get_smoke_config, get_smoke_config)))
]


@pytest.mark.parametrize("getters,arch", CONFIG_CASES)
def test_config_matches_reference(getters, arch):
    j_cfg, t_cfg = getters[0](arch), getters[1](arch)
    j_fields = [f.name for f in dataclasses.fields(j_cfg)]
    assert j_fields == [f.name for f in dataclasses.fields(t_cfg)]
    for name in j_fields:
        a, b = getattr(j_cfg, name), getattr(t_cfg, name)
        if name in ("dtype", "param_dtype"):
            assert jnp.dtype(a).name == str(b).removeprefix("torch."), name
        else:
            assert a == b, name
    assert t_cfg.resolved_head_dim == j_cfg.resolved_head_dim
    assert t_cfg.padded_vocab == j_cfg.padded_vocab
    assert t_cfg.causal == j_cfg.causal and t_cfg.has_decode == j_cfg.has_decode
    assert t_cfg.param_count() == j_cfg.param_count()
    assert t_cfg.train_flops_per_token() == j_cfg.train_flops_per_token()


def test_unported_archs_raise():
    # no reference arch is left unported: each is registered and built with
    # the reference's fields (the vlm and audio backbones too); only an
    # unknown name raises
    assert ARCHS == J_ARCHS and PORTED == J_ARCHS
    for arch in ARCHS:
        for j_get, get in ((j_get_config, get_config), (j_get_smoke_config, get_smoke_config)):
            j_cfg, t_cfg = j_get(arch), get(arch)
            assert isinstance(t_cfg, ModelConfig) and t_cfg.name == j_cfg.name
            for f in dataclasses.fields(j_cfg):
                a, b = getattr(j_cfg, f.name), getattr(t_cfg, f.name)
                assert (str(b).removeprefix("torch.") == jnp.dtype(a).name if f.name.endswith("dtype")
                        else a == b), (arch, f.name)
            assert len(model_spec(t_cfg)) == len(j_model_spec(j_cfg))
    for get in (get_config, get_smoke_config):
        with pytest.raises(KeyError):
            get("no-such-arch")


def test_shapes_match_reference():
    assert [dataclasses.astuple(s) for s in SHAPES] == [dataclasses.astuple(s) for s in J_SHAPES]
    for s in J_SHAPES:
        assert get_shape(s.name) == SHAPES[J_SHAPES.index(s)] and get_shape(s.name).tokens == s.tokens
    with pytest.raises(KeyError):
        get_shape("no-such-shape")


@pytest.mark.parametrize("arch", ARCHS)
def test_derived_properties_and_cells_match_reference(arch):
    j_cfg = j_get_config(arch)
    t_cfg = get_config(arch)
    assert t_cfg.is_attention_free == j_cfg.is_attention_free
    assert t_cfg.supports_long_context == j_cfg.supports_long_context
    assert t_cfg.has_decode == j_cfg.has_decode
    for shape in J_SHAPES:
        assert cell_supported(t_cfg, SHAPES[J_SHAPES.index(shape)]) == j_cell_supported(j_cfg, shape)
    assert t_cfg.param_count() == j_cfg.param_count()
    assert t_cfg.active_param_count() == j_cfg.active_param_count()
    for context in (0, 4096, 32768, 524288):
        assert t_cfg.decode_flops_per_token(context) == j_cfg.decode_flops_per_token(context)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def test_params_from_jax_round_trip(ref_params):
    port = params_from_jax(ref_params, "cpu")
    want, got = _flatten(ref_params), _flatten(port)
    assert sorted(want) == sorted(got)
    assert got["layers/attn/wq"].shape == (2, 64, 4, 16)  # (L, d, H, hd)
    for key, arr in want.items():
        assert tuple(got[key].shape) == arr.shape, key
        np.testing.assert_array_equal(got[key].numpy(), arr, err_msg=key)
    # bf16 leaves keep their bits
    bf = jax.tree_util.tree_map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), ref_params)
    emb = params_from_jax(bf, "cpu")["embed"]["embedding"]
    assert emb.dtype == torch.bfloat16
    np.testing.assert_array_equal(emb.float().numpy(), np.asarray(bf["embed"]["embedding"], np.float32))


def test_init_params_matches_reference_in_distribution(ref_params):
    cfg = get_smoke_config(ARCH).scaled(vocab=4096)
    gen = torch.Generator().manual_seed(0)
    port = init_params(gen, model_spec(cfg), device="cpu")
    ref = jax.tree_util.tree_map(np.asarray, j_init_params(jax.random.PRNGKey(1), j_model_spec(
        j_get_smoke_config(ARCH).scaled(vocab=4096))))
    got, want = _flatten(port), _flatten(ref)
    assert sorted(got) == sorted(want)
    for key, arr in want.items():
        t = got[key]
        assert tuple(t.shape) == arr.shape and t.dtype == torch.float32, key
        if arr.std() == 0:  # norm scales: ones
            np.testing.assert_array_equal(t.numpy(), arr, err_msg=key)
        else:
            assert abs(float(t.std()) / float(arr.std()) - 1) < 0.1, key
            assert abs(float(t.mean())) < 0.1 * float(arr.std()) + 1e-3, key
    assert len(tree_leaves(port)) == len(jax.tree_util.tree_leaves(ref))


# ---------------------------------------------------------------------------
# Forward, prefill and decode against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_prefill_then_decode_matches_reference(ref_params, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    j_cfg = j_get_smoke_config(ARCH).scaled(dtype=jdt)
    t_cfg = get_smoke_config(ARCH).scaled(dtype=tdt)
    port_params = params_from_jax(ref_params, "cpu")
    rng = np.random.default_rng(0)
    b, s, max_seq = 2, 20, 48
    toks = rng.integers(0, j_cfg.vocab, size=(b, s)).astype(np.int32)

    j_logits, j_cache = jax.jit(j_make_prefill_step(j_cfg))(
        ref_params, {"tokens": jnp.asarray(toks)}, j_init_cache(j_cfg, b, max_seq))
    logits, cache = make_prefill_step(t_cfg)(
        port_params, {"tokens": torch.as_tensor(toks, dtype=torch.long)},
        init_cache(t_cfg, b, max_seq, device="cpu"))
    assert logits.shape == j_logits.shape == (b, 1, j_cfg.padded_vocab)
    np.testing.assert_allclose(_np(logits), _np(j_logits), rtol=tol, atol=tol)
    scaled = dtype == "bfloat16"
    for leaf in ("k", "v"):
        assert cache["layers"][leaf].dtype == tdt
        _assert_cache_close(cache["layers"][leaf], j_cache["layers"][leaf], tol, scaled, leaf)

    j_decode = jax.jit(j_make_decode_step(j_cfg))
    decode = make_decode_step(t_cfg)
    for step in range(3):
        nt = rng.integers(0, j_cfg.vocab, size=(b, 1)).astype(np.int32)
        j_logits, j_cache = j_decode(ref_params, jnp.asarray(nt), j_cache, jnp.asarray(s + step, jnp.int32))
        logits, cache = decode(port_params, torch.as_tensor(nt, dtype=torch.long), cache, s + step)
        assert logits.shape == (b, 1, j_cfg.padded_vocab)
        np.testing.assert_allclose(_np(logits), _np(j_logits), rtol=tol, atol=tol, err_msg=f"step {step}")
        for leaf in ("k", "v"):
            _assert_cache_close(cache["layers"][leaf], j_cache["layers"][leaf], tol, scaled,
                                f"{leaf}, step {step}")


def test_forward_without_cache_matches_reference(ref_params):
    j_cfg = j_get_smoke_config(ARCH).scaled(dtype=jnp.float32)
    t_cfg = get_smoke_config(ARCH).scaled(dtype=torch.float32)
    toks = np.random.default_rng(3).integers(0, j_cfg.vocab, size=(2, 37)).astype(np.int32)
    j_logits, _, _ = jax.jit(lambda p, t: j_forward(p, j_cfg, tokens=t))(ref_params, jnp.asarray(toks))
    logits, cache, aux = forward(params_from_jax(ref_params, "cpu"), t_cfg,
                                 torch.as_tensor(toks, dtype=torch.long))
    assert float(aux) == 0.0
    assert cache is None
    assert logits.shape == (2, 37, j_cfg.padded_vocab)
    np.testing.assert_allclose(_np(logits), _np(j_logits), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "command-r-plus-104b"])
def test_dense_gqa_archs_match_reference(arch):
    j_cfg = j_get_smoke_config(arch).scaled(dtype=jnp.float32)
    t_cfg = get_smoke_config(arch).scaled(dtype=torch.float32)
    params = jax.tree_util.tree_map(np.asarray, j_init_params(jax.random.PRNGKey(0), j_model_spec(j_cfg)))
    port = params_from_jax(params, "cpu")
    toks = np.random.default_rng(5).integers(0, j_cfg.vocab, size=(2, 37)).astype(np.int32)
    j_logits, _, _ = jax.jit(lambda p, t: j_forward(p, j_cfg, tokens=t))(params, jnp.asarray(toks))
    logits, _, aux = forward(port, t_cfg, torch.as_tensor(toks, dtype=torch.long))
    assert float(aux) == 0.0
    np.testing.assert_allclose(_np(logits), _np(j_logits), rtol=1e-4, atol=1e-4)
    batch = j_make_batch(JDataConfig(vocab=j_cfg.vocab, seq_len=64, batch_size=2, seed=3), 0, 0)
    j_grads, j_m = jax.jit(j_make_grad_step(j_cfg))(params, {k: jnp.asarray(v) for k, v in batch.items()})
    grads, m = make_grad_step(t_cfg)(port, {k: torch.from_numpy(v.astype(np.int64))
                                            for k, v in batch.items()})
    for k in ("loss", "ce", "aux"):
        np.testing.assert_allclose(float(m[k]), float(j_m[k]), rtol=1e-5, atol=1e-5, err_msg=k)
    for g, w in zip(tree_leaves(grads), jax.tree_util.tree_leaves(j_grads)):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(_np(g), w, rtol=1e-4, atol=1e-4 * np.abs(w).max())
