"""The port's Mamba-2 blocks and the ssm and hybrid stacks against the
reference's, on the CPU at the smoke sizes (``mamba2-smoke``,
``zamba2-smoke``).

Both packages run from the same parameters (the reference's ``init_params``,
loaded with ``params_from_jax``) and the same numpy-made inputs, at f32
compute, to rtol=atol=1e-4 for every element (the SSD pieces inside are held
to 3e-4 in ``tests/test_torch_ssd.py``). ``init_params`` sets ``A_log`` and
``dt_bias`` to 0 and ``D`` and the gated norm to 1, values that hide a wrong
dtype or a wrong leaf, so every test first overwrites them with seeded
values in their published ranges: A in U[1, 16] and dt log-uniform in
[dt_min, dt_max] (Mamba-2's initialisation), D and the gated norm in
U[0.5, 1.5].

Held here: ``_causal_conv``, ``mamba2_forward`` with and without a state,
``mamba2_decode_step``; the no-cache logits of both stacks; prefill then
decode, logits and every cache leaf; decode against the full forward;
greedy ``BatchServer`` token streams; one f32 gradient step; the cache
layout; and the serving loop's parameter dtypes and slot merge on the
nested (groups, layers, batch, ...) cache. Marked ``gpu``: the f32 gradient
step on the card (the ssd_scan backward kernels) against the CPU's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_get_smoke_config  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import model_spec as j_model_spec  # noqa: E402
from repro.models import ssm as j_ssm  # noqa: E402
from repro.models.transformer import cache_spec as j_cache_spec  # noqa: E402
from repro.models.transformer import init_cache as j_init_cache  # noqa: E402
from repro.models.transformer import ssm_config as j_ssm_config  # noqa: E402
from repro.runtime import make_decode_step as j_make_decode_step  # noqa: E402
from repro.runtime import make_prefill_step as j_make_prefill_step  # noqa: E402
from repro.runtime import serve_loop as j_serve  # noqa: E402
from repro.runtime.step_builder import make_grad_step as j_make_grad_step  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import (  # noqa: E402
    cache_spec,
    forward,
    hybrid_layout,
    init_cache,
    init_params,
    model_spec,
    params_from_jax,
    ssm_config,
)
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.layers import tree_map  # noqa: E402
from repro_torch.runtime import make_decode_step, make_grad_step, make_prefill_step  # noqa: E402
from repro_torch.runtime import serve_loop  # noqa: E402

ARCHS = ["mamba2-130m", "zamba2-1.2b"]
TOL = dict(rtol=1e-4, atol=1e-4)


def _np(x):
    return np.asarray(x.detach().float().cpu() if isinstance(x, torch.Tensor) else x, np.float32)


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _published(tree, seed=0, dt_min=0.001, dt_max=0.1):
    """The tree with A_log, dt_bias, D and Mamba's gated norm drawn in their
    published ranges (numpy, seeded), everything else unchanged."""
    rng = np.random.default_rng(seed)

    def draw(t):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out[k] = draw(v)
            elif k == "A_log":
                out[k] = np.log(rng.uniform(1.0, 16.0, v.shape)).astype(np.float32)
            elif k == "dt_bias":
                dt = np.exp(rng.uniform(np.log(dt_min), np.log(dt_max), v.shape))
                out[k] = (dt + np.log(-np.expm1(-dt))).astype(np.float32)  # softplus^-1
            elif k in ("D", "norm"):
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            else:
                out[k] = v
        return out

    return draw(tree)


_SETUPS = {}


def _setup(arch):
    """(reference f32 config, port f32 config, reference numpy tree, port tree)."""
    if arch not in _SETUPS:
        j_cfg = j_get_smoke_config(arch).scaled(dtype=jnp.float32)
        t_cfg = get_smoke_config(arch).scaled(dtype=torch.float32)
        tree = jax.tree_util.tree_map(np.asarray, j_init_params(jax.random.PRNGKey(0),
                                                                j_model_spec(j_cfg)))
        tree = _published(tree)
        _SETUPS[arch] = (j_cfg, t_cfg, tree, params_from_jax(tree, "cpu"))
    return _SETUPS[arch]


def _layer0(tree):
    """The first mamba layer's parameters of a reference tree (numpy)."""
    stack = tree["layers"] if "layers" in tree else tree["groups"]
    mamba = stack["mamba"]
    return {k: (v[0, 0] if "groups" in tree else v[0]) for k, v in mamba.items()}


def _state(rng, b, cfg):
    return {
        "ssm": (rng.standard_normal((b, cfg.n_heads, cfg.head_dim, cfg.d_state)) * 0.5).astype(np.float32),
        "conv": (rng.standard_normal((b, cfg.d_conv - 1, cfg.d_xbc)) * 0.5).astype(np.float32),
    }


def _t(tree):
    """numpy -> torch, copied (arrays that came from jax are read-only)."""
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_tail", [False, True])
def test_causal_conv_matches_reference(with_tail):
    rng = np.random.default_rng(1)
    xbc = rng.standard_normal((2, 9, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    bias = rng.standard_normal((24,)).astype(np.float32)
    tail = rng.standard_normal((2, 3, 24)).astype(np.float32) if with_tail else None
    want_y, want_tail = j_ssm._causal_conv(jnp.asarray(xbc), jnp.asarray(w), jnp.asarray(bias),
                                           None if tail is None else jnp.asarray(tail))
    y, new_tail = ssm._causal_conv(_t(xbc), _t(w), _t(bias), None if tail is None else _t(tail))
    np.testing.assert_allclose(_np(y), np.asarray(want_y), **TOL)
    np.testing.assert_array_equal(_np(new_tail), np.asarray(want_tail))
    # the tail keeps its storage dtype when the activations are bf16
    if with_tail:
        _, t16 = ssm._causal_conv(_t(xbc).bfloat16(), _t(w).bfloat16(), _t(bias).bfloat16(), _t(tail))
        assert t16.dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("with_state", [False, True])
def test_mamba2_forward_matches_reference(arch, with_state):
    j_cfg, t_cfg, tree, _ = _setup(arch)
    jc, tc = j_ssm_config(j_cfg), ssm_config(t_cfg)
    assert tc == ssm.SSMConfig(**{f: getattr(jc, f) for f in jc.__dataclass_fields__})
    lp = _layer0(tree)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 37, j_cfg.d_model)).astype(np.float32)
    state = _state(rng, 2, jc) if with_state else None
    want, want_state = j_ssm.mamba2_forward(_j(lp), jnp.asarray(x), jc,
                                            None if state is None else _j(state))
    got, got_state = ssm.mamba2_forward(_t(lp), _t(x), tc, None if state is None else _t(state))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    if with_state:
        for key in ("ssm", "conv"):
            assert got_state[key].dtype == torch.float32
            np.testing.assert_allclose(_np(got_state[key]), np.asarray(want_state[key]), **TOL,
                                       err_msg=key)
    else:
        assert got_state is None and want_state is None


@pytest.mark.parametrize("arch", ARCHS)
def test_mamba2_decode_step_matches_reference(arch):
    j_cfg, t_cfg, tree, _ = _setup(arch)
    jc, tc = j_ssm_config(j_cfg), ssm_config(t_cfg)
    lp = _layer0(tree)
    rng = np.random.default_rng(3)
    state = _state(rng, 3, jc)
    for step in range(3):
        x = rng.standard_normal((3, 1, j_cfg.d_model)).astype(np.float32)
        want, want_state = j_ssm.mamba2_decode_step(_j(lp), jnp.asarray(x), jc, _j(state))
        got, got_state = ssm.mamba2_decode_step(_t(lp), _t(x), tc, _t(state))
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL, err_msg=f"step {step}")
        for key in ("ssm", "conv"):
            np.testing.assert_allclose(_np(got_state[key]), np.asarray(want_state[key]), **TOL,
                                       err_msg=f"{key}, step {step}")
        state = {k: np.asarray(v) for k, v in want_state.items()}


def test_mamba2_state_shape_matches_reference():
    for arch in ARCHS:
        jc = j_ssm_config(j_get_smoke_config(arch))
        want = j_ssm.mamba2_state_shape(2, jc)
        got = ssm.mamba2_state_shape(2, ssm_config(get_smoke_config(arch)))
        assert {k: v[0] for k, v in got.items()} == {k: v.shape for k, v in want.items()}
        assert all(dt == torch.float32 for _, dt in got.values())


# ---------------------------------------------------------------------------
# Whole stacks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_keeps_the_tree(arch):
    j_cfg, t_cfg, tree, params = _setup(arch)
    want, got = _flatten(tree), _flatten(params)
    assert sorted(want) == sorted(got)
    for key, arr in want.items():
        assert tuple(got[key].shape) == arr.shape, key
        np.testing.assert_array_equal(got[key].numpy(), arr, err_msg=key)
    if arch == "zamba2-1.2b":
        ng, per, tail = hybrid_layout(t_cfg)
        assert (ng, per, tail) == (2, 2, 1)
        assert got["groups/mamba/A_log"].shape == (ng, per, ssm_config(t_cfg).n_heads)
        assert got["tail/mamba/in_proj"].shape[0] == tail
        assert "q_norm" not in params["shared_attn"]["attn"]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_without_cache_matches_reference(arch):
    j_cfg, t_cfg, tree, params = _setup(arch)
    toks = np.random.default_rng(4).integers(0, j_cfg.vocab, size=(2, 37)).astype(np.int32)
    want, _, _ = jax.jit(lambda p, t: j_forward(p, j_cfg, tokens=t))(_j(tree), jnp.asarray(toks))
    got, cache, _ = forward(params, t_cfg, torch.as_tensor(toks, dtype=torch.long))
    assert cache is None and got.shape == (2, 37, j_cfg.padded_vocab)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_layout_matches_reference(arch):
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
        want = _flatten(j_cache_spec(j_get_smoke_config(arch).scaled(dtype=jdt), 3, 40))
        got = _flatten(cache_spec(get_smoke_config(arch).scaled(dtype=tdt), 3, 40))
        assert sorted(got) == sorted(want)
        for key, sds in want.items():
            shape, dt = got[key]
            assert shape == sds.shape, key
            assert str(dt).removeprefix("torch.") == jnp.dtype(sds.dtype).name, key
            if key.split("/")[-1] in ("ssm", "conv"):
                assert dt == torch.float32, key  # both state leaves are f32


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_reference(arch):
    j_cfg, t_cfg, tree, params = _setup(arch)
    rng = np.random.default_rng(5)
    b, s, max_seq = 2, 20, 48
    toks = rng.integers(0, j_cfg.vocab, size=(b, s)).astype(np.int32)
    j_logits, j_cache = jax.jit(j_make_prefill_step(j_cfg))(
        _j(tree), {"tokens": jnp.asarray(toks)}, j_init_cache(j_cfg, b, max_seq))
    logits, cache = make_prefill_step(t_cfg)(
        params, {"tokens": torch.as_tensor(toks, dtype=torch.long)},
        init_cache(t_cfg, b, max_seq, device="cpu"))
    assert logits.shape == j_logits.shape == (b, 1, j_cfg.padded_vocab)
    np.testing.assert_allclose(_np(logits), np.asarray(j_logits), **TOL)

    def same_cache(msg):
        want, got = _flatten(j_cache), _flatten(cache)
        assert sorted(want) == sorted(got)
        for key in want:
            np.testing.assert_allclose(_np(got[key]), np.asarray(want[key], np.float32), **TOL,
                                       err_msg=f"{key}, {msg}")

    same_cache("prefill")
    j_decode = jax.jit(j_make_decode_step(j_cfg))
    decode = make_decode_step(t_cfg)
    for step in range(3):
        nt = rng.integers(0, j_cfg.vocab, size=(b, 1)).astype(np.int32)
        j_logits, j_cache = j_decode(_j(tree), jnp.asarray(nt), j_cache, jnp.asarray(s + step, jnp.int32))
        logits, cache = decode(params, torch.as_tensor(nt, dtype=torch.long), cache, s + step)
        np.testing.assert_allclose(_np(logits), np.asarray(j_logits), **TOL, err_msg=f"step {step}")
        same_cache(f"step {step}")


@pytest.mark.parametrize("arch", ARCHS)
def test_one_token_prompt_takes_the_decode_step(arch):
    # the reference's rule: with a cache and one token the mamba layers take
    # the recurrent step, a prefill of a 1-token prompt included
    j_cfg, t_cfg, tree, params = _setup(arch)
    toks = np.array([[7], [300]], np.int32)
    j_logits, j_cache = jax.jit(j_make_prefill_step(j_cfg))(
        _j(tree), {"tokens": jnp.asarray(toks)}, j_init_cache(j_cfg, 2, 8))
    logits, cache = make_prefill_step(t_cfg)(
        params, {"tokens": torch.as_tensor(toks, dtype=torch.long)}, init_cache(t_cfg, 2, 8, device="cpu"))
    np.testing.assert_allclose(_np(logits), np.asarray(j_logits), **TOL)
    for key, want in _flatten(j_cache).items():
        np.testing.assert_allclose(_np(_flatten(cache)[key]), np.asarray(want, np.float32), **TOL,
                                   err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full_forward(arch):
    # the reference's test_decode_matches_full_forward, on the port
    _, t_cfg, _, params = _setup(arch)
    toks = torch.as_tensor(np.random.default_rng(6).integers(0, t_cfg.vocab, size=(2, 17)))
    full, _, _ = forward(params, t_cfg, toks)
    cache = init_cache(t_cfg, 2, 32, device="cpu")
    _, cache, _ = forward(params, t_cfg, toks[:, :16], cache=cache, cache_index=0)
    dec, _, _ = forward(params, t_cfg, toks[:, 16:17], cache=cache, cache_index=16)
    a, b = _np(full[:, 16, :t_cfg.vocab]), _np(dec[:, 0, :t_cfg.vocab])
    err = np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-9)
    assert err < 2e-3, f"{arch} decode mismatch {err}"


@pytest.mark.parametrize("arch", ARCHS)
def test_grad_step_matches_reference(arch):
    # remat on: each mamba layer (each hybrid group) runs under checkpointing
    j_cfg, t_cfg, tree, params = _setup(arch)
    j_cfg, t_cfg = j_cfg.scaled(remat=True), t_cfg.scaled(remat=True)
    toks = np.random.default_rng(7).integers(0, j_cfg.vocab, size=(2, 33)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    j_grads, j_metrics = jax.jit(j_make_grad_step(j_cfg))(
        _j(tree), {k: jnp.asarray(v) for k, v in batch.items()})
    grads, metrics = make_grad_step(t_cfg)(
        params, {k: torch.as_tensor(v, dtype=torch.long) for k, v in batch.items()})
    np.testing.assert_allclose(_np(metrics["loss"]), np.asarray(j_metrics["loss"]), rtol=1e-5, atol=1e-5)
    # per leaf to 1e-3 relative plus 5e-4 of the leaf's largest entry: the
    # zamba2 smoke stack is ill-conditioned (a 1e-7 relative change of its
    # parameters moves the reference's own logits by ~2e-5, 40x what it does
    # to mamba2-smoke), and f32 sums run in other orders in the two packages
    for (key, g), w in zip(sorted(_flatten(grads).items()), jax.tree_util.tree_leaves(j_grads)):
        assert g.shape == w.shape, key
        w = np.asarray(w)
        np.testing.assert_allclose(_np(g), w, rtol=1e-3, atol=5e-4 * np.abs(w).max(), err_msg=key)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_grad_step_on_the_card_matches_the_cpu(arch):
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("no CUDA card of capability 9.0: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    _, t_cfg, _, params = _setup(arch)
    t_cfg = t_cfg.scaled(remat=True)
    toks = np.random.default_rng(8).integers(0, t_cfg.vocab, size=(2, 65))
    batch = {"tokens": torch.as_tensor(toks[:, :-1]), "labels": torch.as_tensor(toks[:, 1:])}
    step = make_grad_step(t_cfg)
    cpu_grads, cpu_m = step(params, batch)
    before = ssd_ops.launches_bwd
    grads, m = step(tree_map(lambda t: t.cuda(), params), {k: v.cuda() for k, v in batch.items()})
    torch.cuda.synchronize()
    assert ssd_ops.launches_bwd - before == t_cfg.n_layers  # one backward per mamba layer
    np.testing.assert_allclose(_np(m["loss"]), _np(cpu_m["loss"]), rtol=1e-5)
    # each leaf to 1e-3 of its largest entry
    for (key, g), (_, w) in zip(sorted(_flatten(grads).items()), sorted(_flatten(cpu_grads).items())):
        w = _np(w)
        np.testing.assert_allclose(_np(g), w, rtol=0, atol=1e-3 * np.abs(w).max(), err_msg=key)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def _requests(module, vocab, n=7, max_new=6):
    # three prompt lengths (the reference compiles its prefill once for
    # each), one of them a 1-token prompt, which takes the decode step
    rng = np.random.default_rng(0)
    sizes = [1, 6, 13, 6, 13, 1, 6][:n]
    return [
        module.Request(
            id=i,
            prompt=rng.integers(0, vocab, size=sizes[i]).astype(np.int32),
            max_new_tokens=max_new,
            deadline=float(rng.integers(1, 100)),
        )
        for i in range(n)
    ]


@pytest.mark.parametrize("arch", ARCHS)
def test_token_streams_match_reference(arch):
    j_cfg, t_cfg, tree, params = _setup(arch)
    j_server = j_serve.BatchServer(j_cfg, _j(tree), batch_slots=3, max_seq=64)
    t_server = serve_loop.BatchServer(t_cfg, params, batch_slots=3, max_seq=64, device="cpu")
    j_reqs, t_reqs = _requests(j_serve, j_cfg.vocab), _requests(serve_loop, t_cfg.vocab)
    for a, b in zip(j_reqs, t_reqs):
        j_server.submit(a)
        t_server.submit(b)
    jm, tm = j_server.run(), t_server.run()
    assert [r.tokens_out for r in t_reqs] == [r.tokens_out for r in j_reqs]
    assert (tm.requests_done, tm.tokens_generated, tm.decode_steps) == (
        jm.requests_done, jm.tokens_generated, jm.decode_steps)


@pytest.mark.parametrize("arch", ARCHS + ["qwen3-0.6b"])
def test_compute_params_keep_the_f32_leaves(arch):
    # the leaves the reference reads at f32 whatever the compute dtype (the
    # RMSNorm scales and q/k norms; Mamba's A_log, dt_bias and gated norm):
    # at bf16 compute the server must not round them, and casts the rest
    if arch in ARCHS:
        _, t_cfg, _, params = _setup(arch)
    else:
        t_cfg = get_smoke_config(arch)
        params = init_params(torch.Generator().manual_seed(0), model_spec(t_cfg), device="cpu")
    cast = serve_loop._compute_params(params, model_spec(t_cfg), torch.bfloat16, torch.device("cpu"))
    f32_keys = {"A_log", "dt_bias", "norm", "scale", "q_norm", "k_norm"}
    seen = set()
    for key, leaf in _flatten(cast).items():
        want = torch.float32 if key.split("/")[-1] in f32_keys else torch.bfloat16
        assert leaf.dtype == want, key
        if want == torch.float32:
            seen.add(key.split("/")[-1])
            assert torch.equal(leaf, _flatten(params)[key]), key
    assert seen == ({"A_log", "dt_bias", "norm", "scale"} if arch in ARCHS else {"scale", "q_norm", "k_norm"})
    if arch in ARCHS:
        assert _flatten(cast)[("layers" if arch == "mamba2-130m" else "groups") + "/mamba/D"].dtype == \
            torch.bfloat16


def test_merge_slot_writes_only_the_slot():
    # the hybrid cache holds (ng, per, B, ...), (ng, B, ...) and (L, B, ...)
    # leaves; the ssm cache (L, B, ...) ones: only slot 2 of each changes
    for arch in ARCHS:
        cfg = get_smoke_config(arch)
        batch = tree_map(lambda t: torch.arange(t.numel(), dtype=torch.float32).view(t.shape).to(t.dtype),
                         init_cache(cfg, 4, 12, device="cpu"))
        one = tree_map(lambda t: torch.full(t.shape, -1.0, dtype=t.dtype), init_cache(cfg, 1, 12, device="cpu"))
        before = tree_map(torch.clone, batch)
        want = j_serve._merge_slot(jax.tree_util.tree_map(lambda t: jnp.asarray(t.float().numpy()), batch),
                                   jax.tree_util.tree_map(lambda t: jnp.asarray(t.float().numpy()), one), 2)
        got = serve_loop._merge_slot(batch, one, 2)
        for key, leaf in _flatten(got).items():
            np.testing.assert_array_equal(_np(leaf), np.asarray(_flatten(want)[key], np.float32), err_msg=key)
            ax = {"groups_mamba": 2}.get(key.split("/")[0], 1)  # the batch axis
            old = _flatten(before)[key]
            for slot in range(4):
                sl = leaf.select(ax, slot)
                if slot == 2:
                    assert (sl == -1).all(), key
                else:
                    assert torch.equal(sl, old.select(ax, slot)), key
