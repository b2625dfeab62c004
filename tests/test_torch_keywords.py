"""The port's public functions take the reference's parameters, and its
kernel wrappers the reference's keywords.

Every public function of every module of ``repro`` (``launch/`` included)
has a function of the same name in the port's module of the same name,
whose ``inspect.signature`` lists the reference's parameters in order, with
the same names, kinds and defaults. The port may add trailing parameters
with defaults named ``device``, ``params`` or ``initial_state``, and call a
``jax.random`` key ``generator`` (ROADMAP.md, Queue C); ``KNOWN`` lists the
differences that stand, each with its reason. Two of Queue C's repairs are
also held by value: the compression functions' ``interpret`` (the
reference's payload under True and False) and ``models.layers.causal_mask``.

Each of the nine public wrappers of ``repro_torch.kernels.*.ops`` accepts
every parameter of its counterpart in ``repro.kernels.*.ops``, with the same
kind and default (``inspect.signature`` of both), and, called on CPU
tensors with the same keywords (tiling hints off their defaults,
``interpret=True``), gives the reference's result on the same numpy inputs,
to the tolerance of that wrapper's parity test in ``test_torch_kernels.py``,
``test_torch_int8.py`` or ``test_torch_ssd.py``.
"""
import importlib
import importlib.util
import inspect
import os
import pkgutil
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import ops as j_flash  # noqa: E402
from repro.kernels.int8_quant import ops as j_int8  # noqa: E402
from repro.kernels.quorum_compare import ops as j_quorum  # noqa: E402
from repro.kernels.rmsnorm import ops as j_rms  # noqa: E402
from repro.kernels.ssd_scan import ops as j_ssd  # noqa: E402
from repro.kernels.swiglu import ops as j_swiglu  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.int8_quant import ops as int8_ops  # noqa: E402
from repro_torch.kernels.quorum_compare import ops as quorum_ops  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rms_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.swiglu import ops as swiglu_ops  # noqa: E402


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _rmsnorm():
    x, sc = _normal(1, (5, 3, 64)), _normal(2, (64,))
    kw = dict(eps=1e-5, block_rows=4, interpret=True)
    return rms_ops.rmsnorm(_t(x), _t(sc), **kw), j_rms.rmsnorm(jnp.asarray(x), jnp.asarray(sc), **kw), 1e-5


def _swiglu():
    g, u = _normal(1, (7, 48)), _normal(2, (7, 48))
    kw = dict(block_rows=4, interpret=True)
    return swiglu_ops.swiglu(_t(g), _t(u), **kw), j_swiglu.swiglu(jnp.asarray(g), jnp.asarray(u), **kw), 1e-6


def _flash_attention():
    q, k, v = _normal(1, (1, 96, 4, 32)), _normal(2, (1, 96, 2, 32)), _normal(3, (1, 96, 2, 32))
    kw = dict(causal=True, block_q=32, block_k=32, interpret=True)
    got = flash_ops.flash_attention(_t(q), _t(k), _t(v), **kw)
    return got, j_flash.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw), 2e-5


def _quorum_pair():
    a = _normal(1, (1000,))
    b = a.copy()
    b[:37] += 1.0
    return a, b


def _quorum_compare():
    a, b = _quorum_pair()
    kw = dict(rtol=1e-4, atol=1e-6, interpret=True)
    nb, sq = quorum_ops.quorum_compare(_t(a), _t(b), **kw)
    jnb, jsq = j_quorum.quorum_compare(jnp.asarray(a), jnp.asarray(b), **kw)
    assert int(nb) == int(float(jnb)) == 37
    return sq, jsq, 1e-5


def _tree_quorum_agree():
    a, b = _quorum_pair()
    for frac in (0.01, 0.05):
        kw = dict(rtol=1e-4, atol=1e-6, max_bad_fraction=frac, interpret=True)
        got = quorum_ops.tree_quorum_agree({"w": _t(a)}, {"w": _t(b)}, **kw)
        want = j_quorum.tree_quorum_agree({"w": jnp.asarray(a)}, {"w": jnp.asarray(b)}, **kw)
        assert got == want
    return torch.tensor(float(got)), np.float32(want), 0.0


def _int8_quantize():
    x = _normal(1, (30, 100))
    q, s = int8_ops.int8_quantize(_t(x), block_rows=4, interpret=True)
    jq, js = j_int8.int8_quantize(jnp.asarray(x), block_rows=4, interpret=True)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    return s, js, 0.0


def _int8_dequantize():
    x = _normal(1, (30, 100))
    jq, js = j_int8.int8_quantize(jnp.asarray(x), block_rows=4, interpret=True)
    got = int8_ops.int8_dequantize(_t(np.asarray(jq)), _t(np.asarray(js)), n=x.size, shape=x.shape,
                                   block_rows=4, out_dtype=torch.float32, interpret=True)
    want = j_int8.int8_dequantize(jq, js, n=x.size, shape=x.shape, block_rows=4,
                                  out_dtype=jnp.float32, interpret=True)
    return got, want, 0.0


def _quantize_dequantize():
    x = _normal(1, (30, 100))
    got = int8_ops.quantize_dequantize(_t(x), interpret=True)
    return got, j_int8.quantize_dequantize(jnp.asarray(x), interpret=True), 0.0


def _ssd_scan():
    b, s, h, p, g, n = 1, 100, 4, 16, 2, 16
    r = np.random.default_rng(7)
    x = r.standard_normal((b, s, h, p)).astype(np.float32)
    dt = (np.logaddexp(r.standard_normal((b, s, h)), 0.0) * 0.05 + 0.001).astype(np.float32)
    A = (-np.exp(r.standard_normal(h) * 0.3)).astype(np.float32)
    Bm, Cm = ((r.standard_normal((b, s, g, n)) * 0.3).astype(np.float32) for _ in range(2))
    y, st = ssd_ops.ssd_scan(*map(_t, (x, dt, A, Bm, Cm)), block_q=32, interpret=True)
    jy, jst = j_ssd.ssd_scan(*map(jnp.asarray, (x, dt, A, Bm, Cm)), block_q=32, interpret=True)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), atol=3e-4, rtol=3e-4)
    return y, jy, 3e-4


# (port wrapper, reference wrapper, the call of both: (port, reference, tolerance))
WRAPPERS = {
    "rmsnorm": (rms_ops.rmsnorm, j_rms.rmsnorm, _rmsnorm),
    "swiglu": (swiglu_ops.swiglu, j_swiglu.swiglu, _swiglu),
    "flash_attention": (flash_ops.flash_attention, j_flash.flash_attention, _flash_attention),
    "quorum_compare": (quorum_ops.quorum_compare, j_quorum.quorum_compare, _quorum_compare),
    "tree_quorum_agree": (quorum_ops.tree_quorum_agree, j_quorum.tree_quorum_agree,
                          _tree_quorum_agree),
    "int8_quantize": (int8_ops.int8_quantize, j_int8.int8_quantize, _int8_quantize),
    "int8_dequantize": (int8_ops.int8_dequantize, j_int8.int8_dequantize, _int8_dequantize),
    "quantize_dequantize": (int8_ops.quantize_dequantize, j_int8.quantize_dequantize,
                            _quantize_dequantize),
    "ssd_scan": (ssd_ops.ssd_scan, j_ssd.ssd_scan, _ssd_scan),
}


def _same_default(port, ref):
    if ref is jnp.float32:  # a dtype default: the same type in each framework
        return port is torch.float32
    return port == ref or (port is inspect.Parameter.empty and ref is inspect.Parameter.empty)


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrapper_takes_the_reference_keywords(name):
    port_fn, ref_fn, call = WRAPPERS[name]
    port, ref = inspect.signature(port_fn).parameters, inspect.signature(ref_fn).parameters
    for pname, rp in ref.items():
        assert pname in port, f"{name} lacks the reference's parameter {pname!r}"
        assert port[pname].kind == rp.kind, f"{name}.{pname}: {port[pname].kind} vs {rp.kind}"
        assert _same_default(port[pname].default, rp.default), (
            f"{name}.{pname}: default {port[pname].default!r}, reference {rp.default!r}")
    got, want, tol = call()
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol, rtol=tol)


@pytest.mark.gpu
def test_interpret_keeps_cuda_tensors_on_the_kernels():
    # ``interpret`` names the TPU kernels' interpreter: on the card every
    # wrapper still launches its CUDA kernel (its counter rises)
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("no CUDA card of capability 9.0: the kernels run only on the card")
    dev = torch.device("cuda")

    def t(a):
        return _t(a).to(dev)

    a, b = _quorum_pair()
    x = _normal(1, (30, 100))
    q, k, v = _normal(1, (1, 96, 4, 32)), _normal(2, (1, 96, 2, 32)), _normal(3, (1, 96, 2, 32))
    ssd_in = (_normal(1, (1, 64, 4, 16)), np.full((1, 64, 4), 0.02, np.float32),
              -np.ones(4, np.float32), _normal(2, (1, 64, 1, 16)), _normal(3, (1, 64, 1, 16)))
    calls = [
        (rms_ops, "launches", lambda: rms_ops.rmsnorm(t(x), t(x[0]), block_rows=4, interpret=True)),
        (swiglu_ops, "launches", lambda: swiglu_ops.swiglu(t(x), t(x), block_rows=4, interpret=True)),
        (flash_ops, "launches", lambda: flash_ops.flash_attention(
            t(q), t(k), t(v), block_q=32, block_k=32, interpret=True)),
        (quorum_ops, "launches", lambda: quorum_ops.quorum_compare(t(a), t(b), interpret=True)),
        (quorum_ops, "launches", lambda: quorum_ops.tree_quorum_agree(
            {"w": t(a)}, {"w": t(b)}, interpret=True)),
        (int8_ops, "launches_quantize", lambda: int8_ops.int8_quantize(t(x), interpret=True)),
        (int8_ops, "launches_dequantize", lambda: int8_ops.int8_dequantize(
            *int8_ops.int8_quantize(t(x)), n=x.size, shape=x.shape, interpret=True)),
        (int8_ops, "launches_dequantize", lambda: int8_ops.quantize_dequantize(t(x), interpret=True)),
        (ssd_ops, "launches", lambda: ssd_ops.ssd_scan(*map(t, ssd_in), interpret=True)),
    ]
    for mod, counter, call in calls:
        before = getattr(mod, counter)
        call()
        torch.cuda.synchronize()
        assert getattr(mod, counter) > before, (mod.__name__, counter)


# ---------------------------------------------------------------------------
# Every public function of every module pair
# ---------------------------------------------------------------------------

EXTRA_OK = ("device", "params", "initial_state")  # trailing, with a default
RENAMED_OK = {"key": "generator"}
# (module, function): why the difference stands
KNOWN = {
    ("distributed.hlo_analysis", "collective_stats"):
        "the collective statistics come with the production meshes (ROADMAP.md, Queue A 10b.2)",
    ("distributed.hlo_costs", "analyze_module"):
        "parses XLA's HLO text; the port has no HLO and counts aten ops (count_costs)",
    ("launch.roofline_table", "render_table"):
        "one H100's table (mesh '1x1', a fits column) until the production meshes (Queue A 10b.2)",
    ("launch.roofline_table", "pick_hillclimb"):
        "one H100's table (mesh_filter) until the production meshes (Queue A 10b.2)",
    ("models.layers", "swiglu"):
        "the kernel op itself: its keyword-only block_rows and interpret are the reference kernel's",
}
# ``repro.launch`` has no ``__init__``, so the walk does not reach it
LAUNCH = ["repro.launch." + n for n in ("dryrun", "mesh", "perf_iter", "roofline_table")]
SIMPLE = (bool, int, float, str, tuple, type(None))


def _module_pairs():
    import repro

    names = [m.name for m in pkgutil.walk_packages(repro.__path__, "repro.")] + LAUNCH
    pairs = []
    for name in sorted(names):
        port = "repro_torch." + name[len("repro."):]
        if name.endswith("__main__") or importlib.util.find_spec(port) is None:
            continue  # kernels/*/kernel.py and core/jax_backend: their counterparts are csrc/*.cu, torch_backend
        pairs.append(name[len("repro."):])
    return pairs


def _same_default(port, ref):
    if ref is jnp.float32:  # a dtype default: the same type in each framework
        return port is torch.float32
    return port == ref or (port is inspect.Parameter.empty and ref is inspect.Parameter.empty)


def _signature_faults(ref_fn, port_fn):
    rp = list(inspect.signature(ref_fn).parameters.values())
    pp = list(inspect.signature(port_fn).parameters.values())
    faults = []
    for i, r in enumerate(rp):
        if i >= len(pp):
            return faults + [f"lacks {r.name!r}"]
        p = pp[i]
        if p.name != r.name and RENAMED_OK.get(r.name) != p.name:
            faults.append(f"parameter {i} is {p.name!r}, the reference's {r.name!r}")
        if p.kind != r.kind:
            faults.append(f"{r.name}: kind {p.kind.name}, the reference's {r.kind.name}")
        if (p.default is inspect.Parameter.empty) != (r.default is inspect.Parameter.empty):
            faults.append(f"{r.name}: a default on one side only")
        elif isinstance(r.default, SIMPLE) and not _same_default(p.default, r.default):
            faults.append(f"{r.name}: default {p.default!r}, the reference's {r.default!r}")
    for p in pp[len(rp):]:
        if p.name not in EXTRA_OK or p.default is inspect.Parameter.empty:
            faults.append(f"adds {p.name!r}")
    return faults


@pytest.mark.parametrize("module", _module_pairs())
def test_public_functions_take_the_reference_parameters(module):
    with mock.patch.dict(os.environ):  # the reference's launch modules set XLA_FLAGS when imported
        ref = importlib.import_module("repro." + module)
    port = importlib.import_module("repro_torch." + module)
    faults = {}
    for name, ref_fn in vars(ref).items():
        if name.startswith("_") or not inspect.isfunction(ref_fn) or ref_fn.__module__ != ref.__name__:
            continue
        if (module, name) in KNOWN:
            continue
        port_fn = getattr(port, name, None)
        if not callable(port_fn):
            faults[name] = ["missing"]
            continue
        found = _signature_faults(ref_fn, port_fn)
        if found:
            faults[name] = found
    assert not faults, f"repro_torch.{module}: {faults}"


def test_the_module_walk_reaches_launch_and_the_step_builder():
    pairs = _module_pairs()
    assert {"launch.dryrun", "launch.mesh", "launch.perf_iter", "launch.roofline_table",
            "runtime.step_builder", "optim.compression", "models.attention", "models.layers"} <= set(pairs)
    assert len(pairs) >= 80


@pytest.mark.parametrize("interpret", [True, False])
def test_compression_takes_interpret_and_gives_the_reference_payload(interpret):
    # the reference runs its Pallas kernels on the CPU only in interpret mode,
    # so its payload is always the interpret=True one; the port's, under
    # either value, must equal it
    from repro.optim import compression as j_compression
    from repro_torch.optim import compression

    tree = {"b": _normal(3, (7,)), "w": _normal(4, (30, 100), 0.01)}
    got = compression.compress_tree({k: _t(v) for k, v in tree.items()}, interpret=interpret)
    want = j_compression.compress_tree({k: jnp.asarray(v) for k, v in tree.items()}, interpret=True)
    for g, w in zip(got["payload"], want["payload"]):
        np.testing.assert_array_equal(g["q"].numpy(), np.asarray(w["q"]))
        np.testing.assert_array_equal(g["s"].numpy(), np.asarray(w["s"]))
        assert (g["n"], tuple(g["shape"]), g["dtype"]) == (w["n"], tuple(w["shape"]), w["dtype"])
    back = compression.decompress_tree(got, interpret=interpret)
    want_back = j_compression.decompress_tree(want, interpret=True)
    for k in tree:
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(want_back[k]))
    grads = {k: _t(v) for k, v in tree.items()}
    qs, rs = compression.ef_quantize_tree(grads, compression.init_residual(grads), interpret=interpret)
    jqs, jrs = j_compression.ef_quantize_tree({k: jnp.asarray(v) for k, v in tree.items()},
                                              j_compression.init_residual(tree), interpret=True)
    for k in tree:
        np.testing.assert_allclose(qs[k].numpy(), np.asarray(jqs[k]), rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(rs[k].numpy(), np.asarray(jrs[k]), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("s_q,s_k,offset", [(4, 4, 0), (3, 7, 4), (5, 2, 0), (1, 9, 8), (6, 6, -2)])
def test_causal_mask_is_the_reference_mask(s_q, s_k, offset):
    from repro.models.layers import causal_mask as j_causal_mask
    from repro_torch.models.layers import causal_mask

    got = causal_mask(s_q, s_k, offset, device="cpu")
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_causal_mask(s_q, s_k, offset)))
