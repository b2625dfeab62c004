"""The port's gradient compression against the reference's, on the CPU.

* The wire format crosses between the packages: the reference's
  ``compress_tree`` (Pallas kernels in interpret mode) decompressed by the
  port, and the port's decompressed by the reference, array-equal both
  ways; the payloads themselves (codes, scales, ``n``, ``shape``, the
  ``dtype`` string) equal, leaf by leaf in sorted-key order; and
  ``compressed_bytes`` equal.
* ``ef_quantize_tree``: 50 steps of error feedback (the case of
  ``tests/test_substrate.py``) give the reference's quantized sums and
  residuals to rtol 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.optim import compression as j_comp  # noqa: E402
from repro_torch.kernels.int8_quant import ops as int8_ops  # noqa: E402
from repro_torch.models.layers import tree_leaves, tree_map  # noqa: E402
from repro_torch.optim import (  # noqa: E402
    compress_tree,
    compressed_bytes,
    decompress_tree,
    ef_quantize_tree,
    init_residual,
)


def _tree():
    """Numpy leaves: an odd 2-D leaf, a short 1-D leaf, a nested dict with a
    leaf of two tiles and a bf16 leaf (kept as f32 values exact in bf16)."""
    rng = np.random.default_rng(0)
    bf = rng.standard_normal((3, 300)).astype(np.float32)
    bf = np.array(jnp.asarray(bf, jnp.bfloat16).astype(jnp.float32))
    return {
        "b": np.ones((7,), np.float32),
        "a": (rng.standard_normal((100, 4)) * 5).astype(np.float32),
        "layers": {"w": rng.standard_normal((300, 257)).astype(np.float32), "h": bf},
    }


def _as_jax(tree):
    out = jax.tree_util.tree_map(jnp.asarray, tree)
    out["layers"]["h"] = out["layers"]["h"].astype(jnp.bfloat16)
    return out


def _as_torch(tree):
    out = {k: torch.from_numpy(v) for k, v in tree.items() if k != "layers"}
    out["layers"] = {"w": torch.from_numpy(tree["layers"]["w"]),
                     "h": torch.from_numpy(tree["layers"]["h"]).to(torch.bfloat16)}
    return out


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


@pytest.fixture(scope="module")
def packed():
    tree = _tree()
    return _as_jax(tree), _as_torch(tree), j_comp.compress_tree(_as_jax(tree)), compress_tree(_as_torch(tree))


def test_payloads_equal(packed):
    _, _, jp, tp = packed
    assert len(jp["payload"]) == len(tp["payload"]) == 4
    for j_item, t_item in zip(jp["payload"], tp["payload"]):
        assert t_item["q"].dtype == torch.int8 and t_item["s"].dtype == torch.float32
        np.testing.assert_array_equal(t_item["q"].numpy(), np.asarray(j_item["q"]))
        np.testing.assert_array_equal(t_item["s"].numpy(), np.asarray(j_item["s"]))
        assert t_item["n"] == j_item["n"]
        assert t_item["shape"] == j_item["shape"]
        assert t_item["dtype"] == j_item["dtype"]  # "float32", "bfloat16"
    assert [i["dtype"] for i in tp["payload"]] == ["float32", "float32", "bfloat16", "float32"]
    assert compressed_bytes(tp) == j_comp.compressed_bytes(jp)


def test_reference_payload_decompresses_in_the_port(packed):
    jtree, ttree, jp, _ = packed
    want = j_comp.decompress_tree(jp)
    # the reference's payload as it would arrive: numpy codes and scales
    wire = {"treedef": tree_map(lambda _: None, _tree()),
            "payload": [{**i, "q": torch.from_numpy(np.array(i["q"])),
                         "s": torch.from_numpy(np.array(i["s"]))} for i in jp["payload"]]}
    got = decompress_tree(wire)
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert str(g.dtype).replace("torch.", "") == str(w.dtype)
        np.testing.assert_array_equal(_np(g), _np(w))


def test_port_payload_decompresses_in_the_reference(packed):
    jtree, _, _, tp = packed
    got = decompress_tree(tp)
    wire = {"treedef": jax.tree_util.tree_structure(jtree),
            "payload": [{**i, "q": i["q"].numpy(), "s": i["s"].numpy()} for i in tp["payload"]]}
    want = j_comp.decompress_tree(wire)
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(_np(g), _np(w))
    assert got["layers"]["h"].dtype == torch.bfloat16 and got["a"].shape == (100, 4)


def test_cpu_tree_takes_the_plain_versions(packed):
    _, ttree, _, _ = packed
    before = (int8_ops.launches_quantize, int8_ops.launches_dequantize)
    out = decompress_tree(compress_tree(ttree))
    assert (int8_ops.launches_quantize, int8_ops.launches_dequantize) == before
    amax = np.abs(ttree["a"].numpy()).max()
    np.testing.assert_allclose(out["a"].numpy(), ttree["a"].numpy(), atol=amax / 100)


def test_error_feedback_matches_reference():
    rng = np.random.default_rng(1)
    g = {"w": (rng.standard_normal(256) * 1e-3).astype(np.float32),
         "v": (rng.standard_normal((3, 50)) * 2).astype(np.float32)}
    jg = jax.tree_util.tree_map(jnp.asarray, g)
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    jres, tres = j_comp.init_residual(jg), init_residual(tg)
    assert all(r.dtype == torch.float32 and not r.any() for r in tree_leaves(tres))
    j_total = jax.tree_util.tree_map(jnp.zeros_like, jg)
    t_total = {k: torch.zeros_like(v) for k, v in tg.items()}
    for _ in range(50):
        jq, jres = j_comp.ef_quantize_tree(jg, jres)
        tq, tres = ef_quantize_tree(tg, tres)
        j_total = jax.tree_util.tree_map(lambda a, b: a + b, j_total, jq)
        t_total = {k: t_total[k] + tq[k] for k in t_total}
    for k in g:
        np.testing.assert_allclose(t_total[k].numpy(), np.asarray(j_total[k]), rtol=1e-6)
        np.testing.assert_allclose(tres[k].numpy(), np.asarray(jres[k]), rtol=1e-6)
    # and the reference's own check: the sums track 50 true gradients
    np.testing.assert_allclose(t_total["w"].numpy(), g["w"] * 50, atol=np.abs(g["w"]).max() * 2)
