"""The port's int8 block-quant kernels against the reference's.

On the CPU the wrappers take the plain versions (``repro_torch/kernels/
int8_quant/ref.py``); they are held bit for bit against the reference's
Pallas kernels run in interpret mode: the int8 codes and the f32 scales
array-equal, the dequantized values array-equal at f32 and bf16 output, on
the shapes of ``tests/test_kernels.py`` (``TestInt8Quant``) plus a 1-D
leaf, a ragged (28, 128) leaf (14 rows, one tile of 14), a (300, 257) leaf
(two tiles, zero-padded rows), f32 and bf16 inputs, and rounding ties.

Against the reference's jnp oracle the codes and the dequantized values are
array-equal and the scales agree to rtol 1e-6, as ``tests/test_kernels.py``
holds the Pallas kernel to its oracle: XLA compiles the kernel's
``amax / 127.0`` as a multiply by the f32 reciprocal of 127, the eager
oracle divides, and about 4% of tiles differ by one ulp in their scale
(``test_scale_is_the_kernels_reciprocal_multiply``). The port follows the
kernel.

Cases marked ``gpu`` hold the CUDA kernels bit for bit against the plain
versions on the card; they skip without a card of capability 9.0 or newer::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_int8.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.int8_quant import ops  # noqa: E402
from repro_torch.kernels.int8_quant.ref import int8_dequantize_ref, int8_quantize_ref  # noqa: E402

SHAPES = [(100, 300), (17,), (4, 5, 6), (512, 256), (1024,), (28, 128), (300, 257)]
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _normal(seed, shape, scale=3.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _np(t):
    return t.float().cpu().numpy() if t.dtype == torch.bfloat16 else t.cpu().numpy()


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.int8_quant import ops as j_ops
    from repro.kernels.int8_quant.ref import int8_dequantize_ref as j_deq_ref
    from repro.kernels.int8_quant.ref import int8_quantize_ref as j_q_ref

    return jax, jnp, j_ops, j_q_ref, j_deq_ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels run only on the card")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip(f"the kernels are built for sm_90a; card is {torch.cuda.get_device_name(0)}")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# Plain versions against the reference (CPU)
# ---------------------------------------------------------------------------


class TestPlainAgainstReference:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("shape", SHAPES)
    def test_quantize_matches_pallas_and_oracle(self, ref, shape, dtype):
        jax, jnp, j_ops, j_q_ref, _ = ref
        x = _normal(0, shape)
        q, s = j_ops.int8_quantize(jnp.asarray(x, dtype=dtype), interpret=True)
        launches = ops.launches_quantize
        tq, ts = ops.int8_quantize(torch.from_numpy(x).to(TORCH_DT[dtype]))
        assert ops.launches_quantize == launches  # the CPU takes the plain version
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(s))
        # and the jnp oracle on the same padded rows (scales: see the docstring)
        rows2d, br = ops.to_rows(torch.from_numpy(x).to(TORCH_DT[dtype]))
        oq, os_ = j_q_ref(jnp.asarray(_np(rows2d), dtype=dtype), br)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(oq))
        np.testing.assert_allclose(ts.numpy(), np.asarray(os_), rtol=1e-6)

    @pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("shape", SHAPES)
    def test_dequantize_matches_pallas(self, ref, shape, out_dtype):
        jax, jnp, j_ops, _, j_deq_ref = ref
        x = _normal(1, shape)
        q, s = j_ops.int8_quantize(jnp.asarray(x), interpret=True)
        want = j_ops.int8_dequantize(q, s, n=x.size, shape=shape, out_dtype=jnp.dtype(out_dtype),
                                     interpret=True)
        tq, ts = torch.from_numpy(np.array(q)), torch.from_numpy(np.array(s))
        launches = ops.launches_dequantize
        got = ops.int8_dequantize(tq, ts, n=x.size, shape=shape, out_dtype=TORCH_DT[out_dtype])
        assert ops.launches_dequantize == launches
        assert got.dtype == TORCH_DT[out_dtype] and tuple(got.shape) == shape
        np.testing.assert_array_equal(_np(got), np.asarray(want.astype(jnp.float32)))
        br = min(256, q.shape[0])
        oracle = j_deq_ref(q, s, br, jnp.dtype(out_dtype))
        np.testing.assert_array_equal(_np(ops.dequantize_rows(tq, ts, br, TORCH_DT[out_dtype])),
                                      np.asarray(oracle.astype(jnp.float32)))

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("shape", [(100, 300), (17,), (4, 5, 6)])
    def test_round_trip_matches_reference(self, ref, shape, dtype):
        jax, jnp, j_ops, _, _ = ref
        x = _normal(2, shape)
        want = j_ops.quantize_dequantize(jnp.asarray(x, dtype=dtype), interpret=True)
        got = ops.quantize_dequantize(torch.from_numpy(x).to(TORCH_DT[dtype]))
        assert got.dtype == TORCH_DT[dtype]
        np.testing.assert_array_equal(_np(got), np.asarray(want.astype(jnp.float32)))
        # the error bound of tests/test_kernels.py
        if dtype == "float32":
            assert np.abs(_np(got) - x).max() <= np.abs(x).max() / 127.0 + 1e-7

    @pytest.mark.parametrize("block_rows", [64, 100])
    def test_block_rows_match_reference(self, ref, block_rows):
        jax, jnp, j_ops, _, _ = ref
        x = _normal(3, (300, 257))
        q, s = j_ops.int8_quantize(jnp.asarray(x), block_rows=block_rows, interpret=True)
        tq, ts = ops.int8_quantize(torch.from_numpy(x), block_rows=block_rows)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(s))
        got = ops.int8_dequantize(tq, ts, n=x.size, shape=x.shape, block_rows=block_rows)
        want = j_ops.int8_dequantize(q, s, n=x.size, shape=x.shape, block_rows=block_rows,
                                     interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_ties_round_half_to_even_and_zero_tiles(self, ref):
        jax, jnp, j_ops, _, _ = ref
        # tile amax 127 -> scale exactly 1.0: x / scale hits the .5 ties
        ties = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5], np.float32)
        x = np.zeros((2, 256), np.float32)
        x[0, : ties.size] = ties  # row 1 stays zero: an all-zero tile of its own below
        for block_rows in (2, 1):
            q, s = j_ops.int8_quantize(jnp.asarray(x), block_rows=block_rows, interpret=True)
            tq, ts = ops.int8_quantize(torch.from_numpy(x), block_rows=block_rows)
            np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
            np.testing.assert_array_equal(ts.numpy(), np.asarray(s))
        assert tq[0, : ties.size].tolist() == [127, 0, 2, 2, 0, -2, -2, 126, -126]
        assert ts[1, 0].item() == np.float32(1e-12)

    def test_plain_versions_against_the_reference_oracles(self, ref):
        jax, jnp, _, j_q_ref, j_deq_ref = ref
        x = _normal(4, (512, 256))
        q, s = int8_quantize_ref(torch.from_numpy(x), 128)
        oq, os_ = j_q_ref(jnp.asarray(x), 128)
        np.testing.assert_array_equal(q.numpy(), np.asarray(oq))
        np.testing.assert_allclose(s.numpy(), np.asarray(os_), rtol=1e-6)
        np.testing.assert_array_equal(int8_dequantize_ref(q, s, 128).numpy(),
                                      np.asarray(j_deq_ref(q.numpy(), s.numpy(), 128)))

    def test_scale_is_the_kernels_reciprocal_multiply(self, ref):
        jax, jnp, _, j_q_ref, _ = ref
        from repro.kernels.int8_quant.kernel import int8_quantize_kernel

        rng = np.random.default_rng(8)
        x = (rng.standard_normal((1000, 256)) * rng.uniform(0.01, 100, (1000, 1))).astype(np.float32)
        q, s = int8_quantize_kernel(jnp.asarray(x), block_rows=1, interpret=True)
        tq, ts = int8_quantize_ref(torch.from_numpy(x), 1)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(s))
        amax = np.abs(x).max(axis=1, keepdims=True)
        np.testing.assert_array_equal(np.asarray(s), amax * np.float32(1 / 127))
        _, os_ = j_q_ref(jnp.asarray(x), 1)
        # the oracle divides: one ulp apart in 44 of these 1000 tiles
        assert int((np.asarray(os_) != np.asarray(s)).sum()) == 44


def test_wrappers_take_no_plain_path_off_the_cpu(monkeypatch):
    # a meta tensor (the dry run's) gets outputs of the kernels' shapes and
    # dtypes: neither the plain version nor a kernel runs
    def refuse(*args, **kwargs):
        raise AssertionError("a plain version or a kernel ran off the CPU")

    for name in ("int8_quantize_ref", "int8_dequantize_ref"):
        monkeypatch.setattr(ops, name, refuse)
    monkeypatch.setattr(ops._build, "entry", refuse)
    x = torch.empty(4, 256, device="meta")
    q, scales = ops.int8_quantize(x)
    assert (q.device.type, q.shape, q.dtype, scales.shape, scales.dtype) == (
        "meta", (4, 256), torch.int8, (1, 1), torch.float32)
    out = ops.dequantize_rows(torch.empty(4, 256, dtype=torch.int8, device="meta"),
                              torch.empty(1, 1, device="meta"), 4, torch.bfloat16)
    assert (out.device.type, out.shape, out.dtype) == ("meta", (4, 256), torch.bfloat16)
    with pytest.raises(ValueError):
        ops.int8_quantize(torch.empty(0))


# ---------------------------------------------------------------------------
# CUDA kernels against their plain versions (on the card)
# ---------------------------------------------------------------------------


@pytest.mark.gpu
class TestKernelsOnCard:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("shape", SHAPES + [(152064, 1024), (3, 1024), (1, 1)])
    def test_quantize_and_dequantize(self, cuda, shape, dtype):
        x = torch.from_numpy(_normal(5, shape)).to(cuda, TORCH_DT[dtype])
        rows2d, br = ops.to_rows(x)
        launches = ops.launches_quantize
        q, s = ops.int8_quantize(x)
        torch.cuda.synchronize()
        assert ops.launches_quantize == launches + 1
        want_q, want_s = int8_quantize_ref(rows2d, br)
        assert torch.equal(q, want_q) and torch.equal(s, want_s)
        for out_dtype in (torch.float32, torch.bfloat16):
            launches = ops.launches_dequantize
            got = ops.int8_dequantize(q, s, n=x.numel(), shape=tuple(shape), out_dtype=out_dtype)
            torch.cuda.synchronize()
            assert ops.launches_dequantize == launches + 1
            want = int8_dequantize_ref(q, s, br, out_dtype).reshape(-1)[: x.numel()].reshape(shape)
            assert got.dtype == out_dtype and torch.equal(got, want)

    def test_misaligned_views_take_the_scalar_loop(self, cuda):
        # a view one element in: no 16-byte loads; 2 x 256 elements, no padding copy
        base = torch.from_numpy(_normal(6, (2 * 256 + 1,))).to(cuda)
        x = base[1:]
        q, s = ops.int8_quantize(x)
        want_q, want_s = int8_quantize_ref(x.view(2, 256), 2)
        assert torch.equal(q, want_q) and torch.equal(s, want_s)
        qbuf = torch.zeros(2 * 256 + 1, dtype=torch.int8, device=cuda)
        qv = qbuf[1:].view(2, 256)
        qv.copy_(q)
        got = ops.dequantize_rows(qv, s, 2)
        assert torch.equal(got, int8_dequantize_ref(q, s, 2))

    def test_non_finite_tile_scale_propagates_like_the_plain_version(self, cuda):
        x = torch.from_numpy(_normal(7, (4, 256))).to(cuda)
        x[1, 3] = float("nan")
        x[3, 0] = float("inf")
        _, s = ops.int8_quantize(x, block_rows=1)
        _, want_s = int8_quantize_ref(x, 1)
        assert torch.equal(s.isnan(), want_s.isnan()) and torch.equal(s.isinf(), want_s.isinf())
        finite = torch.isfinite(want_s)
        assert torch.equal(s[finite], want_s[finite])
