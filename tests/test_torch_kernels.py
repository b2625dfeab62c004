"""The port's kernels against the reference's.

On the CPU, each kernel's plain version (``repro_torch/kernels/*/ref.py``,
which every wrapper takes for a CPU tensor) is held against the reference's
Pallas kernel run in interpret mode and against its jnp oracle, on the shape
and dtype sweeps of ``tests/test_kernels.py``, with its tolerances.

Cases marked ``gpu`` hold each CUDA kernel against its plain version on the
card; they skip without a card of capability 9.0 or newer. JAX is imported
only by the reference cases, so the ``gpu`` cases also run where JAX is not
installed::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels.py
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rms_ops  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref  # noqa: E402
from repro_torch.kernels.swiglu import ops as swiglu_ops  # noqa: E402
from repro_torch.kernels.swiglu.ref import swiglu_ref  # noqa: E402

# (b, s, h, kv, d, causal, dtype) — the sweep of tests/test_kernels.py
FLASH_CASES = [
    (2, 256, 8, 4, 64, True, "float32"),
    (1, 384, 4, 1, 128, True, "float32"),
    (2, 200, 4, 4, 48, False, "float32"),
    (1, 256, 8, 2, 128, False, "float32"),
    (1, 256, 4, 2, 64, True, "bfloat16"),
    (1, 130, 2, 2, 32, True, "float32"),  # ragged: S not a multiple of the tile
]
RMS_SHAPES = [(4, 256), (3, 77, 256), (2, 5, 8, 128)]
SWIGLU_SHAPES = [(16, 128), (5, 100, 128), (1, 7, 384)]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _np32(t):
    return t.float().cpu().numpy()


@pytest.fixture(scope="module")
def ref():
    """The reference package's kernels, run on the CPU."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.flash_attention.ops import flash_attention
    from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref
    from repro.kernels.rmsnorm.ops import rmsnorm
    from repro.kernels.rmsnorm.ref import rmsnorm_ref as j_rmsnorm_ref
    from repro.kernels.swiglu.ops import swiglu
    from repro.kernels.swiglu.ref import swiglu_ref as j_swiglu_ref

    return SimpleNamespace(
        jax=jax, jnp=jnp, flash_attention=flash_attention, attention_ref=j_attention_ref,
        rmsnorm=rmsnorm, rmsnorm_ref=j_rmsnorm_ref, swiglu=swiglu, swiglu_ref=j_swiglu_ref,
    )


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels run only on the card")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip(f"the kernels are built for sm_90a; card is {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# Plain versions against the reference (CPU)
# ---------------------------------------------------------------------------


class TestPlainAgainstReference:
    @pytest.mark.parametrize("b,s,h,kv,d,causal,dtype", FLASH_CASES)
    def test_flash_attention(self, ref, b, s, h, kv, d, causal, dtype):
        q32, k32, v32 = (_normal(i, shp) for i, shp in
                         enumerate([(b, s, h, d), (b, s, kv, d), (b, s, kv, d)]))
        jdt = getattr(ref.jnp, dtype)
        jq, jk, jv = (ref.jnp.asarray(x).astype(jdt) for x in (q32, k32, v32))
        pallas = ref.flash_attention(jq, jk, jv, causal=causal, interpret=True)
        jh = [ref.jnp.moveaxis(x, 1, 2) for x in (jq, jk, jv)]
        oracle = ref.jnp.moveaxis(ref.attention_ref(*jh, causal=causal), 1, 2)
        tq, tk, tv = (torch.from_numpy(x).to(TORCH_DT[dtype]) for x in (q32, k32, v32))
        launches = flash_ops.launches
        out = flash_ops.flash_attention(tq, tk, tv, causal=causal)
        assert flash_ops.launches == launches  # the CPU path launches nothing
        assert out.shape == (b, s, h, d) and out.dtype == TORCH_DT[dtype]
        tol = FLASH_TOL[dtype]
        for want in (pallas, oracle):
            np.testing.assert_allclose(_np32(out), np.asarray(want, np.float32), atol=tol, rtol=tol)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("shape", RMS_SHAPES)
    def test_rmsnorm(self, ref, shape, dtype):
        x32, sc = _normal(7, shape), _normal(1, (shape[-1],))
        jdt = getattr(ref.jnp, dtype)
        jx = ref.jnp.asarray(x32).astype(jdt)
        pallas = ref.rmsnorm(jx, ref.jnp.asarray(sc), interpret=True)
        oracle = ref.rmsnorm_ref(jx, ref.jnp.asarray(sc))
        launches = rms_ops.launches
        out = rms_ops.rmsnorm(torch.from_numpy(x32).to(TORCH_DT[dtype]), torch.from_numpy(sc))
        assert rms_ops.launches == launches
        assert out.dtype == TORCH_DT[dtype]
        tol = TOL[dtype]
        for want in (pallas, oracle):
            np.testing.assert_allclose(_np32(out), np.asarray(want, np.float32), atol=tol, rtol=tol)

    @pytest.mark.parametrize("shape", SWIGLU_SHAPES)
    def test_swiglu(self, ref, shape):
        g, u = _normal(7, shape), _normal(3, shape)
        pallas = ref.swiglu(ref.jnp.asarray(g), ref.jnp.asarray(u), interpret=True)
        oracle = ref.swiglu_ref(ref.jnp.asarray(g), ref.jnp.asarray(u))
        launches = swiglu_ops.launches
        out = swiglu_ops.swiglu(torch.from_numpy(g), torch.from_numpy(u))
        assert swiglu_ops.launches == launches
        for want in (pallas, oracle):
            np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-6)

    def test_flash_plain_is_the_reference_oracle_layout(self):
        # attention_ref takes (B, H, S, D) like the reference's oracle; the
        # wrapper's CPU path moves the model layout (B, S, H, D) around it
        q, k, v = (torch.from_numpy(_normal(i, (1, 40, 4, 16))) for i in range(3))
        kh = k[:, :, ::2]  # 2 KV heads: query heads 0,1 -> KV 0; 2,3 -> KV 1
        vh = v[:, :, ::2]
        out = flash_ops.flash_attention(q, kh.contiguous(), vh.contiguous(), causal=True)
        full = attention_ref(q.movedim(1, 2), kh.repeat_interleave(2, dim=2).movedim(1, 2),
                             vh.repeat_interleave(2, dim=2).movedim(1, 2), causal=True)
        torch.testing.assert_close(out, full.movedim(1, 2), atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# CUDA kernels against their plain versions (on the card)
# ---------------------------------------------------------------------------


@pytest.mark.gpu
class TestKernelsOnCard:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("shape", RMS_SHAPES + [(700, 1024), (700, 16, 128), (5, 77), (3, 4096)])
    def test_rmsnorm(self, cuda, shape, dtype):
        x = torch.from_numpy(_normal(7, shape)).to(cuda, TORCH_DT[dtype])
        sc = torch.from_numpy(_normal(1, (shape[-1],))).to(cuda)
        launches = rms_ops.launches
        out = rms_ops.rmsnorm(x, sc)
        torch.cuda.synchronize()
        assert rms_ops.launches == launches + 1
        want = rmsnorm_ref(x, sc)
        tol = TOL[dtype]
        torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("shape", SWIGLU_SHAPES + [(700, 3072)])
    def test_swiglu(self, cuda, shape, dtype):
        g = torch.from_numpy(_normal(7, shape)).to(cuda, TORCH_DT[dtype])
        u = torch.from_numpy(_normal(3, shape)).to(cuda, TORCH_DT[dtype])
        launches = swiglu_ops.launches
        out = swiglu_ops.swiglu(g, u)
        torch.cuda.synchronize()
        assert swiglu_ops.launches == launches + 1
        tol = 1e-6 if dtype == "float32" else 2e-2
        torch.testing.assert_close(out.float(), swiglu_ref(g, u).float(), atol=tol, rtol=tol)

    @pytest.mark.parametrize(
        "b,s,h,kv,d,causal,dtype",
        FLASH_CASES + [(1, 300, 16, 8, 128, True, "bfloat16"), (1, 700, 16, 8, 128, True, "bfloat16"),
                       (2, 97, 6, 3, 128, True, "float32"), (1, 1, 16, 8, 128, True, "bfloat16")],
    )
    def test_flash_attention(self, cuda, b, s, h, kv, d, causal, dtype):
        q, k, v = (torch.from_numpy(_normal(i, shp)).to(cuda, TORCH_DT[dtype]) for i, shp in
                   enumerate([(b, s, h, d), (b, s, kv, d), (b, s, kv, d)]))
        launches = flash_ops.launches
        out = flash_ops.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert flash_ops.launches == launches + 1
        want = attention_ref(q.movedim(1, 2), k.movedim(1, 2), v.movedim(1, 2),
                             causal=causal).movedim(1, 2)
        tol = FLASH_TOL[dtype]
        torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)

    def test_flash_attention_reads_strided_inputs(self, cuda):
        # q, k, v as slices of one fused projection: strided heads, no copy
        b, s, h, kv, d = 1, 150, 4, 2, 64
        qkv = torch.from_numpy(_normal(5, (b, s, h + 2 * kv, d))).to(cuda)
        q, k, v = qkv[:, :, :h], qkv[:, :, h:h + kv], qkv[:, :, h + kv:]
        out = flash_ops.flash_attention(q, k, v, causal=True)
        want = flash_ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
        torch.testing.assert_close(out, want, atol=0, rtol=0)
