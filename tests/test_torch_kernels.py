"""The port's kernels against the reference's.

On the CPU, each kernel's plain version (``repro_torch/kernels/*/ref.py``,
which every wrapper takes for a CPU tensor) is held against the reference's
Pallas kernel run in interpret mode and against its jnp oracle, on the shape
and dtype sweeps of ``tests/test_kernels.py``, with its tolerances. The
backward kernels have no Pallas counterpart (the reference differentiates
its jnp functions with XLA): their plain versions are held against
``jax.vjp`` of ``repro.models.layers.rms_norm``, ``repro.models.layers.swiglu``
and ``repro.kernels.flash_attention.ref.attention_ref``, at f32 to 2e-5 and
bf16 to 2e-2. quorum_compare's count is held bit-equal and its sum of
squares to rtol 1e-5.

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
hypothesis = pytest.importorskip("hypothesis")  # optional dep: see requirements-dev.txt
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_ref  # noqa: E402
from repro_torch.kernels.quorum_compare import ops as quorum_ops  # noqa: E402
from repro_torch.kernels.quorum_compare.ref import (  # noqa: E402
    quorum_compare_ref,
    quorum_pair_counts_ref,
)
from repro_torch.kernels.rmsnorm import ops as rms_ops  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref, rmsnorm_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_ref, ssd_scan_bwd_ref, ssd_scan_ref  # noqa: E402
from repro_torch.kernels.swiglu import ops as swiglu_ops  # noqa: E402
from repro_torch.kernels.swiglu.ref import swiglu_bwd_ref, swiglu_ref  # noqa: E402

# (b, s, h, kv, d, causal, dtype) — the sweep of tests/test_kernels.py
FLASH_CASES = [
    (2, 256, 8, 4, 64, True, "float32"),
    (1, 384, 4, 1, 128, True, "float32"),
    (2, 200, 4, 4, 48, False, "float32"),
    (1, 256, 8, 2, 128, False, "float32"),
    (1, 256, 4, 2, 64, True, "bfloat16"),
    (1, 130, 2, 2, 32, True, "float32"),  # ragged: S not a multiple of the tile
    # past D = 128: D = 192 (padded to 256) and D = 256
    (1, 96, 4, 2, 192, True, "float32"),
    (1, 80, 2, 1, 256, True, "bfloat16"),
    # past D = 256 (the reference pads D to 384; the port's wide-D kernels)
    (1, 96, 2, 1, 320, True, "float32"),
    (1, 70, 4, 2, 257, False, "bfloat16"),
]
# the last three: mamba2's gated norm (1536), zamba2's (4096), pixtral's and
# llama4-scout's model width (5120)
RMS_SHAPES = [(4, 256), (3, 77, 256), (2, 5, 8, 128), (3, 1536), (2, 4096), (2, 5120)]
SWIGLU_SHAPES = [(16, 128), (5, 100, 128), (1, 7, 384)]
# the expert buffer (E, C, d_expert) of qwen3-moe-235b-a22b at a 700-token
# prefill and at a 4-slot decode step alike: 128 experts x 128 slots x 1536
MOE_EXPERT_BUFFER = (128, 128, 1536)
# the backward sweep adds GQA with D=48 (ragged lanes) to FLASH_CASES
FLASH_BWD_CASES = FLASH_CASES + [(1, 130, 4, 2, 48, False, "float32"),
                                 (1, 130, 4, 2, 48, True, "bfloat16")]
# bf16 cases for the tensor-core kernels on the card: zamba2's shared
# attention block at its prefill shape, a ragged S with D = 48 (padded to
# 64), GQA without the causal mask; MLA's q/k width at minicpm3-4b's prefill
# shape (D = 96, padded to 128) and at its smoke size (D = 24, padded to 64);
# hubert-xlarge's encoder (non-causal, D = 80 padded to 128, 1500 frames: a
# ragged last key tile) and pixtral-12b's 700-token prefill (32/8 heads)
FLASH_BF16_CASES = [(1, 700, 32, 32, 64, True, "bfloat16"), (1, 130, 4, 2, 48, True, "bfloat16"),
                    (1, 256, 8, 2, 128, False, "bfloat16"), (1, 700, 40, 40, 96, True, "bfloat16"),
                    (1, 130, 4, 4, 24, True, "bfloat16"), (1, 1500, 16, 16, 80, False, "bfloat16"),
                    (1, 700, 32, 8, 128, True, "bfloat16")]
# (b, s, h, p, g, n, with initial state, dtype): the mamba2 and zamba2
# prefill shapes, a ragged S, groups, a ragged P tile and N = 256
SSD_CASES = [
    (1, 700, 24, 64, 1, 128, False, "bfloat16"),
    (1, 700, 24, 64, 1, 128, True, "float32"),
    (1, 700, 64, 64, 1, 64, False, "bfloat16"),
    (2, 200, 8, 32, 2, 32, True, "float32"),
    (1, 130, 4, 40, 2, 16, True, "float32"),
    (3, 1, 6, 16, 3, 256, True, "bfloat16"),
    # the kernels' 64-position chunk edges
    (1, 1, 4, 64, 1, 128, True, "float32"),
    (1, 63, 4, 64, 1, 128, True, "bfloat16"),
    (1, 64, 4, 64, 1, 128, False, "float32"),
    (2, 65, 4, 64, 2, 64, True, "bfloat16"),
    # a long prompt with P = 128, N = 256 and 8 groups
    (1, 2048, 16, 128, 8, 256, True, "bfloat16"),
    (1, 2048, 16, 128, 8, 256, False, "float32"),
]
# the backward's cases: the forward's, the mamba2-130m and zamba2-1.2b
# training shapes (2 x 2048 tokens) in both types, and the shapes below
SSD_BWD_CASES = SSD_CASES + [
    (2, 2048, 24, 64, 1, 128, False, "bfloat16"),
    (2, 2048, 24, 64, 1, 128, False, "float32"),
    (2, 2048, 64, 64, 1, 64, False, "bfloat16"),
    (2, 2048, 64, 64, 1, 64, False, "float32"),
    # N % 4 != 0 (element accesses) in 8 groups; groups of 3 heads (clusters
    # of one head, three partials a group for the reduce)
    (1, 130, 16, 64, 8, 30, True, "bfloat16"),
    (1, 130, 16, 64, 8, 30, True, "float32"),
    (2, 100, 6, 32, 2, 6, True, "bfloat16"),
    (2, 100, 6, 32, 2, 6, False, "float32"),
]
# D past 128 on the card: the kD = 256 kernels (D = 192 padded to 256)
FLASH_WIDE_CASES = [(1, 300, 8, 4, 256, True, "bfloat16"), (1, 130, 4, 2, 192, False, "bfloat16"),
                    (2, 97, 4, 2, 256, True, "float32"), (1, 130, 4, 2, 192, False, "float32")]
# past the tile kernels' D = 256 on the card: the wide-D kernels, each D in
# both types, causal and not, with GQA
FLASH_PAST_TILE_CASES = [(1, 130, 4, 2, 257, True, "float32"), (1, 130, 4, 2, 257, False, "bfloat16"),
                         (2, 96, 4, 1, 320, False, "float32"), (1, 96, 4, 4, 320, True, "bfloat16"),
                         (1, 200, 4, 2, 512, True, "float32"), (1, 200, 4, 2, 512, True, "bfloat16")]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
BWD_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
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
    from repro.kernels.quorum_compare.ops import quorum_compare
    from repro.kernels.quorum_compare.ref import quorum_compare_ref as j_quorum_compare_ref
    from repro.models.layers import rms_norm as j_rms_norm
    from repro.models.layers import swiglu as j_swiglu
    from repro.kernels.rmsnorm.ops import rmsnorm
    from repro.kernels.rmsnorm.ref import rmsnorm_ref as j_rmsnorm_ref
    from repro.kernels.swiglu.ops import swiglu
    from repro.kernels.swiglu.ref import swiglu_ref as j_swiglu_ref

    return SimpleNamespace(
        jax=jax, jnp=jnp, flash_attention=flash_attention, attention_ref=j_attention_ref,
        rmsnorm=rmsnorm, rmsnorm_ref=j_rmsnorm_ref, swiglu=swiglu, swiglu_ref=j_swiglu_ref,
        quorum_compare=quorum_compare, quorum_compare_ref=j_quorum_compare_ref,
        rms_norm=j_rms_norm, model_swiglu=j_swiglu,
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
# Backward plain versions against jax.vjp, and quorum_compare (CPU)
# ---------------------------------------------------------------------------


def _close(actual, desired, tol, msg=""):
    np.testing.assert_allclose(_np32(actual), np.asarray(desired, np.float32), atol=tol, rtol=tol,
                               err_msg=msg)


class TestBackwardAgainstReference:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("shape", RMS_SHAPES)
    def test_rmsnorm_bwd(self, ref, shape, dtype):
        x32, sc, dy32 = _normal(7, shape), _normal(1, (shape[-1],)), _normal(2, shape)
        jdt = getattr(ref.jnp, dtype)
        jx, jdy = (ref.jnp.asarray(a).astype(jdt) for a in (x32, dy32))
        _, vjp = ref.jax.vjp(lambda x, s: ref.rms_norm({"scale": s}, x), jx, ref.jnp.asarray(sc))
        want_dx, want_ds = vjp(jdy)
        tx, tdy = (torch.from_numpy(a).to(TORCH_DT[dtype]) for a in (x32, dy32))
        launches = rms_ops.launches_bwd
        dx, ds = rms_ops.rmsnorm_bwd(tx, torch.from_numpy(sc), tdy)
        assert rms_ops.launches_bwd == launches  # the CPU path launches nothing
        assert dx.dtype == TORCH_DT[dtype] and ds.dtype == torch.float32
        tol = BWD_TOL[dtype]
        _close(dx, want_dx, tol, "dx")
        _close(ds, want_ds, tol, "dscale")

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("shape", SWIGLU_SHAPES)
    def test_swiglu_bwd(self, ref, shape, dtype):
        g32, u32, dh32 = _normal(7, shape), _normal(3, shape), _normal(4, shape)
        jdt = getattr(ref.jnp, dtype)
        jg, ju, jdh = (ref.jnp.asarray(a).astype(jdt) for a in (g32, u32, dh32))
        _, vjp = ref.jax.vjp(ref.model_swiglu, jg, ju)
        want_dg, want_du = vjp(jdh)
        tg, tu, tdh = (torch.from_numpy(a).to(TORCH_DT[dtype]) for a in (g32, u32, dh32))
        launches = swiglu_ops.launches_bwd
        dg, du = swiglu_ops.swiglu_bwd(tg, tu, tdh)
        assert swiglu_ops.launches_bwd == launches
        tol = BWD_TOL[dtype]
        _close(dg, want_dg, tol, "dgate")
        _close(du, want_du, tol, "dup")

    @pytest.mark.parametrize("b,s,h,kv,d,causal,dtype", FLASH_BWD_CASES)
    def test_flash_bwd(self, ref, b, s, h, kv, d, causal, dtype):
        shapes = [(b, s, h, d), (b, s, kv, d), (b, s, kv, d), (b, s, h, d)]
        q32, k32, v32, do32 = (_normal(i, shp) for i, shp in enumerate(shapes))
        jdt = getattr(ref.jnp, dtype)
        # the reference's oracle takes (B, H, S, D)
        jq, jk, jv, jdo = (ref.jnp.moveaxis(ref.jnp.asarray(a).astype(jdt), 1, 2)
                           for a in (q32, k32, v32, do32))
        _, vjp = ref.jax.vjp(lambda q, k, v: ref.attention_ref(q, k, v, causal=causal), jq, jk, jv)
        want = [ref.jnp.moveaxis(g, 1, 2) for g in vjp(jdo)]
        tq, tk, tv, tdo = (torch.from_numpy(a).to(TORCH_DT[dtype]) for a in (q32, k32, v32, do32))
        launches = flash_ops.launches, flash_ops.launches_bwd
        out, lse = flash_ops.flash_attention_fwd(tq, tk, tv, causal=causal, with_lse=True)
        assert lse.shape == (b, h, s) and lse.dtype == torch.float32
        grads = flash_ops.flash_attention_bwd(tq, tk, tv, out, lse, tdo, causal=causal)
        assert (flash_ops.launches, flash_ops.launches_bwd) == launches
        tol = BWD_TOL[dtype]
        for name, got, w in zip(("dq", "dk", "dv"), grads, want):
            assert got.dtype == TORCH_DT[dtype]
            _close(got, w, tol, name)

    def test_flash_lse_is_the_scores_logsumexp(self):
        q, k, v = (torch.from_numpy(_normal(i, (1, 70, 4, 16))) for i in range(3))
        kh, vh = k[:, :, :2].contiguous(), v[:, :, :2].contiguous()
        out, lse = flash_ops.flash_attention_fwd(q, kh, vh, causal=True, with_lse=True)
        s = torch.einsum("bqhd,bkhd->bhqk", q, kh.repeat_interleave(2, dim=2)) / 4.0
        s = s.masked_fill(torch.ones(70, 70, dtype=torch.bool).triu(1), -1e30)
        torch.testing.assert_close(lse, torch.logsumexp(s, -1), atol=1e-5, rtol=1e-5)
        assert flash_ops.flash_attention_fwd(q, kh, vh, causal=True)[1] is None  # serving: no lse
        torch.testing.assert_close(out, flash_ops.flash_attention(q, kh, vh, causal=True))

    @pytest.mark.parametrize("op", ["rmsnorm", "swiglu", "flash_attention"])
    def test_autograd_runs_the_plain_backward_on_the_cpu(self, op):
        # the autograd Functions' backward is the plain backward on the CPU
        x = torch.from_numpy(_normal(5, (2, 9, 4, 16))).requires_grad_()
        if op == "rmsnorm":
            sc = torch.from_numpy(_normal(6, (16,))).requires_grad_()
            y = rms_ops.rmsnorm(x, sc)
            inputs, plain = (x, sc), lambda: rmsnorm_ref(x, sc)
        elif op == "swiglu":
            u = torch.from_numpy(_normal(6, (2, 9, 4, 16))).requires_grad_()
            y = swiglu_ops.swiglu(x, u)
            inputs, plain = (x, u), lambda: swiglu_ref(x, u)
        else:
            kv = torch.from_numpy(_normal(6, (2, 9, 2, 16))).requires_grad_()
            y = flash_ops.flash_attention(x, kv, kv * 0.5, causal=True)
            inputs = (x, kv)
            plain = lambda: attention_ref(x.movedim(1, 2), kv.movedim(1, 2), (kv * 0.5).movedim(1, 2),  # noqa: E731
                                          causal=True).movedim(1, 2)
        dy = torch.from_numpy(_normal(8, tuple(y.shape)))
        got = torch.autograd.grad(y, inputs, dy)
        want = torch.autograd.grad(plain(), inputs, dy)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=2e-5, rtol=2e-5)


class TestQuorumCompareAgainstReference:
    # each new length compiles the Pallas kernel anew: fewer examples than
    # tests/test_kernels.py's 15 keep this file's run short
    @settings(max_examples=8, deadline=None, derandomize=True, database=None)
    @given(
        n=st.integers(min_value=10, max_value=5000),
        bad_frac=st.floats(min_value=0.0, max_value=0.2),
    )
    def test_bad_count_matches_pallas_and_oracle(self, ref, n, bad_frac):
        rng = np.random.default_rng(n)
        a = rng.standard_normal(n).astype(np.float32)
        b = a.copy()
        n_bad = int(n * bad_frac)
        if n_bad:
            b[:n_bad] += 1.0
        ja, jb = ref.jnp.asarray(a), ref.jnp.asarray(b)
        launches = quorum_ops.launches
        nb, sq = quorum_ops.quorum_compare(torch.from_numpy(a), torch.from_numpy(b),
                                           rtol=1e-5, atol=1e-6)
        assert quorum_ops.launches == launches
        assert nb.dtype == torch.int64 and int(nb) == n_bad
        for want_nb, want_sq in (
            ref.quorum_compare(ja, jb, rtol=1e-5, atol=1e-6, interpret=True),
            ref.quorum_compare_ref(ja, jb, rtol=1e-5, atol=1e-6),
        ):
            assert int(nb) == int(float(want_nb))
            np.testing.assert_allclose(float(sq), float(want_sq), rtol=1e-5)

    def test_count_is_numpy_isclose_at_the_boundary(self):
        # b spans magnitudes; a sits one f32 step either side of b's tolerance
        rtol, atol = 1e-4, 1e-6
        b = (np.random.default_rng(0).standard_normal(4096) *
             np.logspace(-8, 3, 4096)).astype(np.float32)
        tol = np.float32(atol) + np.float32(rtol) * np.abs(b)
        a = np.concatenate([b + tol, np.nextafter(b + tol, np.float32(np.inf)),
                            np.nextafter(b - tol, np.float32(-np.inf)), b - tol]).astype(np.float32)
        bb = np.concatenate([b] * 4)
        want = int(np.count_nonzero(~np.isclose(a, bb, rtol=rtol, atol=atol)))
        nb, _ = quorum_ops.quorum_compare(torch.from_numpy(a), torch.from_numpy(bb),
                                          rtol=rtol, atol=atol)
        assert int(nb) == want and 0 < want < a.size

    def test_plain_version_is_the_reference_oracle(self):
        a = _normal(1, (37, 11))
        b = a + _normal(2, (37, 11)) * 1e-3
        nb, sq = quorum_compare_ref(torch.from_numpy(a), torch.from_numpy(b), 1e-3, 1e-4)
        diff = np.abs(a - b)
        assert int(nb) == int(np.count_nonzero(diff > np.float32(1e-4) + np.float32(1e-3) * np.abs(b)))
        np.testing.assert_allclose(float(sq), float(np.sum(diff.astype(np.float64) ** 2)), rtol=1e-6)

    def test_tree_agreement(self):
        a = {"w": torch.ones((100, 7)), "b": torch.zeros((13,))}
        assert quorum_ops.tree_quorum_agree(a, {k: v + 1e-9 for k, v in a.items()})
        w = torch.ones((100, 7))
        w[0, 0] = 5.0
        assert not quorum_ops.tree_quorum_agree(a, {"w": w, "b": torch.zeros((13,))})
        assert not quorum_ops.tree_quorum_agree(a, {"w": torch.ones((100, 7))})  # missing leaf


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
    @pytest.mark.parametrize("shape", SWIGLU_SHAPES + [(700, 3072), MOE_EXPERT_BUFFER])
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
                       (2, 97, 6, 3, 128, True, "float32"), (1, 1, 16, 8, 128, True, "bfloat16")]
        + FLASH_BF16_CASES + FLASH_WIDE_CASES,
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

    @staticmethod
    def _flash_both_ways(q, k, v, do, causal):
        """Forward (with lse) and backward through the kernels, each held
        against its plain version at bf16's 2e-2; returns (out, dq, dk, dv)."""
        out, lse = flash_ops.flash_attention_fwd(q, k, v, causal=causal, with_lse=True)
        want_out, want_lse = attention_ref(q.movedim(1, 2), k.movedim(1, 2), v.movedim(1, 2),
                                           causal=causal, return_lse=True)
        torch.testing.assert_close(out.float(), want_out.movedim(1, 2).float(), atol=2e-2, rtol=2e-2)
        torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)
        grads = flash_ops.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
        want = attention_bwd_ref(q.movedim(1, 2), k.movedim(1, 2), v.movedim(1, 2),
                                 out.movedim(1, 2), lse, do.movedim(1, 2), causal=causal)
        for got, w in zip(grads, want):
            torch.testing.assert_close(got.float(), w.movedim(1, 2).float(), atol=2e-2, rtol=2e-2)
        return (out, *grads)

    def test_flash_bf16_reads_strided_qkv(self, cuda):
        # q, k, v as slices of one fused projection with D = 48: 96-byte rows,
        # 16-byte aligned, so the 16-byte copies read them in place; the
        # results equal those of contiguous copies bit for bit
        b, s, h, kv, d = 1, 150, 4, 2, 48
        qkv = torch.from_numpy(_normal(5, (b, s, h + 2 * kv, d))).to(cuda, torch.bfloat16)
        q, k, v = qkv[:, :, :h], qkv[:, :, h:h + kv], qkv[:, :, h + kv:]
        do = torch.from_numpy(_normal(6, (b, s, h, d))).to(cuda, torch.bfloat16)
        got = self._flash_both_ways(q, k, v, do, True)
        want = self._flash_both_ways(q.contiguous(), k.contiguous(), v.contiguous(), do, True)
        for g, w in zip(got, want):
            assert torch.equal(g, w)

    @pytest.mark.parametrize("d,width", [(40, 44), (36, 36)])
    def test_flash_bf16_two_byte_staging(self, cuda, d, width):
        # rows that the 16-byte copies cannot read: D = 40 as the first 40 of
        # 44 columns (88-byte rows), and D = 36 (72-byte rows); the C entry
        # point stages them with 2-byte loads
        b, s, h, kv = 1, 130, 4, 2
        q, k, v, do = (torch.from_numpy(_normal(i, (b, s, n, width))).to(cuda, torch.bfloat16)[..., :d]
                       for i, n in enumerate((h, kv, kv, h)))
        for causal in (True, False):
            self._flash_both_ways(q, k, v, do, causal)

    @pytest.mark.parametrize("b,s,h,kv,d,dtype", [(1, 700, 16, 8, 128, "bfloat16"),
                                                  (1, 700, 32, 32, 64, "bfloat16"),
                                                  (1, 700, 40, 40, 96, "bfloat16"),
                                                  (1, 130, 4, 4, 24, "bfloat16"),
                                                  (2, 97, 6, 3, 128, "float32")]
                             + [(b, s, h, kv, d, dt) for b, s, h, kv, d, _, dt in FLASH_WIDE_CASES])
    def test_flash_bwd_is_bit_equal_across_calls(self, cuda, b, s, h, kv, d, dtype):
        # no float atomics: the grid trainer's quorum compares replicas'
        # gradients, so equal inputs must give equal bits
        q, k, v, do = (torch.from_numpy(_normal(i, shp)).to(cuda, TORCH_DT[dtype]) for i, shp in
                       enumerate([(b, s, h, d), (b, s, kv, d), (b, s, kv, d), (b, s, h, d)]))
        out, lse = flash_ops.flash_attention_fwd(q, k, v, causal=True, with_lse=True)
        first = flash_ops.flash_attention_bwd(q, k, v, out, lse, do, causal=True)
        for _ in range(2):
            again = flash_ops.flash_attention_bwd(q, k, v, out, lse, do, causal=True)
            for x, y in zip(first, again):
                assert torch.equal(x, y)

    @pytest.mark.parametrize("b,s,h,kv,d,causal,dtype", FLASH_PAST_TILE_CASES)
    def test_flash_past_the_tile_kernels(self, cuda, b, s, h, kv, d, causal, dtype):
        # D > 256 runs the wide-D kernels, forward and backward, against the
        # plain versions; the backward repeats bit for bit
        shapes = [(b, s, h, d), (b, s, kv, d), (b, s, kv, d), (b, s, h, d)]
        q, k, v, do = (torch.from_numpy(_normal(i, shp)).to(cuda, TORCH_DT[dtype])
                       for i, shp in enumerate(shapes))
        wide = flash_ops.launches_wide, flash_ops.launches_wide_bwd
        out, lse = flash_ops.flash_attention_fwd(q, k, v, causal=causal, with_lse=True)
        want_out, want_lse = attention_ref(q.movedim(1, 2), k.movedim(1, 2), v.movedim(1, 2),
                                           causal=causal, return_lse=True)
        tol = FLASH_TOL[dtype]
        torch.testing.assert_close(out.float(), want_out.movedim(1, 2).float(), atol=tol, rtol=tol)
        torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)
        grads = flash_ops.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
        torch.cuda.synchronize()
        assert (flash_ops.launches_wide, flash_ops.launches_wide_bwd) == (wide[0] + 1, wide[1] + 1)
        want = attention_bwd_ref(q.movedim(1, 2), k.movedim(1, 2), v.movedim(1, 2),
                                 out.movedim(1, 2), lse, do.movedim(1, 2), causal=causal)
        tol = BWD_TOL[dtype]
        for got, w in zip(grads, want):
            assert got.dtype == q.dtype
            torch.testing.assert_close(got.float(), w.movedim(1, 2).float(), atol=tol, rtol=tol)
        for _ in range(2):
            again = flash_ops.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
            assert all(torch.equal(x, y) for x, y in zip(grads, again))

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("shape", RMS_SHAPES + [(4096, 1024), (65536, 128), (5, 77), (3, 1024)])
    def test_rmsnorm_bwd(self, cuda, shape, dtype):
        x, dy = (torch.from_numpy(_normal(i, shape)).to(cuda, TORCH_DT[dtype]) for i in (7, 2))
        sc = torch.from_numpy(_normal(1, (shape[-1],))).to(cuda)
        launches = rms_ops.launches_bwd
        dx, ds = rms_ops.rmsnorm_bwd(x, sc, dy)
        torch.cuda.synchronize()
        assert rms_ops.launches_bwd == launches + 1
        want_dx, want_ds = rmsnorm_bwd_ref(x, sc, dy)
        tol = BWD_TOL[dtype]
        torch.testing.assert_close(dx.float(), want_dx.float(), atol=tol, rtol=tol)
        # dscale sums every row: f32 rounding grows with the row count
        torch.testing.assert_close(ds, want_ds, atol=1e-3, rtol=1e-4)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("shape", SWIGLU_SHAPES + [(4096, 3072), MOE_EXPERT_BUFFER])
    def test_swiglu_bwd(self, cuda, shape, dtype):
        g, u, dh = (torch.from_numpy(_normal(i, shape)).to(cuda, TORCH_DT[dtype]) for i in (7, 3, 4))
        launches = swiglu_ops.launches_bwd
        dg, du = swiglu_ops.swiglu_bwd(g, u, dh)
        torch.cuda.synchronize()
        assert swiglu_ops.launches_bwd == launches + 1
        tol = 1e-5 if dtype == "float32" else 2e-2
        for got, want in zip((dg, du), swiglu_bwd_ref(g, u, dh)):
            torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)

    @pytest.mark.parametrize(
        "b,s,h,kv,d,causal,dtype",
        FLASH_BWD_CASES + [(2, 2048, 16, 8, 128, True, "bfloat16"),
                           (2, 97, 6, 3, 128, True, "float32")]
        + [c for c in FLASH_BF16_CASES if c not in FLASH_BWD_CASES] + FLASH_WIDE_CASES,
    )
    def test_flash_bwd(self, cuda, b, s, h, kv, d, causal, dtype):
        shapes = [(b, s, h, d), (b, s, kv, d), (b, s, kv, d), (b, s, h, d)]
        q, k, v, do = (torch.from_numpy(_normal(i, shp)).to(cuda, TORCH_DT[dtype])
                       for i, shp in enumerate(shapes))
        out, lse = flash_ops.flash_attention_fwd(q, k, v, causal=causal, with_lse=True)
        want_out, want_lse = attention_ref(q.movedim(1, 2), k.movedim(1, 2), v.movedim(1, 2),
                                           causal=causal, return_lse=True)
        torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)
        launches = flash_ops.launches_bwd
        grads = flash_ops.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
        torch.cuda.synchronize()
        assert flash_ops.launches_bwd == launches + 1
        want = attention_bwd_ref(q.movedim(1, 2), k.movedim(1, 2), v.movedim(1, 2),
                                 out.movedim(1, 2), lse, do.movedim(1, 2), causal=causal)
        tol = BWD_TOL[dtype]
        for got, w in zip(grads, want):
            torch.testing.assert_close(got.float(), w.movedim(1, 2).float(), atol=tol, rtol=tol)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("n", [1, 7, 4096, 1000003])
    def test_quorum_compare(self, cuda, n, dtype):
        a = torch.from_numpy(_normal(1, (n,))).to(cuda, TORCH_DT[dtype])
        b = a.clone()
        b[: n // 3] += 0.5
        b[n // 2:] *= 1.00001
        launches = quorum_ops.launches
        nb, sq = quorum_ops.quorum_compare(a, b, rtol=1e-4, atol=1e-6)
        torch.cuda.synchronize()
        assert quorum_ops.launches == launches + 1
        want_nb, want_sq = quorum_compare_ref(a, b, 1e-4, 1e-6)
        assert int(nb) == int(want_nb)
        torch.testing.assert_close(sq, want_sq, atol=1e-6, rtol=1e-5)
        # a misaligned view takes the scalar loop
        nb1, _ = quorum_ops.quorum_compare(a[1:], b[1:], rtol=1e-4, atol=1e-6)
        assert int(nb1) == int(quorum_compare_ref(a[1:], b[1:], 1e-4, 1e-6)[0])

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("n,d,lo,hi,offset", [
        (2, 4096, 0, 2, 0), (300, 4096, 0, 300, 0), (300, 4096, 130, 300, 0),
        (70, 4097, 0, 70, 0), (70, 4096, 0, 70, 1), (66, 100, 1, 66, 0), (5, 1, 0, 5, 0),
        (3, 0, 0, 3, 0), (1, 8, 0, 1, 0)])
    def test_quorum_pair_counts(self, cuda, n, d, lo, hi, offset, dtype):
        # rows in groups, some agreeing near the tolerance, NaN and inf
        # among them; offset starts the matrix one element into its buffer
        rows = _normal(1, (n, d)).astype(np.float32)
        rows[1::3] = rows[0::3][: len(rows[1::3])] * np.float32(1.00001)
        rows[2::5] += np.float32(1e-7)
        rows.reshape(-1)[::997] = np.nan
        rows.reshape(-1)[5::1009] = np.inf
        buf = torch.zeros(n * d + 1)
        buf[offset:offset + n * d] = torch.from_numpy(rows.reshape(-1))
        t = buf.to(cuda, TORCH_DT[dtype])[offset:offset + n * d].view(n, d)
        launches, pairs = quorum_ops.launches, quorum_ops.launches_pairs
        got = quorum_ops.quorum_pair_counts(t, lo, hi, rtol=1e-4, atol=1e-6)
        torch.cuda.synchronize()
        assert quorum_ops.launches == launches
        assert quorum_ops.launches_pairs == pairs + (1 if hi >= 2 else 0)
        want = quorum_pair_counts_ref(t, lo, hi, 1e-4, 1e-6)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        for i, r in ((hi - 1, 0), (hi - 1, hi - 2), ((lo + hi) // 2, lo // 2)):
            if 0 <= r < i and d:
                nb, _ = quorum_ops.quorum_compare(t[i], t[r], rtol=1e-4, atol=1e-6)
                assert int(got[i - lo, r]) == int(nb)

    @pytest.mark.parametrize("b,s,h,p,g,n,with_init,dtype", SSD_CASES)
    def test_ssd_scan(self, cuda, b, s, h, p, g, n, with_init, dtype):
        x = torch.from_numpy(_normal(1, (b, s, h, p))).to(cuda, TORCH_DT[dtype])
        dt = torch.nn.functional.softplus(torch.from_numpy(_normal(2, (b, s, h)))).to(cuda) * 0.05 + 0.001
        A = -torch.exp(torch.from_numpy(_normal(3, (h,))).to(cuda) * 0.3)
        bm, cm = (torch.from_numpy(_normal(i, (b, s, g, n)) * 0.3).to(cuda, TORCH_DT[dtype]) for i in (4, 5))
        init = torch.from_numpy(_normal(6, (b, h, p, n)) * 0.5).to(cuda) if with_init else None
        launches = ssd_ops.launches
        y, state = ssd_ops.ssd_scan(x, dt, A, bm, cm, initial_state=init)
        torch.cuda.synchronize()
        assert ssd_ops.launches == launches + 1
        assert y.dtype == x.dtype and state.dtype == torch.float32
        want_y, want_state = ssd_scan_ref(x, dt, A, bm, cm, block_q=256, initial_state=init)
        tol = 1e-4 if dtype == "float32" else 2e-2
        torch.testing.assert_close(y.float(), want_y.float(), atol=tol, rtol=tol)
        torch.testing.assert_close(state, want_state, atol=1e-4, rtol=1e-4)

    def test_ssd_scan_against_the_sequential_oracle(self, cuda):
        # the reference test's tolerance (tests/test_kernels.py): 3e-4 in f32
        b, s, h, p, g, n = 1, 200, 8, 32, 2, 32
        x = torch.from_numpy(_normal(1, (b, s, h, p))).to(cuda)
        dt = torch.nn.functional.softplus(torch.from_numpy(_normal(2, (b, s, h)))).to(cuda) * 0.05 + 0.001
        A = -torch.exp(torch.from_numpy(_normal(3, (h,))).to(cuda) * 0.3)
        bm, cm = (torch.from_numpy(_normal(i, (b, s, g, n)) * 0.3).to(cuda) for i in (4, 5))
        y, state = ssd_ops.ssd_scan(x, dt, A, bm, cm)
        want_y, want_state = ssd_ref(x, dt, A, bm, cm)
        torch.testing.assert_close(y, want_y, atol=3e-4, rtol=3e-4)
        torch.testing.assert_close(state, want_state, atol=3e-4, rtol=3e-4)

    def test_ssd_scan_reads_strided_inputs_and_differentiates(self, cuda):
        # x, B and C as slices of one (B, S, d_xbc) activation, as the model has them
        b, s, h, p, g, n = 1, 90, 4, 16, 1, 32
        xbc = torch.from_numpy(_normal(7, (b, s, h * p + 2 * g * n))).to(cuda)
        x = xbc[..., :h * p].view(b, s, h, p)
        bm = xbc[..., h * p:h * p + g * n].view(b, s, g, n)
        cm = xbc[..., h * p + g * n:].view(b, s, g, n)
        dt = torch.full((b, s, h), 0.02, device=cuda)
        A = -torch.ones(h, device=cuda)
        y, state = ssd_ops.ssd_scan(x, dt, A, bm, cm)
        y2, state2 = ssd_ops.ssd_scan(x.contiguous(), dt, A, bm.contiguous(), cm.contiguous())
        assert torch.equal(y, y2) and torch.equal(state, state2)
        # the gradient reaches the fused activation through the backward kernels
        dy = torch.from_numpy(_normal(8, (b, s, h, p))).to(cuda)
        leaf, dt_l, A_l = (t.detach().clone().requires_grad_() for t in (xbc, dt, A))
        launches = ssd_ops.launches_bwd
        yl, _ = ssd_ops.ssd_scan(leaf[..., :h * p].view(b, s, h, p), dt_l, A_l,
                                 leaf[..., h * p:h * p + g * n].view(b, s, g, n),
                                 leaf[..., h * p + g * n:].view(b, s, g, n))
        dxbc, ddt, dA = torch.autograd.grad(yl, (leaf, dt_l, A_l), dy)
        torch.cuda.synchronize()
        assert ssd_ops.launches_bwd == launches + 1
        want = ssd_scan_bwd_ref(x, dt, A, bm, cm, dy, block_q=256)
        want_xbc = torch.cat([want[0].reshape(b, s, h * p), want[3].reshape(b, s, -1),
                              want[4].reshape(b, s, -1)], dim=-1)
        torch.testing.assert_close(dxbc, want_xbc, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(ddt, want[1], atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(dA, want[2], atol=1e-3, rtol=1e-4)
        # strided and contiguous inputs give the same bits
        got = ssd_ops.ssd_scan_bwd(x, dt, A, bm, cm, dy)
        got2 = ssd_ops.ssd_scan_bwd(x.contiguous(), dt, A, bm.contiguous(), cm.contiguous(), dy)
        assert all(torch.equal(u, v) for u, v in zip(got, got2))

    @pytest.mark.parametrize("b,s,h,p,g,n,with_init,dtype", SSD_BWD_CASES)
    def test_ssd_scan_bwd(self, cuda, b, s, h, p, g, n, with_init, dtype):
        # every gradient against the plain backward, each to tol times its
        # leaf's largest entry (dx, dB and dC rounded once to x's dtype), and
        # the same bits from a second call
        x = torch.from_numpy(_normal(1, (b, s, h, p))).to(cuda, TORCH_DT[dtype])
        dt = torch.nn.functional.softplus(torch.from_numpy(_normal(2, (b, s, h)))).to(cuda) * 0.05 + 0.001
        A = -torch.exp(torch.from_numpy(_normal(3, (h,))).to(cuda) * 0.3)
        bm, cm = (torch.from_numpy(_normal(i, (b, s, g, n)) * 0.3).to(cuda, TORCH_DT[dtype]) for i in (4, 5))
        init = torch.from_numpy(_normal(6, (b, h, p, n)) * 0.5).to(cuda) if with_init else None
        dy = torch.from_numpy(_normal(9, (b, s, h, p))).to(cuda, TORCH_DT[dtype])
        dstate = torch.from_numpy(_normal(10, (b, h, p, n))).to(cuda) if with_init else None
        launches = ssd_ops.launches_bwd
        got = ssd_ops.ssd_scan_bwd(x, dt, A, bm, cm, dy, dstate, init)
        torch.cuda.synchronize()
        assert ssd_ops.launches_bwd == launches + 1
        want = ssd_scan_bwd_ref(x, dt, A, bm, cm, dy, dstate, init, block_q=256)
        tol = 1e-4 if dtype == "float32" else 2e-2
        for name, gt, w in zip(("dx", "ddt", "dA", "dB", "dC", "dinit"), got, want):
            assert gt.shape == w.shape and gt.dtype == (
                x.dtype if name in ("dx", "dB", "dC") else torch.float32), name
            scale = w.abs().max().item()
            torch.testing.assert_close(gt.float(), w, atol=tol * scale, rtol=tol, msg=name)
        again = ssd_ops.ssd_scan_bwd(x, dt, A, bm, cm, dy, dstate, init)
        assert all(torch.equal(u, v) for u, v in zip(got, again))

    @pytest.mark.parametrize("b,s,h,p,g,n,with_init,dtype", SSD_BWD_CASES)
    def test_ssd_scan_bwd_main_path_is_the_standalone_route(self, cuda, b, s, h, p, g, n, with_init,
                                                            dtype):
        # the backward given the forward's states (the main path) gives the
        # bits of the standalone route, which recomputes them, and so does
        # autograd through ssd_scan; neither allocates per-head (B, S, H, N)
        # shares, and the main path no recompute workspace
        x = torch.from_numpy(_normal(1, (b, s, h, p))).to(cuda, TORCH_DT[dtype])
        dt = torch.nn.functional.softplus(torch.from_numpy(_normal(2, (b, s, h)))).to(cuda) * 0.05 + 0.001
        A = -torch.exp(torch.from_numpy(_normal(3, (h,))).to(cuda) * 0.3)
        bm, cm = (torch.from_numpy(_normal(i, (b, s, g, n)) * 0.3).to(cuda, TORCH_DT[dtype]) for i in (4, 5))
        init = torch.from_numpy(_normal(6, (b, h, p, n)) * 0.5).to(cuda) if with_init else None
        dy = torch.from_numpy(_normal(9, (b, s, h, p))).to(cuda, TORCH_DT[dtype])
        dstate = torch.from_numpy(_normal(10, (b, h, p, n))).to(cuda) if with_init else None
        y, fs, states = ssd_ops.ssd_scan_with_states(x, dt, A, bm, cm, initial_state=init)
        want_y, want_fs = ssd_ops.ssd_scan(x, dt, A, bm, cm, initial_state=init)
        assert torch.equal(y, want_y) and torch.equal(fs, want_fs)
        main = ssd_ops.ssd_scan_bwd(x, dt, A, bm, cm, dy, dstate, init, states=states)
        torch.cuda.synchronize()
        scratch = ssd_ops.last_bwd_scratch
        assert "ws" not in scratch and all(shape != (b, s, h, n) for shape, _ in scratch.values())
        alone = ssd_ops.ssd_scan_bwd(x, dt, A, bm, cm, dy, dstate, init)
        assert "ws" in ssd_ops.last_bwd_scratch
        assert all(torch.equal(u, v) for u, v in zip(main, alone))
        leaves = [t.detach().clone().requires_grad_() for t in (x, dt, A, bm, cm)]
        yl, fl = ssd_ops.ssd_scan(*leaves, initial_state=init)
        outs, cots = ([yl, fl], [dy, dstate]) if with_init else ([yl], [dy])
        auto = torch.autograd.grad(outs, leaves, cots)
        assert all(torch.equal(u, v) for u, v in zip(auto, alone[:5]))

    def test_ssd_remat_gives_the_same_gradients(self, cuda):
        # a bf16 grad step of mamba2-smoke with remat on (the forward runs
        # again and the backward takes the rerun's states) and off (the first
        # forward's): the same bits in every gradient
        from repro_torch.configs import get_smoke_config
        from repro_torch.data import DataConfig, make_batch
        from repro_torch.models import init_params, model_spec
        from repro_torch.models.layers import tree_leaves
        from repro_torch.runtime import make_grad_step

        cfg = get_smoke_config("mamba2-130m").scaled(dtype=torch.bfloat16)
        params = init_params(torch.Generator(device=cuda).manual_seed(0), model_spec(cfg), device=cuda)
        data = DataConfig(vocab=cfg.vocab, seq_len=256, batch_size=2, n_shards=1, seed=0)
        batch = {k: torch.from_numpy(v.astype(np.int64)).to(cuda)
                 for k, v in make_batch(data, 0, 0).items()}
        launches = ssd_ops.launches_bwd
        (g_on, m_on), (g_off, m_off) = (make_grad_step(cfg.scaled(remat=r))(params, batch)
                                        for r in (True, False))
        torch.cuda.synchronize()
        assert ssd_ops.launches_bwd == launches + 2 * cfg.n_layers
        assert torch.equal(m_on["loss"], m_off["loss"])
        for a, b in zip(tree_leaves(g_on), tree_leaves(g_off)):
            assert torch.equal(a, b)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_ssd_scan_reads_strided_inputs_at_width(self, cuda, dtype):
        # x, B and C sliced from one activation at P = 128, N = 256, 8 groups
        # over 2048 positions: the 16-byte loads read them in place, and the
        # result equals that of contiguous copies bit for bit and the plain
        # version's within the dtype's tolerance
        b, s, h, p, g, n = 1, 2048, 16, 128, 8, 256
        xbc = torch.from_numpy(_normal(8, (b, s, h * p + 2 * g * n)) * 0.3).to(cuda, TORCH_DT[dtype])
        x = xbc[..., :h * p].view(b, s, h, p)
        bm = xbc[..., h * p:h * p + g * n].view(b, s, g, n)
        cm = xbc[..., h * p + g * n:].view(b, s, g, n)
        dt = torch.nn.functional.softplus(torch.from_numpy(_normal(2, (b, s, h)))).to(cuda) * 0.05 + 0.001
        A = -torch.exp(torch.from_numpy(_normal(3, (h,))).to(cuda) * 0.3)
        y, state = ssd_ops.ssd_scan(x, dt, A, bm, cm)
        y2, state2 = ssd_ops.ssd_scan(x.contiguous(), dt, A, bm.contiguous(), cm.contiguous())
        assert torch.equal(y, y2) and torch.equal(state, state2)
        want_y, want_state = ssd_scan_ref(x, dt, A, bm, cm, block_q=256)
        tol = 1e-4 if dtype == "float32" else 2e-2
        torch.testing.assert_close(y.float(), want_y.float(), atol=tol, rtol=tol)
        torch.testing.assert_close(state, want_state, atol=1e-4 if dtype == "float32" else tol,
                                   rtol=1e-4 if dtype == "float32" else tol)


# ---------------------------------------------------------------------------
# MoE and MLA grad steps and the remat policies on the card
# ---------------------------------------------------------------------------


def _smoke_grad_step(cuda, arch, seq=256, **overrides):
    """A bf16 grad step of ``arch``'s smoke config on the card: its step,
    parameters and batch."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.models import init_params, model_spec
    from repro_torch.runtime import make_grad_step

    cfg = get_smoke_config(arch).scaled(dtype=torch.bfloat16, **overrides)
    params = init_params(torch.Generator(device=cuda).manual_seed(0), model_spec(cfg), device=cuda)
    data = DataConfig(vocab=cfg.vocab, seq_len=seq, batch_size=2, n_shards=1, seed=0)
    batch = {k: torch.from_numpy(v.astype(np.int64)).to(cuda) for k, v in make_batch(data, 0, 0).items()}
    return make_grad_step(cfg), params, batch


@pytest.mark.gpu
class TestModelsOnCard:
    @pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "llama4-scout-17b-a16e", "minicpm3-4b"])
    def test_moe_and_mla_grad_steps_repeat_bit_for_bit(self, cuda, arch):
        # the gradient quorum compares replicas: the MoE dispatch (a stable
        # sort, one write a slot, an ordered combine) and MLA's padded flash
        # must give the same bits on the same inputs
        from repro_torch.models.layers import tree_leaves

        step, params, batch = _smoke_grad_step(cuda, arch)
        before = swiglu_ops.launches_bwd, flash_ops.launches_bwd
        g1, m1 = step(params, batch)
        g2, m2 = step(params, batch)
        torch.cuda.synchronize()
        assert swiglu_ops.launches_bwd > before[0] and flash_ops.launches_bwd > before[1]
        assert torch.isfinite(m1["loss"]) and all(torch.equal(m1[k], m2[k]) for k in m1)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g1), tree_leaves(g2)))

    @pytest.mark.parametrize("arch", ["hubert-xlarge", "pixtral-12b"])
    def test_frontend_logits_on_the_card_match_the_cpu(self, cuda, arch):
        # f32 smoke logits from frame (hubert: the encoder, non-causal over
        # 150 frames) or patch embeddings (pixtral: a prefill), through the
        # kernels on the card and the plain versions on the CPU
        from repro_torch.configs import get_smoke_config
        from repro_torch.models import frontends, init_cache, init_params, model_spec
        from repro_torch.models.layers import tree_map
        from repro_torch.runtime import make_encoder_step, make_prefill_step

        cfg = get_smoke_config(arch).scaled(dtype=torch.float32)
        params = init_params(torch.Generator(device=cuda).manual_seed(0), model_spec(cfg), device=cuda)
        stub = frontends.frame_embeddings if arch == "hubert-xlarge" else frontends.patch_embeddings
        x = stub(torch.Generator(device=cuda).manual_seed(1), 2, 150, cfg.d_model, torch.float32, cuda)
        before = flash_ops.launches
        if cfg.has_decode:
            step = make_prefill_step(cfg)
            card, _ = step(params, {"embeds": x}, init_cache(cfg, 2, 150, cuda))
            cpu, _ = step(tree_map(lambda t: t.cpu(), params), {"embeds": x.cpu()},
                          init_cache(cfg, 2, 150, "cpu"))
        else:
            step = make_encoder_step(cfg)
            card, cpu = step(params, {"embeds": x}), step(tree_map(lambda t: t.cpu(), params),
                                                           {"embeds": x.cpu()})
        torch.cuda.synchronize()
        assert flash_ops.launches == before + cfg.n_layers
        torch.testing.assert_close(card.cpu(), cpu, rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen3-moe-235b-a22b"])
    def test_remat_policies_give_the_same_bits(self, cuda, arch):
        from repro_torch.models.layers import tree_leaves

        runs = []
        for policy in ("nothing", "dots_nb", "dots"):
            step, params, batch = _smoke_grad_step(cuda, arch, remat=True, remat_policy=policy)
            runs.append(step(params, batch))
        torch.cuda.synchronize()
        for grads, m in runs[1:]:
            assert torch.equal(m["loss"], runs[0][1]["loss"])
            assert all(torch.equal(a, b) for a, b in zip(tree_leaves(grads), tree_leaves(runs[0][0])))
