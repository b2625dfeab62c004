"""The port's cost counter (``repro_torch.distributed.hlo_costs``) against
known ground truth, the kernel table's bounds, itself across devices, and
the reference's HLO analyzer.

Twins of ``tests/test_hlo_costs.py``: the port runs eagerly, so a loop is
counted once per trip without any trip parser. Each kernel wrapper reports
its formula (``kernels/_costs.py``); at every shape of the kernel table in
``PERF.md`` the reported bytes and operations, over the H100's constants,
give that row's bound within 2%. A step counts the same on the meta device
as on the CPU, where the kernels' plain versions run. Against the
reference's ``analyze_module`` over its own compiled step (a 1x1 mesh), the
terms each package counts by design differently are taken out, each from
its own package's code:

* attention: the port counts its flash kernel by formula (4 B H S^2 D at
  the true D, halved under the causal mask; the backward 2.5 times that),
  the reference the dots of its chunked jnp attention (the full square up
  to its query chunks), measured here by its analyzer on that function,
  three times over for a forward and its backward;
* the loss chunk's recompute: the port's ``torch.utils.checkpoint`` runs
  the unembedding of each CE chunk again for the backward, where XLA
  merges the reference's recompute with the forward (one unembedding
  ``dot``), so the port's train step holds one more unembedding, counted
  here by the port's counter over ``unembed_logits`` alone.
"""
import contextlib

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as ref_smoke_config  # noqa: E402
from repro.distributed.hlo_analysis import memory_analysis_dict as ref_memory  # noqa: E402
from repro.distributed.hlo_costs import analyze_module  # noqa: E402
from repro.launch.mesh import single_device_mesh as ref_single_device_mesh  # noqa: E402
from repro.models.attention import _chunked_attention  # noqa: E402
from repro.models.config import ShapeConfig as RefShapeConfig  # noqa: E402
from repro.runtime.step_builder import build_step as ref_build_step  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.distributed.hlo_analysis import (  # noqa: E402
    cost_analysis_bytes,
    cost_analysis_flops,
    memory_analysis_dict,
    op_census,
)
from repro_torch.distributed.hlo_costs import count_costs  # noqa: E402
from repro_torch.distributed.roofline import kernel_bound_s  # noqa: E402
from repro_torch.kernels import _costs  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.int8_quant import ops as int8_ops  # noqa: E402
from repro_torch.kernels.quorum_compare import ops as quorum_ops  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rms_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.swiglu import ops as swiglu_ops  # noqa: E402
from repro_torch.launch.dryrun import DRYRUN_MESH  # noqa: E402
from repro_torch.launch.mesh import single_device_mesh  # noqa: E402
from repro_torch.models import init_cache, init_params, model_spec  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402
from repro_torch.models.layers import unembed_logits  # noqa: E402
from repro_torch.optim.adamw import init_state  # noqa: E402
from repro_torch.runtime.step_builder import build_step  # noqa: E402

META = "meta"


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


# ---------------------------------------------------------------------------
# Twins of tests/test_hlo_costs.py
# ---------------------------------------------------------------------------


def test_plain_matmul_flops_exact():
    m, k, n = 256, 512, 128
    costs = count_costs(lambda a, b: a @ b, meta(m, k), meta(k, n))
    assert costs.flops == 2 * m * k * n


@pytest.mark.parametrize("trips", [3, 9])
def test_loop_multiplies_flops(trips):
    m = 128

    def run(x, w):
        for _ in range(trips):
            x = torch.tanh(x @ w)
        return x

    costs = count_costs(run, meta(m, m), meta(m, m))
    assert costs.flops == trips * 2 * m**3  # eager loops run unrolled: every trip counted


def test_nested_loop_multipliers():
    m = 32

    def run(x, w):
        for _ in range(3):
            for _ in range(4):
                x = x @ w
        return x

    assert count_costs(run, meta(m, m), meta(m, m)).flops == 12 * 2 * m**3


def test_collectives_counted_empty_on_single_device():
    # a train step on one device runs aten ops and kernels only: no collective
    # (c10d) op, so nothing for collective bytes to count
    lowered = build_step(get_smoke_config("qwen3-0.6b"), ShapeConfig("cell", 64, 2, "train"),
                         DRYRUN_MESH).lower()
    names = op_census(lowered)
    assert "aten.mm" in names and all(name.startswith("aten.") for name in names), sorted(names)


def test_bytes_of_an_add_a_view_and_an_empty():
    a, b = meta(8, 4), meta(8, 4)
    assert count_costs(lambda x, y: x + y, a, b).bytes == 3 * 8 * 4 * 4
    assert count_costs(lambda x: x.view(4, 8).t(), a).bytes == 0
    costs = count_costs(lambda: torch.empty(1024, 1024, device=META))
    assert costs.bytes == 0 and costs.peak_bytes == 4 * 1024 * 1024
    assert op_census(costs) == {"aten.empty": 1}


def test_counters_do_not_nest():
    with pytest.raises(RuntimeError, match="already running"):
        count_costs(lambda: count_costs(lambda: None))
    assert _costs.ACTIVE is None


# ---------------------------------------------------------------------------
# Each kernel's reported cost against the kernel table's bounds (PERF.md)
# ---------------------------------------------------------------------------

BF, F32 = torch.bfloat16, torch.float32


def _flash(b, s, h, kv, d, dtype, causal=True):
    return lambda: flash_ops.flash_attention_fwd(meta(b, s, h, d, dtype=dtype), meta(b, s, kv, d, dtype=dtype),
                                                 meta(b, s, kv, d, dtype=dtype), causal=causal)


def _flash_bwd(b, s, h, kv, d, dtype, causal=True):
    def call():
        q, o, do = (meta(b, s, h, d, dtype=dtype) for _ in range(3))
        k, v = meta(b, s, kv, d, dtype=dtype), meta(b, s, kv, d, dtype=dtype)
        return flash_ops.flash_attention_bwd(q, k, v, o, meta(b, h, s), do, causal=causal)
    return call


def _ssd(b, s, h, p, n, dtype, g=1):
    return lambda: ssd_ops.ssd_scan(meta(b, s, h, p, dtype=dtype), meta(b, s, h), meta(h),
                                    meta(b, s, g, n, dtype=dtype), meta(b, s, g, n, dtype=dtype))


def _ssd_bwd(b, s, h, p, n, dtype, g=1):
    return lambda: ssd_ops.ssd_scan_bwd(meta(b, s, h, p, dtype=dtype), meta(b, s, h), meta(h),
                                        meta(b, s, g, n, dtype=dtype), meta(b, s, g, n, dtype=dtype),
                                        meta(b, s, h, p, dtype=dtype))


def _int8(rows, dequant=False):
    if dequant:
        return lambda: int8_ops.dequantize_rows(meta(rows, 256, dtype=torch.int8),
                                                meta(rows // 256, 1), 256)
    return lambda: int8_ops.quantize_rows(meta(rows, 256), 256)


# (row, the kernel entry it reports, the call, the row's bound in ms)
KERNEL_ROWS = [
    ("1", "rmsnorm_fwd", lambda: rms_ops.rmsnorm_fwd(meta(4096, 1024, dtype=BF), meta(1024)), 0.0050),
    ("1h", "rmsnorm_fwd", lambda: rms_ops.rmsnorm_fwd(meta(6000, 1280, dtype=BF), meta(1280)), 0.0092),
    ("1p", "rmsnorm_fwd", lambda: rms_ops.rmsnorm_fwd(meta(700, 5120, dtype=BF), meta(5120)), 0.0043),
    ("1b", "rmsnorm_bwd", lambda: rms_ops.rmsnorm_bwd(meta(4096, 1024, dtype=BF), meta(1024),
                                                      meta(4096, 1024, dtype=BF)), 0.0075),
    ("1hb", "rmsnorm_bwd", lambda: rms_ops.rmsnorm_bwd(meta(6000, 1280, dtype=BF), meta(1280),
                                                       meta(6000, 1280, dtype=BF)), 0.0138),
    ("2", "swiglu_fwd", lambda: swiglu_ops.swiglu_fwd(meta(4096, 3072, dtype=BF), meta(4096, 3072, dtype=BF)),
     0.0225),
    ("2m", "swiglu_fwd", lambda: swiglu_ops.swiglu_fwd(meta(128, 128, 1536, dtype=BF),
                                                       meta(128, 128, 1536, dtype=BF)), 0.0451),
    ("2h", "swiglu_fwd", lambda: swiglu_ops.swiglu_fwd(meta(6000, 5120, dtype=BF), meta(6000, 5120, dtype=BF)),
     0.0550),
    ("2p", "swiglu_fwd", lambda: swiglu_ops.swiglu_fwd(meta(700, 14336, dtype=BF), meta(700, 14336, dtype=BF)),
     0.0180),
    ("2b", "swiglu_bwd", lambda: swiglu_ops.swiglu_bwd(*(meta(4096, 3072, dtype=BF) for _ in range(3))), 0.0376),
    ("2hb", "swiglu_bwd", lambda: swiglu_ops.swiglu_bwd(*(meta(6000, 5120, dtype=BF) for _ in range(3))), 0.0917),
    ("3", "flash_attention_fwd", _flash(2, 2048, 16, 8, 128, BF), 0.0348),
    ("3m", "flash_attention_fwd", _flash(1, 700, 40, 40, 96, BF), 0.0064),
    ("3h", "flash_attention_fwd", _flash(4, 1500, 16, 16, 80, BF, causal=False), 0.0466),
    ("3hb", "flash_attention_bwd", _flash_bwd(4, 1500, 16, 16, 80, BF, causal=False), 0.1165),
    ("3p", "flash_attention_fwd", _flash(1, 700, 32, 8, 128, BF), 0.0043),
    ("3b", "flash_attention_bwd", _flash_bwd(2, 2048, 16, 8, 128, BF), 0.0869),
    ("3w", "flash_attention_fwd", _flash(1, 2048, 8, 4, 256, BF), 0.0174),
    ("3wb", "flash_attention_bwd", _flash_bwd(1, 2048, 8, 4, 256, BF), 0.0434),
    ("3x bf16", "flash_attention_fwd", _flash(1, 2048, 8, 4, 512, BF), 0.0348),
    ("3x f32", "flash_attention_fwd", _flash(1, 2048, 8, 4, 512, F32), 0.5131),
    ("3xb bf16", "flash_attention_bwd", _flash_bwd(1, 2048, 8, 4, 512, BF), 0.0869),
    ("3xb f32", "flash_attention_bwd", _flash_bwd(1, 2048, 8, 4, 512, F32), 1.2827),
    ("3f", "flash_attention_fwd", _flash(2, 2048, 16, 8, 128, F32), 0.5131),
    ("3bf", "flash_attention_bwd", _flash_bwd(2, 2048, 16, 8, 128, F32), 1.2827),
    ("4", "quorum_compare", lambda: quorum_ops.quorum_compare(meta(152064, 1024), meta(152064, 1024)), 0.3719),
    ("4v", "quorum_compare", lambda: quorum_ops.quorum_compare(meta(4096), meta(4096)), 0.0000098),
    ("4p", "quorum_pair_counts", lambda: quorum_ops.quorum_pair_counts(meta(150, 4096), 0, 150), 0.0034),
    ("5", "int8_quantize", _int8(608256), 0.2324),
    ("6", "int8_dequantize", _int8(608256, dequant=True), 0.2324),
    ("7", "ssd_scan_fwd", _ssd(1, 700, 24, 64, 128, BF), 0.00165),
    ("7z", "ssd_scan_fwd", _ssd(1, 700, 64, 64, 64, BF), 0.00384),
    ("7f mamba2", "ssd_scan_fwd", _ssd(1, 700, 24, 64, 128, F32), 0.0082),
    ("7f zamba2", "ssd_scan_fwd", _ssd(1, 700, 64, 64, 64, F32), 0.0110),
    ("7b", "ssd_scan_bwd", _ssd_bwd(2, 2048, 24, 64, 128, BF), 0.0128),
    ("7bz", "ssd_scan_bwd", _ssd_bwd(2, 2048, 64, 64, 64, BF), 0.0313),
    ("7bf mamba2", "ssd_scan_bwd", _ssd_bwd(2, 2048, 24, 64, 128, F32), 0.0962),
    ("7bf zamba2", "ssd_scan_bwd", _ssd_bwd(2, 2048, 64, 64, 64, F32), 0.1282),
]


class _Recorder:
    """Stands in for the counter: keeps what each wrapper reports."""

    def __init__(self):
        self.reports = []

    @contextlib.contextmanager
    def kernel(self, name, cost):
        self.reports.append((name, cost))
        yield


@pytest.mark.parametrize("row,entry,call,bound_ms", KERNEL_ROWS, ids=[r[0] for r in KERNEL_ROWS])
def test_kernel_cost_gives_the_tables_bound(monkeypatch, row, entry, call, bound_ms):
    rec = _Recorder()
    monkeypatch.setattr(_costs, "ACTIVE", rec)
    call()
    assert [name for name, _ in rec.reports] == [entry]  # one report, however the call is routed
    cost = rec.reports[0][1]
    got_ms = kernel_bound_s(cost) * 1e3
    assert got_ms == pytest.approx(bound_ms, rel=0.02), (row, cost)


def _empty(dev):
    def make(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)
    return make


# calls the kernels refuse: each raises on the meta device (the dry run) as on
# the card, before any output is made
REFUSED = [
    ("ssd N past MAX_N", lambda t: ssd_ops.ssd_scan(t(1, 8, 2, 4), t(1, 8, 2), t(2), t(1, 8, 1, 300),
                                                    t(1, 8, 1, 300)), ValueError, "0 < N <= 256"),
    ("ssd B not x's dtype", lambda t: ssd_ops.ssd_scan(t(1, 8, 2, 4), t(1, 8, 2), t(2),
                                                       t(1, 8, 1, 4, dtype=BF), t(1, 8, 1, 4, dtype=BF)),
     TypeError, "x, B and C"),
    ("ssd heads not a multiple of groups", lambda t: ssd_ops.ssd_scan(t(1, 8, 3, 4), t(1, 8, 3), t(3),
                                                                      t(1, 8, 2, 4), t(1, 8, 2, 4)),
     ValueError, "ssd_scan shapes"),
    ("ssd bwd dy not x's shape", lambda t: ssd_ops.ssd_scan_bwd(t(1, 8, 2, 4), t(1, 8, 2), t(2), t(1, 8, 1, 4),
                                                                t(1, 8, 1, 4), t(1, 8, 2, 3)),
     ValueError, "dy"),
    ("flash f16", lambda t: flash_ops.flash_attention(*(t(1, 8, 2, 8, dtype=torch.float16) for _ in range(3))),
     TypeError, "float32 or bfloat16"),
    ("flash heads not a multiple of kv", lambda t: flash_ops.flash_attention(t(1, 8, 3, 8), t(1, 8, 2, 8),
                                                                             t(1, 8, 2, 8)),
     ValueError, "flash_attention shapes"),
    ("flash bwd lse shape", lambda t: flash_ops.flash_attention_bwd(t(1, 8, 2, 8), t(1, 8, 2, 8), t(1, 8, 2, 8),
                                                                    t(1, 8, 2, 8), t(1, 8, 2), t(1, 8, 2, 8)),
     ValueError, "lse must be"),
    ("flash bwd dout dtype", lambda t: flash_ops.flash_attention_bwd(
        t(1, 8, 2, 8), t(1, 8, 2, 8), t(1, 8, 2, 8), t(1, 8, 2, 8), t(1, 2, 8), t(1, 8, 2, 8, dtype=BF)),
     ValueError, "out and dout"),
    ("rmsnorm scale shape", lambda t: rms_ops.rmsnorm(t(4, 8), t(4)), ValueError, "scale of shape"),
    ("rmsnorm f16", lambda t: rms_ops.rmsnorm(t(4, 8, dtype=torch.float16), t(8)), TypeError,
     "float32 or bfloat16"),
    ("swiglu shapes differ", lambda t: swiglu_ops.swiglu(t(4, 8), t(4, 6)), ValueError, "shapes differ"),
    ("swiglu bwd dtypes differ", lambda t: swiglu_ops.swiglu_bwd(t(4, 8), t(4, 8), t(4, 8, dtype=BF)),
     TypeError, "float32 or bfloat16"),
    ("int8 rows not whole tiles", lambda t: int8_ops.quantize_rows(t(6, 256), 4), ValueError, "whole tiles"),
    ("int8 scales count", lambda t: int8_ops.dequantize_rows(t(8, 256, dtype=torch.int8), t(3, 1), 4),
     ValueError, "one scale each"),
    ("quorum f16", lambda t: quorum_ops.quorum_compare(t(16, dtype=torch.float16), t(16, dtype=torch.float16)),
     TypeError, "float32 or bfloat16"),
    ("quorum pairs int", lambda t: quorum_ops.quorum_pair_counts(t(4, 16, dtype=torch.int32), 0, 4), TypeError,
     "float32 or bfloat16"),
]


@pytest.mark.parametrize("device", [META, pytest.param("cuda", marks=pytest.mark.gpu)])
@pytest.mark.parametrize("call,exc,match", [r[1:] for r in REFUSED], ids=[r[0] for r in REFUSED])
def test_meta_refuses_what_the_card_refuses(monkeypatch, device, call, exc, match):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels' own checks run only on the card")

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version or a kernel ran")

    monkeypatch.setattr(ssd_ops._build, "entry", refuse)
    with pytest.raises(exc, match=match):
        call(_empty(device))


def test_meta_branches_give_the_kernels_shapes():
    out, lse = flash_ops.flash_attention_fwd(meta(2, 16, 4, 8, dtype=BF), meta(2, 16, 2, 8, dtype=BF),
                                             meta(2, 16, 2, 8, dtype=BF), with_lse=True)
    assert (out.shape, out.dtype, lse.shape, lse.dtype) == ((2, 16, 4, 8), BF, (2, 4, 16), F32)
    y, state, (s_in, total) = ssd_ops.ssd_scan_with_states(
        meta(2, 130, 4, 8, dtype=BF), meta(2, 130, 4), meta(4), meta(2, 130, 1, 16, dtype=BF),
        meta(2, 130, 1, 16, dtype=BF))
    assert (y.shape, state.shape, state.dtype) == ((2, 130, 4, 8), (2, 4, 8, 16), F32)
    assert (s_in.shape, s_in.dtype, total.shape) == ((2, 3, 4, 8, 16), BF, (2, 4, 3))
    q, sc = int8_ops.quantize_rows(meta(512, 256), 256)
    assert (q.dtype, sc.shape) == (torch.int8, (2, 1))
    assert quorum_ops.quorum_pair_counts(meta(5, 7), 1, 4).shape == (3, 4)


# ---------------------------------------------------------------------------
# A step counts the same on the meta device and on the CPU
# ---------------------------------------------------------------------------


def _cpu_args(bundle, cfg, shape):
    gen = torch.Generator().manual_seed(0)
    params = init_params(gen, model_spec(cfg), dtype=cfg.param_dtype, device="cpu")

    def batch_of(specs):
        return {k: (torch.randint(0, cfg.vocab, tuple(t.shape), generator=gen, dtype=t.dtype)
                    if not t.dtype.is_floating_point else torch.randn(tuple(t.shape), generator=gen).to(t.dtype))
                for k, t in specs.items()}

    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return params, init_state(params), batch_of(bundle.in_specs[2])
    if shape.kind == "prefill":
        batch = batch_of(bundle.in_specs[1])
        return (params, batch) if len(bundle.in_specs) == 2 else (params, batch, init_cache(cfg, b, s, "cpu"))
    tokens = torch.randint(0, cfg.vocab, (b, 1), generator=gen, dtype=torch.int32)
    return params, tokens, init_cache(cfg, b, s, "cpu"), s - 1


STEP_CELLS = [
    ("qwen3-0.6b", "train", True), ("qwen3-0.6b", "decode", False), ("hubert-xlarge", "prefill", False),
    ("mamba2-130m", "train", True), ("zamba2-1.2b", "prefill", False), ("qwen3-moe-235b-a22b", "train", True),
    ("minicpm3-4b", "train", False),
]


@pytest.mark.parametrize("arch,kind,remat", STEP_CELLS)
def test_meta_counts_equal_the_cpu_step(arch, kind, remat):
    cfg = get_smoke_config(arch).scaled(remat=remat)
    shape = ShapeConfig("cell", 64, 2, kind)
    bundle = build_step(cfg, shape, single_device_mesh("cpu"))
    lowered = bundle.lower()
    real = count_costs(bundle, *_cpu_args(bundle, cfg, shape))
    assert real.flops == lowered.costs.flops and real.bytes == lowered.costs.bytes
    assert op_census(real) == op_census(lowered)
    assert {k: v.calls for k, v in real.kernels.items()} == {k: v.calls for k, v in lowered.costs.kernels.items()}
    assert cost_analysis_flops(lowered) == lowered.costs.flops
    assert cost_analysis_bytes(lowered) == lowered.costs.bytes
    mem = memory_analysis_dict(lowered)
    assert mem["temp_size_in_bytes"] == lowered.costs.peak_bytes > 0
    if kind == "train":  # params and both moments are updated in place
        assert mem["alias_size_in_bytes"] >= mem["argument_size_in_bytes"] - 4 * 64 * 2 * 2


# ---------------------------------------------------------------------------
# Parity with the reference's analyzer over its compiled step (1x1 mesh)
# ---------------------------------------------------------------------------

SEQ, BATCH = 64, 2


def _ref_costs(cfg, kind):
    bundle = ref_build_step(cfg, RefShapeConfig("cell", SEQ, BATCH, kind), ref_single_device_mesh())
    compiled = bundle.lower().compile()
    return analyze_module(compiled.as_text()), ref_memory(compiled)


def _ref_attention_flops(cfg, backward):
    """The dots of the reference's attention at the cell's shapes, over all
    layers: its forward, as its analyzer counts the chunked attention alone,
    and with ``backward`` three times that (autodiff's dP, dV, dQ and dK are
    each the size of one of the forward's two products)."""
    h, kv, d = cfg.n_heads, cfg.n_kv_heads or cfg.n_heads, cfg.resolved_head_dim
    q = jax.ShapeDtypeStruct((BATCH, SEQ, h, d), cfg.dtype)
    k = jax.ShapeDtypeStruct((BATCH, SEQ, kv, d), cfg.dtype)
    fn = jax.jit(lambda q_, k_, v_: _chunked_attention(q_, k_, v_, cfg.causal, cfg.attn_chunk))
    fwd = analyze_module(fn.lower(q, k, k).compile().as_text()).flops
    return fwd * (3 if backward else 1) * cfg.n_layers


def _port_costs(cfg, kind):
    return build_step(cfg, ShapeConfig("cell", SEQ, BATCH, kind), DRYRUN_MESH).lower()


def _port_attention_flops(costs):
    return sum(v.flops for k, v in costs.kernels.items() if k.startswith("flash_attention"))


def test_hubert_encoder_flops_match_the_reference():
    # no causal mask: the reference's chunks compute the full square, as the
    # kernel's formula counts it, so even the attention terms agree
    ref, _ = _ref_costs(ref_smoke_config("hubert-xlarge"), "prefill")
    port = _port_costs(get_smoke_config("hubert-xlarge"), "prefill").costs
    assert _port_attention_flops(port) == _ref_attention_flops(ref_smoke_config("hubert-xlarge"), False)
    assert port.flops == pytest.approx(ref.flops, rel=0.01)


def test_qwen3_train_flops_match_the_reference_past_the_design_terms():
    rcfg, pcfg = ref_smoke_config("qwen3-0.6b"), get_smoke_config("qwen3-0.6b")
    ref, _ = _ref_costs(rcfg, "train")
    port = _port_costs(pcfg, "train").costs
    ref_attn = _ref_attention_flops(rcfg, True)
    port_attn = _port_attention_flops(port)
    # the port's CE-chunk recompute: one more unembedding of every position
    embed = {"embedding": torch.empty(pcfg.padded_vocab, pcfg.d_model, device=META)}
    recompute = count_costs(unembed_logits, embed,
                            torch.empty(BATCH, SEQ, pcfg.d_model, dtype=pcfg.dtype, device=META)).flops
    assert recompute == 2 * BATCH * SEQ * pcfg.d_model * pcfg.padded_vocab
    assert port.flops - port_attn - recompute == pytest.approx(ref.flops - ref_attn, rel=0.01)


@pytest.mark.parametrize("package", ["port", "reference"])
def test_remat_nothing_counts_more_flops_and_less_temp_than_dots(package):
    flops, temp = {}, {}
    for policy in ("nothing", "dots"):
        if package == "port":
            cfg = get_smoke_config("qwen3-0.6b").scaled(remat=True, remat_policy=policy)
            lowered = _port_costs(cfg, "train")
            flops[policy] = lowered.costs.flops
            temp[policy] = memory_analysis_dict(lowered)["temp_size_in_bytes"]
        else:
            cfg = ref_smoke_config("qwen3-0.6b").scaled(remat=True, remat_policy=policy,
                                                        dtype=jnp.float32)
            costs, mem = _ref_costs(cfg, "train")
            flops[policy], temp[policy] = costs.flops, mem["temp_size_in_bytes"]
    assert flops["nothing"] > flops["dots"]
    assert temp["nothing"] < temp["dots"]
