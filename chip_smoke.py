#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA Hopper card, end to end.

    python3 chip_smoke.py

Phases, in order; the first failure ends the run with a non-zero exit:

1. Card and build: print the card's name and power limit, turn TF32 off,
   build the four kernel libraries from ``src/repro_torch/csrc`` (one nvcc
   per source, all at once) into ``build/kernels/``.
2. Each kernel, forward and backward, against its plain PyTorch version on
   the card, at the serving and training paths' shapes in bf16 and f32, with
   the tolerance stated; per kernel its device time (torch.profiler; a
   session that records no kernel is run again, and after three such
   sessions CUDA events around launches queued behind a sleep kernel take
   its place, which the log says), the
   plain version's, one PyTorch library call's (a yardstick the port never
   calls; for a backward kernel, the device time of autograd's backward of
   the library call), its wall time per call between CUDA events (host
   launch cost included), and the least time the card could take (bytes at
   3.35 TB/s or operations at the peak rate of their type). quorum_compare
   also runs through the grid trainer's comparator on NaN and inf leaves.
3. Serve qwen3-0.6b at full width (28 layers, random weights from a seeded
   generator, bf16 compute) through ``BatchServer``: 8 ragged requests of
   64-700 prompt tokens, 32 new tokens each, EDF deadlines. Every kernel
   counter is zeroed just before and read just after; each must show at
   least the launches the path implies. Then one prefill and one decode step
   under ``torch.profiler`` for the device-time breakdown.
4. The card's f32 prefill logits (kernels) against the port's CPU forward
   (plain versions) from the same parameters, for one 64-token prompt.
5. Train qwen3-0.6b at full width through the volunteer grid
   (``GridTrainer``): 3 optimizer steps of 2 shards x 2 x 2048 tokens on 8
   simulated hosts with 5% erroneous and 15% malicious hosts. Every counter
   is zeroed just before and read just after; each of the seven (three
   forward, three backward, quorum_compare) must be non-zero. Then one grad
   job under ``torch.profiler`` for the device-time breakdown.
6. The card's f32 loss and gradients of one grad step (kernels) against the
   CPU's (plain versions): qwen3 widths at 2 layers, 1 x 256 tokens, the
   same parameters.

The line before the last is one JSON object ``{"kernels": [...]}`` with the
numbers of this run (``launches``: the training run's counts, and for the
forward kernels ``launches_serve``, the serving run's); the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA card, or without the repository's ``src/`` beside it, the
script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
# peak operation rates: bf16 on the tensor cores; f32 outside them (the
# elementwise kernels compute in f32 whatever their storage type)
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
SEED = 0
N_REQUESTS = 8
MAX_NEW = 32
SLOTS = 4
MAX_SEQ = 1024
# the grid-training phase: one microbatch (one grad job) is 2 x 2048 tokens
TRAIN_STEPS = 3
TRAIN_SEQ = 2048
TRAIN_BATCH = 2
TRAIN_SHARDS = 2


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Wall time per call between CUDA events: host launch cost included."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


PROFILER_ATTEMPTS = 3


def queued_event_ms(fn, iters: int = 20) -> float:
    """Device time per call between CUDA events, with the launches queued
    behind a sleep kernel so the card runs them back to back and host launch
    gaps are hidden (as far as the host keeps ahead of the card)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # ~50 ms of clock cycles: time to queue the launches
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profiled(fn, iters: int = 1):
    """Run ``fn`` ``iters`` times under torch.profiler; return the device
    microseconds per kernel name (device-side events only: a CPU op's device
    time repeats its kernels') and the wall milliseconds. A session in which
    CUPTI delivered no kernel record is run again, up to PROFILER_ATTEMPTS
    times; after that the dict is empty."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, PROFILER_ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        dev_us = {e.key: e.self_device_time_total for e in prof.key_averages()
                  if e.device_type.name == "CUDA" and e.self_device_time_total > 0}
        if dev_us:
            return dev_us, wall_ms
        log(f"torch.profiler recorded no device time (attempt {attempt} of {PROFILER_ATTEMPTS})")
    return {}, wall_ms


def device_ms(fn, iters: int = 20) -> float:
    """Device time per call: the kernels' own durations from torch.profiler
    (CUPTI), summed, so host launch cost between kernels is left out. Where
    the profiler records nothing, CUDA events around queued launches."""
    import torch

    fn()
    torch.cuda.synchronize()
    dev_us, _ = profiled(fn, iters)
    if not dev_us:
        ms = queued_event_ms(fn, iters)
        log(f"device time from CUDA events around queued launches instead: {ms:.4f} ms")
        return ms
    return sum(dev_us.values()) / iters / 1e3


def profile_breakdown(fn, label: str, top: int = 10):
    """Run ``fn`` once under torch.profiler; print wall, device-busy and idle
    share and the ``top`` kernels by device time; return the per-kernel
    device microseconds (empty where the profiler recorded none) and the
    wall milliseconds."""
    dev_us, wall_ms = profiled(fn)
    if not dev_us:
        log(f"profile {label}: wall_ms {wall_ms:.3f}; device busy and idle share not measured")
        return dev_us, wall_ms
    busy_ms = sum(dev_us.values()) / 1e3
    log(f"profile {label}: wall_ms {wall_ms:.3f} device_busy_ms {busy_ms:.3f} "
        f"idle_share {max(0.0, 1 - busy_ms / wall_ms):.3f}")
    for key, us in sorted(dev_us.items(), key=lambda kv: -kv[1])[:top]:
        log(f"    {us / 1e3:9.3f} ms  {key[:100]}")
    return dev_us, wall_ms


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.core import reset_ids
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_ref
    from repro_torch.kernels.quorum_compare import ops as quorum_ops
    from repro_torch.kernels.quorum_compare.ref import quorum_compare_ref
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref, rmsnorm_ref
    from repro_torch.kernels.swiglu import ops as swiglu_ops
    from repro_torch.kernels.swiglu.ref import swiglu_bwd_ref, swiglu_ref
    from repro_torch.models import init_cache, init_params, model_spec
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import (BatchServer, GridTrainer, Request, ServeMetrics,
                                     grad_comparator, make_decode_step, make_grad_step,
                                     make_prefill_step)

    dev = torch.device("cuda")
    ops = {"rmsnorm": rms_ops, "swiglu": swiglu_ops, "flash_attention": flash_ops}
    bwd_ops = {"rmsnorm_bwd": rms_ops, "swiglu_bwd": swiglu_ops, "flash_attention_bwd": flash_ops}

    def counts():
        """Every launch counter: forward, backward, quorum_compare."""
        out = {name: mod.launches for name, mod in ops.items()}
        out.update({name: mod.launches_bwd for name, mod in bwd_ops.items()})
        out["quorum_compare"] = quorum_ops.launches
        return out

    def zero_counts():
        for mod in (rms_ops, swiglu_ops, flash_ops):
            mod.launches = mod.launches_bwd = 0
        quorum_ops.launches = 0

    # ---- 1. card and build -------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"capability {torch.cuda.get_device_capability(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    nvcc_s = _build.build()
    if len(nvcc_s) != 4:
        raise AssertionError(f"built {sorted(nvcc_s)}, expected four libraries")
    log(f"[1] built {', '.join(nvcc_s)} in {time.perf_counter() - t0:.2f} s wall "
        f"(nvcc s: {json.dumps({k: round(v, 2) for k, v in nvcc_s.items()})})")

    # ---- 2. kernels against their plain versions --------------------------
    cfg = get_config("qwen3-0.6b")
    d, hd, ff = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
    H, KV, L = cfg.n_heads, cfg.n_kv_heads, cfg.n_layers
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def esize(dtype):
        return torch.empty((), dtype=dtype).element_size()

    results = {}

    def check(name, shape_desc, dtype, kernel, plain, library, args, tol, nbytes, nops, peak):
        """Hold ``kernel(*args)`` against ``plain(*args)`` (a tensor or a
        tuple of tensors) to atol=rtol=tol and time kernel, plain version and
        ``library`` (a callable of ``args``, or of nothing for a backward)."""
        out, want = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        outs = out if isinstance(out, tuple) else (out,)
        wants = want if isinstance(want, tuple) else (want,)
        err = 0.0
        for i, (o, w) in enumerate(zip(outs, wants)):
            diff = (o.float() - w.float()).abs()
            err = max(err, diff.max().item())
            bad = (diff > tol + tol * w.float().abs()).sum().item()
            if bad or not torch.isfinite(o).all():
                raise AssertionError(f"{name} {shape_desc} {dtype} output {i}: {bad} elements outside "
                                     f"atol=rtol={tol} (max abs err {diff.max().item()})")
        lib = None
        if library is not None:
            lib = library if library.__code__.co_argcount == 0 else (lambda: library(*args))
        rec = {
            "ms": device_ms(lambda: kernel(*args)),
            "plain_ms": device_ms(lambda: plain(*args)),
            "library_ms": device_ms(lib) if lib else None,
            "call_ms": time_ms(lambda: kernel(*args)),
            "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "ops_ms": nops / peak * 1e3,
        }
        rec["bound_ms"] = max(rec["bytes_ms"], rec["ops_ms"])
        rec["bound_by"] = "bytes" if rec["bytes_ms"] >= rec["ops_ms"] else "operations"
        rec.update(max_abs_err=err, tol=tol, shape=shape_desc, dtype=str(dtype).replace("torch.", ""))
        log(f"[2] {name:20s} {shape_desc:28s} {rec['dtype']:9s} max_abs_err {err:.3e} (tol {tol}) "
            f"kernel_ms {rec['ms']:.4f} (call {rec['call_ms']:.4f}) plain_ms {rec['plain_ms']:.4f} "
            f"library_ms {rec['library_ms'] if rec['library_ms'] is None else round(rec['library_ms'], 4)} "
            f"bound_ms {rec['bound_ms']:.4f} ({rec['bound_by']})")
        return rec

    def check_rms(rows, width, dtype, tol):
        x, sc = randn(rows, width, dtype=dtype), randn(width, dtype=torch.float32)
        sc_lib = sc.to(dtype)
        es = esize(dtype)
        return check("rmsnorm", f"({rows}, {width})", dtype,
                     lambda x, s: rms_ops.rmsnorm(x, s, eps=cfg.norm_eps),
                     lambda x, s: rmsnorm_ref(x, s, cfg.norm_eps),
                     lambda x, s: F.rms_norm(x, (width,), sc_lib, cfg.norm_eps),
                     (x, sc), tol, 2 * rows * width * es + 4 * width, 4 * rows * width,
                     PEAK_OPS["float32"])

    def check_swiglu(rows, width, dtype, tol):
        g, u = randn(rows, width, dtype=dtype), randn(rows, width, dtype=dtype)
        n = rows * width
        return check("swiglu", f"({rows}, {width})", dtype, swiglu_ops.swiglu, swiglu_ref,
                     lambda g, u: F.silu(g) * u, (g, u), tol, 3 * n * esize(dtype), 6 * n,
                     PEAK_OPS["float32"])

    def check_flash(s, heads, kv, dim, dtype, tol, b=1, with_lse=False):
        q = randn(b, s, heads, dim, dtype=dtype)
        k, v = randn(b, s, kv, dim, dtype=dtype), randn(b, s, kv, dim, dtype=dtype)
        pairs = b * s * (s + 1) // 2
        return check("flash_attention", f"({b}, {s}, {heads}/{kv}, {dim}) causal", dtype,
                     lambda q, k, v: flash_ops.flash_attention_fwd(q, k, v, causal=True,
                                                                   with_lse=with_lse)[0],
                     lambda q, k, v: attention_ref(q.movedim(1, 2), k.movedim(1, 2),
                                                   v.movedim(1, 2), causal=True).movedim(1, 2),
                     lambda q, k, v: F.scaled_dot_product_attention(
                         q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                         is_causal=True, enable_gqa=True),
                     (q, k, v), tol, 2 * b * s * (heads + kv) * dim * esize(dtype) + 4 * b * heads * s * with_lse,
                     4 * heads * dim * pairs,
                     PEAK_OPS[str(dtype).replace("torch.", "")])

    bf, f32 = torch.bfloat16, torch.float32
    s_max = 700  # the longest prompt of phase 3
    n_tok = TRAIN_BATCH * TRAIN_SEQ  # one grad job's tokens (phase 5)
    # the result rows hold the training path's shapes; the serving shapes follow
    results["rmsnorm"] = check_rms(n_tok, d, bf, 2e-2)
    check_rms(n_tok * H, hd, bf, 2e-2)  # qk-norm rows
    check_rms(s_max, d, bf, 2e-2)
    check_rms(s_max * H, hd, bf, 2e-2)
    check_rms(SLOTS, d, bf, 2e-2)  # decode
    check_rms(64, d, f32, 1e-5)
    check_rms(64 * H, hd, f32, 1e-5)
    results["swiglu"] = check_swiglu(n_tok, ff, bf, 2e-2)
    check_swiglu(s_max, ff, bf, 2e-2)
    check_swiglu(SLOTS, ff, bf, 2e-2)  # decode
    check_swiglu(64, ff, f32, 1e-6)
    results["flash_attention"] = check_flash(TRAIN_SEQ, H, KV, hd, bf, 2e-2, b=TRAIN_BATCH,
                                             with_lse=True)
    check_flash(300, H, KV, hd, bf, 2e-2)
    check_flash(s_max, H, KV, hd, bf, 2e-2)
    check_flash(130, H, KV, hd, f32, 2e-5)
    check_flash(130, 4, 2, 48, f32, 2e-5)

    # backward kernels at the training path's shapes (2 x 2048 tokens)
    def autograd_bwd(fn, inputs, dy):
        """The library yardstick for a backward: autograd's backward of
        ``fn`` (one forward here, the backward timed alone)."""
        leaves = [t.detach().clone().requires_grad_() for t in inputs]
        y = fn(*leaves)
        return lambda: torch.autograd.grad(y, leaves, dy, retain_graph=True)

    def check_rms_bwd(rows, width, dtype, tol):
        x, dy = randn(rows, width, dtype=dtype), randn(rows, width, dtype=dtype)
        sc = randn(width, dtype=torch.float32)
        es = esize(dtype)
        lib = autograd_bwd(lambda x, w: F.rms_norm(x, (width,), w, cfg.norm_eps),
                           (x, sc.to(dtype)), dy)
        return check("rmsnorm_bwd", f"({rows}, {width})", dtype,
                     lambda x, s, g: rms_ops.rmsnorm_bwd(x, s, g, cfg.norm_eps),
                     lambda x, s, g: rmsnorm_bwd_ref(x, s, g, cfg.norm_eps), lib,
                     (x, sc, dy), tol, 3 * rows * width * es + 8 * width, 10 * rows * width,
                     PEAK_OPS["float32"])

    def check_swiglu_bwd(rows, width, dtype, tol):
        g, u, dh = (randn(rows, width, dtype=dtype) for _ in range(3))
        n = rows * width
        lib = autograd_bwd(lambda g, u: F.silu(g) * u, (g, u), dh)
        return check("swiglu_bwd", f"({rows}, {width})", dtype, swiglu_ops.swiglu_bwd,
                     swiglu_bwd_ref, lib, (g, u, dh), tol, 5 * n * esize(dtype), 14 * n,
                     PEAK_OPS["float32"])

    def check_flash_bwd(b, s, heads, kv, dim, dtype, tol):
        q, do = randn(b, s, heads, dim, dtype=dtype), randn(b, s, heads, dim, dtype=dtype)
        k, v = randn(b, s, kv, dim, dtype=dtype), randn(b, s, kv, dim, dtype=dtype)
        out, lse = flash_ops.flash_attention_fwd(q, k, v, causal=True, with_lse=True)
        want_out, want_lse = attention_ref(q.movedim(1, 2), k.movedim(1, 2), v.movedim(1, 2),
                                           causal=True, return_lse=True)
        lse_err = (lse - want_lse).abs().max().item()
        out_err = (out.float() - want_out.movedim(1, 2).float()).abs().max().item()
        if lse_err > 1e-3 or out_err > tol:
            raise AssertionError(f"flash forward with lse: lse err {lse_err}, out err {out_err}")
        log(f"[2] flash forward with lse ({b}, {s}, {heads}/{kv}, {dim}) {dtype}: "
            f"lse max abs err {lse_err:.3e} (tol 1e-3), out max abs err {out_err:.3e}")
        pairs = s * (s + 1) // 2
        lib = autograd_bwd(lambda q, k, v: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
            enable_gqa=True).transpose(1, 2), (q, k, v), do)
        es = esize(dtype)
        nbytes = b * s * (4 * heads + 4 * kv) * dim * es + b * heads * s * 4  # + lse
        return check("flash_attention_bwd", f"({b}, {s}, {heads}/{kv}, {dim}) causal", dtype,
                     lambda q, k, v, o, l, g: flash_ops.flash_attention_bwd(q, k, v, o, l, g),
                     lambda q, k, v, o, l, g: tuple(t.movedim(1, 2) for t in attention_bwd_ref(
                         q.movedim(1, 2), k.movedim(1, 2), v.movedim(1, 2), o.movedim(1, 2), l,
                         g.movedim(1, 2), causal=True)),
                     lib, (q, k, v, out, lse, do), tol, nbytes,
                     2.5 * 4 * b * heads * dim * pairs, PEAK_OPS[str(dtype).replace("torch.", "")])

    results["rmsnorm_bwd"] = check_rms_bwd(n_tok, d, bf, 2e-2)
    check_rms_bwd(n_tok * H, hd, bf, 2e-2)  # qk-norm rows
    # f32 at 1e-4: dscale sums 4096 or 65536 rows in another order than torch
    check_rms_bwd(n_tok, d, f32, 1e-4)
    check_rms_bwd(n_tok * H, hd, f32, 1e-4)
    results["swiglu_bwd"] = check_swiglu_bwd(n_tok, ff, bf, 2e-2)
    check_swiglu_bwd(n_tok, ff, f32, 1e-5)
    results["flash_attention_bwd"] = check_flash_bwd(TRAIN_BATCH, TRAIN_SEQ, H, KV, hd, bf, 2e-2)
    # f32 at 1e-4: dQ, dK and dV sum up to 2048 keys or queries per element
    check_flash_bwd(TRAIN_BATCH, TRAIN_SEQ, H, KV, hd, f32, 1e-4)
    check_flash_bwd(1, 130, 4, 2, 48, f32, 2e-5)

    # quorum_compare on a pair of embedding-gradient-sized leaves
    rows_e = cfg.padded_vocab
    qa = randn(rows_e, d, dtype=f32)
    qb = qa.clone()
    planted = torch.randperm(qa.numel(), generator=gen, device=dev)[:37]
    qb.view(-1)[planted] += 1.0
    qb.view(-1)[planted[:5]] = qa.view(-1)[planted[:5]] * (1 + 1e-6)  # within rtol 1e-4: good
    rtol_q, atol_q = 1e-4, 1e-6
    n_q = qa.numel()
    rec = check("quorum_compare", f"({rows_e}, {d}) x2", f32,
                lambda a, b: quorum_ops.quorum_compare(a, b, rtol=rtol_q, atol=atol_q),
                lambda a, b: quorum_compare_ref(a, b, rtol_q, atol_q),
                lambda a, b: torch.isclose(a, b, rtol=rtol_q, atol=atol_q).logical_not().sum(),
                (qa, qb), 1e-5, 2 * n_q * 4, 6 * n_q, PEAK_OPS["float32"])
    n_bad = int(quorum_ops.quorum_compare(qa, qb, rtol=rtol_q, atol=atol_q)[0])
    n_lib = int(torch.isclose(qa, qb, rtol=rtol_q, atol=atol_q).logical_not().sum())
    if n_bad != 32 or n_lib != 32:
        raise AssertionError(f"quorum_compare counted {n_bad} (isclose {n_lib}), planted 32")
    results["quorum_compare"] = rec
    # the grid trainer's comparator on non-finite leaves: card verdicts == CPU verdicts
    small = randn(1000, dtype=f32)
    cases = {"nan": float("nan"), "inf": float("inf")}
    for label, val in cases.items():
        bad_leaf = small.clone()
        bad_leaf[:3] = val
        for ta, tb in (({"e": qa, "x": bad_leaf}, {"e": qa, "x": small}),
                       ({"e": qa, "x": bad_leaf}, {"e": qa, "x": bad_leaf.clone()})):
            for frac in (0.0, 1e-9, 1e-8, 1e-6):
                cmp = grad_comparator(max_bad_fraction=frac)
                got = cmp({"grads": ta}, {"grads": tb})
                want = cmp({"grads": tree_map(lambda t: t.cpu(), ta)},
                           {"grads": tree_map(lambda t: t.cpu(), tb)})
                if got != want:
                    raise AssertionError(f"grad_comparator on a {label} leaf: card {got}, cpu {want}")
    log(f"[2] quorum_compare: {n_bad} bad of {n_q} (32 planted); grad_comparator verdicts on "
        f"NaN and inf leaves equal the CPU's")
    del qa, qb

    # ---- 3. serve at full width -------------------------------------------
    log(f"[3] {cfg.name}: {L} layers, d={d}, {H} heads / {KV} kv heads, head_dim {hd}, "
        f"d_ff {ff}, vocab {cfg.vocab} (padded {cfg.padded_vocab}), compute {cfg.dtype}")
    t = time.perf_counter()
    params = init_params(gen, model_spec(cfg), device=dev)  # f32
    server = BatchServer(cfg, params, batch_slots=SLOTS, max_seq=MAX_SEQ)
    torch.cuda.synchronize()
    log(f"[3] params {cfg.param_count()} ({time.perf_counter() - t:.2f} s to init and cast); "
        f"memory allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    rng = np.random.default_rng(SEED)
    # warm-up (cuBLAS handles, allocator): one short request, not counted
    server.submit(Request(id=-1, prompt=rng.integers(0, cfg.vocab, size=16).astype(np.int32),
                          max_new_tokens=2))
    server.run()
    server.metrics = ServeMetrics()
    prompt_lens = [int(n) for n in rng.integers(64, 701, size=N_REQUESTS)]
    prompt_lens[0] = s_max
    reqs = [Request(id=i, prompt=rng.integers(0, cfg.vocab, size=n).astype(np.int32),
                    max_new_tokens=MAX_NEW, deadline=float(rng.integers(1, 100)))
            for i, n in enumerate(prompt_lens)]
    for r in reqs:
        server.submit(r)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    m = server.run()
    torch.cuda.synchronize()
    launches = {name: mod.launches for name, mod in ops.items()}
    if any(v for k, v in counts().items() if k not in ops):
        raise AssertionError(f"serving launched a backward or quorum kernel: {counts()}")
    log(f"[3] prompt lengths {prompt_lens}; launches {json.dumps(launches)}")
    assert m.requests_done == N_REQUESTS, m
    assert m.tokens_generated == N_REQUESTS * (MAX_NEW - 1), m
    for r in reqs:
        assert len(r.tokens_out) == MAX_NEW and all(0 <= t < cfg.vocab for t in r.tokens_out), r.id
    forwards = N_REQUESTS + m.decode_steps
    implied = {"rmsnorm": (4 * L + 1) * forwards, "swiglu": L * forwards,
               "flash_attention": L * N_REQUESTS}
    for name, want in implied.items():
        if launches[name] < want:
            raise AssertionError(f"{name}: {launches[name]} launches on the serving path, "
                                 f"the path implies at least {want}")
    log(f"[3] requests_done {m.requests_done} tokens_generated {m.tokens_generated} "
        f"decode_steps {m.decode_steps} wall_s {m.wall_time:.3f}")
    log(f"[3] prefill_ms_per_request {m.prefill_time / N_REQUESTS * 1e3:.3f} "
        f"decode_ms_per_step {m.decode_time / m.decode_steps * 1e3:.3f} "
        f"tokens_per_s {m.tokens_per_s:.2f} "
        f"mean_prompt {sum(prompt_lens) / N_REQUESTS:.1f} "
        f"peak_mem_gib {torch.cuda.max_memory_allocated() / 2**30:.2f}")

    # where the device time goes: one 700-token prefill and one decode step
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    one = init_cache(cfg, 1, MAX_SEQ)
    toks = torch.as_tensor(reqs[0].prompt, dtype=torch.long, device=dev)[None, :]
    batch_cache = init_cache(cfg, SLOTS, MAX_SEQ)
    dec_toks = torch.zeros((SLOTS, 1), dtype=torch.long, device=dev)
    for label, step in (("prefill 700", lambda: prefill(server.params, {"tokens": toks}, one)),
                        ("decode x4", lambda: decode(server.params, dec_toks, batch_cache, s_max))):
        step()
        torch.cuda.synchronize()
        profile_breakdown(step, f"[3] {label}", top=8)

    # ---- 4. card (kernels) against CPU (plain versions), f32 ---------------
    cfg32 = cfg.scaled(dtype=torch.float32)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, size=64), dtype=torch.long)
    step32 = make_prefill_step(cfg32)
    before = {name: mod.launches for name, mod in ops.items()}
    gpu_logits, _ = step32(params, {"tokens": prompt[None].to(dev)}, init_cache(cfg32, 1, 64))
    torch.cuda.synchronize()
    assert all(ops[n].launches > before[n] for n in ops), "f32 prefill skipped a kernel"
    cpu_params = tree_map(lambda t: t.cpu(), params)
    cpu_logits, _ = step32(cpu_params, {"tokens": prompt[None]}, init_cache(cfg32, 1, 64, "cpu"))
    g, c = gpu_logits[0, -1, : cfg.vocab].cpu(), cpu_logits[0, -1, : cfg.vocab]
    assert torch.isfinite(g).all() and g.shape == (cfg.vocab,)
    err4 = (g - c).abs().max().item()
    tol4 = 1e-3  # 28 f32 layers, summed in other orders on the card and the CPU
    log(f"[4] f32 prefill logits, card vs CPU: max abs err {err4:.3e} (tol {tol4}, |logit| max "
        f"{c.abs().max().item():.3f}); argmax card {int(g.argmax())} cpu {int(c.argmax())}")
    assert err4 <= tol4 and int(g.argmax()) == int(c.argmax())
    del server, params, cpu_params, one, batch_cache
    torch.cuda.empty_cache()

    # ---- 5. train through the volunteer grid at full width -----------------
    reset_ids()
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ, batch_size=TRAIN_BATCH,
                          n_shards=TRAIN_SHARDS, seed=SEED)
    t = time.perf_counter()
    trainer = GridTrainer(cfg, data_cfg, AdamWConfig(lr=1e-4, warmup_steps=1, total_steps=TRAIN_STEPS),
                          n_steps=TRAIN_STEPS, n_hosts=8, seed=SEED, error_prob=0.05,
                          malicious_fraction=0.15, availability=0.9)
    torch.cuda.synchronize()
    log(f"[5] GridTrainer {cfg.name} (remat={cfg.remat}, compute {cfg.dtype}), {TRAIN_STEPS} steps x "
        f"{TRAIN_SHARDS} shards x ({TRAIN_BATCH} x {TRAIN_SEQ}) tokens, 8 hosts; set up in "
        f"{time.perf_counter() - t:.2f} s, memory allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t = time.perf_counter()
    r = trainer.run()
    torch.cuda.synchronize()
    train_wall = time.perf_counter() - t
    train_launches = counts()
    sm = r.metrics
    credit = sum(v for k, v in r.credit_total.items() if k.startswith("host:"))
    log(f"[5] losses {r.losses} steps_completed {r.steps_completed} jobs_retried {r.jobs_retried} "
        f"virtual_time {r.virtual_time}")
    log(f"[5] SimMetrics wrong_accepted {sm.wrong_accepted} replication_overhead "
        f"{sm.replication_overhead:.3f} instances_executed {sm.instances_executed}; "
        f"host credit {credit:.4e} cobblestones")
    log(f"[5] grad jobs computed {len(trainer.job_seconds)}, wall s each "
        f"{[round(x, 3) for x in trainer.job_seconds]}; run wall {train_wall:.2f} s; "
        f"peak_mem_gib {torch.cuda.max_memory_allocated() / 2**30:.2f}")
    log(f"[5] launches {json.dumps(train_launches)}")
    if r.steps_completed < TRAIN_STEPS:
        raise AssertionError(f"grid trainer completed {r.steps_completed} of {TRAIN_STEPS} steps")
    if not all(math.isfinite(x) for x in r.losses):
        raise AssertionError(f"non-finite loss: {r.losses}")
    idle = [k for k, v in train_launches.items() if v == 0]
    if idle:
        raise AssertionError(f"kernels never launched on the training path: {idle}")

    # where the device time of one grad job goes
    batch_np = make_batch(data_cfg, 0, 0)
    batch = {k: torch.from_numpy(v.astype(np.int64)).to(dev) for k, v in batch_np.items()}
    grad_step = make_grad_step(cfg)
    dev_us, job_wall = profile_breakdown(lambda: grad_step(trainer.params, batch), "[5] grad job",
                                         top=14)
    busy = sum(dev_us.values())
    groups = {
        "flash_bwd": lambda k: "flash_bwd" in k,
        "flash_fwd": lambda k: "flash_fwd" in k,
        "cuBLAS": lambda k: any(s in k.lower() for s in ("gemm", "nvjet", "cutlass", "xmma", "sm90_")),
        "rmsnorm": lambda k: "rmsnorm" in k,
        "swiglu": lambda k: "swiglu" in k,
    }
    if busy:
        shares = {g: sum(us for k, us in dev_us.items() if f(k)) / busy for g, f in groups.items()}
        shares["other"] = 1.0 - sum(shares.values())
        log(f"[5] grad job device shares {json.dumps({k: round(v, 4) for k, v in shares.items()})} "
            f"(busy {busy / 1e3:.2f} ms of {job_wall:.2f} ms wall)")
    del trainer, grad_step, batch
    torch.cuda.empty_cache()

    # ---- 6. card (kernels) against CPU (plain versions): one f32 grad step --
    cfg6 = cfg.scaled(n_layers=2, dtype=torch.float32)
    p6 = init_params(torch.Generator(device=dev).manual_seed(SEED + 6), model_spec(cfg6), device=dev)
    toks = rng.integers(0, cfg.vocab, size=(1, 257))
    b6 = {"tokens": torch.as_tensor(toks[:, :-1]), "labels": torch.as_tensor(toks[:, 1:])}
    step6 = make_grad_step(cfg6)
    before = counts()
    g_card, m_card = step6(p6, {k: v.to(dev) for k, v in b6.items()})
    torch.cuda.synchronize()
    after = counts()
    if any(after[k] <= before[k] for k in ("rmsnorm_bwd", "swiglu_bwd", "flash_attention_bwd")):
        raise AssertionError("the f32 grad step skipped a backward kernel")
    g_cpu, m_cpu = step6(tree_map(lambda x: x.cpu(), p6), b6)
    loss_err = abs(float(m_card["loss"]) - float(m_cpu["loss"]))
    # per leaf: |card - cpu| <= 1e-3 |cpu| + 1e-4 max|cpu| (f32 sums over 256
    # tokens and up to 152064 vocabulary rows, in other orders on the two)
    worst = 0.0
    for path_leaf, (gc, gp) in enumerate(zip(tree_leaves(g_card), tree_leaves(g_cpu))):
        gc = gc.cpu()
        err = (gc - gp).abs()
        lim = 1e-3 * gp.abs() + 1e-4 * gp.abs().max()
        if not torch.isfinite(gc).all() or (err > lim).any():
            raise AssertionError(f"grad leaf {path_leaf} {tuple(gp.shape)}: max abs err "
                                 f"{err.max().item():.3e} past 1e-3|x| + 1e-4 max|x|")
        worst = max(worst, (err.max() / gp.abs().max().clamp(min=1e-30)).item())
        log(f"[6] grad leaf {path_leaf} {str(tuple(gp.shape)):24s} max abs err {err.max().item():.3e} "
            f"(max |g| {gp.abs().max().item():.3e})")
    log(f"[6] f32 loss card {float(m_card['loss']):.6f} cpu {float(m_cpu['loss']):.6f} abs err "
        f"{loss_err:.3e} (tol 1e-4); worst leaf err / max|g| {worst:.3e}")
    if loss_err > 1e-4:
        raise AssertionError(f"f32 loss card vs cpu: {loss_err}")

    # ---- 7. result lines ---------------------------------------------------
    replaces = {
        "rmsnorm": "src/repro/kernels/rmsnorm/kernel.py:17",
        "swiglu": "src/repro/kernels/swiglu/kernel.py:12",
        "flash_attention": "src/repro/kernels/flash_attention/kernel.py:30",
        "quorum_compare": "src/repro/kernels/quorum_compare/kernel.py:21",
        # no TPU backward kernels: the reference differentiates its jnp
        # functions with XLA; each row names the forward TPU kernel
        "rmsnorm_bwd": "src/repro/kernels/rmsnorm/kernel.py:17",
        "swiglu_bwd": "src/repro/kernels/swiglu/kernel.py:12",
        "flash_attention_bwd": "src/repro/kernels/flash_attention/kernel.py:30",
    }
    kernels = []
    for name, rec in results.items():
        row = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name.replace('_bwd', '')}.cu",
            "replaces": replaces[name], "launches": train_launches[name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"], "call_ms": rec["call_ms"], "shape": rec["shape"],
            "dtype": rec["dtype"],
        }
        if name in launches:
            row["launches_serve"] = launches[name]
        kernels.append(row)
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
