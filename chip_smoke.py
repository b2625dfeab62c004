#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA Hopper card, end to end.

    python3 chip_smoke.py

Phases, in order; the first failure ends the run with a non-zero exit:

1. Card and build: print the card's name and power limit, turn TF32 off,
   build the three kernels from ``src/repro_torch/csrc`` (one nvcc per
   source, all at once) into ``build/kernels/``.
2. Each kernel against its plain PyTorch version on the card, at the serving
   path's shapes in bf16 and at small shapes in f32, with the tolerance
   stated; per kernel its device time (torch.profiler), the plain version's,
   one PyTorch library call's (a yardstick the port never calls), its wall
   time per call between CUDA events (host launch cost included), and the
   least time the card could take (bytes at 3.35 TB/s or operations at the
   peak rate of their type).
3. Serve qwen3-0.6b at full width (28 layers, random weights from a seeded
   generator, bf16 compute) through ``BatchServer``: 8 ragged requests of
   64-700 prompt tokens, 32 new tokens each, EDF deadlines. Every kernel
   counter is zeroed just before and read just after; each must show at
   least the launches the path implies. Then one prefill and one decode step
   under ``torch.profiler`` for the device-time breakdown.
4. The card's f32 prefill logits (kernels) against the port's CPU forward
   (plain versions) from the same parameters, for one 64-token prompt.

The line before the last is one JSON object ``{"kernels": [...]}`` with the
numbers of this run; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA card, or without the repository's ``src/`` beside it, the
script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
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


def device_ms(fn, iters: int = 20) -> float:
    """Device time per call: the kernels' own durations from torch.profiler
    (CUPTI), summed, so host launch cost between kernels is left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages() if e.device_type.name == "CUDA")
    if us <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return us / iters / 1e3


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.kernels.swiglu import ops as swiglu_ops
    from repro_torch.kernels.swiglu.ref import swiglu_ref
    from repro_torch.models import init_cache, init_params, model_spec
    from repro_torch.models.layers import tree_map
    from repro_torch.runtime import (BatchServer, Request, ServeMetrics, make_decode_step,
                                     make_prefill_step)

    dev = torch.device("cuda")
    ops = {"rmsnorm": rms_ops, "swiglu": swiglu_ops, "flash_attention": flash_ops}

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
        out, want = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        diff = (out.float() - want.float()).abs()
        err = diff.max().item()
        bad = (diff > tol + tol * want.float().abs()).sum().item()
        if bad:
            raise AssertionError(f"{name} {shape_desc} {dtype}: {bad} elements outside "
                                 f"atol=rtol={tol} (max abs err {err})")
        rec = {
            "ms": device_ms(lambda: kernel(*args)),
            "plain_ms": device_ms(lambda: plain(*args)),
            "library_ms": device_ms(lambda: library(*args)) if library else None,
            "call_ms": time_ms(lambda: kernel(*args)),
            "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "ops_ms": nops / peak * 1e3,
        }
        rec["bound_ms"] = max(rec["bytes_ms"], rec["ops_ms"])
        rec["bound_by"] = "bytes" if rec["bytes_ms"] >= rec["ops_ms"] else "operations"
        rec.update(max_abs_err=err, tol=tol, shape=shape_desc, dtype=str(dtype).replace("torch.", ""))
        log(f"[2] {name:16s} {shape_desc:28s} {rec['dtype']:9s} max_abs_err {err:.3e} (tol {tol}) "
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

    def check_flash(s, heads, kv, dim, dtype, tol):
        q = randn(1, s, heads, dim, dtype=dtype)
        k, v = randn(1, s, kv, dim, dtype=dtype), randn(1, s, kv, dim, dtype=dtype)
        pairs = s * (s + 1) // 2
        return check("flash_attention", f"(1, {s}, {heads}/{kv}, {dim}) causal", dtype,
                     lambda q, k, v: flash_ops.flash_attention(q, k, v, causal=True),
                     lambda q, k, v: attention_ref(q.movedim(1, 2), k.movedim(1, 2),
                                                   v.movedim(1, 2), causal=True).movedim(1, 2),
                     lambda q, k, v: F.scaled_dot_product_attention(
                         q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                         is_causal=True, enable_gqa=True),
                     (q, k, v), tol, 2 * s * (heads + kv) * dim * esize(dtype), 4 * heads * dim * pairs,
                     PEAK_OPS[str(dtype).replace("torch.", "")])

    bf, f32 = torch.bfloat16, torch.float32
    s_max = 700  # the longest prompt of phase 3
    results["rmsnorm"] = check_rms(s_max, d, bf, 2e-2)
    check_rms(s_max * H, hd, bf, 2e-2)  # qk-norm rows
    check_rms(SLOTS, d, bf, 2e-2)  # decode
    check_rms(64, d, f32, 1e-5)
    check_rms(64 * H, hd, f32, 1e-5)
    results["swiglu"] = check_swiglu(s_max, ff, bf, 2e-2)
    check_swiglu(SLOTS, ff, bf, 2e-2)  # decode
    check_swiglu(64, ff, f32, 1e-6)
    check_flash(300, H, KV, hd, bf, 2e-2)
    results["flash_attention"] = check_flash(s_max, H, KV, hd, bf, 2e-2)
    check_flash(130, H, KV, hd, f32, 2e-5)
    check_flash(130, 4, 2, 48, f32, 2e-5)

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
    for mod in ops.values():
        mod.launches = 0
    m = server.run()
    torch.cuda.synchronize()
    launches = {name: mod.launches for name, mod in ops.items()}
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
    from torch.profiler import ProfilerActivity, profile

    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    one = init_cache(cfg, 1, MAX_SEQ)
    toks = torch.as_tensor(reqs[0].prompt, dtype=torch.long, device=dev)[None, :]
    batch_cache = init_cache(cfg, SLOTS, MAX_SEQ)
    dec_toks = torch.zeros((SLOTS, 1), dtype=torch.long, device=dev)
    for label, step in (("prefill 700", lambda: prefill(server.params, {"tokens": toks}, one)),
                        ("decode x4", lambda: decode(server.params, dec_toks, batch_cache, s_max))):
        step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        # device-side events only: a CPU op's device time repeats its kernels'
        dev_us = {e.key: e.self_device_time_total for e in prof.key_averages()
                  if e.device_type.name == "CUDA"}
        busy_ms = sum(dev_us.values()) / 1e3
        top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]
        log(f"[3] profile {label}: wall_ms {wall_ms:.3f} device_busy_ms {busy_ms:.3f} "
            f"idle_share {max(0.0, 1 - busy_ms / wall_ms):.3f}")
        for key, us in top:
            log(f"[3]     {us / 1e3:9.3f} ms  {key[:90]}")

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

    # ---- 5. result lines ---------------------------------------------------
    replaces = {
        "rmsnorm": "src/repro/kernels/rmsnorm/kernel.py:17",
        "swiglu": "src/repro/kernels/swiglu/kernel.py:12",
        "flash_attention": "src/repro/kernels/flash_attention/kernel.py:30",
    }
    kernels = [{
        "name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{name}.cu",
        "replaces": replaces[name], "launches": launches[name],
        "max_abs_err": rec["max_abs_err"], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
        "call_ms": rec["call_ms"], "shape": rec["shape"], "dtype": rec["dtype"],
    } for name, rec in results.items()]
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
