#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA Hopper card, end to end.

    python3 chip_smoke.py

Phases, in order; the first failure ends the run with a non-zero exit:

1. Card and build: print the card's name and power limit, turn TF32 off,
   build the six kernel libraries from ``src/repro_torch/csrc`` (one nvcc
   per source, all at once) into ``build/kernels/``; print each flash,
   rmsnorm and ssd_scan kernel's registers and spills (``-Xptxas -v``; the
   kD = 256 flash kernels and the ssd_scan backward's among them), the
   others' in sum.
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
   3.35 TB/s or operations at the peak rate of their type). rmsnorm is
   held at the serving and training shapes and at every width the
   reference takes: 768-4096 (the SSM models' norms), 3072, 5120 and 12288
   (other archs' model widths), 20000 (above the registers: one block per
   row) and, for the backward, 60000 (dscale sums beyond shared memory), a
   ragged width (1000) and a base one element into its buffer (element-wide
   accesses); every backward is run twice more and must give the same bits,
   and the profiler splits three backward calls by kernel. Flash
   attention is held in bf16 (the tensor-core kernels) at the training
   shape, the serving prompts, zamba2's (1, 700, 32/32, 64), a ragged S with
   D = 48, GQA without the causal mask, q/k/v sliced from one fused
   projection and rows that are not 16-byte aligned (the 2-byte staging),
   forward and backward; in f32 (the scalar kernels) at the training shape
   and two small ones; past D = 128 (the kD = 256 kernels) at D = 256 and a
   D = 192 padded to 256, in bf16 and f32, forward and backward; past
   D = 256 (the wide-D kernels, rows of their own with 0 launches on every
   main path) at (1, 2048, 8/4, 512), a ragged D = 257 and D = 320, in both
   types, forward and backward, SDPA the library time. Each flash row names
   the kernels the profiler saw (mma for bf16, scalar for f32, wide past
   D = 256), and every backward is run twice more on the same inputs and
   must give the same bits. quorum_compare
   also runs through the grid trainer's comparator on NaN and inf leaves.
   The int8 quantize and dequantize kernels are held bit for bit (codes,
   scales, and dequantized values at f32 and bf16) at the embedding
   gradient's shape and at a ragged (28, 128) leaf; no single PyTorch call
   computes the block-scaled int8 code, so they have no library time.
   ssd_scan is held at the mamba2 and zamba2 prefill shapes in bf16 and
   f32, with a ragged S and P tile, an initial state, two groups and a
   2048-token prompt at P = 128, N = 256 in 8 groups, and against the
   sequential oracle at the reference test's size to 3e-4; at the two
   prefill shapes the profiler splits a call's time between its three
   kernels. No single PyTorch call computes the SSD scan either. The
   ssd_scan backward is held against its plain version and against
   autograd of the plain forward, each gradient to 1e-4 (f32) or 2e-2
   (bf16, and its worst to 1e-2) of its leaf's largest entry, at the
   mamba2-130m and zamba2-1.2b training shapes (2 x 2048 tokens), a ragged
   (1, 333, 24, 40), two groups, N = 30 in 8 groups, and (1, 2048, 16, 128)
   N = 256 in 8 groups with an initial state and a final-state gradient, in
   bf16 and f32, as the main path calls it (the forward's states given:
   four launches, no rerun of the forward's kernels, by the profile's
   launch counts) and standalone (the states recomputed: six launches); the
   two routes must give the same bits, every call repeated must too, and
   neither may allocate per-head (B, S, H, N) shares. At the training
   shapes both routes' times are split by kernel beside the plain
   version's and the bound.
3. Serve qwen3-0.6b at full width (28 layers, random weights from a seeded
   generator, bf16 compute) through ``BatchServer``: 8 ragged requests of
   64-700 prompt tokens, 32 new tokens each, EDF deadlines. Every kernel
   counter is zeroed just before and read just after; each must show at
   least the launches the path implies. Then one prefill and one decode step
   under ``torch.profiler`` for the device-time breakdown; the prefill's must
   show the tensor-core flash kernel, and no profile a scalar one.
4. The card's f32 prefill logits (kernels) against the port's CPU forward
   (plain versions) from the same parameters, for one 64-token prompt.
5. Train qwen3-0.6b at full width through the volunteer grid
   (``GridTrainer``): 3 optimizer steps of 2 shards x 2 x 2048 tokens on 8
   simulated hosts with 5% erroneous and 15% malicious hosts. Every counter
   is zeroed just before and read just after; each of the seven (three
   forward, three backward, quorum_compare) must be non-zero. Then one grad
   job under ``torch.profiler`` for the device-time breakdown, which must
   show the three tensor-core flash kernels and no scalar one.
6. The card's f32 loss and gradients of one grad step (kernels) against the
   CPU's (plain versions): qwen3 widths at 2 layers, 1 x 256 tokens, the
   same parameters.
7. Train qwen3-0.6b at full width through the plain training loop
   (``runtime.train``): 3 steps of 2 x 2048 tokens with a checkpoint at
   step 2 (params and AdamW moments, ~7.2 GB, under ``build/``, after
   checking the free disk), then a second ``train`` call that restores it
   and runs step 3 again: its loss must equal the first run's. Counters are
   zeroed before the first call and read after it; the forward and
   backward kernels must be non-zero. Save and restore seconds and bytes,
   and the sha256 and npz-read seconds of the files measured alone.
8. Compress the full-width gradient tree of one grad step (13 leaves,
   596,180,992 elements) with ``compress_tree`` and decompress it with
   ``decompress_tree``, counters zeroed before and read after (both int8
   kernels non-zero): the payload and the decompressed tree equal the plain
   versions' bit for bit, the worst error is at most one quantization step
   of its leaf, and the wire bytes are about a quarter of f32's. Per tree:
   wall, device and queued times, and the host time to enqueue a call.
9. Serve mamba2-130m at full width (24 Mamba-2 layers, d=768, state 128)
   with the traffic of phase 3; counters zeroed before and read after:
   ssd_scan at least 24 per request, rmsnorm (2 x 24 + 1) per forward,
   flash_attention and swiglu none. Then one prefill and one decode step
   under ``torch.profiler``; the prefill's must show the three ssd_scan
   kernels, and no profile the single-block kernel they replaced.
10. mamba2-130m's f32 prefill logits on the card against the CPU (phase
    4's check, all 24 layers).
11. Serve zamba2-1.2b at full width (38 Mamba-2 layers in 6 groups of 6 and
    a tail of 2, d=2048, one weight-tied attention+MLP block after each
    group) with the same traffic: ssd_scan at least 38 per request,
    flash_attention 6 per request, swiglu 6 and rmsnorm (2 x 38 + 2 x 6 + 1)
    per forward; then the same profiles and checks.
12. zamba2-1.2b's f32 prefill logits on the card against the CPU at 8
    layers (one group and the tail).
13. Train mamba2-130m at full width through ``GridTrainer`` with phase 5's
    settings; counters zeroed before and read after: ssd_scan and rmsnorm,
    forward and backward, and quorum_compare non-zero, flash and swiglu
    none; 0 wrong accepted. One grad job profiled (busy time, idle share,
    the ssd_scan backward's time and the job's peak memory): it must show
    the ssd_scan backward's kernels, and the forward's chunk-state kernel
    no more often than the launch counter's forward calls (no rerun in the
    backward).
14. Phase 6's f32 card-against-CPU grad step for mamba2-130m at its full
    widths with 2 layers and zamba2-1.2b with 8 (one group and the tail):
    the loss to 1e-4, each leaf to 1e-3 of its largest entry.
15. Train mamba2-130m through ``runtime.train`` as phase 7 does (a ~1.6 GB
    checkpoint), the resumed loss equal to the first run's.
16. One zamba2-1.2b grad job at full width (38 layers, 2 x 2048 tokens)
    through ``make_grad_step``: ssd_scan, rmsnorm, flash_attention and
    swiglu, forward and backward, all launched; profiled as phase 13's.
Every main path (phases 3, 5, 7, 9, 11, 13, 15, 16) must launch no
wide-D flash kernel.

The line before the last is one JSON object ``{"kernels": [...]}`` with the
numbers of this run (``launches``: the counts of the grid training run
(phase 5) for the forward, backward and quorum kernels and of the
compression run (phase 8) for the int8 kernels and of the mamba2 serving
run (phase 9) for ssd_scan and of the f32 grad step (phase 6) for the f32
flash rows ``flash_attention_f32`` and ``flash_attention_bwd_f32``;
``launches_serve`` and ``launches_train_loop``, the serving run's and the
training loop's, where the kernel runs there, and for ssd_scan
``launches_serve_zamba2``, phase 11's, and ``launches_train``,
``launches_train_loop`` and ``launches_train_zamba2``, phases 13, 15 and
16's; ``ssd_scan_bwd``'s ``launches`` are phase 13's, and its row carries
its standalone time and its f32 and zamba2-shape times; the wide-D flash
rows' are phase 5's, 0; ``kernel`` on the flash rows); the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA card, or without the repository's ``src/`` beside it, the
script exits non-zero and prints no result.
"""
from __future__ import annotations

import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
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
# the training-loop phase: 3 steps, a checkpoint at step 2
LOOP_STEPS = 3
LOOP_PERIOD = 2


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


def profiled(fn, iters: int = 1, calls: dict | None = None):
    """Run ``fn`` ``iters`` times under torch.profiler; return the device
    microseconds per kernel name (device-side events only: a CPU op's device
    time repeats its kernels') and the wall milliseconds; ``calls``, when
    given, takes each kernel's number of launches. A session in which CUPTI
    delivered no kernel record is run again, up to PROFILER_ATTEMPTS times;
    after that the dict is empty."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, PROFILER_ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        events = [e for e in prof.key_averages()
                  if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
        dev_us = {e.key: e.self_device_time_total for e in events}
        if dev_us:
            if calls is not None:
                calls.update({e.key: e.count for e in events})
            return dev_us, wall_ms
        log(f"torch.profiler recorded no device time (attempt {attempt} of {PROFILER_ATTEMPTS})")
    return {}, wall_ms


def device_ms(fn, iters: int = 20, names: list | None = None) -> float:
    """Device time per call: the kernels' own durations from torch.profiler
    (CUPTI), summed, so host launch cost between kernels is left out. Where
    the profiler records nothing, CUDA events around queued launches. The
    port's kernels that the profiler saw (``short_kernel_names``) are
    appended to ``names`` when it is given."""
    import torch

    fn()
    torch.cuda.synchronize()
    dev_us, _ = profiled(fn, iters)
    if names is not None:
        names.extend(short_kernel_names(dev_us))
    if not dev_us:
        ms = queued_event_ms(fn, iters)
        log(f"device time from CUDA events around queued launches instead: {ms:.4f} ms")
        return ms
    return sum(dev_us.values()) / iters / 1e3


# the f32 flash kernels; bf16 runs the tensor-core (mma) kernels
SCALAR_FLASH = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkdv_kernel")
MMA_FLASH = ("flash_fwd_mma_kernel", "flash_bwd_dq_mma_kernel", "flash_bwd_dkdv_mma_kernel")
# one ssd_scan call: chunk states, the pass over the chunks, the outputs; and
# the single-block kernel they replaced, which no profile may show
SSD_KERNELS = ("ssd_chunk_state_kernel", "ssd_state_pass_kernel", "ssd_chunk_output_kernel")
OLD_SSD = "ssd_scan_kernel"
# one ssd_scan backward call on the main path (the forward's states kept):
# the chunk-state sums on dy and C, the pass in reverse, the chunk kernel and
# the fixed-order sums; the standalone route first reruns SSD_KERNELS[:2]
SSD_BWD_KERNELS = ("ssd_chunk_grad_state_kernel", "ssd_state_grad_pass_kernel",
                   "ssd_chunk_bwd_kernel", "ssd_bwd_reduce_kernel")
# the flash kernels past D = 256 (both types): the forward; Delta, dQ, dK/dV
WIDE_FLASH = ("flash_fwd_wide_kernel",)
WIDE_FLASH_BWD = ("flash_bwd_delta_kernel", "flash_bwd_dq_wide_kernel", "flash_bwd_dkdv_wide_kernel")


def short_kernel_names(dev_us) -> list:
    """The port's kernels among the profiler's keys, as ``name<template
    arguments>`` (e.g. ``flash_fwd_mma_kernel<128, true>``), sorted."""
    import re

    found = set()
    for key in dev_us:
        m = re.search(r"\b(\w+_kernel)(<[^>(]*>)?\(", key)
        if m and "(anonymous namespace)::" in key:
            found.add(m.group(1) + (m.group(2) or ""))
    return sorted(found)


def demangle_kernel(sym: str) -> str:
    """``name<args>`` of a mangled kernel symbol with int, bool, float or
    named template arguments (enough for the port's kernels)."""
    import re

    def name_at(end):  # the length-prefixed name that ends at ``end``
        for start in range(1, end):
            digits = re.search(r"\d+$", sym[:start])
            if digits and any(int(digits.group()[i:]) == end - start
                              for i in range(len(digits.group()))):
                return sym[start:end]
        return None

    for m in re.finditer(r"_kernel(?=[IE])", sym):
        name = name_at(m.end())
        if name:
            break
    else:
        return sym
    if sym[m.end()] == "E":  # not a template
        return name
    rest, args = sym[m.end() + 1:], []
    while rest and rest[0] != "E":
        if t := re.match(r"Li(-?\d+)E", rest):
            args.append(t.group(1))
        elif t := re.match(r"Lb([01])E", rest):
            args.append("true" if t.group(1) == "1" else "false")
        elif t := re.match(r"f", rest):
            args.append("float")
        elif t := re.match(r"(\d+)", rest):
            n = int(t.group(1))
            args.append(rest[t.end():t.end() + n])
            rest = rest[t.end() + n:]
            continue
        else:
            break
        rest = rest[t.end():]
    return f"{name}<{', '.join(args)}>"


def ptxas_usage(log: str) -> list:
    """Per entry function of an ``nvcc -Xptxas -v`` log: registers a
    thread, spill bytes (stores, loads) and static shared memory bytes."""
    import re

    rows = []
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            rows.append({"kernel": demangle_kernel(m.group(1))})
        elif rows and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            rows[-1]["spill"] = (int(m.group(1)), int(m.group(2)))
        elif rows and (m := re.search(r"Used (\d+) registers", line)):
            rows[-1]["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            rows[-1]["smem_static"] = int(smem.group(1)) if smem else 0
    return rows


def check_flash_profile(dev_us, want, label: str) -> None:
    """In a bf16 profile: every flash kernel named in ``want`` ran and no
    scalar (f32) flash kernel did. A profile with no records is not checked,
    which the log says."""
    if not dev_us:
        log(f"{label}: flash kernel names not checked (the profiler recorded nothing)")
        return
    names = short_kernel_names(dev_us)
    missing = [w for w in want if not any(n.split("<")[0] == w for n in names)]
    scalar = [n for n in names if n.split("<")[0] in SCALAR_FLASH]
    if missing or scalar:
        raise AssertionError(f"{label}: flash kernels {names}: missing {missing}, scalar {scalar}")
    log(f"{label}: flash kernels in the profile {[n for n in names if n.startswith('flash')]}")


def check_ssd_profile(dev_us, want: bool, label: str) -> None:
    """In a profile: the three ssd_scan kernels all ran (where ``want``) and
    the single-block kernel they replaced did not. A profile with no
    records is not checked, which the log says."""
    if not dev_us:
        log(f"{label}: ssd_scan kernel names not checked (the profiler recorded nothing)")
        return
    names = [n.split("<")[0] for n in short_kernel_names(dev_us)]
    missing = [k for k in SSD_KERNELS if want and k not in names]
    if missing or OLD_SSD in names:
        raise AssertionError(f"{label}: kernels {names}: ssd_scan kernels missing {missing}"
                             f"{f', and {OLD_SSD} ran' if OLD_SSD in names else ''}")
    if want:
        log(f"{label}: ssd_scan kernels in the profile {[n for n in names if n.startswith('ssd')]}")


def check_ssd_bwd_profile(dev_us, label: str, calls: dict | None = None, forwards: int = 0,
                          standalone: bool = False) -> None:
    """In a profile: the ssd_scan backward's kernels ran. ``standalone``
    (no states given): the forward's chunk-state kernel and pass ran before
    them. Else, with ``calls`` (each kernel's launches in the profile): the
    forward's chunk-state kernel ran no more often than the ``forwards``
    forward calls that the launch counter saw in the same window, so no
    backward call reran it on (x, B) (a rerun adds one a backward call; a
    record the profiler lost only lowers the count). A profile with no
    records is not checked, which the log says."""
    if not dev_us:
        log(f"{label}: ssd_scan backward kernel names not checked (the profiler recorded nothing)")
        return
    names = [n.split("<")[0] for n in short_kernel_names(dev_us)]
    want = (*SSD_BWD_KERNELS, *SSD_KERNELS[:2]) if standalone else SSD_BWD_KERNELS
    missing = [k for k in want if k not in names]
    if missing:
        raise AssertionError(f"{label}: kernels {names}: ssd_scan backward kernels missing {missing}")
    if not standalone and calls is not None:
        launched = {k: sum(n for key, n in calls.items()
                           if (short_kernel_names({key: 1}) or ["?"])[0].split("<")[0] == k)
                    for k in (SSD_KERNELS[0], SSD_BWD_KERNELS[2])}
        if launched[SSD_KERNELS[0]] > forwards:
            raise AssertionError(f"{label}: launches {launched} for {forwards} forward calls: the "
                                 f"backward reran the forward's chunk-state kernel")
        log(f"{label}: launches {json.dumps(launched)} for {forwards} forward calls: no rerun of the "
            f"forward's chunk-state kernel in the backward")
    log(f"{label}: ssd_scan kernels in the profile {[n for n in names if n.startswith('ssd')]}")


def profile_breakdown(fn, label: str, top: int = 10, calls: dict | None = None):
    """Run ``fn`` once under torch.profiler; print wall, device-busy and idle
    share and the ``top`` kernels by device time; return the per-kernel
    device microseconds (empty where the profiler recorded none) and the
    wall milliseconds (``calls`` as ``profiled``'s)."""
    dev_us, wall_ms = profiled(fn, calls=calls)
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
    from repro_torch.kernels.int8_quant import ops as int8_ops
    from repro_torch.kernels.int8_quant.ref import int8_dequantize_ref, int8_quantize_ref
    from repro_torch.kernels.quorum_compare import ops as quorum_ops
    from repro_torch.kernels.quorum_compare.ref import quorum_compare_ref
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref, rmsnorm_ref
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ref import ssd_ref, ssd_scan_bwd_ref, ssd_scan_ref
    from repro_torch.kernels.swiglu import ops as swiglu_ops
    from repro_torch.kernels.swiglu.ref import swiglu_bwd_ref, swiglu_ref
    from repro_torch.models import hybrid_layout, init_cache, init_params, model_spec, ssm_config
    from repro_torch.checkpoint.checkpointer import _checksum as checkpoint_sha256
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.optim import AdamWConfig, compress_tree, compressed_bytes, decompress_tree
    from repro_torch.runtime import (BatchServer, GridTrainer, Request, ServeMetrics,
                                     grad_comparator, make_decode_step, make_grad_step,
                                     make_prefill_step, train)

    dev = torch.device("cuda")
    ops = {"rmsnorm": rms_ops, "swiglu": swiglu_ops, "flash_attention": flash_ops}
    bwd_ops = {"rmsnorm_bwd": rms_ops, "swiglu_bwd": swiglu_ops, "flash_attention_bwd": flash_ops}

    fwd_ops = {**ops, "ssd_scan": ssd_ops}  # the serving paths' kernels
    WIDE = ("flash_attention_wide", "flash_attention_bwd_wide")  # no main path runs them

    def counts():
        """Every launch counter: forward, backward, quorum_compare, int8, ssd_scan
        forward and backward, and the flash calls past D = 256."""
        out = {name: mod.launches for name, mod in fwd_ops.items()}
        out.update({name: mod.launches_bwd for name, mod in bwd_ops.items()})
        out["ssd_scan_bwd"] = ssd_ops.launches_bwd
        out["flash_attention_wide"] = flash_ops.launches_wide
        out["flash_attention_bwd_wide"] = flash_ops.launches_wide_bwd
        out["quorum_compare"] = quorum_ops.launches
        out["int8_quantize"] = int8_ops.launches_quantize
        out["int8_dequantize"] = int8_ops.launches_dequantize
        return out

    def zero_counts():
        for mod in (rms_ops, swiglu_ops, flash_ops):
            mod.launches = mod.launches_bwd = 0
        quorum_ops.launches = ssd_ops.launches = ssd_ops.launches_bwd = 0
        flash_ops.launches_wide = flash_ops.launches_wide_bwd = 0
        int8_ops.launches_quantize = int8_ops.launches_dequantize = 0

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
    if len(nvcc_s) != 6:
        raise AssertionError(f"built {sorted(nvcc_s)}, expected six libraries")
    log(f"[1] built {', '.join(nvcc_s)} in {time.perf_counter() - t0:.2f} s wall "
        f"(nvcc s: {json.dumps({k: round(v, 2) for k, v in nvcc_s.items()})})")
    for lib, text in sorted(_build.logs.items()):  # -Xptxas -v: flash, rmsnorm, ssd per kernel
        usage = ptxas_usage(text)
        if lib in ("flash_attention", "rmsnorm", "ssd_scan"):
            for u in usage:
                log(f"[1] ptxas {u['kernel']}: registers {u.get('registers')}, spill bytes "
                    f"(stores, loads) {u.get('spill')}, static smem {u.get('smem_static')}")
            continue
        regs = [u.get("registers", 0) for u in usage]
        spills = [u["kernel"] for u in usage if any(u.get("spill", (0, 0)))]
        log(f"[1] ptxas {lib}: {len(usage)} kernels, registers {min(regs, default=0)}-"
            f"{max(regs, default=0)}, spilling {spills or 'none'}")

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
        seen = []
        rec = {
            "ms": device_ms(lambda: kernel(*args), names=seen),
            "plain_ms": device_ms(lambda: plain(*args)),
            "library_ms": device_ms(lib) if lib else None,
            "call_ms": time_ms(lambda: kernel(*args)),
            "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "ops_ms": nops / peak * 1e3,
        }
        rec["bound_ms"] = max(rec["bytes_ms"], rec["ops_ms"])
        rec["bound_by"] = "bytes" if rec["bytes_ms"] >= rec["ops_ms"] else "operations"
        rec.update(max_abs_err=err, tol=tol, shape=shape_desc, dtype=str(dtype).replace("torch.", ""),
                   kernels=sorted(set(seen)))
        log(f"[2] {name:20s} {shape_desc:28s} {rec['dtype']:9s} max_abs_err {err:.3e} (tol {tol}) "
            f"kernel_ms {rec['ms']:.4f} (call {rec['call_ms']:.4f}) plain_ms {rec['plain_ms']:.4f} "
            f"library_ms {rec['library_ms'] if rec['library_ms'] is None else round(rec['library_ms'], 4)} "
            f"bound_ms {rec['bound_ms']:.4f} ({rec['bound_by']})"
            + (f" kernels {rec['kernels']}" if name.startswith("flash") else ""))
        return rec

    def rms_input(rows, width, dtype, misaligned):
        """(rows, width) normal values; with ``misaligned``, a contiguous view
        one element into its buffer (not 16-byte aligned: the element-wide
        accesses)."""
        flat = randn(rows * width + 1, dtype=dtype)
        return (flat[1:] if misaligned else flat[:-1]).view(rows, width)

    def rms_desc(rows, width, misaligned):
        return f"({rows}, {width}){' +1 elem' if misaligned else ''}"

    def check_rms(rows, width, dtype, tol, misaligned=False):
        x, sc = rms_input(rows, width, dtype, misaligned), randn(width, dtype=torch.float32)
        sc_lib = sc.to(dtype)
        es = esize(dtype)
        return check("rmsnorm", rms_desc(rows, width, misaligned), dtype,
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

    def flash_inputs(b, s, heads, kv, dim, dtype, layout="contiguous", extra=()):
        """q, k, v on the model layout, and ``extra`` (B, S, H, D) tensors
        (dO): contiguous; "fused", slices of one (B, S, H + 2 KV, D)
        projection (strided heads, no copy); or "wide", the first ``dim`` of
        ``dim + 4`` columns (rows not 16-byte aligned: the 2-byte staging)."""
        if layout == "fused":
            qkv = randn(b, s, heads + 2 * kv, dim, dtype=dtype)
            qkv_ = (qkv[:, :, :heads], qkv[:, :, heads:heads + kv], qkv[:, :, heads + kv:])
            return qkv_ + tuple(randn(b, s, heads, dim, dtype=dtype) for _ in extra)
        width = dim + 4 if layout == "wide" else dim
        return tuple(randn(b, s, n, width, dtype=dtype)[..., :dim] for n in (heads, kv, kv, *extra))

    def flash_kernels_ran(rec, names, dtype, layout, label, dim):
        """The profiled launches ran the tensor-core kernels for bf16 (the
        2-byte staging variant for the "wide" layout) and the scalar ones
        for f32, and past D = 256 the wide-D kernels (``names`` then) in
        the input's type; not checked where the profiler recorded nothing."""
        seen = rec["kernels"]
        if not seen:
            log(f"[2] {label}: kernel names not checked (the profiler recorded nothing)")
            return
        if dim > flash_ops.MAX_TILE_D:
            want = sorted(f"{n}<{'float' if dtype == f32 else '__nv_bfloat16'}>" for n in names)
            if seen != want:
                raise AssertionError(f"{label} {dtype} D = {dim}: ran {seen}, want {want}")
            return
        want = [n + ("<float," if dtype == f32 else "<") for n in names]
        ok = all(any(k.startswith(w) for k in seen) for w in want) and len(seen) == len(want)
        if dtype == bf and ok:
            ok = all(k.endswith("false>" if layout == "wide" else "true>") for k in seen)
        if not ok:
            raise AssertionError(f"{label} {dtype} {layout}: ran {seen}, want {want}")

    def check_flash(s, heads, kv, dim, dtype, tol, b=1, with_lse=False, causal=True,
                    layout="contiguous"):
        q, k, v = flash_inputs(b, s, heads, kv, dim, dtype, layout)
        pairs = b * s * (s + 1) // 2 if causal else b * s * s
        rec = check("flash_attention", f"({b}, {s}, {heads}/{kv}, {dim}) "
                    f"{'causal' if causal else 'full'}{'' if layout == 'contiguous' else ' ' + layout}",
                    dtype,
                    lambda q, k, v: flash_ops.flash_attention_fwd(q, k, v, causal=causal,
                                                                  with_lse=with_lse)[0],
                    lambda q, k, v: attention_ref(q.movedim(1, 2), k.movedim(1, 2),
                                                  v.movedim(1, 2), causal=causal).movedim(1, 2),
                    lambda q, k, v: F.scaled_dot_product_attention(
                        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                        is_causal=causal, enable_gqa=True),
                    (q, k, v), tol, 2 * b * s * (heads + kv) * dim * esize(dtype) + 4 * b * heads * s * with_lse,
                    4 * heads * dim * pairs,
                    PEAK_OPS[str(dtype).replace("torch.", "")])
        flash_kernels_ran(rec, WIDE_FLASH if dim > flash_ops.MAX_TILE_D else
                          MMA_FLASH[:1] if dtype == bf else SCALAR_FLASH[:1], dtype, layout,
                          "flash_attention", dim)
        return rec

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
    # every width the reference takes: mamba2's model width and gated norm,
    # zamba2's model width and gated norm at a 700-token prefill; phi4-mini's,
    # pixtral's and command-r-plus's model widths; a width above what the
    # registers hold (one block per row, read twice); a ragged width and a
    # misaligned base (element-wide accesses)
    for width in (768, 1536, 2048, 4096):
        check_rms(s_max, width, bf, 2e-2)
    for width in (3072, 5120, 12288):
        check_rms(300, width, bf, 2e-2)
    check_rms(64, 20000, bf, 2e-2)
    check_rms(64, 20000, f32, 1e-5)
    check_rms(s_max, 1000, bf, 2e-2)
    check_rms(s_max, d, bf, 2e-2, misaligned=True)
    check_rms(64, d, f32, 1e-5, misaligned=True)
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
    # zamba2's shared attention block at its prefill shape; a ragged S with
    # D = 48 (padded to 64); GQA without the causal mask; q, k and v as
    # slices of one fused projection (96-byte rows); rows that are not
    # 16-byte aligned, which take the 2-byte staging
    check_flash(s_max, 32, 32, 64, bf, 2e-2)
    check_flash(130, 4, 2, 48, bf, 2e-2)
    check_flash(256, 8, 2, 128, bf, 2e-2, causal=False)
    check_flash(150, 4, 2, 48, bf, 2e-2, layout="fused")
    check_flash(130, 4, 2, 40, bf, 2e-2, layout="wide")
    # the scalar f32 kernel at the training shape: its own row
    results["flash_attention_f32"] = check_flash(TRAIN_SEQ, H, KV, hd, f32, 2e-5, b=TRAIN_BATCH,
                                                 with_lse=True)
    # past D = 128: the kD = 256 kernels at D = 256 and at D = 192 (padded
    # to 256), bf16 and f32
    check_flash(TRAIN_SEQ, 8, 4, 256, bf, 2e-2)
    check_flash(300, 8, 4, 256, bf, 2e-2)
    check_flash(130, 4, 2, 192, bf, 2e-2, causal=False)
    check_flash(512, 8, 4, 256, f32, 2e-5)
    check_flash(130, 4, 2, 192, f32, 2e-5)
    # past D = 256: the wide-D kernels at (1, 2048, 8/4, 512), bf16 and f32,
    # their own rows (no configuration runs them: 0 launches on the main
    # paths); a ragged D = 257 without the causal mask, and D = 320
    results["flash_attention_wide"] = check_flash(TRAIN_SEQ, 8, 4, 512, bf, 2e-2)
    results["flash_attention_wide_f32"] = check_flash(TRAIN_SEQ, 8, 4, 512, f32, 2e-5)
    check_flash(130, 4, 2, 257, bf, 2e-2, causal=False)
    check_flash(130, 4, 2, 320, f32, 2e-5)

    # backward kernels at the training path's shapes (2 x 2048 tokens)
    def autograd_bwd(fn, inputs, dy):
        """The library yardstick for a backward: autograd's backward of
        ``fn`` (one forward here, the backward timed alone)."""
        leaves = [t.detach().clone().requires_grad_() for t in inputs]
        y = fn(*leaves)
        dy = dy.contiguous()  # cuDNN's attention backward refuses unaligned rows
        return lambda: torch.autograd.grad(y, leaves, dy, retain_graph=True)

    def check_rms_bwd(rows, width, dtype, tol, misaligned=False, split=False):
        """The backward against its plain version and two more calls on the
        same inputs, which must give the same bits; with ``split``, each
        kernel's share of one call from the profiler."""
        x, dy = (rms_input(rows, width, dtype, misaligned) for _ in range(2))
        sc = randn(width, dtype=torch.float32)
        es = esize(dtype)
        lib = autograd_bwd(lambda x, w: F.rms_norm(x, (width,), w, cfg.norm_eps),
                           (x, sc.to(dtype)), dy)
        desc = rms_desc(rows, width, misaligned)
        rec = check("rmsnorm_bwd", desc, dtype,
                    lambda x, s, g: rms_ops.rmsnorm_bwd(x, s, g, cfg.norm_eps),
                    lambda x, s, g: rmsnorm_bwd_ref(x, s, g, cfg.norm_eps), lib,
                    (x, sc, dy), tol, 3 * rows * width * es + 8 * width, 10 * rows * width,
                    PEAK_OPS["float32"])
        first = rms_ops.rmsnorm_bwd(x, sc, dy, cfg.norm_eps)
        again = rms_ops.rmsnorm_bwd(x, sc, dy, cfg.norm_eps)
        if not all(torch.equal(a, b) for a, b in zip(first, again)):
            raise AssertionError(f"rmsnorm backward {desc} {dtype}: two calls on the same inputs differ")
        if split:
            # every kernel the call ran (a fill kernel would show here too)
            dev_us, _ = profiled(lambda: rms_ops.rmsnorm_bwd(x, sc, dy, cfg.norm_eps), 20)
            split_ms = {(short_kernel_names({k: us}) or [k[:60]])[0]: round(us / 20 / 1e3, 5)
                        for k, us in dev_us.items()}
            log(f"[2] rmsnorm_bwd {desc} {rec['dtype']}: device ms per call by kernel "
                f"{json.dumps(split_ms)} ({rms_ops.bwd_parts(rows, width)} blocks of partials)")
        return rec

    def check_swiglu_bwd(rows, width, dtype, tol):
        g, u, dh = (randn(rows, width, dtype=dtype) for _ in range(3))
        n = rows * width
        lib = autograd_bwd(lambda g, u: F.silu(g) * u, (g, u), dh)
        return check("swiglu_bwd", f"({rows}, {width})", dtype, swiglu_ops.swiglu_bwd,
                     swiglu_bwd_ref, lib, (g, u, dh), tol, 5 * n * esize(dtype), 14 * n,
                     PEAK_OPS["float32"])

    def check_flash_bwd(b, s, heads, kv, dim, dtype, tol, causal=True, layout="contiguous"):
        if layout == "contiguous":
            q, do = randn(b, s, heads, dim, dtype=dtype), randn(b, s, heads, dim, dtype=dtype)
            k, v = randn(b, s, kv, dim, dtype=dtype), randn(b, s, kv, dim, dtype=dtype)
        else:
            q, k, v, do = flash_inputs(b, s, heads, kv, dim, dtype, layout, extra=(heads,))
        out, lse = flash_ops.flash_attention_fwd(q, k, v, causal=causal, with_lse=True)
        want_out, want_lse = attention_ref(q.movedim(1, 2), k.movedim(1, 2), v.movedim(1, 2),
                                           causal=causal, return_lse=True)
        lse_err = (lse - want_lse).abs().max().item()
        out_err = (out.float() - want_out.movedim(1, 2).float()).abs().max().item()
        if lse_err > 1e-3 or out_err > tol:
            raise AssertionError(f"flash forward with lse: lse err {lse_err}, out err {out_err}")
        log(f"[2] flash forward with lse ({b}, {s}, {heads}/{kv}, {dim}) {dtype}: "
            f"lse max abs err {lse_err:.3e} (tol 1e-3), out max abs err {out_err:.3e}")
        pairs = s * (s + 1) // 2 if causal else s * s
        lib = autograd_bwd(lambda q, k, v: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=causal,
            enable_gqa=True).transpose(1, 2), (q, k, v), do)
        es = esize(dtype)
        nbytes = b * s * (4 * heads + 4 * kv) * dim * es + b * heads * s * 4  # + lse
        rec = check("flash_attention_bwd",
                    f"({b}, {s}, {heads}/{kv}, {dim}) "
                    f"{'causal' if causal else 'full'}{'' if layout == 'contiguous' else ' ' + layout}",
                    dtype,
                    lambda q, k, v, o, l, g: flash_ops.flash_attention_bwd(q, k, v, o, l, g,
                                                                           causal=causal),
                    lambda q, k, v, o, l, g: tuple(t.movedim(1, 2) for t in attention_bwd_ref(
                        q.movedim(1, 2), k.movedim(1, 2), v.movedim(1, 2), o.movedim(1, 2), l,
                        g.movedim(1, 2), causal=causal)),
                    lib, (q, k, v, out, lse, do), tol, nbytes,
                    2.5 * 4 * b * heads * dim * pairs, PEAK_OPS[str(dtype).replace("torch.", "")])
        flash_kernels_ran(rec, WIDE_FLASH_BWD if dim > flash_ops.MAX_TILE_D else
                          MMA_FLASH[1:] if dtype == bf else SCALAR_FLASH[1:], dtype, layout,
                          "flash_attention_bwd", dim)
        # no float atomics: two calls on the same inputs give the same bits
        first = flash_ops.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
        again = flash_ops.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
        if not all(torch.equal(x, y) for x, y in zip(first, again)):
            raise AssertionError(f"flash backward ({b}, {s}, {heads}/{kv}, {dim}) {dtype}: two calls "
                                 f"on the same inputs differ")
        return rec

    results["rmsnorm_bwd"] = check_rms_bwd(n_tok, d, bf, 2e-2, split=True)
    check_rms_bwd(n_tok * H, hd, bf, 2e-2, split=True)  # q-norm rows
    check_rms_bwd(n_tok * KV, hd, bf, 2e-2)  # k-norm rows
    # f32 at 1e-4: dscale sums 4096 or 65536 rows in another order than torch
    check_rms_bwd(n_tok, d, f32, 1e-4)
    check_rms_bwd(n_tok * H, hd, f32, 1e-4)
    # the widths of the forward's list: mamba2's gated norm, zamba2's model
    # width and gated norm at one grad job's 4096 tokens; phi4-mini's,
    # pixtral's and command-r-plus's; above the registers (dscale sums in
    # shared memory) and above shared memory (in the block's partials row);
    # ragged; misaligned
    for width in (1536, 2048, 4096):
        check_rms_bwd(n_tok, width, bf, 2e-2)
    for width in (3072, 5120, 12288):
        check_rms_bwd(300, width, bf, 2e-2, split=width == 12288)
    check_rms_bwd(64, 20000, bf, 2e-2)
    check_rms_bwd(4, 60000, f32, 1e-4)
    check_rms_bwd(s_max, 1000, bf, 2e-2)
    check_rms_bwd(n_tok, d, bf, 2e-2, misaligned=True)
    results["swiglu_bwd"] = check_swiglu_bwd(n_tok, ff, bf, 2e-2)
    check_swiglu_bwd(n_tok, ff, f32, 1e-5)
    results["flash_attention_bwd"] = check_flash_bwd(TRAIN_BATCH, TRAIN_SEQ, H, KV, hd, bf, 2e-2)
    # f32 at 1e-4: dQ, dK and dV sum up to 2048 keys or queries per element
    results["flash_attention_bwd_f32"] = check_flash_bwd(TRAIN_BATCH, TRAIN_SEQ, H, KV, hd, f32, 1e-4)
    check_flash_bwd(1, 130, 4, 2, 48, f32, 2e-5)
    # the bf16 shapes of the forward's list: serving prompts, zamba2's
    # block, ragged, no causal mask, fused, 2-byte staging
    check_flash_bwd(1, 300, H, KV, hd, bf, 2e-2)
    check_flash_bwd(1, s_max, H, KV, hd, bf, 2e-2)
    check_flash_bwd(1, s_max, 32, 32, 64, bf, 2e-2)
    check_flash_bwd(1, 130, 4, 2, 48, bf, 2e-2)
    check_flash_bwd(1, 256, 8, 2, 128, bf, 2e-2, causal=False)
    check_flash_bwd(1, 150, 4, 2, 48, bf, 2e-2, layout="fused")
    check_flash_bwd(1, 130, 4, 2, 40, bf, 2e-2, layout="wide")
    # past D = 128: the kD = 256 kernels (dK/dV in two column halves)
    check_flash_bwd(1, TRAIN_SEQ, 8, 4, 256, bf, 2e-2)
    check_flash_bwd(1, 300, 8, 4, 256, bf, 2e-2)
    check_flash_bwd(1, 130, 4, 2, 192, bf, 2e-2, causal=False)
    check_flash_bwd(1, 512, 8, 4, 256, f32, 1e-4)
    check_flash_bwd(1, 130, 4, 2, 192, f32, 2e-5)
    # past D = 256: the wide-D kernels (Delta, dQ, dK/dV over 64-column slices)
    results["flash_attention_bwd_wide"] = check_flash_bwd(1, TRAIN_SEQ, 8, 4, 512, bf, 2e-2)
    results["flash_attention_bwd_wide_f32"] = check_flash_bwd(1, TRAIN_SEQ, 8, 4, 512, f32, 1e-4)
    check_flash_bwd(1, 130, 4, 2, 257, bf, 2e-2, causal=False)
    check_flash_bwd(1, 130, 4, 2, 320, f32, 2e-5)

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

    # int8 quantize and dequantize, bit for bit (tolerance 0), at the
    # embedding gradient's shape and at a ragged leaf (padded to 14 x 256,
    # one tile of 14 rows); no PyTorch call computes this block-scaled code
    def check_int8(shape, dtype, out_dtypes):
        x = randn(*shape, dtype=dtype)
        n = x.numel()
        rows2d, br = int8_ops.to_rows(x)
        rows, nb = rows2d.shape[0], rows2d.shape[0] // br
        m = rows * int8_ops.LANES  # padded elements
        desc = f"{tuple(shape)} -> ({rows}, 256) br {br}"
        # bytes: x read, codes and scales written; operations: abs, max,
        # divide, round, two clamps per element
        rec_q = check("int8_quantize", desc, dtype, lambda x: int8_ops.int8_quantize(x),
                      lambda x: int8_quantize_ref(*int8_ops.to_rows(x)), None, (x,), 0.0,
                      m * (esize(dtype) + 1) + nb * 4, 6 * m, PEAK_OPS["float32"])
        q, sc = int8_ops.int8_quantize(x)
        rec_d = None
        for od in out_dtypes:
            rec = check("int8_dequantize", f"{desc} to {str(od).replace('torch.', '')}", od,
                        lambda q, s: int8_ops.int8_dequantize(q, s, n=n, shape=tuple(shape),
                                                              out_dtype=od),
                        lambda q, s: int8_dequantize_ref(q, s, br, od).reshape(-1)[:n].reshape(shape),
                        None, (q, sc), 0.0, m * (1 + esize(od)) + nb * 4, m, PEAK_OPS["float32"])
            rec_d = rec_d or rec
        return rec_q, rec_d

    results["int8_quantize"], results["int8_dequantize"] = check_int8(
        (cfg.padded_vocab, d), f32, (f32, bf))
    check_int8((28, 128), f32, (f32, bf))
    check_int8((28, 128), bf, (bf,))

    # ssd_scan at the mamba2 and zamba2 prefill shapes (phases 9 and 11) in
    # bf16 and f32, a ragged S and P tile, an initial state, two groups; A and
    # dt drawn in Mamba-2's published ranges (A in U[1, 16], dt log-uniform in
    # [0.001, 0.1]). Bound: bytes (x, B, C, dt, A, the initial state read
    # once; y and the final state written once) or operations (the state
    # update and the output, 2 x 2 x P x N per position and head, at the peak
    # of the input type: bf16 products are exact in f32 and could run on the
    # tensor cores); no single PyTorch call computes the SSD scan.
    def uniform(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    def check_ssd(b, s, h, p, g, n, dtype, tol, init=False, split=False):
        x = randn(b, s, h, p, dtype=dtype)
        dt = torch.exp(uniform(b, s, h, lo=math.log(1e-3), hi=math.log(0.1)))
        A = -uniform(h, lo=1.0, hi=16.0)
        bm, cm = ((randn(b, s, g, n, dtype=f32) * 0.3).to(dtype) for _ in range(2))
        st0 = randn(b, h, p, n, dtype=f32) * 0.5 if init else None
        es = esize(dtype)
        nbytes = (2 * b * s * h * p + 2 * b * s * g * n) * es + 4 * (b * s * h + h) \
            + 4 * b * h * p * n * (2 if init else 1)
        desc = f"({b}, {s}, {h}, {p}) g{g} n{n}{' +state' if init else ''}"
        rec = check("ssd_scan", desc, dtype,
                    lambda x, dt, A, bm, cm, st0: ssd_ops.ssd_scan(x, dt, A, bm, cm, initial_state=st0),
                    lambda x, dt, A, bm, cm, st0: ssd_scan_ref(x, dt, A, bm, cm, block_q=256,
                                                              initial_state=st0),
                    None, (x, dt, A, bm, cm, st0), tol, nbytes, 4 * b * s * h * p * n,
                    PEAK_OPS[str(dtype).replace("torch.", "")])
        if split:
            # each of the call's three kernels, device ms per call
            dev_us, _ = profiled(lambda: ssd_ops.ssd_scan(x, dt, A, bm, cm, initial_state=st0), 20)
            split_ms = {(short_kernel_names({k: us}) or [k[:60]])[0]: round(us / 20 / 1e3, 5)
                        for k, us in dev_us.items()}
            check_ssd_profile(dev_us, True, f"[2] ssd_scan {desc}")
            log(f"[2] ssd_scan {desc} {rec['dtype']}: device ms per call by kernel "
                f"{json.dumps(split_ms)}")
        return rec

    results["ssd_scan"] = check_ssd(1, s_max, 24, 64, 1, 128, bf, 2e-2, split=True)  # mamba2-130m
    check_ssd(1, s_max, 24, 64, 1, 128, f32, 1e-4, split=True)
    check_ssd(1, s_max, 64, 64, 1, 64, bf, 2e-2, split=True)  # zamba2-1.2b
    check_ssd(1, s_max, 64, 64, 1, 64, f32, 1e-4, split=True)
    check_ssd(1, s_max, 24, 64, 1, 128, f32, 1e-4, init=True)
    check_ssd(1, s_max, 24, 64, 1, 128, bf, 2e-2, init=True)
    check_ssd(1, 333, 24, 40, 1, 128, f32, 1e-4)  # a ragged last chunk and P tile
    check_ssd(2, 200, 8, 32, 2, 32, f32, 1e-4)  # groups
    check_ssd(1, TRAIN_SEQ, 16, 128, 8, 256, bf, 2e-2, init=True)  # P = 128, N = 256, 8 groups
    check_ssd(1, TRAIN_SEQ, 16, 128, 8, 256, f32, 1e-4)

    def check_ssd_oracle(b, s, h, p, g, n):
        """Against the sequential recurrence, with the reference test's
        distributions and tolerance (3e-4, f32)."""
        x = randn(b, s, h, p, dtype=f32)
        dt = F.softplus(randn(b, s, h, dtype=f32)) * 0.05 + 0.001
        A = -torch.exp(randn(h, dtype=f32) * 0.3)
        bm, cm = (randn(b, s, g, n, dtype=f32) * 0.3 for _ in range(2))
        got, want = ssd_ops.ssd_scan(x, dt, A, bm, cm), ssd_ref(x, dt, A, bm, cm)
        for label, o, w in zip(("y", "final state"), got, want):
            err = (o - w).abs().max().item()
            log(f"[2] ssd_scan {label} against the sequential oracle ({b}, {s}, {h}, {p}) g{g} n{n} "
                f"float32: max abs err {err:.3e} (tol 3e-4)")
            if ((o - w).abs() > 3e-4 + 3e-4 * w.abs()).any():
                raise AssertionError(f"ssd_scan {label} against ssd_ref: max abs err {err}")

    check_ssd_oracle(1, 200, 8, 32, 2, 32)

    # the ssd_scan backward against its plain version (ssd_scan_bwd_ref) and
    # against autograd of the plain forward, on the card: each gradient to
    # tol times its leaf's largest entry (f32 1e-4; bf16 2e-2: the chunk's
    # products take bf16 operands and dx, dB and dC are bf16); two more calls
    # on the same inputs must give the same bits, and the main path's call
    # (given the forward's states, as the autograd function passes them) the
    # standalone call's bits (which recomputes them). Bound: bytes (x, dy, B,
    # C, dt, A and, with a state, the initial state and the final state's
    # gradient read once; dx, dB, dC, ddt, dA and dinit written once) or
    # operations (the gradients of the forward's two P x N products per
    # position and head, 2 x 4 x P x N, at the input type's peak; the
    # forward's rule, doubled).
    def scratch_mb(scratch):
        return sum(math.prod(shape) * esize(dt_) for shape, dt_ in scratch.values()) / 1e6

    def check_ssd_bwd(b, s, h, p, g, n, dtype, tol, init=False, timed=False):
        x, dy = randn(b, s, h, p, dtype=dtype), randn(b, s, h, p, dtype=dtype)
        dt = torch.exp(uniform(b, s, h, lo=math.log(1e-3), hi=math.log(0.1)))
        A = -uniform(h, lo=1.0, hi=16.0)
        bm, cm = ((randn(b, s, g, n, dtype=f32) * 0.3).to(dtype) for _ in range(2))
        st0 = randn(b, h, p, n, dtype=f32) * 0.5 if init else None
        dst = randn(b, h, p, n, dtype=f32) if init else None
        desc = f"({b}, {s}, {h}, {p}) g{g} n{n}{' +state' if init else ''}"
        states = ssd_ops.ssd_scan_with_states(x, dt, A, bm, cm, initial_state=st0)[2]

        def kernel():  # the main path's call: the forward's states
            return ssd_ops.ssd_scan_bwd(x, dt, A, bm, cm, dy, dst, st0, states=states)

        def standalone():  # the states recomputed
            return ssd_ops.ssd_scan_bwd(x, dt, A, bm, cm, dy, dst, st0)

        def plain():
            return ssd_scan_bwd_ref(x, dt, A, bm, cm, dy, dst, st0, block_q=256)

        got = kernel()
        torch.cuda.synchronize()
        main_scratch = dict(ssd_ops.last_bwd_scratch)
        alone = standalone()
        torch.cuda.synchronize()
        alone_scratch = dict(ssd_ops.last_bwd_scratch)
        if not all(torch.equal(u, v) for u, v in zip(got, alone)):
            raise AssertionError(f"ssd_scan_bwd {desc} {dtype}: the main path's call and the "
                                 f"standalone call differ")
        # no per-head (B, S, H, N) shares, and on the main path no recompute
        if "ws" in main_scratch or any(shape == (b, s, h, n) for shape, _ in
                                       (*main_scratch.values(), *alone_scratch.values())):
            raise AssertionError(f"ssd_scan_bwd {desc}: scratch {main_scratch} / {alone_scratch}")
        want = plain()
        leaves = [t.detach().clone().requires_grad_() for t in (x, dt, A, bm, cm)]
        leaves += [st0.clone().requires_grad_()] if init else []
        y, fs = ssd_scan_ref(*leaves[:5], block_q=256, initial_state=leaves[5] if init else None)
        auto = torch.autograd.grad([y, fs] if init else [y], leaves, [dy, dst] if init else [dy])
        torch.cuda.synchronize()
        names = ("dx", "ddt", "dA", "dB", "dC", "dinit")
        errs = {}
        for label, ref_out in (("plain", want), ("autograd", auto)):
            for name, o, w in zip(names, got, ref_out):
                scale = w.float().abs().max().item()
                err = (o.float() - w.float()).abs().max().item()
                errs[(label, name)] = err / max(scale, 1e-30)
                if not torch.isfinite(o).all() or err > tol * scale:
                    raise AssertionError(f"ssd_scan_bwd {desc} {dtype} {name} against {label}: max abs "
                                         f"err {err:.3e} past {tol} x max|leaf| {scale:.3e}")
        for fn in (kernel, kernel, standalone):
            again = fn()
            if not all(torch.equal(u, v) for u, v in zip(got, again)):
                raise AssertionError(f"ssd_scan_bwd {desc} {dtype}: two calls on the same inputs differ")
        worst = {label: max(v for (lb, _), v in errs.items() if lb == label) for label in ("plain", "autograd")}
        if dtype == bf and worst["plain"] > 1e-2:  # the aim within the tolerance
            raise AssertionError(f"ssd_scan_bwd {desc} bf16: worst err / max|leaf| "
                                 f"{worst['plain']:.3e} past 1e-2")
        log(f"[2] ssd_scan_bwd {desc:32s} {str(dtype).replace('torch.', ''):9s} max err / max|leaf| "
            f"against the plain backward {worst['plain']:.3e}, autograd of the plain forward "
            f"{worst['autograd']:.3e} (tol {tol}); bit-equal on repeat and to the standalone call; "
            f"scratch MB main path {scratch_mb(main_scratch):.1f}, standalone "
            f"{scratch_mb(alone_scratch):.1f}")
        if not timed:
            return None
        es = esize(dtype)
        nbytes = (3 * b * s * h * p + 4 * b * s * g * n) * es + 2 * 4 * b * s * h + 2 * 4 * h \
            + (3 * 4 * b * h * p * n if init else 0)
        nops = 8 * b * s * h * p * n
        seen = []
        rec = {"ms": device_ms(kernel, names=seen), "standalone_ms": device_ms(standalone),
               "plain_ms": device_ms(plain), "library_ms": None,
               "call_ms": time_ms(kernel), "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
               "ops_ms": nops / PEAK_OPS[str(dtype).replace("torch.", "")] * 1e3}
        rec["bound_ms"] = max(rec["bytes_ms"], rec["ops_ms"])
        rec["bound_by"] = "bytes" if rec["bytes_ms"] >= rec["ops_ms"] else "operations"
        rec.update(max_abs_err=max((o.float() - w.float()).abs().max().item() for o, w in zip(got, want)),
                   tol=tol, shape=desc, dtype=str(dtype).replace("torch.", ""), kernels=sorted(set(seen)))
        # each of the call's kernels, device ms per call, on both routes
        for route, fn in (("main path", kernel), ("standalone", standalone)):
            calls = {}
            dev_us, _ = profiled(fn, 20, calls=calls)
            split_ms = {(short_kernel_names({k: us}) or [k[:60]])[0]: round(us / 20 / 1e3, 5)
                        for k, us in dev_us.items()}
            check_ssd_bwd_profile(dev_us, f"[2] ssd_scan_bwd {desc} {route}", calls=calls,
                                  standalone=route == "standalone")
            log(f"[2] ssd_scan_bwd {desc} {rec['dtype']} {route}: device ms per call by kernel "
                f"{json.dumps(split_ms)}")
        log(f"[2] ssd_scan_bwd {desc} {rec['dtype']}: kernel_ms {rec['ms']:.4f} (main path; call "
            f"{rec['call_ms']:.4f}) standalone_ms {rec['standalone_ms']:.4f} plain_ms "
            f"{rec['plain_ms']:.4f} bound_ms {rec['bound_ms']:.4f} ({rec['bound_by']})")
        return rec

    # the training shapes (2 x 2048 tokens) of mamba2-130m and zamba2-1.2b,
    # a ragged last chunk and P tile, two and eight groups, N % 4 != 0, and P
    # = 128, N = 256 in 8 groups with an initial state and a final-state
    # gradient
    results["ssd_scan_bwd"] = check_ssd_bwd(TRAIN_BATCH, TRAIN_SEQ, 24, 64, 1, 128, bf, 2e-2, timed=True)
    ssd_bwd_f32 = check_ssd_bwd(TRAIN_BATCH, TRAIN_SEQ, 24, 64, 1, 128, f32, 1e-4, timed=True)
    ssd_bwd_zamba2 = check_ssd_bwd(TRAIN_BATCH, TRAIN_SEQ, 64, 64, 1, 64, bf, 2e-2, timed=True)
    ssd_bwd_zamba2_f32 = check_ssd_bwd(TRAIN_BATCH, TRAIN_SEQ, 64, 64, 1, 64, f32, 1e-4, timed=True)
    for dtype, tol in ((bf, 2e-2), (f32, 1e-4)):
        check_ssd_bwd(1, 333, 24, 40, 1, 128, dtype, tol)
        check_ssd_bwd(2, 200, 8, 32, 2, 32, dtype, tol)
        check_ssd_bwd(1, 130, 16, 64, 8, 30, dtype, tol, init=True)
        check_ssd_bwd(1, TRAIN_SEQ, 16, 128, 8, 256, dtype, tol, init=True)

    # ---- 3. serve at full width -------------------------------------------
    def serve_full_width(tag, cfg, rng, implied):
        """Serve N_REQUESTS requests of 64-700 prompt tokens (the first 700),
        MAX_NEW new tokens each, EDF deadlines, through ``BatchServer`` at
        full width from random weights (bf16 compute). Every counter is
        zeroed just before the run and read just after: each forward kernel
        must show at least ``implied(forwards)[name]`` launches (none where
        that is 0), and no backward, quorum or int8 kernel may run. Then one
        700-token prefill and one decode step under torch.profiler. Returns
        the forward kernels' launches and the f32 parameters."""
        # earlier phases leave device tensors in reference cycles (the grid
        # trainer's store): free them, so that the peak memory is this run's
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        params = init_params(gen, model_spec(cfg), device=dev)  # f32
        server = BatchServer(cfg, params, batch_slots=SLOTS, max_seq=MAX_SEQ)
        torch.cuda.synchronize()
        log(f"[{tag}] params {cfg.param_count()} ({time.perf_counter() - t:.2f} s to init and cast); "
            f"memory allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
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
        run_counts = counts()
        launches = {name: run_counts[name] for name in fwd_ops}
        stray = {k: v for k, v in run_counts.items() if k not in fwd_ops and v}
        if stray:
            raise AssertionError(f"serving launched a backward, quorum or int8 kernel: {stray}")
        log(f"[{tag}] prompt lengths {prompt_lens}; launches {json.dumps(launches)}")
        assert m.requests_done == N_REQUESTS, m
        assert m.tokens_generated == N_REQUESTS * (MAX_NEW - 1), m
        for r in reqs:
            assert len(r.tokens_out) == MAX_NEW and all(0 <= t < cfg.vocab for t in r.tokens_out), r.id
        forwards = N_REQUESTS + m.decode_steps
        for name, want in implied(forwards).items():
            if launches[name] < want or (want == 0 and launches[name]):
                raise AssertionError(f"{name}: {launches[name]} launches on the serving path, "
                                     f"the path implies {'none' if want == 0 else f'at least {want}'}")
        log(f"[{tag}] requests_done {m.requests_done} tokens_generated {m.tokens_generated} "
            f"decode_steps {m.decode_steps} wall_s {m.wall_time:.3f}")
        log(f"[{tag}] prefill_ms_per_request {m.prefill_time / N_REQUESTS * 1e3:.3f} "
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
            dev_us, _ = profile_breakdown(step, f"[{tag}] {label}", top=8)
            # bf16 attention runs the tensor-core flash kernel; no scalar one
            check_flash_profile(dev_us, MMA_FLASH[:1] if label.startswith("prefill") and
                                implied(1)["flash_attention"] else (), f"[{tag}] {label}")
            # an SSM prefill runs the three ssd_scan kernels; none the old one
            check_ssd_profile(dev_us, label.startswith("prefill") and implied(1)["ssd_scan"] > 0,
                              f"[{tag}] {label}")
        del server, one, batch_cache
        torch.cuda.empty_cache()
        return launches, params

    def logits_card_vs_cpu(tag, cfg32, params, prompt, tol, kernels):
        """The card's f32 prefill logits of ``prompt`` (through the kernels,
        each of ``kernels`` launched) against the port's CPU forward (plain
        versions) from the same parameters: max abs error within ``tol`` and
        the same argmax."""
        step32 = make_prefill_step(cfg32)
        before = counts()
        n = len(prompt)
        gpu_logits, _ = step32(params, {"tokens": prompt[None].to(dev)}, init_cache(cfg32, 1, n))
        torch.cuda.synchronize()
        after = counts()
        skipped = [k for k in kernels if after[k] <= before[k]]
        if skipped:
            raise AssertionError(f"the f32 prefill skipped {skipped}")
        cpu_params = tree_map(lambda t: t.cpu(), params)
        cpu_logits, _ = step32(cpu_params, {"tokens": prompt[None]}, init_cache(cfg32, 1, n, "cpu"))
        g, c = gpu_logits[0, -1, : cfg32.vocab].cpu(), cpu_logits[0, -1, : cfg32.vocab]
        assert torch.isfinite(g).all() and g.shape == (cfg32.vocab,)
        err = (g - c).abs().max().item()
        log(f"[{tag}] {cfg32.name} ({cfg32.n_layers} layers) f32 prefill logits, card vs CPU: max abs "
            f"err {err:.3e} (tol {tol}, |logit| max {c.abs().max().item():.3f}); argmax card "
            f"{int(g.argmax())} cpu {int(c.argmax())}")
        if err > tol or int(g.argmax()) != int(c.argmax()):
            raise AssertionError(f"{cfg32.name}: f32 logits card vs CPU differ by {err}")

    log(f"[3] {cfg.name}: {L} layers, d={d}, {H} heads / {KV} kv heads, head_dim {hd}, "
        f"d_ff {ff}, vocab {cfg.vocab} (padded {cfg.padded_vocab}), compute {cfg.dtype}")
    rng = np.random.default_rng(SEED)
    launches, params = serve_full_width(
        "3", cfg, rng, lambda f: {"rmsnorm": (4 * L + 1) * f, "swiglu": L * f,
                                  "flash_attention": L * N_REQUESTS, "ssd_scan": 0})

    # ---- 4. card (kernels) against CPU (plain versions), f32 ---------------
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, size=64), dtype=torch.long)
    # 28 f32 layers, summed in other orders on the card and the CPU
    logits_card_vs_cpu("4", cfg.scaled(dtype=torch.float32), params, prompt, 1e-3, list(ops))
    del params
    torch.cuda.empty_cache()

    # ---- 5. train through the volunteer grid at full width -----------------
    # one grad job's device time by kernel group
    groups = {
        "flash_bwd": lambda k: "flash_bwd" in k,
        "flash_fwd": lambda k: "flash_fwd" in k,
        "cuBLAS": lambda k: any(s in k.lower() for s in ("gemm", "nvjet", "cutlass", "xmma", "sm90_")),
        "rmsnorm": lambda k: "rmsnorm" in k,
        "swiglu": lambda k: "swiglu" in k,
        "ssd_scan_bwd": lambda k: any(b in k for b in SSD_BWD_KERNELS),
        "ssd_scan": lambda k: any(f in k for f in SSD_KERNELS),
    }

    def job_profile(tag, fn, top=14):
        """One grad job under torch.profiler: wall, busy, idle share, the top
        kernels, the shares of ``groups`` and the job's peak memory; returns
        the per-kernel device microseconds and launches, and the ssd_scan
        forward calls the launch counter saw meanwhile."""
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        calls = {}
        forwards = ssd_ops.launches
        dev_us, job_wall = profile_breakdown(fn, f"[{tag}] grad job", top=top, calls=calls)
        torch.cuda.synchronize()
        forwards = ssd_ops.launches - forwards
        peak = torch.cuda.max_memory_allocated() / 2**30
        busy = sum(dev_us.values())
        if busy:
            shares = {g: sum(us for k, us in dev_us.items() if f(k)) / busy for g, f in groups.items()}
            shares["other"] = 1.0 - sum(shares.values())
            log(f"[{tag}] grad job device shares {json.dumps({k: round(v, 4) for k, v in shares.items()})} "
                f"(busy {busy / 1e3:.2f} ms of {job_wall:.2f} ms wall, idle share "
                f"{max(0.0, 1 - busy / 1e3 / job_wall):.3f}; ssd_scan backward "
                f"{sum(us for k, us in dev_us.items() if groups['ssd_scan_bwd'](k)) / 1e3:.2f} ms); "
                f"peak_mem_gib {peak:.2f}")
        else:
            log(f"[{tag}] grad job peak_mem_gib {peak:.2f}")
        return dev_us, calls, forwards

    def grid_train(tag, cfg, required, idle_kernels):
        """Train ``cfg`` at full width through ``GridTrainer``: TRAIN_STEPS
        steps of TRAIN_SHARDS shards x TRAIN_BATCH x TRAIN_SEQ tokens, 8
        hosts, 5% erroneous, 15% malicious. Every counter is zeroed just
        before and read just after: each of ``required`` must be non-zero,
        each of ``idle_kernels`` zero; no wrong gradient may be accepted.
        Then one grad job under torch.profiler. Returns the run's launches
        and ``job_profile``'s result for the profiled job."""
        reset_ids()
        data_cfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ, batch_size=TRAIN_BATCH,
                              n_shards=TRAIN_SHARDS, seed=SEED)
        t = time.perf_counter()
        trainer = GridTrainer(cfg, data_cfg,
                              AdamWConfig(lr=1e-4, warmup_steps=1, total_steps=TRAIN_STEPS),
                              n_steps=TRAIN_STEPS, n_hosts=8, seed=SEED, error_prob=0.05,
                              malicious_fraction=0.15, availability=0.9)
        torch.cuda.synchronize()
        log(f"[{tag}] GridTrainer {cfg.name} (remat={cfg.remat}, compute {cfg.dtype}), {TRAIN_STEPS} steps "
            f"x {TRAIN_SHARDS} shards x ({TRAIN_BATCH} x {TRAIN_SEQ}) tokens, 8 hosts; set up in "
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
        log(f"[{tag}] losses {r.losses} steps_completed {r.steps_completed} jobs_retried "
            f"{r.jobs_retried} virtual_time {r.virtual_time}")
        log(f"[{tag}] SimMetrics wrong_accepted {sm.wrong_accepted} replication_overhead "
            f"{sm.replication_overhead:.3f} instances_executed {sm.instances_executed}; "
            f"host credit {credit:.4e} cobblestones")
        log(f"[{tag}] grad jobs computed {len(trainer.job_seconds)}, wall s each "
            f"{[round(x, 3) for x in trainer.job_seconds]}; run wall {train_wall:.2f} s; "
            f"peak_mem_gib {torch.cuda.max_memory_allocated() / 2**30:.2f}")
        log(f"[{tag}] launches {json.dumps(train_launches)}")
        if r.steps_completed < TRAIN_STEPS:
            raise AssertionError(f"grid trainer completed {r.steps_completed} of {TRAIN_STEPS} steps")
        if not all(math.isfinite(x) for x in r.losses):
            raise AssertionError(f"non-finite loss: {r.losses}")
        if sm.wrong_accepted:
            raise AssertionError(f"the grid accepted {sm.wrong_accepted} wrong gradients")
        idle = [k for k in required if train_launches[k] == 0]
        stray = {k: train_launches[k] for k in idle_kernels if train_launches[k]}
        if idle or stray:
            raise AssertionError(f"training path: kernels never launched {idle}, launched where none "
                                 f"should be {stray}")

        # where the device time of one grad job goes
        batch_np = make_batch(data_cfg, 0, 0)
        batch = {k: torch.from_numpy(v.astype(np.int64)).to(dev) for k, v in batch_np.items()}
        grad_step = make_grad_step(cfg)
        job = job_profile(tag, lambda: grad_step(trainer.params, batch))
        del trainer, grad_step, batch
        gc.collect()
        torch.cuda.empty_cache()
        return train_launches, job

    train_launches, (dev_us, _, _) = grid_train("5", cfg, (*ops, *bwd_ops, "quorum_compare"),
                                           ("ssd_scan", "ssd_scan_bwd", *WIDE))
    check_flash_profile(dev_us, MMA_FLASH, "[5] grad job")

    # ---- 6. card (kernels) against CPU (plain versions): one f32 grad step --
    def grad_card_vs_cpu(tag, cfg32, required_bwd, seed, leaf_rtol=1e-3, leaf_atol=1e-4):
        """One f32 grad step of ``cfg32`` on 1 x 256 tokens on the card
        (each of ``required_bwd`` launched) against the CPU's from the same
        parameters: the loss to 1e-4 and per leaf |card - cpu| <= 1e-3 |cpu|
        + leaf_atol max|cpu| with leaf_rtol = 1e-3. Returns the step's launches."""
        p32 = init_params(torch.Generator(device=dev).manual_seed(seed), model_spec(cfg32), device=dev)
        toks = rng.integers(0, cfg32.vocab, size=(1, 257))
        b32 = {"tokens": torch.as_tensor(toks[:, :-1]), "labels": torch.as_tensor(toks[:, 1:])}
        step32 = make_grad_step(cfg32)
        before = counts()
        g_card, m_card = step32(p32, {k: v.to(dev) for k, v in b32.items()})
        torch.cuda.synchronize()
        after = counts()
        if any(after[k] <= before[k] for k in required_bwd):
            raise AssertionError(f"the f32 grad step of {cfg32.name} skipped a backward kernel: "
                                 f"{[k for k in required_bwd if after[k] <= before[k]]}")
        step_launches = {k: after[k] - before[k] for k in after}
        g_cpu, m_cpu = step32(tree_map(lambda x: x.cpu(), p32), b32)
        loss_err = abs(float(m_card["loss"]) - float(m_cpu["loss"]))
        # per leaf: |card - cpu| <= leaf_rtol |cpu| + leaf_atol max|cpu| (f32 sums over
        # 256 tokens and up to 152064 vocabulary rows, in other orders on the two)
        worst, bad = 0.0, []
        for path_leaf, (g_leaf, gp) in enumerate(zip(tree_leaves(g_card), tree_leaves(g_cpu))):
            g_leaf = g_leaf.cpu()
            err = (g_leaf - gp).abs()
            lim = leaf_rtol * gp.abs() + leaf_atol * gp.abs().max()
            if not torch.isfinite(g_leaf).all() or (err > lim).any():
                bad.append(path_leaf)
            worst = max(worst, (err.max() / gp.abs().max().clamp(min=1e-30)).item())
            log(f"[{tag}] grad leaf {path_leaf} {str(tuple(gp.shape)):24s} max abs err "
                f"{err.max().item():.3e} (max |g| {gp.abs().max().item():.3e})")
        if bad:
            raise AssertionError(f"{cfg32.name} grad leaves {bad}: past {leaf_rtol}|x| + {leaf_atol} max|x|")
        log(f"[{tag}] {cfg32.name} ({cfg32.n_layers} layers) f32 loss card {float(m_card['loss']):.6f} cpu "
            f"{float(m_cpu['loss']):.6f} abs err {loss_err:.3e} (tol 1e-4); worst leaf err / max|g| "
            f"{worst:.3e}")
        if loss_err > 1e-4:
            raise AssertionError(f"{cfg32.name} f32 loss card vs cpu: {loss_err}")
        del p32, g_card, g_cpu
        torch.cuda.empty_cache()
        return step_launches

    # the scalar flash kernels' runs
    f32_launches = grad_card_vs_cpu("6", cfg.scaled(n_layers=2, dtype=torch.float32),
                                    ("rmsnorm_bwd", "swiglu_bwd", "flash_attention_bwd"), SEED + 6)

    # ---- 7. the plain training loop with checkpoint and restart -----------
    def train_loop(tag, cfg, required, idle_kernels):
        """``runtime.train`` of ``cfg`` at full width: LOOP_STEPS steps of
        TRAIN_BATCH x TRAIN_SEQ tokens with a checkpoint at step LOOP_PERIOD
        under ``build/`` (after checking the free disk), then a second call
        that restores it and reruns the next step: its loss must equal the
        first run's. Counters zeroed before the first call and read after
        it: each of ``required`` non-zero, each of ``idle_kernels`` zero.
        Returns the first call's launches."""
        loop_data = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ, batch_size=TRAIN_BATCH, n_shards=1,
                               seed=SEED)
        loop_opt = AdamWConfig(lr=1e-4, warmup_steps=1, total_steps=LOOP_STEPS)
        ckpt_bytes_want = 3 * 4 * cfg.param_count()  # params, mu and nu in f32
        scratch = Path(__file__).resolve().parent / "build"
        free = shutil.disk_usage(scratch).free
        log(f"[{tag}] checkpoint of {ckpt_bytes_want / 1e9:.2f} GB to write under {scratch}; "
            f"{free / 1e9:.2f} GB free")
        if free < ckpt_bytes_want + 2**30:
            raise AssertionError(f"not enough free disk for the phase-{tag} checkpoint: {free} bytes "
                                 f"free, {ckpt_bytes_want} needed and 1 GiB to spare")
        with tempfile.TemporaryDirectory(dir=scratch, prefix="chip_smoke_ckpt_") as ckpt_dir:
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            r1 = train(cfg, loop_data, loop_opt, LOOP_STEPS, seed=SEED, checkpoint_dir=ckpt_dir,
                       checkpoint_period=LOOP_PERIOD, log_every=1, log_fn=log)
            torch.cuda.synchronize()
            loop_launches = counts()
            peak = torch.cuda.max_memory_allocated() / 2**30
            step_dir = os.path.join(ckpt_dir, f"step_{LOOP_PERIOD:010d}")
            ckpt_bytes = sum(os.path.getsize(os.path.join(step_dir, f)) for f in os.listdir(step_dir))
            # where a restore's time goes: the checksums and the npz reads alone
            # (the files are in the page cache, as they are for the restore)
            npz = [os.path.join(step_dir, f) for f in sorted(os.listdir(step_dir)) if f.endswith(".npz")]
            t = time.perf_counter()
            for f in npz:
                checkpoint_sha256(f)
            sha_s = time.perf_counter() - t
            t = time.perf_counter()
            for f in npz:
                with np.load(f) as z:
                    for k in z.files:
                        z[k]
            read_s = time.perf_counter() - t
            r2 = train(cfg, loop_data, loop_opt, LOOP_STEPS, seed=SEED + 1, checkpoint_dir=ckpt_dir,
                       checkpoint_period=LOOP_PERIOD, log_every=1, log_fn=log)
            torch.cuda.synchronize()
            saved = sorted(os.listdir(ckpt_dir))
        log(f"[{tag}] {cfg.name} train {LOOP_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens: losses "
            f"{r1.losses}; step s {[round(x, 4) for x in r1.step_seconds]}; wall {r1.wall_time:.2f} s; "
            f"peak_mem_gib {peak:.2f}")
        log(f"[{tag}] checkpoint at step {LOOP_PERIOD}: {ckpt_bytes} bytes in {saved}; save s "
            f"{[round(x, 3) for x in r1.save_seconds]} ({ckpt_bytes / r1.save_seconds[0] / 1e9:.3f} GB/s); "
            f"restore s {r2.restore_seconds:.3f} ({ckpt_bytes / r2.restore_seconds / 1e9:.3f} GB/s)")
        log(f"[{tag}] of which, measured alone: sha256 of the files {sha_s:.3f} s, reading the npz "
            f"arrays {read_s:.3f} s; the rest of the restore (host to device, templates) "
            f"{r2.restore_seconds - sha_s - read_s:.3f} s, of the save (device to host, np.savez) "
            f"{r1.save_seconds[0] - sha_s:.3f} s")
        log(f"[{tag}] launches {json.dumps(loop_launches)}")
        if saved != [f"step_{LOOP_PERIOD:010d}"] or len(r1.save_seconds) != 1:
            raise AssertionError(f"expected one checkpoint at step {LOOP_PERIOD}: {saved}, "
                                 f"{len(r1.save_seconds)} saves")
        if not all(math.isfinite(x) for x in r1.losses) or len(r1.losses) != LOOP_STEPS:
            raise AssertionError(f"training loop losses: {r1.losses}")
        idle = [k for k in required if loop_launches[k] == 0]
        if idle or any(loop_launches[k] for k in idle_kernels):
            raise AssertionError(f"training-loop launches {loop_launches}: idle {idle}")
        resumed = r2.losses[0] if r2.losses else float("nan")
        bit_equal = resumed == r1.losses[LOOP_PERIOD]
        log(f"[{tag}] resumed from step {r2.restored_from}: step {LOOP_PERIOD + 1} loss {resumed!r}, the "
            f"first run's {r1.losses[LOOP_PERIOD]!r} (rtol 1e-6); bit-equal: {bit_equal}")
        if r2.restored_from != LOOP_PERIOD or len(r2.losses) != LOOP_STEPS - LOOP_PERIOD or \
                not math.isclose(resumed, r1.losses[LOOP_PERIOD], rel_tol=1e-6):
            raise AssertionError(f"resume: restored_from {r2.restored_from}, losses {r2.losses}, "
                                 f"want {r1.losses[LOOP_PERIOD]}")
        del r1, r2
        torch.cuda.empty_cache()
        return loop_launches

    loop_launches = train_loop("7", cfg, (*ops, *bwd_ops),
                               ("quorum_compare", "int8_quantize", "int8_dequantize", *WIDE))
    loop_data = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ, batch_size=TRAIN_BATCH, n_shards=1,
                           seed=SEED)

    # ---- 8. the int8 wire format on the full-width gradient tree -----------
    params = init_params(gen, model_spec(cfg), device=dev)
    batch_np = make_batch(loop_data, 0, 0)
    batch = {k: torch.from_numpy(v.astype(np.int64)).to(dev) for k, v in batch_np.items()}
    grads, _ = make_grad_step(cfg)(params, batch)
    del params, batch
    leaves = tree_leaves(grads)
    n_el = sum(g.numel() for g in leaves)
    torch.cuda.synchronize()
    zero_counts()
    packed = compress_tree(grads)
    out = decompress_tree(packed)
    torch.cuda.synchronize()
    comp_launches = counts()
    log(f"[8] {len(leaves)} gradient leaves, {n_el} elements; launches {json.dumps(comp_launches)}")
    if not comp_launches["int8_quantize"] or not comp_launches["int8_dequantize"]:
        raise AssertionError(f"compression skipped an int8 kernel: {comp_launches}")
    worst = 0.0
    for g, item, o in zip(leaves, packed["payload"], tree_leaves(out)):
        rows2d, br = int8_ops.to_rows(g)
        want_q, want_s = int8_quantize_ref(rows2d, br)
        want_o = int8_dequantize_ref(want_q, want_s, br, g.dtype).reshape(-1)[: g.numel()].reshape(g.shape)
        if not (torch.equal(item["q"], want_q) and torch.equal(item["s"], want_s)
                and torch.equal(o, want_o)):
            raise AssertionError(f"payload of a {tuple(g.shape)} leaf differs from the plain versions'")
        step = g.abs().max() / 127.0
        worst = max(worst, ((g - o).abs().max() / step.clamp(min=1e-30)).item())
        del want_q, want_s, want_o
    wire, f32_bytes = compressed_bytes(packed), 4 * n_el
    tree_bytes = sum(i["q"].numel() * 5 + i["s"].numel() * 4 for i in packed["payload"])
    comp_ms = time_ms(lambda: compress_tree(grads), iters=5, warmup=1)
    decomp_ms = time_ms(lambda: decompress_tree(packed), iters=5, warmup=1)
    enqueue_ms = {}
    for label, fn in (("compress", lambda: compress_tree(grads)),
                      ("decompress", lambda: decompress_tree(packed))):
        # host time to enqueue one call (nothing inside synchronises)
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        enqueue_ms[label] = (time.perf_counter() - t) * 1e3
        torch.cuda.synchronize()
    comp_dev = device_ms(lambda: compress_tree(grads), iters=3)
    decomp_dev = device_ms(lambda: decompress_tree(packed), iters=3)
    log(f"[8] payload and decompressed tree equal the plain versions' bit for bit; worst "
        f"|x - x^| / (leaf amax / 127) {worst:.6f} (limit 1 + 1e-6)")
    log(f"[8] compressed_bytes {wire} against f32 {f32_bytes} ({f32_bytes / wire:.4f}x smaller)")
    comp_q, decomp_q = (queued_event_ms(fn, iters=5) for fn in (lambda: compress_tree(grads),
                                                                  lambda: decompress_tree(packed)))
    log(f"[8] per tree: compress wall {comp_ms:.4f} ms (device {comp_dev:.4f}, queued behind a sleep "
        f"{comp_q:.4f}, host enqueue {enqueue_ms['compress']:.4f}), decompress wall {decomp_ms:.4f} ms "
        f"(device {decomp_dev:.4f}, queued {decomp_q:.4f}, host enqueue {enqueue_ms['decompress']:.4f}); "
        f"bound each {tree_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms (bytes)")
    if worst > 1 + 1e-6:
        raise AssertionError(f"round-trip error {worst} quantization steps")
    del grads, packed, out, leaves
    torch.cuda.empty_cache()

    # ---- 9-10. serve mamba2-130m at full width; f32 logits card vs CPU ----
    mcfg = get_config("mamba2-130m")
    msc = ssm_config(mcfg)
    Lm = mcfg.n_layers
    log(f"[9] {mcfg.name}: {Lm} mamba2 layers, d={mcfg.d_model}, d_inner {msc.d_inner}, "
        f"{msc.n_heads} heads of {msc.head_dim}, state {msc.d_state}, {msc.n_groups} group, "
        f"vocab {mcfg.vocab} (padded {mcfg.padded_vocab}), compute {mcfg.dtype}")
    rng = np.random.default_rng(SEED + 9)
    mamba_launches, params = serve_full_width(
        "9", mcfg, rng, lambda f: {"ssd_scan": Lm * N_REQUESTS, "rmsnorm": (2 * Lm + 1) * f,
                                   "flash_attention": 0, "swiglu": 0})
    prompt = torch.as_tensor(rng.integers(0, mcfg.vocab, size=64), dtype=torch.long)
    logits_card_vs_cpu("10", mcfg.scaled(dtype=torch.float32), params, prompt, 1e-3,
                       ["rmsnorm", "ssd_scan"])
    del params
    torch.cuda.empty_cache()

    # ---- 11-12. serve zamba2-1.2b at full width; f32 logits card vs CPU ----
    zcfg = get_config("zamba2-1.2b")
    zsc = ssm_config(zcfg)
    Lz = zcfg.n_layers
    ng, per, tail = hybrid_layout(zcfg)
    log(f"[11] {zcfg.name}: {Lz} mamba2 layers in {ng} groups of {per} and a tail of {tail}, "
        f"d={zcfg.d_model}, d_inner {zsc.d_inner}, {zsc.n_heads} heads of {zsc.head_dim}, state "
        f"{zsc.d_state}; one shared block after each group: {zcfg.n_heads}/{zcfg.n_kv_heads} heads, "
        f"head_dim {zcfg.resolved_head_dim}, d_ff {zcfg.d_ff}; vocab {zcfg.vocab}, compute {zcfg.dtype}")
    rng = np.random.default_rng(SEED + 11)
    zamba_launches, params = serve_full_width(
        "11", zcfg, rng, lambda f: {"ssd_scan": Lz * N_REQUESTS, "flash_attention": ng * N_REQUESTS,
                                    "swiglu": ng * f, "rmsnorm": (2 * Lz + 2 * ng + 1) * f})
    del params
    torch.cuda.empty_cache()
    # one group and the tail (8 layers) against the CPU
    z8 = zcfg.scaled(n_layers=per + tail, dtype=torch.float32)
    params = init_params(gen, model_spec(z8), device=dev)
    prompt = torch.as_tensor(rng.integers(0, zcfg.vocab, size=64), dtype=torch.long)
    logits_card_vs_cpu("12", z8, params, prompt, 1e-3, list(fwd_ops))
    del params
    torch.cuda.empty_cache()

    # ---- 13. train mamba2-130m through the volunteer grid at full width ----
    ssd_train = ("rmsnorm", "rmsnorm_bwd", "ssd_scan", "ssd_scan_bwd")
    log(f"[13] {mcfg.name} at full width: {Lm} layers, remat={mcfg.remat}")
    mamba_train_launches, (dev_us, calls, forwards) = grid_train(
        "13", mcfg, (*ssd_train, "quorum_compare"),
        ("flash_attention", "flash_attention_bwd", "swiglu", "swiglu_bwd", *WIDE))
    check_ssd_bwd_profile(dev_us, "[13] grad job", calls=calls, forwards=forwards)
    check_ssd_profile(dev_us, True, "[13] grad job")

    # ---- 14. card (kernels) against CPU (plain versions): f32 grad steps ---
    rng = np.random.default_rng(SEED + 14)
    # each leaf to 1e-3 of its largest entry
    grad_card_vs_cpu("14", mcfg.scaled(n_layers=2, dtype=torch.float32), ("rmsnorm_bwd", "ssd_scan_bwd"),
                     SEED + 14, leaf_rtol=0.0, leaf_atol=1e-3)
    grad_card_vs_cpu("14", zcfg.scaled(n_layers=per + tail, dtype=torch.float32),
                     ("rmsnorm_bwd", "swiglu_bwd", "flash_attention_bwd", "ssd_scan_bwd"), SEED + 15,
                     leaf_rtol=0.0, leaf_atol=1e-3)

    # ---- 15. train mamba2-130m through the plain training loop -------------
    mamba_loop_launches = train_loop("15", mcfg, ssd_train,
                                     ("flash_attention", "flash_attention_bwd", "swiglu", "swiglu_bwd",
                                      "quorum_compare", "int8_quantize", "int8_dequantize", *WIDE))

    # ---- 16. one zamba2-1.2b grad job at full width -------------------------
    params = init_params(gen, model_spec(zcfg), device=dev)
    zdata = DataConfig(vocab=zcfg.vocab, seq_len=TRAIN_SEQ, batch_size=TRAIN_BATCH, n_shards=1, seed=SEED)
    batch = {k: torch.from_numpy(v.astype(np.int64)).to(dev) for k, v in make_batch(zdata, 0, 0).items()}
    zgrad = make_grad_step(zcfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t = time.perf_counter()
    zgrads, zm = zgrad(params, batch)
    zloss = float(zm["loss"])
    zjob_s = time.perf_counter() - t
    zamba_train_launches = counts()
    log(f"[16] {zcfg.name} grad job at full width ({Lz} layers, {TRAIN_BATCH} x {TRAIN_SEQ} tokens, "
        f"remat={zcfg.remat}): loss {zloss:.6f}, wall {zjob_s:.3f} s (the first: allocator), peak_mem_gib "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f}; launches {json.dumps(zamba_train_launches)}")
    want16 = ("rmsnorm", "rmsnorm_bwd", "swiglu", "swiglu_bwd", "flash_attention", "flash_attention_bwd",
              "ssd_scan", "ssd_scan_bwd")
    idle16 = [k for k in want16 if zamba_train_launches[k] == 0]
    idle16 += [k for k in WIDE if zamba_train_launches[k]]
    if idle16 or not math.isfinite(zloss) or not all(torch.isfinite(g).all() for g in tree_leaves(zgrads)):
        raise AssertionError(f"zamba2 grad job: kernels never launched or wide-D flash launched "
                             f"{idle16}, loss {zloss}")
    del zgrads
    dev_us, calls, forwards = job_profile("16", lambda: zgrad(params, batch))
    check_ssd_bwd_profile(dev_us, "[16] grad job", calls=calls, forwards=forwards)
    check_flash_profile(dev_us, MMA_FLASH, "[16] grad job")
    del params, batch, zgrad
    gc.collect()
    torch.cuda.empty_cache()

    # ---- result lines ------------------------------------------------------
    replaces = {
        "rmsnorm": "src/repro/kernels/rmsnorm/kernel.py:17",
        "swiglu": "src/repro/kernels/swiglu/kernel.py:12",
        "flash_attention": "src/repro/kernels/flash_attention/kernel.py:30",
        "quorum_compare": "src/repro/kernels/quorum_compare/kernel.py:21",
        "int8_quantize": "src/repro/kernels/int8_quant/kernel.py:19",
        "int8_dequantize": "src/repro/kernels/int8_quant/kernel.py:28",
        "ssd_scan": "src/repro/kernels/ssd_scan/kernel.py:26",
        "ssd_scan_bwd": "src/repro/kernels/ssd_scan/kernel.py:26",
        # no TPU backward kernels: the reference differentiates its jnp
        # functions with XLA; each row names the forward TPU kernel
        "rmsnorm_bwd": "src/repro/kernels/rmsnorm/kernel.py:17",
        "swiglu_bwd": "src/repro/kernels/swiglu/kernel.py:12",
        "flash_attention_bwd": "src/repro/kernels/flash_attention/kernel.py:30",
        # the f32 scalar flash kernels, run by the f32 checks (phases 4, 6, 10, 12)
        "flash_attention_f32": "src/repro/kernels/flash_attention/kernel.py:30",
        "flash_attention_bwd_f32": "src/repro/kernels/flash_attention/kernel.py:30",
        # the wide-D flash kernels (D > 256), both types, run by phase 2 alone
        **{n: "src/repro/kernels/flash_attention/kernel.py:30"
           for n in ("flash_attention_wide", "flash_attention_wide_f32", "flash_attention_bwd_wide",
                     "flash_attention_bwd_wide_f32")},
    }
    sources = {"int8_quantize": "int8_quant", "int8_dequantize": "int8_quant",
               **{n: "flash_attention" for n in replaces if "wide" in n}}
    main_launches = {**train_launches, "int8_quantize": comp_launches["int8_quantize"],
                     "int8_dequantize": comp_launches["int8_dequantize"],
                     "ssd_scan": mamba_launches["ssd_scan"],
                     "ssd_scan_bwd": mamba_train_launches["ssd_scan_bwd"],
                     # f32 rows: the f32 grad step's launches (phase 6)
                     "flash_attention_f32": f32_launches["flash_attention"],
                     "flash_attention_bwd_f32": f32_launches["flash_attention_bwd"],
                     # the wide-D rows: the grid training run's (0; every main path checks 0)
                     **{n: train_launches[n.replace("_f32", "")] for n in replaces if "wide" in n}}
    kernels = []
    for name, rec in results.items():
        base = name.replace("_f32", "")
        row = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{sources.get(name, base.replace('_bwd', ''))}.cu",
            "replaces": replaces[name], "launches": main_launches[name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"], "call_ms": rec["call_ms"], "shape": rec["shape"],
            "dtype": rec["dtype"],
        }
        if base.startswith("flash"):
            row["kernel"] = rec["kernels"]  # mma (bf16) or scalar (f32), as profiled
        if name in ops:
            row["launches_serve"] = launches[name]
        if name in ops or name in bwd_ops:
            row["launches_train_loop"] = loop_launches[name]
        if name.endswith("_f32"):
            row["launches_in"] = "phase 6, the f32 grad step"
        if "wide" in name:
            row["launches_in"] = "phase 5; every main path (phases 3, 5, 7, 9, 11, 13, 15, 16) launched none"
        if name == "ssd_scan":
            row["launches_serve"] = mamba_launches[name]
            row["launches_serve_zamba2"] = zamba_launches[name]
            row["launches_train"] = mamba_train_launches[name]
            row["launches_train_loop"] = mamba_loop_launches[name]
            row["launches_train_zamba2"] = zamba_train_launches[name]
        if name == "ssd_scan_bwd":
            # launches: the mamba2 grid run's (phase 13)
            row["launches_train_loop"] = mamba_loop_launches[name]
            row["launches_train_zamba2"] = zamba_train_launches[name]
            row["standalone_ms"] = rec["standalone_ms"]
            row["f32"] = {k: ssd_bwd_f32[k] for k in ("ms", "standalone_ms", "plain_ms", "bound_ms",
                                                      "bound_by")}
            row["zamba2"] = {k: ssd_bwd_zamba2[k] for k in ("shape", "ms", "standalone_ms", "plain_ms",
                                                            "bound_ms", "bound_by", "max_abs_err")}
            row["zamba2_f32"] = {k: ssd_bwd_zamba2_f32[k] for k in ("ms", "standalone_ms", "plain_ms",
                                                                    "bound_ms", "bound_by")}
        kernels.append(row)
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
