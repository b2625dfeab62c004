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
   must give the same bits. The frontends' shapes have rows of their own:
   hubert-xlarge's encoder over 4 x 1500 frames (rmsnorm at (6000, 1280)
   and swiglu at (6000, 5120), forward and backward; flash without the
   causal mask at (4, 1500, 16/16, 80), D = 80 padded to 128 and a ragged
   last key tile, forward and backward) and pixtral-12b's 700-position
   prefill (rmsnorm (700, 5120), swiglu (700, 14336), flash (1, 700,
   32/8, 128) causal). quorum_compare
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
17-21. Serve the rest of the decoder zoo at full width with phase 3's
    traffic, each model's f32 tree dropped once the server holds its bf16
    copy: phi4-mini-3.8b (all 32 layers), command-r-plus-104b (2 of 64:
    d = 12288, d_ff = 33792), qwen3-moe-235b-a22b (2 of 94: 128 experts
    top-8, qk-norm), llama4-scout-17b-a16e (2 of 48: 16 experts top-1 and a
    shared expert) and minicpm3-4b (all 62: MLA, its attention at D = 96);
    counters zeroed before and read after: rmsnorm, swiglu (exactly one
    launch a layer a forward, two for llama4: every MoE launch is on the
    expert buffer) and flash (every minicpm3 launch at D = 96) launched, no
    ssd_scan and no wide-D flash kernel. Each: serving numbers and the
    profiles of phase 3, then its f32 prefill logits on the card against
    the CPU at 2 layers (phi4, minicpm3) or 1 (the others). Phase 19 also
    prints the MoE capacity of a prefill and of a decode step.
22. The f32 grad step of phase 6, card against CPU, for the qwen3-moe,
    llama4 and minicpm3 smoke configs (1 x 256 tokens), and each one's bf16
    grad step (2 x 256 tokens) repeated: the same bits.
23. The remat policies: a bf16 grad step (2 x 2048 tokens, remat on) of
    qwen3-0.6b at full width with 2 layers and with all 28, and of the
    qwen3-moe smoke config
    under "nothing", "dots_nb" and "dots": the same bits under all three,
    and each one's peak memory above the parameters and busy time.
24. hubert-xlarge (audio, encoder-only) at full width, all 48 layers:
    ``make_encoder_step`` over ``frame_embeddings`` of four 30 s clips
    (4 x 1500 frames, d = 1280), counters exact (flash 48, all non-causal
    at D = 80; rmsnorm 97; swiglu 48; nothing else) and profiled; its f32
    logits on the card against the CPU at 2 layers over 150 frames (1e-3,
    the same argmax at every frame); a ``GridTrainer`` run with phase 5's
    settings on 2 shards of 2 x 1500 frames (remat on; the forward and
    backward kernels and quorum_compare launched, 0 wrong accepted), one
    grad job profiled; the f32 grad step of the smoke config from
    embeddings, card against CPU, as phase 6.
25. pixtral-12b (vlm) at full width, all 40 layers, the server taking the
    f32 tree leaf by leaf: ``BatchServer`` on phase 3's traffic from token
    prompts (rmsnorm and swiglu counted exactly); then, on the server's
    bf16 parameters, a ``make_prefill_step`` over ``patch_embeddings`` of
    shape (1, 700, 5120) and 32 greedy ``make_decode_step`` steps from its
    token (flash 40, the prefill's; rmsnorm and swiglu exact), the prefill
    and a decode step profiled (busy time, idle share) and the peak memory;
    then its f32 prefill logits from 64 patch embeddings on the card against
    the CPU at 2 layers (1e-3, the same argmax).
26. The BOINC engines on the card: the middleware's engines on
    ``backend="torch", device="cuda"`` against the NumPy engines, bit for
    bit. (1) Each pass alone at fleet scale, with the wall time of a call
    on each backend and the torch call's device busy time and idle share:
    ``BatchDispatchEngine`` scoring and eligibility over a full 1024-slot
    feeder cache for 200 requests from a 10 000-host population (hosts
    available 35-100% of the time, so the scaled runtimes are real
    divisions), then 2048 requests dispatched through ``rpc_batch``;
    ``BatchClientEngine.wrr_batch``, ``schedule_batch`` and
    ``needs_work_batch`` on a 10 000-host feature-dense fleet;
    ``HostArrays.advance_batch`` and ``completed_rows_batch`` on 10 000
    hosts over five passes, a mutation of every ``_touch`` kind between
    them, the card's column mirror equal to the host arrays after each.
    (2) Whole ``run_spec`` runs, numpy against torch, identical by
    ``assert_results_identical(..., job_states=True)``:
    ``clique_half_fleet_defended``, ``blackout_half`` and ``cpu_gpu_mix``
    at their test sizes and ``adversarial_10k`` (3000 jobs, churn, epoch 60,
    half a virtual day; cut to 2500 hosts, a quarter of its fleet, with a
    250-host clique and 100 credit farmers, its adversaries in proportion),
    with both walls. (3) A
    ``quorum_compare`` row at the digest's shape, (4096,) x 2 f32 (the pairwise kernel, which the
    digests no longer call); then a 1000-host, 2000-job run whose jobs
    return 4096-element f64 vectors (``executor``; corruptions add one
    uniform draw in [1, 2) to every element, ``corruptor``; 5% erroneous
    and 10% malicious hosts, no clique), both quorum counters zeroed
    before the torch run: after it the pairwise ``launches`` must be 0 and
    ``launches_pairs`` the number of digest panels (one a digest call),
    the run identical to NumPy's with job states (digest calls, rows a
    call, both walls; not profiled: a profile of its million launches
    costs some 45 s of the script's time limit). (4) The pair-count kernel bit-equal to its plain version at
    (2, 4096), at the payload run's largest digest, at twice that plus 3
    rows (also as two panels, and the group codes of a two-panel
    ``quorum_group_codes`` equal to one panel's) and at (n,
    4097) one element into its buffer (unaligned rows), each in f32 and
    bf16; 16 of its counts equal to the pairwise kernel's; its row
    ``quorum_pair_counts`` timed at the payload run's largest digest, the
    library time that of ``~isclose`` over the (n, n, d) broadcast.
27. The scheduler service on the card: ``SchedulerService`` over
    ``ProjectServer(engine_backend="torch", engine_device="cuda")`` on
    ``benchmarks/bench_rpc.py``'s §5.1 deployment (2048 hosts over three
    OSes, 20 000 jobs of min_quorum 1, a 384-slot feeder cache, four
    shard-affine scheduler instances, vectorized dispatch), built in the
    script, once on NumPy and once on torch from the same ids. (1) 2048
    WORK frames, one per host, pipelined over one connection a wave (1024
    frames) at a time, coalesced and per request, with no refill between
    waves: the reply frames equal, byte for byte and in order, the NumPy
    project's sequential ``rpc`` calls encoded with ``reply_to_wire``.
    (2) ``run_load`` with 10 000 clients over 64 connections (bench_rpc's
    treatment traffic) on torch, then again under torch.profiler (device
    busy time, idle share), then on NumPy: every request answered, no
    error, jobs received, no instance dispatched twice; RPC/s, p50/p95/p99
    latency, waves and per-shard utilization. (3) PING, STATS, a malformed
    and an over-long frame on a raw socket: the reference's reply codes,
    the connection dropped after ``too-long``. (4) A ``done=`` report for an
    instance dispatched in (1): the reply and the instance equal the NumPy
    project's fed the same frame. Every kernel counter is zeroed before (1)
    and must read 0 after (4): the service path launches no kernel of the
    port. The phase prints its wall against a 90 s budget.
28. The dry run and the roofline on the card's machine (a 120 s budget,
    its wall printed): ``python -m repro_torch.launch.dryrun --all`` in a
    subprocess (6 processes) lowers every (arch x shape) cell at full width
    on the meta device; each must be ``ok`` or ``skipped`` exactly where
    ``cell_supported`` says, and the roofline table is printed with
    ``fits``. Then qwen3-0.6b train (2 x 2048), hubert-xlarge prefill (the
    encoder, 4 x 1500 frames), mamba2-130m train (2 x 2048) and qwen3-0.6b
    decode (4 sequences, a 1024 context), reduced ``ShapeConfig``s, run
    through ``build_step(..., single_device_mesh())`` on the card in bf16
    from seeded random weights: ``count_costs`` over the real step must
    give the meta run's FLOPs and bytes exactly (else the op census of both
    is printed where they differ), and the launch counters must move as the
    counted kernel calls (flash forward and backward, rmsnorm, swiglu and
    ssd_scan forward and backward each launched by some cell); each cell's
    busy time and idle share (torch.profiler) beside the roofline's step
    time, MFU (model FLOPs over 989.4 TFLOP/s) over the busy time and over
    the wall, and the peak memory above the arguments against the
    predicted temp bytes. Last, ``perf_iter`` on qwen3-0.6b's train cell
    (2 x 2048) under remat "nothing" and "dots": more FLOPs and fewer bytes
    a device (arguments + outputs - aliased + temp, as the reference
    counts them) for "nothing", printed beside phase 23's measured peaks.
29. The sharded train step (a budget of ``SHARDED_BUDGET_S``, its wall
    printed): qwen3-0.6b at full width and depth (28 layers) in f32,
    ``build_step`` over a (4, 2) ("data", "model") mesh whose 8 ranks are
    simulated in this one process on the one card (``simulated_ranks``: a
    ``fake`` process group under ``LocalTensorMode``), 8 sequences of 128
    tokens. Params, AdamW moments and batch sit on the sharding rules'
    placements; the model's constraints redistribute its activations;
    rmsnorm, swiglu and flash attention, forward and backward, run on each
    rank's local shards: counters zeroed just before and read just after,
    each exactly 8 launches (one a rank) a call of the unsharded step
    (rmsnorm 4 x 28 + 1, swiglu and flash 28). Its loss against the
    unsharded step's on the card from the same parameters to 1e-4 (relative),
    every AdamW first moment to 1e-3 of its leaf's largest entry, and every
    parameter's update (p - p0, sharded against unsharded) to 0.1 x the
    first step's learning rate lr beyond the part the two gradients explain:
    AdamW's first update is -lr * (g / (|g| + eps) + wd * p), about lr in
    size on every element, so a step that skips it or flips its sign fails;
    the gradients explain lr * |s(g8) - s(g1)| of the difference,
    s(g) = g / (|g| + eps) (g = mu / (1 - b1)), which is up to 2 x lr only
    where a gradient is rounding noise near 0 or near eps; busy
    time, idle share, wall and peak memory (torch.profiler, device activity
    only), beside the card's name and power limit.
Every main path (phases 3, 5, 7, 9, 11, 13, 15, 16, 17-21, 24, 25, 29) must
launch no wide-D flash kernel. Phases 24-29 print their walls.

The line before the last is one JSON object ``{"kernels": [...]}`` with the
numbers of this run (``launches``: the counts of the grid training run
(phase 5) for the forward, backward and quorum kernels and of the
compression run (phase 8) for the int8 kernels and of the mamba2 serving
run (phase 9) for ssd_scan and of the f32 grad step (phase 6) for the f32
flash rows ``flash_attention_f32`` and ``flash_attention_bwd_f32``;
``launches_serve`` and ``launches_train_loop``, the serving run's and the
training loop's, where the kernel runs there, ``launches_serve_zoo`` phases
17-21's; the rows ``flash_attention_mla`` (D = 96) and ``swiglu_moe`` (the
expert buffer) phase 21's and 19's launches; and for ssd_scan
``launches_serve_zamba2``, phase 11's, and ``launches_train``,
``launches_train_loop`` and ``launches_train_zamba2``, phases 13, 15 and
16's; ``ssd_scan_bwd``'s ``launches`` are phase 13's, and its row carries
its standalone time and its f32 and zamba2-shape times; the wide-D flash
rows' are phase 5's, 0; ``kernel`` on the flash rows); the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
The rows ``*_hubert`` take their launches from phase 24's grid run (and,
forward, ``launches_encoder`` from its encoder step), ``*_pixtral`` from
phase 25's serving run (and ``launches_vlm_path``). ``quorum_compare``
also carries ``launches_engines``, the payload run's launches (phase 26),
which are the ``launches`` of the row ``quorum_compare_digest`` (the
digest's shape): 0, since the digests go through the pair-count kernel,
whose row ``quorum_pair_counts`` takes its launches from that run. The
rmsnorm, swiglu and flash rows, forward and backward, also carry
``launches_sharded``: phase 29's, on the simulated ranks' local shards.
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
# hubert-xlarge's input: 30 s clips of 20 ms frames; the encoder takes four
HUBERT_FRAMES = 1500
HUBERT_CLIPS = 4


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


# ---- phase 26: the BOINC engines on the card ---------------------------------
# the middle population of benchmarks/bench_dispatch.py; the feeder cache is
# the scheduler's default (1024 slots)
ENGINE_HOSTS = 10_000
N_SCORE = 200  # candidate scorings held bit for bit, per backend
N_DISPATCH = 2048  # dispatched requests, in chunks of 256 (bench_dispatch's batch path)
DISPATCH_CHUNK = 256
# tensor payloads through the validation engine
PAYLOAD_HOSTS = 1000
PAYLOAD_JOBS = 2000
PAYLOAD_LEN = 4096


def engine_fleet(cl, n, seed, max_jobs=12, allow_inf=True):
    """A feature-dense random client population over the classes of the
    port's ``core.client`` (``cl``): heterogeneous resources, two projects
    with unequal shares and debited balances, mixed job states, RAM-heavy
    working sets, GPU jobs, non-CPU-intensive jobs and jobs with
    est_flops == 0 (infinite remaining); the builder of the repo's client
    engine tests, repeated here."""
    import random

    CPU, GPU = cl.ResourceType.CPU, cl.ResourceType.GPU
    rng = random.Random(seed)
    clients = []
    for h in range(n):
        res = {CPU: cl.ClientResource(CPU, rng.choice([1, 2, 4, 8]), rng.uniform(1e9, 4e10))}
        if rng.random() < 0.4:
            res[GPU] = cl.ClientResource(GPU, rng.choice([1, 2]), 1e12)
        c = cl.Client(host_id=h + 1, resources=res,
                      prefs=cl.ClientPrefs(buffer_lo_days=rng.choice([0.02, 0.1]),
                                           buffer_hi_days=rng.choice([0.1, 0.5])),
                      ram_bytes=rng.choice([1e9, 4e9, 8e9]))
        c.attach(cl.ProjectAttachment(name="p", resource_share=100.0))
        if rng.random() < 0.5:
            c.attach(cl.ProjectAttachment(name="q", resource_share=rng.choice([50.0, 300.0])))
            if rng.random() < 0.5:
                c.rec.debit("p", rng.uniform(0, 1e5), 0.0)
        flops_choices = [1e9, 2e10] + ([0.0] if allow_inf else [])
        for i in range(rng.randrange(0, max_jobs)):
            usage = {CPU: rng.choice([0.5, 1.0, 2.0])}
            if GPU in res and rng.random() < 0.4:
                usage[GPU] = 1.0
            proj = "q" if ("q" in c.projects and rng.random() < 0.5) else "p"
            c.jobs.append(cl.ClientJob(
                instance_id=h * 1000 + i, job_id=h * 1000 + i, project=proj, app_name="a",
                usage=usage, est_flops=rng.choice(flops_choices),
                est_flop_count=rng.uniform(1e11, 5e13), deadline=rng.uniform(0.0, 2 * 86400.0),
                est_wss=rng.choice([0.0, 0.5e9, 2e9]), fraction_done=rng.choice([0.0, 0.3, 0.99]),
                fraction_done_exact=rng.random() < 0.3, runtime=rng.uniform(0, 3600),
                state=rng.choice([cl.RunState.UNSTARTED, cl.RunState.RUNNING,
                                  cl.RunState.PREEMPTED, cl.RunState.DONE]),
                slice_start=rng.uniform(0, 1000), checkpoint_time=rng.uniform(0, 1000),
                non_cpu_intensive=rng.random() < 0.1))
        clients.append(c)
    return clients


def engine_world(core, backend, dev, n, seed):
    """A columnar world of ``n`` hosts, 1-4 queued jobs each (running or
    preempted, CPU usage 0.5-2), on the given engine backend."""
    import random

    cl = core.client
    CPU = core.ResourceType.CPU
    rng = random.Random(seed)
    world = core.HostArrays(backend=backend, device=dev)
    for h in range(n):
        client = cl.Client(host_id=h + 1, resources={CPU: cl.ClientResource(CPU, 4, 1e10)},
                           prefs=cl.ClientPrefs())
        client.attach(cl.ProjectAttachment(name="p"))
        world.add_host(h + 1, client, 4)
        for k in range(rng.randrange(1, 5)):
            cj = cl.ClientJob(instance_id=h * 100 + k, job_id=h * 100 + k, project="p",
                              app_name="w", usage={CPU: rng.choice([0.5, 1.0, 2.0])},
                              est_flops=1e10, est_flop_count=1e13, deadline=1e9,
                              state=rng.choice([cl.RunState.RUNNING, cl.RunState.PREEMPTED]))
            client.jobs.append(cj)
            world.add_job(h + 1, cj, actual_total=rng.uniform(40.0, 200.0))
        world.sync_run_state(h + 1)
    return world


def cuda_profile(fn):
    """Run ``fn`` once under torch.profiler with device activity only (a
    whole simulation holds too many host ops to record them); return the
    device microseconds per kernel name (empty where CUPTI recorded none:
    the run is not repeated), the wall milliseconds and ``fn``'s result. The
    device records are summed straight from the profiler's raw results:
    building its event tree (``key_averages``) over a run's million launches
    takes minutes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    dev_us = {}
    raw = getattr(prof.profiler, "kineto_results", None)
    if raw is not None:
        for e in raw.events():
            if str(e.device_type()).endswith("CUDA") and e.duration_ns() > 0:
                dev_us[e.name()] = dev_us.get(e.name(), 0.0) + e.duration_ns() / 1e3
    else:
        dev_us = {e.key: e.self_device_time_total for e in prof.key_averages()
                  if e.self_device_time_total > 0}
    if not dev_us:
        log("torch.profiler recorded no device time for the run: busy time not measured")
    return dev_us, wall_ms, out


def engines_phase(dev, check, quorum_ops, quorum_compare_ref):
    """Phase 26: the torch engine backend on the card against the NumPy
    engines, bit for bit: each engine pass alone at fleet scale, whole
    scenario runs, and tensor payloads through the validation engine's
    digests (the pair-count kernel). Returns the pairwise kernel's record at
    the digest's shape and its launches in the payload run (none), then the
    pair-count kernel's record and its launches there."""
    import random

    import numpy as np
    import torch

    from repro_torch import core
    from repro_torch.core import scenarios as scen
    from repro_torch.core import torch_backend
    from repro_torch.core.batch_dispatch import BatchDispatchEngine
    from repro_torch.core.scheduler import ResourceRequest, ScheduleRequest
    from repro_torch.kernels.quorum_compare.ref import quorum_pair_counts_ref

    CPU = core.ResourceType.CPU
    walls = {}

    def timed(fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    def profile_pass(label, fn):
        """Busy time and idle share of one call of a torch engine pass."""
        dev_us, wall_ms = profile_breakdown(fn, f"[26] {label}", top=5)
        walls[label] = {"profiled_wall_ms": wall_ms, "busy_ms": sum(dev_us.values()) / 1e3
                        if dev_us else None}

    # ---- 1a. dispatch scoring over a full feeder cache, 10 000 hosts -------
    def dispatch_server(backend):
        core.reset_ids()
        server = core.ProjectServer(name="bench", purge_delay=1e18, engine_backend=backend,
                                    engine_device=dev)
        app = core.App(name="work", min_quorum=1, init_ninstances=1, delay_bound=6 * 3600.0,
                       comparator=core.fuzzy_comparator(rtol=1e-6, atol=1e-9))
        for osn in ("windows", "mac", "linux"):
            app.add_version(core.AppVersion(id=core.next_id("appver"), app_name="work",
                                            platform=core.Platform(osn, "x86_64"), version_num=1,
                                            plan_class=core.default_cpu_plan_class()))
        server.add_app(app)
        rng = random.Random(SEED + 26)
        hosts = []
        for i in range(ENGINE_HOSTS):
            # availabilities below 1 make the scaled runtimes real divisions
            h = core.Host(id=i + 1, platforms=(core.Platform("windows", "x86_64"),),
                          resources={CPU: core.ProcessingResource(CPU, 8, 2e10)},
                          volunteer_id=i + 1, on_fraction=rng.choice([1.0, 0.9, 0.6, 0.35]))
            server.add_host(h)
            hosts.append(h)
        for _ in range(N_DISPATCH + server.cache_size):
            server.submit_job(core.Job(id=core.next_id("job"), app_name="work",
                                       est_flop_count=0.25 * 3600 * 16.5e9), 0.0)
        server.tick(0.0)
        return server, hosts

    def request(host):
        return ScheduleRequest(host_id=host.id,
                               requests={CPU: ResourceRequest(req_runtime=1.0, req_idle=0)})

    def candidate_sig(rows):
        if rows is None:
            return None
        pos, grp, scores, est, scaled, choices, disk, delay = rows
        return ([a.tobytes() for a in (pos, grp, scores, est, scaled, disk, delay)],
                [(c.version.id if c.version else None, sorted((k.name, v) for k, v in c.usage.items()),
                  c.pf, c.size_q) for c in choices])

    t_step = time.perf_counter()
    srv = {b: dispatch_server(b) for b in ("numpy", "torch")}
    rng = random.Random(SEED + 27)
    picks = [(rng.randrange(ENGINE_HOSTS), rng.random()) for _ in range(N_SCORE)]
    sigs, n_cand = {}, []
    for backend, (server, hosts) in srv.items():
        eng = BatchDispatchEngine(server.store, server.feeder, backend=backend, device=dev)
        sched = server.schedulers[0]
        args = [(sched, hosts[i], request(hosts[i]), CPU, int(u * eng.n), 0.0) for i, u in picks]
        out, sec = timed(lambda: [eng.candidate_rows(*a) for a in args])
        sigs[backend] = [candidate_sig(r) for r in out]
        n_cand = [0 if r is None else len(r[0]) for r in out]
        walls[f"dispatch_score_{backend}_ms"] = sec * 1e3 / N_SCORE
        if backend == "torch":
            profile_pass("dispatch scoring x20", lambda: [eng.candidate_rows(*a) for a in args[:20]])
    if sigs["torch"] != sigs["numpy"]:
        bad = next(i for i, (a, b) in enumerate(zip(sigs["torch"], sigs["numpy"])) if a != b)
        raise AssertionError(f"dispatch scoring on the card differs from NumPy at request {bad}")
    log(f"[26] dispatch scoring, {ENGINE_HOSTS} hosts, a {srv['numpy'][0].cache_size}-slot cache: "
        f"{N_SCORE} requests bit-equal (candidates {min(n_cand)}-{max(n_cand)}); ms per call numpy "
        f"{walls['dispatch_score_numpy_ms']:.3f}, torch {walls['dispatch_score_torch_ms']:.3f}")
    replies = {}
    for backend, (server, hosts) in srv.items():
        got = []
        t = time.perf_counter()
        for base in range(0, N_DISPATCH, DISPATCH_CHUNK):
            chunk = [request(hosts[k % ENGINE_HOSTS]) for k in range(base, base + DISPATCH_CHUNK)]
            for r in server.rpc_batch(chunk, base * 1e-3):
                got.append([(dj.job.id, dj.instance.id, dj.version.id, dj.est_runtime)
                            for dj in r.jobs])
            server.feeder.fill()
        walls[f"dispatch_rpc_{backend}_ms"] = (time.perf_counter() - t) * 1e3 / N_DISPATCH
        replies[backend] = got
    if replies["torch"] != replies["numpy"]:
        raise AssertionError("rpc_batch dispatch on the torch engines differs from NumPy")
    n_jobs = sum(len(r) for r in replies["numpy"])
    log(f"[26] dispatch through rpc_batch: {N_DISPATCH} requests, {n_jobs} jobs sent, replies "
        f"identical; ms per request numpy {walls['dispatch_rpc_numpy_ms']:.3f}, torch "
        f"{walls['dispatch_rpc_torch_ms']:.3f}")
    del srv

    # ---- 1b. the client engine on a 10 000-host fleet ------------------------
    def wrr_sig(r):
        by_name = lambda d: {rt.name: v for rt, v in d.items()}  # noqa: E731
        return (list(r.deadline_misses), by_name(r.shortfall), by_name(r.idle_instances),
                by_name(r.queue_dur), by_name(r.saturated_until))

    def jobs_sig(js):
        return [(j.instance_id, j.state, j.slice_start, j.deadline_miss) for j in js]

    now = 500.0
    fleets = {b: engine_fleet(core.client, ENGINE_HOSTS, SEED + 26) for b in ("numpy", "torch")}
    engines = {"numpy": core.BatchClientEngine(),
               "torch": core.BatchClientEngine(backend="torch", device=dev)}
    client_out = {}
    for backend, fleet in fleets.items():
        eng = engines[backend]
        wrr, s1 = timed(lambda: eng.wrr_batch(fleet, now))
        runs, s2 = timed(lambda: eng.schedule_batch(fleet, now))
        needs, s3 = timed(lambda: eng.needs_work_batch(fleet, now))
        walls.update({f"wrr_batch_{backend}_s": s1, f"schedule_batch_{backend}_s": s2,
                      f"needs_work_batch_{backend}_s": s3})
        client_out[backend] = (
            [wrr_sig(r) for r in wrr], [jobs_sig(r) for r in runs],
            [(jobs_sig(c.jobs), jobs_sig(c.running)) for c in fleet],
            [{rt.name: (q.req_runtime, q.req_idle, q.queue_dur) for rt, q in d.items()}
             for d in needs])
    for i, what in enumerate(("wrr_batch", "schedule_batch run sets", "client states",
                              "needs_work_batch")):
        if client_out["torch"][i] != client_out["numpy"][i]:
            raise AssertionError(f"client engine on the card: {what} differ from NumPy")
    fresh = engine_fleet(core.client, ENGINE_HOSTS, SEED + 26)
    profile_pass("wrr_batch", lambda: engines["torch"].wrr_batch(fresh, now))
    profile_pass("schedule_batch", lambda: engines["torch"].schedule_batch(fresh, now))
    profile_pass("needs_work_batch", lambda: engines["torch"].needs_work_batch(fresh, now))
    log(f"[26] client engine, {ENGINE_HOSTS} hosts: wrr_batch, schedule_batch and needs_work_batch "
        f"bit-equal; s per call numpy / torch: wrr {walls['wrr_batch_numpy_s']:.3f} / "
        f"{walls['wrr_batch_torch_s']:.3f}, schedule {walls['schedule_batch_numpy_s']:.3f} / "
        f"{walls['schedule_batch_torch_s']:.3f}, needs {walls['needs_work_batch_numpy_s']:.3f} / "
        f"{walls['needs_work_batch_torch_s']:.3f}")
    del fleets, fresh, client_out

    # ---- 1c. the world's accrual and completion passes, 10 000 hosts --------
    worlds = {b: engine_world(core, b, dev, ENGINE_HOSTS, SEED + 26) for b in ("numpy", "torch")}
    cl = core.client

    def mutate(world, step):
        """One mutation of every ``_touch`` kind, the same on both worlds."""
        r = random.Random(SEED + step)
        ids = [h for h in world.index if world.alive[world.index[h]]]
        a, b, c, d, e, f, g = r.sample(ids, 7)
        rows = world.row_of[world.index[a]]
        if rows:
            world.set_accrued(a, next(iter(rows)), 7.25)  # set_accrued
        for j in world.clients[world.index[b]].jobs:
            j.state = cl.RunState.RUNNING
        world.sync_run_state(b)  # sync_run_state
        cj = world.clients[world.index[c]].jobs
        if cj:
            cj[0].state = cl.RunState.DONE
        world.mark_dirty(c)
        world.resync_host(c)  # resync_host
        world.remove_host(d)  # remove_host
        extra = cl.ClientJob(instance_id=10_000_000 + step, job_id=10_000_000 + step, project="p",
                             app_name="w", usage={CPU: 1.0}, est_flops=1e10, est_flop_count=1e13,
                             deadline=1e9, state=cl.RunState.RUNNING)
        world.clients[world.index[e]].jobs.append(extra)
        world.add_job(e, extra, actual_total=55.0)  # add_job
        world.sync_run_state(e)
        world.advance_host(f, world.last_update[world.index[f]] + 5.0)  # advance_host
        done = world.completed_rows(g)
        if len(done):
            world.remove_rows(g, done)  # remove_rows

    def same_worlds(label):
        wn, wt = worlds["numpy"], worlds["torch"]
        for name in ("q_runtime", "q_frac", "busy", "q_count", "q_total", "q_running"):
            if not np.array_equal(getattr(wn, name), getattr(wt, name)):
                raise AssertionError(f"world {label}: {name} differs from NumPy")
        m = wt._mirror
        m.sync(wt)
        for name in ("q_total", "q_runtime", "q_frac", "q_running", "q_weight", "busy"):
            if not np.array_equal(getattr(m, name).cpu().numpy(), getattr(wt, name)):
                raise AssertionError(f"world {label}: the card's {name} differs from the host's")

    done_rows = {}
    for step, t in enumerate((30.0, 60.0, 95.0, 160.0, 400.0)):
        for backend, world in worlds.items():
            ids = [h for h in world.index if world.alive[world.index[h]]]
            if step == 4 and backend == "torch":
                profile_pass("advance_batch", lambda: world.advance_batch(ids, t))
                out = {"done": None}
                profile_pass("completed_rows_batch",
                             lambda: out.update(done=world.completed_rows_batch(ids)))
                done = out["done"]
            else:
                _, s = timed(lambda: world.advance_batch(ids, t))
                done, s2 = timed(lambda: world.completed_rows_batch(ids))
                walls.setdefault(f"advance_batch_{backend}_s", []).append(s)
                walls.setdefault(f"completed_rows_batch_{backend}_s", []).append(s2)
            done_rows[backend] = {h: r.tolist() for h, r in done.items()}
            mutate(world, step)
        if done_rows["torch"] != done_rows["numpy"]:
            raise AssertionError(f"world pass {step}: completed rows differ from NumPy")
        same_worlds(f"pass {step}")
    recs = [(wn.rec.accounts, wt.rec.accounts) for wn, wt in
            zip(worlds["numpy"].clients, worlds["torch"].clients) if wn is not None]
    if any({k: (v.balance, v.total_used) for k, v in a.items()}
           != {k: (v.balance, v.total_used) for k, v in b.items()} for a, b in recs):
        raise AssertionError("world passes: REC debits differ from NumPy")
    log(f"[26] world, {ENGINE_HOSTS} hosts: 5 accrual and completion passes with every _touch kind "
        f"between them, bit-equal (host arrays, the card's mirror, REC debits); s per pass numpy / "
        f"torch: advance {np.mean(walls['advance_batch_numpy_s']):.4f} / "
        f"{np.mean(walls['advance_batch_torch_s']):.4f}, completion "
        f"{np.mean(walls['completed_rows_batch_numpy_s']):.4f} / "
        f"{np.mean(walls['completed_rows_batch_torch_s']):.4f}")
    del worlds
    log(f"[26] step 1 wall {time.perf_counter() - t_step:.1f} s")

    # ---- 2. whole runs: three specs of the matrix and adversarial_10k --------
    t_step = time.perf_counter()
    DAY, HOUR = scen.DAY, scen.HOUR
    specs = [
        (scen.ScenarioSpec(name="clique_half_fleet_defended", seed=2, clique=scen.Clique(size=6),
                           n_jobs=40, defense=core.DefensePolicy()), 0.0),
        (scen.ScenarioSpec(name="blackout_half", seed=3,
                           outage=scen.Outage(start=1.0 * DAY, duration=8 * HOUR, fraction=0.5),
                           horizon=3 * DAY), 0.0),
        (scen.ScenarioSpec(name="cpu_gpu_mix", gpu=True, gpu_fraction=0.5, n_jobs=80,
                           est_hours=0.4), 0.0),
        # adversarial_10k at its jobs and horizon on a quarter of its fleet,
        # its clique and credit farmers cut in proportion: its time goes
        # with its RPCs (~10 a host), and the script has a time limit (cut
        # from half the fleet for phase 29); step 1 holds every pass at
        # 10 000 hosts
        (scen.ScenarioSpec(name="adversarial_10k", seed=12, n_hosts=2500, n_jobs=3000,
                           horizon=0.5 * DAY, est_hours=0.05, clique=scen.Clique(size=250),
                           farm=scen.CreditFarm(count=100, factor=8.0),
                           churn_rate=1.0 / (30 * DAY), availability=0.9), 60.0),
    ]
    for spec, epoch in specs:
        a, sa = timed(lambda: scen.run_spec(spec, epoch=epoch))
        b, sb = timed(lambda: scen.run_spec(spec, epoch=epoch, backend="torch", device=dev))
        scen.assert_results_identical(a, b, "torch backend on the card vs numpy engines",
                                      job_states=True)
        c = a.server.counts()
        walls[f"run_{spec.name}_s"] = (sa, sb)
        log(f"[26] run_spec {spec.name} ({spec.n_hosts} hosts, {spec.n_jobs} jobs, epoch {epoch}): "
            f"identical with job states; jobs_success {c['jobs_success']}, wrong_accepted "
            f"{a.metrics.wrong_accepted}, replication {a.metrics.replication_overhead:.4f}; wall s "
            f"numpy {sa:.2f}, torch {sb:.2f}")
    log(f"[26] step 2 wall {time.perf_counter() - t_step:.1f} s")

    # ---- 3. tensor payloads through the validation engine --------------------
    t_step = time.perf_counter()
    f32 = torch.float32
    gen = torch.Generator(device=dev).manual_seed(SEED + 26)
    qa = torch.randn(PAYLOAD_LEN, generator=gen, device=dev)
    qb = qa.clone()
    qb[:7] += 1.5
    rtol_d, atol_d = 1e-6, 1e-9  # the App's fuzzy_comparator
    rec = check("quorum_compare_digest", f"({PAYLOAD_LEN},) x2", f32,
                lambda a, b: quorum_ops.quorum_compare(a, b, rtol=rtol_d, atol=atol_d),
                lambda a, b: quorum_compare_ref(a, b, rtol_d, atol_d),
                lambda a, b: torch.isclose(a, b, rtol=rtol_d, atol=atol_d).logical_not().sum(),
                (qa, qb), 1e-5, 2 * PAYLOAD_LEN * 4, 6 * PAYLOAD_LEN, PEAK_OPS["float32"])

    def execute(job, host):
        return np.random.default_rng(job.id).standard_normal(PAYLOAD_LEN)

    def corrupt(truth, r):
        return truth + r.uniform(1.0, 2.0)

    spec = scen.ScenarioSpec(name="tensor_payloads", seed=5, n_hosts=PAYLOAD_HOSTS,
                             n_jobs=PAYLOAD_JOBS, error_prob=0.05, malicious_fraction=0.1)

    def payload_run(**kw):
        server, sim, pop = scen.build(spec, **kw)
        sim.executor, sim.corruptor = execute, corrupt
        m = sim.run(spec.horizon)
        sim.audit_validation()
        return scen.ScenarioResult(spec=spec, server=server, sim=sim, metrics=m, population=pop)

    digests = []  # the rows of each digest call of the torch run
    grouping = torch_backend.quorum_group_codes

    def counted_grouping(mat, rtol, atol, device):
        digests.append(mat.shape[0])
        return grouping(mat, rtol, atol, device)

    a, sa = timed(lambda: payload_run())
    torch_backend.quorum_group_codes = counted_grouping
    try:
        quorum_ops.launches = quorum_ops.launches_pairs = 0
        b, sb = timed(lambda: payload_run(backend="torch", device=dev))
        launches, pair_launches = quorum_ops.launches, quorum_ops.launches_pairs
    finally:
        torch_backend.quorum_group_codes = grouping
    scen.assert_results_identical(a, b, "torch digests on the card vs numpy", job_states=True)
    panels = sum(-(-n // max(1, torch_backend.PANEL_ENTRIES // n)) for n in digests if n >= 2)
    if launches:
        raise AssertionError(f"the payload run launched the per-pair quorum_compare {launches} times")
    if not pair_launches or pair_launches != panels:
        raise AssertionError(f"the payload run launched the pair-count kernel {pair_launches} times, "
                             f"its {len(digests)} digest calls make {panels} panels")
    walls["payload_s"] = (sa, sb)
    c = a.server.counts()
    n_max = max(digests)
    log(f"[26] tensor payloads ({PAYLOAD_HOSTS} hosts, {PAYLOAD_JOBS} jobs of {PAYLOAD_LEN} f64, "
        f"error_prob 0.05, malicious 0.1): identical with job states; jobs_success "
        f"{c['jobs_success']}, wrong_accepted {a.metrics.wrong_accepted}; digest calls "
        f"{len(digests)}, rows a call mean {sum(digests) / len(digests):.2f} max {n_max}; "
        f"quorum_compare launches {launches}, quorum_pair_counts launches {pair_launches}; wall s "
        f"numpy {sa:.2f}, torch {sb:.2f}")

    log(f"[26] step 3 wall {time.perf_counter() - t_step:.1f} s")

    # ---- 4. the pair-count kernel against its plain version, bit for bit ----
    t_step = time.perf_counter()
    def payload_rows(n, d, dtype, offset=0):
        """n rows of d: replicas of a few results, some within the digest
        tolerance of each other, some corrupted, one NaN and one inf; with
        ``offset``, a view that starts one element into its buffer."""
        base = torch.randn(max(1, n // 3), d, generator=gen, device=dev, dtype=torch.float64)
        pick = torch.randint(0, base.shape[0], (n,), generator=gen, device=dev)
        x = base[pick] * (1 + 1e-7 * torch.randn(n, 1, generator=gen, device=dev,
                                                 dtype=torch.float64))
        x[1::4] += torch.rand(len(x[1::4]), 1, generator=gen, device=dev, dtype=torch.float64) + 1
        x[n // 2, d // 3] = float("nan")
        x[n - 1, d - 1] = float("inf")
        flat = torch.zeros(n * d + 1, device=dev, dtype=dtype)
        flat[offset:offset + n * d] = x.reshape(-1).to(dtype)
        return flat[offset:offset + n * d].view(n, d)

    def held(label, x, lo, hi):
        got = quorum_ops.quorum_pair_counts(x, lo, hi, rtol=rtol_d, atol=atol_d)
        want = quorum_pair_counts_ref(x, lo, hi, rtol_d, atol_d)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"quorum_pair_counts {label} [{lo}, {hi}): "
                                 f"{int((got != want).sum())} counts differ from the plain version")
        return got

    cases = []
    for dtype in (f32, torch.bfloat16):
        for n, d, offset in ((2, PAYLOAD_LEN, 0), (n_max, PAYLOAD_LEN, 0), (2 * n_max + 3, PAYLOAD_LEN, 0),
                             (n_max, PAYLOAD_LEN + 1, 1)):
            x = payload_rows(n, d, dtype, offset)
            label = f"({n}, {d}) {str(dtype)[6:]}" + (" one element into its buffer" if offset else "")
            got = held(label, x, 0, n)
            cases.append(label)
            if n == 2 * n_max + 3:  # two panels, as a test-only panel constant makes them
                held(label, x, 0, (n + 1) // 2)
                held(label, x, (n + 1) // 2, n)
                mat = x.double().cpu().numpy()
                want = torch_backend.quorum_group_codes(mat, rtol_d, atol_d, dev)
                old = torch_backend.PANEL_ENTRIES
                torch_backend.PANEL_ENTRIES = n * ((n + 1) // 2)
                try:
                    codes = torch_backend.quorum_group_codes(mat, rtol_d, atol_d, dev)
                finally:
                    torch_backend.PANEL_ENTRIES = old
                finite = ~np.isnan(mat).any(axis=1)  # NaN rows: fresh sentinels each call
                if not np.array_equal(codes[finite], want[finite]):
                    raise AssertionError(f"two-panel group codes differ from one panel's ({label})")
            if dtype is f32 and d == PAYLOAD_LEN and n == n_max:
                # a sample of pairs against the pairwise kernel
                pick = torch.randint(1, n, (16,), generator=gen, device=dev).tolist()
                for i in pick:
                    r = int(torch.randint(0, i, (1,), generator=gen, device=dev))
                    nb, _ = quorum_ops.quorum_compare(x[i], x[r], rtol=rtol_d, atol=atol_d)
                    if int(nb) != int(got[i, r]):
                        raise AssertionError(f"quorum_pair_counts [{i}, {r}] {int(got[i, r])} != "
                                             f"quorum_compare's {int(nb)}")
    log(f"[26] quorum_pair_counts bit-equal to its plain version at {cases}; 16 pairs equal to "
        f"quorum_compare's counts; two panels give one panel's codes")
    x = payload_rows(n_max, PAYLOAD_LEN, f32)

    def pairs():
        return quorum_ops.quorum_pair_counts(x, 0, n_max, rtol=rtol_d, atol=atol_d)

    pair_rec = check(
        "quorum_pair_counts", f"({n_max}, {PAYLOAD_LEN}) f32 pairs", f32, lambda x: pairs(),
        lambda x: quorum_pair_counts_ref(x, 0, n_max, rtol_d, atol_d),
        lambda x: torch.isclose(x[:, None], x[None], rtol=rtol_d, atol=atol_d).logical_not().sum(-1),
        (x,), 0.0, n_max * PAYLOAD_LEN * 4 + 4 * n_max * n_max,
        5 * PAYLOAD_LEN * n_max * (n_max - 1) / 2, PEAK_OPS["float32"])
    # CUDA events around queued launches as well: a profile of this short
    # two-kernel launch has been seen to lose records (a time under the
    # bound, or a fraction of the events' time)
    pair_rec["events_ms"] = queued_event_ms(pairs)
    if "quorum_pairs_kernel<float, true>" not in pair_rec["kernels"] or \
            pair_rec["ms"] < 0.5 * pair_rec["events_ms"]:
        log(f"[26] quorum_pair_counts: the profile saw {pair_rec['kernels']} for "
            f"{pair_rec['ms']:.6f} ms against {pair_rec['events_ms']:.6f} ms between CUDA events: "
            f"it lost records, so the events' time stands")
        pair_rec["ms"] = pair_rec["events_ms"]
        pair_rec["kernels"] = ["quorum_pairs_kernel<float, true>", "quorum_pairs_sum_kernel",
                               "(CUDA events)"]
    log(f"[26] quorum_pair_counts {pair_rec['shape']}: {pair_rec['ms']:.6f} ms "
        f"({pair_rec['events_ms']:.6f} ms between CUDA events around queued launches)")
    log(f"[26] step 4 wall {time.perf_counter() - t_step:.1f} s")
    log(f"[26] walls {json.dumps(walls)}")
    return rec, launches, pair_rec, pair_launches


# ---- phase 27: the scheduler service on the card ------------------------------
# the §5.1 deployment of benchmarks/bench_rpc.py: one min_quorum=1 app over
# three OSes, a pre-filled 384-slot feeder cache, four shard-affine scheduler
# instances with vectorized dispatch, 2048 hosts and 20 000 jobs
SVC_CACHE = 384
SVC_HOSTS = 2048
SVC_JOBS = 20_000
SVC_SHARDS = 4
SVC_CLIENTS = 10_000  # bench_rpc's treatment traffic: 10 000 clients over 64 connections
SVC_CONNS = 64
SVC_WINDOW = 1024  # frames written at once on the exact run's connection: bench_rpc's max_batch
SVC_BUDGET_S = 90.0
SVC_TIMEOUT_S = 120.0  # the bound of every asyncio run
SVC_OSES = ("windows", "mac", "linux")


def service_project(core, **engine):
    """bench_rpc's project (``benchmarks/bench_rpc.py``'s ``_make_server`` at
    four shards with vectorized dispatch), on the engines ``engine`` names;
    ids are reset first, so two builds give the same ids."""
    core.reset_ids()
    server = core.ProjectServer(name="bench_rpc", purge_delay=1e18, cache_size=SVC_CACHE,
                                n_scheduler_instances=SVC_SHARDS, vector_dispatch=True, **engine)
    app = core.App(name="work", min_quorum=1, init_ninstances=1)
    for osn in SVC_OSES:
        app.add_version(core.AppVersion(id=core.next_id("appver"), app_name="work",
                                        platform=core.Platform(osn, "x86_64"), version_num=1,
                                        plan_class=core.default_cpu_plan_class()))
    server.add_app(app)
    for _ in range(SVC_JOBS):
        server.submit_job(core.Job(id=core.next_id("job"), app_name="work", est_flop_count=1e12), 0.0)
    CPU = core.ResourceType.CPU
    for i in range(SVC_HOSTS):
        server.add_host(core.Host(id=i + 1, platforms=(core.Platform(SVC_OSES[i % 3], "x86_64"),),
                                  resources={CPU: core.ProcessingResource(CPU, 8, 2e10)},
                                  volunteer_id=i + 1))
    server.tick(0.0)
    return server


def service_phase(dev, counts, zero_counts, smi):
    """Phase 27: ``SchedulerService`` over the torch engines on the card.
    (1) 2048 WORK frames pipelined on one connection (a wave at a time),
    coalesced and per request, byte for byte against the NumPy project's sequential ``rpc``
    calls; (2) bench_rpc's 10 000-client load, on torch (unprofiled, then
    profiled for busy time and idle share) and on NumPy; (3) PING, STATS, a
    malformed and an over-long frame on a raw socket; (4) a ``done=`` report
    for an instance dispatched in (1), against the NumPy project fed the same
    frame. No kernel of the port may launch."""
    import asyncio

    from repro_torch import core
    from repro_torch import service as svc

    t_phase = time.perf_counter()
    torch_engines = {"engine_backend": "torch", "engine_device": dev}
    rec = {"deployment": {"hosts": SVC_HOSTS, "jobs": SVC_JOBS, "cache": SVC_CACHE,
                          "shards": SVC_SHARDS, "vector_dispatch": True}}

    def bounded(coro):
        return asyncio.run(asyncio.wait_for(coro, timeout=SVC_TIMEOUT_S))

    # ---- 1. exact: one connection, 2048 pipelined frames --------------------
    CPU = core.ResourceType.CPU
    frames = [svc.encode_request(svc.WorkRequest(seq=i + 1, request=core.ScheduleRequest(
        host_id=i + 1, requests={CPU: core.ResourceRequest(req_runtime=1.0 + 97.0 * (i % 3))},
        usable_disk=1e12))) for i in range(SVC_HOSTS)]
    t = time.perf_counter()
    ref = service_project(core)
    build_s = time.perf_counter() - t
    t = time.perf_counter()
    want = [svc.encode_reply(svc.reply_to_wire(i + 1, ref.rpc(svc.decode_request(f).request, 0.0)))
            for i, f in enumerate(frames)]
    seq_s = time.perf_counter() - t
    offered = [len(svc.decode_reply(w).jobs) for w in want]
    log(f"[27] NumPy project built in {build_s:.2f} s; {len(frames)} sequential rpc calls "
        f"{seq_s:.3f} s: {sum(offered)} jobs offered to {sum(1 for n in offered if n)} hosts")

    async def pipelined(project, coalesce):
        # refill_every above the frame count: no feeder refill between waves.
        # The frames go out a wave (max_batch frames) at a time, each window
        # in one write and its replies read before the next: on gVisor's
        # user-space loopback TCP one write of all 2048 frames stalls the
        # last wave's replies for ~46 s, on the NumPy engines as on torch
        service = svc.SchedulerService(project, coalesce=coalesce, max_batch=SVC_WINDOW,
                                       refill_every=len(frames) + 1)
        await service.start()
        try:
            reader, writer = await asyncio.open_connection("127.0.0.1", service.port)
            t0 = time.perf_counter()
            got = []
            for k in range(0, len(frames), SVC_WINDOW):
                window = frames[k:k + SVC_WINDOW]
                writer.write(("\n".join(window) + "\n").encode())
                await writer.drain()
                got += [(await reader.readline()).decode().rstrip("\n") for _ in window]
            wall = time.perf_counter() - t0
            writer.close()
        finally:
            await service.stop()
        return got, service.stats(), wall

    zero_counts()
    exact = {}
    projects = {}
    for coalesce in (True, False):
        label = "coalesced" if coalesce else "per_request"
        projects[label] = service_project(core, **torch_engines)
        got, stats, wall = bounded(pipelined(projects[label], coalesce))
        bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
        if len(got) != len(want) or bad:
            raise AssertionError(f"[27] {label}: {len(bad)} of {len(want)} reply frames differ from "
                                 f"the NumPy project's sequential rpc, first at frame {bad[:1]}: "
                                 f"{got[bad[0]]!r} != {want[bad[0]]!r}" if bad else
                                 f"[27] {label}: {len(got)} replies for {len(want)} frames")
        exact[label] = {"wall_s": wall, "waves": stats["waves"], "max_wave": stats["max_wave"]}
        log(f"[27] exact, {label}: {len(frames)} reply frames on the torch engines equal the NumPy "
            f"project's sequential rpc byte for byte; {wall:.3f} s, {stats['waves']} waves "
            f"(max {stats['max_wave']})")
    rec["exact"] = {**exact, "frames": len(frames), "jobs_offered": sum(offered),
                    "numpy_sequential_s": seq_s}

    # ---- 3. inline frames on a raw socket ----------------------------------
    async def raw_frames(project):
        service = svc.SchedulerService(project)
        await service.start()
        try:
            reader, writer = await asyncio.open_connection("127.0.0.1", service.port)
            writer.write(b"PING 5\nSTATS 6\nthis is not a frame\n")
            writer.write(b"W" * (svc.MAX_LINE + 1) + b"\n")  # one byte over the limit
            await writer.drain()
            lines = [await reader.readline() for _ in range(5)]
            writer.close()
        finally:
            await service.stop()
        return lines

    lines = bounded(raw_frames(projects["coalesced"]))
    replies = [svc.decode_reply(line.decode().rstrip("\n")) for line in lines[:4]]
    # the reference service's answers (tests/test_service.py): PONG, STATS,
    # ERR bad-int, ERR too-long, then the connection dropped
    pong, stats_rep, err, too_long = replies
    if not (pong == svc.PongReply(seq=5) and isinstance(stats_rep, svc.StatsReply)
            and stats_rep.seq == 6 and stats_rep.values.get("errors") == 0.0
            and isinstance(err, svc.ErrorReply) and err.code == "bad-int"
            and isinstance(too_long, svc.ErrorReply) and too_long.code == "too-long"
            and lines[4] == b""):
        raise AssertionError(f"[27] raw frames answered {lines[:4]!r}, then {lines[4][:80]!r}")
    log(f"[27] raw socket: PING -> PONG, STATS -> {len(stats_rep.values)} values, a malformed frame "
        f"-> ERR bad-int, {svc.MAX_LINE + 1} bytes -> ERR too-long and the connection dropped")

    # ---- 4. a completion report against the NumPy project ------------------
    first = next(i for i, n in enumerate(offered) if n)
    inst_id = svc.decode_reply(want[first]).jobs[0].instance_id
    done = (f"WORK {len(frames) + 1} host={first + 1} disk=1e+15 cpu=3000.0:1.0:0.0 "
            f"done={inst_id}:success:120.0:1e+12:0")

    async def report_done(project):
        service = svc.SchedulerService(project)
        await service.start()
        try:
            reader, writer = await asyncio.open_connection("127.0.0.1", service.port)
            writer.write((done + "\n").encode())
            await writer.drain()
            line = (await reader.readline()).decode().rstrip("\n")
            writer.close()
        finally:
            await service.stop()
        return line

    got_done = bounded(report_done(projects["coalesced"]))
    want_done = svc.encode_reply(svc.reply_to_wire(len(frames) + 1,
                                                   ref.rpc(svc.decode_request(done).request, 0.0)))

    def instance_row(project):
        i = project.store.instances[inst_id]
        return (i.outcome.value, i.state.value, i.validate_state.value, i.is_outstanding(),
                project.store.jobs[i.job_id].transition_flag)

    if got_done != want_done or instance_row(projects["coalesced"]) != instance_row(ref):
        raise AssertionError(f"[27] done= report: torch {got_done!r} {instance_row(projects['coalesced'])}"
                             f", NumPy {want_done!r} {instance_row(ref)}")
    if instance_row(ref)[0] != "success" or instance_row(ref)[3]:
        raise AssertionError(f"[27] the reported instance is {instance_row(ref)}")
    log(f"[27] done= report for instance {inst_id}: the reply and the instance "
        f"{instance_row(ref)[:3]} equal the NumPy project's")
    del projects, ref
    gc.collect()

    # ---- 2. the 10 000-client load -----------------------------------------
    async def load(project):
        service = svc.SchedulerService(project, coalesce=True, max_batch=SVC_WINDOW)
        await service.start()
        try:
            report = await svc.run_load("127.0.0.1", service.port, n_clients=SVC_CLIENTS,
                                        n_conns=SVC_CONNS)
        finally:
            await service.stop()
        return report, service.stats()

    def load_row(label, project, profile=False):
        if profile:
            dev_us, wall_ms, (report, stats) = cuda_profile(lambda: bounded(load(project)))
        else:
            report, stats = bounded(load(project))
        sent = [i for i in project.store.instances.values()
                if i.state == core.InstanceState.IN_PROGRESS]
        if not (report.replies == report.requests == SVC_CLIENTS and report.errors == 0
                and report.jobs_received > 0 and stats["requests"] == SVC_CLIENTS
                and len(sent) == stats["dispatched"] == report.jobs_received):
            raise AssertionError(f"[27] load {label}: {report}, stats {stats}, {len(sent)} instances sent")
        row = {k: getattr(report, k) for k in ("requests", "replies", "errors", "jobs_received",
                                                 "wall_s", "rpcs_per_s", "p50_ms", "p95_ms", "p99_ms")}
        row.update(waves=stats["waves"], max_wave=stats["max_wave"],
                   shards=[{k: r[k] for k in ("shard", "requests", "dispatched", "owned_slots",
                                               "migrations_in")} for r in stats["shards"]])
        if profile:
            busy_ms = sum(dev_us.values()) / 1e3 if dev_us else None
            row.update(profiled_wall_ms=wall_ms, busy_ms=busy_ms,
                       idle_share=max(0.0, 1 - busy_ms / wall_ms) if busy_ms is not None else None,
                       kernels=len(dev_us))
        log(f"[27] load {label}: {SVC_CLIENTS} clients over {SVC_CONNS} connections, "
            f"{report.rpcs_per_s:.1f} RPC/s, p50/p95/p99 {report.p50_ms:.2f}/{report.p95_ms:.2f}/"
            f"{report.p99_ms:.2f} ms, {report.jobs_received} jobs, {stats['waves']} waves "
            f"(max {stats['max_wave']}), shards {[(r['requests'], r['dispatched']) for r in stats['shards']]}"
            + (f"; profiled: busy {row['busy_ms']} ms of {wall_ms:.1f} ms, idle share "
               f"{row['idle_share']}" if profile else ""))
        return row

    rec["load_torch"] = load_row("torch", service_project(core, **torch_engines))
    gc.collect()
    rec["load_torch_profiled"] = load_row("torch, profiled", service_project(core, **torch_engines),
                                          profile=True)
    gc.collect()
    rec["load_numpy"] = load_row("NumPy", service_project(core))
    gc.collect()

    launched = {k: v for k, v in counts().items() if v}
    if launched:
        raise AssertionError(f"[27] the service run launched the port's kernels: {launched}")
    rec["launches"] = 0
    rec["wall_s"] = time.perf_counter() - t_phase
    rec["card"] = smi
    log(f"[27] no kernel of the port launched; phase wall {rec['wall_s']:.1f} s of a "
        f"{SVC_BUDGET_S:.0f} s budget ({'within' if rec['wall_s'] <= SVC_BUDGET_S else 'OVER'}) on {smi}")
    log(f"[27] service {json.dumps(rec)}")


# ---- phase 28: the dry run and the roofline, held against real steps ---------
DRYRUN_BUDGET_S = 120.0
DRYRUN_JOBS = 6  # cells the sweep lowers at once, each in its own process (8 cores)
DRYRUN_TIMEOUT_S = 400.0  # the sweep's subprocess is killed past this
# the cells run for real on the card: reduced ShapeConfigs of full-width archs
# (arch, name, seq_len, global_batch, kind)
DRYRUN_CHECKS = (
    ("qwen3-0.6b", "train_2x2048", 2048, 2, "train"),  # the grid job's shape
    ("hubert-xlarge", "prefill_4x1500", 1500, 4, "prefill"),  # the encoder, 4 clips
    ("mamba2-130m", "train_2x2048", 2048, 2, "train"),
    ("qwen3-0.6b", "decode_4x1024", 1024, 4, "decode"),
)
# every one of these must launch in some check cell
DRYRUN_MUST_LAUNCH = ("flash_attention", "flash_attention_bwd", "rmsnorm", "rmsnorm_bwd", "swiglu",
                      "swiglu_bwd", "ssd_scan", "ssd_scan_bwd")


def dryrun_phase(dev, counts, zero_counts, smi, remat_peaks=None):
    """Phase 28: (1) ``python -m repro_torch.launch.dryrun --all`` in a
    subprocess: every (arch x shape) cell at full width on the meta device,
    each ``ok`` or ``skipped`` exactly where ``cell_supported`` says, and the
    roofline table with ``fits``; (2) each of ``DRYRUN_CHECKS`` through
    ``build_step(..., single_device_mesh())`` on the card in bf16 from
    seeded random weights: ``count_costs`` over the real step must give the
    meta run's FLOPs and bytes exactly and its kernel calls as the launch
    counters moved; the step's peak memory above its arguments against the
    predicted ``temp_size_in_bytes``; its busy time and idle share
    (torch.profiler) beside the roofline's step time, and MFU over the busy
    time and over the wall; (3) ``perf_iter`` on qwen3-0.6b's train cell
    under remat "nothing" and "dots": FLOPs and temp bytes beside phase
    23's measured peaks. Returns the phase's record."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed.hlo_analysis import op_census
    from repro_torch.distributed.hlo_costs import count_costs
    from repro_torch.distributed.roofline import PEAK_FLOPS_BF16, RooflineTerms
    from repro_torch.launch.mesh import mesh_name, single_device_mesh
    from repro_torch.launch.perf_iter import run_iteration
    from repro_torch.launch.roofline_table import render_table
    from repro_torch.models import cell_supported, get_shape, init_cache, init_params, model_spec
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim.adamw import init_state
    from repro_torch.runtime.step_builder import build_step, model_flops_for_cell

    t_phase = time.perf_counter()
    rec = {"card": smi}
    # ---- 1. the sweep over every cell, at full width on the meta device -----
    src = str(Path(__file__).resolve().parent / "src")
    out = Path(tempfile.mkdtemp(prefix="dryrun_")) / "dryrun.jsonl"
    env = {**os.environ, "PYTHONPATH": src + os.pathsep + os.environ.get("PYTHONPATH", "")}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--all", "--jobs",
                           str(DRYRUN_JOBS), "--json", str(out)], capture_output=True, text=True,
                          env=env, timeout=DRYRUN_TIMEOUT_S)
    sweep_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"[28] the dry run exited {proc.returncode}: {proc.stdout[-2000:]} "
                             f"{proc.stderr[-2000:]}")
    records = [json.loads(line) for line in out.read_text().splitlines()]
    shutil.rmtree(out.parent, ignore_errors=True)
    for r in records:
        supported, why = cell_supported(get_config(r["arch"]), get_shape(r["shape"]))
        if r["status"] != ("ok" if supported else "skipped"):
            raise AssertionError(f"[28] {r['arch']} x {r['shape']}: {r['status']}, but cell_supported "
                                 f"says {supported} ({why})")
    n_ok = sum(r["status"] == "ok" for r in records)
    log(f"[28] dry run: {len(records)} cells, {n_ok} ok and {len(records) - n_ok} skipped as "
        f"cell_supported says, {sweep_s:.1f} s in {DRYRUN_JOBS} processes (meta runs "
        f"{sum(r.get('meta_s', 0) for r in records):.1f} s in all)")
    for line in render_table(records, fits=True).splitlines():
        log(f"[28] {line}")
    rec["sweep"] = {"cells": len(records), "ok": n_ok, "wall_s": sweep_s,
                    "fit": [f"{r['arch']} {r['shape']}" for r in records if r.get("fits")]}

    # ---- 2. the dry run held against real steps on the card -----------------
    mesh = single_device_mesh()
    gen = torch.Generator(device=dev).manual_seed(SEED + 28)
    launched_any = dict.fromkeys(DRYRUN_MUST_LAUNCH, 0)
    rec["checks"] = []

    def real_args(bundle, cfg, shape):
        """The step's arguments on the card: seeded random weights (f32
        masters), AdamW's zero moments, random tokens or bf16 embeddings, a
        zero cache, the last position's index."""
        b, s = shape.global_batch, shape.seq_len
        params = init_params(gen, model_spec(cfg), dtype=cfg.param_dtype, device=dev)

        def batch_of(specs):
            return {k: (torch.randint(0, cfg.vocab, tuple(t.shape), generator=gen, device=dev,
                                      dtype=t.dtype) if not t.dtype.is_floating_point
                        else torch.randn(tuple(t.shape), generator=gen, device=dev).to(t.dtype))
                    for k, t in specs.items()}

        if shape.kind == "train":
            return params, init_state(params), batch_of(bundle.in_specs[2])
        if shape.kind == "prefill":
            batch = batch_of(bundle.in_specs[1])
            return (params, batch) if len(bundle.in_specs) == 2 else (params, batch,
                                                                       init_cache(cfg, b, s, dev))
        tokens = torch.randint(0, cfg.vocab, (b, 1), generator=gen, device=dev, dtype=torch.int32)
        return params, tokens, init_cache(cfg, b, s, dev), s - 1

    for arch, name, seq, batch, kind in DRYRUN_CHECKS:
        cfg = get_config(arch)
        shape = ShapeConfig(name, seq, batch, kind)
        bundle = build_step(cfg, shape, mesh)
        lowered = bundle.lower()
        meta = lowered.costs
        args = real_args(bundle, cfg, shape)
        bundle(*args)  # warm-up: the allocator, cuBLAS's handles
        torch.cuda.synchronize()
        zero_counts()
        real = count_costs(bundle, *args)
        torch.cuda.synchronize()
        launched = counts()
        if real.flops != meta.flops or real.bytes != meta.bytes:
            got, want = op_census(real), op_census(meta)
            diff = {k: (got.get(k), want.get(k)) for k in sorted(set(got) | set(want))
                    if got.get(k) != want.get(k)}
            raise AssertionError(f"[28] {arch} {name}: the card counted flops {real.flops} bytes "
                                 f"{real.bytes}, the meta run {meta.flops} and {meta.bytes}; "
                                 f"census (card, meta) where they differ: {diff}")
        calls = {k: v.calls for k, v in meta.kernels.items()}
        if {k: v.calls for k, v in real.kernels.items()} != calls:
            raise AssertionError(f"[28] {arch} {name}: kernel calls on the card "
                                 f"{ {k: v.calls for k, v in real.kernels.items()} } != meta {calls}")
        moved = {k: v for k, v in launched.items() if v}
        # the launch counter of a kernel entry: "flash_attention_fwd" moves "flash_attention"
        want_launches = {k.removesuffix("_fwd"): n for k, n in calls.items()}
        if moved != want_launches:
            raise AssertionError(f"[28] {arch} {name}: the launch counters moved {moved}, the counted "
                                 f"kernel calls imply {want_launches}")
        for k, n in moved.items():
            if k in launched_any:
                launched_any[k] += n
        # memory: the step's peak above its arguments against the prediction
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        result = bundle(*args)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        del result
        temp = lowered.memory.temp_size_in_bytes
        dev_us, wall_ms = profile_breakdown(lambda: bundle(*args), f"[28] {arch} {name}", top=5)
        busy_ms = sum(dev_us.values()) / 1e3 if dev_us else None
        model_flops = model_flops_for_cell(cfg, shape)
        terms = RooflineTerms(arch=arch, shape=name, mesh=mesh_name(mesh), chips=1,
                              hlo_flops=meta.flops, hlo_bytes=meta.bytes,
                              model_flops=model_flops)
        row = {
            "arch": arch, "shape": name, "tokens": shape.tokens, "kind": kind,
            "flops": meta.flops, "bytes": meta.bytes, "model_flops": model_flops,
            "kernel_calls": calls, "compute_s": terms.compute_s, "memory_s": terms.memory_s,
            "dominant": terms.dominant, "step_time_ms": terms.step_time_s * 1e3,
            "argument_bytes": lowered.memory.argument_size_in_bytes, "temp_bytes": temp,
            "peak_bytes": peak, "peak_over_temp": peak / temp if temp else None,
            "wall_ms": wall_ms, "busy_ms": busy_ms,
            "idle_share": None if busy_ms is None else max(0.0, 1 - busy_ms / wall_ms),
            "mfu_busy": None if busy_ms is None else model_flops / (PEAK_FLOPS_BF16 * busy_ms / 1e3),
            "mfu_wall": model_flops / (PEAK_FLOPS_BF16 * wall_ms / 1e3),
            "meta_s": lowered.seconds,
        }
        rec["checks"].append(row)
        log(f"[28] {arch} {name}: flops {meta.flops:.6e} and bytes {meta.bytes:.6e} equal on the card "
            f"and on meta; kernel calls {calls} as launched; roofline {terms.step_time_s * 1e3:.3f} ms "
            f"({terms.dominant}; C {terms.compute_s * 1e3:.3f} ms, M {terms.memory_s * 1e3:.3f} ms); "
            f"busy {'not measured' if busy_ms is None else f'{busy_ms:.3f} ms'} of wall "
            f"{wall_ms:.3f} ms (idle {row['idle_share'] if busy_ms is None else round(row['idle_share'], 4)}); "
            f"mfu busy {row['mfu_busy'] if busy_ms is None else round(row['mfu_busy'], 4)} wall "
            f"{row['mfu_wall']:.4f}; peak above the arguments {peak / 2**30:.3f} GiB against the "
            f"predicted temp {temp / 2**30:.3f} GiB (ratio {row['peak_over_temp']:.3f})")
        del args, bundle
        gc.collect()
        torch.cuda.empty_cache()
    missing = [k for k, n in launched_any.items() if not n]
    if missing:
        raise AssertionError(f"[28] no check cell launched {missing}")
    log(f"[28] launches over the check cells: {launched_any}")

    # ---- 3. perf_iter: qwen3-0.6b's train cell under two remat policies -----
    shape = ShapeConfig("train_2x2048", TRAIN_SEQ, TRAIN_BATCH, "train")
    rec["remat"] = {}
    for policy in ("nothing", "dots"):
        terms, costs, per_dev = run_iteration("qwen3-0.6b", shape, {"remat_policy": policy}, top=5)
        rec["remat"][policy] = {"flops": costs.flops, "per_device_bytes": per_dev,
                                "phase23_peak_gib": (remat_peaks or {}).get(policy)}
        log(f"[28] perf_iter qwen3-0.6b {shape.name} remat_policy {policy}: flops {costs.flops:.6e}, "
            f"per-device bytes {per_dev / 2**30:.3f} GiB (arguments + outputs - aliased + temp: the "
            f"train step's params, AdamW and grads); phase 23's grad step measured "
            f"{(remat_peaks or {}).get(policy, 'not run')} GiB above the params")
    nothing, dots = rec["remat"]["nothing"], rec["remat"]["dots"]
    if not (nothing["flops"] > dots["flops"] and nothing["per_device_bytes"] < dots["per_device_bytes"]):
        raise AssertionError(f"[28] remat 'nothing' must count more flops and fewer bytes a device "
                             f"than 'dots': {rec['remat']}")
    rec["wall_s"] = time.perf_counter() - t_phase
    log(f"[28] phase wall {rec['wall_s']:.1f} s of a {DRYRUN_BUDGET_S:.0f} s budget "
        f"({'within' if rec['wall_s'] <= DRYRUN_BUDGET_S else 'OVER'}) on {smi}")
    log(f"[28] dryrun {json.dumps(rec)}")
    return rec


# ---- phase 29: the sharded train step on a simulated (4, 2) mesh -------------
SHARDED_MESH = (4, 2)
SHARDED_SEQ = 128
SHARDED_BATCH = 8
SHARDED_BUDGET_S = 90.0


def sharded_phase(dev, counts, zero_counts, smi, layers=None):
    """Phase 29: the train step of qwen3-0.6b (full width, all 28 layers,
    f32) over a (4, 2) mesh of 8 ranks simulated in this process, against
    the unsharded step on the card (see the module docstring); ``layers``
    cuts the depth (a probe of the phase alone). Returns the sharded run's
    launch counts and the phase's record."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh, simulated_ranks, single_device_mesh
    from repro_torch.models import init_params, model_spec
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.layers import tree_leaves
    from repro_torch.optim.adamw import AdamWConfig, init_state, lr_at
    from repro_torch.runtime.step_builder import build_step

    t_phase = time.perf_counter()
    cfg = get_config("qwen3-0.6b").scaled(dtype=torch.float32, remat=False)
    if layers:
        cfg = cfg.scaled(n_layers=layers)
    shape = ShapeConfig("sharded", SHARDED_SEQ, SHARDED_BATCH, "train")
    params = init_params(torch.Generator(device=dev).manual_seed(SEED + 29), model_spec(cfg), device=dev)
    g = torch.Generator().manual_seed(SEED + 29)
    batch = {k: torch.randint(0, cfg.vocab, (SHARDED_BATCH, SHARDED_SEQ), generator=g,
                              dtype=torch.int32).to(dev) for k in ("tokens", "labels")}

    t = time.perf_counter()
    one = build_step(cfg, shape, single_device_mesh(), donate=False)
    p1, o1, m1 = one(params, init_state(params), batch)
    torch.cuda.synchronize()
    unsharded_s = time.perf_counter() - t
    loss1 = float(m1["loss"])
    p0 = tree_leaves(params)
    want_mu = tree_leaves(o1.mu)
    want_d = [w - p for w, p in zip(tree_leaves(p1), p0)]  # each leaf's update
    del p1, o1
    gc.collect()
    torch.cuda.empty_cache()

    L = cfg.n_layers
    ranks = SHARDED_MESH[0] * SHARDED_MESH[1]
    calls = {"rmsnorm": 4 * L + 1, "swiglu": L, "flash_attention": L}
    want_launches = {**{k: 0 for k in counts()},
                     **{k: ranks * n for k, n in calls.items()},
                     **{f"{k}_bwd": ranks * n for k, n in calls.items()}}
    opt = AdamWConfig()
    lr = float(lr_at(opt, 1))
    update_bound = 0.1 * lr

    def direction(m):  # AdamW's first update is -lr * (this + wd * p), g = m / (1 - b1)
        return m / (m.abs() + (1 - opt.b1) * opt.eps)

    with simulated_ranks(ranks):
        mesh = make_mesh(SHARDED_MESH, ("data", "model"))
        bundle = build_step(cfg, shape, mesh, donate=False)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        zero_counts()
        dev_us, wall_ms, (p8, o8, m8) = cuda_profile(lambda: bundle(params, init_state(params), batch))
        launched = counts()
        peak = torch.cuda.max_memory_allocated() - base
        loss8 = float(m8["loss"].full_tensor().reconcile())
        placements = {str(tuple(t.placements)) for t in tree_leaves(p8)}
        # each update (p - p0) against the unsharded one beyond the part
        # that the two gradients explain, lr * |direction(mu8) -
        # direction(mu1)|: nothing where a gradient is settled, up to 2 x lr
        # where it is rounding noise (near 0, or near eps). ``skipped``: what
        # the check would read of a step that left the parameters as they were
        worst_mu, worst_raw, worst_update, skipped, n_noise, n_all = 0.0, 0.0, 0.0, 0.0, 0, 0
        for p, want, m1, got, got_m in zip(p0, want_d, want_mu, tree_leaves(p8), tree_leaves(o8.mu)):
            mu8 = got_m.full_tensor().reconcile()
            worst_mu = max(worst_mu, float((mu8 - m1).abs().max() / m1.abs().max().clamp(min=1e-30)))
            explained = lr * (direction(mu8) - direction(m1)).abs()
            err = ((got.full_tensor().reconcile() - p) - want).abs()
            worst_raw = max(worst_raw, float(err.max()))
            worst_update = max(worst_update, float((err - explained).max()))
            skipped = max(skipped, float((want.abs() - explained).max()))
            n_noise, n_all = n_noise + int((explained > update_bound).sum()), n_all + m1.numel()
            del mu8, explained, err
        del p8, o8, m8, bundle
    gc.collect()
    torch.cuda.empty_cache()
    busy_ms = sum(dev_us.values()) / 1e3 if dev_us else None
    rec = {"card": smi, "mesh": list(SHARDED_MESH), "tokens": SHARDED_BATCH * SHARDED_SEQ,
           "layers": L, "loss_unsharded": loss1, "loss_sharded": loss8,
           "loss_rel_err": abs(loss8 - loss1) / abs(loss1), "mu_worst_rel": worst_mu,
           "update_worst_abs": worst_raw, "update_unexplained_worst_abs": worst_update,
           "update_bound": update_bound, "skipped_update_reads": skipped, "noise_share": n_noise / n_all,
           "launches": launched,
           "wall_ms": wall_ms, "busy_ms": busy_ms,
           "idle_share": None if busy_ms is None else max(0.0, 1 - busy_ms / wall_ms),
           "peak_gib": peak / 2**30, "unsharded_s": unsharded_s}
    log(f"[29] sharded train step, qwen3-0.6b f32 {L} layers, {SHARDED_BATCH} x {SHARDED_SEQ} tokens on "
        f"a {SHARDED_MESH} (data, model) mesh of {ranks} simulated ranks: loss {loss8:.6f} against the "
        f"unsharded {loss1:.6f} (rel {rec['loss_rel_err']:.2e}, tol 1e-4); AdamW mu worst "
        f"{worst_mu:.2e} of its leaf's max (tol 1e-3); updates (p - p0) worst {worst_raw:.3e}, beyond "
        f"the gradients' part {worst_update:.3e} (bound 0.1 x lr = {update_bound:.3e}; the gradients "
        f"explain more than that on {rec['noise_share']:.2e} of the elements; a skipped update would "
        f"read {skipped:.3e}); "
        f"param placements {sorted(placements)}")
    log(f"[29] launches on the local shards {json.dumps(launched)}")
    log(f"[29] wall {wall_ms:.1f} ms, device busy "
        f"{'not measured' if busy_ms is None else f'{busy_ms:.1f} ms'}, idle share "
        f"{'not measured' if busy_ms is None else f'{rec['idle_share']:.4f}'}, peak memory above the "
        f"arguments {rec['peak_gib']:.3f} GiB (the unsharded step {unsharded_s:.2f} s) on {smi}")
    if not rec["loss_rel_err"] <= 1e-4 or not math.isfinite(loss8):
        raise AssertionError(f"[29] sharded loss {loss8} against the unsharded {loss1}")
    if not worst_mu <= 1e-3:
        raise AssertionError(f"[29] an AdamW first moment differs by {worst_mu} of its leaf's max")
    if not skipped > update_bound:
        raise AssertionError(f"[29] a skipped update would read {skipped}, within the bound {update_bound}")
    if not worst_update <= update_bound:
        raise AssertionError(f"[29] a parameter's update differs by {worst_update} beyond its "
                             f"gradient's part (bound {update_bound})")
    if launched != want_launches:
        raise AssertionError(f"[29] the sharded step launched {launched}; one launch a rank a call "
                             f"implies {want_launches}")
    rec["wall_s"] = time.perf_counter() - t_phase
    log(f"[29] phase wall {rec['wall_s']:.1f} s of a {SHARDED_BUDGET_S:.0f} s budget "
        f"({'within' if rec['wall_s'] <= SHARDED_BUDGET_S else 'OVER'}) on {smi}")
    log(f"[29] sharded {json.dumps(rec)}")
    return launched, rec


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.configs import get_config, get_smoke_config
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
    from repro_torch.models import (frontends, hybrid_layout, init_cache, init_params, model_spec,
                                    ssm_config)
    from repro_torch.checkpoint.checkpointer import _checksum as checkpoint_sha256
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.models.moe import dispatch_shape
    from repro_torch.models.transformer import moe_config
    from repro_torch.optim import AdamWConfig, compress_tree, compressed_bytes, decompress_tree
    from repro_torch.runtime import (BatchServer, GridTrainer, Request, ServeMetrics,
                                     grad_comparator, make_decode_step, make_encoder_step,
                                     make_grad_step, make_prefill_step, train)

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
        out["quorum_pair_counts"] = quorum_ops.launches_pairs
        out["int8_quantize"] = int8_ops.launches_quantize
        out["int8_dequantize"] = int8_ops.launches_dequantize
        return out

    def zero_counts():
        for mod in (rms_ops, swiglu_ops, flash_ops):
            mod.launches = mod.launches_bwd = 0
        quorum_ops.launches = quorum_ops.launches_pairs = 0
        ssd_ops.launches = ssd_ops.launches_bwd = 0
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

    def check_swiglu(rows, width, dtype, tol, lead=()):
        """(rows, width), or (*lead, rows, width): an MoE expert buffer."""
        shape = (*lead, rows, width)
        g, u = randn(*shape, dtype=dtype), randn(*shape, dtype=dtype)
        n = math.prod(shape)
        return check("swiglu", str(shape), dtype, swiglu_ops.swiglu, swiglu_ref,
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
    for width in (2560, 256):  # minicpm3-4b's model width and kv latent (its q latent: 768)
        check_rms(s_max, width, bf, 2e-2)
    check_rms(64, 20000, bf, 2e-2)
    check_rms(64, 20000, f32, 1e-5)
    check_rms(s_max, 1000, bf, 2e-2)
    check_rms(s_max, d, bf, 2e-2, misaligned=True)
    check_rms(64, d, f32, 1e-5, misaligned=True)
    # the frontends' rows: hubert-xlarge's encoder over four 30 s clips (4 x
    # 1500 frames at d = 1280; phase 24) and pixtral-12b's 700-position
    # prefill (d = 5120; phase 25)
    n_frames = HUBERT_CLIPS * HUBERT_FRAMES
    results["rmsnorm_hubert"] = check_rms(n_frames, 1280, bf, 2e-2)
    results["rmsnorm_pixtral"] = check_rms(s_max, 5120, bf, 2e-2)
    results["swiglu"] = check_swiglu(n_tok, ff, bf, 2e-2)
    check_swiglu(s_max, ff, bf, 2e-2)
    check_swiglu(SLOTS, ff, bf, 2e-2)  # decode
    check_swiglu(64, ff, f32, 1e-6)
    # the experts' buffer (E, C, d_expert) of qwen3-moe-235b-a22b (phase 19's
    # prefill and decode alike) and llama4-scout-17b-a16e's at a 700-token
    # prefill (phase 20); its own row
    results["swiglu_moe"] = check_swiglu(128, 1536, bf, 2e-2, lead=(128,))
    check_swiglu(56, 8192, bf, 2e-2, lead=(16,))
    check_swiglu(8, 8192, bf, 2e-2, lead=(16,))  # llama4's decode step
    # the zoo's dense MLPs at a 700-token prefill: phi4-mini's and llama4's
    # shared expert (8192), command-r-plus's (33792), minicpm3's (6400); a
    # decode step's shared expert
    for width in (8192, 33792, 6400):
        check_swiglu(s_max, width, bf, 2e-2)
    check_swiglu(SLOTS, 8192, bf, 2e-2)
    results["swiglu_hubert"] = check_swiglu(n_frames, 5120, bf, 2e-2)
    results["swiglu_pixtral"] = check_swiglu(s_max, 14336, bf, 2e-2)
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
    # the zoo's GQA prefills at D = 128 (groups of 3, 12, 16 and 5 query
    # heads a kv head): phi4-mini, command-r-plus, qwen3-moe, llama4-scout
    for heads, kv in ((24, 8), (96, 8), (64, 4), (40, 8)):
        check_flash(s_max, heads, kv, 128, bf, 2e-2)
    # MLA's q/k width (V padded to it): minicpm3-4b's prefill, D = 96 padded
    # to 128 (phase 21; its own row), and its smoke size, D = 24 padded to 64
    results["flash_attention_mla"] = check_flash(s_max, 40, 40, 96, bf, 2e-2)
    check_flash(130, 4, 4, 24, bf, 2e-2)
    # hubert-xlarge's encoder: no causal mask, D = 80 padded to 128, 1500
    # frames (a ragged last key tile, whose padded keys must score -inf);
    # pixtral-12b's prefill, 32 query heads on 8 kv heads: rows of their own
    results["flash_attention_hubert"] = check_flash(HUBERT_FRAMES, 16, 16, 80, bf, 2e-2,
                                                    b=HUBERT_CLIPS, causal=False)
    results["flash_attention_pixtral"] = check_flash(s_max, 32, 8, 128, bf, 2e-2)
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

    def check_swiglu_bwd(rows, width, dtype, tol, lead=()):
        shape = (*lead, rows, width)
        g, u, dh = (randn(*shape, dtype=dtype) for _ in range(3))
        n = math.prod(shape)
        lib = autograd_bwd(lambda g, u: F.silu(g) * u, (g, u), dh)
        return check("swiglu_bwd", str(shape), dtype, swiglu_ops.swiglu_bwd,
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
    results["rmsnorm_bwd_hubert"] = check_rms_bwd(n_frames, 1280, bf, 2e-2)
    results["swiglu_bwd"] = check_swiglu_bwd(n_tok, ff, bf, 2e-2)
    check_swiglu_bwd(n_tok, ff, f32, 1e-5)
    check_swiglu_bwd(128, 1536, bf, 2e-2, lead=(128,))  # qwen3-moe's expert buffer
    results["swiglu_bwd_hubert"] = check_swiglu_bwd(n_frames, 5120, bf, 2e-2)
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
    check_flash_bwd(1, s_max, 40, 40, 96, bf, 2e-2)  # MLA, minicpm3-4b and its smoke size
    check_flash_bwd(1, 130, 4, 4, 24, bf, 2e-2)
    # hubert-xlarge: no causal mask, D = 80, 1500 frames; padded keys add
    # nothing to dQ, dK or dV, and the repeat gives the same bits
    results["flash_attention_bwd_hubert"] = check_flash_bwd(HUBERT_CLIPS, HUBERT_FRAMES, 16, 16, 80, bf,
                                                            2e-2, causal=False)
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
    # the grid trainer's comparator on non-finite leaves: card verdicts == CPU
    # verdicts, beside 16384 rows of the embedding gradient: 3 bad elements
    # of 16.8M fall between the fractions as of the whole leaf, and the
    # sixteen CPU verdicts over the whole leaf cost half a minute
    small = randn(1000, dtype=f32)
    qe = qa[:16384]
    cases = {"nan": float("nan"), "inf": float("inf")}
    for label, val in cases.items():
        bad_leaf = small.clone()
        bad_leaf[:3] = val
        for ta, tb in (({"e": qe, "x": bad_leaf}, {"e": qe, "x": small}),
                       ({"e": qe, "x": bad_leaf}, {"e": qe, "x": bad_leaf.clone()})):
            for frac in (0.0, 1e-9, 1e-8, 1e-6):
                cmp = grad_comparator(max_bad_fraction=frac)
                got = cmp({"grads": ta}, {"grads": tb})
                want = cmp({"grads": tree_map(lambda t: t.cpu(), ta)},
                           {"grads": tree_map(lambda t: t.cpu(), tb)})
                if got != want:
                    raise AssertionError(f"grad_comparator on a {label} leaf: card {got}, cpu {want}")
    log(f"[2] quorum_compare: {n_bad} bad of {n_q} (32 planted); grad_comparator verdicts on "
        f"NaN and inf leaves equal the CPU's")
    del qa, qb, qe

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
    def serve_full_width(tag, cfg, rng, implied, exact=(), keep_f32=True, then=None):
        """Serve N_REQUESTS requests of 64-700 prompt tokens (the first 700),
        MAX_NEW new tokens each, EDF deadlines, through ``BatchServer`` at
        full width from random weights (bf16 compute). Every counter is
        zeroed just before the run and read just after: each forward kernel
        must show at least ``implied(forwards)[name]`` launches (exactly
        that many for the names in ``exact``; none where that is 0), and no
        backward, quorum, int8 or wide-D flash kernel may run. Then one
        700-token prefill and one decode step under torch.profiler; then
        ``then(server)``, where given. Returns the forward kernels' launches
        and the f32 parameters (None without ``keep_f32``: the server takes
        the f32 tree leaf by leaf, so it and the compute copy are never both
        whole)."""
        # earlier phases leave device tensors in reference cycles (the grid
        # trainer's store): free them, so that the peak memory is this run's
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        params = init_params(gen, model_spec(cfg), device=dev)  # f32
        torch.cuda.synchronize()
        init_peak = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        server = BatchServer(cfg, params, batch_slots=SLOTS, max_seq=MAX_SEQ,
                             take_params=not keep_f32)
        torch.cuda.synchronize()
        log(f"[{tag}] params {cfg.param_count()} ({time.perf_counter() - t:.2f} s to init and cast); "
            f"memory allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB; peak GiB while "
            f"drawing the f32 tree {init_peak:.2f}, while the server casts it "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
        if not keep_f32:
            params = None  # emptied by the server
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
            if launches[name] < want or ((want == 0 or name in exact) and launches[name] != want):
                implies = 'none' if want == 0 else f"{'exactly' if name in exact else 'at least'} {want}"
                raise AssertionError(f"{name}: {launches[name]} launches on the serving path, "
                                     f"the path implies {implies}")
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
        del one, batch_cache
        if then is not None:
            then(server)
        del server
        torch.cuda.empty_cache()
        return launches, params

    def logits_card_vs_cpu(tag, cfg32, params, prompt, tol, kernels):
        """The card's f32 prefill logits of ``prompt`` (tokens (S,), or
        embeddings (S, d) of a vlm; through the kernels, each of
        ``kernels`` launched) against the port's CPU forward (plain
        versions) from the same parameters: max abs error within ``tol`` and
        the same argmax."""
        step32 = make_prefill_step(cfg32)
        before = counts()
        n = len(prompt)
        key = "embeds" if prompt.is_floating_point() else "tokens"
        gpu_logits, _ = step32(params, {key: prompt[None].to(dev)}, init_cache(cfg32, 1, n))
        torch.cuda.synchronize()
        after = counts()
        skipped = [k for k in kernels if after[k] <= before[k]]
        if skipped:
            raise AssertionError(f"the f32 prefill skipped {skipped}")
        cpu_params = tree_map(lambda t: t.cpu(), params)
        cpu_logits, _ = step32(cpu_params, {key: prompt[None]}, init_cache(cfg32, 1, n, "cpu"))
        g, c = gpu_logits[0, -1, : cfg32.vocab].cpu(), cpu_logits[0, -1, : cfg32.vocab]
        assert torch.isfinite(g).all() and g.shape == (cfg32.vocab,)
        err = (g - c).abs().max().item()
        log(f"[{tag}] {cfg32.name} ({cfg32.n_layers} layers) f32 prefill logits from {key}, card vs "
            f"CPU: max abs "
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

    def grid_train(tag, cfg, required, idle_kernels, seq=TRAIN_SEQ):
        """Train ``cfg`` at full width through ``GridTrainer``: TRAIN_STEPS
        steps of TRAIN_SHARDS shards x TRAIN_BATCH x ``seq`` positions
        (tokens, or a frontend's embeddings), 8 hosts, 5% erroneous, 15%
        malicious. Every counter is zeroed just
        before and read just after: each of ``required`` must be non-zero,
        each of ``idle_kernels`` zero; no wrong gradient may be accepted.
        Then one grad job under torch.profiler. Returns the run's launches
        and ``job_profile``'s result for the profiled job."""
        reset_ids()
        data_cfg = DataConfig(vocab=cfg.vocab, seq_len=seq, batch_size=TRAIN_BATCH,
                              n_shards=TRAIN_SHARDS, seed=SEED, input_mode=cfg.input_mode,
                              d_model=cfg.d_model)
        t = time.perf_counter()
        trainer = GridTrainer(cfg, data_cfg,
                              AdamWConfig(lr=1e-4, warmup_steps=1, total_steps=TRAIN_STEPS),
                              n_steps=TRAIN_STEPS, n_hosts=8, seed=SEED, error_prob=0.05,
                              malicious_fraction=0.15, availability=0.9)
        torch.cuda.synchronize()
        log(f"[{tag}] GridTrainer {cfg.name} (remat={cfg.remat}, compute {cfg.dtype}), {TRAIN_STEPS} steps "
            f"x {TRAIN_SHARDS} shards x ({TRAIN_BATCH} x {seq}) {cfg.input_mode}, 8 hosts; set up in "
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
        batch = {k: torch.from_numpy(v.astype(np.int64) if v.dtype.kind == "i" else v).to(dev)
                 for k, v in make_batch(data_cfg, 0, 0).items()}
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
        """One f32 grad step of ``cfg32`` on 1 x 256 tokens (or frontend
        embeddings) on the card
        (each of ``required_bwd`` launched) against the CPU's from the same
        parameters: the loss to 1e-4 and per leaf |card - cpu| <= 1e-3 |cpu|
        + leaf_atol max|cpu| with leaf_rtol = 1e-3. Returns the step's launches."""
        p32 = init_params(torch.Generator(device=dev).manual_seed(seed), model_spec(cfg32), device=dev)
        toks = rng.integers(0, cfg32.vocab, size=(1, 257))
        b32 = {"tokens": torch.as_tensor(toks[:, :-1]), "labels": torch.as_tensor(toks[:, 1:])}
        if cfg32.input_mode == "embeds":
            b32["embeds"] = torch.as_tensor(rng.standard_normal((1, 256, cfg32.d_model)),
                                            dtype=torch.float32)
            del b32["tokens"]
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

    # ---- 17-21. serve the rest of the decoder zoo at full width ------------
    def serve_and_check(tag, cfg, depth, cpu_depth, implied, exact, kernels):
        """Serve ``cfg`` cut to ``depth`` layers (its widths published) with
        phase 3's traffic, the f32 tree dropped before serving; then its f32
        prefill logits on the card against the CPU's at ``cpu_depth`` layers
        (fresh parameters). Returns the serving run's launches."""
        served = cfg.scaled(n_layers=depth)
        log(f"[{tag}] {cfg.name}: {depth} of {cfg.n_layers} layers, d={cfg.d_model}, "
            f"{cfg.n_heads}/{cfg.n_kv_heads} heads, attention {cfg.attention}, family {cfg.family}"
            + (f", {cfg.n_experts} experts top-{cfg.top_k} of d_expert {cfg.d_expert}"
               + (f" + {cfg.n_shared_experts} shared" if cfg.n_shared_experts else "")
               if cfg.family == "moe" else f", d_ff {cfg.d_ff}")
            + f", vocab {cfg.vocab} (padded {cfg.padded_vocab}), rope_theta {cfg.rope_theta}, "
              f"compute {cfg.dtype}")
        rng = np.random.default_rng(SEED + int(tag))
        launches, _ = serve_full_width(tag, served, rng, implied(depth), exact=exact, keep_f32=False)
        gc.collect()
        torch.cuda.empty_cache()
        cut = cfg.scaled(n_layers=cpu_depth, dtype=torch.float32)
        params = init_params(gen, model_spec(cut), device=dev)
        prompt = torch.as_tensor(rng.integers(0, cfg.vocab, size=64), dtype=torch.long)
        logits_card_vs_cpu(tag, cut, params, prompt, 1e-3, kernels)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        return launches

    zoo = {}
    # phi4-mini-3.8b: all 32 layers; dense GQA without qk-norm
    zoo["phi4-mini-3.8b"] = serve_and_check(
        "17", get_config("phi4-mini-3.8b"), 32, 2,
        lambda n: lambda f: {"rmsnorm": (2 * n + 1) * f, "swiglu": n * f,
                             "flash_attention": n * N_REQUESTS, "ssd_scan": 0},
        ("swiglu",), list(ops))
    # command-r-plus-104b: 2 of 64 layers (d = 12288, d_ff = 33792)
    zoo["command-r-plus-104b"] = serve_and_check(
        "18", get_config("command-r-plus-104b"), 2, 1,
        lambda n: lambda f: {"rmsnorm": (2 * n + 1) * f, "swiglu": n * f,
                             "flash_attention": n * N_REQUESTS, "ssd_scan": 0},
        ("swiglu",), list(ops))
    # qwen3-moe-235b-a22b: 2 of 94 layers; qk-norm; one swiglu a layer, the
    # experts' (so exactly n per forward: every launch is on the expert buffer)
    qmoe = get_config("qwen3-moe-235b-a22b")
    mcfg_q = moe_config(qmoe)
    for label, tokens in (("a 700-token prefill", s_max), ("a 4-slot decode step", SLOTS)):
        n_assign = tokens * mcfg_q.top_k
        blocks, cap_block = dispatch_shape(tokens, mcfg_q)
        cap = cap_block * blocks
        log(f"[19] {label}: {n_assign} assignments in {blocks} dispatch blocks, capacity {cap}: "
            f"the experts run over {mcfg_q.n_experts} x {cap} = {mcfg_q.n_experts * cap} rows "
            f"for {tokens} tokens")
    zoo["qwen3-moe-235b-a22b"] = serve_and_check(
        "19", qmoe, 2, 1,
        lambda n: lambda f: {"rmsnorm": (4 * n + 1) * f, "swiglu": n * f,
                             "flash_attention": n * N_REQUESTS, "ssd_scan": 0},
        ("swiglu",), list(ops))
    # llama4-scout-17b-a16e: 2 of 48 layers; 16 experts top-1 and a shared
    # expert: two swiglu launches a layer
    zoo["llama4-scout-17b-a16e"] = serve_and_check(
        "20", get_config("llama4-scout-17b-a16e"), 2, 1,
        lambda n: lambda f: {"rmsnorm": (2 * n + 1) * f, "swiglu": 2 * n * f,
                             "flash_attention": n * N_REQUESTS, "ssd_scan": 0},
        ("swiglu",), list(ops))
    # minicpm3-4b: all 62 layers; MLA, its only attention at D = 96 (so
    # every flash launch is at D = 96); rmsnorm on the model width and both
    # latents (768, 256)
    zoo["minicpm3-4b"] = serve_and_check(
        "21", get_config("minicpm3-4b"), 62, 2,
        lambda n: lambda f: {"rmsnorm": (4 * n + 1) * f, "swiglu": n * f,
                             "flash_attention": n * N_REQUESTS, "ssd_scan": 0},
        ("swiglu", "rmsnorm"), list(ops))

    # ---- 22. MoE and MLA grad steps: card against CPU, and repeats ---------
    rng = np.random.default_rng(SEED + 22)
    zoo_grad = {}
    for i, arch in enumerate(("qwen3-moe-235b-a22b", "llama4-scout-17b-a16e", "minicpm3-4b")):
        smoke = get_smoke_config(arch)
        zoo_grad[arch] = grad_card_vs_cpu("22", smoke.scaled(dtype=torch.float32),
                                          ("rmsnorm_bwd", "swiglu_bwd", "flash_attention_bwd"),
                                          SEED + 22 + i)
        # bf16: the same bits on a repeat (the gradient quorum compares replicas)
        p_bf = init_params(torch.Generator(device=dev).manual_seed(SEED + 22 + i), model_spec(smoke),
                           device=dev)
        toks = torch.as_tensor(rng.integers(0, smoke.vocab, size=(2, 257)), device=dev)
        b_bf = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        step_bf = make_grad_step(smoke)
        (g1, m1), (g2, m2) = step_bf(p_bf, b_bf), step_bf(p_bf, b_bf)
        same = all(torch.equal(a, b) for a, b in zip(tree_leaves(g1), tree_leaves(g2)))
        log(f"[22] {smoke.name} bf16 grad step (2 x 256 tokens): loss {float(m1['loss']):.6f} aux "
            f"{float(m1['aux']):.6f}; a repeat gives the same bits: {same}")
        if not same or not torch.equal(m1["loss"], m2["loss"]) or not torch.isfinite(m1["loss"]):
            raise AssertionError(f"{smoke.name}: the bf16 grad step does not repeat bit for bit")
        del p_bf, g1, g2

    # ---- 23. the remat policies: the same bits, what each keeps ------------
    def remat_policies(tag, cfg):
        """One bf16 grad step of ``cfg`` (remat on) on TRAIN_BATCH x
        TRAIN_SEQ tokens under each policy: the grads bit-equal across the
        three; each policy's peak memory and one profiled step's busy time."""
        p = init_params(torch.Generator(device=dev).manual_seed(SEED + 23), model_spec(cfg), device=dev)
        data = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ, batch_size=TRAIN_BATCH, n_shards=1,
                          seed=SEED)
        b = {k: torch.from_numpy(v.astype(np.int64)).to(dev) for k, v in make_batch(data, 0, 0).items()}
        first = None
        peaks = {}
        for policy in ("nothing", "dots_nb", "dots"):
            step = make_grad_step(cfg.scaled(remat=True, remat_policy=policy))
            step(p, b)  # warm-up: allocator, cuBLAS handles
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            grads, m = step(p, b)
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - base) / 2**30
            peaks[policy] = round(peak, 3)
            leaves = tree_leaves(grads)
            if first is None:
                first = (m["loss"], leaves)
            elif not torch.equal(m["loss"], first[0]) or not all(
                    torch.equal(x, y) for x, y in zip(leaves, first[1])):
                raise AssertionError(f"{cfg.name}: remat_policy {policy} changed the gradients")
            del grads, leaves  # one gradient tree besides the first's while profiling
            dev_us, _ = profile_breakdown(lambda: step(p, b), f"[{tag}] {cfg.name} {policy}", top=3)
            busy = sum(dev_us.values()) / 1e3 if dev_us else None
            log(f"[{tag}] {cfg.name} ({cfg.n_layers} layers) remat_policy {policy}: loss "
                f"{float(m['loss']):.6f}, peak above the params {peak:.3f} GiB, busy "
                f"{'not measured' if busy is None else f'{busy:.3f} ms'}")
        log(f"[{tag}] {cfg.name}: the three policies give the same bits")
        del p, b, first
        gc.collect()
        torch.cuda.empty_cache()
        return peaks

    # qwen3 at 2 layers, where the step is mostly the 152k-vocab CE, and at
    # all 28, where the layers' products weigh; qwen3-moe at smoke width and
    # at full width cut to 1 of 94 layers, where "dots" also keeps the
    # experts' bmm outputs (its f32 parameters and two gradient trees, ≈ 15
    # GB each, leave no room for a second layer)
    for remat_cfg in (cfg.scaled(n_layers=2), cfg, get_smoke_config("qwen3-moe-235b-a22b"),
                      qmoe.scaled(n_layers=1)):
        peaks = remat_policies("23", remat_cfg)
        if remat_cfg is cfg:
            remat_peaks = peaks  # qwen3-0.6b at all 28 layers, for phase 28

    # ---- 24. hubert-xlarge: the encoder, a grid run, f32 checks ------------
    t_phase = time.perf_counter()
    hcfg = get_config("hubert-xlarge")
    Lh = hcfg.n_layers
    log(f"[24] {hcfg.name}: all {Lh} layers, d={hcfg.d_model}, {hcfg.n_heads}/{hcfg.n_kv_heads} heads "
        f"of {hcfg.resolved_head_dim}, d_ff {hcfg.d_ff}, vocab {hcfg.vocab} (padded "
        f"{hcfg.padded_vocab}), encoder_only {hcfg.encoder_only} (causal {hcfg.causal}), input_mode "
        f"{hcfg.input_mode}, compute {hcfg.dtype}")
    gc.collect()
    torch.cuda.empty_cache()
    params = init_params(gen, model_spec(hcfg), device=dev)  # f32
    clips = {"embeds": frontends.frame_embeddings(gen, HUBERT_CLIPS, HUBERT_FRAMES, hcfg.d_model,
                                                  device=dev)}
    encode = make_encoder_step(hcfg)
    encode(params, clips)  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t = time.perf_counter()
    logits = encode(params, clips)
    torch.cuda.synchronize()
    enc_ms = (time.perf_counter() - t) * 1e3
    enc_launches = counts()
    want = {**{k: 0 for k in enc_launches}, "rmsnorm": 2 * Lh + 1, "swiglu": Lh, "flash_attention": Lh}
    log(f"[24] encoder over {HUBERT_CLIPS} x {HUBERT_FRAMES} frames: {enc_ms:.3f} ms wall, logits "
        f"{tuple(logits.shape)}, peak_mem_gib {torch.cuda.max_memory_allocated() / 2**30:.2f}; "
        f"launches {json.dumps(enc_launches)}")
    if enc_launches != want:
        raise AssertionError(f"the encoder launched {enc_launches}; its path implies {want}")
    if (tuple(logits.shape) != (HUBERT_CLIPS, HUBERT_FRAMES, hcfg.padded_vocab)
            or not torch.isfinite(logits).all()):
        raise AssertionError(f"encoder logits of shape {tuple(logits.shape)}, or not finite")
    dev_us, _ = profile_breakdown(lambda: encode(params, clips), "[24] encoder", top=8)
    check_flash_profile(dev_us, MMA_FLASH[:1], "[24] encoder")
    del params, clips, logits
    # f32 encoder logits at every one of 150 frames, card (kernels) against
    # CPU (plain versions), at 2 layers
    h32 = hcfg.scaled(n_layers=2, dtype=torch.float32)
    params = init_params(gen, model_spec(h32), device=dev)
    frames = frontends.frame_embeddings(gen, 1, 150, h32.d_model, torch.float32, dev)
    encode32 = make_encoder_step(h32)
    before = flash_ops.launches
    card = encode32(params, {"embeds": frames})[..., : h32.vocab].cpu()
    if flash_ops.launches - before != h32.n_layers:
        raise AssertionError("the f32 encoder skipped the flash kernel")
    cpu = encode32(tree_map(lambda t: t.cpu(), params), {"embeds": frames.cpu()})[..., : h32.vocab]
    err = (card - cpu).abs().max().item()
    same = bool((card.argmax(-1) == cpu.argmax(-1)).all())
    log(f"[24] {h32.name} ({h32.n_layers} layers) f32 encoder logits of 150 frames, card vs CPU: max abs "
        f"err {err:.3e} (tol 1e-3, |logit| max {cpu.abs().max().item():.3f}); argmax equal at every "
        f"frame: {same}")
    if err > 1e-3 or not same or not torch.isfinite(card).all():
        raise AssertionError(f"{h32.name}: f32 encoder logits card vs CPU differ by {err}")
    del params, frames
    # the grid run: 2 shards of 2 clips of 1500 frames a step
    hubert_train_launches, (dev_us, _, _) = grid_train(
        "24", hcfg, (*ops, *bwd_ops, "quorum_compare"), ("ssd_scan", "ssd_scan_bwd", *WIDE),
        seq=HUBERT_FRAMES)
    check_flash_profile(dev_us, MMA_FLASH, "[24] grad job")
    grad_card_vs_cpu("24", get_smoke_config("hubert-xlarge").scaled(dtype=torch.float32),
                     ("rmsnorm_bwd", "swiglu_bwd", "flash_attention_bwd"), SEED + 24)
    log(f"[24] phase wall {time.perf_counter() - t_phase:.1f} s")

    # ---- 25. pixtral-12b: patch embeddings prefilled, text decoded, served --
    t_phase = time.perf_counter()
    pcfg = get_config("pixtral-12b")
    Lp = pcfg.n_layers
    log(f"[25] {pcfg.name}: all {Lp} layers, d={pcfg.d_model}, {pcfg.n_heads}/{pcfg.n_kv_heads} heads "
        f"of {pcfg.resolved_head_dim}, d_ff {pcfg.d_ff}, vocab {pcfg.vocab} (padded {pcfg.padded_vocab}), "
        f"rope_theta {pcfg.rope_theta}, input_mode {pcfg.input_mode}, compute {pcfg.dtype}")
    vlm = {}

    def vlm_path(server):
        """Prefill (1, 700, d) patch embeddings through ``make_prefill_step``
        from the server's bf16 parameters, then MAX_NEW greedy decode steps
        from token ids: launches exact, wall times, peak memory; then the
        prefill and one decode step profiled (busy time, idle share)."""
        emb = frontends.patch_embeddings(gen, 1, s_max, pcfg.d_model, device=dev)
        prefill, decode = make_prefill_step(pcfg), make_decode_step(pcfg)
        cache = init_cache(pcfg, 1, MAX_SEQ)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t = time.perf_counter()
        logits, cache = prefill(server.params, {"embeds": emb}, cache)
        tok = logits[:, -1, : pcfg.vocab].argmax(-1, keepdim=True)
        out = [int(tok)]
        prefill_ms = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        for i in range(MAX_NEW):
            logits, cache = decode(server.params, tok, cache, s_max + i)
            tok = logits[:, -1, : pcfg.vocab].argmax(-1, keepdim=True)
            out.append(int(tok))
        decode_ms = (time.perf_counter() - t) * 1e3 / MAX_NEW
        vlm["launches"] = counts()
        forwards = 1 + MAX_NEW
        want = {**{k: 0 for k in vlm["launches"]}, "rmsnorm": (2 * Lp + 1) * forwards,
                "swiglu": Lp * forwards, "flash_attention": Lp}  # decode bypasses flash
        log(f"[25] vlm path: prefill of (1, {s_max}, {pcfg.d_model}) patch embeddings {prefill_ms:.3f} ms, "
            f"{MAX_NEW} greedy decode steps {decode_ms:.3f} ms each, peak_mem_gib "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f}; tokens {out}; launches "
            f"{json.dumps(vlm['launches'])}")
        if vlm["launches"] != want:
            raise AssertionError(f"the vlm path launched {vlm['launches']}; it implies {want}")
        if not all(0 <= x < pcfg.vocab for x in out):
            raise AssertionError(f"decoded tokens out of the vocabulary: {out}")
        steps = (("prefill 700 embeds", lambda: prefill(server.params, {"embeds": emb}, cache)),
                 ("decode x1", lambda: decode(server.params, tok, cache, s_max + MAX_NEW)))
        for label, step in steps:
            dev_us, _ = profile_breakdown(step, f"[25] {label}", top=8)
            check_flash_profile(dev_us, MMA_FLASH[:1] if label.startswith("prefill") else (),
                                f"[25] {label}")

    # the server takes the f32 tree leaf by leaf (46.3 GB f32, 23.2 GB bf16)
    pixtral_launches, _ = serve_full_width(
        "25", pcfg, np.random.default_rng(SEED + 25),
        lambda f: {"rmsnorm": (2 * Lp + 1) * f, "swiglu": Lp * f, "flash_attention": Lp * N_REQUESTS,
                   "ssd_scan": 0},
        exact=("swiglu", "rmsnorm"), keep_f32=False, then=vlm_path)
    gc.collect()
    torch.cuda.empty_cache()
    # f32 prefill logits from patch embeddings, card against CPU, 2 layers
    p32 = pcfg.scaled(n_layers=2, dtype=torch.float32)
    params = init_params(gen, model_spec(p32), device=dev)
    patches = torch.randn((64, p32.d_model), generator=torch.Generator().manual_seed(SEED + 25))
    logits_card_vs_cpu("25", p32, params, patches, 1e-3, list(ops))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[25] phase wall {time.perf_counter() - t_phase:.1f} s")

    # ---- 26. the BOINC engines on the card ---------------------------------
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    (results["quorum_compare_digest"], engine_launches, results["quorum_pair_counts"],
     pair_launches) = engines_phase(dev, check, quorum_ops, quorum_compare_ref)
    log(f"[26] phase wall {time.perf_counter() - t_phase:.1f} s")

    # ---- 27. the scheduler service on the card -----------------------------
    gc.collect()
    torch.cuda.empty_cache()
    service_phase(dev, counts, zero_counts, smi)

    # ---- 28. the dry run and the roofline, held against real steps ---------
    gc.collect()
    torch.cuda.empty_cache()
    dryrun_phase(dev, counts, zero_counts, smi, remat_peaks)

    # ---- 29. the sharded train step on a simulated (4, 2) mesh --------------
    gc.collect()
    torch.cuda.empty_cache()
    sharded_launches, _ = sharded_phase(dev, counts, zero_counts, smi)

    # ---- result lines ------------------------------------------------------
    # each row's TPU kernel and CUDA source, from the kernel its name starts
    # with; the backward rows name their forward's TPU kernel (the reference
    # differentiates its jnp functions with XLA: no TPU backward kernels)
    replaces = {
        "rmsnorm": "src/repro/kernels/rmsnorm/kernel.py:17",
        "swiglu": "src/repro/kernels/swiglu/kernel.py:12",
        "flash_attention": "src/repro/kernels/flash_attention/kernel.py:30",
        "quorum_compare": "src/repro/kernels/quorum_compare/kernel.py:21",
        "quorum_pair_counts": "src/repro/kernels/quorum_compare/kernel.py:21",
        "int8_quantize": "src/repro/kernels/int8_quant/kernel.py:19",
        "int8_dequantize": "src/repro/kernels/int8_quant/kernel.py:28",
        "ssd_scan": "src/repro/kernels/ssd_scan/kernel.py:26",
    }
    sources = {"int8_quantize": "int8_quant", "int8_dequantize": "int8_quant",
               "quorum_pair_counts": "quorum_compare"}

    def kernel_of(name):
        return next(k for k in replaces if name.startswith(k))

    main_launches = {**train_launches, "int8_quantize": comp_launches["int8_quantize"],
                     "int8_dequantize": comp_launches["int8_dequantize"],
                     "ssd_scan": mamba_launches["ssd_scan"],
                     "ssd_scan_bwd": mamba_train_launches["ssd_scan_bwd"],
                     # f32 rows: the f32 grad step's launches (phase 6)
                     "flash_attention_f32": f32_launches["flash_attention"],
                     "flash_attention_bwd_f32": f32_launches["flash_attention_bwd"],
                     "flash_attention_mla": zoo["minicpm3-4b"]["flash_attention"],
                     "swiglu_moe": zoo["qwen3-moe-235b-a22b"]["swiglu"],
                     # the wide-D rows: the grid training run's (0; every main path checks 0)
                     **{n: train_launches[n.replace("_f32", "")] for n in results if "wide" in n},
                     # the frontends' rows: hubert-xlarge's grid run (phase 24) and
                     # pixtral-12b's serving run (phase 25)
                     **{n: hubert_train_launches[n.replace("_hubert", "")] for n in results
                        if n.endswith("_hubert")},
                     **{n: pixtral_launches[n.replace("_pixtral", "")] for n in results
                        if n.endswith("_pixtral")},
                     # the validation engine's digests of the tensor-payload run (phase 26):
                     # the pair-count kernel's, and the pairwise kernel's (none)
                     "quorum_compare_digest": engine_launches,
                     "quorum_pair_counts": pair_launches}
    kernels = []
    for name, rec in results.items():
        base, kernel = name.replace("_f32", ""), kernel_of(name)
        row = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{sources.get(kernel, kernel)}.cu",
            "replaces": replaces[kernel], "launches": main_launches[name],
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
            row["launches_sharded"] = sharded_launches[name]  # phase 29, on the ranks' local shards
        if name in ops:
            row["launches_serve_zoo"] = {arch: zoo[arch][name] for arch in zoo}
        if name == "flash_attention_mla":
            row["launches_in"] = "phase 21, serving minicpm3-4b (its only attention, D = 96)"
        if name == "swiglu_moe":
            row["launches_in"] = "phase 19, serving qwen3-moe-235b-a22b (one swiglu a layer, the experts')"
            row["launches_serve_llama4"] = zoo["llama4-scout-17b-a16e"]["swiglu"]
        if name.endswith("_f32"):
            row["launches_in"] = "phase 6, the f32 grad step"
        if "wide" in name:
            row["launches_in"] = ("phase 5; every main path (phases 3, 5, 7, 9, 11, 13, 15, 16, "
                                  "17-21, 24, 25) launched none")
        if name.endswith("_hubert"):
            row["launches_in"] = ("phase 24, training hubert-xlarge (every flash launch non-causal at "
                                  "D = 80; 2 x 1500 frames a grad job)")
            if "_bwd" not in name:
                row["launches_encoder"] = enc_launches[name.replace("_hubert", "")]
        if name.endswith("_pixtral"):
            row["launches_in"] = "phase 25, serving pixtral-12b from token prompts"
            row["launches_vlm_path"] = vlm["launches"][name.replace("_pixtral", "")]
        if name == "quorum_compare":
            row["launches_engines"] = engine_launches
        if name == "quorum_compare_digest":
            row["launches_in"] = ("phase 26, the validation engine's digests of 4096-element "
                                  "payloads on the torch engines (they go through "
                                  "quorum_pair_counts)")
        if name == "quorum_pair_counts":
            row["kernel"] = rec["kernels"]  # the tiled kernel and the slices' sum, as timed
            row["events_ms"] = rec["events_ms"]
            row["launches_in"] = ("phase 26, the validation engine's digests of 4096-element "
                                  "payloads on the torch engines, one launch a digest call")
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
    log(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
