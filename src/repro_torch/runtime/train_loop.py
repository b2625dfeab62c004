"""Single-process training driver; counterpart of ``repro.runtime.train_loop``.

The volunteer-grid (asynchronous, fault-tolerant) driver lives in
``grid_runtime.py``; this loop is what each *worker* runs internally.
Checkpoint/restart follows the paper's request/ack protocol
(``checkpoint/checkpointer.py``), in the reference's on-disk format, so a
run of either package resumes from the other's checkpoint.

Beside the reference's signature, ``params`` takes explicit initial
parameters (any tree of tensors or arrays shaped like ``model_spec(cfg)``;
copied) and ``device`` the device to train on. Without ``params`` they are
drawn from a generator on the device seeded with ``seed``, so they match
the reference's ``jax.random`` draws in distribution only.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import Checkpointer, CheckpointPolicy
from repro_torch.data.pipeline import DataConfig, global_batch
from repro_torch.device import Device, resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import init_params, tree_map
from repro_torch.models.transformer import model_spec
from repro_torch.optim.adamw import AdamWConfig, init_state
from repro_torch.runtime.step_builder import make_train_step


@dataclass
class TrainResult:
    steps: int
    losses: List[float]
    wall_time: float
    restored_from: Optional[int] = None
    # host seconds of each step, ending in the read of its loss (which waits
    # for the device), of each checkpoint save, and of the restore
    step_seconds: List[float] = field(default_factory=list)
    save_seconds: List[float] = field(default_factory=list)
    restore_seconds: Optional[float] = None

    @property
    def final_loss(self) -> float:
        return self.losses[-1] if self.losses else float("nan")


def train(
    cfg: ModelConfig,
    data_cfg: DataConfig,
    opt_cfg: AdamWConfig,
    steps: int,
    seed: int = 0,
    checkpoint_dir: Optional[str] = None,
    checkpoint_period: int = 50,
    log_every: int = 10,
    log_fn: Callable[[str], None] = print,
    resume: bool = True,
    *,
    params: Optional[Any] = None,
    device: Device = "cuda",
) -> TrainResult:
    dev = resolve_device(device)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = init_params(gen, model_spec(cfg), cfg.param_dtype, dev)
    else:
        params = tree_map(
            lambda t: torch.as_tensor(t).to(device=dev, dtype=cfg.param_dtype).clone(), params
        )
    opt_state = init_state(params)
    start_step = 0
    restored = None
    restore_s = None

    ckpt = Checkpointer(checkpoint_dir) if checkpoint_dir else None
    policy = CheckpointPolicy(period_steps=checkpoint_period)
    if ckpt is not None and resume and ckpt.latest_step() is not None:
        t = time.perf_counter()
        start_step, trees = ckpt.restore({"params": params, "opt": opt_state})
        params, opt_state = trees["params"], trees["opt"]
        restore_s = time.perf_counter() - t
        restored = start_step
        log_fn(f"[train] restored checkpoint at step {start_step}")

    step_fn = make_train_step(cfg, opt_cfg)
    losses: List[float] = []
    step_s: List[float] = []
    save_s: List[float] = []
    t0 = time.time()
    for step in range(start_step, steps):
        t = time.perf_counter()
        batch_np = global_batch(data_cfg, step)
        batch = {k: torch.from_numpy(v.astype(np.int64) if v.dtype.kind == "i" else v).to(dev)
                 for k, v in batch_np.items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        step_s.append(time.perf_counter() - t)
        losses.append(loss)
        if log_every and (step % log_every == 0 or step == steps - 1):
            log_fn(
                f"[train] step={step} loss={loss:.4f} "
                f"gnorm={float(metrics['grad_norm']):.3f} lr={float(metrics['lr']):.2e}"
            )
        if ckpt is not None and policy.should_checkpoint(step + 1):
            # masked section: checkpoint only at the step boundary (§3.6)
            t = time.perf_counter()
            ckpt.save(step + 1, {"params": params, "opt": opt_state})
            save_s.append(time.perf_counter() - t)
            policy.ack(step + 1)
    return TrainResult(
        steps=steps - start_step,
        losses=losses,
        wall_time=time.time() - t0,
        restored_from=restored,
        step_seconds=step_s,
        save_seconds=save_s,
        restore_seconds=restore_s,
    )
