"""AdamW with decoupled weight decay, global-norm clipping and LR schedules;
counterpart of ``repro.optim.adamw``.

The optimizer state is a tree shaped like the params (``mu``, ``nu``, f32)
plus the step count. ``apply_updates`` updates the parameters and both
moment trees **in place** (the reference returns new arrays; here that
saves two copies of every tree on the card) and returns them. The
reference runs this outside any Pallas kernel, and so does the port: plain
tensor ops, in f32, with the reference's order of operations. Scalars (the
learning rate, the bias corrections) are f32 tensors, as under ``jit``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.models.layers import tree_leaves, tree_map


class AdamWState(NamedTuple):
    count: int  # steps applied so far
    mu: Any  # first moments (tree like params)
    nu: Any  # second moments


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"  # cosine | wsd | constant
    final_lr_fraction: float = 0.1


def _f32(x: float, device: torch.device) -> torch.Tensor:
    return torch.full((), x, dtype=torch.float32, device=device)


def lr_at(cfg: AdamWConfig, step: int, device: torch.device = torch.device("cpu")) -> torch.Tensor:
    """The learning rate at ``step`` as an f32 scalar tensor."""
    s = _f32(step, device)
    warm = torch.clamp((s + 1.0) / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        decay = 1.0
    elif cfg.schedule == "wsd":  # warmup-stable-decay: linear tail 20%
        tail = 0.2 * cfg.total_steps
        into_tail = torch.clamp(s - (cfg.total_steps - tail), min=0.0)
        decay = 1.0 - (1.0 - cfg.final_lr_fraction) * torch.clamp(into_tail / tail, max=1.0)
    else:  # cosine
        frac = torch.clamp(s / max(cfg.total_steps, 1), 0.0, 1.0)
        decay = cfg.final_lr_fraction + (1.0 - cfg.final_lr_fraction) * 0.5 * (
            1.0 + torch.cos(math.pi * frac)
        )
    return cfg.lr * warm * decay


def init_state(params: Any) -> AdamWState:
    mu = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    nu = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    return AdamWState(count=0, mu=mu, nu=nu)


def global_norm(tree: Any) -> torch.Tensor:
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float())) for leaf in leaves))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads: Any, max_norm: float) -> Tuple[Any, torch.Tensor]:
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g * scale, grads), norm


@torch.no_grad()
def apply_updates(
    cfg: AdamWConfig,
    params: Any,
    grads: Any,
    state: AdamWState,
) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step. ``params``, ``state.mu`` and ``state.nu`` are updated
    in place and returned (with the new count); ``grads`` is left alone.

    ``count`` is incremented before the learning rate and the bias
    corrections are taken, as in the reference. Clipping scales each leaf
    as it is used (``clip_by_global_norm`` would hold a clipped copy of
    the whole tree)."""
    leaves_g = tree_leaves(grads)
    device = leaves_g[0].device
    gnorm = global_norm(grads)
    gscale = _clip_scale(gnorm, cfg.clip_norm) if cfg.clip_norm > 0 else None
    count = state.count + 1
    lr = lr_at(cfg, count, device)
    c = _f32(count, device)
    b1c = 1.0 - _f32(cfg.b1, device) ** c
    b2c = 1.0 - _f32(cfg.b2, device) ** c

    for p, g, m, v in zip(tree_leaves(params), leaves_g, tree_leaves(state.mu),
                          tree_leaves(state.nu)):
        g = g.float()
        if gscale is not None:
            g = g * gscale
        m.mul_(cfg.b1).add_((1.0 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1.0 - cfg.b2) * torch.square(g))
        step = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        p32 = p.float()
        p.copy_(p32 - lr * (step + cfg.weight_decay * p32))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, AdamWState(count=count, mu=state.mu, nu=state.nu), metrics
