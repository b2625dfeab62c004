"""Gradient, train, prefill and decode steps; counterpart of
``repro.runtime.step_builder``.

PyTorch runs eagerly, so a step is a plain function over (params, inputs,
cache); nothing is traced or compiled. The cache is updated in place and
returned. ``make_grad_step`` is the grid trainer's job body: gradients of
``train_loss`` for every parameter leaf, as a tree shaped like the params.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import tree_leaves, tree_unflatten, unembed_logits
from repro_torch.models.transformer import forward, train_loss
from repro_torch.optim.adamw import AdamWConfig, AdamWState, apply_updates


def make_grad_step(cfg: ModelConfig) -> Callable[..., Tuple[Any, Dict[str, torch.Tensor]]]:
    """Gradient-only step: ``(grads, {"loss", "ce", "aux"})``. The params are
    not modified; each gradient has its parameter's shape and dtype."""

    def grad_step(params: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        live = tree_unflatten(params, leaves)
        with torch.enable_grad():
            loss, parts = train_loss(live, cfg, batch)
            grads = torch.autograd.grad(loss, leaves)
        metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in parts.items()}}
        return tree_unflatten(params, list(grads)), metrics

    return grad_step


def make_train_step(
    cfg: ModelConfig, opt_cfg: AdamWConfig
) -> Callable[..., Tuple[Any, AdamWState, Dict[str, torch.Tensor]]]:
    """Gradient step then AdamW: ``(params, opt_state, metrics)``; the params
    and moments are updated in place (``optim.adamw.apply_updates``)."""
    grad_step = make_grad_step(cfg)

    def train_step(params: Dict[str, Any], opt_state: AdamWState, batch: Dict[str, torch.Tensor]):
        grads, metrics = grad_step(params, batch)
        new_params, new_opt, opt_metrics = apply_updates(opt_cfg, params, grads, opt_state)
        return new_params, new_opt, {**metrics, **opt_metrics}

    return train_step


def make_prefill_step(cfg: ModelConfig) -> Callable[..., Tuple[torch.Tensor, Any]]:
    @torch.no_grad()
    def prefill_step(params: Dict[str, Any], batch: Dict[str, torch.Tensor], cache: Any):
        hidden, new_cache, _ = forward(
            params, cfg, batch["tokens"], cache=cache, cache_index=0, return_hidden=True
        )
        # the reference unembeds every position and keeps the last; the rows
        # are independent, so unembedding the last one gives the same logits
        return unembed_logits(params["embed"], hidden[:, -1:, :]), new_cache

    return prefill_step


def make_decode_step(cfg: ModelConfig) -> Callable[..., Tuple[torch.Tensor, Any]]:
    @torch.no_grad()
    def decode_step(params: Dict[str, Any], tokens: torch.Tensor, cache: Any, index: int):
        logits, new_cache, _ = forward(params, cfg, tokens, cache=cache, cache_index=index)
        return logits, new_cache

    return decode_step
