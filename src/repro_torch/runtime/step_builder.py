"""Gradient, train, prefill, encoder and decode steps, and the inputs each
takes; counterpart of ``repro.runtime.step_builder``.

PyTorch runs eagerly, so a step is a plain function over (params, inputs,
cache); nothing is traced or compiled. The cache is updated in place and
returned. ``make_grad_step`` is the grid trainer's job body: gradients of
``train_loss`` for every parameter leaf, as a tree shaped like the params.
``input_specs`` gives ``(shape, dtype)`` for every input of a cell's step
kind, nested as the reference's ``ShapeDtypeStruct`` tree.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.models.layers import tree_leaves, tree_unflatten, unembed_logits
from repro_torch.models.transformer import cache_spec, forward, train_loss
from repro_torch.optim.adamw import AdamWConfig, AdamWState, apply_updates


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """``(shape, dtype)`` of every input of the step kind of ``shape``:
    ``labels`` and ``tokens`` (int32) or bf16 ``embeds`` for a train step;
    ``tokens`` or ``embeds``, and the decode cache where the arch decodes,
    for a prefill; one token a sequence, the cache and the index for a
    decode step."""
    b, s = shape.global_batch, shape.seq_len
    inputs: Dict[str, Any] = {}
    if cfg.input_mode == "embeds":
        inputs["embeds"] = ((b, s, cfg.d_model), torch.bfloat16)
    else:
        inputs["tokens"] = ((b, s), torch.int32)
    if shape.kind == "train":
        return {"batch": {"labels": ((b, s), torch.int32), **inputs}}
    if shape.kind == "prefill":
        out: Dict[str, Any] = {"batch": inputs}
        if cfg.has_decode:
            out["cache"] = cache_spec(cfg, b, s)
        return out
    if shape.kind == "decode":
        return {"tokens": ((b, 1), torch.int32), "cache": cache_spec(cfg, b, s),
                "index": ((), torch.int32)}
    raise ValueError(shape.kind)


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
    """Prefill of ``batch["tokens"]`` or ``batch["embeds"]`` (a vlm's patch
    embeddings) into ``cache`` from index 0: the last position's logits
    and the cache."""

    @torch.no_grad()
    def prefill_step(params: Dict[str, Any], batch: Dict[str, torch.Tensor], cache: Any):
        hidden, new_cache, _ = forward(
            params, cfg, tokens=batch.get("tokens"), embeds=batch.get("embeds"), cache=cache,
            cache_index=0, return_hidden=True
        )
        # the reference unembeds every position and keeps the last; the rows
        # are independent, so unembedding the last one gives the same logits
        return unembed_logits(params["embed"], hidden[:, -1:, :]), new_cache

    return prefill_step


def make_encoder_step(cfg: ModelConfig) -> Callable[..., torch.Tensor]:
    """Encoder-only forward (hubert): the logits (B, S, V_padded) of every
    position of ``batch["embeds"]`` (or ``batch["tokens"]``)."""

    @torch.no_grad()
    def encoder_step(params: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        logits, _, _ = forward(params, cfg, tokens=batch.get("tokens"), embeds=batch.get("embeds"))
        return logits

    return encoder_step


def make_decode_step(cfg: ModelConfig) -> Callable[..., Tuple[torch.Tensor, Any]]:
    @torch.no_grad()
    def decode_step(params: Dict[str, Any], tokens: torch.Tensor, cache: Any, index: int):
        logits, new_cache, _ = forward(params, cfg, tokens=tokens, cache=cache, cache_index=index)
        return logits, new_cache

    return decode_step
