"""Prefill and decode steps; counterpart of ``repro.runtime.step_builder``.

PyTorch runs eagerly, so a step is a plain function over (params, inputs,
cache); nothing is traced or compiled. The cache is updated in place and
returned.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import unembed_logits
from repro_torch.models.transformer import forward


def make_prefill_step(cfg: ModelConfig) -> Callable[..., Tuple[torch.Tensor, Any]]:
    @torch.no_grad()
    def prefill_step(params: Dict[str, Any], batch: Dict[str, torch.Tensor], cache: Any):
        hidden, new_cache = forward(
            params, cfg, batch["tokens"], cache=cache, cache_index=0, return_hidden=True
        )
        # the reference unembeds every position and keeps the last; the rows
        # are independent, so unembedding the last one gives the same logits
        return unembed_logits(params["embed"], hidden[:, -1:, :]), new_cache

    return prefill_step


def make_decode_step(cfg: ModelConfig) -> Callable[..., Tuple[torch.Tensor, Any]]:
    @torch.no_grad()
    def decode_step(params: Dict[str, Any], tokens: torch.Tensor, cache: Any, index: int):
        return forward(params, cfg, tokens, cache=cache, cache_index=index)

    return decode_step
