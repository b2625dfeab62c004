"""Modality frontend stubs; counterpart of ``repro.models.frontends``.

The ``[vlm]`` and ``[audio]`` archs specify the transformer backbone only:
training and prefill take precomputed patch or frame embeddings. These
stubs draw embeddings with the statistics a ViT patchifier or a HuBERT conv
feature encoder would give, so the models run end to end without image or
audio data. The reference draws with ``jax.random``, which torch cannot
reproduce: the draws here match the reference's in distribution only
(patches: mean 0, variance 1, no correlation between positions; frames:
mean 0, variance 0.5, lag-1 correlation 0.5 along the sequence).
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.device import Device, resolve_device


def _normal(generator: torch.Generator, shape: Tuple[int, ...], device: Device) -> torch.Tensor:
    # drawn on the generator's device, then moved: equal generators give equal bits
    dev = resolve_device(device)
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=generator.device).to(dev)


def patch_embeddings(
    generator: torch.Generator,
    batch: int,
    seq: int,
    d_model: int,
    dtype: Any = torch.bfloat16,
    device: Device = "cuda",
) -> torch.Tensor:
    """Pixtral-style stub: unit-variance patch/text embeddings (B, S, d)."""
    return _normal(generator, (batch, seq, d_model), device).to(dtype)


def frame_embeddings(
    generator: torch.Generator,
    batch: int,
    seq: int,
    d_model: int,
    dtype: Any = torch.bfloat16,
    device: Device = "cuda",
) -> torch.Tensor:
    """HuBERT-style stub: 20 ms-frame conv features after projection (B, S, d)."""
    x = _normal(generator, (batch, seq, d_model), device)
    # conv feature encoders give temporally correlated features; the light
    # smoothing wraps around the sequence, as the reference's ``jnp.roll``
    x = 0.5 * x + 0.5 * torch.roll(x, 1, dims=1)
    return x.to(dtype)


def embed_input_spec(
    batch: int, seq: int, d_model: int, dtype: Any = torch.bfloat16
) -> Tuple[Tuple[int, int, int], Any]:
    """``(shape, dtype)`` of an embeddings input, as ``cache_spec`` gives its leaves."""
    return (batch, seq, d_model), dtype
