"""Dense decoder stack; counterpart of ``repro.models.transformer``.

[rmsnorm -> GQA attention (qk-norm, RoPE) -> +res -> rmsnorm -> SwiGLU MLP
-> +res] x L, then the final rmsnorm and the tied unembedding. The
reference's ``lax.scan`` over stacked layer parameters is a Python loop over
their leading axis. Only the dense family is ported.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.device import Device, resolve_device

from .attention import AttnConfig, gqa_cache_shape, gqa_forward, gqa_spec
from .config import ModelConfig
from .layers import (
    embed_tokens,
    embedding_spec,
    mlp_forward,
    mlp_spec,
    rms_norm,
    rmsnorm_spec,
    stack_layer_specs,
    tree_map,
    unembed_logits,
)


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.attention != "gqa":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} / attention {cfg.attention!r} is not yet "
            "ported to repro_torch (dense GQA only)"
        )


def attn_config(cfg: ModelConfig) -> AttnConfig:
    return AttnConfig(
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads or cfg.n_heads,
        head_dim=cfg.resolved_head_dim,
        rope_theta=cfg.rope_theta,
        qk_norm=cfg.qk_norm,
        causal=cfg.causal,
        norm_eps=cfg.norm_eps,
    )


def _dense_block_spec(cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "attn_norm": rmsnorm_spec(cfg.d_model),
        "attn": gqa_spec(
            cfg.d_model,
            cfg.n_heads,
            cfg.n_kv_heads or cfg.n_heads,
            cfg.resolved_head_dim,
            qk_norm=cfg.qk_norm,
        ),
        "mlp_norm": rmsnorm_spec(cfg.d_model),
        "mlp": mlp_spec(cfg.d_model, cfg.d_ff),
    }


def model_spec(cfg: ModelConfig) -> Dict[str, Any]:
    _require_dense(cfg)
    spec: Dict[str, Any] = {}
    if cfg.vocab:
        spec["embed"] = embedding_spec(cfg.padded_vocab, cfg.d_model)
    spec["layers"] = stack_layer_specs(_dense_block_spec(cfg), cfg.n_layers)
    spec["final_norm"] = rmsnorm_spec(cfg.d_model)
    return spec


def _dense_block(
    lp: Dict[str, Any],
    x: torch.Tensor,
    cfg: ModelConfig,
    positions: torch.Tensor,
    cache: Optional[Dict[str, torch.Tensor]],
    cache_index: Optional[int],
) -> torch.Tensor:
    h = rms_norm(lp["attn_norm"], x, cfg.norm_eps)
    a, _ = gqa_forward(lp["attn"], h, attn_config(cfg), positions, cache, cache_index)
    x = x + a
    h = rms_norm(lp["mlp_norm"], x, cfg.norm_eps)
    return x + mlp_forward(lp["mlp"], h)


def forward(
    params: Dict[str, Any],
    cfg: ModelConfig,
    tokens: torch.Tensor,
    cache: Optional[Dict[str, Any]] = None,
    cache_index: Optional[int] = None,
    return_hidden: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """Returns (logits (B, S, V_padded) or hidden, cache).

    A given cache is written in place, layer by layer, and returned. The
    reference also returns an auxiliary loss, which is zero for the dense
    family, and takes embeddings in place of tokens for other input modes."""
    _require_dense(cfg)
    x = embed_tokens(params["embed"], tokens, cfg.dtype)
    b, s = x.shape[:2]
    base = cache_index if cache_index is not None else 0
    positions = (base + torch.arange(s, device=x.device))[None, :].expand(b, s)
    layers = params["layers"]
    for i in range(cfg.n_layers):
        lp = tree_map(lambda t: t[i], layers)
        # layer i's K/V are views into the stacked cache: gqa_forward writes them in place
        lcache = tree_map(lambda t: t[i], cache["layers"]) if cache is not None else None
        x = _dense_block(lp, x, cfg, positions, lcache, cache_index)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    if return_hidden:
        return x, cache
    return unembed_logits(params["embed"], x), cache


def cache_spec(cfg: ModelConfig, batch: int, max_seq: int) -> Dict[str, Any]:
    """(shape, dtype) of every decode-cache leaf, stacked over layers."""
    _require_dense(cfg)
    per = gqa_cache_shape(
        batch, max_seq, cfg.n_kv_heads or cfg.n_heads, cfg.resolved_head_dim, cfg.dtype
    )
    return {"layers": {k: ((cfg.n_layers,) + shp, dt) for k, (shp, dt) in per.items()}}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device: Device = "cuda") -> Dict[str, Any]:
    dev = resolve_device(device)
    return {
        "layers": {
            k: torch.zeros(shp, dtype=dt, device=dev)
            for k, (shp, dt) in cache_spec(cfg, batch, max_seq)["layers"].items()
        }
    }
