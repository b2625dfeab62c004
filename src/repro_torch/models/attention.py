"""GQA attention with qk-norm, prefill and cached decode; counterpart of
``repro.models.attention`` (MLA is not ported yet).

The reference's block-wise ``_chunked_attention`` mirrors the tiling of its
Pallas ``flash_attention`` kernel; here that computation is a call of the
``flash_attention`` op: the hand-written CUDA kernel on the card (which
tiles the sequence itself, so the reference's ``chunk`` has no counterpart),
its plain version on the CPU. Decode attention (``_decode_attend``) has no
TPU kernel in the reference and stays plain torch.

The KV cache is laid out ``(B, S_max, KV, D)`` and is written in place.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention

from .layers import ParamSpec, apply_rope, head_rms_norm

# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------


def gqa_spec(
    d_model: int,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    qk_norm: bool = False,
) -> Dict[str, ParamSpec]:
    spec = {
        "wq": ParamSpec((d_model, n_heads, head_dim), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d_model, n_kv_heads, head_dim), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d_model, n_kv_heads, head_dim), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((n_heads, head_dim, d_model), ("heads", "head_dim", "embed")),
    }
    if qk_norm:
        spec["q_norm"] = ParamSpec((head_dim,), ("head_dim",), init="ones", f32_at_use=True)
        spec["k_norm"] = ParamSpec((head_dim,), ("head_dim",), init="ones", f32_at_use=True)
    return spec


# ---------------------------------------------------------------------------
# GQA forward (prefill / decode)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AttnConfig:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    qk_norm: bool = False
    causal: bool = True
    norm_eps: float = 1e-6


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, d) x (d, heads, hd) -> (B, S, heads, hd), contiguous."""
    b, s, d = x.shape
    return (x @ w.to(x.dtype).reshape(d, -1)).view(b, s, w.shape[1], w.shape[2])


def gqa_forward(
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,  # (B, S, d_model)
    cfg: AttnConfig,
    positions: torch.Tensor,  # (B, S)
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_index: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Returns (out, cache).

    * no cache:           cache=None                  — full pass
    * prefill:            cache=zeros, cache_index=0  — writes [0, S)
    * decode (S == 1):    cache=state, cache_index=t  — appends + attends

    The cache tensors are updated in place and returned."""
    b, s, _ = x.shape
    q = _project(x, params["wq"])
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    if cfg.qk_norm:
        q = head_rms_norm(params["q_norm"], q, cfg.norm_eps)
        k = head_rms_norm(params["k_norm"], k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache is None:
        out = flash_attention(q, k, v, causal=cfg.causal)
    else:
        idx = int(cache_index) if cache_index is not None else 0
        ck, cv = cache["k"], cache["v"]
        # dynamic_update_slice semantics: the start is clamped so the update fits
        start = min(max(idx, 0), ck.shape[1] - s)
        ck[:, start:start + s] = k.to(ck.dtype)
        cv[:, start:start + s] = v.to(cv.dtype)
        if s == 1:
            out = _decode_attend(q, ck, cv, idx)
        else:
            # prefill: attend within the fresh segment only, as the reference does
            out = flash_attention(q, k, v, causal=cfg.causal)
    wo = params["wo"]
    return out.reshape(b, s, -1) @ wo.to(x.dtype).reshape(-1, wo.shape[-1]), cache


def _decode_attend(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor, idx: int) -> torch.Tensor:
    """Single-token attention over the cache; keys at positions <= idx count."""
    b, _, h, d = q.shape
    kv = ck.shape[2]
    groups = h // kv
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, kv, groups, d)
    scores = (torch.einsum("bkgd,bskd->bkgs", qg, ck) * scale).float()
    valid = torch.arange(ck.shape[1], device=q.device) <= idx
    scores = torch.where(valid, scores, torch.full_like(scores, -1e30))
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", w, cv)
    return out.reshape(b, 1, h, d)


def gqa_cache_shape(
    batch: int, max_seq: int, n_kv_heads: int, head_dim: int, dtype: Any = torch.bfloat16
) -> Dict[str, Tuple[Tuple[int, ...], Any]]:
    """(shape, dtype) of each cache leaf."""
    shp = (batch, max_seq, n_kv_heads, head_dim)
    return {"k": (shp, dtype), "v": (shp, dtype)}
