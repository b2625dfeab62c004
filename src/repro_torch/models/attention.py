"""Attention variants, GQA (with qk-norm) and MLA, for training, prefill
and cached decode; counterpart of ``repro.models.attention``.

The reference's block-wise ``_chunked_attention`` mirrors the tiling of its
Pallas ``flash_attention`` kernel; here that computation is a call of the
``flash_attention`` op: the hand-written CUDA kernel on the card (which
tiles the sequence itself, so the reference's ``chunk`` has no counterpart),
its plain version on the CPU. Decode attention (``_decode_attend``) has no
TPU kernel in the reference and stays plain torch.

The KV cache is laid out ``(B, S_max, KV, D)`` and is written in place.

MLA (DeepSeek-V2 / MiniCPM3) caches the compressed latent ``(B, S_max,
rank)`` and the decoupled RoPE key ``(B, S_max, rope)``. Training and
prefill expand the latent to per-head K and V and call the flash op at the
q/k width ``nope + rope`` (V padded to it with zeros, as the reference pads
it for its chunked attention, and the output cut back to ``v_head_dim``);
decode takes the *absorbed* form, scores taken directly against the latent,
which has no TPU kernel and stays plain torch. Its two latent norms go
through the rmsnorm op.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.distributed.dtensors import is_dtensor, rows_for_product
from repro_torch.distributed.logical import constrain
from repro_torch.kernels.flash_attention.ops import flash_attention

from .layers import ParamSpec, apply_rope, head_rms_norm, rms_norm

# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------


def gqa_spec(
    d_model: int,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    qk_norm: bool = False,
    bias: bool = False,
) -> Dict[str, ParamSpec]:
    """``bias`` is the reference's keyword, accepted and ignored there too:
    no projection has a bias."""
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


def mla_spec(
    d_model: int,
    n_heads: int,
    q_lora_rank: int,
    kv_lora_rank: int,
    qk_nope_dim: int,
    qk_rope_dim: int,
    v_head_dim: int,
) -> Dict[str, ParamSpec]:
    return {
        "wq_a": ParamSpec((d_model, q_lora_rank), ("embed", "qk_rank")),
        "q_a_norm": ParamSpec((q_lora_rank,), ("qk_rank",), init="ones", f32_at_use=True),
        "wq_b": ParamSpec(
            (q_lora_rank, n_heads, qk_nope_dim + qk_rope_dim),
            ("qk_rank", "heads", "head_dim"),
        ),
        "wkv_a": ParamSpec((d_model, kv_lora_rank + qk_rope_dim), ("embed", "kv_rank")),
        "kv_a_norm": ParamSpec((kv_lora_rank,), ("kv_rank",), init="ones", f32_at_use=True),
        "wk_b": ParamSpec(
            (kv_lora_rank, n_heads, qk_nope_dim), ("kv_rank", "heads", "head_dim")
        ),
        "wv_b": ParamSpec(
            (kv_lora_rank, n_heads, v_head_dim), ("kv_rank", "heads", "head_dim")
        ),
        "wo": ParamSpec((n_heads, v_head_dim, d_model), ("heads", "head_dim", "embed")),
    }


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
    positions: Optional[torch.Tensor] = None,  # (B, S); None: from cache_index
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_index: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Returns (out, cache).

    * no cache:           cache=None                  — full pass
    * prefill:            cache=zeros, cache_index=0  — writes [0, S)
    * decode (S == 1):    cache=state, cache_index=t  — appends + attends

    The cache tensors are updated in place and returned."""
    b, s, _ = x.shape
    positions = _positions(positions, b, s, cache_index, x.device)
    x = rows_for_product(x)
    # seq=None: attention needs the whole sequence (the sequence-parallel
    # gather); the heads shard over "model" instead
    q = constrain(_project(x, params["wq"]), ("batch", None, "heads", None))
    k = constrain(_project(x, params["wk"]), ("batch", None, "kv_heads", None))
    v = constrain(_project(x, params["wv"]), ("batch", None, "kv_heads", None))
    if cfg.qk_norm:
        q = head_rms_norm(params["q_norm"], q, cfg.norm_eps)
        k = head_rms_norm(params["k_norm"], k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache is None:
        out = flash_attention(q, *_kv_for_query_heads(q, k, v), causal=cfg.causal)
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


def _positions(positions: Optional[torch.Tensor], b: int, s: int, cache_index: Optional[int],
               device: torch.device) -> torch.Tensor:
    """The given positions, or as the reference makes them: ``cache_index``
    (0 without one) onwards, for every sequence."""
    if positions is not None:
        return positions
    base = int(cache_index) if cache_index is not None else 0
    return (base + torch.arange(s, device=device))[None, :].expand(b, s)


def _kv_for_query_heads(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K and V as flash attention reads them for ``q``'s heads. The kernel
    maps query head h to KV head h // groups itself, and on each rank's
    shard too while the KV heads split as the query heads do. Where the
    query heads shard over a mesh axis that the KV heads do not (too few KV
    heads to divide it), K and V are repeated to the full head count and
    sharded as the query heads, the reference's sharded gather
    (``_chunked_attention``'s repeat); unsharded they are left as they are."""
    if q.shape[2] == k.shape[2] or not is_dtensor(q):
        return k, v
    heads = [i for i, p in enumerate(q.placements) if p.is_shard() and p.dim == 2]
    if all(k.placements[i] == q.placements[i] for i in heads):
        return k, v
    groups = q.shape[2] // k.shape[2]
    return tuple(constrain(t.repeat_interleave(groups, dim=2), ("batch", None, "heads", None))
                 for t in (k, v))


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


# ---------------------------------------------------------------------------
# MLA forward
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MLAConfig:
    n_heads: int
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_dim: int
    qk_rope_dim: int
    v_head_dim: int
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6


def _mla_qkv(params, x, cfg: MLAConfig, positions):
    """``(q_nope, q_pe, c_kv, k_pe)``: the per-head query halves (B, S, H, ·),
    the normed latent (B, S, rank) and the rotated shared key (B, S, 1, rope)."""
    x = rows_for_product(x)
    cq = x @ params["wq_a"].to(x.dtype)
    cq = rms_norm({"scale": params["q_a_norm"]}, cq, cfg.norm_eps)
    q = _project(cq, params["wq_b"])
    q_nope, q_pe = q[..., : cfg.qk_nope_dim], q[..., cfg.qk_nope_dim:]
    q_pe = apply_rope(q_pe, positions, cfg.rope_theta)

    ckv_full = x @ params["wkv_a"].to(x.dtype)
    c_kv = ckv_full[..., : cfg.kv_lora_rank]
    k_pe = ckv_full[..., cfg.kv_lora_rank:][:, :, None, :]  # (B, S, 1, rope)
    c_kv = rms_norm({"scale": params["kv_a_norm"]}, c_kv, cfg.norm_eps)
    k_pe = apply_rope(k_pe, positions, cfg.rope_theta)
    return q_nope, q_pe, c_kv, k_pe


def mla_forward(
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,  # (B, S, d_model)
    cfg: MLAConfig,
    positions: Optional[torch.Tensor] = None,  # (B, S); None: from cache_index
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_index: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Returns (out, cache), with ``gqa_forward``'s three modes; the latent
    and RoPE-key cache leaves are written in place."""
    b, s, _ = x.shape
    positions = _positions(positions, b, s, cache_index, x.device)
    q_nope, q_pe, c_kv, k_pe = _mla_qkv(params, x, cfg, positions)
    if cache is not None:
        idx = int(cache_index) if cache_index is not None else 0
        cc, cp = cache["c_kv"], cache["k_pe"]
        start = min(max(idx, 0), cc.shape[1] - s)
        cc[:, start:start + s] = c_kv.to(cc.dtype)
        cp[:, start:start + s] = k_pe[:, :, 0, :].to(cp.dtype)
    if cache is not None and s == 1:
        out = _mla_decode_absorbed(params, q_nope, q_pe, cc, cp, idx, cfg)
    else:
        # train / prefill: expand the latent to per-head K and V, flash
        # attention at the q/k width; V padded with zeros to it, the output
        # cut back
        k_nope = _project(c_kv, params["wk_b"])
        v = _project(c_kv, params["wv_b"])
        k = torch.cat([k_nope, k_pe.expand(b, s, cfg.n_heads, cfg.qk_rope_dim)], dim=-1)
        q = torch.cat([q_nope, q_pe], dim=-1)
        out = flash_attention(q, k, _pad_last(v, q.shape[-1]), causal=True)[..., : cfg.v_head_dim]
    wo = params["wo"]
    return out.reshape(b, s, -1) @ wo.to(x.dtype).reshape(-1, wo.shape[-1]), cache


def _pad_last(x: torch.Tensor, to: int) -> torch.Tensor:
    pad = to - x.shape[-1]
    if pad <= 0:
        return x
    return torch.nn.functional.pad(x, (0, pad))


def _mla_decode_absorbed(params, q_nope, q_pe, c_kv, k_pe, idx: int, cfg: MLAConfig) -> torch.Tensor:
    """Absorbed MLA decode: W_uk folded into the query and W_uv into the
    output, scores taken against the latent cache; keys at positions <= idx
    count. Returns (B, 1, H, v_head_dim)."""
    dt = q_nope.dtype
    scale = 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
    q_lat = torch.einsum("bhk,rhk->bhr", q_nope[:, 0], params["wk_b"].to(dt))
    scores = torch.einsum("bhr,bsr->bhs", q_lat, c_kv)
    scores = scores + torch.einsum("bhk,bsk->bhs", q_pe[:, 0], k_pe)
    scores = (scores * scale).float()
    valid = torch.arange(c_kv.shape[1], device=c_kv.device) <= idx
    scores = torch.where(valid, scores, torch.full_like(scores, -1e30))
    w = torch.softmax(scores, dim=-1).to(dt)
    o_lat = torch.einsum("bhs,bsr->bhr", w, c_kv)
    out = torch.einsum("bhr,rhk->bhk", o_lat, params["wv_b"].to(dt))
    return out[:, None]


def mla_cache_shape(
    batch: int, max_seq: int, kv_lora_rank: int, qk_rope_dim: int, dtype: Any = torch.bfloat16
) -> Dict[str, Tuple[Tuple[int, ...], Any]]:
    """(shape, dtype) of each cache leaf."""
    return {
        "c_kv": ((batch, max_seq, kv_lora_rank), dtype),
        "k_pe": ((batch, max_seq, qk_rope_dim), dtype),
    }
