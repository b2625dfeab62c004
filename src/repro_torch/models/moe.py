"""Mixture-of-Experts FFN with top-k routing and capacity-based dispatch;
counterpart of ``repro.models.moe``.

The reference's semantics, step by step:
  1. router top-k -> (token, expert, weight) triples;
  2. the position of each assignment within its (token block, expert)
     queue, by a stable per-block sort (``_position_in_expert_blocked``);
  3. the token activations into an (E, C, d) buffer, dropping assignments
     past their strip's capacity;
  4. the experts' SwiGLU as batched products over the expert-major buffer
     (``torch.bmm``; the reference's einsums are plain products outside any
     Pallas kernel) around the port's swiglu op, the hand-written kernel on
     the card;
  5. the outputs gathered back and combined with the routing weights;
     dropped assignments contribute zero and fall through the residual.

Top-1 with a shared expert (Llama-4 Scout) and 128 experts top-8
(Qwen3-MoE). Nothing here sums floats in an order the device chooses, so
equal inputs give equal bits (the gradient quorum compares replicas):

* top-k is a stable descending sort, so ties go to the lower expert index
  as in ``jax.lax.top_k`` (``torch.topk`` breaks them otherwise);
* every kept assignment owns its (expert, slot), so the dispatch writes
  each slot once (``index_put``) where the reference adds it to a zero, or
  adds zeros for the dropped assignments, which change no bit; the dropped
  ones write to a spare row that is cut off;
* a token's k outputs are added in order, k = 0 first, in the compute
  dtype, as the reference's scatter-add over ``flat_t`` adds them;
* the aux loss's per-expert fractions add ``1 / (T k)`` once per
  assignment as the reference does (``index_add_``): every addend is the
  same, so the order in which the card adds them changes no bit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from repro_torch.distributed.dtensors import replicated, rows_for_product
from repro_torch.distributed.logical import constrain

from .layers import ParamSpec, swiglu


@dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_expert: int  # per-expert FFN width
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    n_shared_experts: int = 0  # shared expert width = n_shared * d_expert
    router_aux_weight: float = 0.01
    normalize_router_weights: bool = True  # softmax over the selected top-k
    # positions are computed within contiguous token blocks (the data shards
    # of the reference's production mesh), each filling its own capacity
    # strip; kept for the semantics: capacity and drops depend on it
    dispatch_blocks: int = 16


def moe_spec(cfg: MoEConfig) -> Dict[str, ParamSpec]:
    spec = {
        "router": ParamSpec((cfg.d_model, cfg.n_experts), ("embed", "experts")),
        "w_gate": ParamSpec(
            (cfg.n_experts, cfg.d_model, cfg.d_expert), ("experts", "embed", "mlp")
        ),
        "w_up": ParamSpec(
            (cfg.n_experts, cfg.d_model, cfg.d_expert), ("experts", "embed", "mlp")
        ),
        "w_down": ParamSpec(
            (cfg.n_experts, cfg.d_expert, cfg.d_model), ("experts", "mlp", "embed")
        ),
    }
    if cfg.n_shared_experts > 0:
        ds = cfg.n_shared_experts * cfg.d_expert
        spec["shared_gate"] = ParamSpec((cfg.d_model, ds), ("embed", "mlp"))
        spec["shared_up"] = ParamSpec((cfg.d_model, ds), ("embed", "mlp"))
        spec["shared_down"] = ParamSpec((ds, cfg.d_model), ("mlp", "embed"))
    return spec


def capacity(n_tokens: int, cfg: MoEConfig) -> int:
    c = int(cfg.capacity_factor * cfg.top_k * n_tokens / cfg.n_experts) + 1
    return max(8, -(-c // 8) * 8)


def dispatch_shape(n_tokens: int, cfg: MoEConfig) -> Tuple[int, int]:
    """``(blocks, cap_block)`` for ``n_tokens`` tokens: the positions are
    counted in ``cfg.dispatch_blocks`` blocks when the ``n_tokens * top_k``
    assignments divide into them, else in one, and each block holds
    ``cap_block`` slots per expert (the buffer's capacity is their product)."""
    n = n_tokens * cfg.top_k
    blocks = cfg.dispatch_blocks if n % cfg.dispatch_blocks == 0 else 1
    return blocks, max(8, -(-capacity(n_tokens, cfg) // blocks))


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest along the last axis and their indices, equal values
    in index order (``jax.lax.top_k``'s rule): a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(
    xf: torch.Tensor, router: torch.Tensor, cfg: MoEConfig
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(top_w (T, k) f32, top_e (T, k), probs (T, E) f32)``: softmax of the
    router logits (the product in the compute dtype), the k largest with
    ties to the lower index, optionally renormalized."""
    logits = (xf @ router.to(xf.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = top_k(probs, cfg.top_k)
    if cfg.normalize_router_weights:
        top_w = top_w / top_w.sum(-1, keepdim=True).clamp(min=1e-9)
    return top_w, top_e, probs


def moe_forward(
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,  # (B, S, d)
    cfg: MoEConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out (B, S, d), aux_loss scalar f32)."""
    dt = x.dtype
    b, s, d = x.shape
    nt, k, ne = b * s, cfg.top_k, cfg.n_experts
    xf = rows_for_product(x).reshape(nt, d)
    top_w, top_e, probs = route(xf, params["router"], cfg)
    # the routing's bookkeeping runs alike on every rank of the sharded step;
    # the experts' buffers built from it shard over "experts"
    top_w, top_e = replicated(top_w), replicated(top_e)

    # load-balancing aux loss (Switch): E * sum_e f_e * p_e
    me = probs.mean(dim=0)
    flat_e = top_e.reshape(-1)  # (n,), token-major: assignment i is token i // k
    # the buffers updated in place are made from the routing's own tensors
    # (``new_*``), so that in the sharded step they are DTensors too
    ce = probs.new_zeros(ne).index_add_(0, flat_e, probs.new_full(flat_e.shape, 1.0 / (nt * k)))
    aux = cfg.router_aux_weight * ne * (me * ce).sum()

    n = flat_e.shape[0]
    blocks, cap_block = dispatch_shape(nt, cfg)
    cap = cap_block * blocks
    pos = _position_in_expert_blocked(flat_e, ne, blocks)
    keep = pos < cap_block
    block_id = torch.arange(n, device=x.device) // (n // blocks)
    # each assignment's row of the (E * C, d) buffer; a dropped one's is its
    # strip's last slot, where it writes nothing (the spare row E * C takes
    # its write) and whose output it reads with weight zero
    row = flat_e * cap + block_id * cap_block + pos.clamp(max=cap_block - 1)
    dest = torch.where(keep, row, ne * cap)

    val = xf[:, None, :].expand(nt, k, d).reshape(n, d)
    buf = x.new_zeros((ne * cap + 1, d)).index_put((dest,), val)[:-1].view(ne, cap, d)
    buf = constrain(buf, ("experts", None, None))

    # expert computation (expert axis sharded over "model")
    g = torch.bmm(buf, params["w_gate"].to(dt))
    u = torch.bmm(buf, params["w_up"].to(dt))
    eo = torch.bmm(swiglu(g, u), params["w_down"].to(dt))
    eo = constrain(eo, ("experts", None, None))

    w = top_w.reshape(-1).to(dt) * keep.to(dt)
    per_assign = (eo.reshape(ne * cap, d)[row] * w[:, None]).view(nt, k, d)
    out = per_assign[:, 0]
    for j in range(1, k):
        out = out + per_assign[:, j]

    if cfg.n_shared_experts > 0:
        sg = xf @ params["shared_gate"].to(dt)
        su = xf @ params["shared_up"].to(dt)
        out = out + swiglu(sg, su) @ params["shared_down"].to(dt)
    return out.reshape(b, s, d), aux


def _position_in_expert_blocked(flat_e: torch.Tensor, n_experts: int, blocks: int) -> torch.Tensor:
    """Index of each assignment within its (block, expert) queue: the number
    of earlier assignments of the same block routed to the same expert. A
    stable sort per block, as in the reference; integers only."""
    n = flat_e.shape[0]
    nb = n // blocks
    e2 = flat_e.reshape(blocks, nb)
    order = torch.argsort(e2, dim=1, stable=True)
    sorted_e = torch.gather(e2, 1, order)
    counts = e2.new_zeros((blocks, n_experts), dtype=torch.long)
    counts.scatter_add_(1, e2, torch.ones_like(e2))
    starts = torch.cumsum(counts, dim=1) - counts  # exclusive prefix per block
    pos_sorted = torch.arange(nb, device=flat_e.device)[None, :] - torch.gather(starts, 1, sorted_e)
    pos = torch.empty_like(pos_sorted).scatter_(1, order, pos_sorted)
    return pos.reshape(n)
