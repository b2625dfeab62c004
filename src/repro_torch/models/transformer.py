"""Decoder stacks; counterpart of ``repro.models.transformer``.

Families ported:

  dense : [rmsnorm -> attention -> +res -> rmsnorm -> SwiGLU MLP -> +res] x L,
          the attention GQA (qk-norm, RoPE) or MLA
  moe   : the same with the MoE FFN (+ optional shared expert), whose
          load-balancing loss each layer returns
  ssm   : [rmsnorm -> mamba2 -> +res] x L
  hybrid: groups of mamba layers with ONE weight-tied attention+MLP block
          (no qk-norm) after each group, then the tail layers
  vlm   : the dense stack fed with patch embeddings (prefill, training) or
          text tokens (decode)
  audio : the dense stack fed with frame embeddings, encoder-only (no
          causal mask, no cache)

each followed by the final rmsnorm and the tied unembedding (hubert's
``tie_embeddings=False`` is read nowhere in the reference either). The
reference's ``lax.scan`` over stacked layer parameters is a Python loop
over their leading axis (or the two leading axes, groups and layers, of
the hybrid stack), unbound once (so a gradient through the layers is one
stack of the per-layer gradients); the aux losses are summed in layer
order from zero, as the scan's carry sums them.
``jax.checkpoint(..., policy=...)`` becomes
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`` with the
policy ``cfg.remat_policy`` names (``_remat_context``), for each layer
(each group of the hybrid stack) when training with ``cfg.remat``; each CE
chunk of ``train_loss`` is a plain checkpoint, as its reference is a bare
``jax.checkpoint``. A given cache is written in place: K/V slices (or the
MLA latent and RoPE key) as in the reference's ``dynamic_update_slice``,
and each mamba layer's state and conv tail replaced by the new ones.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from repro_torch.device import Device, resolve_device
from repro_torch.distributed.logical import constrain

from .attention import (
    AttnConfig,
    MLAConfig,
    gqa_cache_shape,
    gqa_forward,
    gqa_spec,
    mla_cache_shape,
    mla_forward,
    mla_spec,
)
from .config import ModelConfig
from .layers import (
    cross_entropy_from_logits,
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
from .moe import MoEConfig, moe_forward, moe_spec
from .ssm import SSMConfig, mamba2_decode_step, mamba2_forward, mamba2_spec, mamba2_state_shape


_DENSE_STACK = ("dense", "moe", "vlm", "audio")  # the families the dense stack serves


def _require_ported(cfg: ModelConfig) -> None:
    if not (cfg.family in ("ssm", "hybrid")
            or (cfg.family in _DENSE_STACK and cfg.attention in ("gqa", "mla"))):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} / attention {cfg.attention!r} has no stack in "
            "repro_torch (dense, moe, vlm and audio with gqa or mla; ssm; hybrid)"
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


def mla_config(cfg: ModelConfig) -> MLAConfig:
    return MLAConfig(
        n_heads=cfg.n_heads,
        q_lora_rank=cfg.q_lora_rank,
        kv_lora_rank=cfg.kv_lora_rank,
        qk_nope_dim=cfg.qk_nope_dim,
        qk_rope_dim=cfg.qk_rope_dim,
        v_head_dim=cfg.v_head_dim,
        rope_theta=cfg.rope_theta,
        norm_eps=cfg.norm_eps,
    )


def moe_config(cfg: ModelConfig) -> MoEConfig:
    return MoEConfig(
        d_model=cfg.d_model,
        d_expert=cfg.d_expert or cfg.d_ff,
        n_experts=cfg.n_experts,
        top_k=cfg.top_k,
        capacity_factor=cfg.capacity_factor,
        n_shared_experts=cfg.n_shared_experts,
    )


def ssm_config(cfg: ModelConfig) -> SSMConfig:
    return SSMConfig(
        d_model=cfg.d_model,
        d_state=cfg.ssm_state,
        d_conv=cfg.ssm_conv,
        expand=cfg.ssm_expand,
        head_dim=cfg.ssm_head_dim,
        n_groups=cfg.ssm_groups,
        chunk=cfg.ssm_chunk,
        norm_eps=cfg.norm_eps,
    )


def hybrid_layout(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(n_groups, layers_per_group, tail_layers) for hybrid stacks."""
    period = cfg.shared_attn_period
    n_groups = cfg.n_layers // period
    tail = cfg.n_layers - n_groups * period
    return n_groups, period, tail


def _attn_spec(cfg: ModelConfig) -> Dict[str, Any]:
    if cfg.attention == "mla":
        return mla_spec(
            cfg.d_model,
            cfg.n_heads,
            cfg.q_lora_rank,
            cfg.kv_lora_rank,
            cfg.qk_nope_dim,
            cfg.qk_rope_dim,
            cfg.v_head_dim,
        )
    return gqa_spec(
        cfg.d_model,
        cfg.n_heads,
        cfg.n_kv_heads or cfg.n_heads,
        cfg.resolved_head_dim,
        qk_norm=cfg.qk_norm,
    )


def _dense_block_spec(cfg: ModelConfig) -> Dict[str, Any]:
    spec: Dict[str, Any] = {
        "attn_norm": rmsnorm_spec(cfg.d_model),
        "attn": _attn_spec(cfg),
        "mlp_norm": rmsnorm_spec(cfg.d_model),
    }
    if cfg.family == "moe":
        spec["moe"] = moe_spec(moe_config(cfg))
    else:
        spec["mlp"] = mlp_spec(cfg.d_model, cfg.d_ff)
    return spec


def _mamba_block_spec(cfg: ModelConfig) -> Dict[str, Any]:
    return {"norm": rmsnorm_spec(cfg.d_model), "mamba": mamba2_spec(ssm_config(cfg))}


def model_spec(cfg: ModelConfig) -> Dict[str, Any]:
    _require_ported(cfg)
    spec: Dict[str, Any] = {}
    if cfg.vocab:
        spec["embed"] = embedding_spec(cfg.padded_vocab, cfg.d_model)
    if cfg.family in _DENSE_STACK:
        spec["layers"] = stack_layer_specs(_dense_block_spec(cfg), cfg.n_layers)
    elif cfg.family == "ssm":
        spec["layers"] = stack_layer_specs(_mamba_block_spec(cfg), cfg.n_layers)
    else:  # hybrid
        ng, per, tail = hybrid_layout(cfg)
        spec["groups"] = stack_layer_specs(
            stack_layer_specs(_mamba_block_spec(cfg), per), ng, axis_name="groups"
        )
        if tail:
            spec["tail"] = stack_layer_specs(_mamba_block_spec(cfg), tail)
        # the weight-tied shared transformer block (Zamba2)
        spec["shared_attn"] = {
            "attn_norm": rmsnorm_spec(cfg.d_model),
            "attn": gqa_spec(
                cfg.d_model, cfg.n_heads, cfg.n_kv_heads or cfg.n_heads, cfg.resolved_head_dim
            ),
            "mlp_norm": rmsnorm_spec(cfg.d_model),
            "mlp": mlp_spec(cfg.d_model, cfg.d_ff),
        }
    spec["final_norm"] = rmsnorm_spec(cfg.d_model)
    return spec


# the products a policy may save: "dots_nb" those with no batch dims (a
# (B, S, d) @ (d, f) projection folds to ``mm``), "dots" the batched ones too
# (the experts' ``bmm``); the kernels' autograd functions are no aten ops and
# run again on recompute under every policy
_NO_BATCH_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_BATCH_DOTS = (torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)
_SAVED_OPS = {
    "nothing": (),
    "dots_nb": _NO_BATCH_DOTS,
    "dots": _NO_BATCH_DOTS + _BATCH_DOTS,
}


def _remat_context(cfg: ModelConfig) -> Callable[[], Any]:
    """The ``context_fn`` of ``cfg.remat_policy``'s checkpoints: "nothing"
    recomputes everything; "dots_nb" and "dots" save their products'
    outputs. An unknown name raises ``KeyError``, as in the reference."""
    saved = _SAVED_OPS[cfg.remat_policy]
    if not saved:
        return noop_context_fn
    return functools.partial(create_selective_checkpoint_contexts, list(saved))


def _dense_block(
    lp: Dict[str, Any],
    x: torch.Tensor,
    cfg: ModelConfig,
    positions: torch.Tensor,
    cache: Optional[Dict[str, torch.Tensor]],
    cache_index: Optional[int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer: ``(x, aux)``, aux the MoE layer's load-balancing loss (f32
    zero for an MLP layer)."""
    x = constrain(x, ("batch", "seq", None))
    h = rms_norm(lp["attn_norm"], x, cfg.norm_eps)
    if cfg.attention == "mla":
        a, _ = mla_forward(lp["attn"], h, mla_config(cfg), positions, cache, cache_index)
    else:
        a, _ = gqa_forward(lp["attn"], h, attn_config(cfg), positions, cache, cache_index)
    x = x + constrain(a, ("batch", "seq", None))
    h = rms_norm(lp["mlp_norm"], x, cfg.norm_eps)
    if cfg.family == "moe":
        m, aux = moe_forward(lp["moe"], h, moe_config(cfg))
    else:
        m, aux = mlp_forward(lp["mlp"], h), torch.zeros((), dtype=torch.float32, device=x.device)
    return x + constrain(m, ("batch", "seq", None)), aux


def _mamba_block(
    lp: Dict[str, Any],
    x: torch.Tensor,
    cfg: ModelConfig,
    state: Optional[Dict[str, torch.Tensor]],
    decode: bool,
) -> torch.Tensor:
    """One [rmsnorm -> mamba2 -> +res] layer; a given state (views into the
    stacked cache) is replaced in place by the new one."""
    x = constrain(x, ("batch", "seq", None))
    h = rms_norm(lp["norm"], x, cfg.norm_eps)
    if decode:
        m, new_state = mamba2_decode_step(lp["mamba"], h, ssm_config(cfg), state)
    else:
        m, new_state = mamba2_forward(lp["mamba"], h, ssm_config(cfg), state)
    if state is not None:
        for key in ("ssm", "conv"):
            state[key].copy_(new_state[key])
    return x + constrain(m, ("batch", "seq", None))


def _scan_mamba(
    layers: Dict[str, Any],
    n_layers: int,
    x: torch.Tensor,
    cfg: ModelConfig,
    state: Optional[Dict[str, torch.Tensor]],
    decode: bool,
    train: bool,
) -> torch.Tensor:
    unbound = tree_map(lambda t: t.unbind(0), layers)
    remat = train and cfg.remat
    context_fn = _remat_context(cfg) if remat else None
    for i in range(n_layers):
        lp = tree_map(lambda t: t[i], unbound)
        lstate = tree_map(lambda t: t[i], state) if state is not None else None
        if remat:
            x = checkpoint(_mamba_block, lp, x, cfg, lstate, decode, use_reentrant=False,
                           context_fn=context_fn)
        else:
            x = _mamba_block(lp, x, cfg, lstate, decode)
    return x


def _hybrid_forward(
    params: Dict[str, Any],
    x: torch.Tensor,
    cfg: ModelConfig,
    positions: torch.Tensor,
    cache: Optional[Dict[str, Any]],
    cache_index: Optional[int],
    decode: bool,
    train: bool,
) -> torch.Tensor:
    shared = params["shared_attn"]
    acfg = attn_config(cfg)
    ng, per, tail = hybrid_layout(cfg)

    def group_body(gp, h, gstate, gattn):
        h = _scan_mamba(gp, per, h, cfg, gstate, decode, train=False)
        # the weight-tied shared block; its K/V cache slice is written in place
        a_in = rms_norm(shared["attn_norm"], h, cfg.norm_eps)
        a, _ = gqa_forward(shared["attn"], a_in, acfg, positions, gattn, cache_index)
        h = h + a
        m_in = rms_norm(shared["mlp_norm"], h, cfg.norm_eps)
        return h + mlp_forward(shared["mlp"], m_in)

    groups = tree_map(lambda t: t.unbind(0), params["groups"])
    context_fn = _remat_context(cfg) if train and cfg.remat else None
    for gi in range(ng):
        gp = tree_map(lambda t: t[gi], groups)
        gstate = tree_map(lambda t: t[gi], cache["groups_mamba"]) if cache is not None else None
        gattn = tree_map(lambda t: t[gi], cache["groups_attn"]) if cache is not None else None
        if train and cfg.remat:
            x = checkpoint(group_body, gp, x, gstate, gattn, use_reentrant=False,
                           context_fn=context_fn)
        else:
            x = group_body(gp, x, gstate, gattn)
    if tail:
        tstate = cache["tail"] if cache is not None else None
        x = _scan_mamba(params["tail"], tail, x, cfg, tstate, decode, train)
    return x


def forward(
    params: Dict[str, Any],
    cfg: ModelConfig,
    tokens: Optional[torch.Tensor] = None,
    embeds: Optional[torch.Tensor] = None,
    cache: Optional[Dict[str, Any]] = None,
    cache_index: Optional[int] = None,
    train: bool = False,
    return_hidden: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]], torch.Tensor]:
    """Returns (logits (B, S, V_padded) or hidden, cache, aux_loss), as the
    reference does; aux is the MoE layers' load-balancing loss summed in
    layer order (an f32 zero for the other families).

    A given cache is written in place, layer by layer, and returned. With a
    cache and one token, the mamba layers take the O(1) decode step (the
    reference's rule, so a 1-token prompt decodes too). With ``train`` and
    ``cfg.remat`` each layer (each group of a hybrid stack) runs under
    activation checkpointing with ``cfg.remat_policy``, as in the
    reference. ``embeds`` (B, S, d_model), given, take the place of the
    embedded ``tokens``: they are cast to ``cfg.dtype`` (the vlm and audio
    frontends' patch and frame embeddings)."""
    _require_ported(cfg)
    if embeds is not None:
        x = embeds.to(cfg.dtype)
    elif tokens is not None:
        x = embed_tokens(params["embed"], tokens, cfg.dtype)
    else:
        raise ValueError("forward needs tokens or embeds")
    x = constrain(x, ("batch", "seq", None))
    b, s = x.shape[:2]
    base = cache_index if cache_index is not None else 0
    positions = (base + torch.arange(s, device=x.device))[None, :].expand(b, s)
    decode = cache is not None and s == 1
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":
        lstate = cache["layers"] if cache is not None else None
        x = _scan_mamba(params["layers"], cfg.n_layers, x, cfg, lstate, decode, train)
    elif cfg.family == "hybrid":
        x = _hybrid_forward(params, x, cfg, positions, cache, cache_index, decode, train)
    else:
        layers = tree_map(lambda t: t.unbind(0), params["layers"])
        remat = train and cfg.remat
        context_fn = _remat_context(cfg) if remat else None
        for i in range(cfg.n_layers):
            lp = tree_map(lambda t: t[i], layers)
            # layer i's cache leaves are views into the stacked cache, written in place
            lcache = tree_map(lambda t: t[i], cache["layers"]) if cache is not None else None
            if remat:
                x, a = checkpoint(_dense_block, lp, x, cfg, positions, lcache, cache_index,
                                  use_reentrant=False, context_fn=context_fn)
            else:
                x, a = _dense_block(lp, x, cfg, positions, lcache, cache_index)
            aux = aux + a
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    x = constrain(x, ("batch", "seq", None))
    if return_hidden:
        return x, cache, aux
    return constrain(unembed_logits(params["embed"], x), ("batch", "seq", "vocab")), cache, aux


def train_loss(
    params: Dict[str, Any],
    cfg: ModelConfig,
    batch: Dict[str, torch.Tensor],
    ce_chunk: int = 512,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token (or frame-classification) CE loss + aux (the MoE layers'
    load-balancing loss); the batch holds ``tokens`` or ``embeds``.

    As in the reference, the loss is computed in sequence chunks with
    rematerialization when ``s > 2 * ce_chunk`` and ``s % ce_chunk == 0``:
    the (B, S, V) logits are never alive at once; per chunk, unembed + CE
    run forward and again in backward. Otherwise one checkpointed chunk
    covers the whole sequence. Chunk sums are added in order from zero."""
    labels = batch["labels"]
    mask = batch.get("mask")
    hidden, _, aux = forward(params, cfg, tokens=batch.get("tokens"), embeds=batch.get("embeds"),
                             train=True, return_hidden=True)
    b, s, _ = hidden.shape
    ce_chunk = cfg.ce_chunk or ce_chunk
    zero = torch.zeros((), dtype=torch.float32, device=hidden.device)
    ones = (torch.ones((b, s), dtype=torch.float32, device=hidden.device) if mask is None
            else mask.float())

    def chunk_sums(x_c, labels_c, mask_c):
        logits_c = constrain(unembed_logits(params["embed"], x_c), ("batch", None, "vocab"))
        nll = cross_entropy_from_logits(logits_c, labels_c, mask_c, valid_vocab=cfg.vocab,
                                        reduce=False)
        return nll.sum(), mask_c.sum()

    def sums(x_c, labels_c, mask_c):
        return checkpoint(chunk_sums, x_c, labels_c, mask_c, use_reentrant=False)

    if s > 2 * ce_chunk and s % ce_chunk == 0:
        tot_nll, tot_mask = zero, zero
        for c0 in range(0, s, ce_chunk):
            sn, sm = sums(hidden[:, c0:c0 + ce_chunk], labels[:, c0:c0 + ce_chunk],
                          ones[:, c0:c0 + ce_chunk])
            tot_nll, tot_mask = tot_nll + sn, tot_mask + sm
        ce = tot_nll / tot_mask.clamp(min=1.0)
    else:
        sn, sm = sums(hidden, labels, ones)
        ce = sn / sm.clamp(min=1.0)
    loss = ce + aux
    return loss, {"ce": ce, "aux": aux}


def _stack(tree: Any, n: int) -> Any:
    return tree_map(lambda sd: ((n,) + sd[0], sd[1]), tree)


def cache_spec(cfg: ModelConfig, batch: int, max_seq: int) -> Dict[str, Any]:
    """(shape, dtype) of every decode-cache leaf, stacked over layers (and
    groups). K/V (the MLA latent and RoPE key) are in the compute dtype;
    both mamba state leaves are f32."""
    _require_ported(cfg)
    if cfg.family in _DENSE_STACK:
        if cfg.attention == "mla":
            per = mla_cache_shape(batch, max_seq, cfg.kv_lora_rank, cfg.qk_rope_dim, cfg.dtype)
        else:
            per = gqa_cache_shape(
                batch, max_seq, cfg.n_kv_heads or cfg.n_heads, cfg.resolved_head_dim, cfg.dtype
            )
        return {"layers": _stack(per, cfg.n_layers)}
    mstate = mamba2_state_shape(batch, ssm_config(cfg), torch.float32)
    if cfg.family == "ssm":
        return {"layers": _stack(mstate, cfg.n_layers)}
    ng, per_g, tail = hybrid_layout(cfg)
    attn = gqa_cache_shape(
        batch, max_seq, cfg.n_kv_heads or cfg.n_heads, cfg.resolved_head_dim, cfg.dtype
    )
    out = {"groups_mamba": _stack(_stack(mstate, per_g), ng), "groups_attn": _stack(attn, ng)}
    if tail:
        out["tail"] = _stack(mstate, tail)
    return out


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device: Device = "cuda") -> Dict[str, Any]:
    dev = resolve_device(device)
    return tree_map(lambda sd: torch.zeros(sd[0], dtype=sd[1], device=dev),
                    cache_spec(cfg, batch, max_seq))


def cache_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """Logical axes for every cache leaf, built by construction (mirrors
    ``cache_spec``): batch -> "batch" (data-sharded), the long KV sequence
    axis -> "kv_seq" (model-sharded, ring-attention style), SSM state
    unsharded except batch."""
    attn_ax = {
        "k": ("layers", "batch", "kv_seq", None, None),
        "v": ("layers", "batch", "kv_seq", None, None),
    }
    mla_ax = {
        "c_kv": ("layers", "batch", "kv_seq", None),
        "k_pe": ("layers", "batch", "kv_seq", None),
    }
    ssm_ax = {
        "ssm": ("layers", "batch", None, None, None),
        "conv": ("layers", "batch", None, None),
    }
    if cfg.family in _DENSE_STACK:
        return {"layers": mla_ax if cfg.attention == "mla" else attn_ax}
    if cfg.family == "ssm":
        return {"layers": ssm_ax}
    if cfg.family == "hybrid":
        _, _, tail = hybrid_layout(cfg)
        g_ssm = {
            "ssm": ("groups", "layers", "batch", None, None, None),
            "conv": ("groups", "layers", "batch", None, None),
        }
        g_attn = {
            "k": ("groups", "batch", "kv_seq", None, None),
            "v": ("groups", "batch", "kv_seq", None, None),
        }
        out = {"groups_mamba": g_ssm, "groups_attn": g_attn}
        if tail:
            out["tail"] = ssm_ax
        return out
    raise ValueError(cfg.family)
