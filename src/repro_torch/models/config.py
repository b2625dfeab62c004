"""Model configuration and input-shape cells; counterpart of
``repro.models.config``.

The fields are the reference's, with torch dtypes in place of the jnp ones.
Every family is ported: dense (GQA or MLA), moe, ssm, hybrid, and vlm and
audio, whose backbone is the dense stack fed with embeddings
(``input_mode="embeds"``; audio is ``encoder_only``: no causal mask, no
decode).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Tuple

import torch

from .layers import pad_vocab


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab: int = 0
    head_dim: int = 0  # 0 -> d_model // n_heads
    # attention
    attention: str = "gqa"  # gqa | mla | none
    qk_norm: bool = False
    rope_theta: float = 10000.0
    attn_chunk: int = 1024
    # MLA
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    # SSM
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_chunk: int = 256
    # hybrid (zamba2): one weight-tied attention block every `period` layers
    shared_attn_period: int = 0
    # encoder-only (no causal mask, no decode)
    encoder_only: bool = False
    # input modality: "tokens" or "embeds" (frontend stub supplies embeddings)
    input_mode: str = "tokens"
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    dtype: Any = torch.bfloat16  # compute dtype
    param_dtype: Any = torch.float32
    remat: bool = True
    # remat policy: "nothing" (recompute all — smallest memory), "dots_nb"
    # (save the products with no batch dims), "dots" (save every product);
    # models/transformer.py maps it to a selective-checkpoint policy
    remat_policy: str = "nothing"
    ce_chunk: int = 512

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.n_heads:
            return self.d_model // self.n_heads
        return 0

    @property
    def padded_vocab(self) -> int:
        return pad_vocab(self.vocab) if self.vocab else 0

    @property
    def causal(self) -> bool:
        return not self.encoder_only

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic archs run the long_500k cell (SSM / hybrid)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decode(self) -> bool:
        return not self.encoder_only

    def scaled(self, **overrides: Any) -> "ModelConfig":
        return dataclasses.replace(self, **overrides)

    # ---- parameter / FLOP accounting ----

    def param_count(self) -> int:
        from .layers import count_params
        from .transformer import model_spec

        return count_params(model_spec(self))

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k + shared experts only)."""
        total = self.param_count()
        if self.n_experts and self.top_k:
            per_expert = 3 * self.d_model * self.d_expert
            inactive = (self.n_experts - self.top_k) * per_expert * self.n_layers
            return total - inactive
        return total

    def train_flops_per_token(self) -> float:
        """MODEL_FLOPS/token for a train step: 6·N_active (fwd+bwd). The grid
        trainer's ``est_flop_count`` per job, and so all credit, comes from it."""
        return 6.0 * self.active_param_count()

    def decode_flops_per_token(self, context: int = 0) -> float:
        """2·N_active plus attention score/value FLOPs against the context."""
        f = 2.0 * self.active_param_count()
        if self.attention == "gqa" and self.n_heads:
            f += 4.0 * self.n_heads * self.resolved_head_dim * context
        elif self.attention == "mla":
            f += 4.0 * self.n_heads * (self.kv_lora_rank + self.qk_rope_dim) * context
        return f


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell from the assignment."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)


def get_shape(name: str) -> ShapeConfig:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown shape {name}")


def cell_supported(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether (arch, shape) is a runnable cell; reason if not."""
    if shape.kind == "decode" and not cfg.has_decode:
        return False, "encoder-only architecture has no decode step"
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, "full quadratic attention; long_500k skipped per assignment"
    return True, ""
