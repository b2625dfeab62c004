"""qwen3-moe-235b-a22b [moe] — 128 experts top-8, hf:Qwen/Qwen3-235B-A22B
(family hf:Qwen/Qwen3-30B-A3B).

94L d_model=4096 64H (GQA kv=4) expert d_ff=1536 vocab=151936,
MoE 128e top-8, qk_norm. Full attention -> long_500k skipped.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    d_expert=1536,
    vocab=151936,
    n_experts=128,
    top_k=8,
    qk_norm=True,
    rope_theta=1_000_000.0,
)

SMOKE_CONFIG = CONFIG.scaled(
    name="qwen3-moe-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=64,
    d_expert=64,
    vocab=512,
    n_experts=8,
    top_k=2,
    attn_chunk=32,
    remat=False,
)
