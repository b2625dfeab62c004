"""qwen3-0.6b [dense] — qk_norm + GQA, hf:Qwen/Qwen3-0.6B (family hf:Qwen/Qwen3-8B).

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936; head_dim=128
(Qwen3 decouples head_dim from d_model/n_heads).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
)

SMOKE_CONFIG = CONFIG.scaled(
    name="qwen3-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=512,
    attn_chunk=32,
    remat=False,
)
