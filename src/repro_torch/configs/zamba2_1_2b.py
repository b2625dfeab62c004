"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention blocks,
arXiv:2411.15242.

38 Mamba2 layers, d_model=2048, ssm_state=64; ONE weight-tied transformer
block (32H GQA kv=32, d_ff=8192) applied after every 6 mamba layers
(6 applications + 2 tail mamba layers). vocab=32000.
Hybrid/sub-quadratic -> runs long_500k.

As in the reference, the shared block is weight-tied exactly: Zamba2's
per-invocation LoRA deltas on it are omitted.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab=32000,
    ssm_state=64,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    shared_attn_period=6,
)

SMOKE_CONFIG = CONFIG.scaled(
    name="zamba2-smoke",
    n_layers=5,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab=512,
    ssm_state=16,
    ssm_head_dim=16,
    ssm_chunk=16,
    shared_attn_period=2,
    attn_chunk=32,
    remat=False,
)
