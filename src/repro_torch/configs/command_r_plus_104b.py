"""command-r-plus-104b [dense] — GQA, no-bias, hf:CohereForAI/c4ai-command-r-plus.

64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000; head_dim=128.
The FSDP+TP sharding stress case of the pool. Full attention ->
long_500k skipped.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    head_dim=128,
    d_ff=33792,
    vocab=256000,
    rope_theta=75_000_000.0,
)

SMOKE_CONFIG = CONFIG.scaled(
    name="command-r-smoke",
    n_layers=2,
    d_model=96,
    n_heads=6,
    n_kv_heads=2,
    head_dim=16,
    d_ff=256,
    vocab=512,
    attn_chunk=32,
    remat=False,
)
