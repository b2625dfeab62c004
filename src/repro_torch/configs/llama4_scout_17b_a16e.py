"""llama4-scout-17b-a16e [moe] — MoE top-1 + shared expert, early fusion,
hf:meta-llama/Llama-4-Scout-17B-16E.

48L d_model=5120 40H (GQA kv=8) expert d_ff=8192 vocab=202048,
MoE 16 experts top-1 (+1 shared expert). Early-fusion vision tower is a
frontend stub per the assignment. Full attention -> long_500k skipped.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    d_expert=8192,
    vocab=202048,
    n_experts=16,
    top_k=1,
    n_shared_experts=1,
    rope_theta=500_000.0,
)

SMOKE_CONFIG = CONFIG.scaled(
    name="llama4-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    d_expert=128,
    vocab=512,
    n_experts=4,
    top_k=1,
    n_shared_experts=1,
    attn_chunk=32,
    remat=False,
)
