"""pixtral-12b [vlm] — pixtral-ViT + mistral-nemo backbone,
hf:mistralai/Pixtral-12B-2409.

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072; head_dim=128.
The ViT patchifier is a frontend STUB: train/prefill consume precomputed
patch+text embeddings from ``input_specs()``; decode embeds text tokens.
Full attention -> long_500k skipped.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=131072,
    input_mode="embeds",
    rope_theta=1_000_000.0,
)

SMOKE_CONFIG = CONFIG.scaled(
    name="pixtral-smoke",
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
