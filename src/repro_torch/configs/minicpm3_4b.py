"""minicpm3-4b [dense] — MLA, hf:openbmb/MiniCPM3-4B.

62L d_model=2560 40H (GQA kv=40 via MLA) d_ff=6400 vocab=73448.
MLA ranks from the HF config: q_lora_rank=768, kv_lora_rank=256,
qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64.
Full attention -> long_500k skipped (DESIGN.md §4).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab=73448,
    attention="mla",
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_nope_dim=64,
    qk_rope_dim=32,
    v_head_dim=64,
)

SMOKE_CONFIG = CONFIG.scaled(
    name="minicpm3-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=512,
    q_lora_rank=32,
    kv_lora_rank=16,
    qk_nope_dim=16,
    qk_rope_dim=8,
    v_head_dim=16,
    attn_chunk=32,
    remat=False,
)
