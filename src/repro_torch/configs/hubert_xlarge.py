"""hubert-xlarge [audio] — encoder-only (w2v2 arch), arXiv:2106.07447.

48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504 (masked-prediction
cluster codebook). The conv feature encoder is a frontend STUB: inputs are
precomputed 20ms frame embeddings. Encoder-only: no decode step ->
decode_32k and long_500k skipped per the assignment.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab=504,
    encoder_only=True,
    input_mode="embeds",
    tie_embeddings=False,
)

SMOKE_CONFIG = CONFIG.scaled(
    name="hubert-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab=64,
    attn_chunk=32,
    remat=False,
)
