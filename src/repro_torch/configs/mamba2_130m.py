"""mamba2-130m [ssm] — SSD (state-space duality), arXiv:2405.21060.

24L d_model=768 attn-free d_ff=0 vocab=50280, ssm_state=128.
Runs long_500k (recurrent state is O(1) in sequence length).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    vocab=50280,
    attention="none",
    ssm_state=128,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_groups=1,
    ssm_chunk=256,
)

SMOKE_CONFIG = CONFIG.scaled(
    name="mamba2-smoke",
    n_layers=2,
    d_model=64,
    vocab=512,
    ssm_state=16,
    ssm_head_dim=16,
    ssm_chunk=16,
    remat=False,
)
