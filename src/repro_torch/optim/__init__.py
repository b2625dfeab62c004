"""Optimizer of the port; counterpart of ``repro.optim``: AdamW, and the int8
error-feedback gradient compression with its wire format."""
from .adamw import (
    AdamWConfig,
    AdamWState,
    apply_updates,
    clip_by_global_norm,
    global_norm,
    init_state,
    lr_at,
)
from .compression import (
    compress_tree,
    compressed_bytes,
    decompress_tree,
    ef_quantize_tree,
    init_residual,
)

__all__ = [
    "AdamWConfig",
    "AdamWState",
    "apply_updates",
    "clip_by_global_norm",
    "compress_tree",
    "compressed_bytes",
    "decompress_tree",
    "ef_quantize_tree",
    "global_norm",
    "init_residual",
    "init_state",
    "lr_at",
]
