"""Optimizer of the port; counterpart of ``repro.optim`` (AdamW only: the
reference's gradient compression is not ported)."""
from .adamw import (
    AdamWConfig,
    AdamWState,
    apply_updates,
    clip_by_global_norm,
    global_norm,
    init_state,
    lr_at,
)

__all__ = [
    "AdamWConfig",
    "AdamWState",
    "apply_updates",
    "clip_by_global_norm",
    "global_norm",
    "init_state",
    "lr_at",
]
