"""Model code of the port; counterpart of ``repro.models`` (dense family)."""
from .config import ModelConfig
from .convert import params_from_jax
from .layers import ParamSpec, count_params, init_params
from .transformer import cache_spec, forward, init_cache, model_spec

__all__ = [
    "ModelConfig",
    "ParamSpec",
    "cache_spec",
    "count_params",
    "forward",
    "init_cache",
    "init_params",
    "model_spec",
    "params_from_jax",
]
