"""Model code of the port; counterpart of ``repro.models`` (dense GQA and
MLA, moe, ssm, hybrid, and the vlm and audio backbones with their frontend
stubs in ``frontends``)."""
from . import frontends
from .config import SHAPES, ModelConfig, ShapeConfig, cell_supported, get_shape
from .convert import params_from_jax
from .layers import ParamSpec, abstract_params, axes_tree, count_params, init_params
from .ssm import SSMConfig
from .transformer import (
    cache_axes,
    cache_spec,
    forward,
    hybrid_layout,
    init_cache,
    model_spec,
    ssm_config,
    train_loss,
)

__all__ = [
    "SHAPES",
    "ModelConfig",
    "ParamSpec",
    "SSMConfig",
    "ShapeConfig",
    "abstract_params",
    "axes_tree",
    "cache_axes",
    "cache_spec",
    "cell_supported",
    "count_params",
    "forward",
    "frontends",
    "get_shape",
    "hybrid_layout",
    "init_cache",
    "init_params",
    "model_spec",
    "params_from_jax",
    "ssm_config",
    "train_loss",
]
