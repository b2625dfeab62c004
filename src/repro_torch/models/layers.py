"""Parameter descriptors and basic layers; counterpart of ``repro.models.layers``.

Parameters are nested dicts of tensors with the reference's keys, shapes and
layouts (``wq`` is ``(d, H, hd)``, layers stacked as ``(L, ...)``), so a
reference tree loads one to one (``models/convert.py``). RMSNorm and SwiGLU
route through the kernel wrappers: the CUDA kernel on the card, the plain
version on the CPU.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.device import Device, resolve_device
from repro_torch.distributed.dtensors import embed_lookup, label_logit, rows_for_product
from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.kernels.swiglu.ops import swiglu  # the model's swiglu is the op itself

# ---------------------------------------------------------------------------
# Parameter descriptors
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"  # normal | zeros | ones | embed
    scale: float = 1.0
    dtype: Any = torch.float32
    # read at f32 at every use whatever the compute dtype (RMSNorm scales,
    # Mamba's A_log and dt_bias): the server keeps such leaves in f32
    f32_at_use: bool = False

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")


def is_spec(x: Any) -> bool:
    return isinstance(x, ParamSpec)


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """Apply ``fn`` to every leaf of a tree of nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree: Any) -> list:
    """Leaves in sorted-key order: jax's leaf order for a tree of dicts."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(tree: Any, leaves: list) -> Any:
    """The tree of ``tree``'s structure with ``leaves`` (in ``tree_leaves``
    order) in place of its own."""
    it = iter(leaves)

    def build(t: Any) -> Any:
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    return build(tree)


def init_params(
    generator: torch.Generator,
    spec_tree: Any,
    dtype: Any = None,
    device: Device = "cuda",
) -> Any:
    """Materialize a spec tree into tensors on ``device``.

    Draws come from ``generator`` on its own device, so they match the
    reference's ``jax.random`` draws in distribution only: fan-in scaled
    normals by default, std 0.02 for embeddings."""
    dev = resolve_device(device)

    def make(spec: ParamSpec) -> torch.Tensor:
        dt = dtype or spec.dtype
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dt, device=dev)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dt, device=dev)
        std = spec.scale
        if spec.init == "normal" and spec.scale == 1.0:
            fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
            std = 1.0 / math.sqrt(max(fan_in, 1))
        elif spec.init == "embed":
            std = 0.02
        arr = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                          device=generator.device)
        return (arr * std).to(device=dev, dtype=dt)

    return tree_map(make, spec_tree)


def _tree_map_specs(fn: Callable[[ParamSpec], Any], tree: Any) -> Any:
    return tree_map(fn, tree)


def abstract_params(spec_tree: Any, dtype: Any = None) -> Any:
    """Meta-device stand-ins of every leaf's shape and dtype, the dry run's
    parameters: nothing is allocated."""
    return _tree_map_specs(
        lambda s: torch.empty(s.shape, dtype=dtype or s.dtype, device="meta"), spec_tree
    )


def axes_tree(spec_tree: Any) -> Any:
    return _tree_map_specs(lambda s: s.axes, spec_tree)


def count_params(spec_tree: Any) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(spec_tree))


def stack_layer_specs(spec_tree: Any, n_layers: int, axis_name: str = "layers") -> Any:
    """Add a leading scanned-layers dimension to every spec in the tree."""
    return tree_map(
        lambda s: ParamSpec(
            shape=(n_layers,) + s.shape,
            axes=(axis_name,) + s.axes,
            init=s.init,
            scale=s.scale,
            dtype=s.dtype,
            f32_at_use=s.f32_at_use,
        ),
        spec_tree,
    )


# ---------------------------------------------------------------------------
# Normalization / activation / positional layers
# ---------------------------------------------------------------------------


def rmsnorm_spec(dim: int) -> Dict[str, ParamSpec]:
    return {"scale": ParamSpec((dim,), ("embed",), init="ones", f32_at_use=True)}


def rms_norm(params: Dict[str, torch.Tensor], x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return rmsnorm(x, params["scale"], eps=eps)


def head_rms_norm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """qk-norm (Qwen3): RMS over the head_dim axis of (..., heads, head_dim)."""
    return rmsnorm(x, scale, eps=eps)


def rope_frequencies(head_dim: int, theta: float = 10000.0, device: Device = "cpu") -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotate (..., S, H, D) by position; positions is (..., S). Split-half, in f32."""
    dt = x.dtype
    freqs = rope_frequencies(x.shape[-1], theta, x.device)  # (d/2,)
    angles = positions[..., :, None].float() * freqs  # (..., S, d/2)
    angles = angles[..., :, None, :]  # broadcast over heads
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(dt)


# ---------------------------------------------------------------------------
# Embedding / unembedding (padded vocabulary, tied)
# ---------------------------------------------------------------------------


def embedding_spec(vocab: int, d_model: int) -> Dict[str, ParamSpec]:
    return {"embedding": ParamSpec((vocab, d_model), ("vocab", "embed"), init="embed")}


def embed_tokens(params: Dict[str, torch.Tensor], tokens: torch.Tensor, compute_dtype: Any) -> torch.Tensor:
    # gather first, then cast: the same values as casting the whole table
    return embed_lookup(params["embedding"], tokens).to(compute_dtype)


def unembed_logits(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """(B, S, d) -> (B, S, V_padded)."""
    return rows_for_product(x) @ params["embedding"].to(x.dtype).T


def cross_entropy_from_logits(
    logits: torch.Tensor,
    labels: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    valid_vocab: int = 0,
    reduce: bool = True,
) -> torch.Tensor:
    """Mean CE over tokens, in f32; logits at or past ``valid_vocab`` (the
    padded vocabulary rows) are masked with -1e30 first. With
    ``reduce=False``, the per-token (masked) NLL. The label's logit is
    gathered: the reference's one-hot contraction sums it with zeros only,
    which gives the same value (a DTensor's is that contraction:
    ``label_logit``)."""
    logits = logits.float()
    if valid_vocab and valid_vocab < logits.shape[-1]:
        viota = torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(viota < valid_vocab, logits, -1e30)
    m = logits.amax(dim=-1, keepdim=True)
    lse = torch.log(torch.exp(logits - m).sum(dim=-1)) + m.squeeze(-1)
    nll = lse - label_logit(logits, labels)
    if mask is not None:
        nll = nll * mask
    if not reduce:
        return nll
    if mask is not None:
        return nll.sum() / mask.sum().clamp(min=1.0)
    return nll.mean()


# ---------------------------------------------------------------------------
# Dense MLP (SwiGLU)
# ---------------------------------------------------------------------------


def mlp_spec(d_model: int, d_ff: int) -> Dict[str, ParamSpec]:
    return {
        "gate": ParamSpec((d_model, d_ff), ("embed", "mlp")),
        "up": ParamSpec((d_model, d_ff), ("embed", "mlp")),
        "down": ParamSpec((d_ff, d_model), ("mlp", "embed")),
    }


def mlp_forward(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    x = rows_for_product(x)
    g = x @ params["gate"].to(dt)
    u = x @ params["up"].to(dt)
    return swiglu(g, u) @ params["down"].to(dt)


# ---------------------------------------------------------------------------
# Misc
# ---------------------------------------------------------------------------


def pad_vocab(vocab: int, multiple: int = 256) -> int:
    """Pad embedding tables to a multiple of 256 rows, as the reference does."""
    return ((vocab + multiple - 1) // multiple) * multiple


def causal_mask(s_q: int, s_k: int, offset: int = 0, device: Device = "cuda") -> torch.Tensor:
    """Boolean (s_q, s_k) mask; query i attends to keys <= i + offset."""
    q = torch.arange(s_q, device=resolve_device(device))[:, None] + offset
    k = torch.arange(s_k, device=q.device)[None, :]
    return k <= q
