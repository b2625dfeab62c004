"""Logical-axis sharding rules -> partition specs -> DTensor placements;
counterpart of ``repro.distributed.sharding``.

One rule table covers all 10 architectures; rules are *resolved per
(config, mesh)*: a logical axis maps onto a mesh axis only when the
dimension divides evenly (e.g. kv_heads=8 cannot shard over model=16 and
falls back to replication, while 96 heads shard fine).

Parallelism described:
  DP    batch        -> ("pod", "data")
  FSDP  param embed  -> "data"
  TP    heads/mlp/vocab -> "model"
  EP    experts      -> "model"
  SP    kv_seq       -> "model"  (decode cache sequence sharding)

The resolution is pure Python and covers every mesh. ``PartitionSpec`` is
the port's own: a tuple of one entry per dimension (a mesh axis, a tuple of
them, or None). ``shardings_from_specs`` turns specs into the placements of
``torch.distributed.tensor`` (one ``Shard(dim)`` or ``Replicate()`` per mesh
axis), which need no process group; only the one-device step runs so far
(``runtime.step_builder.build_step``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.models.layers import tree_map
from repro_torch.optim.adamw import AdamWState

# logical axis -> preferred mesh axes, in priority order
DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "experts": ("model",),
    "embed": ("data",),  # FSDP on parameters
    "kv_seq": ("model",),  # decode-cache sequence sharding
    "capacity": ("data",),  # MoE expert-capacity axis (token parallel)
    "qk_rank": (),
    "kv_rank": (),
    "head_dim": (),
    "layers": (),
    "groups": (),
    "state": (),
    # Megatron-style sequence parallelism: the residual stream between
    # blocks is sharded over "model"; attention/MLP gather it on use.
    "seq": ("model",),
    # SSD chunk axis: intra-chunk work is independent per chunk, so the
    # chunk dimension shards over "model".
    "chunks": ("model",),
}


class PartitionSpec(tuple):
    """One entry per tensor dimension: a mesh axis name, a tuple of them, or
    None (replicated); a tuple of one axis is that axis, as in jax's."""

    def __new__(cls, *parts: Any) -> "PartitionSpec":
        return super().__new__(cls, (p[0] if isinstance(p, tuple) and len(p) == 1 else p
                                     for p in parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


@dataclass(frozen=True)
class ShardingRules:
    mesh_axes: Tuple[str, ...]
    mesh_shape: Dict[str, int]
    rules: Dict[str, Tuple[str, ...]]

    def resolve(self, dim: int, logical: Optional[str]) -> Optional[Any]:
        """Mesh axes for one tensor dimension (None = replicate)."""
        if logical is None:
            return None
        prefs = self.rules.get(logical, ())
        chosen: List[str] = []
        remaining = dim
        for axis in prefs:
            if axis not in self.mesh_shape:
                continue
            n = self.mesh_shape[axis]
            if remaining % n == 0 and n > 1:
                chosen.append(axis)
                remaining //= n
        if not chosen:
            return None
        return tuple(chosen) if len(chosen) > 1 else chosen[0]

    def spec_for(self, shape: Sequence[int], axes: Sequence[Optional[str]]) -> PartitionSpec:
        if len(shape) != len(axes):
            raise ValueError(f"shape {tuple(shape)} and axes {tuple(axes)} differ in rank")
        used: set = set()
        parts: List[Any] = []
        for dim, logical in zip(shape, axes):
            r = self.resolve(dim, logical)
            # a mesh axis may appear only once in a spec
            if r is None:
                parts.append(None)
            elif isinstance(r, tuple):
                r2 = tuple(a for a in r if a not in used)
                used.update(r2)
                parts.append(r2 if r2 else None)
            elif r in used:
                parts.append(None)
            else:
                used.add(r)
                parts.append(r)
        return PartitionSpec(*parts)


def make_rules(mesh: Any, overrides: Optional[Dict[str, Tuple[str, ...]]] = None) -> ShardingRules:
    """The rules of ``mesh`` (``launch.mesh.Mesh``: axis names and sizes)."""
    rules = dict(DEFAULT_RULES)
    if overrides:
        rules.update(overrides)
    return ShardingRules(
        mesh_axes=tuple(mesh.axis_names),
        mesh_shape={a: int(n) for a, n in mesh.shape.items()},
        rules=rules,
    )


# ---------------------------------------------------------------------------
# Tree-level helpers
# ---------------------------------------------------------------------------


def _shape(leaf: Any) -> Tuple[int, ...]:
    """A leaf's shape: a tensor's, or the first entry of a ``(shape, dtype)``
    pair (``cache_spec``, ``input_specs``)."""
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf[0])


def _map2(fn: Any, a: Any, b: Any) -> Any:
    if isinstance(a, dict):
        return {k: _map2(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def param_specs(rules: ShardingRules, spec_tree: Any) -> Any:
    """Partition spec tree for a ParamSpec tree."""
    return tree_map(lambda s: rules.spec_for(s.shape, s.axes), spec_tree)


def tree_specs_from_axes(rules: ShardingRules, sds_tree: Any, axes_tree: Any) -> Any:
    """Partition spec tree for a tree of tensors or ``(shape, dtype)`` pairs
    and its logical-axes tree."""
    return _map2(lambda s, ax: rules.spec_for(_shape(s), ax), sds_tree, axes_tree)


def shardings_from_specs(mesh: Any, spec_tree: Any) -> Any:
    """``torch.distributed.tensor`` placements for each spec: per mesh axis,
    ``Shard(dim)`` for the dimension the spec puts on it, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    def one(spec: PartitionSpec) -> Tuple[Any, ...]:
        dims: Dict[str, int] = {}
        for dim, part in enumerate(spec):
            for axis in (part if isinstance(part, tuple) else (part,)):
                if axis is not None:
                    dims[axis] = dim
        return tuple(Shard(dims[a]) if a in dims else Replicate() for a in mesh.axis_names)

    def walk(t: Any) -> Any:
        if isinstance(t, PartitionSpec):
            return one(t)
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, AdamWState):
            return AdamWState(count=walk(t.count), mu=walk(t.mu), nu=walk(t.nu))
        raise TypeError(f"not a partition spec tree: {type(t).__name__}")

    return walk(spec_tree)


def batch_specs(rules: ShardingRules, batch_tree: Any, seq_axis: Optional[str] = None) -> Any:
    """Input-batch partition specs: the leading dim is the (global) batch."""

    def one(leaf: Any) -> PartitionSpec:
        shape = _shape(leaf)
        axes: List[Optional[str]] = ["batch"] + [None] * (len(shape) - 1)
        if seq_axis and len(shape) >= 2:
            axes[1] = seq_axis
        return rules.spec_for(shape, axes)

    return tree_map(one, batch_tree)


def opt_state_specs(rules: ShardingRules, param_spec_tree: Any, opt_template: Any) -> AdamWState:
    """Adam moments shard exactly like their parameters."""
    pspecs = param_specs(rules, param_spec_tree)
    return AdamWState(count=PartitionSpec(), mu=pspecs, nu=pspecs)

