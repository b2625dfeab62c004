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
axis), and ``distribute_tree`` places a tree of tensors with them on a
mesh of more than one device (``runtime.step_builder.build_step``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

# the models and AdamW are imported where they are used: the kernels import
# ``distributed.dtensors``, and the models import the kernels

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
    from repro_torch.models.layers import tree_map

    return tree_map(lambda s: rules.spec_for(s.shape, s.axes), spec_tree)


def tree_specs_from_axes(rules: ShardingRules, sds_tree: Any, axes_tree: Any) -> Any:
    """Partition spec tree for a tree of tensors or ``(shape, dtype)`` pairs
    and its logical-axes tree."""
    return _map2(lambda s, ax: rules.spec_for(_shape(s), ax), sds_tree, axes_tree)


def placements(spec: PartitionSpec, axis_names: Sequence[str]) -> Tuple[Any, ...]:
    """The ``torch.distributed.tensor`` placements of one spec on a mesh of
    ``axis_names``: per mesh axis ``Shard(dim)`` for the dimension the spec
    puts on it, else ``Replicate()``. A dimension on several axes is split
    over them in mesh order, as jax splits it."""
    from torch.distributed.tensor import Replicate, Shard

    dims: Dict[str, int] = {}
    for dim, part in enumerate(spec):
        for axis in (part if isinstance(part, tuple) else (part,)):
            if axis is not None:
                dims[axis] = dim
    return tuple(Shard(dims[a]) if a in dims else Replicate() for a in axis_names)


def shardings_from_specs(mesh: Any, spec_tree: Any) -> Any:
    """``placements`` of each spec of a tree of them (params, AdamW state)."""
    from repro_torch.optim.adamw import AdamWState

    def walk(t: Any) -> Any:
        if isinstance(t, PartitionSpec):
            return placements(t, mesh.axis_names)
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, AdamWState):
            return AdamWState(count=walk(t.count), mu=walk(t.mu), nu=walk(t.nu))
        raise TypeError(f"not a partition spec tree: {type(t).__name__}")

    return walk(spec_tree)


def distribute_tree(mesh: Any, tree: Any, placement_tree: Any) -> Any:
    """Each tensor of ``tree`` as a DTensor on ``mesh``'s device mesh with
    its placements (``shardings_from_specs``); a DTensor already so placed
    is kept, one placed otherwise is redistributed. Every rank holds the
    whole tensor before (the same values, as on the reference's host).

    Ranks simulated in one process (``launch.mesh.simulated_ranks``) are
    given their own copy of each shard (``_own_shards``)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.optim.adamw import AdamWState

    def one(t: Any, pl: Tuple[Any, ...]) -> Any:
        if isinstance(t, DTensor):
            return t if tuple(t.placements) == tuple(pl) else t.redistribute(mesh.device_mesh, pl)
        return _own_shards(distribute_tensor(t, mesh.device_mesh, pl))

    if isinstance(tree, AdamWState):
        return AdamWState(count=tree.count,
                          mu=distribute_tree(mesh, tree.mu, placement_tree.mu),
                          nu=distribute_tree(mesh, tree.nu, placement_tree.nu))
    return _map2(one, tree, placement_tree)


def _own_shards(d: Any) -> Any:
    """``d`` with a tensor of its own for every simulated rank. Under
    ``LocalTensorMode`` a replicated DTensor holds one plain tensor for all
    ranks, and shards are views of the one distributed tensor, shared by
    the ranks that hold the same shard; an in-place update from per-rank
    values (AdamW's, of params and moments) would then be applied once a
    rank to the same memory. Outside the mode ``d`` is returned as it is."""
    try:
        from torch.distributed._local_tensor import enabled_local_tensor_mode
    except ImportError:  # a torch without simulated ranks
        return d
    mode = enabled_local_tensor_mode()
    if mode is None:
        return d
    from torch.distributed.tensor import DTensor

    local = d.to_local()
    shards = getattr(local, "_local_tensors", None)
    if shards is None:
        own = mode.rank_map(lambda r: local.clone())
    elif len({x.untyped_storage().data_ptr() for x in shards.values()}) < len(shards):
        own = mode.tensor_map(local, lambda r, x: x.clone())
    else:
        return d
    return DTensor.from_local(own, d.device_mesh, d.placements, run_check=False,
                              shape=d.shape, stride=d.stride())


def batch_specs(rules: ShardingRules, batch_tree: Any, seq_axis: Optional[str] = None) -> Any:
    """Input-batch partition specs: the leading dim is the (global) batch."""

    def one(leaf: Any) -> PartitionSpec:
        shape = _shape(leaf)
        axes: List[Optional[str]] = ["batch"] + [None] * (len(shape) - 1)
        if seq_axis and len(shape) >= 2:
            axes[1] = seq_axis
        return rules.spec_for(shape, axes)

    from repro_torch.models.layers import tree_map

    return tree_map(one, batch_tree)


def opt_state_specs(rules: ShardingRules, param_spec_tree: Any, opt_template: Any) -> Any:
    """Adam moments shard exactly like their parameters (an ``AdamWState``)."""
    from repro_torch.optim.adamw import AdamWState

    pspecs = param_specs(rules, param_spec_tree)
    return AdamWState(count=PartitionSpec(), mu=pspecs, nu=pspecs)

