"""Logical activation-sharding constraints, mesh-agnostic at the model
layer; counterpart of ``repro.distributed.logical``.

Model code may call ``constrain(x, ("batch", "seq", None))``; what that
does depends on the ambient scope the step builder installs while the step
runs. Without a scope it is a no-op. With one, ``(shape, axes)`` goes to the
scope's function, as in the reference, which returns a partition spec
(the step builder's: its rules' ``spec_for``). A DTensor is redistributed to that spec's
placements on its own device mesh, the counterpart of
``with_sharding_constraint``; a plain tensor, or a spec that puts no
dimension on a mesh axis (every spec of a mesh of one device), leaves ``x``
as it is.

The constraints are not decorative: DTensor refuses an in-place op whose
operands would need new placements (rmsnorm's statistics over a last
dimension sharded on "model" among them), and the residual stream's
``("batch", "seq", None)`` keeps that dimension whole.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Callable, Iterator, Optional, Sequence

import torch

# spec_fn(shape, logical_axes) -> partition spec or None
_SCOPE: contextvars.ContextVar[Optional[Callable]] = contextvars.ContextVar(
    "logical_sharding_scope", default=None
)


@contextlib.contextmanager
def logical_sharding_scope(
    spec_fn: Callable[[Sequence[int], Sequence[Optional[str]]], Any]
) -> Iterator[None]:
    token = _SCOPE.set(spec_fn)
    try:
        yield
    finally:
        _SCOPE.reset(token)


def constrain(x: torch.Tensor, axes: Sequence[Optional[str]]) -> torch.Tensor:
    """Constrain ``x``'s sharding by logical axis names (no-op w/o scope)."""
    spec_fn = _SCOPE.get()
    if spec_fn is None:
        return x
    if len(axes) != x.ndim:
        return x  # defensive: caller passed axes for a different rank
    spec = spec_fn(tuple(x.shape), tuple(axes))
    if spec is None or all(part is None for part in spec):
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    from repro_torch.distributed.sharding import placements

    want = placements(spec, x.device_mesh.mesh_dim_names)
    return x if tuple(x.placements) == want else x.redistribute(x.device_mesh, want)
