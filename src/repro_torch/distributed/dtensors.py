"""DTensor helpers of the sharded step, for the kernel wrappers and the
models alike.

The kernel wrappers run their kernel on each rank's local shard: a
dimension the kernel reduces or scans across is gathered first, by
``placements_keeping`` and ``local``, and the outputs become DTensors again
by ``dtensor``. A replicated operand's local gradient is a partial sum over
each mesh axis that splits the others (``grad_partial_where_sharded``).

The rest works round what DTensor (torch 2.11 on the card, 2.13 on the
CPU) cannot do on the placements the sharding rules give, and is all the
models know of it: ``rows_for_product`` (rows split twice cannot be
flattened for a product), ``embed_lookup`` (lookups in a split table),
``label_logit`` (a gather along a split vocabulary) and ``replicated``
(integer sorts and scatters along a split dimension). Each returns a plain
tensor's result as the unsharded code computes it.
"""
from __future__ import annotations

from typing import Any, Iterable, Optional, Sequence, Tuple

import torch


def is_dtensor(t: Any) -> bool:
    if not isinstance(t, torch.Tensor) or type(t) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def placements_keeping(placements: Sequence[Any], dims: Iterable[int]) -> Tuple[Any, ...]:
    """``placements`` with every ``Shard`` of a dimension outside ``dims``,
    and every pending sum (``Partial``), made ``Replicate``."""
    from torch.distributed.tensor import Replicate

    keep = set(dims)
    return tuple(p if p.is_shard() and p.dim in keep else Replicate() for p in placements)


def grad_partial_where_sharded(placements: Sequence[Any]) -> Tuple[Any, ...]:
    """The placements of a replicated operand's local gradient, when the
    other operands are split by ``placements``: a partial sum over each mesh
    axis that splits them (the scales of rmsnorm, ssd_scan's A, the
    embedding table)."""
    from torch.distributed.tensor import Partial, Replicate

    return tuple(Partial() if p.is_shard() else Replicate() for p in placements)


def local(t: Any, placements: Sequence[Any], grad_placements: Optional[Sequence[Any]] = None) -> Any:
    """``t``'s local shard once it is laid out as ``placements``
    (redistributed where it is not), differentiable: its gradient comes back
    as ``grad_placements`` (default: ``placements``)."""
    if tuple(t.placements) != tuple(placements):
        t = t.redistribute(t.device_mesh, tuple(placements))
    return t.to_local(grad_placements=tuple(grad_placements) if grad_placements else None)


def dtensor(local_t: Any, like: Any, placements: Sequence[Any]) -> Any:
    """A DTensor on ``like``'s mesh from each rank's local output; the shards
    are even, as the inputs' were."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local_t, like.device_mesh, tuple(placements), run_check=False)


def rows_for_product(x: torch.Tensor) -> torch.Tensor:
    """``x`` (..., d) made ready to meet a weight in a product over its last
    axis. A DTensor whose rows are split over an inner dimension as well as
    the first (the residual stream's sequence, besides its batch) has the
    inner ones gathered: the sequence-parallel boundary that the reference's
    ``seq=None`` constraints mark, and DTensor (torch 2.11) cannot flatten
    rows split twice for the product. Anything else is returned as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    inner = [p.is_shard() and 0 < p.dim < x.ndim - 1 for p in x.placements]
    if not any(inner):
        return x
    return x.redistribute(x.device_mesh, [Replicate() if i else p for i, p in zip(inner, x.placements)])


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``. A DTensor table (the sharded step) is gathered
    whole on every rank and each rank's tokens are looked up in it, the rows
    keeping the tokens' placements; the table's local gradient is a partial
    sum over each axis that splits the tokens. DTensor's own lookups fail on
    a split table (the indexing's backward in torch 2.11, ``embedding``'s
    masked partial sum in 2.13)."""
    if not is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import Replicate

    if not is_dtensor(tokens):
        raise TypeError("the lookup of a DTensor table needs DTensor tokens on the same mesh")
    pl = tuple(tokens.placements)
    whole = local(table, (Replicate(),) * len(pl), grad_partial_where_sharded(pl))
    return dtensor(whole[local(tokens, pl)], tokens, pl)


def label_logit(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each row's logit at its label. A DTensor's (its vocabulary split over
    "model") is the reference's one-hot contraction, since DTensor's gather
    along a split dimension fails on its masked partial sum; the contraction
    sums the label's logit with zeros only, which gives the gather's value."""
    if is_dtensor(logits):
        viota = torch.arange(logits.shape[-1], device=logits.device)
        return torch.where(viota == labels.long()[..., None], logits, 0.0).sum(dim=-1)
    return logits.gather(-1, labels.long()[..., None]).squeeze(-1)


def replicated(t: torch.Tensor) -> torch.Tensor:
    """``t`` gathered whole on every rank where it is a DTensor: bookkeeping
    of sorts, scatters and prefix sums over all its entries (the MoE
    routing's) then runs alike on every rank, since DTensor's integer sorts
    and scatters along a split dimension do not give the unsplit result."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate

    return t.redistribute(t.device_mesh, (Replicate(),) * t.device_mesh.ndim)
