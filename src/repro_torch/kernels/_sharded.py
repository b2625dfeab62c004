"""The kernel entries under ranks simulated in one process.

A kernel wrapper given a DTensor runs its kernel on each rank's local
shard (each wrapper's ``_sharded`` function, with the helpers of
``distributed.dtensors``). Ranks simulated in one process
(``launch.mesh.simulated_ranks``) hold their shards as one ``LocalTensor``,
which has no storage of its own: ``per_rank`` wraps each kernel entry so
that it runs once for each rank on that rank's tensors, which launches the
CUDA kernel once a rank, and the launch counters count every one. In a
process of its own a rank's shard is a plain tensor and goes straight
through.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Any, Callable, Optional

import torch
from torch.utils import _pytree as pytree

# argument types that hold no LocalTensor: a call of only these goes
# straight through, without flattening its arguments
_PLAIN = frozenset({torch.Tensor, int, float, bool, str, type(None), torch.dtype})


def _local_tensor_type() -> Optional[type]:
    try:
        from torch.distributed._local_tensor import LocalTensor
    except ImportError:  # a torch without simulated ranks: every shard is a plain tensor
        return None
    return LocalTensor


def _quiet_local_mode() -> Any:
    """A context with the ambient ``LocalTensorMode`` (if any) disabled, so
    that the kernel entries' own ``torch.empty`` calls make plain tensors.
    The mode is found on the dispatch stack, which autograd carries into its
    backward threads."""
    from torch.distributed._local_tensor import LocalTensorMode
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, LocalTensorMode) and not mode._disable:
            return mode.disable()
    return contextlib.nullcontext()


def per_rank(fn: Callable) -> Callable:
    """Wrap a kernel entry of plain tensors: given ``LocalTensor`` arguments
    (simulated ranks), call it once for each rank on that rank's tensors and
    return the outputs as ``LocalTensor``s; otherwise call it as it is."""

    @functools.wraps(fn)
    def call(*args, **kwargs):
        if all(type(a) in _PLAIN for a in args) and all(type(v) in _PLAIN for v in kwargs.values()):
            return fn(*args, **kwargs)
        lt = _local_tensor_type()
        flat, spec = pytree.tree_flatten((args, kwargs))
        if lt is None or not any(isinstance(a, lt) for a in flat):
            return fn(*args, **kwargs)
        ranks = sorted(next(a for a in flat if isinstance(a, lt))._local_tensors)
        outs = {}
        with _quiet_local_mode():
            for r in ranks:
                a_r, k_r = pytree.tree_unflatten(
                    [a._local_tensors[r] if isinstance(a, lt) else a for a in flat], spec)
                outs[r] = fn(*a_r, **k_r)
        leaves = {r: pytree.tree_flatten(o)[0] for r, o in outs.items()}
        out_spec = pytree.tree_flatten(outs[ranks[0]])[1]
        merged = [lt({r: leaves[r][i] for r in ranks}) if isinstance(leaf, torch.Tensor) else leaf
                  for i, leaf in enumerate(leaves[ranks[0]])]
        return pytree.tree_unflatten(merged, out_spec)

    return call
