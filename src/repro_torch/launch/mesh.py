"""Mesh descriptions; counterpart of ``repro.launch.mesh``.

The port's mesh is axis names and sizes, and the ``torch.device`` its step
runs on. ``make_mesh`` raises without a card unless the CPU is asked for;
it never drops to the CPU on its own (``single_device_mesh("cpu")`` asks
for it). A mesh of more than one device
is a ``torch.distributed`` ``DeviceMesh`` over the default process group,
which the caller initialises (one process a rank, or all ranks in one
process under ``simulated_ranks``, the port's counterpart of the
reference's ``--xla_force_host_platform_device_count``). The production
meshes (16 x 16 and 2 x 16 x 16) are not ported yet, so asking for them
raises.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import torch

from repro_torch.device import Device, resolve_device

MULTI_POD_TODO = ("the production meshes (16 x 16 and 2 x 16 x 16) and the dry run on them "
                  "are not ported yet: ROADMAP.md, Queue A 10b.2")


@dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    device: Optional[torch.device] = None  # the device its step runs on (None: a dry-run mesh)
    device_mesh: Any = None  # a mesh of more than one device: its DeviceMesh

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def make_mesh(shape: Sequence[int], axes: Sequence[str], device: Device = "cuda") -> Mesh:
    """A mesh over the first ``prod(shape)`` devices of ``device``'s type.
    More than one device is a ``DeviceMesh`` over the default process group,
    which must be initialised with world size ``prod(shape)``."""
    n = math.prod(shape)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} and axes {tuple(axes)} differ in rank")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if n == 1:
        return Mesh(tuple(axes), tuple(int(s) for s in shape), dev)
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size() if dist.is_initialized() else None
    if world != n:
        raise RuntimeError(
            f"mesh {tuple(shape)} needs the default process group initialised with world size "
            f"{n}, {'found none' if world is None else f'found {world}'} (one process a rank, "
            f"or simulated_ranks({n}) for all of them in this process)")
    device_mesh = init_device_mesh(dev.type, tuple(int(s) for s in shape), mesh_dim_names=tuple(axes))
    return Mesh(tuple(axes), tuple(int(s) for s in shape), dev, device_mesh)


def single_device_mesh(device: Device = "cuda") -> Mesh:
    """1x1 mesh over one device: the card unless the caller asks for the CPU."""
    return make_mesh((1, 1), ("data", "model"), device)


@contextlib.contextmanager
def simulated_ranks(world_size: int) -> Iterator[Any]:
    """Every rank of a ``world_size`` process group in this one process: a
    ``fake`` default group (it carries no data) under ``LocalTensorMode``,
    which runs each op once for every rank on that rank's shard and computes
    the collectives from the shards. Tensors made inside hold one shard a
    rank (the mode, yielded, has ``disable()`` for work of one process);
    the group is destroyed on exit."""
    import torch.distributed as dist
    from torch.distributed._local_tensor import LocalTensorMode
    # torch names the "fake" backend (it is in Backend.backend_list) but
    # registers its creator with c10d only in this module of its own;
    # without it init_process_group("fake") fails: "Unknown c10d backend
    # type FAKE" (torch 2.13)
    from torch.testing._internal.distributed import fake_pg  # noqa: F401

    if dist.is_initialized():
        raise RuntimeError("a default process group is initialised already")
    dist.init_process_group("fake", store=dist.HashStore(), rank=0, world_size=world_size)
    try:
        with LocalTensorMode(world_size) as mode:
            yield mode
    finally:
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh: (16,16) single pod = 256 chips,
    (2,16,16) multi-pod = 512 chips over ("pod","data","model"). Not ported
    yet: raises."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    raise NotImplementedError(f"production mesh {shape}: {MULTI_POD_TODO}")


def mesh_name(mesh: Mesh) -> str:
    return "x".join(str(s) for s in mesh.axis_sizes) + ":" + ",".join(mesh.axis_names)
