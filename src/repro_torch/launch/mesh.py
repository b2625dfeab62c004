"""Mesh descriptions; counterpart of ``repro.launch.mesh``.

The port's mesh is a plain description: axis names and sizes, and on a
mesh of one device the ``torch.device`` its step runs on. ``make_mesh``
counts the cards and raises when they are too few; it never drops to the
CPU on its own (``single_device_mesh("cpu")`` asks for it). The production
meshes (16 x 16 and 2 x 16 x 16) describe what the sharded step will run
on; that step is not ported yet, so asking for them raises.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.device import Device, resolve_device

SHARDED_STEP_TODO = ("the sharded step over a mesh of more than one device (DTensor over a "
                     "process group) is not ported yet: ROADMAP.md, Queue A")


@dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    device: Optional[torch.device] = None  # the device of a mesh of one

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def make_mesh(shape: Sequence[int], axes: Sequence[str], device: Device = "cuda") -> Mesh:
    """A mesh over the first ``prod(shape)`` devices of ``device``'s type;
    more than one is the sharded step's, not ported yet."""
    n = math.prod(shape)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} and axes {tuple(axes)} differ in rank")
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(f"need {n} devices, have {torch.cuda.device_count()}")
    if n != 1:
        raise NotImplementedError(f"mesh {tuple(shape)}: {SHARDED_STEP_TODO}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(tuple(axes), tuple(int(s) for s in shape), dev)


def single_device_mesh(device: Device = "cuda") -> Mesh:
    """1x1 mesh over one device: the card unless the caller asks for the CPU."""
    return make_mesh((1, 1), ("data", "model"), device)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh: (16,16) single pod = 256 chips,
    (2,16,16) multi-pod = 512 chips over ("pod","data","model"). Not ported
    yet: raises."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    raise NotImplementedError(f"production mesh {shape}: {SHARDED_STEP_TODO}")


def mesh_name(mesh: Mesh) -> str:
    return "x".join(str(s) for s in mesh.axis_sizes) + ":" + ",".join(mesh.axis_names)
