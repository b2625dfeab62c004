"""Checkpoint/restart following the paper's application-checkpoint protocol
(§3.6); counterpart of ``repro.checkpoint.checkpointer`` with the same
on-disk format, so either package restores what the other wrote.

The runtime *requests* a checkpoint every ``period`` steps; the training
step completes its "outer loop" (the step boundary: never mid-step), writes
atomically, and acknowledges. Restart resumes from the latest manifest.

Storage: one ``.npz`` per tree under ``step_{step:010d}/`` plus a JSON
manifest with the step, the time and per-file sha256 checksums (the paper's
file immutability and hash validation, §2.2/§3.10). Writes go to a ``.tmp``
directory that is then renamed (atomic on POSIX); ``keep`` bounds how many
steps stay on disk.

Leaf keys are the tree paths joined by ``/``, as jax's
``tree_flatten_with_path`` spells them: dict keys in sorted order, a
NamedTuple's field names, sequence indices. So the train loop's trees give
``params/...`` keys such as ``embed/embedding`` and ``layers/attn/wq``, and
``opt`` keys ``count``, ``mu/...`` and ``nu/...``. Tensors go to the host
with ``.cpu().numpy()`` and restore onto the template's device and dtype. A
Python ``int`` leaf (``AdamWState.count``) is written as a 0-d int32 array,
as the reference's count is, and restored as an ``int``. numpy has no
bfloat16, so a bfloat16 tensor leaf raises.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch


def _children(tree: Any) -> Optional[List[Tuple[str, Any]]]:
    """(key, child) pairs of an inner node in jax's order; None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # NamedTuple
        return [(f, getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    if tree is None:  # an empty subtree, as in jax
        return []
    return None


def _flatten_with_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [kv for k, v in kids for kv in _flatten_with_paths(v, f"{prefix}/{k}" if prefix else k)]


def _map_with_paths(fn: Callable[[str, Any], Any], tree: Any, prefix: str = "") -> Any:
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree)
    if tree is None:
        return None
    new = {k: _map_with_paths(fn, v, f"{prefix}/{k}" if prefix else k) for k, v in kids}
    if isinstance(tree, dict):
        return {k: new[str(k)] for k in tree}
    if hasattr(tree, "_fields"):
        return type(tree)(**new)
    return type(tree)(new[str(i)] for i in range(len(tree)))


def _to_numpy(key: str, leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError(f"checkpoint leaf {key!r} is bfloat16, which numpy (and so the .npz "
                            f"format) cannot hold; save it as float32")
        return leaf.detach().cpu().numpy()
    if isinstance(leaf, int) and not isinstance(leaf, bool):
        return np.asarray(leaf, dtype=np.int32)
    return np.asarray(leaf)


def _from_numpy(arr: np.ndarray, template: Any) -> Any:
    if isinstance(template, torch.Tensor):
        return torch.from_numpy(arr).to(device=template.device, dtype=template.dtype)
    if isinstance(template, int) and not isinstance(template, bool):
        return int(arr)
    return arr.astype(np.asarray(template).dtype)


def _checksum(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


@dataclass
class Checkpointer:
    directory: str
    keep: int = 3

    def __post_init__(self) -> None:
        os.makedirs(self.directory, exist_ok=True)

    # ------------------------------------------------------------------

    def save(self, step: int, trees: Dict[str, Any], meta: Optional[Dict] = None) -> str:
        """Atomically write {name: tree} at ``step``; returns the checkpoint dir."""
        final = os.path.join(self.directory, f"step_{step:010d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest: Dict[str, Any] = {
            "step": step,
            "time": time.time(),
            "files": {},
            "meta": meta or {},
        }
        for name, tree in trees.items():
            arrays = {k: _to_numpy(k, leaf) for k, leaf in _flatten_with_paths(tree)}
            fpath = os.path.join(tmp, f"{name}.npz")
            np.savez(fpath, **arrays)
            manifest["files"][name] = {
                "file": f"{name}.npz",
                "sha256": _checksum(fpath),
                "n_arrays": len(arrays),
            }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()
        return final

    # ------------------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(
        self, templates: Dict[str, Any], step: Optional[int] = None
    ) -> Tuple[int, Dict[str, Any]]:
        """Restore {name: tree} using ``templates`` for structure, dtypes and
        devices. Verifies checksums (hash validation of downloaded files, §2.2)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        d = os.path.join(self.directory, f"step_{step:010d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        out: Dict[str, Any] = {}
        for name, template in templates.items():
            entry = manifest["files"][name]
            fpath = os.path.join(d, entry["file"])
            if _checksum(fpath) != entry["sha256"]:
                raise IOError(f"checksum mismatch for {fpath}")
            with np.load(fpath) as data:
                out[name] = _map_with_paths(lambda key, leaf: _from_numpy(data[key], leaf),
                                            template)
        return manifest["step"], out

    # ------------------------------------------------------------------

    def _steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def _gc(self) -> None:
        steps = self._steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"), ignore_errors=True)


@dataclass
class CheckpointPolicy:
    """The client-side checkpoint request cadence (§3.6)."""

    period_steps: int = 50
    last_requested: int = -1
    last_acked: int = -1

    def should_checkpoint(self, step: int) -> bool:
        return step > 0 and step % self.period_steps == 0

    def ack(self, step: int) -> None:
        self.last_acked = step
