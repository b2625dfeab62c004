"""Load the reference's parameter tree into the port.

The reference's tree, as numpy arrays (for example
``jax.tree_util.tree_map(np.asarray, repro.models.init_params(key, spec))``),
becomes the port's tree with the same keys, shapes and layouts, so both
packages compute from the same parameters.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import Device, resolve_device

from .layers import tree_map


def _to_tensor(a: Any) -> torch.Tensor:
    arr = np.array(a, order="C")  # a writable copy: jax hands out read-only buffers
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same bits as torch's
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def params_from_jax(tree: Any, device: Device, dtype: Optional[torch.dtype] = None) -> Any:
    dev = resolve_device(device)
    return tree_map(lambda a: _to_tensor(a).to(device=dev, dtype=dtype), tree)
