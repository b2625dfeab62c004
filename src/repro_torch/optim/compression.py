"""Int8 error-feedback gradient compression; counterpart of
``repro.optim.compression``.

Two paths, as in the reference:

* ``compress_tree`` / ``decompress_tree`` — the wire format (BOINC's
  "upload compression", paper §2.2, adapted to gradient trees): every leaf
  through the int8 quantize/dequantize kernels (``kernels/int8_quant``) on
  the card, their plain versions on the CPU.
* ``ef_quantize_tree`` — the round trip plus the residual update of error
  feedback, one scale per leaf. The reference writes it as inline jnp ops,
  not through its kernel (``compression.py:26-49``), and so does the port:
  plain tensor ops in the reference's order.

The payload is wire-compatible with the reference's: per leaf ``q`` (int8,
(rows, 256)), ``s`` (f32 scales, (nb, 1)), ``n``, ``shape`` and ``dtype``
spelt as numpy and jax spell it (``"float32"``, ``"bfloat16"``), leaves in
sorted-key order (jax's order for a tree of dicts). ``treedef`` is the tree
with ``None`` in place of each leaf, where the reference keeps a jax
``PyTreeDef``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.kernels.int8_quant.ops import int8_dequantize, int8_quantize
from repro_torch.models.layers import tree_leaves, tree_map, tree_unflatten


def ef_quantize_tree(grads: Any, residual: Any, interpret: bool = True) -> Tuple[Any, Any]:
    """Quantize (grads + residual) to int8 resolution; returns
    (quantized_grads, new_residual). Shapes and dtypes preserved; the
    residual is f32. ``interpret``, the reference's keyword, is accepted
    and ignored: no kernel runs here, in the reference either."""

    def one(g: torch.Tensor, r: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        g32 = g.float() + r
        amax = torch.clamp_min(torch.amax(torch.abs(g32)), 1e-12)
        scale = amax / 127.0
        q = torch.clamp(torch.round(g32 / scale), -127, 127)
        deq = q * scale
        return deq.to(g.dtype), g32 - deq

    outs = [one(g, r) for g, r in zip(tree_leaves(grads), tree_leaves(residual))]
    return (tree_unflatten(grads, [o[0] for o in outs]),
            tree_unflatten(grads, [o[1] for o in outs]))


def init_residual(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


# ---------------------------------------------------------------------------
# Wire format (host-to-coordinator payloads in the grid runtime)
# ---------------------------------------------------------------------------


def compress_tree(tree: Any, interpret: bool = True) -> Dict[str, Any]:
    """Every leaf through ``int8_quantize``. ``interpret``, the reference's
    keyword, goes to the wrapper, which accepts and ignores it: a CUDA leaf
    runs the CUDA kernel either way."""
    payload = []
    for leaf in tree_leaves(tree):
        q, s = int8_quantize(leaf, interpret=interpret)
        payload.append({"q": q, "s": s, "n": leaf.numel(), "shape": tuple(leaf.shape),
                        "dtype": str(leaf.dtype).replace("torch.", "")})
    return {"treedef": tree_map(lambda _: None, tree), "payload": payload}


def decompress_tree(packed: Dict[str, Any], interpret: bool = True) -> Any:
    """Every leaf through ``int8_dequantize`` (``interpret`` as in
    ``compress_tree``)."""
    leaves = [
        int8_dequantize(item["q"], item["s"], n=item["n"], shape=tuple(item["shape"]),
                        out_dtype=getattr(torch, item["dtype"]), interpret=interpret)
        for item in packed["payload"]
    ]
    return tree_unflatten(packed["treedef"], leaves)


def compressed_bytes(packed: Dict[str, Any]) -> int:
    """Bytes on the wire: the int8 codes and the f32 scales, padding included."""
    return sum(i["q"].numel() + i["s"].numel() * 4 for i in packed["payload"])
