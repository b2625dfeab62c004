"""Gradient, train, prefill, encoder and decode steps, and the inputs each
takes; counterpart of ``repro.runtime.step_builder``.

PyTorch runs eagerly, so a step is a plain function over (params, inputs,
cache); nothing is traced or compiled. The cache is updated in place and
returned. ``make_grad_step`` is the grid trainer's job body: gradients of
``train_loss`` for every parameter leaf, as a tree shaped like the params.
``input_specs`` gives ``(shape, dtype)`` for every input of a cell's step
kind, nested as the reference's ``ShapeDtypeStruct`` tree.

``build_step`` gives a cell's ``StepBundle``, the single entry point of the
dry run: ``lower()`` runs the step once on the meta device (nothing is
allocated) under the cost counter and returns what the dry run reads;
calling the bundle runs the step on its mesh, under the logical scope of
its sharding rules. On a mesh of more than one device (a ``DeviceMesh``
over a process group, ``launch.mesh.make_mesh``) the train step runs on
DTensors: the params, the AdamW moments and the batch are placed by the
rules' specs (``sharding.distribute_tree``), the model's ``constrain``
calls redistribute its activations, the kernel wrappers run on each rank's
shards, and the step returns DTensors. Prefill, encoder and decode steps
over such a mesh, and ``lower()`` of any step on one, are not ported yet
(``SHARDED_TODO``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.distributed.hlo_costs import ModuleCosts, counting, tensors_in
from repro_torch.distributed.dtensors import is_dtensor
from repro_torch.distributed.logical import logical_sharding_scope
from repro_torch.distributed.sharding import (
    PartitionSpec,
    ShardingRules,
    batch_specs,
    distribute_tree,
    make_rules,
    opt_state_specs,
    param_specs,
    shardings_from_specs,
)
from repro_torch.launch.mesh import Mesh
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.models.layers import abstract_params, tree_leaves, tree_map, tree_unflatten, unembed_logits
from repro_torch.models.transformer import cache_spec, forward, model_spec, train_loss
from repro_torch.optim.adamw import AdamWConfig, AdamWState, apply_updates, init_state


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """``(shape, dtype)`` of every input of the step kind of ``shape``:
    ``labels`` and ``tokens`` (int32) or bf16 ``embeds`` for a train step;
    ``tokens`` or ``embeds``, and the decode cache where the arch decodes,
    for a prefill; one token a sequence, the cache and the index for a
    decode step."""
    b, s = shape.global_batch, shape.seq_len
    inputs: Dict[str, Any] = {}
    if cfg.input_mode == "embeds":
        inputs["embeds"] = ((b, s, cfg.d_model), torch.bfloat16)
    else:
        inputs["tokens"] = ((b, s), torch.int32)
    if shape.kind == "train":
        return {"batch": {"labels": ((b, s), torch.int32), **inputs}}
    if shape.kind == "prefill":
        out: Dict[str, Any] = {"batch": inputs}
        if cfg.has_decode:
            out["cache"] = cache_spec(cfg, b, s)
        return out
    if shape.kind == "decode":
        return {"tokens": ((b, 1), torch.int32), "cache": cache_spec(cfg, b, s),
                "index": ((), torch.int32)}
    raise ValueError(shape.kind)


SHARDED_TODO = ("prefill, encoder and decode steps over a mesh of more than one device, and the "
                "dry run (lower) on such a mesh, are not ported yet: ROADMAP.md, Queue A 10b.2")


def make_grad_step(cfg: ModelConfig) -> Callable[..., Tuple[Any, Dict[str, torch.Tensor]]]:
    """Gradient-only step: ``(grads, {"loss", "ce", "aux"})``. The params are
    not modified; each gradient has its parameter's shape and dtype, and a
    DTensor parameter's gradient its placements (pending sums reduced, as
    AdamW's in-place updates need)."""

    def grad_step(params: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        live = tree_unflatten(params, leaves)
        with torch.enable_grad():
            loss, parts = train_loss(live, cfg, batch)
            grads = torch.autograd.grad(loss, leaves)
        grads = [g.redistribute(p.device_mesh, p.placements)
                 if is_dtensor(g) and tuple(g.placements) != tuple(p.placements) else g
                 for p, g in zip(leaves, grads)]
        metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in parts.items()}}
        return tree_unflatten(params, list(grads)), metrics

    return grad_step


def make_train_step(
    cfg: ModelConfig, opt_cfg: AdamWConfig
) -> Callable[..., Tuple[Any, AdamWState, Dict[str, torch.Tensor]]]:
    """Gradient step then AdamW: ``(params, opt_state, metrics)``; the params
    and moments are updated in place (``optim.adamw.apply_updates``)."""
    grad_step = make_grad_step(cfg)

    def train_step(params: Dict[str, Any], opt_state: AdamWState, batch: Dict[str, torch.Tensor]):
        grads, metrics = grad_step(params, batch)
        new_params, new_opt, opt_metrics = apply_updates(opt_cfg, params, grads, opt_state)
        return new_params, new_opt, {**metrics, **opt_metrics}

    return train_step


def make_prefill_step(cfg: ModelConfig) -> Callable[..., Tuple[torch.Tensor, Any]]:
    """Prefill of ``batch["tokens"]`` or ``batch["embeds"]`` (a vlm's patch
    embeddings) into ``cache`` from index 0: the last position's logits
    and the cache."""

    @torch.no_grad()
    def prefill_step(params: Dict[str, Any], batch: Dict[str, torch.Tensor], cache: Any):
        hidden, new_cache, _ = forward(
            params, cfg, tokens=batch.get("tokens"), embeds=batch.get("embeds"), cache=cache,
            cache_index=0, return_hidden=True
        )
        # the reference unembeds every position and keeps the last; the rows
        # are independent, so unembedding the last one gives the same logits
        return unembed_logits(params["embed"], hidden[:, -1:, :]), new_cache

    return prefill_step


def make_encoder_step(cfg: ModelConfig) -> Callable[..., torch.Tensor]:
    """Encoder-only forward (hubert): the logits (B, S, V_padded) of every
    position of ``batch["embeds"]`` (or ``batch["tokens"]``)."""

    @torch.no_grad()
    def encoder_step(params: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        logits, _, _ = forward(params, cfg, tokens=batch.get("tokens"), embeds=batch.get("embeds"))
        return logits

    return encoder_step


def make_decode_step(cfg: ModelConfig) -> Callable[..., Tuple[torch.Tensor, Any]]:
    @torch.no_grad()
    def decode_step(params: Dict[str, Any], tokens: torch.Tensor, cache: Any, index: int):
        logits, new_cache, _ = forward(params, cfg, tokens=tokens, cache=cache, cache_index=index)
        return logits, new_cache

    return decode_step


# ---------------------------------------------------------------------------
# Step bundles (the dry run's entry point)
# ---------------------------------------------------------------------------


def _size(ts: list) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


@dataclass
class MemoryAnalysis:
    """What the step holds on its device: its arguments, its outputs (of
    which ``alias`` are arguments updated in place: params, moments, cache)
    and ``temp``, the most bytes it allocates alive at once (its new outputs
    among them)."""

    argument_size_in_bytes: int
    output_size_in_bytes: int
    alias_size_in_bytes: int
    temp_size_in_bytes: int


@dataclass
class LoweredStep:
    """A step run once on the meta device under the cost counter: what the
    dry run reads, as the reference reads a compiled module."""

    costs: ModuleCosts
    memory: MemoryAnalysis
    seconds: float  # the meta run's wall


@dataclass
class StepBundle:
    """Everything needed to run or lower one (arch, shape, mesh) cell: the
    reference's bundle (the sharding rules and the params' specs among it),
    and the port's own fields after ``kind``."""

    cfg: ModelConfig
    shape: ShapeConfig
    mesh: Mesh
    rules: ShardingRules
    fn: Callable  # the step
    in_specs: Tuple[Any, ...]  # meta tensors (and the decode index), in call order
    param_pspecs: Any
    kind: str
    donated: Tuple[int, ...] = ()  # the arguments the step updates in place
    donate: bool = True  # False: ``__call__`` copies those first
    # each argument's placements, read on a mesh of more than one device
    in_shardings: Tuple[Any, ...] = ()

    def _spec_fn(self) -> Callable[..., PartitionSpec]:
        return self.rules.spec_for

    def lower(self) -> LoweredStep:
        """Run the step once on the meta device, counted."""
        if self.mesh.size != 1:
            raise NotImplementedError(f"lower() on mesh {self.mesh.axis_sizes}: {SHARDED_TODO}")
        args = self.in_specs
        t0 = time.perf_counter()
        with counting() as costs, logical_sharding_scope(self._spec_fn()):
            out = self.fn(*args)
        seconds = time.perf_counter() - t0
        arg_ts, out_ts = tensors_in(args), tensors_in(out)
        arg_storages = {t.untyped_storage()._cdata for t in arg_ts}
        memory = MemoryAnalysis(
            argument_size_in_bytes=_size(arg_ts),
            output_size_in_bytes=_size(out_ts),
            alias_size_in_bytes=_size([t for t in out_ts
                                       if t.untyped_storage()._cdata in arg_storages]),
            temp_size_in_bytes=costs.peak_bytes,
        )
        return LoweredStep(costs, memory, seconds)

    def __call__(self, *args: Any) -> Any:
        """Run the step on the mesh; with ``donate=False`` the arguments it
        would update in place are copied first. On a mesh of more than one
        device the arguments (whole tensors, or DTensors) are placed by
        ``in_shardings`` first and the outputs are DTensors."""
        dev = self.mesh.device
        if dev is None:
            raise ValueError("this mesh has no device: a dry-run mesh can be lowered, not run")
        for t in tensors_in(args):
            if t.device != dev:
                raise ValueError(f"the step runs on {dev}, got a tensor on {t.device}")
        if not self.donate:
            args = tuple(_clone(a) if i in self.donated else a for i, a in enumerate(args))
        with logical_sharding_scope(self._spec_fn()):
            if self.mesh.device_mesh is None:
                return self.fn(*args)
            from torch.distributed.tensor.experimental import implicit_replication

            args = tuple(distribute_tree(self.mesh, a, pl) for a, pl in zip(args, self.in_shardings))
            # the step's own tensors (positions, masks, AdamW's scalars) are
            # the same on every rank: replicated where they meet DTensors
            with implicit_replication():
                return self.fn(*args)


def _clone(tree: Any) -> Any:
    if isinstance(tree, AdamWState):
        return AdamWState(tree.count, _clone(tree.mu), _clone(tree.nu))
    return tree_map(torch.clone, tree)


def _meta(tree: Any) -> Any:
    """Meta tensors for a tree of ``(shape, dtype)`` pairs."""
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    shape, dtype = tree
    return torch.empty(shape, dtype=dtype, device="meta")


def build_step(
    cfg: ModelConfig,
    shape: ShapeConfig,
    mesh: Mesh,
    opt_cfg: Optional[AdamWConfig] = None,
    rules_overrides: Optional[Dict[str, Tuple[str, ...]]] = None,
    donate: bool = True,
) -> StepBundle:
    """The step of one cell on ``mesh``. The port's steps update params,
    moments and cache in place (donated); ``donate=False`` copies them
    first. Over a mesh of more than one device only the train step is
    ported (``SHARDED_TODO``)."""
    rules = make_rules(mesh, rules_overrides)
    spec_tree = model_spec(cfg)
    p_abstract = abstract_params(spec_tree, cfg.param_dtype)
    p_pspecs = param_specs(rules, spec_tree)
    ins = input_specs(cfg, shape)
    if mesh.size != 1 and shape.kind != "train":
        raise NotImplementedError(f"build_step({shape.kind!r}) on mesh {mesh.axis_sizes}: "
                                  f"{SHARDED_TODO}")

    def bundle(fn: Callable, in_specs: Tuple[Any, ...], kind: str, donated: Tuple[int, ...],
               in_shardings: Tuple[Any, ...] = ()):
        return StepBundle(cfg, shape, mesh, rules, fn, in_specs, p_pspecs, kind, donated, donate,
                          in_shardings)

    if shape.kind == "train":
        step = make_train_step(cfg, opt_cfg or AdamWConfig())
        in_shardings = (shardings_from_specs(mesh, p_pspecs),
                        shardings_from_specs(mesh, opt_state_specs(rules, spec_tree, None)),
                        shardings_from_specs(mesh, batch_specs(rules, ins["batch"])))
        return bundle(step, (p_abstract, init_state(p_abstract), _meta(ins["batch"])), "train",
                      (0, 1), in_shardings)
    if shape.kind == "prefill":
        if not cfg.has_decode:
            return bundle(make_encoder_step(cfg), (p_abstract, _meta(ins["batch"])), "prefill", ())
        return bundle(make_prefill_step(cfg), (p_abstract, _meta(ins["batch"]), _meta(ins["cache"])),
                      "prefill", (2,))
    if shape.kind == "decode":
        # one token a sequence against a full context: the last position
        return bundle(make_decode_step(cfg),
                      (p_abstract, _meta(ins["tokens"]), _meta(ins["cache"]), shape.seq_len - 1),
                      "decode", (2,))
    raise ValueError(shape.kind)


def model_flops_for_cell(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS for the roofline table."""
    if shape.kind == "train":
        return cfg.train_flops_per_token() * shape.tokens
    if shape.kind == "prefill":
        per = cfg.train_flops_per_token() / 3.0  # forward only: 2·N
        return per * shape.tokens
    # decode: one token per sequence against a seq_len context
    return cfg.decode_flops_per_token(context=shape.seq_len) * shape.global_batch
