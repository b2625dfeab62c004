"""Batched serving loop; counterpart of ``repro.runtime.serve_loop``.

Continuous batching over a shared decode cache (K/V, SSM states, or both):
requests are admitted earliest-deadline-first into free slots, each
admission runs a batch-1 prefill whose cache is copied into its slot, and
each decode step advances every live slot by one greedy token.

The reference's behaviour is kept as it is, quirks included: prefill runs at
cache index 0 and attends only within the prompt; every slot decodes at
``lengths.max()``; ``argmax`` runs over ``[:vocab]`` and takes the first
index on ties; ``_merge_slot`` leaves the batch cache unchanged when the two
caches have equal shapes (``batch_slots=1``).
"""
from __future__ import annotations

import heapq
import time
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import Device, resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import init_cache, model_spec
from repro_torch.runtime.step_builder import make_decode_step, make_prefill_step

@dataclass
class Request:
    id: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int = 16
    deadline: float = float("inf")  # EDF admission
    submitted_at: float = 0.0
    tokens_out: List[int] = field(default_factory=list)
    started_at: Optional[float] = None
    finished_at: Optional[float] = None


@dataclass
class ServeMetrics:
    requests_done: int = 0
    tokens_generated: int = 0
    total_latency: float = 0.0
    decode_steps: int = 0
    wall_time: float = 0.0
    # host seconds in prefill (per admission) and decode steps, each ending
    # in the read of its argmax, which waits for the device
    prefill_time: float = 0.0
    decode_time: float = 0.0

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_generated / self.wall_time if self.wall_time else 0.0

    @property
    def mean_latency(self) -> float:
        return self.total_latency / self.requests_done if self.requests_done else 0.0


class AdmissionQueue:
    """EDF priority queue: a heap keyed ``(deadline, seq)``, so deadline ties
    pop in submission order."""

    def __init__(self) -> None:
        self._heap: List[Tuple[float, int, Request]] = []
        self._seq = 0

    def push(self, req: Request) -> None:
        heapq.heappush(self._heap, (req.deadline, self._seq, req))
        self._seq += 1

    def pop(self) -> Request:
        return heapq.heappop(self._heap)[2]

    def __len__(self) -> int:
        return len(self._heap)


def _compute_params(params: Any, spec: Any, dtype: torch.dtype, device: torch.device,
                    take: bool = False) -> Any:
    """Parameters on ``device``, cast once to the compute dtype (the leaves
    whose ``ParamSpec`` says ``f32_at_use`` to f32): the values the
    reference casts to at every call. With ``take``, each leaf is removed
    from ``params`` before its copy is made, so the caller's tree empties
    as the copy fills and the two are never whole at once."""
    if not isinstance(params, dict):
        raise TypeError(f"parameters must be nested dicts of tensors, got {type(params)}")
    out = {}
    for k in list(params):
        v = params.pop(k) if take else params[k]
        out[k] = (_compute_params(v, spec[k], dtype, device, take) if isinstance(v, dict)
                  else v.to(device=device, dtype=torch.float32 if spec[k].f32_at_use else dtype))
    return out


class BatchServer:
    """Slot-based continuous batching with a fixed decode batch."""

    def __init__(
        self,
        cfg: ModelConfig,
        params: Any,
        batch_slots: int = 4,
        max_seq: int = 256,
        device: Device = "cuda",
        take_params: bool = False,
    ) -> None:
        """``take_params``: the server takes ``params``, whose leaves leave
        the caller's tree as their compute copies are made (a 12 B model's
        46 GB f32 tree and its 23 GB bf16 copy are never both whole)."""
        if not cfg.has_decode:
            raise ValueError("encoder-only archs don't serve decode")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = _compute_params(params, model_spec(cfg), cfg.dtype, self.device, take_params)
        self.slots = batch_slots
        self.max_seq = max_seq
        self._prefill = make_prefill_step(cfg)
        self._decode = make_decode_step(cfg)
        self.queue = AdmissionQueue()
        self.metrics = ServeMetrics()

    def submit(self, req: Request) -> None:
        self.queue.push(req)

    def run(self, max_steps: int = 10_000) -> ServeMetrics:
        t0 = time.time()
        # one shared cache batch; slot i holds request i of the active set
        cache = init_cache(self.cfg, self.slots, self.max_seq, self.device)
        active: List[Optional[Request]] = [None] * self.slots
        lengths = np.zeros((self.slots,), np.int32)
        steps = 0
        vocab = self.cfg.vocab

        def admit() -> None:
            nonlocal cache
            for i in range(self.slots):
                if active[i] is None and self.queue:
                    req = self.queue.pop()
                    req.started_at = time.time()
                    t = time.perf_counter()
                    # per-slot prefill (batch=1), then copy into the batch cache
                    one = init_cache(self.cfg, 1, self.max_seq, self.device)
                    toks = torch.as_tensor(np.asarray(req.prompt, np.int64), device=self.device)
                    logits, one = self._prefill(self.params, {"tokens": toks[None, :]}, one)
                    req.tokens_out.append(int(torch.argmax(logits[0, -1, :vocab])))
                    self.metrics.prefill_time += time.perf_counter() - t
                    cache = _merge_slot(cache, one, i)
                    active[i] = req
                    lengths[i] = len(req.prompt)

        while steps < max_steps:
            admit()
            if all(a is None for a in active):
                break
            # batched decode step at the max current index
            toks = np.zeros((self.slots, 1), np.int64)
            for i, req in enumerate(active):
                if req is not None and req.tokens_out:
                    toks[i, 0] = req.tokens_out[-1]
            idx = int(lengths.max())
            t = time.perf_counter()
            logits, cache = self._decode(
                self.params, torch.as_tensor(toks, device=self.device), cache, idx
            )
            nxt = torch.argmax(logits[:, 0, :vocab], dim=-1).tolist()
            self.metrics.decode_time += time.perf_counter() - t
            steps += 1
            self.metrics.decode_steps += 1
            for i, req in enumerate(active):
                if req is None:
                    continue
                req.tokens_out.append(nxt[i])
                lengths[i] += 1
                self.metrics.tokens_generated += 1
                done = (
                    len(req.tokens_out) >= req.max_new_tokens
                    or lengths[i] >= self.max_seq - 2
                )
                if done:
                    req.finished_at = time.time()
                    self.metrics.requests_done += 1
                    self.metrics.total_latency += req.finished_at - (req.started_at or t0)
                    active[i] = None
        self.metrics.wall_time = time.time() - t0
        return self.metrics


def _merge_slot(batch_cache: Any, one_cache: Any, slot: int) -> Any:
    """Copy a single-sequence cache into slot ``slot`` of the batch cache, in place.

    The batch axis is the first axis whose size differs between the two
    trees; only that slot is written. A leaf whose shapes are equal is left
    unchanged, as in the reference."""
    if isinstance(batch_cache, dict):
        return {k: _merge_slot(v, one_cache[k], slot) for k, v in batch_cache.items()}
    for ax in range(batch_cache.ndim):
        n = one_cache.shape[ax]
        if batch_cache.shape[ax] != n:
            # dynamic_update_slice semantics: the start is clamped so the slot fits
            start = min(max(slot, 0), batch_cache.shape[ax] - n)
            batch_cache.narrow(ax, start, n).copy_(one_cache)
            break
    return batch_cache
