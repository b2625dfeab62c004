"""The volunteer-grid training runtime: BOINC middleware x PyTorch training;
counterpart of ``repro.runtime.grid_runtime``.

A training run is a BOINC *project*; one microbatch gradient computation is
a *job*; the emulated hosts execute jobs with real compute on the card
while the virtual-time simulator (``repro_torch.core.simulator``) drives
dispatch, deadlines, validation, credit and churn.

  * jobs:        ("grad", step, shard) with est_flop_count = 6·N·tokens
  * app:         adaptive replication + the fuzzy gradient comparator,
                 which counts disagreeing elements with the quorum_compare
                 CUDA kernel (the reference's comparator uses np.isclose)
  * assimilator: collects canonical gradients; when a step's shards are all
                 assimilated, averages them and applies one AdamW update,
                 then submits the next step's jobs
  * faults:      malicious/erroneous hosts corrupt outputs (SDC model);
                 churned hosts trigger deadline re-dispatch
  * credit:      PFC accounting doubles as the FLOPs ledger

Where the port departs from the reference: gradients stay on the device
as torch tensors (the reference copies every tree to host numpy). The job
cache, the corruptor, the comparator and the update all work on device
trees, and nothing is copied to the host but the loss and the comparator's
per-leaf counts. Trees are flattened in sorted-key order, which is jax's
leaf order for dicts, so the corruptor picks the same leaf from the same
draw and every verdict matches the reference's.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import (
    App,
    AppVersion,
    GridSimulation,
    Job,
    Platform,
    ProjectServer,
    default_cpu_plan_class,
    make_population,
    next_id,
)
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.device import Device, resolve_device
from repro_torch.kernels.quorum_compare.ops import quorum_compare
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import init_params, tree_leaves, tree_map, tree_unflatten
from repro_torch.models.transformer import model_spec
from repro_torch.optim.adamw import AdamWConfig, apply_updates, init_state
from repro_torch.runtime.step_builder import make_grad_step


def grad_comparator(rtol: float = 1e-4, atol: float = 1e-6, max_bad_fraction: float = 1e-6):
    """Fuzzy gradient agreement (§3.4 'within specified tolerances').

    The verdict is numpy.isclose's: an element disagrees unless
    ``|a - b| <= atol + rtol*|b|`` with ``b`` finite, or ``a == b``. The
    quorum_compare op counts ``|a - b| > atol + rtol*|b|`` per leaf, which is
    that rule wherever both leaves are finite; its ``sum_sq`` is finite
    exactly then (an overflow of the squares also lands on the other branch,
    which is still right). A leaf whose ``sum_sq`` is not finite is counted
    with ``torch.isclose``, whose rule for NaN and infinities is numpy's.
    All leaves are compared before one copy of the counts to the host."""

    def cmp(a: Any, b: Any) -> bool:
        la = tree_leaves(a["grads"])
        lb = tree_leaves(b["grads"])
        if len(la) != len(lb) or any(xa.shape != xb.shape for xa, xb in zip(la, lb)):
            return False
        total = sum(xa.numel() for xa in la)
        if total == 0:
            return True
        counts, sums = zip(*(quorum_compare(xa, xb, rtol=rtol, atol=atol)
                             for xa, xb in zip(la, lb)))
        counts = torch.stack(counts).tolist()
        finite = torch.isfinite(torch.stack(sums)).tolist()
        bad = 0
        for xa, xb, n, ok in zip(la, lb, counts, finite):
            if ok:
                bad += n
            else:
                bad += int(torch.count_nonzero(~torch.isclose(xa, xb, rtol=rtol, atol=atol)))
        return (bad / total) <= max_bad_fraction

    return cmp


def _grad_corruptor(output: Any, rng) -> Any:
    """SDC model: flip a random scale on one gradient leaf."""
    out = {k: v for k, v in output.items()}
    leaves = tree_leaves(out["grads"])
    idx = rng.randrange(len(leaves))
    noise = 1.0 + 0.5 * rng.random()
    leaves = [leaf * noise if i == idx else leaf for i, leaf in enumerate(leaves)]
    out["grads"] = tree_unflatten(out["grads"], leaves)
    return out


def _tree_mean(trees: List[Any]) -> Any:
    """Leafwise f32 mean of equally shaped trees."""
    if isinstance(trees[0], dict):
        return {k: _tree_mean([t[k] for t in trees]) for k in trees[0]}
    return torch.stack([t.float() for t in trees]).mean(0)


@dataclass
class GridTrainResult:
    losses: List[float]
    steps_completed: int
    metrics: Any  # SimMetrics
    credit_total: Dict[str, float]
    jobs_retried: int
    virtual_time: float

    @property
    def final_loss(self) -> float:
        return self.losses[-1] if self.losses else float("nan")


class GridTrainer:
    """Trains a model through the BOINC grid (virtual time, real compute).

    The reference's constructor, plus ``params`` (initial parameters, any
    tree of tensors or arrays shaped like ``model_spec(cfg)``; copied, f32)
    and ``device``. Without ``params`` they are drawn from a generator on
    the device seeded with ``seed`` (so they match the reference's
    ``jax.random`` draws in distribution only)."""

    def __init__(
        self,
        cfg: ModelConfig,
        data_cfg: DataConfig,
        opt_cfg: AdamWConfig,
        n_steps: int,
        n_hosts: int = 12,
        seed: int = 0,
        adaptive_replication: bool = True,
        min_quorum: int = 2,
        error_prob: float = 0.0,
        malicious_fraction: float = 0.0,
        availability: float = 1.0,
        churn_rate: float = 0.0,
        delay_bound: float = 4 * 3600.0,
        horizon: float = 90 * 86400.0,
        params: Optional[Any] = None,
        device: Device = "cuda",
    ) -> None:
        self.cfg = cfg
        self.data_cfg = data_cfg
        self.opt_cfg = opt_cfg
        self.n_steps = n_steps
        self.n_shards = data_cfg.n_shards
        self.device = resolve_device(device)

        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            self.params = init_params(gen, model_spec(cfg), cfg.param_dtype, self.device)
        else:
            self.params = tree_map(
                lambda t: torch.as_tensor(t).to(device=self.device, dtype=cfg.param_dtype).clone(),
                params,
            )
        self.opt_state = init_state(self.params)
        self._grad_fn = make_grad_step(cfg)

        # tokens per microbatch job -> est_flop_count (§3.3 / §6.3)
        tokens = data_cfg.batch_size * data_cfg.seq_len
        self._est_flops = cfg.train_flops_per_token() * tokens

        self.server = ProjectServer(name="grid-train", purge_delay=1e18)
        comparator = grad_comparator()
        app = App(
            name="grad",
            min_quorum=min_quorum,
            init_ninstances=min_quorum,
            max_error_instances=8,
            max_success_instances=12,
            delay_bound=delay_bound,
            adaptive_replication=adaptive_replication,
            comparator=comparator,
            fraction_done_exact=True,
        )
        for osn in ("windows", "mac", "linux"):
            app.add_version(
                AppVersion(
                    id=next_id("appver"),
                    app_name="grad",
                    platform=Platform(osn, "x86_64"),
                    version_num=1,
                    plan_class=default_cpu_plan_class(),
                )
            )
        self.server.add_app(app)
        self.server.assimilators["grad"] = self._assimilate
        self._app = app

        population = make_population(
            n_hosts,
            seed=seed + 1,
            error_prob=error_prob,
            malicious_fraction=malicious_fraction,
            availability=availability,
            churn_rate=churn_rate,
            horizon=horizon,
        )
        self.sim = GridSimulation(
            self.server,
            population,
            seed=seed + 2,
            executor=self._execute,
            corruptor=_grad_corruptor,
        )
        self.horizon = horizon
        self._grad_cache: Dict[Tuple[int, int], Any] = {}
        self._pending: Dict[int, Dict[int, Any]] = {}  # step -> shard -> grads
        self._job_meta: Dict[int, Tuple[int, int]] = {}  # job_id -> (step, shard)
        self.losses: List[float] = []
        self.steps_completed = 0
        # host seconds of each computed grad job, ending in the read of its
        # loss, which waits for the device (cached replicas cost nothing)
        self.job_seconds: List[float] = []
        self._delay_bound = delay_bound

    # ------------------------------------------------------------------

    def _submit_step_jobs(self, step: int, now: float) -> None:
        self._pending[step] = {}
        for shard in range(self.n_shards):
            job = Job(
                id=next_id("job"),
                app_name="grad",
                est_flop_count=self._est_flops,
                delay_bound=self._delay_bound,
                submitter="trainer",
                payload=("grad", step, shard),
            )
            self._job_meta[job.id] = (step, shard)
            self.server.submit_job(job, now)

    # ------------------------------------------------------------------

    def _execute(self, job: Job, host) -> Any:
        """Real compute for a job (cached: replicas see identical data, hence
        identical correct results — homogeneous redundancy). The gradient
        tree stays on the device."""
        _, step, shard = job.payload
        key = (step, shard)
        if key not in self._grad_cache:
            t0 = time.perf_counter()
            batch_np = make_batch(self.data_cfg, shard, step)
            batch = {k: torch.from_numpy(v.astype(np.int64) if v.dtype.kind == "i" else v)
                     .to(self.device) for k, v in batch_np.items()}
            grads, metrics = self._grad_fn(self.params, batch)
            self._grad_cache[key] = {
                "grads": tree_map(lambda g: g.float(), grads),
                "loss": float(metrics["loss"]),
            }
            self.job_seconds.append(time.perf_counter() - t0)
        return self._grad_cache[key]

    # ------------------------------------------------------------------

    def _assimilate(self, job: Job, output: Any) -> None:
        meta = self._job_meta.get(job.id)
        if meta is None:
            return
        step, shard = meta
        if output is None:
            # job failed outright (error limits): resubmit the (step, shard)
            if shard not in self._pending.get(step, {}):
                replacement = Job(
                    id=next_id("job"),
                    app_name="grad",
                    est_flop_count=self._est_flops,
                    delay_bound=self._delay_bound,
                    submitter="trainer",
                    payload=("grad", step, shard),
                )
                self._job_meta[replacement.id] = (step, shard)
                self.server.submit_job(replacement, self.sim.now)
            return
        bucket = self._pending.get(step)
        if bucket is None or shard in bucket:
            return
        bucket[shard] = output
        if len(bucket) == self.n_shards and step == self.steps_completed:
            self._apply_step(step)

    def _apply_step(self, step: int) -> None:
        bucket = self._pending.pop(step)
        outs = [bucket[s] for s in range(self.n_shards)]
        loss = float(np.mean([o["loss"] for o in outs]))
        grads = _tree_mean([o["grads"] for o in outs])
        self.params, self.opt_state, _ = apply_updates(self.opt_cfg, self.params, grads,
                                                       self.opt_state)
        self.losses.append(loss)
        self.steps_completed = step + 1
        # free the cache for this step (file deleter analogue)
        for shard in range(self.n_shards):
            self._grad_cache.pop((step, shard), None)
        if self.steps_completed < self.n_steps:
            self._submit_step_jobs(self.steps_completed, self.sim.now)

    # ------------------------------------------------------------------

    def run(self) -> GridTrainResult:
        self._submit_step_jobs(0, 0.0)
        # run in windows so we can stop as soon as training finishes
        window = 6 * 3600.0
        t = 0.0
        while self.steps_completed < self.n_steps and t < self.horizon:
            t = min(self.horizon, t + window)
            self.sim.run(t)
        self.sim.audit_validation()
        retries = sum(tr.metrics.retries_created for tr in self.server.transitioners)
        return GridTrainResult(
            losses=self.losses,
            steps_completed=self.steps_completed,
            metrics=self.sim.metrics,
            credit_total=dict(self.server.credit.total),
            jobs_retried=retries,
            virtual_time=self.sim.now,
        )
