"""Deterministic, shardable synthetic data pipeline.

Jobs in the grid runtime reference data by (shard_id, step) — the BOINC
"input file" analogue — so any host can regenerate exactly the same
microbatch (locality scheduling makes shard affinity worthwhile, and
replicated instances of a step task see identical data, which is what makes
gradient replication validation meaningful).

The synthetic LM stream is a mixture of Zipfian unigrams and a copy task so
small models show a real, monotonically-decreasing loss.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    batch_size: int  # per-host microbatch
    seed: int = 0
    n_shards: int = 1
    input_mode: str = "tokens"  # tokens | embeds
    d_model: int = 0  # for embeds mode
    copy_fraction: float = 0.5  # fraction of each sequence that is copyable
    zipf_a: float = 1.2


def _rng_for(cfg: DataConfig, shard: int, step: int) -> np.random.Generator:
    # stable, collision-free stream per (seed, shard, step)
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, shard, step, 0xB01AC])
    )


def make_batch(cfg: DataConfig, shard: int, step: int) -> Dict[str, np.ndarray]:
    """Deterministic microbatch for (shard, step)."""
    rng = _rng_for(cfg, shard, step)
    b, s, v = cfg.batch_size, cfg.seq_len, cfg.vocab
    half = max(1, int(s * cfg.copy_fraction) // 2)
    # Zipfian prefix + copied suffix (learnable structure)
    ranks = rng.zipf(cfg.zipf_a, size=(b, s)).astype(np.int64)
    tokens = np.minimum(ranks, v - 1).astype(np.int32)
    tokens[:, s - half :] = tokens[:, s - 2 * half : s - half]
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = 0
    out: Dict[str, np.ndarray] = {"labels": labels}
    if cfg.input_mode == "embeds":
        emb_rng = _rng_for(cfg, shard, step + 1_000_003)
        out["embeds"] = emb_rng.standard_normal((b, s, cfg.d_model), dtype=np.float32)
    else:
        out["tokens"] = tokens
    return out


@dataclass
class DataShard:
    """Iterator view over one shard (a BOINC 'sticky file' unit)."""

    cfg: DataConfig
    shard: int
    step: int = 0

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        batch = make_batch(self.cfg, self.shard, self.step)
        self.step += 1
        return batch

    def shard_file_name(self) -> str:
        """The 'input file' name used for locality scheduling (§3.5)."""
        return f"data_shard_{self.cfg.seed}_{self.shard}.bin"


def global_batch(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """Concatenate all shards' microbatches (for single-process training)."""
    parts = [make_batch(cfg, sh, step) for sh in range(cfg.n_shards)]
    return {k: np.concatenate([p[k] for p in parts], axis=0) for k in parts[0]}
