"""Synthetic data pipeline of the port: a verbatim copy of
``repro.data.pipeline`` (NumPy), so both packages make byte-identical
batches for a (shard, step)."""
from .pipeline import DataConfig, DataShard, global_batch, make_batch

__all__ = ["DataConfig", "DataShard", "global_batch", "make_batch"]
