"""Data of the port: verbatim copies of ``repro.data.pipeline`` (NumPy), so
both packages make byte-identical batches for a (shard, step), and of
``repro.data.traces`` with its bundled ``host_sessions.csv``, so both fit and
replay the same availability trace."""
from .pipeline import DataConfig, DataShard, global_batch, make_batch
from .traces import (
    Session,
    TraceFit,
    apply_outage,
    fit_trace,
    intervals_to_toggles,
    load_bundled_trace,
    load_trace,
    synthesize_toggles,
    toggles_to_intervals,
)

__all__ = [
    "DataConfig",
    "DataShard",
    "Session",
    "TraceFit",
    "apply_outage",
    "fit_trace",
    "global_batch",
    "intervals_to_toggles",
    "load_bundled_trace",
    "load_trace",
    "make_batch",
    "synthesize_toggles",
    "toggles_to_intervals",
]
