"""Serving runtime of the port; counterpart of ``repro.runtime`` (serving only)."""
from .serve_loop import AdmissionQueue, BatchServer, Request, ServeMetrics
from .step_builder import make_decode_step, make_prefill_step

__all__ = [
    "AdmissionQueue",
    "BatchServer",
    "Request",
    "ServeMetrics",
    "make_decode_step",
    "make_prefill_step",
]
