"""Runtime of the port; counterpart of ``repro.runtime``: serving, the
gradient and train steps, and the volunteer-grid trainer."""
from .grid_runtime import GridTrainer, GridTrainResult, grad_comparator
from .serve_loop import AdmissionQueue, BatchServer, Request, ServeMetrics
from .step_builder import make_decode_step, make_grad_step, make_prefill_step, make_train_step

__all__ = [
    "AdmissionQueue",
    "BatchServer",
    "GridTrainResult",
    "GridTrainer",
    "Request",
    "ServeMetrics",
    "grad_comparator",
    "make_decode_step",
    "make_grad_step",
    "make_prefill_step",
    "make_train_step",
]
