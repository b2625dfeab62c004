"""Runtime of the port; counterpart of ``repro.runtime``: serving, the
gradient, train, prefill, encoder and decode steps and the step bundles
the dry run lowers (``build_step``), the single-process training loop with
checkpoint/restart, and the volunteer-grid trainer."""
from .grid_runtime import GridTrainer, GridTrainResult, grad_comparator
from .serve_loop import AdmissionQueue, BatchServer, Request, ServeMetrics
from .step_builder import (
    StepBundle,
    build_step,
    input_specs,
    make_decode_step,
    make_encoder_step,
    make_grad_step,
    make_prefill_step,
    make_train_step,
    model_flops_for_cell,
)
from .train_loop import TrainResult, train

__all__ = [
    "AdmissionQueue",
    "BatchServer",
    "GridTrainResult",
    "GridTrainer",
    "Request",
    "ServeMetrics",
    "StepBundle",
    "TrainResult",
    "build_step",
    "grad_comparator",
    "input_specs",
    "make_decode_step",
    "make_encoder_step",
    "make_grad_step",
    "make_prefill_step",
    "make_train_step",
    "model_flops_for_cell",
    "train",
]
