"""Checkpoint/restart of the port; counterpart of ``repro.checkpoint``, with
the same on-disk format, so either package restores the other's."""
from .checkpointer import Checkpointer, CheckpointPolicy

__all__ = ["Checkpointer", "CheckpointPolicy"]
