"""PyTorch/CUDA port of the ``repro`` package for one NVIDIA Hopper card.

The JAX package ``repro`` is the reference; this package mirrors its module
names and public signatures (``repro_torch.models.layers`` is the
counterpart of ``repro.models.layers``, and so on) and imports nothing of
it. Hot spots that the reference wrote as Pallas TPU kernels run here as
CUDA C++ kernels written for ``sm_90a`` (``repro_torch/csrc``), bound with
ctypes (``repro_torch/kernels``).

Entry points run on the card unless the caller passes ``device="cpu"``; on
the CPU every kernel wrapper takes its plain PyTorch version.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
