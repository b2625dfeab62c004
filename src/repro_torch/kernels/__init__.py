"""Hand-written Hopper kernels for the hot spots the reference wrote in Pallas.

Each subpackage has ``ops.py`` (the public wrapper: the CUDA kernel for a
CUDA tensor, the plain version for a CPU tensor, and a ``launches`` count)
and ``ref.py`` (the plain PyTorch version). The CUDA sources live in
``repro_torch/csrc``; ``_build.py`` compiles them with nvcc for ``sm_90a``
and binds them with ctypes.

  rmsnorm          — fused RMSNorm            (csrc/rmsnorm.cu)
  swiglu           — fused SwiGLU gate        (csrc/swiglu.cu)
  flash_attention  — GQA/causal forward flash attention (csrc/flash_attention.cu)
"""
