"""Hand-written Hopper kernels for the hot spots the reference wrote in Pallas.

Each subpackage has ``ops.py`` (the public wrapper: the CUDA kernel for a
CUDA tensor, the plain version for a CPU tensor, and a ``launches`` count,
plus ``launches_bwd`` where there is a backward kernel behind a
``torch.autograd.Function``; int8_quant counts ``launches_quantize`` and
``launches_dequantize``) and ``ref.py`` (the plain PyTorch versions).
The CUDA sources live in ``repro_torch/csrc``; ``_build.py`` compiles them
with nvcc for ``sm_90a`` and binds them with ctypes.

  rmsnorm          — fused RMSNorm, forward and backward (csrc/rmsnorm.cu)
  swiglu           — fused SwiGLU gate, forward and backward (csrc/swiglu.cu)
  flash_attention  — GQA/causal flash attention, forward (+ log-sum-exp)
                     and backward (dQ; dK/dV)  (csrc/flash_attention.cu)
  quorum_compare   — fuzzy replica comparison: bad-element count and sum
                     of squares             (csrc/quorum_compare.cu)
  int8_quant       — block-scaled int8 quantize and dequantize, the
                     gradient wire format   (csrc/int8_quant.cu)
  ssd_scan         — Mamba-2 SSD chunked scan with a carried f32 state,
                     forward: chunk states, the pass over the chunks,
                     chunk outputs        (csrc/ssd_scan.cu)
"""
