// SwiGLU gate: out = silu(gate) * up = gate * sigmoid(gate) * up.
//
// Replaces the Pallas TPU kernel src/repro/kernels/swiglu/kernel.py
// (_swiglu_kernel / swiglu_kernel), one pass over row blocks in VMEM.
//
// Bound on the card: bytes. Two inputs read once and one output written
// once (3 * n * sizeof(T)) for a handful of operations per element.
// Design: a grid-stride elementwise loop, f32 inside, one rounding to the
// gate's dtype at the store. expf, not __expf: the f32 tolerance against
// the reference is 1e-6, and the library is built without fast math.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 blocks for each of the H100's 132 SMs

template <typename T>
__global__ void __launch_bounds__(kThreads)
swiglu_kernel(const T* __restrict__ gate, const T* __restrict__ up, T* __restrict__ out,
              int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float g = repro::to_f32(gate[i]);
    const float u = repro::to_f32(up[i]);
    const float sig = 1.0f / (1.0f + expf(-g));
    out[i] = repro::from_f32<T>(g * sig * u);
  }
}

template <typename T>
void launch(const void* gate, const void* up, void* out, int64_t n, cudaStream_t stream) {
  const int64_t want = (n + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(want < kMaxBlocks ? want : kMaxBlocks);
  swiglu_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(gate), static_cast<const T*>(up), static_cast<T*>(out), n);
}

}  // namespace

extern "C" int repro_swiglu(const void* gate, const void* up, void* out, int64_t n, int dtype,
                            void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32) launch<float>(gate, up, out, n, s);
  else if (dtype == repro::kBFloat16) launch<__nv_bfloat16>(gate, up, out, n, s);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
