// RMSNorm over the last axis: y = x * rsqrt(mean(x^2) + eps) * scale.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm/kernel.py
// (_rmsnorm_kernel / rmsnorm_kernel), which normalises a block of rows per
// grid step in VMEM.
//
// Bound on the card: bytes. Each row is read once and written once
// (2 * rows * d * sizeof(T)); the arithmetic is a few operations per element.
// Design: one warp per row, the row held in registers (ITEMS values per lane,
// lane l holding columns l, l+32, ...), the f32 sum of squares reduced with
// warp shuffles, then one write in the input dtype. No shared memory and no
// second read of x. d may be anything up to 4096; ITEMS is picked at launch.
// Statistics are f32 whatever the input dtype, as in the reference.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;  // rows per block

template <typename T, int ITEMS>
__global__ void __launch_bounds__(kWarps * 32)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale, T* __restrict__ out,
               int64_t rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warp leaves together
  const T* xr = x + row * d;
  float v[ITEMS];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int c = i * 32 + lane;
    v[i] = c < d ? repro::to_f32(xr[c]) : 0.f;
    ss += v[i] * v[i];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float inv = 1.0f / sqrtf(ss / static_cast<float>(d) + eps);
  T* orow = out + row * d;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int c = i * 32 + lane;
    if (c < d) orow[c] = repro::from_f32<T>(v[i] * inv * scale[c]);
  }
}

template <typename T, int ITEMS>
void launch(const void* x, const float* scale, void* out, int64_t rows, int d, float eps,
            cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((rows + kWarps - 1) / kWarps);
  rmsnorm_kernel<T, ITEMS><<<blocks, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), scale, static_cast<T*>(out), rows, d, eps);
}

template <typename T>
void dispatch(const void* x, const float* scale, void* out, int64_t rows, int d, float eps,
              cudaStream_t stream) {
  if (d <= 32) launch<T, 1>(x, scale, out, rows, d, eps, stream);
  else if (d <= 64) launch<T, 2>(x, scale, out, rows, d, eps, stream);
  else if (d <= 128) launch<T, 4>(x, scale, out, rows, d, eps, stream);
  else if (d <= 256) launch<T, 8>(x, scale, out, rows, d, eps, stream);
  else if (d <= 512) launch<T, 16>(x, scale, out, rows, d, eps, stream);
  else if (d <= 1024) launch<T, 32>(x, scale, out, rows, d, eps, stream);
  else if (d <= 2048) launch<T, 64>(x, scale, out, rows, d, eps, stream);
  else launch<T, 128>(x, scale, out, rows, d, eps, stream);
}

}  // namespace

extern "C" int repro_rmsnorm(const void* x, const void* scale, void* out, int64_t rows, int d,
                             float eps, int dtype, void* stream) {
  if (rows <= 0 || d <= 0 || d > 4096) return static_cast<int>(cudaErrorInvalidValue);
  const float* sc = static_cast<const float*>(scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32) dispatch<float>(x, sc, out, rows, d, eps, s);
  else if (dtype == repro::kBFloat16) dispatch<__nv_bfloat16>(x, sc, out, rows, d, eps, s);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
