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
//
// Backward (no TPU kernel: the reference differentiates its jnp rms_norm,
// src/repro/models/layers.py rms_norm / head_rms_norm, with XLA). From x,
// scale and dy, all in f32: r = rsqrt(mean(x^2) + eps), xh = x * r,
// g = dy * scale, dx = r * (g - xh * mean(g * xh)), cast to x's dtype; and
// dscale = sum over rows of dy * xh, in f32.
// Bound on the card: bytes, 3 * rows * d * sizeof(T) (x and dy read, dx
// written) plus the f32 partials below. Design: one warp per row as in the
// forward, each warp walking rows with a fixed stride so every row is
// visited by the same warp on every run; each lane keeps its columns' dscale
// sums in registers; the block's warps add them into shared memory one warp
// after another, and each block writes one row of partials. A second kernel
// sums the partials of each column in block order. No atomics: dscale is
// the same on every run. d may be anything up to 1024 (the dscale sums live
// in registers).
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

constexpr int kBwdWarps = 8;  // rows in flight per block

template <typename T, int ITEMS>
__global__ void __launch_bounds__(kBwdWarps * 32)
rmsnorm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ partial,
                   int64_t rows, int d, float eps) {
  extern __shared__ float dscale_s[];  // d
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float sc[ITEMS], acc[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int c = i * 32 + lane;
    sc[i] = c < d ? scale[c] : 0.f;
    acc[i] = 0.f;
  }
  const float inv_d = 1.0f / static_cast<float>(d);
  const int64_t step = static_cast<int64_t>(gridDim.x) * kBwdWarps;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * kBwdWarps + warp; row < rows; row += step) {
    const T* xr = x + row * d;
    const T* gr = dy + row * d;
    float xv[ITEMS], gv[ITEMS];
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int c = i * 32 + lane;
      xv[i] = c < d ? repro::to_f32(xr[c]) : 0.f;
      gv[i] = c < d ? repro::to_f32(gr[c]) : 0.f;
      ss += xv[i] * xv[i];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
    const float r = 1.0f / sqrtf(ss * inv_d + eps);
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const float xh = xv[i] * r;
      acc[i] += gv[i] * xh;
      gv[i] *= sc[i];
      dot += gv[i] * xh;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
    const float mean = dot * inv_d;
    T* orow = dx + row * d;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int c = i * 32 + lane;
      if (c < d) orow[c] = repro::from_f32<T>(r * (gv[i] - xv[i] * r * mean));
    }
  }
  for (int c = threadIdx.x; c < d; c += kBwdWarps * 32) dscale_s[c] = 0.f;
  __syncthreads();
  for (int w = 0; w < kBwdWarps; ++w) {  // warp by warp: a fixed order
    if (warp == w) {
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        const int c = i * 32 + lane;
        if (c < d) dscale_s[c] += acc[i];
      }
    }
    __syncthreads();
  }
  float* prow = partial + static_cast<int64_t>(blockIdx.x) * d;
  for (int c = threadIdx.x; c < d; c += kBwdWarps * 32) prow[c] = dscale_s[c];
}

__global__ void rmsnorm_dscale_kernel(const float* __restrict__ partial, float* __restrict__ dscale,
                                      int parts, int d) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d) return;
  float s = 0.f;
  for (int p = 0; p < parts; ++p) s += partial[static_cast<int64_t>(p) * d + c];
  dscale[c] = s;
}

template <typename T, int ITEMS>
void launch_bwd(const void* x, const float* scale, const void* dy, void* dx, float* partial,
                int parts, int64_t rows, int d, float eps, cudaStream_t stream) {
  rmsnorm_bwd_kernel<T, ITEMS><<<parts, kBwdWarps * 32, d * sizeof(float), stream>>>(
      static_cast<const T*>(x), scale, static_cast<const T*>(dy), static_cast<T*>(dx), partial,
      rows, d, eps);
}

template <typename T>
void dispatch_bwd(const void* x, const float* scale, const void* dy, void* dx, float* partial,
                  int parts, int64_t rows, int d, float eps, cudaStream_t stream) {
  if (d <= 32) launch_bwd<T, 1>(x, scale, dy, dx, partial, parts, rows, d, eps, stream);
  else if (d <= 64) launch_bwd<T, 2>(x, scale, dy, dx, partial, parts, rows, d, eps, stream);
  else if (d <= 128) launch_bwd<T, 4>(x, scale, dy, dx, partial, parts, rows, d, eps, stream);
  else if (d <= 256) launch_bwd<T, 8>(x, scale, dy, dx, partial, parts, rows, d, eps, stream);
  else if (d <= 512) launch_bwd<T, 16>(x, scale, dy, dx, partial, parts, rows, d, eps, stream);
  else launch_bwd<T, 32>(x, scale, dy, dx, partial, parts, rows, d, eps, stream);
}

}  // namespace

// partial holds `parts` rows of d f32 (one per block of the first kernel).
extern "C" int repro_rmsnorm_bwd(const void* x, const void* scale, const void* dy, void* dx,
                                 void* partial, void* dscale, int64_t rows, int d, float eps,
                                 int parts, int dtype, void* stream) {
  if (rows <= 0 || d <= 0 || d > 1024 || parts <= 0 || parts > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* sc = static_cast<const float*>(scale);
  float* part = static_cast<float*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32) dispatch_bwd<float>(x, sc, dy, dx, part, parts, rows, d, eps, s);
  else if (dtype == repro::kBFloat16)
    dispatch_bwd<__nv_bfloat16>(x, sc, dy, dx, part, parts, rows, d, eps, s);
  else return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rmsnorm_dscale_kernel<<<(d + 255) / 256, 256, 0, s>>>(part, static_cast<float*>(dscale), parts,
                                                         d);
  return static_cast<int>(cudaGetLastError());
}

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
