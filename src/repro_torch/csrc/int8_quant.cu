// Block-scaled int8 quantize and dequantize over (rows, 256) arrays cut into
// tiles of block_rows x 256: per tile, scale = max(amax * f32(1/127), 1e-12) and
// q = clip(round_half_even(x / scale), -127, 127); dequantize is q * scale.
//
// Replaces the Pallas TPU kernels src/repro/kernels/int8_quant/kernel.py
// (_quant_kernel / int8_quantize_kernel and _dequant_kernel /
// int8_dequantize_kernel), one grid step per tile with the tile in VMEM.
// The kernel there writes amax / 127.0; XLA compiles a division by a
// constant as a multiply by the constant's f32 reciprocal, so the scale is
// amax * f32(1/127), bit for bit what this kernel computes.
//
// Bound on the card: bytes. Quantize reads x once and writes one int8 per
// element and one f32 scale per tile (sizeof(T) + 1 bytes per element);
// dequantize reads one int8 and writes one T per element. A few operations
// per element.
//
// Quantize design: one block of 1024 threads per tile (at most 256 x 256
// elements; the wrapper's default). Pass 1 max-reduces |x| in f32 (warp
// shuffles, then shared memory); max is exact, so the order does not change
// the result. One thread takes the scale (one f32 multiply). Pass 2 reads
// the tile again and stores the int8 codes. The second read is from L2 as
// far as L2 holds the tiles in flight: at two blocks of 1024 threads per SM
// that is 264 tiles of 256 KB (f32), a little past the H100's 50 MB, so
// some of it comes from device memory again. The codes match the
// reference bit for bit: x / scale by __fdiv_rn (true division, no
// reciprocal multiply, no fast math), then rintf (round half to even, as
// jnp.round and torch.round). A NaN propagates into the tile's amax and
// scale, as jnp.max and jnp.maximum propagate it.
//
// Dequantize design: a grid-stride elementwise pass, 16-byte stores
// (4 f32 or 8 bf16 per thread and step) where the pointers allow;
// __fmul_rn((float)q, scale) then one rounding to the output type
// (__float2bfloat16_rn for bf16).
//
// Both take 16-byte vector loads where the pointers are aligned and a
// scalar loop otherwise. No atomics: every output is written once.
#include "common.cuh"

namespace {

constexpr int kLanes = 256;
constexpr int kQThreads = 1024;
constexpr int kQWarps = kQThreads / 32;
constexpr int kDThreads = 256;
constexpr int kDMaxBlocks = 132 * 16;  // 16 blocks for each of the H100's 132 SMs
constexpr float kInv127 = 1.0f / 127.0f;

// kV elements of type E in one aligned load or store
template <typename E, int kV>
struct alignas(sizeof(E) * kV) Vec {
  E v[kV];
};

// max that propagates NaN (as jnp.max / jnp.maximum do); fmaxf drops it
__device__ __forceinline__ float nan_max(float a, float b) { return (a > b || a != a) ? a : b; }

template <typename T, int kV>
__global__ void __launch_bounds__(kQThreads)
quantize_kernel(const T* __restrict__ x, int64_t tile, int8_t* __restrict__ q,
                float* __restrict__ scales) {
  const T* xt = x + static_cast<int64_t>(blockIdx.x) * tile;
  int8_t* qt = q + static_cast<int64_t>(blockIdx.x) * tile;
  const int64_t nv = tile / kV;

  float amax = 0.0f;
  for (int64_t i = threadIdx.x; i < nv; i += kQThreads) {
    const Vec<T, kV> p = reinterpret_cast<const Vec<T, kV>*>(xt)[i];
#pragma unroll
    for (int j = 0; j < kV; ++j) amax = nan_max(amax, fabsf(repro::to_f32(p.v[j])));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = nan_max(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  __shared__ float warp_max[kQWarps];
  __shared__ float scale_s;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_max[warp] = amax;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = warp_max[0];
    for (int w = 1; w < kQWarps; ++w) m = nan_max(m, warp_max[w]);
    const float s = nan_max(__fmul_rn(m, kInv127), 1e-12f);
    scale_s = s;
    scales[blockIdx.x] = s;
  }
  __syncthreads();
  const float s = scale_s;

  for (int64_t i = threadIdx.x; i < nv; i += kQThreads) {
    const Vec<T, kV> p = reinterpret_cast<const Vec<T, kV>*>(xt)[i];
    Vec<int8_t, kV> o;
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const float r = rintf(__fdiv_rn(repro::to_f32(p.v[j]), s));
      o.v[j] = static_cast<int8_t>(static_cast<int>(fminf(fmaxf(r, -127.0f), 127.0f)));
    }
    reinterpret_cast<Vec<int8_t, kV>*>(qt)[i] = o;
  }
}

template <typename T, int kV>
__global__ void __launch_bounds__(kDThreads)
dequantize_kernel(const int8_t* __restrict__ q, const float* __restrict__ scales, int64_t nv,
                  int64_t tile, T* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kDThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kDThreads + threadIdx.x; i < nv;
       i += stride) {
    // kV divides 256, so the kV elements lie in one tile
    const float s = scales[i * kV / tile];
    const Vec<int8_t, kV> p = reinterpret_cast<const Vec<int8_t, kV>*>(q)[i];
    Vec<T, kV> o;
#pragma unroll
    for (int j = 0; j < kV; ++j)
      o.v[j] = repro::from_f32<T>(__fmul_rn(static_cast<float>(p.v[j]), s));
    reinterpret_cast<Vec<T, kV>*>(out)[i] = o;
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

template <typename T>
int quantize(const void* x, int64_t rows, int block_rows, void* q, void* scales,
             cudaStream_t stream) {
  constexpr int kV = 16 / sizeof(T);
  const int64_t tile = static_cast<int64_t>(block_rows) * kLanes;
  const unsigned blocks = static_cast<unsigned>(rows / block_rows);
  const T* xp = static_cast<const T*>(x);
  int8_t* qp = static_cast<int8_t*>(q);
  float* sp = static_cast<float*>(scales);
  if (aligned(x, 16) && aligned(q, kV))
    quantize_kernel<T, kV><<<blocks, kQThreads, 0, stream>>>(xp, tile, qp, sp);
  else
    quantize_kernel<T, 1><<<blocks, kQThreads, 0, stream>>>(xp, tile, qp, sp);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dequantize(const void* q, const void* scales, int64_t rows, int block_rows, void* out,
               cudaStream_t stream) {
  constexpr int kV = 16 / sizeof(T);
  const int64_t tile = static_cast<int64_t>(block_rows) * kLanes;
  const int64_t n = rows * kLanes;
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(scales);
  T* op = static_cast<T*>(out);
  const bool vec = aligned(q, kV) && aligned(out, 16);
  const int64_t nv = vec ? n / kV : n;
  const int64_t want = (nv + kDThreads - 1) / kDThreads;
  const unsigned blocks = static_cast<unsigned>(want < kDMaxBlocks ? want : kDMaxBlocks);
  if (vec)
    dequantize_kernel<T, kV><<<blocks, kDThreads, 0, stream>>>(qp, sp, nv, tile, op);
  else
    dequantize_kernel<T, 1><<<blocks, kDThreads, 0, stream>>>(qp, sp, nv, tile, op);
  return static_cast<int>(cudaGetLastError());
}

bool valid(int64_t rows, int block_rows) {
  return rows > 0 && block_rows > 0 && rows % block_rows == 0 &&
         rows / block_rows <= 0x7fffffff;
}

}  // namespace

// x: (rows, 256) of dtype, contiguous; rows a multiple of block_rows.
// q: (rows, 256) int8; scales: (rows / block_rows) f32, one per tile.
extern "C" int repro_int8_quantize(const void* x, int64_t rows, int block_rows, void* q,
                                   void* scales, int dtype, void* stream) {
  if (!valid(rows, block_rows)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32) return quantize<float>(x, rows, block_rows, q, scales, s);
  if (dtype == repro::kBFloat16)
    return quantize<__nv_bfloat16>(x, rows, block_rows, q, scales, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// q: (rows, 256) int8; scales: (rows / block_rows) f32; out: (rows, 256) of
// dtype (the output type), contiguous.
extern "C" int repro_int8_dequantize(const void* q, const void* scales, int64_t rows,
                                     int block_rows, void* out, int dtype, void* stream) {
  if (!valid(rows, block_rows)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32) return dequantize<float>(q, scales, rows, block_rows, out, s);
  if (dtype == repro::kBFloat16)
    return dequantize<__nv_bfloat16>(q, scales, rows, block_rows, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
