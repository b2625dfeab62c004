// Fuzzy quorum comparison of two result replicas: the count of elements
// with |a - b| > atol + rtol * |b|, and sum((a - b)^2), over flat inputs.
//
// Replaces the Pallas TPU kernel src/repro/kernels/quorum_compare/kernel.py
// (_quorum_kernel / quorum_compare_kernel), whose sequential grid adds each
// block's count and sum into one (1, 1) output in VMEM, counting in f32.
//
// Bound on the card: bytes. Both inputs are read once (2 * n * sizeof(T));
// the outputs are two scalars and the arithmetic is a few operations per
// element. Design: a grid-stride pass (float4 loads where both pointers
// are 16-byte aligned) writes one (int64 count, f64 sum) partial per block,
// reduced inside the block by shuffles in a fixed pattern; a second pass of
// one block reduces the partials in a fixed order. No float atomics, so the
// result is the same on every run. The count is int64: an embedding leaf
// has ~1.6e8 elements, past f32's exact integers (2^24).
// The tolerance test rounds each operation on its own (__fsub_rn,
// __fmul_rn, __fadd_rn: no FMA contraction), in f32, as numpy.isclose does
// on float32 arrays, so counts at the boundary are bit-equal to numpy's.
// A NaN never counts as bad here (the comparison is false), as on the TPU;
// a non-finite element makes the sum non-finite, which is how the caller
// (grid_runtime.grad_comparator) knows to apply isclose's non-finite rules.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void tally(float x, float y, float rtol, float atol, long long& cnt,
                                      double& sq) {
  const float d = fabsf(__fsub_rn(x, y));
  const float tol = __fadd_rn(atol, __fmul_rn(rtol, fabsf(y)));
  cnt += d > tol ? 1 : 0;
  const double dd = static_cast<double>(d);
  sq = __dadd_rn(sq, __dmul_rn(dd, dd));
}

// Block-wide sums of (cnt, sq) in a fixed pattern; thread 0 gets the result.
__device__ __forceinline__ void block_sum(long long& cnt, double& sq) {
  __shared__ long long cnt_s[kWarps];
  __shared__ double sq_s[kWarps];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
    sq += __shfl_xor_sync(0xffffffffu, sq, off);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    cnt_s[warp] = cnt;
    sq_s[warp] = sq;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    cnt = 0;
    sq = 0.0;
    for (int w = 0; w < kWarps; ++w) {
      cnt += cnt_s[w];
      sq += sq_s[w];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
quorum_partial_kernel(const T* __restrict__ a, const T* __restrict__ b, int64_t n, float rtol,
                      float atol, long long* __restrict__ cnt_part, double* __restrict__ sq_part) {
  long long cnt = 0;
  double sq = 0.0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  int64_t head = 0;  // elements handled by the vector loop
  if constexpr (sizeof(T) == 4) {
    const bool aligned =
        ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & 15) == 0;
    if (aligned) {
      const int64_t n4 = n / 4;
      const float4* a4 = reinterpret_cast<const float4*>(a);
      const float4* b4 = reinterpret_cast<const float4*>(b);
      for (int64_t i = first; i < n4; i += stride) {
        const float4 x = a4[i], y = b4[i];
        tally(x.x, y.x, rtol, atol, cnt, sq);
        tally(x.y, y.y, rtol, atol, cnt, sq);
        tally(x.z, y.z, rtol, atol, cnt, sq);
        tally(x.w, y.w, rtol, atol, cnt, sq);
      }
      head = n4 * 4;
    }
  }
  for (int64_t i = head + first; i < n; i += stride)
    tally(repro::to_f32(a[i]), repro::to_f32(b[i]), rtol, atol, cnt, sq);
  block_sum(cnt, sq);
  if (threadIdx.x == 0) {
    cnt_part[blockIdx.x] = cnt;
    sq_part[blockIdx.x] = sq;
  }
}

__global__ void __launch_bounds__(kThreads)
quorum_final_kernel(const long long* __restrict__ cnt_part, const double* __restrict__ sq_part,
                    int parts, long long* __restrict__ cnt_out, float* __restrict__ sq_out) {
  long long cnt = 0;
  double sq = 0.0;
  for (int i = threadIdx.x; i < parts; i += kThreads) {
    cnt += cnt_part[i];
    sq += sq_part[i];
  }
  block_sum(cnt, sq);
  if (threadIdx.x == 0) {
    *cnt_out = cnt;
    *sq_out = __double2float_rn(sq);
  }
}

template <typename T>
int launch(const void* a, const void* b, int64_t n, float rtol, float atol, int parts,
           void* cnt_part, void* sq_part, void* cnt_out, void* sq_out, cudaStream_t stream) {
  quorum_partial_kernel<T><<<parts, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), n, rtol, atol,
      static_cast<long long*>(cnt_part), static_cast<double*>(sq_part));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  quorum_final_kernel<<<1, kThreads, 0, stream>>>(
      static_cast<const long long*>(cnt_part), static_cast<const double*>(sq_part), parts,
      static_cast<long long*>(cnt_out), static_cast<float*>(sq_out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cnt_part (int64) and sq_part (f64) hold `parts` partials, one per block of
// the first pass; cnt_out is one int64, sq_out one f32.
extern "C" int repro_quorum_compare(const void* a, const void* b, int64_t n, float rtol,
                                    float atol, int parts, void* cnt_part, void* sq_part,
                                    void* cnt_out, void* sq_out, int dtype, void* stream) {
  if (n <= 0 || parts <= 0 || parts > (1 << 20)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return launch<float>(a, b, n, rtol, atol, parts, cnt_part, sq_part, cnt_out, sq_out, s);
  if (dtype == repro::kBFloat16)
    return launch<__nv_bfloat16>(a, b, n, rtol, atol, parts, cnt_part, sq_part, cnt_out, sq_out,
                                 s);
  return static_cast<int>(cudaErrorInvalidValue);
}
