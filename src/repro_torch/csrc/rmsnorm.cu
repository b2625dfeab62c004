// RMSNorm over the last axis: y = x * rsqrt(mean(x^2) + eps) * scale.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm/kernel.py
// (_rmsnorm_kernel / rmsnorm_kernel), which normalises a block of rows per
// grid step in VMEM.
//
// Bound on the card: bytes. Each row is read once and written once
// (2 * rows * d * sizeof(T)); the arithmetic is a few operations per element.
// Design: a row is spread over `tpr` threads, chosen at launch from d and the
// row count (see `plan`): each thread holds at most kFwdElems values of the
// row in registers, moved as 16-byte vectors (8 bf16 or 4 f32 values), and a
// batch of few rows is spread over more threads, so the whole card has loads
// in flight. The f32 sum of squares is reduced with butterfly shuffles inside
// the warp (sub-warp groups for short rows) and, for rows of several warps,
// through shared memory in warp order. A thread keeps its columns' `scale` in
// registers across the rows it visits (grid-stride over rows). Rows too wide
// for registers (more than 1024 threads' worth) take the wide kernel: one
// block per row, which reads the row twice, the second time from L2.
// Inputs that cannot take 16-byte accesses (d not a multiple of the vector,
// or a base that is not 16-byte aligned) take the same kernels with one
// element per access (VEC = 1); the C entry point picks the route.
// Statistics are f32 whatever the input dtype, as in the reference.
//
// Backward (no TPU kernel: the reference differentiates its jnp rms_norm,
// src/repro/models/layers.py rms_norm / head_rms_norm, with XLA). From x,
// scale and dy, all in f32: r = rsqrt(mean(x^2) + eps), xh = x * r,
// g = dy * scale, dx = r * (g - xh * mean(g * xh)), cast to x's dtype; and
// dscale = sum over rows of dy * xh, in f32.
// Bound on the card: bytes, 3 * rows * d * sizeof(T) (x and dy read, dx
// written) plus the f32 partials below. Design: the forward's row-to-thread
// mapping and routes, with at most kBwdElems values per thread; the two row
// sums (x^2 and g * x) travel together, and the warps of a row meet at their
// own named barrier, so a block's rows do not wait for each other. Rows of
// more than four warps get blocks of up to 1024 threads (several rows each),
// since their blocks are fewer. The grid is `parts` blocks, a pure
// function of (rows, d) computed by the wrapper, each walking its rows at a
// fixed stride; each thread sums dscale for its own columns in registers
// (the same columns on every row it visits). The block's row groups are added
// in shared memory in group order after one barrier, and each block writes
// one row of partials. In the wide kernel each thread's column sums live in
// shared memory (d floats), or, for d beyond shared memory, in the block's
// own row of partials. A second kernel sums the partials of each column:
// 32 warps each add a fixed strided set of parts, then the warps' sums are
// added in warp order. No atomics: dx and dscale are the same bits on every
// run, as the grid's gradient quorum needs.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 1024;  // threads per row at most (the register route)
constexpr int kFwdElems = 16;      // values of a row a thread holds, forward
constexpr int kBwdElems = 8;       // and backward (x, dy, scale and dscale sums)
constexpr int kFwdMinBlock = 128;
constexpr int kBwdMinBlock = 256;
constexpr int kFwdMaxBlocks = 132 * 16;  // a grid-stride loop beyond: 16 blocks per H100 SM
// a batch whose rows would occupy fewer threads than this is spread wider
constexpr int64_t kBusyThreads = 132 * 1024;
constexpr int kSumWarps = 32;  // warps of the partial-sum kernel

// ---- 16-byte accesses -------------------------------------------------------

__device__ __forceinline__ void unpack16(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}

// bf16 to f32 is exact: the bf16 bits are the high half of the f32 bits
__device__ __forceinline__ void unpack16(const __nv_bfloat16* p, float* v) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

__device__ __forceinline__ void pack16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ unsigned bf16_bits(float v) {
  return __bfloat16_as_ushort(repro::from_f32<__nv_bfloat16>(v));
}

__device__ __forceinline__ void pack16(__nv_bfloat16* p, const float* v) {
  *reinterpret_cast<uint4*>(p) = make_uint4(
      bf16_bits(v[0]) | bf16_bits(v[1]) << 16, bf16_bits(v[2]) | bf16_bits(v[3]) << 16,
      bf16_bits(v[4]) | bf16_bits(v[5]) << 16, bf16_bits(v[6]) | bf16_bits(v[7]) << 16);
}

// VEC values at p as f32: one 16-byte access, or one element (VEC = 1)
template <int VEC, typename T>
__device__ __forceinline__ void load(const T* p, float* v) {
  if constexpr (VEC == 1) {
    v[0] = repro::to_f32(*p);
  } else {
    static_assert(VEC * sizeof(T) == 16, "a vector is 16 bytes");
    unpack16(p, v);
  }
}

template <int VEC, typename T>
__device__ __forceinline__ void store(T* p, const float* v) {
  if constexpr (VEC == 1) {
    *p = repro::from_f32<T>(v[0]);
  } else {
    pack16(p, v);
  }
}

// VEC f32 values (scale, dscale sums): VEC / 4 16-byte accesses, or one element
template <int VEC>
__device__ __forceinline__ void load_f32(const float* p, float* v) {
  if constexpr (VEC == 1) {
    v[0] = *p;
  } else {
#pragma unroll
    for (int k = 0; k < VEC; k += 4) unpack16(p + k, v + k);
  }
}

template <int VEC>
__device__ __forceinline__ void store_f32(float* p, const float* v) {
  if constexpr (VEC == 1) {
    *p = v[0];
  } else {
#pragma unroll
    for (int k = 0; k < VEC; k += 4) pack16(p + k, v + k);
  }
}

// ---- row sums ---------------------------------------------------------------

// The barrier of the tpr threads of one row group (whole warps): named
// barrier 1 + group, so the groups of a block do not wait for each other
// (barrier 0 is __syncthreads'). A block holds at most seven rows of more
// than one warp (block_for, bwd_block_for): within the 16 named barriers.
// The backward's register kernel uses it: its blocks of up to 1024 threads
// hold several wide rows, and on an H100 it ran faster with it at 4096 rows
// of 1536-4096 and no slower elsewhere. The forward keeps __syncthreads:
// with the asm barrier in its code it ran slower, even at widths that never
// reach the barrier.
__device__ __forceinline__ void group_sync(int group, int tpr) {
  asm volatile("bar.sync %0, %1;" ::"r"(group + 1), "r"(tpr) : "memory");
}

// The K sums s over the tpr threads of each row; every thread of the row gets
// the same bits. tpr is a power of two up to 32 (rows share a warp) or a
// multiple of 32 (rows of whole warps). Butterfly shuffles inside the warp
// (a + b == b + a, so the lanes agree); for rows of several warps, lane 0 of
// each warp puts its sum in `red` and every thread adds its row's warps in
// warp order, after a barrier: its group's (NAMED) or the block's. `red`
// holds two buffers used in turn (`parity`), so one barrier per row
// suffices. Every thread of the block must call it.
template <bool NAMED = false, int K>
__device__ __forceinline__ void row_sum(float (&s)[K], int tpr, float* red, int parity) {
  for (int off = (tpr < 32 ? tpr : 32) >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) s[k] += __shfl_xor_sync(0xffffffffu, s[k], off);
  }
  if (tpr <= 32) return;
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5;
  float* buf = red + parity * nw * K;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) buf[warp * K + k] = s[k];
  }
  if constexpr (NAMED) {
    group_sync(threadIdx.x / tpr, tpr);
  } else {
    __syncthreads();
  }
  const int first = (threadIdx.x / tpr) * (tpr >> 5);
#pragma unroll
  for (int k = 0; k < K; ++k) s[k] = 0.f;
  for (int w = 0; w < (tpr >> 5); ++w) {
#pragma unroll
    for (int k = 0; k < K; ++k) s[k] += buf[(first + w) * K + k];
  }
}

// ---- forward ----------------------------------------------------------------

// Each block holds blockDim.x / tpr rows at a time; thread t of a row holds
// its vectors i * tpr + t (i < NV), so a warp's accesses are contiguous.
template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale, T* __restrict__ out,
               int64_t rows, int d, int tpr, float eps) {
  __shared__ float red[2 * 32];
  const int t = threadIdx.x % tpr, group = threadIdx.x / tpr, groups = blockDim.x / tpr;
  int col[NV];
  float sc[NV][VEC];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    col[i] = (i * tpr + t) * VEC;
    if (col[i] < d) {
      load_f32<VEC>(scale + col[i], sc[i]);
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) sc[i][k] = 0.f;
    }
  }
  const int64_t step = static_cast<int64_t>(gridDim.x) * groups;
  int parity = 0;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * groups; base < rows;
       base += step, parity ^= 1) {
    const int64_t row = base + group;
    const bool live = row < rows;
    float v[NV][VEC];
    float ss[1] = {0.f};
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (live && col[i] < d) {
        load<VEC>(x + row * d + col[i], v[i]);
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) v[i][k] = 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) ss[0] += v[i][k] * v[i][k];
    }
    row_sum(ss, tpr, red, parity);
    const float inv = 1.0f / sqrtf(ss[0] / static_cast<float>(d) + eps);
    if (!live) continue;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (col[i] < d) {
        float o[VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k) o[k] = v[i][k] * inv * sc[i][k];
        store<VEC>(out + row * d + col[i], o);
      }
    }
  }
}

// Rows wider than the register route: one block per row (grid-stride), the
// row read once for the sum of squares and again, from L2, for the output.
template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_wide_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                    T* __restrict__ out, int64_t rows, int d, float eps) {
  __shared__ float red[2 * 32];
  const int first = threadIdx.x * VEC, stride = blockDim.x * VEC;
  int parity = 0;
  for (int64_t row = blockIdx.x; row < rows; row += gridDim.x, parity ^= 1) {
    const T* xr = x + row * d;
    float ss[1] = {0.f};
#pragma unroll 4
    for (int c = first; c < d; c += stride) {
      float v[VEC];
      load<VEC>(xr + c, v);
#pragma unroll
      for (int k = 0; k < VEC; ++k) ss[0] += v[k] * v[k];
    }
    row_sum(ss, blockDim.x, red, parity);
    const float inv = 1.0f / sqrtf(ss[0] / static_cast<float>(d) + eps);
    T* orow = out + row * d;
#pragma unroll 4
    for (int c = first; c < d; c += stride) {
      float v[VEC], sc[VEC];
      load<VEC>(xr + c, v);
      load_f32<VEC>(scale + c, sc);
#pragma unroll
      for (int k = 0; k < VEC; ++k) v[k] = v[k] * inv * sc[k];
      store<VEC>(orow + c, v);
    }
  }
}

// ---- backward ---------------------------------------------------------------

// As the forward; block b's row groups visit rows b * groups + group + k * step.
// Each block writes its dscale sums to partial[b] (d floats).
template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ partial,
                   int64_t rows, int d, int tpr, float eps) {
  extern __shared__ float group_sums[];  // groups x d, when a block holds several rows
  __shared__ float red[2 * 32 * 2];
  const int t = threadIdx.x % tpr, group = threadIdx.x / tpr, groups = blockDim.x / tpr;
  int col[NV];
  float sc[NV][VEC], acc[NV][VEC];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    col[i] = (i * tpr + t) * VEC;
#pragma unroll
    for (int k = 0; k < VEC; ++k) sc[i][k] = acc[i][k] = 0.f;
    if (col[i] < d) load_f32<VEC>(scale + col[i], sc[i]);
  }
  const float fd = static_cast<float>(d);
  const int64_t step = static_cast<int64_t>(gridDim.x) * groups;
  int parity = 0;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * groups; base < rows;
       base += step, parity ^= 1) {
    const int64_t row = base + group;
    const bool live = row < rows;
    float xv[NV][VEC], gv[NV][VEC];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (live && col[i] < d) {
        load<VEC>(x + row * d + col[i], xv[i]);
        load<VEC>(dy + row * d + col[i], gv[i]);
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) xv[i][k] = gv[i][k] = 0.f;
      }
    }
    float s[2] = {0.f, 0.f};  // sum x^2, sum (dy * scale) * x
#pragma unroll
    for (int i = 0; i < NV; ++i) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        s[0] += xv[i][k] * xv[i][k];
        s[1] += gv[i][k] * sc[i][k] * xv[i][k];
      }
    }
    row_sum<true>(s, tpr, red, parity);
    const float r = 1.0f / sqrtf(s[0] / fd + eps);
    const float mean = s[1] * r / fd;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      float o[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float xh = xv[i][k] * r;
        if (live) acc[i][k] += gv[i][k] * xh;
        o[k] = r * (gv[i][k] * sc[i][k] - xh * mean);
      }
      if (live && col[i] < d) store<VEC>(dx + row * d + col[i], o);
    }
  }
  float* prow = partial + static_cast<int64_t>(blockIdx.x) * d;
  if (groups == 1) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (col[i] < d) store_f32<VEC>(prow + col[i], acc[i]);
    }
    return;
  }
  // each group's sums in shared memory, value k of vector j at k * nvec + j
  // (a warp's lanes hit distinct banks), then added in group order
  const int nvec = d / VEC;  // d is a whole number of vectors on this route
  float* mine = group_sums + group * d;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (col[i] < d) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) mine[k * nvec + col[i] / VEC] = acc[i][k];
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < nvec; j += blockDim.x) {
    float sum[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) sum[k] = 0.f;
    for (int g = 0; g < groups; ++g) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) sum[k] += group_sums[g * d + k * nvec + j];
    }
    store_f32<VEC>(prow + j * VEC, sum);
  }
}

// Rows wider than the register route: one block per row (grid-stride); each
// thread owns vectors j = threadIdx.x + m * blockDim.x and sums their dscale
// in shared memory (IN_SHARED, d floats, value k of vector j at k * nvec + j
// so a warp's lanes hit distinct banks), or, for d beyond shared memory, in
// the block's own row of partials.
template <typename T, int VEC, bool IN_SHARED>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_bwd_wide_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                        const T* __restrict__ dy, T* __restrict__ dx,
                        float* __restrict__ partial, int64_t rows, int d, float eps) {
  extern __shared__ float shared_sums[];
  __shared__ float red[2 * 32 * 2];
  float* prow = partial + static_cast<int64_t>(blockIdx.x) * d;
  const int nvec = d / VEC;  // d is a whole number of vectors on this route
  for (int j = threadIdx.x; j < nvec; j += blockDim.x) {
    const float zero[VEC] = {};
    if constexpr (IN_SHARED) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) shared_sums[k * nvec + j] = 0.f;
    } else {
      store_f32<VEC>(prow + j * VEC, zero);
    }
  }
  const float fd = static_cast<float>(d);
  int parity = 0;
  for (int64_t row = blockIdx.x; row < rows; row += gridDim.x, parity ^= 1) {
    const T* xr = x + row * d;
    const T* gr = dy + row * d;
    float s[2] = {0.f, 0.f};
#pragma unroll 2
    for (int j = threadIdx.x; j < nvec; j += blockDim.x) {
      float xv[VEC], gv[VEC], sc[VEC];
      load<VEC>(xr + j * VEC, xv);
      load<VEC>(gr + j * VEC, gv);
      load_f32<VEC>(scale + j * VEC, sc);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        s[0] += xv[k] * xv[k];
        s[1] += gv[k] * sc[k] * xv[k];
      }
    }
    row_sum(s, blockDim.x, red, parity);
    const float r = 1.0f / sqrtf(s[0] / fd + eps);
    const float mean = s[1] * r / fd;
    T* orow = dx + row * d;
#pragma unroll 2
    for (int j = threadIdx.x; j < nvec; j += blockDim.x) {
      float xv[VEC], gv[VEC], sc[VEC], o[VEC], acc[VEC];
      load<VEC>(xr + j * VEC, xv);
      load<VEC>(gr + j * VEC, gv);
      load_f32<VEC>(scale + j * VEC, sc);
      if constexpr (!IN_SHARED) load_f32<VEC>(prow + j * VEC, acc);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float xh = xv[k] * r;
        if constexpr (IN_SHARED) shared_sums[k * nvec + j] += gv[k] * xh;
        else acc[k] += gv[k] * xh;
        o[k] = r * (gv[k] * sc[k] - xh * mean);
      }
      if constexpr (!IN_SHARED) store_f32<VEC>(prow + j * VEC, acc);
      store<VEC>(orow + j * VEC, o);
    }
  }
  if constexpr (IN_SHARED) {
    for (int j = threadIdx.x; j < nvec; j += blockDim.x) {
      float v[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) v[k] = shared_sums[k * nvec + j];
      store_f32<VEC>(prow + j * VEC, v);
    }
  }
}

// dscale[c] = the sum over parts of partial[p][c]: warp w of a block adds
// parts w, w + kSumWarps, ... for 32 columns, then the warps' sums are added
// in warp order.
__global__ void __launch_bounds__(kSumWarps * 32)
rmsnorm_dscale_kernel(const float* __restrict__ partial, float* __restrict__ dscale, int parts,
                      int d) {
  __shared__ float warp_sums[kSumWarps][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (c < d) {
#pragma unroll 8
    for (int p = warp; p < parts; p += kSumWarps) s += partial[static_cast<int64_t>(p) * d + c];
  }
  warp_sums[warp][lane] = s;
  __syncthreads();
  if (warp != 0 || c >= d) return;
  float sum = 0.f;
  for (int w = 0; w < kSumWarps; ++w) sum += warp_sums[w][lane];
  dscale[c] = sum;
}

// ---- launch -----------------------------------------------------------------

struct Args {
  const void* x;
  const float* scale;
  const void* dy;
  void* out;  // y (forward) or dx (backward)
  float* partial;
  int64_t rows;
  int d;
  float eps;
  int parts;  // backward blocks
};

// How a row is spread: tpr threads, each holding nv vectors of vec values;
// `wide` when a row needs more than kMaxThreads threads.
struct Plan {
  int tpr, nv;
  bool wide;
};

int threads_for(int nvec, int nv) {
  const int n = (nvec + nv - 1) / nv;
  if (n > 32) return (n + 31) / 32 * 32;
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

Plan plan(int64_t rows, int d, int vec, int max_elems) {
  const int nvec = (d + vec - 1) / vec;
  int nv = max_elems / vec;
  int tpr = threads_for(nvec, nv);
  if (tpr > kMaxThreads) return {kMaxThreads, 0, true};
  while (nv > 1 && rows * tpr < kBusyThreads && threads_for(nvec, nv / 2) <= kMaxThreads) {
    nv /= 2;
    tpr = threads_for(nvec, nv);
  }
  return {tpr, nv, false};
}

// whole rows of tpr threads, at least min_block threads when tpr is smaller
int block_for(int tpr, int min_block) { return tpr * std::max(1, min_block / tpr); }

// The backward's wide rows (more than kBwdMinBlock / 2 threads) get fewer
// blocks, for the partials' sake (`bwd_parts`), so each block holds as many
// of them as kMaxThreads threads allow, keeping rows in flight.
int bwd_block_for(int tpr) {
  return tpr > kBwdMinBlock / 2 ? kMaxThreads / tpr * tpr : block_for(tpr, kBwdMinBlock);
}

template <typename T, int VEC, int NV>
void launch_fwd(const Args& a, const Plan& p, cudaStream_t s) {
  const int block = block_for(p.tpr, kFwdMinBlock), groups = block / p.tpr;
  const int64_t grid = std::min<int64_t>((a.rows + groups - 1) / groups, kFwdMaxBlocks);
  rmsnorm_kernel<T, VEC, NV><<<static_cast<unsigned>(grid), block, 0, s>>>(
      static_cast<const T*>(a.x), a.scale, static_cast<T*>(a.out), a.rows, a.d, p.tpr, a.eps);
}

template <typename T, int VEC, int NV>
void launch_bwd(const Args& a, const Plan& p, cudaStream_t s) {
  const int block = bwd_block_for(p.tpr), groups = block / p.tpr;
  const size_t smem = groups > 1 ? static_cast<size_t>(groups) * a.d * sizeof(float) : 0;
  rmsnorm_bwd_kernel<T, VEC, NV><<<a.parts, block, smem, s>>>(
      static_cast<const T*>(a.x), a.scale, static_cast<const T*>(a.dy), static_cast<T*>(a.out),
      a.partial, a.rows, a.d, p.tpr, a.eps);
}

// launch the instance with p.nv vectors a thread (NV = 1, 2, 4, ... while
// NV * VEC <= MAX); false when there is none
template <typename T, int VEC, int MAX, bool BWD, int NV = 1>
bool launch_nv(const Args& a, const Plan& p, cudaStream_t s) {
  if constexpr (NV * VEC > MAX) {
    return false;
  } else {
    if (p.nv != NV) return launch_nv<T, VEC, MAX, BWD, NV * 2>(a, p, s);
    if constexpr (BWD) launch_bwd<T, VEC, NV>(a, p, s);
    else launch_fwd<T, VEC, NV>(a, p, s);
    return true;
  }
}

template <typename T, int VEC>
cudaError_t run_fwd(const Args& a, cudaStream_t s) {
  const Plan p = plan(a.rows, a.d, VEC, kFwdElems);
  if (!p.wide) {
    if (!launch_nv<T, VEC, kFwdElems, false>(a, p, s)) return cudaErrorInvalidValue;
  } else {
    const int64_t grid = std::min<int64_t>(a.rows, kFwdMaxBlocks);
    rmsnorm_wide_kernel<T, VEC><<<static_cast<unsigned>(grid), kMaxThreads, 0, s>>>(
        static_cast<const T*>(a.x), a.scale, static_cast<T*>(a.out), a.rows, a.d, a.eps);
  }
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t run_bwd(const Args& a, cudaStream_t s) {
  const Plan p = plan(a.rows, a.d, VEC, kBwdElems);
  if (!p.wide) {
    if (!launch_nv<T, VEC, kBwdElems, true>(a, p, s)) return cudaErrorInvalidValue;
  } else {
    int max_smem = 0, dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    const size_t smem = static_cast<size_t>(a.d) * sizeof(float);
    const T* x = static_cast<const T*>(a.x);
    const T* dy = static_cast<const T*>(a.dy);
    T* dx = static_cast<T*>(a.out);
    if (smem <= static_cast<size_t>(max_smem)) {
      auto kernel = rmsnorm_bwd_wide_kernel<T, VEC, true>;
      cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
      kernel<<<a.parts, kMaxThreads, smem, s>>>(x, a.scale, dy, dx, a.partial, a.rows, a.d,
                                                a.eps);
    } else {
      rmsnorm_bwd_wide_kernel<T, VEC, false><<<a.parts, kMaxThreads, 0, s>>>(
          x, a.scale, dy, dx, a.partial, a.rows, a.d, a.eps);
    }
  }
  return cudaGetLastError();
}

bool aligned16(const void* p) { return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// 16-byte accesses when d is a whole number of vectors and every base is
// 16-byte aligned (then so is every row); element-wide accesses otherwise
template <typename T>
cudaError_t run(const Args& a, bool bwd, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec_ok = a.d % kVec == 0 && aligned16(a.x) && aligned16(a.dy) && aligned16(a.out) &&
                      aligned16(a.scale);
  if (bwd) return vec_ok ? run_bwd<T, kVec>(a, s) : run_bwd<T, 1>(a, s);
  return vec_ok ? run_fwd<T, kVec>(a, s) : run_fwd<T, 1>(a, s);
}

cudaError_t run_dtype(const Args& a, int dtype, bool bwd, cudaStream_t s) {
  if (dtype == repro::kFloat32) return run<float>(a, bwd, s);
  if (dtype == repro::kBFloat16) return run<__nv_bfloat16>(a, bwd, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// partial holds `parts` rows of d f32 (one per block of the first kernel);
// parts comes from the wrapper, a function of (rows, d) alone.
extern "C" int repro_rmsnorm_bwd(const void* x, const void* scale, const void* dy, void* dx,
                                 void* partial, void* dscale, int64_t rows, int d, float eps,
                                 int parts, int dtype, void* stream) {
  if (rows <= 0 || d <= 0 || parts <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  const Args a{x, static_cast<const float*>(scale), dy, dx, part, rows, d, eps, parts};
  cudaError_t err = run_dtype(a, dtype, true, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  rmsnorm_dscale_kernel<<<(d + 31) / 32, kSumWarps * 32, 0, s>>>(
      part, static_cast<float*>(dscale), parts, d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_rmsnorm(const void* x, const void* scale, void* out, int64_t rows, int d,
                             float eps, int dtype, void* stream) {
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, static_cast<const float*>(scale), nullptr, out, nullptr, rows, d, eps, 0};
  return static_cast<int>(run_dtype(a, dtype, false, static_cast<cudaStream_t>(stream)));
}
