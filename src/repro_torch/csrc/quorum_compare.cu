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
//
// repro_quorum_pair_counts, beside it, counts the same test for every pair
// of rows of one (n, d) matrix in a panel: count[i - lo, r] for
// lo <= i < hi and r < i, b being the earlier row r (0 where r >= i). It
// gives the validation engine's greedy first-match grouping every verdict a
// panel needs in one call, where one call (and one host sync) a pair cost
// ~2.5 us for 32 KiB of work. Bound on the card: operations, about 5 f32
// operations per element of a pair (the tolerance of b, a subtraction, a
// comparison, an add), d * n (n - 1) / 2 pairs, against n * d * sizeof(T)
// bytes read and 4 * n^2 written. The tensor cores do not apply: a
// threshold count is not a product. Design, as an SGEMM's: a block owns
// 64 i-rows by 64 r-rows of the lower triangle (tiles wholly above the
// diagonal are not launched, 16 x 16 groups of a tile that hold no pair
// r < i are skipped); the d axis streams through shared memory in 128-byte
// column chunks, double-buffered with cp.async, so each element is read
// from device memory or L2 once per tile, not once per pair; each of the
// 256 threads keeps a 4 x 4 micro-tile of pair counts in registers. The
// digests' panels have few tiles (n of tens to hundreds) and long rows
// (4096), so the wrapper also splits the d axis into slices, one block per
// (tile, slice), until the card's SMs are busy; each slice's counts go to
// a buffer of their own and a second kernel adds the slices in a fixed
// order. Every count has exactly one owner thread in each kernel: no
// atomics, and every run gives the same bits. The row pitch in shared
// memory (144 bytes) makes each quarter-warp's 16-byte reads of eight rows
// conflict-free. Rows whose start is not 16-byte aligned (d * sizeof(T) %
// 16 != 0, or an offset base) are copied one element at a time (cp.async
// for f32, plain loads for bf16's 2 bytes); the last chunk of a row is
// partial. The arithmetic is tally's, operation for
// operation.
#include "common.cuh"
#include "mma.cuh"

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

// ---- pair counts (repro_quorum_pair_counts) --------------------------------

constexpr int kPairTile = 64;              // i-rows and r-rows a block owns
constexpr int kPairThreads = 256;          // 16 x 16 threads, 4 x 4 pairs each
constexpr int kChunkBytes = 128;           // the bytes of a row one chunk holds
constexpr int kPitch = kChunkBytes + 16;   // a row's pitch in shared memory
constexpr int kStageBytes = 2 * kPairTile * kPitch;  // the i-rows, then the r-rows

// The 16 bytes at p as f32: four floats, or eight bf16 widened exactly.
__device__ __forceinline__ void load16(const unsigned char* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

__device__ __forceinline__ void load16(const unsigned char* p, float (&v)[8]) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[2 * j] = __uint_as_float(w[j] << 16);  // the lower half is the earlier element
    v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

// Copy columns [k0, k0 + kChunkBytes / sizeof(T)) of the tile's i-rows
// [i0, i0 + 64) and r-rows [r0, r0 + 64) into one stage: 16 bytes a copy by
// cp.async where every row start is 16-byte aligned (kVec), else one
// element a copy (cp.async for f32, a plain load for bf16). Rows at or past
// hi and columns at or past d arrive as zeros.
template <typename T, bool kVec>
__device__ __forceinline__ void stage_chunk(unsigned char* stage, const T* rows, int64_t d,
                                            int hi, int i0, int r0, int64_t k0) {
  constexpr int kUnit = kVec ? 16 : static_cast<int>(sizeof(T));  // bytes a copy
  constexpr int kPer = kUnit / static_cast<int>(sizeof(T));  // elements a copy
  constexpr int kUnits = kChunkBytes / kUnit;  // copies a row
  for (int u = threadIdx.x; u < 2 * kPairTile * kUnits; u += kPairThreads) {
    const int row = u / kUnits, part = u % kUnits;
    const int grow = row < kPairTile ? i0 + row : r0 + row - kPairTile;
    const int64_t col = k0 + static_cast<int64_t>(part) * kPer;
    const bool ok = grow < hi && col < d;
    unsigned char* dst = stage + row * kPitch + part * kUnit;
    const T* src = ok ? rows + static_cast<int64_t>(grow) * d + col : rows;
    if constexpr (kUnit == 16) {
      cp_async16(dst, src, ok ? 16 : 0);
    } else if constexpr (sizeof(T) == 4) {
      cp_async4(dst, src, ok ? 4 : 0);
    } else {
      *reinterpret_cast<uint16_t*>(dst) = ok ? *reinterpret_cast<const uint16_t*>(src) : 0;
    }
  }
}

// Add the verdicts of one 16-byte column group s of a staged chunk to the
// thread's micro-tile: its i-rows ty + 16 a against its r-rows tx + 16 b,
// the groups (a, b) whose bit (4 a + b) is set in `live` (the same for the
// whole block), the chunk's first kmax columns only (all unless kTail).
template <typename T, bool kTail>
__device__ __forceinline__ void count_step(const unsigned char* sa, const unsigned char* sb, int s,
                                           int kmax, unsigned live, float rtol, float atol,
                                           int (&cnt)[4][4]) {
  constexpr int E = 16 / sizeof(T);  // elements in 16 bytes
  float b[4][E], tol[4][E];
#pragma unroll
  for (int bb = 0; bb < 4; ++bb) {
    if (!(live & (0x1111u << bb))) continue;
    load16(sb + bb * 16 * kPitch + s * 16, b[bb]);
#pragma unroll
    for (int e = 0; e < E; ++e) tol[bb][e] = __fadd_rn(atol, __fmul_rn(rtol, fabsf(b[bb][e])));
  }
#pragma unroll
  for (int aa = 0; aa < 4; ++aa) {
    if (!(live & (0xfu << (4 * aa)))) continue;
    float a[E];
    load16(sa + aa * 16 * kPitch + s * 16, a);
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) {
      if (!(live & (1u << (4 * aa + bb)))) continue;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const bool bad = fabsf(__fsub_rn(a[e], b[bb][e])) > tol[bb][e];
        if (!kTail || s * E + e < kmax) cnt[aa][bb] += bad ? 1 : 0;
      }
    }
  }
}

// One staged chunk: every 16-byte group of a full chunk, or the groups that
// hold a partial chunk's kmax columns.
template <typename T>
__device__ __forceinline__ void count_chunk(const unsigned char* stage, int tx, int ty, int kmax,
                                            unsigned live, float rtol, float atol,
                                            int (&cnt)[4][4]) {
  constexpr int E = 16 / sizeof(T);
  constexpr int kSteps = kChunkBytes / 16;
  const unsigned char* sa = stage + ty * kPitch;
  const unsigned char* sb = stage + (kPairTile + tx) * kPitch;
  if (kmax == kSteps * E) {
#pragma unroll
    for (int s = 0; s < kSteps; ++s) count_step<T, false>(sa, sb, s, kmax, live, rtol, atol, cnt);
  } else {
#pragma unroll 1
    for (int s = 0; s * E < kmax; ++s) count_step<T, true>(sa, sb, s, kmax, live, rtol, atol, cnt);
  }
}

// One block a (tile, slice): blockIdx.x walks the tiles (i-tiles in order,
// each with the r-tiles up to its last row's diagonal), blockIdx.y the
// slices of slice_chunks chunks of the d axis. Writes the tile's counts
// over its slice into out + blockIdx.y * (hi - lo) * hi, with the columns
// past the diagonal tile of each row as 0: every entry of the slice's
// (hi - lo, hi) matrix is written by exactly one thread.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kPairThreads)
quorum_pairs_kernel(const T* __restrict__ rows, int64_t d, int lo, int hi, float rtol, float atol,
                    int64_t slice_chunks, int* __restrict__ out) {
  __shared__ __align__(16) unsigned char smem[2][kStageBytes];
  int t = blockIdx.x, i0 = lo, nr = 0;
  for (;; i0 += kPairTile) {
    const int i1 = min(hi, i0 + kPairTile);
    nr = (i1 - 1 + kPairTile - 1) / kPairTile;  // r-tiles covering [0, i1 - 1)
    if (t < nr) break;
    t -= nr;
  }
  const int r0 = t * kPairTile;
  out += static_cast<int64_t>(blockIdx.y) * (hi - lo) * hi;
  // the 16 x 16 groups that hold a pair r < i of rows below hi
  unsigned live = 0;
#pragma unroll
  for (int aa = 0; aa < 4; ++aa) {
    const int imax = min(i0 + 16 * aa + 15, hi - 1);
#pragma unroll
    for (int bb = 0; bb < 4; ++bb)
      if (i0 + 16 * aa < hi && r0 + 16 * bb < imax) live |= 1u << (4 * aa + bb);
  }
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  constexpr int kCols = kChunkBytes / sizeof(T);
  const int64_t chunks = (d + kCols - 1) / kCols;
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * slice_chunks;
  const int64_t c1 = c0 + slice_chunks < chunks ? c0 + slice_chunks : chunks;
  int cnt[4][4] = {};
  if (c0 < c1) {
    stage_chunk<T, kVec>(smem[0], rows, d, hi, i0, r0, c0 * kCols);
    cp_async_commit();
  }
  for (int64_t c = c0; c < c1; ++c) {
    if (c + 1 < c1) {
      stage_chunk<T, kVec>(smem[(c + 1 - c0) & 1], rows, d, hi, i0, r0, (c + 1) * kCols);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int64_t left = d - c * kCols;
    count_chunk<T>(smem[(c - c0) & 1], tx, ty, left < kCols ? static_cast<int>(left) : kCols, live,
                   rtol, atol, cnt);
    __syncthreads();  // the stage is refilled next
  }
#pragma unroll
  for (int aa = 0; aa < 4; ++aa) {
    const int i = i0 + ty + 16 * aa;
    if (i >= hi) continue;
    int* row_out = out + static_cast<int64_t>(i - lo) * hi;
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) {
      const int r = r0 + tx + 16 * bb;
      if (r < hi) row_out[r] = r < i ? cnt[aa][bb] : 0;
    }
  }
  if (t == nr - 1) {  // the diagonal tile zeroes its rows past the tile
    for (int row = 0; row < kPairTile && i0 + row < hi; ++row) {
      int* row_out = out + static_cast<int64_t>(i0 + row - lo) * hi;
      for (int r = r0 + kPairTile + threadIdx.x; r < hi; r += kPairThreads) row_out[r] = 0;
    }
  }
}

// counts[e] = the sum over the slices of partials[s * entries + e], in slice
// order.
__global__ void __launch_bounds__(kPairThreads)
quorum_pairs_sum_kernel(const int* __restrict__ partials, int slices, int64_t entries,
                        int* __restrict__ counts) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kPairThreads;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * kPairThreads + threadIdx.x; e < entries;
       e += stride) {
    int sum = 0;
    for (int s = 0; s < slices; ++s) sum += partials[s * entries + e];
    counts[e] = sum;
  }
}

template <typename T, bool kVec>
int launch_pairs(const void* rows, int64_t d, int lo, int hi, float rtol, float atol, int tiles,
                 int slices, void* partials, void* counts, cudaStream_t stream) {
  constexpr int kCols = kChunkBytes / sizeof(T);
  const int64_t chunks = (d + kCols - 1) / kCols;
  const int64_t slice_chunks = (chunks + slices - 1) / slices;
  int* out = static_cast<int*>(slices > 1 ? partials : counts);
  quorum_pairs_kernel<T, kVec><<<dim3(tiles, slices), kPairThreads, 0, stream>>>(
      static_cast<const T*>(rows), d, lo, hi, rtol, atol, slice_chunks, out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return static_cast<int>(err);
  const int64_t entries = static_cast<int64_t>(hi - lo) * hi;
  const int64_t blocks = (entries + kPairThreads - 1) / kPairThreads;
  quorum_pairs_sum_kernel<<<static_cast<int>(blocks < 132 * 8 ? blocks : 132 * 8), kPairThreads, 0,
                            stream>>>(static_cast<const int*>(partials), slices, entries,
                                      static_cast<int*>(counts));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// counts (int32, row-major (hi - lo, hi)) of out-of-tolerance elements for
// every pair of rows lo <= i < hi, r < i of the row-major (n, d) matrix
// `rows`, 0 where r >= i. vec says that every row starts 16-byte aligned
// (the base and d * sizeof(T)), so copies take 16 bytes; slices (1 to 65535)
// splits the d axis across blocks, and for slices > 1 partials holds
// slices * (hi - lo) * hi int32.
extern "C" int repro_quorum_pair_counts(const void* rows, int64_t n, int64_t d, int64_t lo,
                                        int64_t hi, float rtol, float atol, int vec, int slices,
                                        void* partials, void* counts, int dtype, void* stream) {
  if (n < 2 || n > INT32_MAX || d < 0 || d > INT32_MAX || lo < 0 || hi > n || hi < 2 ||
      lo >= hi || slices < 1 || slices > 65535 || (slices > 1 && partials == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  int64_t tiles = 0;
  for (int64_t i0 = lo; i0 < hi; i0 += kPairTile) {
    const int64_t i1 = i0 + kPairTile < hi ? i0 + kPairTile : hi;
    tiles += (i1 - 1 + kPairTile - 1) / kPairTile;
  }
  if (tiles > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int l = static_cast<int>(lo), h = static_cast<int>(hi), g = static_cast<int>(tiles);
#define REPRO_PAIRS(T, V) launch_pairs<T, V>(rows, d, l, h, rtol, atol, g, slices, partials, counts, s)
  if (dtype == repro::kFloat32) return vec ? REPRO_PAIRS(float, true) : REPRO_PAIRS(float, false);
  if (dtype == repro::kBFloat16)
    return vec ? REPRO_PAIRS(__nv_bfloat16, true) : REPRO_PAIRS(__nv_bfloat16, false);
#undef REPRO_PAIRS
  return static_cast<int>(cudaErrorInvalidValue);
}

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
