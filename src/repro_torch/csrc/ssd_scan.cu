// Mamba-2 SSD chunked scan with a carried (P, N) f32 state, on the model
// layout: x (B, S, H, P), dt (B, S, H) f32, A (H,) f32, B and C (B, S, G, N);
// y (B, S, H, P) in x's dtype and the final state (B, H, P, N) f32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan/kernel.py
// (_ssd_kernel / ssd_scan_kernel), whose grid is (batch, head, chunk) with
// the chunk axis sequential and the state in VMEM scratch. Per chunk of Q
// positions, with cum the running sum of dt * A inside the chunk:
//   y_i    = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//            + exp(cum_i) C_i . state_p
//   state' = exp(total) state + sum_j dt_j exp(total - cum_j) x_j (x) B_j
//
// Bound on the card: operations. The recurrence does 4 * P * N operations per
// (position, head) (the state update and the output, each a multiply-add over
// P x N), at the f32 rate, since all arithmetic is f32; the bytes (x, B, C,
// dt read once, y and the state written once) take less than a fifth of that
// at the mamba2 and zamba2 prefill shapes. This first kernel uses scalar f32
// FMAs on shared-memory tiles, not the tensor cores, and its per-chunk C.B^T
// is recomputed by every block of a group; wgmma and TMA, and one C.B^T per
// group, are for a later kernel.
//
// Design: the Pallas grid's sequential chunk axis becomes a loop inside one
// block of 256 threads per (16-column P tile, head, batch), so the state's
// 16 x N slice stays in shared memory from the first chunk to the last. The
// kernel picks its own chunk, Q = 32 positions (one warp's prefix sum; the
// result does not depend on the chunk beyond rounding), so that B, C, x, the
// scores and the state slice fit in 48 KB of shared memory at N = 128. Rows
// of B, C and the state are padded to an odd length, so that the column walks
// hit distinct banks. Per chunk: warp 0 loads dt and forms cum by a shuffle
// scan; all threads stage B, C and x as f32; the scores
// (C_i . B_j) exp(cum_i - cum_j) dt_j are formed where i >= j and set to 0
// above the diagonal, where the exponent would overflow (selected, never a
// multiplied mask: inf * 0 is NaN); each thread then writes its y entries and,
// after every read of the old state, updates its state entries. Positions at
// or past S are not loaded: they count as dt = 0, B = C = x = 0, an exact
// no-op on the recurrence, so the final state is that of the last real
// position. Head h reads group h / (H / G). x, dt, B, C and y are read and
// written through their (batch, seq, head) strides, so the caller needs no
// transpose and no padding; the last axis of x, B, C and y is contiguous.
#include "common.cuh"

namespace {

constexpr int kChunk = 32;  // positions per chunk: one warp's prefix sum
constexpr int kPTile = 16;  // head-dim columns per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 256;
constexpr int kLdq = kChunk + 1;  // scores row stride

struct Strides {
  int64_t b, s, h;
};

__host__ __device__ constexpr int odd_ld(int n) { return n | 1; }

__host__ __device__ constexpr size_t smem_floats(int n) {
  return static_cast<size_t>(2 * kChunk + kPTile) * odd_ld(n)  // B, C, state
         + kChunk * kPTile                                       // x
         + kChunk * kLdq                                         // scores
         + 3 * kChunk + 1;                                       // cum, dt, w, exp(total)
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
                const T* __restrict__ bm, const T* __restrict__ cm,
                const float* __restrict__ init, T* __restrict__ y, float* __restrict__ final_state,
                int S, int H, int G, int P, int N, Strides xs, Strides dts, Strides bs, Strides cs,
                Strides ys) {
  extern __shared__ float smem[];
  const int ldn = odd_ld(N);
  float* b_s = smem;                       // kChunk x ldn
  float* c_s = b_s + kChunk * ldn;         // kChunk x ldn
  float* st_s = c_s + kChunk * ldn;        // kPTile x ldn: the carried state
  float* x_s = st_s + kPTile * ldn;        // kChunk x kPTile
  float* sc_s = x_s + kChunk * kPTile;     // kChunk x kLdq: the scores
  float* cum_s = sc_s + kChunk * kLdq;     // kChunk
  float* dt_s = cum_s + kChunk;            // kChunk
  float* w_s = dt_s + kChunk;              // kChunk: dt_j exp(total - cum_j)
  float* etot_s = w_s + kChunk;            // 1: exp(total)

  const int pt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int grp = h / (H / G);
  const int p0 = pt * kPTile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float a_h = A[h];

  const T* xb = x + b * xs.b + h * xs.h + p0;
  const float* dtb = dt + b * dts.b + h * dts.h;
  const T* bb = bm + b * bs.b + grp * bs.h;
  const T* cb = cm + b * cs.b + grp * cs.h;
  T* yb = y + b * ys.b + h * ys.h + p0;
  const int64_t state_base = (static_cast<int64_t>(b) * H + h) * P + p0;  // row of (B, H, P, N)

  for (int e = tid; e < kPTile * N; e += kThreads) {
    const int p = e / N, n = e - p * N;
    float v = 0.f;
    if (init != nullptr && p0 + p < P) v = init[(state_base + p) * N + n];
    st_s[p * ldn + n] = v;
  }

  for (int c0 = 0; c0 < S; c0 += kChunk) {
    __syncthreads();  // the last chunk's reads of B, x, w and exp(total) are done
    if (warp == 0) {
      const int s = c0 + lane;
      const float d = s < S ? dtb[s * dts.s] : 0.f;
      float cum = d * a_h;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, cum, off);
        if (lane >= off) cum += o;
      }
      const float total = __shfl_sync(0xffffffffu, cum, 31);
      cum_s[lane] = cum;
      dt_s[lane] = d;
      w_s[lane] = d * expf(total - cum);
      if (lane == 0) etot_s[0] = expf(total);
    }
    for (int e = tid; e < kChunk * N; e += kThreads) {
      const int r = e / N, n = e - r * N;
      const int s = c0 + r;
      float bv = 0.f, cv = 0.f;
      if (s < S) {
        bv = repro::to_f32(bb[s * bs.s + n]);
        cv = repro::to_f32(cb[s * cs.s + n]);
      }
      b_s[r * ldn + n] = bv;
      c_s[r * ldn + n] = cv;
    }
    for (int e = tid; e < kChunk * kPTile; e += kThreads) {
      const int r = e / kPTile, p = e - r * kPTile;
      const int s = c0 + r;
      x_s[e] = (s < S && p0 + p < P) ? repro::to_f32(xb[s * xs.s + p]) : 0.f;
    }
    __syncthreads();

    // scores: thread (rows warp + 8 k, column lane)
    {
      constexpr int kRows = kChunk / kWarps;
      const int j = lane;
      float acc[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k) acc[k] = 0.f;
      for (int n = 0; n < N; ++n) {
        const float bv = b_s[j * ldn + n];
#pragma unroll
        for (int k = 0; k < kRows; ++k) acc[k] = fmaf(c_s[(warp + kWarps * k) * ldn + n], bv, acc[k]);
      }
      const float cj = cum_s[j], dj = dt_s[j];
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int i = warp + kWarps * k;
        sc_s[i * kLdq + j] = i >= j ? acc[k] * expf(cum_s[i] - cj) * dj : 0.f;
      }
    }
    __syncthreads();

    // y: thread (column tid % 16, rows tid / 16 + 16 k)
    {
      const int p = tid % kPTile;
#pragma unroll
      for (int k = 0; k < kChunk * kPTile / kThreads; ++k) {
        const int i = tid / kPTile + (kThreads / kPTile) * k;
        float intra = 0.f;
        for (int j = 0; j <= i; ++j) intra = fmaf(sc_s[i * kLdq + j], x_s[j * kPTile + p], intra);
        float inter = 0.f;
        for (int n = 0; n < N; ++n) inter = fmaf(c_s[i * ldn + n], st_s[p * ldn + n], inter);
        const int s = c0 + i;
        if (s < S && p0 + p < P) yb[s * ys.s + p] = repro::from_f32<T>(intra + inter * expf(cum_s[i]));
      }
    }
    __syncthreads();  // every read of the old state is done

    // state' = exp(total) state + sum_j (x_j w_j) (x) B_j
    {
      const float et = etot_s[0];
      for (int e = tid; e < kPTile * N; e += kThreads) {
        const int p = e / N, n = e - p * N;
        float contrib = 0.f;
#pragma unroll 8
        for (int j = 0; j < kChunk; ++j)
          contrib = fmaf(x_s[j * kPTile + p] * w_s[j], b_s[j * ldn + n], contrib);
        st_s[p * ldn + n] = st_s[p * ldn + n] * et + contrib;
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < kPTile * N; e += kThreads) {
    const int p = e / N, n = e - p * N;
    if (p0 + p < P) final_state[(state_base + p) * N + n] = st_s[p * ldn + n];
  }
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* bm, const void* cm,
           const float* init, void* y, float* final_state, int B, int S, int H, int G, int P,
           int N, Strides xs, Strides dts, Strides bs, Strides cs, Strides ys,
           cudaStream_t stream) {
  const size_t bytes = smem_floats(N) * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((P + kPTile - 1) / kPTile, H, B);
  ssd_scan_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(bm), static_cast<const T*>(cm), init,
      static_cast<T*>(y), final_state, S, H, G, P, N, xs, dts, bs, cs, ys);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// init may be null (a zero initial state). Strides are in elements, in the
// order (batch, seq, head-or-group); the last axis of x, B, C and y has
// stride 1, and init and final_state are contiguous (B, H, P, N).
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* A, const void* bm,
                              const void* cm, const void* init, void* y, void* final_state, int B,
                              int S, int H, int G, int P, int N, int64_t xs_b, int64_t xs_s,
                              int64_t xs_h, int64_t dts_b, int64_t dts_s, int64_t dts_h,
                              int64_t bs_b, int64_t bs_s, int64_t bs_h, int64_t cs_b, int64_t cs_s,
                              int64_t cs_h, int64_t ys_b, int64_t ys_s, int64_t ys_h, int dtype,
                              void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G || P <= 0 || N <= 0 || N > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides xs{xs_b, xs_s, xs_h}, dts{dts_b, dts_s, dts_h}, bs{bs_b, bs_s, bs_h},
      cs{cs_b, cs_s, cs_h}, ys{ys_b, ys_s, ys_h};
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(A);
  const float* initf = static_cast<const float*>(init);
  float* fs = static_cast<float*>(final_state);
  if (dtype == repro::kFloat32)
    return launch<float>(x, dtf, af, bm, cm, initf, y, fs, B, S, H, G, P, N, xs, dts, bs, cs, ys, st);
  if (dtype == repro::kBFloat16)
    return launch<__nv_bfloat16>(x, dtf, af, bm, cm, initf, y, fs, B, S, H, G, P, N, xs, dts, bs,
                                 cs, ys, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
