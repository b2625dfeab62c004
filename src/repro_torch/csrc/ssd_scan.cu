// Mamba-2 SSD chunked scan with a carried (P, N) f32 state, on the model
// layout: x (B, S, H, P), dt (B, S, H) f32, A (H,) f32, B and C (B, S, G, N);
// y (B, S, H, P) in x's dtype and the final state (B, H, P, N) f32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan/kernel.py
// (_ssd_kernel / ssd_scan_kernel), whose grid is (batch, head, chunk) with
// the chunk axis sequential and the state in VMEM scratch. Per chunk of Q
// positions, with cum the running sum of dt * A inside the chunk and total
// its last value:
//   y_i    = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//            + exp(cum_i) C_i . state_p
//   state' = exp(total) state + sum_j dt_j exp(total - cum_j) x_j (x) B_j
//
// Bound on the card: bytes (x, B, C, dt read once; y and the final state
// written once), as chip_smoke.py counts them; the operations (4 P N per
// position and head) take about a third of that time at the bf16
// tensor-core rate at the mamba2 and zamba2 prefill shapes.
//
// Design: Mamba-2's own chunked algorithm, with the sequential chunk axis
// taken out of the heavy work. Chunks of Q = 64 positions; three launches:
//   1. ssd_chunk_state_kernel, grid (chunk, head, batch), all parallel:
//      cum by a warp scan, and the chunk's own state contribution
//      s_c = sum_j dt_j exp(total - cum_j) x_j (x) B_j, written in f32 to a
//      workspace (B, nc, H, P, N), with total to (B, H, nc).
//   2. ssd_state_pass_kernel, one thread per four (batch, head, p, n)
//      elements (16-byte accesses; one where N % 4 != 0): walks the chunks
//      in order, state_c = exp(total_c) state_(c-1) + s_c from the initial
//      state, writes chunk c's incoming state (over s_c in f32; in bf16,
//      rounded, to a workspace of its own, as the output's products take
//      it) and the final state. The only sequential loop: nc steps of one
//      FMA, the workspace reads issued eight chunks at a time.
//   3. ssd_chunk_output_kernel, grid (chunk, head, batch), all parallel:
//      y = (C B^T o L o dt_j) x + exp(cum_i) C state_in^T, cast once. In
//      bf16 a block takes two heads of a group where that still leaves two
//      blocks an SM: C and B are staged once for both, which halves the
//      blocks (one wave at the zamba2 shape) and the reads of C and B.
// Each block issues every tile it needs by cp.async before it waits (bf16),
// so its global loads share one round trip.
// The workspaces stay in the 50 MB L2 at the serving shapes (8.6 MB of f32
// at mamba2's, 11.5 MB at zamba2's, and half that again in bf16). No float
// atomics: equal inputs give equal bits.
//
// bf16 runs every product on the tensor cores (mma.sync.m16n8k16, bf16
// operands from ldmatrix, f32 accumulators; 4 warps of 16 rows): C B^T (exact
// for bf16 inputs), the scores (C B^T o L o dt_j, rounded to bf16 in
// registers as the A operand) times x, C times the incoming state (rounded to
// bf16 as an operand), and x^T diag(w) B for s_c. The state keeps f32's
// digits: x_j w_j enters s_c as two bf16 operands, its rounding and what the
// rounding left (two products into one accumulator, B exact), so the final
// state holds to 1e-4 in bf16 too; the carried state stays f32. f32 runs the
// same three stages with scalar f32 FMAs on shared-memory tiles (no TF32:
// the f32 checks hold to 1e-4).
// The scores above the diagonal are selected to 0, never multiplied by a
// mask: exp(cum_i - cum_j) overflows there (inf * 0 is NaN). A warp's rows
// [16 w, 16 w + 16) meet no key past 16 w + 15, so the bf16 kernels skip
// those products.
//
// The backward (repro_ssd_scan_bwd) has no Pallas counterpart: the
// reference differentiates its jnp ssd_chunked with XLA. Bound on the card:
// bytes (x, dy, B, C, dt read once; dx, dB, dC, ddt written once). Six
// launches: the chunk-state kernel and the pass again, for every chunk's
// incoming state; the same two on (dy, C) with weights exp(cum_i) and the
// pass walking the chunks in reverse, for every chunk's outgoing state
// gradient G_out (G_in = exp(total) G_out + sum_i exp(cum_i) dy_i (x) C_i);
// ssd_chunk_bwd_kernel, one block per (chunk, head, batch), for dx, ddt and
// the head's shares of dB, dC and dA (ref.py's docstring has the formulas);
// ssd_bwd_reduce_kernel, which sums the shares over a group's heads and
// (batch, chunk) in a fixed order. The chunk kernel runs, in bf16, its eight
// products on the tensor cores (bwd_mma: bf16 operands, f32 accumulators;
// the scores Sx and Sb, G_out and S_in rounded to bf16 as operands, the
// decay derivative's terms kept in f32); in f32, scalar FMAs on f32 tiles
// (bwd_fma, one 153 KB block an SM).
//
// Positions at or past S are not loaded: they count as dt = 0,
// B = C = x = 0, an exact no-op on the recurrence, so the final state is
// that of the last real position. Head h reads group h / (H / G). x, dt, B,
// C and y are read and written through their (batch, seq, head) strides with
// a unit last stride; 16-byte loads where a tensor's base, strides and width
// allow, else element loads with the same arithmetic. P is walked in tiles of
// 64 columns, so any P is taken; N up to 256 (padded to 16 in shared memory).
#include <initializer_list>
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kQ = 64;         // positions per chunk; also the P tile and the state tile's rows
constexpr int kThreads = 128;  // 4 warps of 16 rows
constexpr int kMaxN = 256;
constexpr int kPassThreads = 256;

struct Strides {
  int64_t b, s, h;
};

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* bm;
  const void* cm;
  const float* init;  // null: zeros
  void* y;
  float* final_state;
  float* ws;     // (B, nc, H, P, N): s_c, then chunk c's incoming state
  bf16* ws_in;   // bf16 only, (B, nc, H, P, N): the incoming states as the output's operands
  float* total;  // (B, H, nc)
  int S, H, G, P, N, nc;
  Strides xs, dts, bs, cs, ys;
  bool vec_x, vec_bc, vec_ws;  // 16-byte loads allowed
  bool pair_y;                 // y takes 2-element stores
  // the backward's state-gradient sums: x is dy, B is C, and position i
  // weighs exp(cum_i) in place of dt_i exp(total - cum_i)
  bool grad;
};

template <typename T>
constexpr bool kMma = sizeof(T) == 2;  // bf16: tensor cores; f32: scalar FMAs

__host__ __device__ constexpr int round16(int n) { return (n + 15) & ~15; }

// Shared row stride of a tile of `cols` (a multiple of 16) columns: bf16
// rows padded by 16 bytes, so the 8 rows of one ldmatrix phase fall in 8
// distinct bank groups; f32 rows padded to an odd length, so column walks
// hit distinct banks.
template <typename T>
__host__ __device__ constexpr int tile_ld(int cols) {
  return kMma<T> ? cols + 8 : cols + 1;
}

template <typename O>
__device__ __forceinline__ O cast(float v) {
  return repro::from_f32<O>(v);
}

// Stage a kQ-row tile: element (r, c) is src[r * rs + c] (times scale[r]
// when given) for r < rows and c < cols, else 0, rounded to O; cpad (a
// multiple of 16) columns, row stride ld in the tile. With vec, 16-byte
// loads, kInFlight of them issued before any is stored (cols, rs and src
// then keep 16-byte alignment); else element loads. Both give the same bits.
template <typename T, typename O>
__device__ __forceinline__ void stage(O* __restrict__ tile, int ld, const T* __restrict__ src,
                                      int64_t rs, int rows, int cols, int cpad,
                                      const float* __restrict__ scale, bool vec, int tid) {
  if (vec) {
    constexpr int kV = 16 / sizeof(T);
    constexpr int kInFlight = 8;
    const int cpr = cpad / kV, n = kQ * cpr;
    for (int i0 = tid; i0 < n; i0 += kInFlight * kThreads) {
      uint4 raw[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int i = i0 + u * kThreads, r = i / cpr, c = (i - r * cpr) * kV;
        raw[u] = make_uint4(0u, 0u, 0u, 0u);
        if (i < n && r < rows && c < cols) raw[u] = *reinterpret_cast<const uint4*>(src + r * rs + c);
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int i = i0 + u * kThreads, r = i / cpr, c = (i - r * cpr) * kV;
        if (i >= n) break;
        const T* v = reinterpret_cast<const T*>(&raw[u]);
        const float sc = scale != nullptr ? scale[r] : 1.f;
#pragma unroll
        for (int k = 0; k < kV; ++k) tile[r * ld + c + k] = cast<O>(repro::to_f32(v[k]) * sc);
      }
    }
  } else {
#pragma unroll 4
    for (int i = tid; i < kQ * cpad; i += kThreads) {
      const int r = i / cpad, c = i - r * cpad;
      float v = 0.f;
      if (r < rows && c < cols) v = repro::to_f32(src[r * rs + c]) * (scale != nullptr ? scale[r] : 1.f);
      tile[r * ld + c] = cast<O>(v);
    }
  }
}

// A bf16 tile copied as it is (the element rule of stage): by cp.async,
// 16 bytes a thread, where vec allows (the caller commits and waits before
// its __syncthreads), else by element loads. A block issues all its tiles
// before it waits, so their loads share one round trip.
__device__ __forceinline__ void stage_copy(bf16* __restrict__ tile, int ld,
                                           const bf16* __restrict__ src, int64_t rs, int rows,
                                           int cols, int cpad, bool vec, int tid) {
  if (!vec) {
    stage<bf16, bf16>(tile, ld, src, rs, rows, cols, cpad, nullptr, false, tid);
    return;
  }
  const int cpr = cpad / 8, n = kQ * cpr;
  for (int i = tid; i < n; i += kThreads) {
    const int r = i / cpr, c = (i - r * cpr) * 8;
    const bool ok = r < rows && c < cols;
    cp_async16(tile + r * ld + c, ok ? src + r * rs + c : src, ok ? 16 : 0);
  }
}

// dt of the chunk's positions and cum = dt * A summed within each warp of
// 32 (threads 0-63); after the caller's __syncthreads, cum_at gives the
// chunk's running sum.
__device__ __forceinline__ void chunk_dt(float* dt_s, float* cum_s, const float* __restrict__ dt,
                                         const Strides& dts, int b, int h, int c0, int S, float a_h,
                                         int tid) {
  if (tid < kQ) {
    const int s = c0 + tid;
    const float d = s < S ? dt[b * dts.b + s * dts.s + h * dts.h] : 0.f;
    float cum = d * a_h;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, cum, off);
      if ((tid & 31) >= off) cum += o;
    }
    dt_s[tid] = d;
    cum_s[tid] = cum;
  }
}

__device__ __forceinline__ float cum_at(const float* cum_s, int i) {
  return cum_s[i] + (i >= 32 ? cum_s[31] : 0.f);
}

// ---- 1. each chunk's own state contribution --------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_state_kernel(Args a) {
  using Tile = typename std::conditional<kMma<T>, bf16, float>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int npad = round16(a.N);
  const int ldb = tile_ld<T>(npad), ldx = kMma<T> ? tile_ld<T>(kQ) : kQ;
  float* dt_s = reinterpret_cast<float*>(smem_raw);
  float* cum_s = dt_s + kQ;
  float* w_s = cum_s + kQ;
  Tile* sb = reinterpret_cast<Tile*>(w_s + kQ);  // kQ x ldb: B
  Tile* sx = sb + kQ * ldb;                      // kQ x ldx: x_j w_j, one P tile
  Tile* sxl = sx + kQ * ldx;                     // bf16 only: what rounding x_j w_j left
  Tile* sxr = sxl + kQ * ldx;                    // bf16 only: the P tile of x as it is

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int c0 = c * kQ, rows = min(kQ, a.S - c0);
  const int grp = h / (a.H / a.G);
  const int tid = threadIdx.x;
  const T* xb = static_cast<const T*>(a.x) + b * a.xs.b + h * a.xs.h + c0 * a.xs.s;
  const T* bb = static_cast<const T*>(a.bm) + b * a.bs.b + grp * a.bs.h + c0 * a.bs.s;
  float* out = a.ws + ((static_cast<int64_t>(b) * a.nc + c) * a.H + h) * a.P * a.N;

  if constexpr (kMma<T>) {
    stage_copy(sb, ldb, bb, a.bs.s, rows, a.N, npad, a.vec_bc, tid);
    stage_copy(sxr, ldx, xb, a.xs.s, rows, min(kQ, a.P), kQ, a.vec_x, tid);
    cp_async_commit();
  } else {
    stage<T, Tile>(sb, ldb, bb, a.bs.s, rows, a.N, npad, nullptr, a.vec_bc, tid);
  }
  chunk_dt(dt_s, cum_s, a.dt, a.dts, b, h, c0, a.S, a.A[h], tid);
  cp_async_wait<0>();
  __syncthreads();
  const float total = cum_s[31] + cum_s[kQ - 1];
  if (tid < kQ)
    w_s[tid] = a.grad ? expf(cum_at(cum_s, tid)) : dt_s[tid] * expf(total - cum_at(cum_s, tid));
  if (tid == 0) a.total[(static_cast<int64_t>(b) * a.H + h) * a.nc + c] = total;

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  for (int p0 = 0; p0 < a.P; p0 += kQ) {
    __syncthreads();  // w_s written; the last tile read by everyone
    if constexpr (kMma<T>) {
      if (p0 > 0) {
        stage_copy(sxr, ldx, xb + p0, a.xs.s, rows, min(kQ, a.P - p0), kQ, a.vec_x, tid);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
      }
      // x_j w_j as two bf16 operands: its rounding and what the rounding left
      for (int i = tid; i < kQ * kQ / 2; i += kThreads) {
        const int r = i / (kQ / 2), at = r * ldx + 2 * (i - r * (kQ / 2));
        const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sxr + at));
        const float v0 = v.x * w_s[r], v1 = v.y * w_s[r];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(v0, v1);
        const float2 hf = __bfloat1622float2(hi);
        *reinterpret_cast<__nv_bfloat162*>(sx + at) = hi;
        *reinterpret_cast<__nv_bfloat162*>(sxl + at) = __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
      }
    } else {
      stage<T, Tile>(sx, ldx, xb + p0, a.xs.s, rows, min(kQ, a.P - p0), kQ, w_s, a.vec_x, tid);
    }
    __syncthreads();
    if constexpr (kMma<T>) {
      // s_c^T rows p0 + 16 warp .. + 16: A = (x w)^T from [j][p] rows through
      // .trans, B = B from [j][n] rows through .trans, k over the chunk
      const int at_off = b_offset(lane, ldx), bt_off = bt_offset(lane, ldb);
      for (int n0 = 0; n0 < npad; n0 += 64) {
        float acc[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kQ / 16; ++kk) {
          uint32_t af[4], afl[4];
          ldsm_x4_t(af, sx + kk * 16 * ldx + at_off + warp * 16);
          ldsm_x4_t(afl, sxl + kk * 16 * ldx + at_off + warp * 16);
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            if (n0 + np * 16 >= npad) break;
            uint32_t bf[4];
            ldsm_x4_t(bf, sb + kk * 16 * ldb + bt_off + n0 + np * 16);
            mma_bf16(acc[2 * np], af, bf[0], bf[1]);
            mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
            mma_bf16(acc[2 * np], afl, bf[0], bf[1]);
            mma_bf16(acc[2 * np + 1], afl, bf[2], bf[3]);
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int p = p0 + warp * 16 + g + 8 * r;
          if (p >= a.P) continue;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int n = n0 + j * 8 + 2 * t;
            if (a.N % 2 == 0) {
              if (n < a.N)
                *reinterpret_cast<float2*>(out + p * a.N + n) =
                    make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
            } else {
              if (n < a.N) out[p * a.N + n] = acc[j][2 * r];
              if (n + 1 < a.N) out[p * a.N + n + 1] = acc[j][2 * r + 1];
            }
          }
        }
      }
    } else {
      // thread (ty, tx): p rows ty + 8 i of a 32-row half, n columns tx + 16 k
      // of a 64-column block
      const int ty = tid >> 4, tx = tid & 15;
      for (int blk = 0; blk < 2 * ((npad + 63) / 64); ++blk) {
        const int ph = (blk & 1) * 32, n0 = (blk >> 1) * 64;
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[i][k] = 0.f;
        for (int j = 0; j < kQ; ++j) {
          float xv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) xv[i] = sx[j * ldx + ph + ty + 8 * i];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int n = n0 + tx + 16 * k;
            bv[k] = n < npad ? sb[j * ldb + n] : 0.f;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[i][k] = fmaf(xv[i], bv[k], acc[i][k]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int p = p0 + ph + ty + 8 * i;
          if (p >= a.P) continue;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int n = n0 + tx + 16 * k;
            if (n < a.N) out[p * a.N + n] = acc[i][k];
          }
        }
      }
    }
  }
}

// ---- 2. the state pass over the chunks -------------------------------------

// kE consecutive f32 values at p (kE = 4: one 16-byte access)
template <int kE>
__device__ __forceinline__ void load_e(float (&v)[kE], const float* p) {
  if constexpr (kE == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < kE; ++k) v[k] = p[k];
  }
}

template <int kE>
__device__ __forceinline__ void store_e(float* p, const float (&v)[kE]) {
  if constexpr (kE == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < kE; ++k) p[k] = v[k];
  }
}

template <int kE>
__device__ __forceinline__ void store_e(bf16* p, const float (&v)[kE]) {
  if constexpr (kE == 4) {
    uint2 q;
    q.x = pack_bf16(v[0], v[1]);
    q.y = pack_bf16(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) = q;
  } else {
#pragma unroll
    for (int k = 0; k < kE; ++k) p[k] = __float2bfloat16_rn(v[k]);
  }
}

// kE neighbouring (p, n) elements a thread: 4 where N % 4 == 0, else 1.
// Forwards (the scan): from the initial state (init), each chunk's incoming
// state over its s_c, final_state the last outgoing one. In reverse (the
// backward): from the final state's gradient (init), each chunk's outgoing
// state gradient G_out over its sum_i exp(cum_i) dy_i (x) C_i, walking the
// chunks from the last, G_in = exp(total) G_out + that sum; final_state
// takes the first chunk's G_in, the initial state's gradient.
template <int kE, bool kRev>
__global__ void __launch_bounds__(kPassThreads)
ssd_state_pass_kernel(Args a) {
  const int64_t pn = static_cast<int64_t>(a.P) * a.N;
  const int64_t e = (static_cast<int64_t>(blockIdx.x) * kPassThreads + threadIdx.x) * kE;
  if (e >= pn) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const int64_t bh = static_cast<int64_t>(b) * a.H + h;
  float st[kE];
  if (a.init != nullptr) {
    load_e<kE>(st, a.init + bh * pn + e);
  } else {
#pragma unroll
    for (int k = 0; k < kE; ++k) st[k] = 0.f;
  }
  const float* tot = a.total + bh * a.nc;
  const int64_t at = static_cast<int64_t>(b) * a.nc * a.H * pn + h * pn + e;
  float* w = a.ws + at;
  bf16* w_in = a.ws_in != nullptr ? a.ws_in + at : nullptr;
  const int64_t cstride = static_cast<int64_t>(a.H) * pn;
  constexpr int kBatch = 8;
  for (int k0 = 0; k0 < a.nc; k0 += kBatch) {
    float s[kBatch][kE];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int c = kRev ? a.nc - 1 - (k0 + k) : k0 + k;
      if (k0 + k < a.nc) load_e<kE>(s[k], w + c * cstride);
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (k0 + k < a.nc) {
        const int c = kRev ? a.nc - 1 - (k0 + k) : k0 + k;
        if (w_in != nullptr)
          store_e<kE>(w_in + c * cstride, st);
        else
          store_e<kE>(w + c * cstride, st);
        const float decay = expf(tot[c]);
#pragma unroll
        for (int q = 0; q < kE; ++q) st[q] = fmaf(decay, st[q], s[k][q]);
      }
  }
  store_e<kE>(a.final_state + bh * pn + e, st);
}

// ---- 3. each chunk's output -------------------------------------------------

// bf16, kHB heads of one group a block: C and B are staged once for all of
// them (with each head's first state and x tiles, in one round trip), and
// each head takes its own C B^T from them, scores and y.
template <int kHB>
__device__ __forceinline__ void output_mma(const Args& a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int npad = round16(a.N);
  const int ldn = tile_ld<bf16>(npad), ldx = tile_ld<bf16>(kQ);
  float* dt_s = reinterpret_cast<float*>(smem_raw);  // kHB x kQ
  float* cum_s = dt_s + kHB * kQ;                     // kHB x kQ
  bf16* sc = reinterpret_cast<bf16*>(cum_s + kHB * kQ);  // kQ x ldn: C
  bf16* sb = sc + kQ * ldn;                              // kQ x ldn: B
  bf16* sx = sb + kQ * ldn;                              // kHB x kQ x ldx: a P tile of x
  bf16* sst = sx + kHB * kQ * ldx;                       // kHB x kQ x ldn: a tile of the state

  const int c = blockIdx.x, h0 = blockIdx.y * kHB, b = blockIdx.z;
  const int c0 = c * kQ, rows = min(kQ, a.S - c0);
  const int grp = h0 / (a.H / a.G);
  const int tid = threadIdx.x;
  const bf16* bb = static_cast<const bf16*>(a.bm) + b * a.bs.b + grp * a.bs.h + c0 * a.bs.s;
  const bf16* cb = static_cast<const bf16*>(a.cm) + b * a.cs.b + grp * a.cs.h + c0 * a.cs.s;
  auto x_of = [&](int hh) {
    return static_cast<const bf16*>(a.x) + b * a.xs.b + (h0 + hh) * a.xs.h + c0 * a.xs.s;
  };
  auto state_of = [&](int hh) {  // chunk c's incoming state, rounded to bf16
    return a.ws_in + ((static_cast<int64_t>(b) * a.nc + c) * a.H + h0 + hh) * a.P * a.N;
  };

  stage_copy(sc, ldn, cb, a.cs.s, rows, a.N, npad, a.vec_bc, tid);
  stage_copy(sb, ldn, bb, a.bs.s, rows, a.N, npad, a.vec_bc, tid);
#pragma unroll
  for (int hh = 0; hh < kHB; ++hh) {
    stage_copy(sst + hh * kQ * ldn, ldn, state_of(hh), a.N, min(kQ, a.P), a.N, npad, a.vec_ws, tid);
    stage_copy(sx + hh * kQ * ldx, ldx, x_of(hh), a.xs.s, rows, min(kQ, a.P), kQ, a.vec_x, tid);
  }
  cp_async_commit();
  if (tid < kHB * kQ) {  // warps 0-1 scan head h0's dt, warps 2-3 head h0 + 1's
    const int hh = tid / kQ;
    chunk_dt(dt_s + hh * kQ, cum_s + hh * kQ, a.dt, a.dts, b, h0 + hh, c0, a.S, a.A[h0 + hh],
             tid - hh * kQ);
  }
  cp_async_wait<0>();
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int a_off = a_offset(lane, ldn), b_off = b_offset(lane, ldn), bt_off = bt_offset(lane, ldx);
  for (int hh = 0; hh < kHB; ++hh) {
    const float* hdt = dt_s + hh * kQ;
    const float* hcum = cum_s + hh * kQ;
    bf16* hx = sx + hh * kQ * ldx;
    bf16* hst = sst + hh * kQ * ldn;
    // C B^T: rows 16 warp .. + 16, keys 16 np .. + 16 for np <= warp
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    for (int kk = 0; kk < npad / 16; ++kk) {
      uint32_t af[4];
      ldsm_x4(af, sc + warp * 16 * ldn + a_off + kk * 16);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (np > warp) break;
        uint32_t bf[4];
        ldsm_x4(bf, sb + np * 16 * ldn + b_off + kk * 16);
        mma_bf16(s[2 * np], af, bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], af, bf[2], bf[3]);
      }
    }
    // scores = C B^T o exp(cum_i - cum_j) dt_j on and below the diagonal
    float cum_r[2], ecum[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      cum_r[r] = cum_at(hcum, warp * 16 + g + 8 * r);
      ecum[r] = expf(cum_r[r]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = warp * 16 + g + 8 * (e >> 1), jj = j * 8 + 2 * t + (e & 1);
        s[j][e] = jj <= i ? s[j][e] * expf(cum_r[e >> 1] - cum_at(hcum, jj)) * hdt[jj] : 0.f;
      }
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a(pa[kk], s[2 * kk], s[2 * kk + 1]);

    bf16* yb = static_cast<bf16*>(a.y) + b * a.ys.b + (h0 + hh) * a.ys.h + c0 * a.ys.s;
    for (int p0 = 0; p0 < a.P; p0 += kQ) {
      if (p0 > 0) {  // the first tiles came with C and B
        __syncthreads();  // the last state and x tiles read by everyone
        stage_copy(hst, ldn, state_of(hh) + p0 * a.N, a.N, min(kQ, a.P - p0), a.N, npad,
                   a.vec_ws, tid);
        stage_copy(hx, ldx, x_of(hh) + p0, a.xs.s, rows, min(kQ, a.P - p0), kQ, a.vec_x, tid);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
      }
      float yd[8][4], yo[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) yd[j][e] = yo[j][e] = 0.f;
      // y_diag = scores x
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk > warp) break;
#pragma unroll
        for (int dp = 0; dp < 4; ++dp) {
          uint32_t bf[4];
          ldsm_x4_t(bf, hx + kk * 16 * ldx + bt_off + dp * 16);
          mma_bf16(yd[2 * dp], pa[kk], bf[0], bf[1]);
          mma_bf16(yd[2 * dp + 1], pa[kk], bf[2], bf[3]);
        }
      }
      // y_off = C state^T: the state tile's rows are p, its columns n
      for (int kk = 0; kk < npad / 16; ++kk) {
        uint32_t af[4];
        ldsm_x4(af, sc + warp * 16 * ldn + a_off + kk * 16);
#pragma unroll
        for (int dp = 0; dp < 4; ++dp) {
          uint32_t bf[4];
          ldsm_x4(bf, hst + dp * 16 * ldn + b_off + kk * 16);
          mma_bf16(yo[2 * dp], af, bf[0], bf[1]);
          mma_bf16(yo[2 * dp + 1], af, bf[2], bf[3]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = warp * 16 + g + 8 * r;
        if (i >= rows) continue;
        bf16* yrow = yb + i * a.ys.s;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int p = p0 + j * 8 + 2 * t;
          const float v0 = fmaf(ecum[r], yo[j][2 * r], yd[j][2 * r]);
          const float v1 = fmaf(ecum[r], yo[j][2 * r + 1], yd[j][2 * r + 1]);
          if (a.pair_y) {
            if (p < a.P) *reinterpret_cast<__nv_bfloat162*>(yrow + p) = __floats2bfloat162_rn(v0, v1);
          } else {
            if (p < a.P) yrow[p] = cast<bf16>(v0);
            if (p + 1 < a.P) yrow[p + 1] = cast<bf16>(v1);
          }
        }
      }
    }
  }
}

// f32, one head a block, scalar FMAs on f32 tiles.
__device__ __forceinline__ void output_fma(const Args& a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int npad = round16(a.N);
  const int ldn = tile_ld<float>(npad), ldx = kQ;
  constexpr int ldsc = kQ + 1;
  float* dt_s = reinterpret_cast<float*>(smem_raw);
  float* cum_s = dt_s + kQ;
  float* sc = cum_s + kQ;         // kQ x ldn: C
  float* sbs = sc + kQ * ldn;     // kQ x ldn: B, then a tile of the state
  float* sx = sbs + kQ * ldn;     // kQ x ldx: a P tile of x
  float* ssc = sx + kQ * ldx;     // kQ x ldsc: the scores

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int c0 = c * kQ, rows = min(kQ, a.S - c0);
  const int grp = h / (a.H / a.G);
  const int tid = threadIdx.x;
  const float* xb = static_cast<const float*>(a.x) + b * a.xs.b + h * a.xs.h + c0 * a.xs.s;
  const float* bb = static_cast<const float*>(a.bm) + b * a.bs.b + grp * a.bs.h + c0 * a.bs.s;
  const float* cb = static_cast<const float*>(a.cm) + b * a.cs.b + grp * a.cs.h + c0 * a.cs.s;
  float* yb = static_cast<float*>(a.y) + b * a.ys.b + h * a.ys.h + c0 * a.ys.s;
  // chunk c's incoming state
  const float* st_in = a.ws + ((static_cast<int64_t>(b) * a.nc + c) * a.H + h) * a.P * a.N;

  stage<float, float>(sc, ldn, cb, a.cs.s, rows, a.N, npad, nullptr, a.vec_bc, tid);
  stage<float, float>(sbs, ldn, bb, a.bs.s, rows, a.N, npad, nullptr, a.vec_bc, tid);
  chunk_dt(dt_s, cum_s, a.dt, a.dts, b, h, c0, a.S, a.A[h], tid);
  __syncthreads();

  // thread (ty, tx): rows ty + 8 i, columns tx + 16 k (keys, then P)
  const int ty = tid >> 4, tx = tid & 15;
  {
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][k] = 0.f;
    for (int n = 0; n < a.N; ++n) {
      float cv[8], bv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) cv[i] = sc[(ty + 8 * i) * ldn + n];
#pragma unroll
      for (int k = 0; k < 4; ++k) bv[k] = sbs[(tx + 16 * k) * ldn + n];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][k] = fmaf(cv[i], bv[k], acc[i][k]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty + 8 * i;
      const float cr = cum_at(cum_s, r);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = tx + 16 * k;
        ssc[r * ldsc + j] = j <= r ? acc[i][k] * expf(cr - cum_at(cum_s, j)) * dt_s[j] : 0.f;
      }
    }
  }
  for (int p0 = 0; p0 < a.P; p0 += kQ) {
    __syncthreads();  // scores complete; B (or the last state tile) and x read by everyone
    stage<float, float>(sbs, ldn, st_in + p0 * a.N, a.N, min(kQ, a.P - p0), a.N, npad, nullptr,
                        a.vec_ws, tid);
    stage<float, float>(sx, ldx, xb + p0, a.xs.s, rows, min(kQ, a.P - p0), kQ, nullptr, a.vec_x,
                        tid);
    __syncthreads();
    float yd[8][4], yo[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) yd[i][k] = yo[i][k] = 0.f;
    for (int j = 0; j < kQ; ++j) {
      float sv[8], xv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) sv[i] = ssc[(ty + 8 * i) * ldsc + j];
#pragma unroll
      for (int k = 0; k < 4; ++k) xv[k] = sx[j * ldx + tx + 16 * k];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) yd[i][k] = fmaf(sv[i], xv[k], yd[i][k]);
    }
    for (int n = 0; n < a.N; ++n) {
      float cv[8], sv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) cv[i] = sc[(ty + 8 * i) * ldn + n];
#pragma unroll
      for (int k = 0; k < 4; ++k) sv[k] = sbs[(tx + 16 * k) * ldn + n];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) yo[i][k] = fmaf(cv[i], sv[k], yo[i][k]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty + 8 * i;
      if (r >= rows) continue;
      const float ec = expf(cum_at(cum_s, r));
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int p = p0 + tx + 16 * k;
        if (p < a.P) yb[r * a.ys.s + p] = fmaf(ec, yo[i][k], yd[i][k]);
      }
    }
  }
}

// kHB heads a block (bf16 only; f32 takes one)
template <typename T, int kHB>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_output_kernel(Args a) {
  if constexpr (kMma<T>)
    output_mma<kHB>(a);
  else
    output_fma(a);
}

template <typename T>
size_t state_smem(int N) {
  using Tile = typename std::conditional<kMma<T>, bf16, float>::type;
  const int ldb = tile_ld<T>(round16(N)), ldx = kMma<T> ? tile_ld<T>(kQ) : kQ;
  return 3 * kQ * sizeof(float) +
         static_cast<size_t>(kQ) * (ldb + (kMma<T> ? 3 : 1) * ldx) * sizeof(Tile);
}

template <typename T>
size_t output_smem(int N, int hb) {
  const int npad = round16(N);
  if constexpr (kMma<T>) {  // dt and cum, C, B, and per head an x tile and a state tile
    const int ldn = tile_ld<T>(npad), ldx = tile_ld<T>(kQ);
    return 2 * hb * kQ * sizeof(float) +
           static_cast<size_t>(kQ) * ((2 + hb) * ldn + hb * ldx) * sizeof(bf16);
  } else {  // dt and cum, C, B (then a state tile), an x tile, the scores
    const int ldn = tile_ld<T>(npad);
    return 2 * kQ * sizeof(float) +
           static_cast<size_t>(kQ) * (2 * ldn + kQ + kQ + 1) * sizeof(float);
  }
}

template <typename T, int kHB>
int launch_output(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = output_smem<T>(a.N, kHB);
  const cudaError_t err = cudaFuncSetAttribute(ssd_chunk_output_kernel<T, kHB>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_output_kernel<T, kHB><<<dim3(a.nc, a.H / kHB, B), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The chunk-state kernel, then the pass (forwards, or in reverse for the
// backward's state gradients)
template <typename T, bool kRev>
int launch_states(const Args& a, int B, cudaStream_t stream) {
  const size_t smem1 = state_smem<T>(a.N);
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_state_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem1));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_state_kernel<T><<<dim3(a.nc, a.H, B), kThreads, smem1, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-byte accesses where every (p, n) row starts 16-byte aligned
  const int64_t pn = static_cast<int64_t>(a.P) * a.N;
  const int64_t per_block = static_cast<int64_t>(kPassThreads) * (a.N % 4 == 0 ? 4 : 1);
  const dim3 pass(static_cast<unsigned>((pn + per_block - 1) / per_block), a.H, B);
  if (a.N % 4 == 0)
    ssd_state_pass_kernel<4, kRev><<<pass, kPassThreads, 0, stream>>>(a);
  else
    ssd_state_pass_kernel<1, kRev><<<pass, kPassThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const Args& a, int B, cudaStream_t stream) {
  const int err = launch_states<T, false>(a, B, stream);
  if (err != 0) return err;
  // bf16: two heads of a group a block where the group's size is even and
  // the blocks would still fill every SM twice over; fewer blocks, each with
  // twice the serial work, are slower at mamba2's 264 and faster at
  // zamba2's 704 (one wave instead of two)
  if constexpr (kMma<T>) {
    static int sms = 0;
    if (sms == 0) {
      int dev = 0;
      if (cudaGetDevice(&dev) != cudaSuccess ||
          cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
        sms = 132;
    }
    if ((a.H / a.G) % 2 == 0 && static_cast<int64_t>(a.nc) * (a.H / 2) * B >= 2 * sms)
      return launch_output<T, 2>(a, B, stream);
  }
  return launch_output<T, 1>(a, B, stream);
}

// ---- 4. the backward within each chunk ---------------------------------------

constexpr int kBwdThreads = 256;  // 16 x 16 threads, each 4 x 4 of a 64 x 64 tile
constexpr int kT = 64;            // a tile's columns (P or N)
constexpr int kLd = kT + 1;       // f32 row stride: column walks hit distinct banks
constexpr int kReduceThreads = 256;

struct BwdArgs {
  const void* x;
  const void* bm;
  const void* cm;
  const void* dy;
  const float* dt;
  const float* A;
  const float* s_in;   // (B, nc, H, P, N): chunk c's incoming state
  const float* g_out;  // (B, nc, H, P, N): the gradient of chunk c's outgoing state
  void* dx;            // (B, S, H, P), x's dtype
  float* ddt;          // (B, S, H)
  float* db_part;      // (B, S, H, N): dB per head
  float* dc_part;      // (B, S, H, N): dC per head
  float* da_part;      // (B, nc, H): dA per chunk and head
  void* db;            // (B, S, G, N), x's dtype
  void* dc;
  float* da;           // (H,)
  int B, S, H, G, P, N, nc;
  Strides xs, dts, bs, cs, dys;
  bool vec_x, vec_dy, vec_bc;  // bf16: 16-byte copies allowed
};

// The chunk's last stage, over its kQ positions (threads 0 to kQ - 1; every
// thread of the block calls it, after the `parts` partial sums of
// <G_out, S_in> are in red): dcum (ref.py's docstring) at every position,
// its suffix sum da within the chunk, ddt at every position and the chunk's
// share of dA. Sums by shuffle trees and in-order two-warp combines through
// xch (8 floats past red): equal inputs give equal bits.
__device__ __forceinline__ void bwd_tail(const BwdArgs& a, const float* dt_s, const float* cum_s,
                                         const float* w_s, const float* rowT, const float* colE,
                                         const float* u_s, const float* v_s, float* red, int parts,
                                         int rows, int64_t row0, float a_h, int tid) {
  float* xch = red + parts;
  const int i = tid, lane = tid & 31, warp = tid >> 5;
  const bool mine = tid < kQ;
  auto tree = [](float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
  };
  float g = 0.f, wu = 0.f, da = 0.f, ci = 0.f;
  if (mine) {
    for (int k = lane; k < parts; k += 32) g += red[k];
    g = tree(g);  // <G_out, S_in>, the same in both warps
    wu = tree(w_s[i] * u_s[i]);
    if (lane == 0) xch[warp] = wu;
  }
  __syncthreads();
  const float total = cum_s[31] + cum_s[kQ - 1];
  if (mine) {
    wu = xch[0] + xch[1];
    ci = cum_at(cum_s, i);
    float dcum = rowT[i] - dt_s[i] * colE[i] + expf(ci) * v_s[i] - w_s[i] * u_s[i];
    // <G_out, S_out> enters at the chunk's last position (total = its cum)
    if (i == kQ - 1) dcum += wu + expf(total) * g;
    da = dcum;  // the suffix sum of dcum: the gradient of a_i = dt_i A
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_down_sync(0xffffffffu, da, off);
      if (lane + off < 32) da += o;
    }
    if (warp == 1 && lane == 0) xch[2] = da;
  }
  __syncthreads();
  if (mine) {
    if (warp == 0) da += xch[2];
    if (i < rows)
      a.ddt[row0 + static_cast<int64_t>(i) * a.H] = colE[i] + expf(total - ci) * u_s[i] + a_h * da;
    const float dah = tree(dt_s[i] * da);
    if (lane == 0) xch[4 + warp] = dah;
  }
  __syncthreads();
  if (tid == 0)
    a.da_part[(static_cast<int64_t>(blockIdx.z) * a.nc + blockIdx.x) * a.H + blockIdx.y] =
        xch[4] + xch[5];
}

// A kQ x kT f32 tile: element (r, c) is src[r * rs + c] for r < rows and
// c < cols, else 0
template <typename T>
__device__ __forceinline__ void stage_f32(float* __restrict__ tile, const T* __restrict__ src,
                                          int64_t rs, int rows, int cols, int tid) {
#pragma unroll 4
  for (int i = tid; i < kQ * kT; i += kBwdThreads) {
    const int r = i / kT, c = i - r * kT;
    tile[r * kLd + c] = r < rows && c < cols ? repro::to_f32(src[r * rs + c]) : 0.f;
  }
}

// acc[r][k] += sum_{q < K} a[(ty + 16 r) * ars + q * acs] * b[q * brs + (tx + 16 k) * bcs]:
// one thread's 4 x 4 of a 64 x 64 product of shared-memory operands
__device__ __forceinline__ void mm(float (&acc)[4][4], const float* __restrict__ a, int ars,
                                   int acs, const float* __restrict__ b, int brs, int bcs, int K,
                                   int ty, int tx) {
#pragma unroll 4
  for (int q = 0; q < K; ++q) {
    float av[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) av[r] = a[(ty + 16 * r) * ars + q * acs];
#pragma unroll
    for (int k = 0; k < 4; ++k) bv[k] = b[q * brs + (tx + 16 * k) * bcs];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[r][k] = fmaf(av[r], bv[k], acc[r][k]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[r][k] = 0.f;
}

// f32: one block per (chunk, head, batch), scalar f32 FMAs on f32 tiles.
// With L_ij = exp(cum_i - cum_j) on and below the diagonal:
//   Sx = C B^T o L o dt_j, Sb = dy x^T o L o dt_j, E = (dy x^T) o (C B^T) o L
//   dx = Sx^T dy + diag(w) B G_out^T
//   dB = Sb^T C + diag(w) x G_out       (this head's share)
//   dC = Sb B + diag(exp(cum)) dy S_in  (this head's share)
// and ddt, this chunk's share of dA from dcum (ref.py's docstring; bwd_tail).
__device__ __forceinline__ void bwd_fma(const BwdArgs& a) {
  using T = float;
  extern __shared__ __align__(16) float bsm[];
  float* dt_s = bsm;           // kQ
  float* cum_s = dt_s + kQ;    // kQ: warp-wise running sums (cum_at)
  float* w_s = cum_s + kQ;     // kQ: dt_j exp(total - cum_j)
  float* rowT = w_s + kQ;      // kQ: sum_j E_ij dt_j
  float* colE = rowT + kQ;     // kQ: sum_i E_ij
  float* u_s = colE + kQ;      // kQ: x_j^T G_out B_j
  float* v_s = u_s + kQ;       // kQ: dy_i^T S_in C_i
  float* red = v_s + kQ;       // kBwdThreads + 8: partial sums of <G_out, S_in>; bwd_tail's
  float* sx = red + kBwdThreads + 8;  // kQ x kLd: C B^T, then Sx
  float* sb = sx + kQ * kLd;      // kQ x kLd: Sb
  float* se = sb + kQ * kLd;      // kQ x kLd: E
  float* t_b = se + kQ * kLd;      // kQ x kLd tiles: B, C, x, dy, G_out, S_in
  float* t_c = t_b + kQ * kLd;
  float* t_x = t_c + kQ * kLd;
  float* t_dy = t_x + kQ * kLd;
  float* t_g = t_dy + kQ * kLd;
  float* t_s = t_g + kQ * kLd;

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int c0 = c * kQ, rows = min(kQ, a.S - c0);
  const int grp = h / (a.H / a.G);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const T* xb = static_cast<const T*>(a.x) + b * a.xs.b + h * a.xs.h + c0 * a.xs.s;
  const T* dyb = static_cast<const T*>(a.dy) + b * a.dys.b + h * a.dys.h + c0 * a.dys.s;
  const T* bb = static_cast<const T*>(a.bm) + b * a.bs.b + grp * a.bs.h + c0 * a.bs.s;
  const T* cb = static_cast<const T*>(a.cm) + b * a.cs.b + grp * a.cs.h + c0 * a.cs.s;
  const int64_t pn = static_cast<int64_t>(a.P) * a.N;
  const int64_t at = ((static_cast<int64_t>(b) * a.nc + c) * a.H + h) * pn;
  const float* sin_c = a.s_in + at;
  const float* gout_c = a.g_out + at;
  const float a_h = a.A[h];
  // rows of the per-position outputs: (b, c0 + i, h)
  const int64_t row0 = (static_cast<int64_t>(b) * a.S + c0) * a.H + h;

  chunk_dt(dt_s, cum_s, a.dt, a.dts, b, h, c0, a.S, a_h, tid);
  if (tid < kQ) u_s[tid] = v_s[tid] = 0.f;
  __syncthreads();
  const float total = cum_s[31] + cum_s[kQ - 1];
  if (tid < kQ) w_s[tid] = dt_s[tid] * expf(total - cum_at(cum_s, tid));

  // C B^T over N tiles, dy x^T over P tiles
  float acc[4][4], m[4][4];
  zero(acc);
  for (int n0 = 0; n0 < a.N; n0 += kT) {
    __syncthreads();
    stage_f32<T>(t_c, cb + n0, a.cs.s, rows, min(kT, a.N - n0), tid);
    stage_f32<T>(t_b, bb + n0, a.bs.s, rows, min(kT, a.N - n0), tid);
    __syncthreads();
    mm(acc, t_c, kLd, 1, t_b, 1, kLd, kT, ty, tx);
  }
  zero(m);
  for (int p0 = 0; p0 < a.P; p0 += kT) {
    __syncthreads();
    stage_f32<T>(t_dy, dyb + p0, a.dys.s, rows, min(kT, a.P - p0), tid);
    stage_f32<T>(t_x, xb + p0, a.xs.s, rows, min(kT, a.P - p0), tid);
    __syncthreads();
    mm(m, t_dy, kLd, 1, t_x, 1, kLd, kT, ty, tx);
  }
  // Sx, Sb and E; above the diagonal 0, the exponent never taken there
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ty + 16 * r;
    const float ci = cum_at(cum_s, i);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = tx + 16 * k;
      float vx = 0.f, vb = 0.f, ve = 0.f;
      if (j <= i) {
        const float l = expf(ci - cum_at(cum_s, j));
        vx = acc[r][k] * l * dt_s[j];
        vb = m[r][k] * l * dt_s[j];
        ve = m[r][k] * acc[r][k] * l;
      }
      sx[i * kLd + j] = vx;
      sb[i * kLd + j] = vb;
      se[i * kLd + j] = ve;
    }
  }
  __syncthreads();
  if (tid < kQ) {
    float sum = 0.f;
    for (int j = 0; j <= tid; ++j) sum = fmaf(se[tid * kLd + j], dt_s[j], sum);
    rowT[tid] = sum;
  } else if (tid < 2 * kQ) {
    const int j = tid - kQ;
    float sum = 0.f;
    for (int i = j; i < kQ; ++i) sum += se[i * kLd + j];
    colE[j] = sum;
  }

  // dx, P tile by P tile: Sx^T dy + w_j (B G_out^T)
  for (int p0 = 0; p0 < a.P; p0 += kT) {
    const int pc = min(kT, a.P - p0);
    __syncthreads();
    stage_f32<T>(t_dy, dyb + p0, a.dys.s, rows, pc, tid);
    __syncthreads();
    float dxa[4][4], gb[4][4];
    zero(dxa);
    zero(gb);
    mm(dxa, sx, 1, kLd, t_dy, kLd, 1, kQ, ty, tx);
    for (int n0 = 0; n0 < a.N; n0 += kT) {
      const int ncol = min(kT, a.N - n0);
      __syncthreads();
      stage_f32<T>(t_b, bb + n0, a.bs.s, rows, ncol, tid);
      stage_f32<float>(t_g, gout_c + p0 * a.N + n0, a.N, pc, ncol, tid);
      __syncthreads();
      mm(gb, t_b, kLd, 1, t_g, 1, kLd, kT, ty, tx);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = ty + 16 * r;
      if (j >= rows) continue;
      T* out = static_cast<T*>(a.dx) + (row0 + static_cast<int64_t>(j) * a.H) * a.P + p0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int p = tx + 16 * k;
        if (p < pc) out[p] = cast<T>(fmaf(w_s[j], gb[r][k], dxa[r][k]));
      }
    }
  }

  // dB and dC, N tile by N tile; u, v and <G_out, S_in> on the way
  float gs = 0.f;
  for (int n0 = 0; n0 < a.N; n0 += kT) {
    const int ncol = min(kT, a.N - n0);
    __syncthreads();
    stage_f32<T>(t_b, bb + n0, a.bs.s, rows, ncol, tid);
    stage_f32<T>(t_c, cb + n0, a.cs.s, rows, ncol, tid);
    __syncthreads();
    float db[4][4], dc[4][4], xg[4][4], dys[4][4];
    zero(db);
    zero(dc);
    zero(xg);
    zero(dys);
    mm(db, sb, 1, kLd, t_c, kLd, 1, kQ, ty, tx);
    mm(dc, sb, kLd, 1, t_b, kLd, 1, kQ, ty, tx);
    for (int p0 = 0; p0 < a.P; p0 += kT) {
      const int pc = min(kT, a.P - p0);
      __syncthreads();
      stage_f32<T>(t_x, xb + p0, a.xs.s, rows, pc, tid);
      stage_f32<T>(t_dy, dyb + p0, a.dys.s, rows, pc, tid);
      stage_f32<float>(t_g, gout_c + p0 * a.N + n0, a.N, pc, ncol, tid);
      stage_f32<float>(t_s, sin_c + p0 * a.N + n0, a.N, pc, ncol, tid);
      __syncthreads();
      mm(xg, t_x, kLd, 1, t_g, kLd, 1, kT, ty, tx);
      mm(dys, t_dy, kLd, 1, t_s, kLd, 1, kT, ty, tx);
      for (int i = tid; i < kT * kT; i += kBwdThreads) {
        const int r = i / kT, cc = i - r * kT;
        gs = fmaf(t_g[r * kLd + cc], t_s[r * kLd + cc], gs);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = ty + 16 * r;
      float uu = 0.f, vv = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        uu = fmaf(t_b[j * kLd + tx + 16 * k], xg[r][k], uu);
        vv = fmaf(t_c[j * kLd + tx + 16 * k], dys[r][k], vv);
      }
      // over the 16 threads of the row (one half warp), then in N-tile order
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        uu += __shfl_xor_sync(0xffffffffu, uu, off);
        vv += __shfl_xor_sync(0xffffffffu, vv, off);
      }
      if (tx == 0) {
        u_s[j] += uu;
        v_s[j] += vv;
      }
      if (j >= rows) continue;
      const float wj = w_s[j], ej = expf(cum_at(cum_s, j));
      float* dbo = a.db_part + (row0 + static_cast<int64_t>(j) * a.H) * a.N + n0;
      float* dco = a.dc_part + (row0 + static_cast<int64_t>(j) * a.H) * a.N + n0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int n = tx + 16 * k;
        if (n < ncol) {
          dbo[n] = fmaf(wj, xg[r][k], db[r][k]);
          dco[n] = fmaf(ej, dys[r][k], dc[r][k]);
        }
      }
    }
  }

  red[tid] = gs;
  __syncthreads();
  bwd_tail(a, dt_s, cum_s, w_s, rowT, colE, u_s, v_s, red, kBwdThreads, rows, row0, a_h, tid);
}

// A kQ x kQ tile of the f32 state (or state gradient) at rows p0.., columns
// n0.. of its (P, N) rows, rounded to bf16 (zeros outside); with tile2 and
// src2 (the matching tile of the second state), also that tile and the f32
// sum of the two tiles' products into dot, in a fixed order per thread.
// With vec (N % 4 == 0), 16-byte loads, four a tensor issued before any is
// used; else element loads.
__device__ __forceinline__ void stage_state(bf16* __restrict__ tile, const float* __restrict__ src,
                                            bf16* __restrict__ tile2, const float* __restrict__ src2,
                                            int p0, int n0, int P, int N, bool vec, float& dot,
                                            int tid) {
  constexpr int ld = kQ + 8;
  if (vec) {
    constexpr int kRow = kQ / 4, kPer = kQ * kRow / kThreads, kInFlight = 4;
    for (int k0 = 0; k0 < kPer; k0 += kInFlight) {
      float4 v[kInFlight], v2[kInFlight];
#pragma unroll
      for (int k = 0; k < kInFlight; ++k) {
        const int i = tid + (k0 + k) * kThreads, r = i / kRow, cc = (i - r * kRow) * 4;
        const bool ok = p0 + r < P && n0 + cc < N;
        const int64_t off = static_cast<int64_t>(p0 + r) * N + n0 + cc;
        v[k] = v2[k] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (ok) v[k] = *reinterpret_cast<const float4*>(src + off);
        if (ok && tile2 != nullptr) v2[k] = *reinterpret_cast<const float4*>(src2 + off);
      }
#pragma unroll
      for (int k = 0; k < kInFlight; ++k) {
        const int i = tid + (k0 + k) * kThreads, r = i / kRow, cc = (i - r * kRow) * 4;
        *reinterpret_cast<uint2*>(tile + r * ld + cc) =
            make_uint2(pack_bf16(v[k].x, v[k].y), pack_bf16(v[k].z, v[k].w));
        if (tile2 != nullptr) {
          *reinterpret_cast<uint2*>(tile2 + r * ld + cc) =
              make_uint2(pack_bf16(v2[k].x, v2[k].y), pack_bf16(v2[k].z, v2[k].w));
          dot = fmaf(v[k].x, v2[k].x, dot);
          dot = fmaf(v[k].y, v2[k].y, dot);
          dot = fmaf(v[k].z, v2[k].z, dot);
          dot = fmaf(v[k].w, v2[k].w, dot);
        }
      }
    }
    return;
  }
  for (int i = tid; i < kQ * kQ; i += kThreads) {
    const int r = i / kQ, cc = i - r * kQ, p = p0 + r, n = n0 + cc;
    const bool ok = p < P && n < N;
    const float v = ok ? src[static_cast<int64_t>(p) * N + n] : 0.f;
    tile[r * ld + cc] = __float2bfloat16_rn(v);
    if (tile2 != nullptr) {
      const float v2 = ok ? src2[static_cast<int64_t>(p) * N + n] : 0.f;
      tile2[r * ld + cc] = __float2bfloat16_rn(v2);
      dot = fmaf(v, v2, dot);
    }
  }
}

// bf16: the same products on the tensor cores (mma.sync.m16n8k16, bf16
// operands from ldmatrix, f32 accumulators), 4 warps of 16 rows. C B^T and
// dy x^T over the chunk's lower triangle; Sx and Sb rounded to bf16 into
// shared memory (their transposes are the A operands of dx and dB), Sb also
// kept in registers as the A operand of dC; G_out and S_in rounded to bf16
// a 64 x 64 tile at a time, each tile staged once (16-byte loads issued four
// at a time: the staging's round trips, not the products, set the kernel's
// time). E, rowT, colE, u and v stay f32. dx is written P tile by P tile, dB
// and dC (each head's share) N block by N block.
__device__ __forceinline__ void bwd_mma(const BwdArgs& a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int npad = round16(a.N);
  const int ldn = tile_ld<bf16>(npad), ldt = tile_ld<bf16>(kQ);
  float* dt_s = reinterpret_cast<float*>(smem_raw);
  float* cum_s = dt_s + kQ;
  float* w_s = cum_s + kQ;       // dt_j exp(total - cum_j)
  float* rowT = w_s + kQ;        // sum_j E_ij dt_j
  float* colE = rowT + kQ;       // sum_i E_ij
  float* u_s = colE + kQ;        // x_j^T G_out B_j
  float* v_s = u_s + kQ;         // dy_i^T S_in C_i
  float* colp = v_s + kQ;        // 4 x kQ: each warp's column sums of E
  float* red = colp + 4 * kQ;    // kThreads + 8: partial sums of <G_out, S_in>; bwd_tail's
  bf16* sc = reinterpret_cast<bf16*>(red + kThreads + 8);  // kQ x ldn: C
  bf16* sb = sc + kQ * ldn;                            // kQ x ldn: B
  bf16* sx = sb + kQ * ldn;                            // kQ x ldt: a P tile of x
  bf16* sdy = sx + kQ * ldt;                           // kQ x ldt: the P tile of dy
  bf16* ssx = sdy + kQ * ldt;                          // kQ x ldt: Sx [i][j]
  bf16* ssb = ssx + kQ * ldt;                          // kQ x ldt: Sb [i][j]
  bf16* sg = ssb + kQ * ldt;                           // kQ x ldt: G_out [p][n], one tile
  bf16* ss = sg + kQ * ldt;                            // kQ x ldt: S_in [p][n], one tile

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int c0 = c * kQ, rows = min(kQ, a.S - c0);
  const int grp = h / (a.H / a.G);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const bf16* xb = static_cast<const bf16*>(a.x) + b * a.xs.b + h * a.xs.h + c0 * a.xs.s;
  const bf16* dyb = static_cast<const bf16*>(a.dy) + b * a.dys.b + h * a.dys.h + c0 * a.dys.s;
  const bf16* bb = static_cast<const bf16*>(a.bm) + b * a.bs.b + grp * a.bs.h + c0 * a.bs.s;
  const bf16* cb = static_cast<const bf16*>(a.cm) + b * a.cs.b + grp * a.cs.h + c0 * a.cs.s;
  const int64_t at = ((static_cast<int64_t>(b) * a.nc + c) * a.H + h) * a.P * a.N;
  const float* sin_c = a.s_in + at;
  const float* gout_c = a.g_out + at;
  const float a_h = a.A[h];
  const int64_t row0 = (static_cast<int64_t>(b) * a.S + c0) * a.H + h;
  const bool vec_st = a.N % 4 == 0;  // the states' rows start 16-byte aligned

  stage_copy(sc, ldn, cb, a.cs.s, rows, a.N, npad, a.vec_bc, tid);
  stage_copy(sb, ldn, bb, a.bs.s, rows, a.N, npad, a.vec_bc, tid);
  stage_copy(sx, ldt, xb, a.xs.s, rows, min(kQ, a.P), kQ, a.vec_x, tid);
  stage_copy(sdy, ldt, dyb, a.dys.s, rows, min(kQ, a.P), kQ, a.vec_dy, tid);
  cp_async_commit();
  chunk_dt(dt_s, cum_s, a.dt, a.dts, b, h, c0, a.S, a_h, tid);
  if (tid < kQ) u_s[tid] = v_s[tid] = 0.f;
  cp_async_wait<0>();
  __syncthreads();
  const float total = cum_s[31] + cum_s[kQ - 1];
  if (tid < kQ) w_s[tid] = dt_s[tid] * expf(total - cum_at(cum_s, tid));
  int staged = 0;  // the P tile of x and dy in shared memory
  auto stage_p = [&](int p0) {
    if (p0 == staged) return;
    __syncthreads();  // the last tiles read by everyone
    stage_copy(sx, ldt, xb + p0, a.xs.s, rows, min(kQ, a.P - p0), kQ, a.vec_x, tid);
    stage_copy(sdy, ldt, dyb + p0, a.dys.s, rows, min(kQ, a.P - p0), kQ, a.vec_dy, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    staged = p0;
  };

  const int a_n = a_offset(lane, ldn), b_n = b_offset(lane, ldn), bt_n = bt_offset(lane, ldn);
  const int a_t = a_offset(lane, ldt), b_t = b_offset(lane, ldt), bt_t = bt_offset(lane, ldt);
  // C B^T and dy x^T: rows 16 warp .. + 16, keys 16 np .. + 16 for np <= warp
  float cbv[8][4], mv[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) cbv[j][e] = mv[j][e] = 0.f;
  for (int kk = 0; kk < npad / 16; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, sc + warp * 16 * ldn + a_n + kk * 16);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      if (np > warp) break;
      uint32_t bf[4];
      ldsm_x4(bf, sb + np * 16 * ldn + b_n + kk * 16);
      mma_bf16(cbv[2 * np], af, bf[0], bf[1]);
      mma_bf16(cbv[2 * np + 1], af, bf[2], bf[3]);
    }
  }
  for (int p0 = 0; p0 < a.P; p0 += kQ) {
    stage_p(p0);
#pragma unroll
    for (int kk = 0; kk < kQ / 16; ++kk) {
      uint32_t af[4];
      ldsm_x4(af, sdy + warp * 16 * ldt + a_t + kk * 16);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (np > warp) break;
        uint32_t bf[4];
        ldsm_x4(bf, sx + np * 16 * ldt + b_t + kk * 16);
        mma_bf16(mv[2 * np], af, bf[0], bf[1]);
        mma_bf16(mv[2 * np + 1], af, bf[2], bf[3]);
      }
    }
  }
  // Sx = C B^T o L o dt_j (over cbv), Sb = dy x^T o L o dt_j (over mv), E =
  // (dy x^T) o (C B^T) o L; above the diagonal 0, the exponent never taken
  float cum_r[2], ecum[2], rt[2] = {0.f, 0.f}, cs[8][2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    cum_r[r] = cum_at(cum_s, warp * 16 + g + 8 * r);
    ecum[r] = expf(cum_r[r]);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    cs[j][0] = cs[j][1] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = warp * 16 + g + 8 * (e >> 1), jj = j * 8 + 2 * t + (e & 1);
      float vx = 0.f, vb = 0.f, ve = 0.f;
      if (jj <= i) {
        const float l = expf(cum_r[e >> 1] - cum_at(cum_s, jj));
        vx = cbv[j][e] * l * dt_s[jj];
        vb = mv[j][e] * l * dt_s[jj];
        ve = mv[j][e] * cbv[j][e] * l;
      }
      rt[e >> 1] = fmaf(ve, dt_s[jj], rt[e >> 1]);
      cs[j][e & 1] += ve;
      cbv[j][e] = vx;
      mv[j][e] = vb;
    }
  }
  // rowT over the 4 threads of a row; colE over the 8 row pairs of the warp
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rt[r] += __shfl_xor_sync(0xffffffffu, rt[r], 1);
    rt[r] += __shfl_xor_sync(0xffffffffu, rt[r], 2);
    if (t == 0) rowT[warp * 16 + g + 8 * r] = rt[r];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      float v = cs[j][k];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (g == 0) colp[warp * kQ + j * 8 + 2 * t + k] = v;
    }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = warp * 16 + g + 8 * r, jj = j * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(ssx + i * ldt + jj) = pack_bf16(cbv[j][2 * r], cbv[j][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(ssb + i * ldt + jj) = pack_bf16(mv[j][2 * r], mv[j][2 * r + 1]);
    }
  uint32_t pa[4][4];  // Sb rows of this warp: the A operand of dC
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) acc_to_a(pa[kk], mv[2 * kk], mv[2 * kk + 1]);
  __syncthreads();
  if (tid < kQ) colE[tid] = ((colp[tid] + colp[kQ + tid]) + colp[2 * kQ + tid]) + colp[3 * kQ + tid];

  // G_out and S_in a (P tile, N block) at a time, each staged once. Per N
  // block: this P tile's x G_out and dy S_in, which give u and v and enter
  // dB = Sb^T C + w_j x G_out and dC = Sb B + exp(cum_i) dy S_in (this head's
  // shares; a later P tile adds its terms to what the first one wrote), and
  // B G_out^T for dx. Per P tile: dx = Sx^T dy + w_j B G_out^T.
  float gs = 0.f;
  for (int p0 = 0; p0 < a.P; p0 += kQ) {
    stage_p(p0);
    float gba[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) gba[j][e] = 0.f;
    for (int n0 = 0; n0 < npad; n0 += kQ) {
      const int nk = min(4, (npad - n0) / 16);
      __syncthreads();  // the last G and S tiles read by everyone
      stage_state(sg, gout_c, ss, sin_c, p0, n0, a.P, a.N, vec_st, gs, tid);
      __syncthreads();
      float xg[8][4], dys[8][4], acc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) xg[j][e] = dys[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kQ / 16; ++kk) {
        uint32_t af[4], ad[4];
        ldsm_x4(af, sx + warp * 16 * ldt + a_t + kk * 16);
        ldsm_x4(ad, sdy + warp * 16 * ldt + a_t + kk * 16);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          if (np >= nk) break;
          uint32_t bf[4];
          ldsm_x4_t(bf, sg + kk * 16 * ldt + bt_t + np * 16);
          mma_bf16(xg[2 * np], af, bf[0], bf[1]);
          mma_bf16(xg[2 * np + 1], af, bf[2], bf[3]);
          ldsm_x4_t(bf, ss + kk * 16 * ldt + bt_t + np * 16);
          mma_bf16(dys[2 * np], ad, bf[0], bf[1]);
          mma_bf16(dys[2 * np + 1], ad, bf[2], bf[3]);
        }
      }
      // B G_out^T: keys j of this warp, this P tile's columns, over the block's n
      for (int kk = 0; kk < nk; ++kk) {
        uint32_t af[4];
        ldsm_x4(af, sb + warp * 16 * ldn + a_n + n0 + kk * 16);
#pragma unroll
        for (int dp = 0; dp < 4; ++dp) {
          uint32_t bf[4];
          ldsm_x4(bf, sg + dp * 16 * ldt + b_t + kk * 16);
          mma_bf16(gba[2 * dp], af, bf[0], bf[1]);
          mma_bf16(gba[2 * dp + 1], af, bf[2], bf[3]);
        }
      }
      // u_j += B_j . (x G_out)_j and v_i += C_i . (dy S_in)_i over the block's columns
      float uu[2] = {0.f, 0.f}, vv[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j >= 2 * nk) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = warp * 16 + g + 8 * (e >> 1), n = n0 + j * 8 + 2 * t + (e & 1);
          uu[e >> 1] = fmaf(__bfloat162float(sb[i * ldn + n]), xg[j][e], uu[e >> 1]);
          vv[e >> 1] = fmaf(__bfloat162float(sc[i * ldn + n]), dys[j][e], vv[e >> 1]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        uu[r] += __shfl_xor_sync(0xffffffffu, uu[r], 1);
        uu[r] += __shfl_xor_sync(0xffffffffu, uu[r], 2);
        vv[r] += __shfl_xor_sync(0xffffffffu, vv[r], 1);
        vv[r] += __shfl_xor_sync(0xffffffffu, vv[r], 2);
        if (t == 0) {  // each row's own quad, the blocks in order
          u_s[warp * 16 + g + 8 * r] += uu[r];
          v_s[warp * 16 + g + 8 * r] += vv[r];
        }
      }
      // dB: keys j of this warp, rows i >= j
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      if (p0 == 0) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (kk < warp) continue;
          uint32_t af[4];
          ldsm_x4_t(af, ssb + kk * 16 * ldt + b_t + warp * 16);
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            if (np >= nk) break;
            uint32_t bf[4];
            ldsm_x4_t(bf, sc + kk * 16 * ldn + bt_n + n0 + np * 16);
            mma_bf16(acc[2 * np], af, bf[0], bf[1]);
            mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = warp * 16 + g + 8 * r;
        if (j >= rows) continue;
        float* out = a.db_part + (row0 + static_cast<int64_t>(j) * a.H) * a.N;
#pragma unroll
        for (int jt = 0; jt < 8; ++jt)
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int n = n0 + jt * 8 + 2 * t + k;
            if (jt < 2 * nk && n < a.N)
              out[n] = fmaf(w_s[j], xg[jt][2 * r + k], p0 == 0 ? acc[jt][2 * r + k] : out[n]);
          }
      }
      // dC: rows i of this warp, keys j <= i
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      if (p0 == 0) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (kk > warp) break;
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            if (np >= nk) break;
            uint32_t bf[4];
            ldsm_x4_t(bf, sb + kk * 16 * ldn + bt_n + n0 + np * 16);
            mma_bf16(acc[2 * np], pa[kk], bf[0], bf[1]);
            mma_bf16(acc[2 * np + 1], pa[kk], bf[2], bf[3]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = warp * 16 + g + 8 * r;
        if (i >= rows) continue;
        float* out = a.dc_part + (row0 + static_cast<int64_t>(i) * a.H) * a.N;
#pragma unroll
        for (int jt = 0; jt < 8; ++jt)
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int n = n0 + jt * 8 + 2 * t + k;
            if (jt < 2 * nk && n < a.N)
              out[n] = fmaf(ecum[r], dys[jt][2 * r + k], p0 == 0 ? acc[jt][2 * r + k] : out[n]);
          }
      }
    }
    // dx for this P tile: Sx^T dy (keys j of this warp, rows i >= j) + w_j B G_out^T
    float dxa[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dxa[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk < warp) continue;
      uint32_t af[4];
      ldsm_x4_t(af, ssx + kk * 16 * ldt + b_t + warp * 16);
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        uint32_t bf[4];
        ldsm_x4_t(bf, sdy + kk * 16 * ldt + bt_t + dp * 16);
        mma_bf16(dxa[2 * dp], af, bf[0], bf[1]);
        mma_bf16(dxa[2 * dp + 1], af, bf[2], bf[3]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = warp * 16 + g + 8 * r;
      if (j >= rows) continue;
      bf16* out = static_cast<bf16*>(a.dx) + (row0 + static_cast<int64_t>(j) * a.H) * a.P;
#pragma unroll
      for (int jt = 0; jt < 8; ++jt)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int p = p0 + jt * 8 + 2 * t + k;
          if (p < a.P) out[p] = cast<bf16>(fmaf(w_s[j], gba[jt][2 * r + k], dxa[jt][2 * r + k]));
        }
    }
  }

  red[tid] = gs;
  __syncthreads();
  bwd_tail(a, dt_s, cum_s, w_s, rowT, colE, u_s, v_s, red, kThreads, rows, row0, a_h, tid);
}

// f32: scalar FMAs (bwd_fma, 256 threads); bf16: the tensor cores (bwd_mma,
// 128 threads)
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
ssd_chunk_bwd_kernel(BwdArgs a) {
  if constexpr (kMma<T>)
    bwd_mma(a);
  else
    bwd_fma(a);
}

// dB and dC summed over the heads of each group, dA over (batch, chunk),
// each in a fixed order; one thread an element of dB and dC, and block 0's
// threads the heads of dA.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
ssd_bwd_reduce_kernel(BwdArgs a) {
  const int rep = a.H / a.G;
  const int64_t n_el = static_cast<int64_t>(a.B) * a.S * a.G * a.N;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kReduceThreads + threadIdx.x;
  if (e < n_el) {
    const int n = static_cast<int>(e % a.N);
    const int64_t rg = e / a.N;  // (b, s) * G + g
    const int g = static_cast<int>(rg % a.G);
    const int64_t at = ((rg - g) * a.H / a.G + static_cast<int64_t>(g) * rep) * a.N + n;
    float sb = 0.f, sc = 0.f;
    for (int k = 0; k < rep; ++k) {
      sb += a.db_part[at + static_cast<int64_t>(k) * a.N];
      sc += a.dc_part[at + static_cast<int64_t>(k) * a.N];
    }
    static_cast<T*>(a.db)[e] = cast<T>(sb);
    static_cast<T*>(a.dc)[e] = cast<T>(sc);
  }
  if (blockIdx.x == 0)
    for (int h = threadIdx.x; h < a.H; h += kReduceThreads) {
      float s = 0.f;
      for (int k = 0; k < a.B * a.nc; ++k) s += a.da_part[static_cast<int64_t>(k) * a.H + h];
      a.da[h] = s;
    }
}

template <typename T>
size_t bwd_smem(int N) {
  if constexpr (kMma<T>)  // dt, cum, w, rowT, colE, u, v, 4 column sums, the partial sums;
    // C and B; x, dy, Sx, Sb, G and S tiles
    return (11 * kQ + kThreads + 8) * sizeof(float) +
           static_cast<size_t>(kQ) * (2 * tile_ld<bf16>(round16(N)) + 6 * tile_ld<bf16>(kQ)) *
               sizeof(bf16);
  return (7 * kQ + kBwdThreads + 8) * sizeof(float) +
         9 * static_cast<size_t>(kQ) * kLd * sizeof(float);
}

// Recompute every chunk's incoming state, then the state gradients in
// reverse, then the chunks' backward, then the sums over heads and chunks
template <typename T>
int launch_bwd(const Args& fwd, const Args& grad, const BwdArgs& a, cudaStream_t stream) {
  int code = launch_states<T, false>(fwd, a.B, stream);
  if (code != 0) return code;
  code = launch_states<T, true>(grad, a.B, stream);
  if (code != 0) return code;
  const size_t smem = bwd_smem<T>(a.N);
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_bwd_kernel<T><<<dim3(a.nc, a.H, a.B), kMma<T> ? kThreads : kBwdThreads, smem,
                            stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_el = static_cast<int64_t>(a.B) * a.S * a.G * a.N;
  const unsigned blocks = static_cast<unsigned>((n_el + kReduceThreads - 1) / kReduceThreads);
  ssd_bwd_reduce_kernel<T><<<blocks, kReduceThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p, std::initializer_list<int64_t> strides, int64_t width, int esize) {
  const int per = 16 / esize;  // elements in 16 bytes
  if (reinterpret_cast<uintptr_t>(p) % 16 || width % per) return false;
  for (const int64_t s : strides)
    if (s % per) return false;
  return true;
}

}  // namespace

// init may be null (a zero initial state). Strides are in elements, in the
// order (batch, seq, head-or-group); the last axis of x, B, C and y has
// stride 1, and init and final_state are contiguous (B, H, P, N). ws is f32
// (B, ceil(S / 64), H, P, N), ws_in the same shape in bf16 for bf16 inputs
// and null for f32, and total f32 (B, H, ceil(S / 64)): contiguous scratch
// that the call overwrites. Three launches on `stream`.
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* A, const void* bm,
                              const void* cm, const void* init, void* y, void* final_state,
                              void* ws, void* ws_in, void* total, int B, int S, int H, int G,
                              int P, int N,
                              int64_t xs_b, int64_t xs_s, int64_t xs_h, int64_t dts_b,
                              int64_t dts_s, int64_t dts_h, int64_t bs_b, int64_t bs_s,
                              int64_t bs_h, int64_t cs_b, int64_t cs_s, int64_t cs_h,
                              int64_t ys_b, int64_t ys_s, int64_t ys_h, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G || P <= 0 || N <= 0 || N > kMaxN ||
      H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = x;
  a.dt = static_cast<const float*>(dt);
  a.A = static_cast<const float*>(A);
  a.bm = bm;
  a.cm = cm;
  a.init = static_cast<const float*>(init);
  a.y = y;
  a.final_state = static_cast<float*>(final_state);
  a.ws = static_cast<float*>(ws);
  a.ws_in = static_cast<bf16*>(ws_in);
  a.total = static_cast<float*>(total);
  a.S = S;
  a.H = H;
  a.G = G;
  a.P = P;
  a.N = N;
  a.nc = (S + kQ - 1) / kQ;
  a.xs = {xs_b, xs_s, xs_h};
  a.dts = {dts_b, dts_s, dts_h};
  a.bs = {bs_b, bs_s, bs_h};
  a.cs = {cs_b, cs_s, cs_h};
  a.ys = {ys_b, ys_s, ys_h};
  const int es = dtype == repro::kFloat32 ? 4 : 2;
  a.vec_x = aligned16(x, {xs_b, xs_s, xs_h}, P, es);
  a.vec_bc = aligned16(bm, {bs_b, bs_s, bs_h}, N, es) && aligned16(cm, {cs_b, cs_s, cs_h}, N, es);
  a.pair_y = P % 2 == 0 && reinterpret_cast<uintptr_t>(y) % 4 == 0 && ys_b % 2 == 0 &&
             ys_s % 2 == 0 && ys_h % 2 == 0;
  a.grad = false;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32 && ws_in == nullptr) {
    a.vec_ws = aligned16(ws, {}, N, 4);
    return launch<float>(a, B, st);
  }
  if (dtype == repro::kBFloat16 && ws_in != nullptr) {
    a.vec_ws = aligned16(ws_in, {}, N, 2);
    return launch<__nv_bfloat16>(a, B, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward of repro_ssd_scan: dx (B, S, H, P), dB and dC (B, S, G, N) in
// x's dtype, contiguous; ddt (B, S, H), dA (H,) and dinit (B, H, P, N) f32,
// contiguous (dinit is written whether init is null or not). dy is read
// through its strides (unit last stride); init and dstate (the final state's
// gradient; null: zeros) are contiguous f32. Scratch, contiguous f32, that the
// call overwrites: ws_s and ws_g (B, ceil(S / 64), H, P, N), total
// (B, H, ceil(S / 64)), db_part and dc_part (B, S, H, N), da_part
// (B, ceil(S / 64), H). Six launches on `stream`.
extern "C" int repro_ssd_scan_bwd(const void* x, const void* dt, const void* A, const void* bm,
                                  const void* cm, const void* dy, const void* init,
                                  const void* dstate, void* dx, void* ddt, void* dA, void* db,
                                  void* dc, void* dinit, void* ws_s, void* ws_g, void* total,
                                  void* db_part, void* dc_part, void* da_part, int B, int S, int H,
                                  int G, int P, int N, int64_t xs_b, int64_t xs_s, int64_t xs_h,
                                  int64_t dts_b, int64_t dts_s, int64_t dts_h, int64_t bs_b,
                                  int64_t bs_s, int64_t bs_h, int64_t cs_b, int64_t cs_s,
                                  int64_t cs_h, int64_t dys_b, int64_t dys_s, int64_t dys_h,
                                  int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G || P <= 0 || N <= 0 || N > kMaxN ||
      H > 65535 || B > 65535 || (dtype != repro::kFloat32 && dtype != repro::kBFloat16))
    return static_cast<int>(cudaErrorInvalidValue);
  const int es = dtype == repro::kFloat32 ? 4 : 2;
  // the forward's chunk states, recomputed: chunk c's incoming state over ws_s
  Args f{};
  f.x = x;
  f.dt = static_cast<const float*>(dt);
  f.A = static_cast<const float*>(A);
  f.bm = bm;
  f.cm = cm;
  f.init = static_cast<const float*>(init);
  f.final_state = static_cast<float*>(dinit);  // overwritten by the reverse pass
  f.ws = static_cast<float*>(ws_s);
  f.total = static_cast<float*>(total);
  f.S = S;
  f.H = H;
  f.G = G;
  f.P = P;
  f.N = N;
  f.nc = (S + kQ - 1) / kQ;
  f.xs = {xs_b, xs_s, xs_h};
  f.dts = {dts_b, dts_s, dts_h};
  f.bs = {bs_b, bs_s, bs_h};
  f.cs = {cs_b, cs_s, cs_h};
  f.vec_x = aligned16(x, {xs_b, xs_s, xs_h}, P, es);
  f.vec_bc = aligned16(bm, {bs_b, bs_s, bs_h}, N, es) && aligned16(cm, {cs_b, cs_s, cs_h}, N, es);
  // the state gradients: sum_i exp(cum_i) dy_i (x) C_i per chunk, then the
  // reverse pass from dstate, chunk c's G_out over ws_g
  Args g = f;
  g.x = dy;
  g.xs = {dys_b, dys_s, dys_h};
  g.bm = cm;
  g.bs = f.cs;
  g.init = static_cast<const float*>(dstate);
  g.ws = static_cast<float*>(ws_g);
  g.grad = true;
  g.vec_x = aligned16(dy, {dys_b, dys_s, dys_h}, P, es);
  g.vec_bc = aligned16(cm, {cs_b, cs_s, cs_h}, N, es);
  BwdArgs a{};
  a.x = x;
  a.bm = bm;
  a.cm = cm;
  a.dy = dy;
  a.dt = f.dt;
  a.A = f.A;
  a.s_in = f.ws;
  a.g_out = g.ws;
  a.dx = dx;
  a.ddt = static_cast<float*>(ddt);
  a.db_part = static_cast<float*>(db_part);
  a.dc_part = static_cast<float*>(dc_part);
  a.da_part = static_cast<float*>(da_part);
  a.db = db;
  a.dc = dc;
  a.da = static_cast<float*>(dA);
  a.B = B;
  a.S = S;
  a.H = H;
  a.G = G;
  a.P = P;
  a.N = N;
  a.nc = f.nc;
  a.xs = f.xs;
  a.dts = f.dts;
  a.bs = f.bs;
  a.cs = f.cs;
  a.dys = g.xs;
  a.vec_x = f.vec_x;
  a.vec_dy = g.vec_x;
  a.vec_bc = f.vec_bc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32) return launch_bwd<float>(f, g, a, st);
  return launch_bwd<__nv_bfloat16>(f, g, a, st);
}
