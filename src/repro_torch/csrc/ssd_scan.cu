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
  if (tid < kQ) w_s[tid] = dt_s[tid] * expf(total - cum_at(cum_s, tid));
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

// kE neighbouring (p, n) elements a thread: 4 where N % 4 == 0, else 1
template <int kE>
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
  for (int c0 = 0; c0 < a.nc; c0 += kBatch) {
    float s[kBatch][kE];
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (c0 + k < a.nc) load_e<kE>(s[k], w + (c0 + k) * cstride);
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (c0 + k < a.nc) {
        if (w_in != nullptr)
          store_e<kE>(w_in + (c0 + k) * cstride, st);
        else
          store_e<kE>(w + (c0 + k) * cstride, st);
        const float decay = expf(tot[c0 + k]);
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

template <typename T>
int launch(const Args& a, int B, cudaStream_t stream) {
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
    ssd_state_pass_kernel<4><<<pass, kPassThreads, 0, stream>>>(a);
  else
    ssd_state_pass_kernel<1><<<pass, kPassThreads, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
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
