// Forward flash attention, causal or not, with GQA, on the (B, S, H, D) layout.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_flash_kernel / flash_attention_kernel), whose grid walks the KV blocks of
// one query block in order and carries (m, l, acc) across grid steps in VMEM.
//
// Bound on the card: at the main path's prompts (S up to ~700, D = 128, GQA
// 16/8) the least time is set by the bytes (q, k, v read once, out written
// once) and operations (4 * D per attended (query, key) pair, at the bf16
// tensor-core rate) about equally; above S ~ 900 the operations dominate.
// This first kernel uses neither the tensor cores nor TMA: it is bound by its
// scalar f32 FMAs and shared-memory reads, far above either limit. wgmma and
// TMA are for a later kernel.
// Design: one block of 256 threads per (64-row query tile, head, batch). The
// Pallas grid's sequential KV axis becomes a loop inside the block, which
// stops at the diagonal when causal. Q and one 64-key tile (K, then V in the
// same buffer) are staged in shared memory in f32, padded to D + 1 columns so
// the column walks hit distinct banks; the running max, sum and output
// accumulator stay in registers in f32. Each thread owns 4 query rows
// (ty + 16 i) and, for the scores, 4 key columns (tx + 16 j) and, for the
// output, up to 8 of the D columns (tx + 16 j); row statistics are reduced
// across the 16 threads of a row with shuffles. Keys at or past S, and keys
// above the diagonal, get the score -1e30 as in the reference; l is clamped
// at 1e-30 before the division. Query head h reads KV head h / (H / KV).
// q, k, v and out are read through their (batch, seq, head) strides, so the
// caller needs no transpose and no padding; D may be anything up to 128.
// When the caller asks (training), the forward also writes each row's
// log-sum-exp, lse = m + log(l), in f32 as (B, H, S); serving passes null.
//
// Backward (no TPU kernel: the reference differentiates its jnp attention
// with XLA). Two kernels in the forward's layout, each recomputing
// P = exp(S * scale - lse) tile by tile from q, k and the saved lse:
//   dQ:    one block per (64-row query tile, head, batch). It first forms
//          Delta = rowsum(dO * O) for its rows and writes it out (f32,
//          (B, H, S)), then walks the key tiles up to the diagonal:
//          dP = dO V^T, dS = P * (dP - Delta), dQ += scale * dS K.
//   dK/dV: one block per (64-row key tile, KV head, batch). It walks the
//          query tiles from the diagonal on, for every query head of its
//          KV group, reading the Delta the dQ kernel wrote:
//          dV += P^T dO, dK += scale * dS^T Q. Summing the group's heads
//          inside the block gives GQA's dK and dV without atomics.
// Causal tiles above the diagonal are skipped; rows and keys at or past S
// get P = 0. Bound on the card: the operations (2.5 times the forward's:
// five (query, key, D) products against the forward's two) at the bf16
// tensor-core rate, or the bytes (q, k, v, o, dO read once; dq, dk, dv
// written once), whichever is larger. Like the forward, these kernels use
// scalar f32 FMAs on f32 tiles in shared memory, not the tensor cores.
#include "common.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;  // == kBlockQ: the causal loop and stage_tile rely on it
constexpr int kThreads = 256;  // 16 x 16
constexpr int kMaxD = 128;
constexpr int kDPer = kMaxD / 16;  // output columns per thread
constexpr float kNegInf = -1e30f;

struct Strides {
  int64_t b, s, h;
};

// Stage rows [s0, s0 + 64) of one head (row stride `rs`) into `tile` as f32
// with row stride `ld`; rows at or past S become zeros. Thread t handles
// column t % 128 of rows t / 128 + 2 i, so a warp reads 32 neighbouring
// elements of one row. Loads go out in batches of kBatch before their
// stores, so a thread waits for kRows / kBatch round trips, not kRows.
template <typename T>
__device__ __forceinline__ void stage_tile(float* __restrict__ tile, int ld,
                                           const T* __restrict__ base, int64_t rs, int s0,
                                           int S, int D, int tid) {
  constexpr int kRows = kBlockK * kMaxD / kThreads;  // 32 rows per thread
  constexpr int kBatch = 8;
  const int c = tid % kMaxD;
  const int r0 = tid / kMaxD;
  if (c >= D) return;
#pragma unroll
  for (int b = 0; b < kRows; b += kBatch) {
    float vals[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int s = s0 + r0 + 2 * (b + i);
      vals[i] = s < S ? repro::to_f32(base[s * rs + c]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) tile[(r0 + 2 * (b + i)) * ld + c] = vals[i];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int S, int H, int KV, int D,
                 Strides qs, Strides ks, Strides vs, Strides os, float sm_scale, int causal) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* q_tile = smem;                       // kBlockQ x ld
  float* kv_tile = q_tile + kBlockQ * ld;     // kBlockK x ld: K, then V
  float* p_tile = kv_tile + kBlockK * ld;     // kBlockQ x (kBlockK + 1)
  constexpr int ldp = kBlockK + 1;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qt * kBlockQ;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;

  stage_tile(q_tile, ld, qb, qs.s, q0, S, D, tid);

  float m[4], l[4], acc[4][kDPer];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kDPer; ++j) acc[i][j] = 0.f;
  }

  const int n_tiles = (S + kBlockK - 1) / kBlockK;
  // kBlockQ == kBlockK: causal query tile qt needs key tiles 0..qt
  const int n_kt = causal ? min(n_tiles, qt + 1) : n_tiles;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // q_tile written / last V tile read by everyone
    stage_tile(kv_tile, ld, kb, ks.s, k0, S, D, tid);
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int dd = 0; dd < D; ++dd) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_tile[(ty + 16 * i) * ld + dd];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = kv_tile[(tx + 16 * j) * ld + dd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mcur = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float s = sc[i][j] * sm_scale;
        if (kpos >= S || (causal && kpos > qpos)) s = kNegInf;
        sc[i][j] = s;
        mcur = fmaxf(mcur, s);
      }
      // the 16 threads of a row are lanes 0-15 or 16-31 of one warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mcur = fmaxf(mcur, __shfl_xor_sync(0xffffffffu, mcur, off));
      const float m_new = fmaxf(m[i], mcur);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        p_tile[(ty + 16 * i) * ldp + tx + 16 * j] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + psum;
#pragma unroll
      for (int j = 0; j < kDPer; ++j) acc[i][j] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();  // scores done with K; p_tile complete

    stage_tile(kv_tile, ld, vb, vs.s, k0, S, D, tid);
    __syncthreads();

    for (int kk = 0; kk < kBlockK; ++kk) {
      float pv[4], vv[kDPer];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_tile[(ty + 16 * i) * ldp + kk];
#pragma unroll
      for (int j = 0; j < kDPer; ++j) {
        const int c = tx + 16 * j;
        vv[j] = c < D ? kv_tile[kk * ld + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kDPer; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  T* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= S) continue;
    const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kDPer; ++j) {
      const int c = tx + 16 * j;
      if (c < D) ob[qpos * os.s + c] = repro::from_f32<T>(acc[i][j] / li);
    }
    if (lse != nullptr && tx == 0)
      lse[(static_cast<int64_t>(b) * H + h) * S + qpos] = m[i] + logf(li);
  }
}

// dQ and Delta; see the header. Shared memory: Q and dO tiles, one tile that
// holds V and then K, and the dS tile, all f32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ o, const T* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta, T* __restrict__ dq,
                    int S, int H, int KV, int D, Strides qs, Strides ks, Strides vs, Strides os,
                    Strides dos, Strides dqs, float sm_scale, int causal) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  constexpr int ldp = kBlockK + 1;
  float* q_tile = smem;                    // kBlockQ x ld
  float* do_tile = q_tile + kBlockQ * ld;  // kBlockQ x ld
  float* kv_tile = do_tile + kBlockQ * ld;  // kBlockK x ld: V, then K
  float* ds_tile = kv_tile + kBlockK * ld;  // kBlockQ x ldp

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qt * kBlockQ;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int64_t row_base = (static_cast<int64_t>(b) * H + h) * S;

  const T* ob = o + b * os.b + h * os.h;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;
  stage_tile(q_tile, ld, q + b * qs.b + h * qs.h, qs.s, q0, S, D, tid);
  stage_tile(do_tile, ld, dout + b * dos.b + h * dos.h, dos.s, q0, S, D, tid);
  __syncthreads();

  float dl[4], ls[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, qpos = q0 + r;
    float part = 0.f;
    if (qpos < S) {
#pragma unroll
      for (int j = 0; j < kDPer; ++j) {
        const int c = tx + 16 * j;
        if (c < D) part += do_tile[r * ld + c] * repro::to_f32(ob[qpos * os.s + c]);
      }
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    dl[i] = part;
    ls[i] = qpos < S ? lse[row_base + qpos] : 0.f;
    if (tx == 0 && qpos < S) delta[row_base + qpos] = part;
  }

  float acc[4][kDPer];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDPer; ++j) acc[i][j] = 0.f;

  const int n_tiles = (S + kBlockK - 1) / kBlockK;
  const int n_kt = causal ? min(n_tiles, qt + 1) : n_tiles;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the last tile's K and dS are read by everyone
    stage_tile(kv_tile, ld, vb, vs.s, k0, S, D, tid);
    __syncthreads();
    float dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dp[i][j] = 0.f;
    for (int dd = 0; dd < D; ++dd) {
      float ov[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ov[i] = do_tile[(ty + 16 * i) * ld + dd];
#pragma unroll
      for (int j = 0; j < 4; ++j) vv[j] = kv_tile[(tx + 16 * j) * ld + dd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
    }
    __syncthreads();  // V read by everyone
    stage_tile(kv_tile, ld, kb, ks.s, k0, S, D, tid);
    __syncthreads();
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int dd = 0; dd < D; ++dd) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_tile[(ty + 16 * i) * ld + dd];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = kv_tile[(tx + 16 * j) * ld + dd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float p = 0.f;
        if (qpos < S && kpos < S && !(causal && kpos > qpos))
          p = expf(sc[i][j] * sm_scale - ls[i]);
        ds_tile[(ty + 16 * i) * ldp + tx + 16 * j] = p * (dp[i][j] - dl[i]);
      }
    }
    __syncthreads();  // dS complete
    for (int kk = 0; kk < kBlockK; ++kk) {
      float sv[4], kv[kDPer];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = ds_tile[(ty + 16 * i) * ldp + kk];
#pragma unroll
      for (int j = 0; j < kDPer; ++j) {
        const int c = tx + 16 * j;
        kv[j] = c < D ? kv_tile[kk * ld + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kDPer; ++j) acc[i][j] = fmaf(sv[i], kv[j], acc[i][j]);
    }
  }

  T* dqb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= S) continue;
#pragma unroll
    for (int j = 0; j < kDPer; ++j) {
      const int c = tx + 16 * j;
      if (c < D) dqb[qpos * dqs.s + c] = repro::from_f32<T>(acc[i][j] * sm_scale);
    }
  }
}

// dK and dV of one key tile, summed over the KV group's query heads; see the
// header. Shared memory: K, V, Q and dO tiles, one tile that holds P^T and
// then dS^T, and the query tile's lse and Delta, all f32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                      int S, int H, int KV, int D, Strides qs, Strides ks, Strides vs,
                      Strides dos, Strides dks, Strides dvs, float sm_scale, int causal) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  constexpr int ldp = kBlockQ + 1;
  float* k_tile = smem;                     // kBlockK x ld
  float* v_tile = k_tile + kBlockK * ld;    // kBlockK x ld
  float* q_tile = v_tile + kBlockK * ld;    // kBlockQ x ld
  float* do_tile = q_tile + kBlockQ * ld;   // kBlockQ x ld
  float* pt_tile = do_tile + kBlockQ * ld;  // kBlockK x ldp: P^T, then dS^T
  float* stat = pt_tile + kBlockK * ldp;    // lse[kBlockQ], Delta[kBlockQ]

  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int group = H / KV;
  const int k0 = kt * kBlockK;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  stage_tile(k_tile, ld, k + b * ks.b + kvh * ks.h, ks.s, k0, S, D, tid);
  stage_tile(v_tile, ld, v + b * vs.b + kvh * vs.h, vs.s, k0, S, D, tid);

  // rows are keys k0 + ty + 16 a, columns are D columns tx + 16 j
  float dk_acc[4][kDPer], dv_acc[4][kDPer];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < kDPer; ++j) dk_acc[a][j] = dv_acc[a][j] = 0.f;

  const int n_tiles = (S + kBlockQ - 1) / kBlockQ;
  const int qt0 = causal ? kt : 0;  // kBlockQ == kBlockK
  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const int64_t row_base = (static_cast<int64_t>(b) * H + h) * S;
    const T* qb = q + b * qs.b + h * qs.h;
    const T* dob = dout + b * dos.b + h * dos.h;
    for (int qt = qt0; qt < n_tiles; ++qt) {
      const int q0 = qt * kBlockQ;
      __syncthreads();  // the last query tile and dS^T are read by everyone
      stage_tile(q_tile, ld, qb, qs.s, q0, S, D, tid);
      stage_tile(do_tile, ld, dob, dos.s, q0, S, D, tid);
      if (tid < kBlockQ) {
        const int qpos = q0 + tid;
        stat[tid] = qpos < S ? lse[row_base + qpos] : 0.f;
        stat[kBlockQ + tid] = qpos < S ? delta[row_base + qpos] : 0.f;
      }
      __syncthreads();
      // S^T and dP^T: rows keys ty + 16 a, columns queries tx + 16 c
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) st[a][c] = dpt[a][c] = 0.f;
      for (int dd = 0; dd < D; ++dd) {
        float kr[4], vr[4], qc[4], oc[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          kr[a] = k_tile[(ty + 16 * a) * ld + dd];
          vr[a] = v_tile[(ty + 16 * a) * ld + dd];
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          qc[c] = q_tile[(tx + 16 * c) * ld + dd];
          oc[c] = do_tile[(tx + 16 * c) * ld + dd];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            st[a][c] = fmaf(kr[a], qc[c], st[a][c]);
            dpt[a][c] = fmaf(vr[a], oc[c], dpt[a][c]);
          }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int kpos = k0 + ty + 16 * a;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = tx + 16 * c, qpos = q0 + col;
          float p = 0.f;
          if (qpos < S && kpos < S && !(causal && kpos > qpos))
            p = expf(st[a][c] * sm_scale - stat[col]);
          dpt[a][c] = p * (dpt[a][c] - stat[kBlockQ + col]);
          pt_tile[(ty + 16 * a) * ldp + col] = p;
        }
      }
      __syncthreads();  // P^T complete
      for (int qq = 0; qq < kBlockQ; ++qq) {
        float pv[4], ov[kDPer];
#pragma unroll
        for (int a = 0; a < 4; ++a) pv[a] = pt_tile[(ty + 16 * a) * ldp + qq];
#pragma unroll
        for (int j = 0; j < kDPer; ++j) {
          const int c = tx + 16 * j;
          ov[j] = c < D ? do_tile[qq * ld + c] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int j = 0; j < kDPer; ++j) dv_acc[a][j] = fmaf(pv[a], ov[j], dv_acc[a][j]);
      }
      __syncthreads();  // P^T read by everyone
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) pt_tile[(ty + 16 * a) * ldp + tx + 16 * c] = dpt[a][c];
      __syncthreads();  // dS^T complete
      for (int qq = 0; qq < kBlockQ; ++qq) {
        float sv[4], qv[kDPer];
#pragma unroll
        for (int a = 0; a < 4; ++a) sv[a] = pt_tile[(ty + 16 * a) * ldp + qq];
#pragma unroll
        for (int j = 0; j < kDPer; ++j) {
          const int c = tx + 16 * j;
          qv[j] = c < D ? q_tile[qq * ld + c] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int j = 0; j < kDPer; ++j) dk_acc[a][j] = fmaf(sv[a], qv[j], dk_acc[a][j]);
      }
    }
  }

  T* dkb = dk + b * dks.b + kvh * dks.h;
  T* dvb = dv + b * dvs.b + kvh * dvs.h;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int kpos = k0 + ty + 16 * a;
    if (kpos >= S) continue;
#pragma unroll
    for (int j = 0; j < kDPer; ++j) {
      const int c = tx + 16 * j;
      if (c < D) {
        dkb[kpos * dks.s + c] = repro::from_f32<T>(dk_acc[a][j] * sm_scale);
        dvb[kpos * dvs.s + c] = repro::from_f32<T>(dv_acc[a][j]);
      }
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S, int H,
           int KV, int D, Strides qs, Strides ks, Strides vs, Strides os, float sm_scale,
           int causal, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(kBlockQ + kBlockK) * (D + 1) +
                                       static_cast<size_t>(kBlockQ) * (kBlockK + 1));
  // above 48 KB a block's shared memory has to be asked for
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  flash_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, S, H, KV, D, qs, ks, vs, os, sm_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int S,
               int H, int KV, int D, Strides qs, Strides ks, Strides vs, Strides os, Strides dos,
               Strides dqs, Strides dks, Strides dvs, float sm_scale, int causal,
               cudaStream_t stream) {
  const size_t tile = static_cast<size_t>(kBlockQ) * (D + 1);  // kBlockQ == kBlockK
  const size_t smem_dq = sizeof(float) * (3 * tile + static_cast<size_t>(kBlockQ) * (kBlockK + 1));
  const size_t smem_dkdv =
      sizeof(float) * (4 * tile + static_cast<size_t>(kBlockK) * (kBlockQ + 1) + 2 * kBlockQ);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_dq));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_dkdv));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (S + kBlockQ - 1) / kBlockQ;
  // dQ first: it writes the Delta that dK/dV reads
  flash_bwd_dq_kernel<T><<<dim3(n_tiles, H, B), kThreads, smem_dq, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), S,
      H, KV, D, qs, ks, vs, os, dos, dqs, sm_scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_kernel<T><<<dim3(n_tiles, KV, B), kThreads, smem_dkdv, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), S, H,
      KV, D, qs, ks, vs, dos, dks, dvs, sm_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// lse: null, or f32 (B, H, S) for the row log-sum-exps (training).
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, void* lse, int B, int S, int H, int KV,
    int D,
    int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh,
    float sm_scale, int causal, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV || D <= 0 || D > kMaxD || H > 65535 ||
      B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh},
      os{o_sb, o_ss, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == repro::kFloat32)
    return launch<float>(q, k, v, o, l, B, S, H, KV, D, qs, ks, vs, os, sm_scale, causal, s);
  if (dtype == repro::kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, o, l, B, S, H, KV, D, qs, ks, vs, os, sm_scale, causal,
                                 s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// lse (read) and delta (written, then read) are f32 (B, H, S), contiguous;
// every other tensor is read or written through its (batch, seq, head)
// strides with unit stride along D. dq is written by the first kernel, dk
// and dv by the second.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* delta, void* dq, void* dk, void* dv, int B, int S, int H, int KV,
    int D, int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh,
    int64_t do_sb, int64_t do_ss, int64_t do_sh, int64_t dq_sb, int64_t dq_ss, int64_t dq_sh,
    int64_t dk_sb, int64_t dk_ss, int64_t dk_sh, int64_t dv_sb, int64_t dv_ss, int64_t dv_sh,
    float sm_scale, int causal, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV || D <= 0 || D > kMaxD || H > 65535 ||
      B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh},
      os{o_sb, o_ss, o_sh}, dos{do_sb, do_ss, do_sh}, dqs{dq_sb, dq_ss, dq_sh},
      dks{dk_sb, dk_ss, dk_sh}, dvs{dv_sb, dv_ss, dv_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == repro::kFloat32)
    return launch_bwd<float>(q, k, v, o, dout, l, dl, dq, dk, dv, B, S, H, KV, D, qs, ks, vs, os,
                             dos, dqs, dks, dvs, sm_scale, causal, s);
  if (dtype == repro::kBFloat16)
    return launch_bwd<__nv_bfloat16>(q, k, v, o, dout, l, dl, dq, dk, dv, B, S, H, KV, D, qs, ks,
                                     vs, os, dos, dqs, dks, dvs, sm_scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
