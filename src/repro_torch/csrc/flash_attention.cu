// Flash attention, forward and backward, causal or not, with GQA, on the
// (B, S, H, D) layout.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_flash_kernel / flash_attention_kernel), whose grid walks the KV blocks of
// one query block in order and carries (m, l, acc) across grid steps in VMEM.
// The backward has no TPU kernel (the reference differentiates its jnp
// attention with XLA); it is two kernels here, dQ and then dK/dV.
//
// Which kernel takes which type. bf16 goes to the tensor-core kernels
// (flash_fwd_mma_kernel, flash_bwd_dq_mma_kernel, flash_bwd_dkdv_mma_kernel);
// f32 goes to the scalar kernels (flash_fwd_kernel, flash_bwd_dq_kernel,
// flash_bwd_dkdv_kernel). This is a choice by type, not a fallback: an f32
// product on the tensor cores is TF32, which keeps about three decimal
// digits, and the f32 path is what the card-against-CPU checks hold to
// 2e-5..1e-4. The C entry points pick by dtype; neither route catches the
// other's failure.
//
// Bound on the card. Forward: the operations (4 * D per attended (query,
// key) pair, at the bf16 tensor-core rate for bf16) or the bytes (q, k, v
// read once, out written once), whichever is larger; at the training shape
// (2, 2048, 16/8, 128) and at prompts above ~900 tokens the operations.
// Backward: 2.5 times the forward's operations (five (query, key, D)
// products against two), or the bytes (q, k, v, o, dO read once; dq, dk, dv
// written once).
//
// The tensor-core kernels (FlashAttention-2's shape on mma.sync):
// - One block of 4 warps per (64-row tile, head, batch); each warp owns 16
//   rows. The Pallas grid's sequential KV axis becomes a loop inside the
//   block, which stops at the diagonal when causal; the blocks with the
//   most tiles to walk launch first.
// - Every product is mma.sync.m16n8k16 with bf16 operands and f32
//   accumulators. Operands come from shared memory by ldmatrix (.trans
//   where a product contracts over the tile's rows). A product's result is
//   reused in registers as the next product's A operand (P for P V, dS for
//   dS K), so P and dS are rounded to bf16 there: the one rounding that the
//   Pallas kernel (f32 P times f32 V) does not have. Softmax, lse and Delta
//   stay f32.
// - Tiles travel by cp.async, 16 bytes a thread, in a 2-stage ring: tile
//   n + 1 loads while tile n computes. K and V have buffers of their own,
//   so the scores start as soon as K has landed. Rows at or past S and
//   columns at or past D arrive as zeros (cp.async's source size). Shared
//   rows are padded by 16 bytes, so the 8 rows that one ldmatrix phase reads
//   fall in 8 distinct bank groups.
// - A template on the padded head width kD in {64, 128, 256}: a smaller D
//   is zero-padded in shared memory (D = 48 to 64, D = 192 to 256); its
//   padding columns multiply as zeros (the loops stay free of branches) and
//   are never stored. Where a 16-byte copy cannot be used (D not a multiple
//   of 8, or a base or stride not 16-byte aligned), the same kernels stage
//   with 2-byte loads (kVec = false), as the C entry point picks from the
//   arguments.
// - Forward: Q is staged through K's second buffer (free until the first
//   prefetch) and stays in registers as A fragments, so a block takes 4
//   tiles of shared memory (69.6 KB at kD = 128) and 3 blocks fit an SM.
//   At kD = 256, O's accumulators alone are 128 f32 registers a thread: Q
//   keeps a fifth tile (169 KB in all) and is read from it at each k-step,
//   and one block runs an SM.
//   S = Q K^T; the online softmax runs on the accumulators (row max and sum
//   across each quad by shuffles, exp2 with log2(e) folded into one FMA);
//   O += P V. Only the diagonal tile and a tile that reaches past S mask,
//   with -1e30; l is clamped at 1e-30; lse = m + log(l) is written only
//   when asked.
// - dQ: Delta = rowsum(dO * O) first, written out for dK/dV; then per key
//   tile S = Q K^T, dP = dO V^T, P = exp(S * scale - lse), dS = P (dP -
//   Delta), dQ += dS K.
// - dK/dV: one block per (64-key tile, KV head, batch) with K and V
//   resident. It walks the KV group's query heads and, for each, the query
//   tiles from the diagonal on, with Q, dO, lse and Delta double-buffered:
//   S^T = K Q^T, P^T, dV += P^T dO, dP^T = V dO^T, dS^T, dK += dS^T Q, 32
//   queries at a time, so that dK and dV (128 f32 registers a thread at
//   kD = 128) leave room for the rest. Summing the group inside the block
//   gives GQA's dK and dV without atomics: no kernel here uses a float
//   atomic, so equal inputs give bit-equal gradients. At kD = 256 dK plus
//   dV would be 256 registers a thread, so a grid axis splits their columns
//   in halves: each half recomputes S^T and dP^T over all of D and keeps
//   dK and dV for its 128 columns (dkdv_cols).
//
// The f32 scalar kernels: one block of 256 threads per (64-row tile, head,
// batch); tiles staged in shared memory in f32 with D + 1 columns, so the
// column walks hit distinct banks; each thread owns 4 rows and up to 8
// output columns (16 for D past 128: the width template kDW = 256); scalar
// f32 FMAs. The same loops, masks and clamps as above. At kDW = 256 the
// dK/dV kernel takes 32 keys a block (206 KB of tiles at D = 256).
//
// Past D = 256, both types go to the wide-D kernels (flash_fwd_wide_kernel,
// flash_bwd_delta_kernel, flash_bwd_dq_wide_kernel,
// flash_bwd_dkdv_wide_kernel; their section says how), so D may be anything.
//
// Every kernel reads and writes q, k, v, o, dO, dq, dk and dv through their
// (batch, seq, head) strides with unit stride along D: the caller needs no
// transpose and no padding copy. Query head h
// reads KV head h / (H / KV). lse and Delta are f32 (B, H, S), contiguous.
#include <initializer_list>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;  // == kBlockQ: the forward's and dQ's causal loops rely on it
constexpr int kThreads = 256;  // 16 x 16
constexpr int kMaxD = 256;     // the widest D the tile kernels take; past it, the wide-D kernels
constexpr float kNegInf = -1e30f;

// Keys per block of the scalar dK/dV kernel: 64, or 32 at kDW = 256, where
// four 64-row f32 tiles of 257 columns (263 KB) would not fit 227 KB.
__host__ __device__ constexpr int dkdv_rows(int dw) { return dw > 128 ? 32 : 64; }

struct Strides {
  int64_t b, s, h;
};

// Stage rows [s0, s0 + kRowsT) of one head (row stride `rs`) into `tile` as
// f32 with row stride `ld`; rows at or past S become zeros. Thread t handles
// column t % kDW of rows t / kDW + kStep i, so a warp reads 32 neighbouring
// elements of one row. Loads go out in batches of kBatch before their
// stores, so a thread waits for kRows / kBatch round trips, not kRows.
template <typename T, int kDW, int kRowsT>
__device__ __forceinline__ void stage_tile(float* __restrict__ tile, int ld,
                                           const T* __restrict__ base, int64_t rs, int s0,
                                           int S, int D, int tid) {
  constexpr int kStep = kThreads / kDW;  // rows one pass covers: 2 at kDW = 128, 1 at 256
  constexpr int kRows = kRowsT / kStep;  // rows per thread
  constexpr int kBatch = 8;
  const int c = tid % kDW;
  const int r0 = tid / kDW;
  if (c >= D) return;
#pragma unroll
  for (int b = 0; b < kRows; b += kBatch) {
    float vals[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int s = s0 + r0 + kStep * (b + i);
      vals[i] = s < S ? repro::to_f32(base[s * rs + c]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) tile[(r0 + kStep * (b + i)) * ld + c] = vals[i];
  }
}

template <typename T, int kDW>
__global__ void __launch_bounds__(kThreads, kDW > 128 ? 1 : 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int S, int H, int KV, int D,
                 Strides qs, Strides ks, Strides vs, Strides os, float sm_scale, int causal) {
  constexpr int kDPer = kDW / 16;  // output columns per thread
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

  stage_tile<T, kDW, kBlockQ>(q_tile, ld, qb, qs.s, q0, S, D, tid);

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
    stage_tile<T, kDW, kBlockQ>(kv_tile, ld, kb, ks.s, k0, S, D, tid);
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

    stage_tile<T, kDW, kBlockQ>(kv_tile, ld, vb, vs.s, k0, S, D, tid);
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
template <typename T, int kDW>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ o, const T* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta, T* __restrict__ dq,
                    int S, int H, int KV, int D, Strides qs, Strides ks, Strides vs, Strides os,
                    Strides dos, Strides dqs, float sm_scale, int causal) {
  constexpr int kDPer = kDW / 16;
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
  stage_tile<T, kDW, kBlockQ>(q_tile, ld, q + b * qs.b + h * qs.h, qs.s, q0, S, D, tid);
  stage_tile<T, kDW, kBlockQ>(do_tile, ld, dout + b * dos.b + h * dos.h, dos.s, q0, S, D, tid);
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
    stage_tile<T, kDW, kBlockQ>(kv_tile, ld, vb, vs.s, k0, S, D, tid);
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
    stage_tile<T, kDW, kBlockQ>(kv_tile, ld, kb, ks.s, k0, S, D, tid);
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
// header. Shared memory: K and V tiles of kBK keys, Q and dO tiles, one
// tile that holds P^T and then dS^T, and the query tile's lse and Delta, all
// f32.
template <typename T, int kDW>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                      int S, int H, int KV, int D, Strides qs, Strides ks, Strides vs,
                      Strides dos, Strides dks, Strides dvs, float sm_scale, int causal) {
  constexpr int kDPer = kDW / 16;
  constexpr int kBK = dkdv_rows(kDW);  // keys per block
  constexpr int kA = kBK / 16;         // key rows per thread
  extern __shared__ float smem[];
  const int ld = D + 1;
  constexpr int ldp = kBlockQ + 1;
  float* k_tile = smem;                     // kBK x ld
  float* v_tile = k_tile + kBK * ld;        // kBK x ld
  float* q_tile = v_tile + kBK * ld;        // kBlockQ x ld
  float* do_tile = q_tile + kBlockQ * ld;   // kBlockQ x ld
  float* pt_tile = do_tile + kBlockQ * ld;  // kBK x ldp: P^T, then dS^T
  float* stat = pt_tile + kBK * ldp;        // lse[kBlockQ], Delta[kBlockQ]

  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int group = H / KV;
  const int k0 = kt * kBK;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  stage_tile<T, kDW, kBK>(k_tile, ld, k + b * ks.b + kvh * ks.h, ks.s, k0, S, D, tid);
  stage_tile<T, kDW, kBK>(v_tile, ld, v + b * vs.b + kvh * vs.h, vs.s, k0, S, D, tid);

  // rows are keys k0 + ty + 16 a, columns are D columns tx + 16 j
  float dk_acc[kA][kDPer], dv_acc[kA][kDPer];
#pragma unroll
  for (int a = 0; a < kA; ++a)
#pragma unroll
    for (int j = 0; j < kDPer; ++j) dk_acc[a][j] = dv_acc[a][j] = 0.f;

  const int n_tiles = (S + kBlockQ - 1) / kBlockQ;
  const int qt0 = causal ? k0 / kBlockQ : 0;
  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const int64_t row_base = (static_cast<int64_t>(b) * H + h) * S;
    const T* qb = q + b * qs.b + h * qs.h;
    const T* dob = dout + b * dos.b + h * dos.h;
    for (int qt = qt0; qt < n_tiles; ++qt) {
      const int q0 = qt * kBlockQ;
      __syncthreads();  // the last query tile and dS^T are read by everyone
      stage_tile<T, kDW, kBlockQ>(q_tile, ld, qb, qs.s, q0, S, D, tid);
      stage_tile<T, kDW, kBlockQ>(do_tile, ld, dob, dos.s, q0, S, D, tid);
      if (tid < kBlockQ) {
        const int qpos = q0 + tid;
        stat[tid] = qpos < S ? lse[row_base + qpos] : 0.f;
        stat[kBlockQ + tid] = qpos < S ? delta[row_base + qpos] : 0.f;
      }
      __syncthreads();
      // S^T and dP^T: rows keys ty + 16 a, columns queries tx + 16 c
      float st[kA][4], dpt[kA][4];
#pragma unroll
      for (int a = 0; a < kA; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) st[a][c] = dpt[a][c] = 0.f;
      for (int dd = 0; dd < D; ++dd) {
        float kr[kA], vr[kA], qc[4], oc[4];
#pragma unroll
        for (int a = 0; a < kA; ++a) {
          kr[a] = k_tile[(ty + 16 * a) * ld + dd];
          vr[a] = v_tile[(ty + 16 * a) * ld + dd];
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          qc[c] = q_tile[(tx + 16 * c) * ld + dd];
          oc[c] = do_tile[(tx + 16 * c) * ld + dd];
        }
#pragma unroll
        for (int a = 0; a < kA; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            st[a][c] = fmaf(kr[a], qc[c], st[a][c]);
            dpt[a][c] = fmaf(vr[a], oc[c], dpt[a][c]);
          }
      }
#pragma unroll
      for (int a = 0; a < kA; ++a) {
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
        float pv[kA], ov[kDPer];
#pragma unroll
        for (int a = 0; a < kA; ++a) pv[a] = pt_tile[(ty + 16 * a) * ldp + qq];
#pragma unroll
        for (int j = 0; j < kDPer; ++j) {
          const int c = tx + 16 * j;
          ov[j] = c < D ? do_tile[qq * ld + c] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < kA; ++a)
#pragma unroll
          for (int j = 0; j < kDPer; ++j) dv_acc[a][j] = fmaf(pv[a], ov[j], dv_acc[a][j]);
      }
      __syncthreads();  // P^T read by everyone
#pragma unroll
      for (int a = 0; a < kA; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) pt_tile[(ty + 16 * a) * ldp + tx + 16 * c] = dpt[a][c];
      __syncthreads();  // dS^T complete
      for (int qq = 0; qq < kBlockQ; ++qq) {
        float sv[kA], qv[kDPer];
#pragma unroll
        for (int a = 0; a < kA; ++a) sv[a] = pt_tile[(ty + 16 * a) * ldp + qq];
#pragma unroll
        for (int j = 0; j < kDPer; ++j) {
          const int c = tx + 16 * j;
          qv[j] = c < D ? q_tile[qq * ld + c] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < kA; ++a)
#pragma unroll
          for (int j = 0; j < kDPer; ++j) dk_acc[a][j] = fmaf(sv[a], qv[j], dk_acc[a][j]);
      }
    }
  }

  T* dkb = dk + b * dks.b + kvh * dks.h;
  T* dvb = dv + b * dvs.b + kvh * dvs.h;
#pragma unroll
  for (int a = 0; a < kA; ++a) {
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

// ---- bf16: the tensor-core kernels ------------------------------------------

constexpr int kTile = 64;         // query and key rows per tile
constexpr int kMmaThreads = 128;  // 4 warps of 16 rows
constexpr float kLog2e = 1.4426950408889634f;

// Output columns of dK/dV per block: all of kD up to 128. At kD = 256 half
// of them, the halves on a grid axis of their own: dK and dV together would
// be 256 f32 registers a thread. Each half computes S^T and dP^T over all of
// D again; no atomics, so the halves stay bit-equal on repeat. (dQ's 128
// accumulator registers at kD = 256 fit beside the rest without a spill.)
__host__ __device__ constexpr int dkdv_cols(int d) { return d > 128 ? 128 : d; }

template <int kD>
struct TileShape {
  static constexpr int kLd = kD + 8;           // row stride in shared memory: 16 bytes of padding
  static constexpr int kElems = kTile * kLd;   // one 64-row tile
  static constexpr int kBytes = kElems * 2;
};

// Stage rows [s0, s0 + 64) of one head (row stride rs) into a padded tile;
// rows at or past S and columns at or past D become zeros. kVec: 16-byte
// cp.async copies, one commit group for the caller to close; otherwise
// 2-byte loads and stores, visible after the caller's __syncthreads.
template <int kD, bool kVec>
__device__ __forceinline__ void load_tile(bf16* __restrict__ tile, const bf16* __restrict__ base,
                                          int64_t rs, int s0, int S, int D, int tid) {
  constexpr int kLd = TileShape<kD>::kLd;
  if constexpr (kVec) {
    // thread tid copies chunk tid % kChunks of rows tid / kChunks + kStep i:
    // one source pointer a thread, advanced by whole rows
    constexpr int kChunks = kD / 8;
    constexpr int kStep = kMmaThreads / kChunks;
    const int r = tid / kChunks, c = (tid % kChunks) * 8;
    const bf16* src = base + (s0 + r) * rs + c;
    bf16* dst = tile + r * kLd + c;
#pragma unroll
    for (int i = 0; i < kTile / kStep; ++i) {
      const bool ok = s0 + r + i * kStep < S && c < D;
      cp_async16(dst + i * kStep * kLd, ok ? src : base, ok ? 16 : 0);
      src += kStep * rs;
    }
  } else {
#pragma unroll 8
    for (int idx = tid; idx < kTile * kD; idx += kMmaThreads) {
      const int r = idx / kD, c = idx % kD;
      const int s = s0 + r;
      tile[r * kLd + c] = (s < S && c < D) ? base[s * rs + c] : __float2bfloat16_rn(0.f);
    }
  }
}

// Write two neighbouring columns c, c + 1 of one row.
template <bool kVec>
__device__ __forceinline__ void store_pair(bf16* row, int c, int D, float x0, float x1) {
  if constexpr (kVec) {
    if (c < D) *reinterpret_cast<__nv_bfloat162*>(row + c) = __floats2bfloat162_rn(x0, x1);
  } else {
    if (c < D) row[c] = __float2bfloat16_rn(x0);
    if (c + 1 < D) row[c + 1] = __float2bfloat16_rn(x1);
  }
}

template <int kD, bool kVec>
__global__ void __launch_bounds__(kMmaThreads, kD > 128 ? 1 : 3)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                     int S, int H, int KV, int D, Strides qs, Strides ks, Strides vs, Strides os,
                     float sm_scale, int causal) {
  constexpr int kLd = TileShape<kD>::kLd, kT = TileShape<kD>::kElems;
  constexpr int kKs = kD / 16;  // k-steps over D
  constexpr int kDn = kD / 8;   // 8-column tiles over D
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sk = reinterpret_cast<bf16*>(smem_raw);  // two stages
  bf16* sv = sk + 2 * kT;                        // two stages
  // Up to kD = 128, Q passes through K's second stage: it is read into
  // registers before the first prefetch writes there. At kD = 256 its
  // fragments would take 64 more registers a thread beside O's 128, so Q
  // keeps a tile of its own and each k-step reads it again.
  constexpr bool kQRegs = kD <= 128;
  bf16* sq = kQRegs ? sk + kT : sv + 2 * kT;

  const int n_tiles = (S + kTile - 1) / kTile;
  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = n_tiles - 1 - static_cast<int>(blockIdx.z);  // longest rows first
  const int kvh = h / (H / KV);
  const int q0 = qt * kTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0 and row0 + 8

  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + kvh * ks.h;
  const bf16* vb = v + b * vs.b + kvh * vs.h;
  const int n_kt = causal ? qt + 1 : n_tiles;

  load_tile<kD, kVec>(sq, qb, qs.s, q0, S, D, tid);
  load_tile<kD, kVec>(sk, kb, ks.s, 0, S, D, tid);
  cp_async_commit();
  load_tile<kD, kVec>(sv, vb, vs.s, 0, S, D, tid);
  cp_async_commit();

  const int a_off = a_offset(lane, kLd), b_off = b_offset(lane, kLd),
            bt_off = bt_offset(lane, kLd);
  cp_async_wait<1>();  // Q and the first K
  __syncthreads();
  uint32_t qf[kQRegs ? kKs : 1][4];
  if constexpr (kQRegs) {
#pragma unroll
    for (int kk = 0; kk < kKs; ++kk) ldsm_x4(qf[kk], sq + warp * 16 * kLd + a_off + kk * 16);
  }

  float acc[kDn][4];
#pragma unroll
  for (int dn = 0; dn < kDn; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float scale2 = sm_scale * kLog2e;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1;
    cp_async_wait<1>();  // this tile's K; its V may still be in flight
    __syncthreads();     // for every thread; and stage st ^ 1 is read by no one
    if (kt + 1 < n_kt) load_tile<kD, kVec>(sk + (st ^ 1) * kT, kb, ks.s, (kt + 1) * kTile, S, D, tid);
    cp_async_commit();
    if (kt + 1 < n_kt) load_tile<kD, kVec>(sv + (st ^ 1) * kT, vb, vs.s, (kt + 1) * kTile, S, D, tid);
    cp_async_commit();

    // S = Q K^T: 16 rows x 64 keys per warp
    const bf16* kst = sk + st * kT;
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKs; ++kk) {
      uint32_t qa[4];
      if constexpr (kQRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e];
      } else {
        ldsm_x4(qa, sq + warp * 16 * kLd + a_off + kk * 16);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bf[4];
        ldsm_x4(bf, kst + np * 16 * kLd + b_off + kk * 16);
        mma_bf16(s[2 * np], qa, bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], qa, bf[2], bf[3]);
      }
    }

    // mask the diagonal tile and keys past S (on the unscaled scores)
    const int k0 = kt * kTile;
    if ((causal && kt == qt) || k0 + kTile > S) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + j * 8 + 2 * t + (e & 1);
          const int row = row0 + (e >> 1) * 8;
          if (key >= S || (causal && key > row)) s[j][e] = kNegInf;
        }
    }

    // online softmax: a row's 64 scores live in the 4 lanes of a quad; m is
    // kept unscaled, and exp2's argument is one FMA
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float alpha = exp2f((m[r] - mx) * scale2);
      const float mx2 = mx * scale2;
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const float p = exp2f(fmaf(s[j][e], scale2, -mx2));
          s[j][e] = p;
          ps += p;
        }
      l[r] = l[r] * alpha + ps;  // this lane's part; the quad's sum is taken at the end
      m[r] = mx;
#pragma unroll
      for (int dn = 0; dn < kDn; ++dn) {
        acc[dn][2 * r] *= alpha;
        acc[dn][2 * r + 1] *= alpha;
      }
    }

    // O += P V, P rounded to bf16 in registers
    cp_async_wait<2>();  // this tile's V
    __syncthreads();
    const bf16* vst = sv + st * kT;
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t pa[4];
      acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < kD / 16; ++dp) {
        uint32_t bf[4];
        ldsm_x4_t(bf, vst + kk * 16 * kLd + bt_off + dp * 16);
        mma_bf16(acc[2 * dp], pa, bf[0], bf[1]);
        mma_bf16(acc[2 * dp + 1], pa, bf[2], bf[3]);
      }
    }
  }

  bf16* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int row = row0 + r * 8;
    if (row >= S) continue;
    const float li = fmaxf(lr, 1e-30f);
    bf16* orow = ob + row * os.s;
#pragma unroll
    for (int dn = 0; dn < kDn; ++dn)
      store_pair<kVec>(orow, dn * 8 + 2 * t, D, acc[dn][2 * r] / li, acc[dn][2 * r + 1] / li);
    if (lse != nullptr && t == 0)
      lse[(static_cast<int64_t>(b) * H + h) * S + row] = m[r] * sm_scale + logf(li);
  }
}

// dQ and Delta; see the header. Shared memory: Q, dO, two stages of K and of
// V, and the tile's Delta.
template <int kD, bool kVec>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ o,
                        const bf16* __restrict__ dout, const float* __restrict__ lse,
                        float* __restrict__ delta, bf16* __restrict__ dq, int S, int H, int KV,
                        int D, Strides qs, Strides ks, Strides vs, Strides os, Strides dos,
                        Strides dqs, float sm_scale, int causal) {
  constexpr int kLd = TileShape<kD>::kLd, kT = TileShape<kD>::kElems;
  constexpr int kKs = kD / 16, kDn = kD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdo = sq + kT;
  bf16* sk = sdo + kT;     // two stages
  bf16* sv = sk + 2 * kT;  // two stages
  float* sdelta = reinterpret_cast<float*>(sv + 2 * kT);  // kTile

  const int n_tiles = (S + kTile - 1) / kTile;
  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = n_tiles - 1 - static_cast<int>(blockIdx.z);
  const int kvh = h / (H / KV);
  const int q0 = qt * kTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16 + g;
  const int64_t row_base = (static_cast<int64_t>(b) * H + h) * S;

  const bf16* kb = k + b * ks.b + kvh * ks.h;
  const bf16* vb = v + b * vs.b + kvh * vs.h;
  const int n_kt = causal ? qt + 1 : n_tiles;

  load_tile<kD, kVec>(sq, q + b * qs.b + h * qs.h, qs.s, q0, S, D, tid);
  load_tile<kD, kVec>(sdo, dout + b * dos.b + h * dos.h, dos.s, q0, S, D, tid);
  load_tile<kD, kVec>(sk, kb, ks.s, 0, S, D, tid);
  cp_async_commit();
  load_tile<kD, kVec>(sv, vb, vs.s, 0, S, D, tid);
  cp_async_commit();
  cp_async_wait<1>();  // Q, dO and the first K
  __syncthreads();

  // Delta = rowsum(dO * O): two threads per row, half of the columns each
  {
    const int r = tid >> 1, half = tid & 1;
    const int row = q0 + r;
    float part = 0.f;
    if (row < S) {
      const bf16* orow = o + b * os.b + h * os.h + row * os.s;
      const bf16* drow = sdo + r * kLd;
      const int c_end = min((half + 1) * (kD / 2), D);
      if constexpr (kVec) {
        for (int c = half * (kD / 2); c < c_end; c += 8) {
          const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
          const uint4 dv = *reinterpret_cast<const uint4*>(drow + c);
          const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
          const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float2 of = __bfloat1622float2(o2[i]), df = __bfloat1622float2(d2[i]);
            part += df.x * of.x;
            part += df.y * of.y;
          }
        }
      } else {
        for (int c = half * (kD / 2); c < c_end; ++c)
          part += __bfloat162float(drow[c]) * __bfloat162float(orow[c]);
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if (half == 0) {
      sdelta[r] = part;
      if (row < S) delta[row_base + row] = part;
    }
  }
  __syncthreads();

  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    lse2[r] = row < S ? lse[row_base + row] * kLog2e : 0.f;
    dl[r] = sdelta[warp * 16 + g + r * 8];
  }

  const int a_off = a_offset(lane, kLd), b_off = b_offset(lane, kLd),
            bt_off = bt_offset(lane, kLd);
  const float scale2 = sm_scale * kLog2e;
  float dqa[kDn][4];
#pragma unroll
  for (int dn = 0; dn < kDn; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[dn][e] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1;
    cp_async_wait<1>();
    __syncthreads();
    if (kt + 1 < n_kt) load_tile<kD, kVec>(sk + (st ^ 1) * kT, kb, ks.s, (kt + 1) * kTile, S, D, tid);
    cp_async_commit();
    if (kt + 1 < n_kt) load_tile<kD, kVec>(sv + (st ^ 1) * kT, vb, vs.s, (kt + 1) * kTile, S, D, tid);
    cp_async_commit();
    const bf16* kst = sk + st * kT;
    const bf16* vst = sv + st * kT;

    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKs; ++kk) {  // S = Q K^T
      uint32_t af[4];
      ldsm_x4(af, sq + warp * 16 * kLd + a_off + kk * 16);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bf[4];
        ldsm_x4(bf, kst + np * 16 * kLd + b_off + kk * 16);
        mma_bf16(s[2 * np], af, bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], af, bf[2], bf[3]);
      }
    }
    cp_async_wait<2>();  // this tile's V
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKs; ++kk) {  // dP = dO V^T
      uint32_t af[4];
      ldsm_x4(af, sdo + warp * 16 * kLd + a_off + kk * 16);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bf[4];
        ldsm_x4(bf, vst + np * 16 * kLd + b_off + kk * 16);
        mma_bf16(dp[2 * np], af, bf[0], bf[1]);
        mma_bf16(dp[2 * np + 1], af, bf[2], bf[3]);
      }
    }

    // P = exp(S scale - lse), 0 where masked; dS = P (dP - Delta), in s
    const int k0 = kt * kTile;
    const bool edge = (causal && kt == qt) || k0 + kTile > S || q0 + kTile > S;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = exp2f(s[j][e] * scale2 - lse2[r]);
        if (edge) {
          const int key = k0 + j * 8 + 2 * t + (e & 1);
          const int row = row0 + r * 8;
          if (row >= S || key >= S || (causal && key > row)) p = 0.f;
        }
        s[j][e] = p * (dp[j][e] - dl[r]);
      }

#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {  // dQ += dS K, dS rounded to bf16
      uint32_t da[4];
      acc_to_a(da, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dp2 = 0; dp2 < kD / 16; ++dp2) {
        uint32_t bf[4];
        ldsm_x4_t(bf, kst + kk * 16 * kLd + bt_off + dp2 * 16);
        mma_bf16(dqa[2 * dp2], da, bf[0], bf[1]);
        mma_bf16(dqa[2 * dp2 + 1], da, bf[2], bf[3]);
      }
    }
  }

  bf16* dqb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= S) continue;
    bf16* drow = dqb + row * dqs.s;
#pragma unroll
    for (int dn = 0; dn < kDn; ++dn)
      store_pair<kVec>(drow, dn * 8 + 2 * t, D, dqa[dn][2 * r] * sm_scale,
                       dqa[dn][2 * r + 1] * sm_scale);
  }
}

// dK and dV of one key tile, summed over the KV group's query heads; see the
// header. Shared memory: K, V, two stages of Q, dO, lse and Delta.
template <int kD, bool kVec>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int H, int KV, int D,
                          Strides qs, Strides ks, Strides vs, Strides dos, Strides dks,
                          Strides dvs, float sm_scale, int causal) {
  constexpr int kLd = TileShape<kD>::kLd, kT = TileShape<kD>::kElems;
  constexpr int kDo = dkdv_cols(kD);  // output columns of this block
  constexpr int kKs = kD / 16, kDn = kDo / 8;
  constexpr int kSub = 32;  // queries per pass over a tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sk = reinterpret_cast<bf16*>(smem_raw);
  bf16* sv = sk + kT;
  bf16* sq = sv + kT;       // two stages
  bf16* sdo = sq + 2 * kT;  // two stages
  float* slse = reinterpret_cast<float*>(sdo + 2 * kT);  // two stages of kTile
  float* sdl = slse + 2 * kTile;                          // two stages of kTile

  const int n_tiles = (S + kTile - 1) / kTile;
  const int kvh = blockIdx.x / (kD / kDo), b = blockIdx.y;
  const int d0 = (blockIdx.x % (kD / kDo)) * kDo;
  const int kt = blockIdx.z;  // causal: the first key tiles have the most query tiles
  const int group = H / KV;
  const int k0 = kt * kTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int key0 = k0 + warp * 16 + g;  // this thread's keys: key0 and key0 + 8
  const int qt0 = causal ? kt : 0;
  const int per_head = n_tiles - qt0;
  const int n_it = group * per_head;

  // stage the it-th (query head, query tile) of the walk
  auto load_q = [&](int it, int st) {
    const int hh = kvh * group + it / per_head;
    const int qq0 = (qt0 + it % per_head) * kTile;
    load_tile<kD, kVec>(sq + st * kT, q + b * qs.b + hh * qs.h, qs.s, qq0, S, D, tid);
    load_tile<kD, kVec>(sdo + st * kT, dout + b * dos.b + hh * dos.h, dos.s, qq0, S, D, tid);
    const int i = tid & (kTile - 1);
    const int row = qq0 + i;
    const bool ok = row < S;
    const int64_t at = (static_cast<int64_t>(b) * H + hh) * S + (ok ? row : 0);
    if (tid < kTile)
      cp_async4(slse + st * kTile + i, lse + at, ok ? 4 : 0);
    else
      cp_async4(sdl + st * kTile + i, delta + at, ok ? 4 : 0);
  };

  load_tile<kD, kVec>(sk, k + b * ks.b + kvh * ks.h, ks.s, k0, S, D, tid);
  load_tile<kD, kVec>(sv, v + b * vs.b + kvh * vs.h, vs.s, k0, S, D, tid);
  load_q(0, 0);
  cp_async_commit();

  const int a_off = a_offset(lane, kLd), b_off = b_offset(lane, kLd),
            bt_off = bt_offset(lane, kLd);
  const float scale2 = sm_scale * kLog2e;
  float dka[kDn][4], dva[kDn][4];
#pragma unroll
  for (int dn = 0; dn < kDn; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[dn][e] = dva[dn][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    cp_async_wait<0>();
    __syncthreads();  // this tile has landed for everyone; stage st ^ 1 is read by no one
    if (it + 1 < n_it) load_q(it + 1, st ^ 1);
    cp_async_commit();
    const int qt = qt0 + it % per_head;
    const int q0 = qt * kTile;
    const bool edge = (causal && qt == kt) || q0 + kTile > S || k0 + kTile > S;
    const bf16* qst = sq + st * kT;
    const bf16* dost = sdo + st * kT;
    const float* lst = slse + st * kTile;
    const float* dlst = sdl + st * kTile;

#pragma unroll 1
    for (int c0 = 0; c0 < kTile; c0 += kSub) {
      // S^T = K Q^T: 16 keys x 32 queries per warp
      float s[kSub / 8][4];
#pragma unroll
      for (int j = 0; j < kSub / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKs; ++kk) {
        uint32_t af[4];
        ldsm_x4(af, sk + warp * 16 * kLd + a_off + kk * 16);
#pragma unroll
        for (int np = 0; np < kSub / 16; ++np) {
          uint32_t bf[4];
          ldsm_x4(bf, qst + (c0 + np * 16) * kLd + b_off + kk * 16);
          mma_bf16(s[2 * np], af, bf[0], bf[1]);
          mma_bf16(s[2 * np + 1], af, bf[2], bf[3]);
        }
      }
      // P^T = exp(S^T scale - lse), 0 where masked
#pragma unroll
      for (int j = 0; j < kSub / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + j * 8 + 2 * t + (e & 1);  // query within the tile
          float p = exp2f(s[j][e] * scale2 - lst[col] * kLog2e);
          if (edge) {
            const int key = key0 + (e >> 1) * 8;
            const int qrow = q0 + col;
            if (qrow >= S || key >= S || (causal && key > qrow)) p = 0.f;
          }
          s[j][e] = p;
        }
      // dV += P^T dO, P rounded to bf16
#pragma unroll
      for (int kk = 0; kk < kSub / 16; ++kk) {
        uint32_t pa[4];
        acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int dp = 0; dp < kDo / 16; ++dp) {
          uint32_t bf[4];
          ldsm_x4_t(bf, dost + (c0 + kk * 16) * kLd + bt_off + d0 + dp * 16);
          mma_bf16(dva[2 * dp], pa, bf[0], bf[1]);
          mma_bf16(dva[2 * dp + 1], pa, bf[2], bf[3]);
        }
      }
      // dP^T = V dO^T
      float dpt[kSub / 8][4];
#pragma unroll
      for (int j = 0; j < kSub / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dpt[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKs; ++kk) {
        uint32_t af[4];
        ldsm_x4(af, sv + warp * 16 * kLd + a_off + kk * 16);
#pragma unroll
        for (int np = 0; np < kSub / 16; ++np) {
          uint32_t bf[4];
          ldsm_x4(bf, dost + (c0 + np * 16) * kLd + b_off + kk * 16);
          mma_bf16(dpt[2 * np], af, bf[0], bf[1]);
          mma_bf16(dpt[2 * np + 1], af, bf[2], bf[3]);
        }
      }
      // dS^T = P^T (dP^T - Delta), in s
#pragma unroll
      for (int j = 0; j < kSub / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= dpt[j][e] - dlst[c0 + j * 8 + 2 * t + (e & 1)];
      // dK += dS^T Q, dS rounded to bf16
#pragma unroll
      for (int kk = 0; kk < kSub / 16; ++kk) {
        uint32_t da[4];
        acc_to_a(da, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int dp = 0; dp < kDo / 16; ++dp) {
          uint32_t bf[4];
          ldsm_x4_t(bf, qst + (c0 + kk * 16) * kLd + bt_off + d0 + dp * 16);
          mma_bf16(dka[2 * dp], da, bf[0], bf[1]);
          mma_bf16(dka[2 * dp + 1], da, bf[2], bf[3]);
        }
      }
    }
  }

  bf16* dkb = dk + b * dks.b + kvh * dks.h;
  bf16* dvb = dv + b * dvs.b + kvh * dvs.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + r * 8;
    if (key >= S) continue;
#pragma unroll
    for (int dn = 0; dn < kDn; ++dn) {
      const int c = d0 + dn * 8 + 2 * t;
      store_pair<kVec>(dkb + key * dks.s, c, D, dka[dn][2 * r] * sm_scale,
                       dka[dn][2 * r + 1] * sm_scale);
      store_pair<kVec>(dvb + key * dvs.s, c, D, dva[dn][2 * r], dva[dn][2 * r + 1]);
    }
  }
}

// ---- the wide-D kernels (D > kMaxD), f32 and bf16 ----------------------------
//
// One block of 256 threads per (64-row tile, head, batch, 64-column slice of
// the output): the scores, and in the backward dP = dO V^T, are summed over
// D in 64-column slices staged in shared memory as f32, so shared memory is
// bounded (four to six 64 x 65 f32 tiles) whatever D is; the block keeps
// only its slice's columns of O, dQ, dK or dV. Each block recomputes the
// scores over all of D, D / 64 times in all: a simple design for a width no
// configuration of the repo runs. Scalar f32 FMAs in both types (each thread
// 4 x 4 of a 64 x 64 product), the forward's online softmax and the
// backward's P = exp(S * scale - lse), dS = P (dP - Delta) as the scalar
// kernels above have them; Delta = rowsum(dO * O) first, by its own small
// kernel. No float atomics: dK and dV sum the group's query heads inside
// the block, so the backward repeats bit for bit.

constexpr int kWide = 64;          // D columns a slice
constexpr int kWLd = kWide + 1;    // f32 row stride of a slice tile
constexpr int kWTile = kBlockQ * kWLd;

__host__ __device__ constexpr int wide_slices(int D) { return (D + kWide - 1) / kWide; }

// Rows [s0, s0 + 64) and columns [c0, c0 + 64) of one head (row stride rs)
// as f32, zeros past S and D. Thread t takes column t % 64 of rows t / 64 +
// 4 i; its 16 loads go out 8 at a time.
template <typename T>
__device__ __forceinline__ void stage_slice(float* __restrict__ tile, const T* __restrict__ base,
                                            int64_t rs, int s0, int S, int c0, int D, int tid) {
  const int c = tid & 63, r0 = tid >> 6;
  const bool col = c0 + c < D;
#pragma unroll
  for (int b = 0; b < kBlockQ / 4; b += 8) {
    float vals[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int s = s0 + r0 + 4 * (b + i);
      vals[i] = col && s < S ? repro::to_f32(base[s * rs + c0 + c]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) tile[(r0 + 4 * (b + i)) * kWLd + c] = vals[i];
  }
}

// acc[i][j] += sum_d a[(ty + 16 i)][d] b[(tx + 16 j)][d] over one slice
__device__ __forceinline__ void slice_dot(float (&acc)[4][4], const float* __restrict__ a,
                                          const float* __restrict__ b, int ty, int tx) {
#pragma unroll 8
  for (int d = 0; d < kWide; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * kWLd + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * kWLd + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc[i][j] += sum_k p[(ty + 16 i)][k] v[k][(tx + 16 j)]: rows of p times a slice
__device__ __forceinline__ void slice_pv(float (&acc)[4][4], const float* __restrict__ p,
                                         const float* __restrict__ v, int ty, int tx) {
#pragma unroll 8
  for (int k = 0; k < kWide; ++k) {
    float pv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = p[(ty + 16 * i) * kWLd + k];
#pragma unroll
    for (int j = 0; j < 4; ++j) vv[j] = v[k * kWLd + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
  }
}

// acc[i][j] += sum_q p[q][(ty + 16 i)] v[q][(tx + 16 j)]: columns of p times a slice
__device__ __forceinline__ void slice_ptv(float (&acc)[4][4], const float* __restrict__ p,
                                          const float* __restrict__ v, int ty, int tx) {
#pragma unroll 8
  for (int q = 0; q < kWide; ++q) {
    float pv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = p[q * kWLd + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) vv[j] = v[q * kWLd + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero44(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// S = Q K^T and, with dO and V, dP = dO V^T, summed over every slice of D:
// rows ty + 16 i of the query tile q0, keys tx + 16 j of the key tile k0
template <typename T, bool kDP>
__device__ __forceinline__ void wide_scores(float (&sc)[4][4], float (&dp)[4][4], float* t_q,
                                            float* t_k, float* t_do, float* t_v, const T* qb,
                                            const T* kb, const T* dob, const T* vb, int64_t q_rs,
                                            int64_t k_rs, int64_t do_rs, int64_t v_rs, int q0,
                                            int k0, int S, int D, int tid, int ty, int tx) {
  zero44(sc);
  if constexpr (kDP) zero44(dp);
  for (int d0 = 0; d0 < D; d0 += kWide) {
    __syncthreads();  // the last slices read by everyone
    stage_slice<T>(t_q, qb, q_rs, q0, S, d0, D, tid);
    stage_slice<T>(t_k, kb, k_rs, k0, S, d0, D, tid);
    if constexpr (kDP) {
      stage_slice<T>(t_do, dob, do_rs, q0, S, d0, D, tid);
      stage_slice<T>(t_v, vb, v_rs, k0, S, d0, D, tid);
    }
    __syncthreads();
    slice_dot(sc, t_q, t_k, ty, tx);
    if constexpr (kDP) slice_dot(dp, t_do, t_v, ty, tx);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      T* __restrict__ o, float* __restrict__ lse, int S, int H, int KV, int D,
                      Strides qs, Strides ks, Strides vs, Strides os, float sm_scale, int causal) {
  extern __shared__ float smem[];
  float* t_q = smem;            // a slice of Q
  float* t_kv = t_q + kWTile;   // a slice of K, then the output slice of V
  float* t_p = t_kv + kWTile;   // P

  const int nds = wide_slices(D);
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z / nds, c0 = (blockIdx.z % nds) * kWide;
  const int kvh = h / (H / KV);
  const int q0 = qt * kBlockQ;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;

  float m[4], l[4], acc[4][4], sc[4][4], unused[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  zero44(acc);
  const int n_tiles = (S + kBlockK - 1) / kBlockK;
  const int n_kt = causal ? min(n_tiles, qt + 1) : n_tiles;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBlockK;
    wide_scores<T, false>(sc, unused, t_q, t_kv, nullptr, nullptr, qb, kb, nullptr, nullptr, qs.s,
                          ks.s, 0, 0, q0, k0, S, D, tid, ty, tx);
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
        t_p[(ty + 16 * i) * kWLd + tx + 16 * j] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + psum;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();  // P complete; the K slice read by everyone
    stage_slice<T>(t_kv, vb, vs.s, k0, S, c0, D, tid);
    __syncthreads();
    slice_pv(acc, t_p, t_kv, ty, tx);
  }

  T* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= S) continue;
    const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c < D) ob[qpos * os.s + c] = repro::from_f32<T>(acc[i][j] / li);
    }
    if (lse != nullptr && c0 == 0 && tx == 0)
      lse[(static_cast<int64_t>(b) * H + h) * S + qpos] = m[i] + logf(li);
  }
}

// Delta = rowsum(dO * O), one warp a row: each lane's columns in order, then
// a shuffle tree
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, int S, int H, int D, Strides os, Strides dos) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s = blockIdx.x * (kThreads / 32) + warp, h = blockIdx.y, b = blockIdx.z;
  if (s >= S) return;
  const T* orow = o + b * os.b + h * os.h + s * os.s;
  const T* drow = dout + b * dos.b + h * dos.h + s * dos.s;
  float sum = 0.f;
  for (int c = lane; c < D; c += 32) sum = fmaf(repro::to_f32(drow[c]), repro::to_f32(orow[c]), sum);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) delta[(static_cast<int64_t>(b) * H + h) * S + s] = sum;
}

// P and dS of one (query tile, key tile) from S and dP (rows ty + 16 i,
// keys tx + 16 j), into t_p and t_ds; 0 past S and above the diagonal
__device__ __forceinline__ void wide_p_ds(const float (&sc)[4][4], const float (&dp)[4][4],
                                          const float (&lse_r)[4], const float (&delta_r)[4],
                                          float* t_p, float* t_ds, int q0, int k0, int S,
                                          float sm_scale, int causal, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kpos = k0 + tx + 16 * j;
      const bool live = qpos < S && kpos < S && !(causal && kpos > qpos);
      const float p = live ? expf(sc[i][j] * sm_scale - lse_r[i]) : 0.f;
      t_p[(ty + 16 * i) * kWLd + tx + 16 * j] = p;
      t_ds[(ty + 16 * i) * kWLd + tx + 16 * j] = p * (dp[i][j] - delta_r[i]);
    }
  }
}

// dQ for one (query tile, head, batch, column slice): over the key tiles,
// S and dP over all of D, then dQ += dS K over the slice
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         T* __restrict__ dq, int S, int H, int KV, int D, Strides qs, Strides ks,
                         Strides vs, Strides dos, Strides dqs, float sm_scale, int causal) {
  extern __shared__ float smem[];
  float* t_q = smem;
  float* t_k = t_q + kWTile;   // a slice of K (for S, then the output slice)
  float* t_do = t_k + kWTile;
  float* t_v = t_do + kWTile;
  float* t_p = t_v + kWTile;
  float* t_ds = t_p + kWTile;

  const int nds = wide_slices(D);
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z / nds, c0 = (blockIdx.z % nds) * kWide;
  const int kvh = h / (H / KV);
  const int q0 = qt * kBlockQ;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;
  const T* dob = dout + b * dos.b + h * dos.h;
  const int64_t bh = (static_cast<int64_t>(b) * H + h) * S;
  float lse_r[4], delta_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    lse_r[i] = qpos < S ? lse[bh + qpos] : 0.f;
    delta_r[i] = qpos < S ? delta[bh + qpos] : 0.f;
  }
  float acc[4][4], sc[4][4], dp[4][4];
  zero44(acc);
  const int n_tiles = (S + kBlockK - 1) / kBlockK;
  const int n_kt = causal ? min(n_tiles, qt + 1) : n_tiles;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBlockK;
    wide_scores<T, true>(sc, dp, t_q, t_k, t_do, t_v, qb, kb, dob, vb, qs.s, ks.s, dos.s, vs.s, q0,
                         k0, S, D, tid, ty, tx);
    wide_p_ds(sc, dp, lse_r, delta_r, t_p, t_ds, q0, k0, S, sm_scale, causal, ty, tx);
    __syncthreads();  // dS complete; the K slice read by everyone
    stage_slice<T>(t_k, kb, ks.s, k0, S, c0, D, tid);
    __syncthreads();
    slice_pv(acc, t_ds, t_k, ty, tx);
  }
  T* dqb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= S) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c < D) dqb[qpos * dqs.s + c] = repro::from_f32<T>(acc[i][j] * sm_scale);
    }
  }
}

// dK and dV for one (key tile, KV head, batch, column slice): over the
// group's query heads in order and, for each, the query tiles from the
// diagonal on, S and dP over all of D, then dV += P^T dO and dK += dS^T Q
// over the slice
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           T* __restrict__ dk, T* __restrict__ dv, int S, int H, int KV, int D,
                           Strides qs, Strides ks, Strides vs, Strides dos, Strides dks,
                           Strides dvs, float sm_scale, int causal) {
  extern __shared__ float smem[];
  float* t_q = smem;
  float* t_k = t_q + kWTile;
  float* t_do = t_k + kWTile;
  float* t_v = t_do + kWTile;
  float* t_p = t_v + kWTile;
  float* t_ds = t_p + kWTile;

  const int nds = wide_slices(D);
  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z / nds, c0 = (blockIdx.z % nds) * kWide;
  const int group = H / KV;
  const int k0 = kt * kBlockK;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;
  float dka[4][4], dva[4][4], sc[4][4], dp[4][4];
  zero44(dka);
  zero44(dva);
  const int n_tiles = (S + kBlockQ - 1) / kBlockQ;
  for (int hh = 0; hh < group; ++hh) {
    const int h = kvh * group + hh;
    const T* qb = q + b * qs.b + h * qs.h;
    const T* dob = dout + b * dos.b + h * dos.h;
    const int64_t bh = (static_cast<int64_t>(b) * H + h) * S;
    for (int qt = causal ? kt : 0; qt < n_tiles; ++qt) {
      const int q0 = qt * kBlockQ;
      float lse_r[4], delta_r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qpos = q0 + ty + 16 * i;
        lse_r[i] = qpos < S ? lse[bh + qpos] : 0.f;
        delta_r[i] = qpos < S ? delta[bh + qpos] : 0.f;
      }
      wide_scores<T, true>(sc, dp, t_q, t_k, t_do, t_v, qb, kb, dob, vb, qs.s, ks.s, dos.s, vs.s,
                           q0, k0, S, D, tid, ty, tx);
      wide_p_ds(sc, dp, lse_r, delta_r, t_p, t_ds, q0, k0, S, sm_scale, causal, ty, tx);
      __syncthreads();  // P and dS complete; the Q and dO slices read by everyone
      stage_slice<T>(t_q, qb, qs.s, q0, S, c0, D, tid);
      stage_slice<T>(t_do, dob, dos.s, q0, S, c0, D, tid);
      __syncthreads();
      slice_ptv(dva, t_p, t_do, ty, tx);
      slice_ptv(dka, t_ds, t_q, ty, tx);
    }
  }
  T* dkb = dk + b * dks.b + kvh * dks.h;
  T* dvb = dv + b * dvs.b + kvh * dvs.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + ty + 16 * i;
    if (kpos >= S) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c >= D) continue;
      dkb[kpos * dks.s + c] = repro::from_f32<T>(dka[i][j] * sm_scale);
      dvb[kpos * dvs.s + c] = repro::from_f32<T>(dva[i][j]);
    }
  }
}

template <typename T>
int launch_wide(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
                int H, int KV, int D, Strides qs, Strides ks, Strides vs, Strides os,
                float sm_scale, int causal, cudaStream_t stream) {
  constexpr int smem = 3 * kWTile * sizeof(float);
  const int64_t z = static_cast<int64_t>(B) * wide_slices(D);
  if (z > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(flash_fwd_wide_kernel<T>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, static_cast<unsigned>(z));
  flash_fwd_wide_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, S, H, KV, D, qs, ks, vs, os, sm_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd_wide(const void* q, const void* k, const void* v, const void* o, const void* dout,
                    const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int S,
                    int H, int KV, int D, Strides qs, Strides ks, Strides vs, Strides os,
                    Strides dos, Strides dqs, Strides dks, Strides dvs, float sm_scale,
                    int causal, cudaStream_t stream) {
  constexpr int smem = 6 * kWTile * sizeof(float);
  const int64_t z = static_cast<int64_t>(B) * wide_slices(D);
  if (z > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_wide_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dkdv_wide_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (S + kBlockQ - 1) / kBlockQ;
  // Delta first: both kernels read it
  flash_bwd_delta_kernel<T><<<dim3((S + kThreads / 32 - 1) / (kThreads / 32), H, B), kThreads, 0,
                              stream>>>(static_cast<const T*>(o), static_cast<const T*>(dout),
                                        delta, S, H, D, os, dos);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_wide_kernel<T><<<dim3(n_tiles, H, static_cast<unsigned>(z)), kThreads, smem,
                                stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), S, H, KV, D, qs, ks, vs, dos,
      dqs, sm_scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_wide_kernel<T><<<dim3(n_tiles, KV, static_cast<unsigned>(z)), kThreads, smem,
                                  stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), S, H, KV,
      D, qs, ks, vs, dos, dks, dvs, sm_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// ---- launches ------------------------------------------------------------

template <typename T, int kDW>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S, int H,
           int KV, int D, Strides qs, Strides ks, Strides vs, Strides os, float sm_scale,
           int causal, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(kBlockQ + kBlockK) * (D + 1) +
                                       static_cast<size_t>(kBlockQ) * (kBlockK + 1));
  // above 48 KB a block's shared memory has to be asked for
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, kDW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  flash_fwd_kernel<T, kDW><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, S, H, KV, D, qs, ks, vs, os, sm_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kDW>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int S,
               int H, int KV, int D, Strides qs, Strides ks, Strides vs, Strides os, Strides dos,
               Strides dqs, Strides dks, Strides dvs, float sm_scale, int causal,
               cudaStream_t stream) {
  constexpr int kBK = dkdv_rows(kDW);
  const size_t tile = static_cast<size_t>(kBlockQ) * (D + 1);  // kBlockQ == kBlockK
  const size_t smem_dq = sizeof(float) * (3 * tile + static_cast<size_t>(kBlockQ) * (kBlockK + 1));
  const size_t smem_dkdv =
      sizeof(float) * (2 * tile + 2 * static_cast<size_t>(kBK) * (D + 1) +
                       static_cast<size_t>(kBK) * (kBlockQ + 1) + 2 * kBlockQ);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, kDW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_dq));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, kDW>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_dkdv));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (S + kBlockQ - 1) / kBlockQ;
  // dQ first: it writes the Delta that dK/dV reads
  flash_bwd_dq_kernel<T, kDW><<<dim3(n_tiles, H, B), kThreads, smem_dq, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), S,
      H, KV, D, qs, ks, vs, os, dos, dqs, sm_scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_dkdv((S + kBK - 1) / kBK, KV, B);
  flash_bwd_dkdv_kernel<T, kDW><<<grid_dkdv, kThreads, smem_dkdv, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), S, H,
      KV, D, qs, ks, vs, dos, dks, dvs, sm_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// The mma kernels' grid: (heads, batch, tiles), the tile index slowest so
// that the tiles with the most work launch first.
int mma_grid(int S, int heads, int B, dim3* grid) {
  const int n_tiles = (S + kTile - 1) / kTile;
  if (n_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  *grid = dim3(heads, B, n_tiles);
  return 0;
}

template <int kD, bool kVec>
int launch_mma(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
               int H, int KV, int D, Strides qs, Strides ks, Strides vs, Strides os,
               float sm_scale, int causal, cudaStream_t stream) {
  // two stages of K and of V (Q in K's second up to kD = 128, in a fifth tile at 256)
  constexpr int smem = (kD > 128 ? 5 : 4) * TileShape<kD>::kBytes;
  dim3 grid;
  if (const int bad = mma_grid(S, H, B, &grid)) return bad;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_mma_kernel<kD, kVec>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_mma_kernel<kD, kVec><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, S, H, KV, D, qs, ks, vs, os, sm_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int kD, bool kVec>
int launch_bwd_mma(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int S,
                   int H, int KV, int D, Strides qs, Strides ks, Strides vs, Strides os,
                   Strides dos, Strides dqs, Strides dks, Strides dvs, float sm_scale, int causal,
                   cudaStream_t stream) {
  // dQ: Q, dO, two stages of K and of V, Delta; dK/dV: K, V, two stages of
  // Q and of dO, two stages of lse and of Delta
  constexpr int smem_dq = 6 * TileShape<kD>::kBytes + kTile * 4;
  constexpr int smem_dkdv = 6 * TileShape<kD>::kBytes + 4 * kTile * 4;
  dim3 grid_dq, grid_dkdv;
  if (const int bad = mma_grid(S, H, B, &grid_dq)) return bad;
  if (const int bad = mma_grid(S, KV * (kD / dkdv_cols(kD)), B, &grid_dkdv)) return bad;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_mma_kernel<kD, kVec>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dkdv_mma_kernel<kD, kVec>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dkdv);
  if (err != cudaSuccess) return static_cast<int>(err);
  // dQ first: it writes the Delta that dK/dV reads
  flash_bwd_dq_mma_kernel<kD, kVec><<<grid_dq, kMmaThreads, smem_dq, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dq), S, H, KV, D, qs, ks, vs, os, dos, dqs, sm_scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_mma_kernel<kD, kVec><<<grid_dkdv, kMmaThreads, smem_dkdv, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      S, H, KV, D, qs, ks, vs, dos, dks, dvs, sm_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// 16-byte copies and bf16 pair stores need D % 8 == 0 and every base and
// (batch, seq, head) stride 16-byte aligned.
bool vec_ok(int D, std::initializer_list<const void*> ptrs, std::initializer_list<Strides> strides) {
  if (D % 8) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  for (const Strides& s : strides)
    if (s.b % 8 || s.s % 8 || s.h % 8) return false;
  return true;
}

// kD = 64, 128 or 256 by D; kVec by vec_ok
#define REPRO_FLASH_DISPATCH(fn, d, vec, ...)                                          \
  ((d) <= 64    ? ((vec) ? fn<64, true>(__VA_ARGS__) : fn<64, false>(__VA_ARGS__))     \
   : (d) <= 128 ? ((vec) ? fn<128, true>(__VA_ARGS__) : fn<128, false>(__VA_ARGS__))   \
                : ((vec) ? fn<256, true>(__VA_ARGS__) : fn<256, false>(__VA_ARGS__)))

}  // namespace

// lse: null, or f32 (B, H, S) for the row log-sum-exps (training). f32 runs
// the scalar kernel, bf16 the tensor-core kernel.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, void* lse, int B, int S, int H, int KV,
    int D,
    int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh,
    float sm_scale, int causal, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV || D <= 0 || H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh},
      os{o_sb, o_ss, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (D > kMaxD && dtype == repro::kFloat32)
    return launch_wide<float>(q, k, v, o, l, B, S, H, KV, D, qs, ks, vs, os, sm_scale, causal, s);
  if (D > kMaxD && dtype == repro::kBFloat16)
    return launch_wide<bf16>(q, k, v, o, l, B, S, H, KV, D, qs, ks, vs, os, sm_scale, causal, s);
  if (dtype == repro::kFloat32)
    return D <= 128
               ? launch<float, 128>(q, k, v, o, l, B, S, H, KV, D, qs, ks, vs, os, sm_scale, causal, s)
               : launch<float, 256>(q, k, v, o, l, B, S, H, KV, D, qs, ks, vs, os, sm_scale, causal, s);
  if (dtype == repro::kBFloat16) {
    const bool vec = vec_ok(D, {q, k, v, o}, {qs, ks, vs, os});
    return REPRO_FLASH_DISPATCH(launch_mma, D, vec, q, k, v, o, l, B, S, H, KV, D, qs, ks, vs, os,
                                sm_scale, causal, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// lse (read) and delta (written, then read) are f32 (B, H, S), contiguous;
// every other tensor is read or written through its (batch, seq, head)
// strides with unit stride along D. dq is written by the first kernel, dk
// and dv by the second. f32 runs the scalar kernels, bf16 the tensor-core
// kernels.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* delta, void* dq, void* dk, void* dv, int B, int S, int H, int KV,
    int D, int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh,
    int64_t do_sb, int64_t do_ss, int64_t do_sh, int64_t dq_sb, int64_t dq_ss, int64_t dq_sh,
    int64_t dk_sb, int64_t dk_ss, int64_t dk_sh, int64_t dv_sb, int64_t dv_ss, int64_t dv_sh,
    float sm_scale, int causal, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV || D <= 0 || H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh},
      os{o_sb, o_ss, o_sh}, dos{do_sb, do_ss, do_sh}, dqs{dq_sb, dq_ss, dq_sh},
      dks{dk_sb, dk_ss, dk_sh}, dvs{dv_sb, dv_ss, dv_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (D > kMaxD && dtype == repro::kFloat32)
    return launch_bwd_wide<float>(q, k, v, o, dout, l, dl, dq, dk, dv, B, S, H, KV, D, qs, ks, vs,
                                  os, dos, dqs, dks, dvs, sm_scale, causal, s);
  if (D > kMaxD && dtype == repro::kBFloat16)
    return launch_bwd_wide<bf16>(q, k, v, o, dout, l, dl, dq, dk, dv, B, S, H, KV, D, qs, ks, vs,
                                 os, dos, dqs, dks, dvs, sm_scale, causal, s);
  if (dtype == repro::kFloat32)
    return D <= 128 ? launch_bwd<float, 128>(q, k, v, o, dout, l, dl, dq, dk, dv, B, S, H, KV, D, qs,
                                             ks, vs, os, dos, dqs, dks, dvs, sm_scale, causal, s)
                    : launch_bwd<float, 256>(q, k, v, o, dout, l, dl, dq, dk, dv, B, S, H, KV, D, qs,
                                             ks, vs, os, dos, dqs, dks, dvs, sm_scale, causal, s);
  if (dtype == repro::kBFloat16) {
    const bool vec = vec_ok(D, {q, k, v, o, dout, dq, dk, dv}, {qs, ks, vs, os, dos, dqs, dks, dvs});
    return REPRO_FLASH_DISPATCH(launch_bwd_mma, D, vec, q, k, v, o, dout, l, dl, dq, dk, dv, B, S, H,
                                KV, D, qs, ks, vs, os, dos, dqs, dks, dvs, sm_scale, causal, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
