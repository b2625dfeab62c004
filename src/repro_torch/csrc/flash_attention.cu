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
                 T* __restrict__ o, int S, int H, int KV, int D, Strides qs, Strides ks,
                 Strides vs, Strides os, float sm_scale, int causal) {
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
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H, int KV,
           int D, Strides qs, Strides ks, Strides vs, Strides os, float sm_scale, int causal,
           cudaStream_t stream) {
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
      static_cast<T*>(o), S, H, KV, D, qs, ks, vs, os, sm_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, int B, int S, int H, int KV, int D,
    int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh,
    float sm_scale, int causal, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV || D <= 0 || D > kMaxD || H > 65535 ||
      B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh},
      os{o_sb, o_ss, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return launch<float>(q, k, v, o, B, S, H, KV, D, qs, ks, vs, os, sm_scale, causal, s);
  if (dtype == repro::kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, o, B, S, H, KV, D, qs, ks, vs, os, sm_scale, causal,
                                 s);
  return static_cast<int>(cudaErrorInvalidValue);
}
