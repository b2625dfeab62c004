// Tensor-core building blocks shared by the bf16 kernels (flash attention,
// the SSD scan): cp.async copies into shared memory, ldmatrix loads of 8 x 8
// bf16 tiles from it, the mma.sync.m16n8k16 product with f32 accumulators,
// and the per-lane offsets that feed one from a padded row-major tile.
//
// Fragment layout of one m16n8k16 product (lane = 4 g + t): the f32
// accumulator holds rows g and g + 8, columns 2t and 2t + 1 of a 16 x 8
// tile; A is 16 x 16 (row-major), B 16 x 8 (column-major).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes into shared memory; the bytes past src_bytes (all of them for 0)
// are zeros and are not read
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a b for one 16 x 8 x 16 product: a is 16 x 16 (row), b 16 x 8 (col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 as a bf16 pair, rounded to nearest even; lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A operand of one 16-wide k-step from the f32 accumulators of the two
// 8-column tiles that make it up (c0: columns 0-7, c1: 8-15), rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Per-lane element offsets of an ldmatrix.x4 within a tile of row stride
// kLd (a runtime ld works the same way). A operand of rows [r, r + 16),
// k-step at column c: add r * kLd + c.
__device__ __forceinline__ int a_offset(int lane, int ld) {
  return (lane & 15) * ld + (lane >> 4) * 8;
}
// B operands of two 8-wide n-tiles from [n][k] rows (K for Q K^T): the four
// registers are b0, b1 of n-tile 0 and b0, b1 of n-tile 1. Through .trans,
// the same offsets give the A operand of a 16 x 16 step from [k][m] rows (a
// product that contracts over the tile's rows, as X^T B does).
__device__ __forceinline__ int b_offset(int lane, int ld) {
  return ((lane & 7) + ((lane >> 4) << 3)) * ld + ((lane >> 3) & 1) * 8;
}
// B operands of two n-tiles from [k][n] rows through .trans (V for P V).
__device__ __forceinline__ int bt_offset(int lane, int ld) {
  return ((lane & 7) + (((lane >> 3) & 1) << 3)) * ld + (lane >> 4) * 8;
}

}  // namespace
