// Tensor-core building blocks of mma.sync kernels: cp.async copies,
// ldmatrix, mma.sync m16n8k16 (bf16 in, f32 accumulation), mma.sync m16n8k4
// f64 (`dmma`) and the XOR swizzle of a shared tile's 16-byte chunks. Shared
// by flash_attention.cu (row 10), the tensor-core attention of the int8
// sublayers (attn_mma.cuh: rows 2, 4, 7), the DPC-KNN Gram product
// (cluster_dpc.cu, row 1) and the int8-cache attention's copies (row 11).
//
// Fragment layouts of m16n8k16 (g = lane / 4, t4 = lane % 4): A (16 x 16,
// row-major) a0 (row g, cols 2t4, 2t4 + 1), a1 (row g + 8), a2 (row g, cols
// 8 + 2t4), a3 (row g + 8, cols 8 + 2t4); B (16 x 8) b0 (k 2t4, 2t4 + 1, col
// g), b1 (k 8 + 2t4); C (16 x 8) c0, c1 (row g, cols 2t4, 2t4 + 1), c2, c3
// (row g + 8).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma16 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared, the bytes past src_bytes zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the newest N groups of this thread's copies have landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// c (16 x 8, f64) += a (16 x 4) . b (4 x 8) on the FP64 tensor cores: lane
// (g, t4) gives A[g][t4], A[g + 8][t4] and B[t4][g], holds C[g][2t4],
// C[g][2t4 + 1], C[g + 8][2t4], C[g + 8][2t4 + 1]
__device__ __forceinline__ void dmma(double (&c)[4], double a0, double a1,
                                     double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a0), "d"(a1), "d"(b));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  mma_bf16(c, a[0], a[1], a[2], a[3], b0, b1);
}

// x → hi = bf16(x), lo = bf16(x - hi), two values packed per register
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// byte offset of 16-byte chunk c of row r in a (64, D) bf16 tile: the chunk
// index XORed with the row's low 3 bits, so that the 8 rows an ldmatrix
// reads sit in 8 different bank groups
template <int D>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * (D * 2) + ((c ^ (r & 7)) << 4));
}

// the same in a tile of row_bytes a row (a multiple of 128)
__device__ __forceinline__ uint32_t swz(int r, int c, int row_bytes) {
  return (uint32_t)(r * row_bytes + ((c ^ (r & 7)) << 4));
}

// ldmatrix.x4 row addresses. Lane l feeds row l & 7 of matrix l >> 3.
// "pairs": matrices (rows 0-7, chunk 2c), (rows 8-15, 2c), (rows 0-7,
// 2c + 1), (rows 8-15, 2c + 1): an A fragment, or with .trans the B
// fragments of two n8 tiles of a row-major [k][n] operand. "halves": (rows
// 0-7, 2c), (0-7, 2c + 1), (8-15, 2c), (8-15, 2c + 1): the B fragments of
// two n8 tiles of a [n][k] operand.
__device__ __forceinline__ int pairs_row(int lane) {
  return ((lane >> 3) & 1) * 8 + (lane & 7);
}
__device__ __forceinline__ int pairs_chunk(int lane) { return lane >> 4; }
__device__ __forceinline__ int halves_row(int lane) {
  return (lane >> 4) * 8 + (lane & 7);
}
__device__ __forceinline__ int halves_chunk(int lane) {
  return (lane >> 3) & 1;
}

}  // namespace mma16
