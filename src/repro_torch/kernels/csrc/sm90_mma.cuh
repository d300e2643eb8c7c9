// Warp-level tensor-core and async-copy helpers shared by the bf16 kernels
// (flash_attention.cu, ssd.cu), as inline PTX for sm_90a.
//
//   mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32   D = A B + D
//     A 16 x 16 (row), 4 registers of two bf16; B 16 x 8 (col), 2 registers;
//     C/D 16 x 8 fp32, 4 registers.  With g = lane / 4, c = lane % 4:
//       A: a0 (row g, k 2c..2c+1), a1 (row g+8, same k), a2 (row g, k 2c+8..),
//          a3 (row g+8, k 2c+8..)
//       B: b0 (k 2c..2c+1, col g), b1 (k 2c+8.., col g)
//       C: c0, c1 (row g, cols 2c, 2c+1), c2, c3 (row g+8, same cols)
//     so the accumulator of one product, packed to bf16 pairs, is the A
//     fragment of the next (two adjacent 8-column tiles make one 16-deep step).
//   ldmatrix.sync.aligned.m8n8.x4[.trans].shared.b16: four 8 x 8 bf16
//     matrices; lanes 8i..8i+7 give the row addresses of matrix i, which lands
//     in register i.  Without .trans lane l receives (row g, cols 2c, 2c+1) of
//     each matrix, with .trans (rows 2c, 2c+1, col g).
//   cp.async.cg.shared.global 16 bytes, zero-filled when the source size is 0.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zeros when !pred (src is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(pred ? 16 : 0));
}

// 4 bytes global -> shared; zeros when !pred
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> a bf16 pair (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// x = hi + lo with hi = bf16(x) and lo = bf16(x - hi): a pair of floats as
// two bf16 pairs, good to ~2^-16 relative (one bf16 alone: 2^-8)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  const float2 h = unpack_bf16(hi);
  lo = pack_bf16(x0 - h.x, x1 - h.y);
}

// 2^x in one MUFU instruction (relative error ~2^-22; results below 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace sm90
