// Tensor-core and copy helpers shared by the flash body of K2 and K5
// (flash_mma.cuh), the split runs of K4, K6 and K7 (split_runs.cuh) and the
// quantized matmuls' tensor-core routes (quant_matmul.cu, w4a8_matmul.cu),
// and fp32 K2's 3xTF32 body (attention.cu): cp.async into shared memory,
// ldmatrix, bf16 mma.sync.m16n8k16 with f32 sums, tf32 mma.sync.m16n8k8
// with f32 sums (and the hi/lo split of 3xTF32), int8 mma.sync.m16n8k32
// with int32 sums, and packing two f32 values into one bf16x2 operand
// register.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}

// 8 bytes, through the L1 (cp.async.cg takes 16 only): the int4 cache's
// per-key scales, 24 bytes a key, are 8-byte aligned but not 16.
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_u32(dst)), "l"(src));
}

// As cp_async16, but copies only `bytes` (0 or 16) and zero-fills the rest:
// a chunk past a ragged edge arrives as zeros from a clamped, valid address.
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a (16 x 16, row-major) * b (16 x 8, column-major), bf16 in, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An f32 value rounded to tf32 (10 mantissa bits; to nearest, ties away from
// zero, as cvt.rna.tf32.f32), as the b32 operand register of a tf32 mma: half
// an ulp (bit 12) added to the bits, the low 13 cleared.  Two integer ops;
// cvt.rna.tf32.f32 becomes a longer sequence with NaN and infinity checks
// (fp32 K2 took 0.373 ms with it against 0.284 at lq 1024 over 1152 keys on
// an NVIDIA H100 80GB HBM3).  Finite inputs only.
__device__ __forceinline__ unsigned tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x as hi + lo, both tf32: hi = tf32(x), lo = tf32(x - hi) (x - hi is exact
// in f32).  hi + lo differs from x by at most 2^-22 |x|.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// c += a (16 x 8, row-major) * b (8 x 8, column-major), tf32 in, f32 sums.
// a0: row gid, k tig; a1: row gid + 8, k tig; a2, a3: the same rows at k
// tig + 4; b0: k tig, column gid; b1: k tig + 4; c as mma_bf16's.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b in 3xTF32: a_lo b_hi + a_hi b_lo, then a_hi b_hi (the small
// terms first).  Each tf32 product is exact in the f32 sum; only a_lo b_lo,
// at most 2^-22 of |a b|, is dropped.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const unsigned (&ah)[4],
                                           const unsigned (&al)[4], unsigned bh0, unsigned bh1,
                                           unsigned bl0, unsigned bl1) {
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

// d = c + a (16 x 32, row-major) * b (32 x 8, column-major), signed int8 in,
// int32 sums (exact).  A register holds four consecutive k of one row (a0:
// row gid, k 4 t..4 t + 3; a1: row gid + 8; a2, a3: the same rows at k + 16),
// b0 / b1 the same k of column gid; c and d as mma_bf16's c.
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1,
                                       const int (&c)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "r"(c[0]), "r"(c[1]), "r"(c[2]),
        "r"(c[3]));
}

// Two f32 values rounded to bf16, the lower column in the low half.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

}  // namespace
