// The tensor-core building blocks of the spatial attention cores (q8_attention.cuh,
// attention_bwd.cu): 16-byte cp.async copies into shared memory, ldmatrix fragment
// loads, the mma.sync m16n8k16 product (bf16 operands) and the m16n8k8 product (tf32
// operands), both with f32 accumulators, and the TF32 split of an f32 value. (The
// float GEMM runs wgmma instead: wgmma.cuh.)
//
// Fragment layout of m16n8k16 (PTX ISA, "Matrix Fragments for mma.m16n8k16"), for
// lane = 4 g + t: A (16 x 16, row-major) a0 = (g, 2t..2t+1), a1 = (g + 8, 2t..),
// a2 = (g, 8 + 2t..), a3 = (g + 8, 8 + 2t..); B (16 x 8) b0 = (2t..2t+1, g),
// b1 = (8 + 2t.., g); C / D (16 x 8, f32) c0, c1 = (g, 2t..2t+1), c2, c3 =
// (g + 8, 2t..). So the C fragments of two neighbouring n8 tiles, rounded to bf16 in
// pairs, are the A fragment of the next product (C -> A without shared memory).
//
// Fragment layout of m16n8k8 with tf32 operands ("Matrix Fragments for mma.m16n8k8"):
// A (16 x 8) a0 = (g, t), a1 = (g + 8, t), a2 = (g, t + 4), a3 = (g + 8, t + 4); B (8 x 8)
// b0 = (t, g), b1 = (t + 4, g); C / D as m16n8k16's. So thread (g, t) holds C columns 2t
// and 2t + 1 where A wants t and t + 4: a C tile becomes the A fragment of the next
// product without a shuffle when that product's k index t stands for column 2t and t + 4
// for 2t + 1, and its B rows are taken in the same order (attention_tf32.cuh).
#pragma once

#include "common.cuh"

namespace istvt {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = full ? 16 : 0;  // 0: write 16 zero bytes, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = full ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 rounded to bf16 (nearest even) in one register, lo in the low half.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from zero, as
// cvt.rna.tf32.f32 (wgmma.cuh tf32_rna) rounds a finite x, in two integer operations
// (cvt.rna takes several): half of the dropped unit added to the magnitude's bits (a
// carry into the exponent is the right rounding), then the dropped bits cleared.
__device__ __forceinline__ unsigned tf32_round(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo to 2^-22 of |x|: hi = x rounded to TF32, lo = the (exact) rest rounded to
// TF32 (kernels/linear.split_tf32 is the plain version, in the same integer operations).
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = tf32_round(x);
  lo = tf32_round(__fsub_rn(x, __uint_as_float(hi)));
}

// c += a b, m16n8k8, tf32 operands (TF32 bit patterns), f32 accumulators. The tensor
// cores round the f32 sum of each product toward zero.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b as three TF32 products of the split operands: a_lo b_hi, a_hi b_lo, then
// a_hi b_hi (the small terms first; a_lo b_lo, ~2^-22 of the product, is left out). With
// kSwap the first two go the other way round, so that the product with A and B
// exchanged (K Q^T for Q K^T) adds the same terms in the same order and gets the same
// bits.
template <bool kSwap = false>
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const unsigned (&ah)[4],
                                           const unsigned (&al)[4], unsigned bh0, unsigned bh1,
                                           unsigned bl0, unsigned bl1) {
  if constexpr (kSwap) {
    mma_tf32(c, ah, bl0, bl1);
    mma_tf32(c, al, bh0, bh1);
  } else {
    mma_tf32(c, al, bh0, bh1);
    mma_tf32(c, ah, bl0, bl1);
  }
  mma_tf32(c, ah, bh0, bh1);
}

}  // namespace istvt
