// Hopper's asynchronous building blocks for the float GEMM (float_gemm.cu), in
// inline PTX: mbarriers, 2-D TMA loads, the wgmma shared-memory descriptor with the
// 128-byte swizzle, wgmma m64n128k16 (bf16 in, f32 sums) and setmaxnreg.
//
// Shared-memory layouts (PTX ISA, "Shared Memory Matrix Layout"; CUTLASS's
// canonical GMMA layouts), 16-bit elements, 128-byte swizzle, each atom 1024-byte
// aligned:
//   * K-major (the K index contiguous): rows of 64 elements (128 B) at a stride of
//     128 B, one row per M (or N) index; the descriptor's stride byte offset (SBO) is
//     the stride between groups of 8 rows, 1024 B; its leading byte offset is unused.
//     The k-th 16-deep slice starts 32 k bytes into the row.
//   * MN-major (the M or N index contiguous): slabs of 64 K-rows x 64 elements, one
//     K index per 128-byte row; SBO is the stride between groups of 8 K-rows, 1024 B,
//     and the leading byte offset (LBO) the stride between 64-wide slabs. The k-th
//     16-deep slice starts 16 k rows (2048 k bytes) into the slab.
// A TMA load with CU_TENSOR_MAP_SWIZZLE_128B and a box whose inner extent is 64
// elements writes exactly these layouts.
//
// Fragment of the f32 accumulator of m64nNk16 (PTX ISA, "Register Fragments: wgmma
// .m64nNk16"), thread t of the warpgroup, warp w = t / 32, lane = 4 g + q: d[4 i + 2 h
// + e] = (row 16 w + g + 8 h, column 8 i + 2 q + e), i < N / 8.
#pragma once

#include <cuda.h>

#include "common.cuh"

namespace istvt {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// --- mbarriers ---------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Make the initialised barriers visible to the async proxy (TMA) and the other threads.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive once and add `bytes` to the transaction count the phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(ok)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}

// Wait until the phase of parity `parity` has completed. A wait of more than about
// 2^34 cycles (several seconds) can only be a fault of the pipeline: trap, so that
// the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1LL << 34)) __trap();
}

// --- TMA -----------------------------------------------------------------------------

// The box of `map` at element coordinates (c0 innermost, c1) into shared memory at
// dst; completion adds the box's bytes to bar's transaction count.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// --- wgmma -------------------------------------------------------------------------

// Descriptor of a 128-byte-swizzled operand tile at shared address `addr` (bytes).
__device__ __forceinline__ uint64_t wgmma_desc(unsigned addr, unsigned lbo, unsigned sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accesses of the accumulators across the async MMAs.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define ISTVT_F8(i)                                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),         \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 128, f32) += A (64 x 16) @ B (16 x 128), bf16, both from shared memory;
// TA / TB: the operand is MN-major (1) or K-major (0).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : ISTVT_F8(0), ISTVT_F8(8), ISTVT_F8(16), ISTVT_F8(24), ISTVT_F8(32), ISTVT_F8(40),
        ISTVT_F8(48), ISTVT_F8(56)
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

#undef ISTVT_F8

// --- register budgets of warp-specialised warpgroups -----------------------------------

template <int R>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// The consumers' named barrier (id 1; 0 is __syncthreads) over `n` threads.
__device__ __forceinline__ void bar_sync(int n) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(n) : "memory");
}

}  // namespace istvt
