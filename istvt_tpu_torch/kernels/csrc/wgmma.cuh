// Hopper's asynchronous building blocks for the wgmma GEMMs, the float ones
// (float_gemm.cu: bf16, and f32 as three TF32 products) and the int8 one
// (q8_rows_gemm.cuh, whose body the standalone kernel and #9's GEMM phases run), in
// inline PTX: mbarriers, 2-D TMA loads, the proxy fences, the wgmma shared-memory
// descriptor with the 128-byte swizzle, wgmma m64n128k16 (bf16 in, f32 sums),
// m64n128k8 (tf32, A from registers, f32 sums) and m64n128k32 (s8 in, s32 sums), the
// TF32 rounding, setmaxnreg; and
// what both GEMMs share around them: the persistent walk over the output tiles
// (TileGrid), the producer thread's loop that keeps the TMA ring full (produce_ring),
// and on the host the tensor maps (tile_map) and the card's SM count.
//
// Shared-memory layouts (PTX ISA, "Shared Memory Matrix Layout"; CUTLASS's
// canonical GMMA layouts), 128-byte swizzle, each atom 1024-byte aligned:
//   * K-major (the K index contiguous): rows of 128 B (64 bf16, 32 f32 or 128 int8
//     elements) at a stride of 128 B, one row per M (or N) index; the descriptor's
//     stride byte offset (SBO) is the stride between groups of 8 rows, 1024 B; its
//     leading byte offset is unused. The k-th slice of one wgmma (16 bf16, 8 tf32 or 32
//     int8 deep: 32 B) starts 32 k bytes into the row, so all types take the same
//     descriptors.
//   * MN-major (the M or N index contiguous; bf16 only, wgmma transposes no 8-bit
//     operand): slabs of 64 K-rows x 64 elements, one
//     K index per 128-byte row; SBO is the stride between groups of 8 K-rows, 1024 B,
//     and the leading byte offset (LBO) the stride between 64-wide slabs. The k-th
//     16-deep slice starts 16 k rows (2048 k bytes) into the slab.
// A TMA load with CU_TENSOR_MAP_SWIZZLE_128B and a box whose inner extent is 128
// bytes writes exactly these layouts.
//
// Fragment of the f32 accumulator of m64nNk16 and m64nNk8 and of the s32 one of
// m64nNk32 (PTX ISA, "Register Fragments: wgmma .m64nNk16 / .m64nNk8 / .m64nNk32"),
// thread t of the warpgroup, warp w = t / 32, lane = 4 g + q: d[4 i + 2 h + e] = (row
// 16 w + g + 8 h, column 8 i + 2 q + e), i < N / 8.
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

// End a barrier's life, so that its word may be initialised anew (#9 runs one ring per
// GEMM phase on the same shared memory).
__device__ __forceinline__ void mbar_inval(uint64_t* bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar)) : "memory");
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

// Order this thread's earlier generic-proxy accesses (ordinary loads and stores) of
// global / shared memory before later async-proxy ones (TMA), its own or, through a
// barrier, another thread's: TMA must not read codes, or overwrite shared memory, from
// before the generic writes that the barrier orders first.
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
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

// d (64 x 128, f32) = A (64 x 8) @ B (8 x 128) (+ d if add), tf32. A from registers:
// warp w of the warpgroup holds rows 16 w .. + 15 as the m16n8k8 tf32 fragment, lane
// 4 g + q: a[i] = (row 16 w + g + 8 (i % 2), column q + 4 (i / 2)). B from shared memory,
// K-major (tf32 has no transpose bits); each 8-deep slice is 32 bytes of the 128-byte
// rows, so B takes the bf16 K-major descriptors. The tensor cores round the f32 sum of
// each such product toward zero.
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64], const unsigned (&a)[4],
                                                     uint64_t db, int add) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : ISTVT_F8(0), ISTVT_F8(8), ISTVT_F8(16), ISTVT_F8(24), ISTVT_F8(32), ISTVT_F8(40),
        ISTVT_F8(48), ISTVT_F8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(add));
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from zero: the result's
// low 13 bits are zero.
__device__ __forceinline__ unsigned tf32_rna(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

#undef ISTVT_F8

#define ISTVT_R8(i)                                                                  \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]),         \
      "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// d (64 x 128, s32) += A (64 x 32) @ B (32 x 128), s8, both K-major in shared memory
// (8-bit operands have no transpose bits). The sums are exact: a K = 2912 dot of codes
// within +-127 stays below 2^26.
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : ISTVT_R8(0), ISTVT_R8(8), ISTVT_R8(16), ISTVT_R8(24), ISTVT_R8(32), ISTVT_R8(40),
        ISTVT_R8(48), ISTVT_R8(56)
      : "l"(da), "l"(db), "r"(1));
}

#undef ISTVT_R8

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

// --- the persistent tile walk and the producer ---------------------------------------

// Both GEMMs' output tile.
constexpr int kTileM = 128, kTileN = 128;

// The output tiles of one launch, in the order the blocks take them: the N tile
// fastest, then the M tile, then the split-K slice z (so the blocks in flight share
// their A rows and the weight stays in L2).
struct TileGrid {
  int tn, tm, splits, kslice, nk;
  __device__ __forceinline__ int count() const { return tn * tm * splits; }
  // tile -> the block's output rows m0.., columns n0.., M tile mt, slice z, k-tiles [kb, ke)
  __device__ __forceinline__ void at(int tile, int& m0, int& n0, int& mt, int& z, int& kb,
                                     int& ke) const {
    const int nt = tile % tn;
    mt = (tile / tn) % tm;
    z = tile / (tn * tm);
    m0 = mt * kTileM;
    n0 = nt * kTileN;
    kb = z * kslice;
    ke = min(nk, kb + kslice);
  }
};

// The producer thread of a persistent block: walks the block's tiles blockIdx.x, +
// gridDim.x, ... and, for each k-tile kt of each, waits until the ring's next stage s
// is free, arms its full barrier with the stage's `tx_bytes` and calls load(s, m0, n0,
// kt) to start the stage's TMA loads; it runs ahead into the next tile while the
// consumers finish one.
template <int kStages, typename Load>
__device__ __forceinline__ void produce_ring(const TileGrid& grid, int tiles, uint64_t* full,
                                             uint64_t* empty, unsigned tx_bytes,
                                             const Load& load) {
  int it = 0;  // k-steps so far: stage it % kStages, pass it / kStages
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int m0, n0, mt, z, kb, ke;
    grid.at(tile, m0, n0, mt, z, kb, ke);
    for (int kt = kb; kt < ke; ++kt, ++it) {
      const int s = it % kStages;
      mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
      mbar_arrive_expect_tx(&full[s], tx_bytes);
      load(s, m0, n0, kt);
    }
  }
}

// --- host: tensor maps and the grid -----------------------------------------------------

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point query (the
// library does not link libcuda); null if it is not found.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                            cudaEnableDefault, &q);
#else
    const cudaError_t rc =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return rc == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                 : nullptr;
  }();
  return fn;
}

// The TMA map of a row-major (rows, cols) matrix of `type` (elements of elem_bytes) with
// rows ld elements apart, read in boxes of 128 bytes (128 / elem_bytes columns) x
// box_rows rows with the 128-byte swizzle; elements past (rows, cols) read as zeros, so
// a row's padding past cols is never read (TMA's conditions: base 16-byte aligned, ld
// elem_bytes a multiple of 16); false if refused.
inline bool tile_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
                     const void* base, int rows, int cols, long ld, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / elem_bytes),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The card's SMs: a persistent GEMM's grid.
inline int sm_count() {
  static const int n = [] {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms;
  }();
  return n;
}

}  // namespace istvt
