// The int8 row passes and the body of the W8A8 GEMM on s8 wgmma as device functions:
// q8_rows_gemm.cu launches each as a kernel of its own (the row passes one row per
// warp, the GEMM as gemm_q8_wgmma_kernel), q8_layer.cu walks them all inside one
// persistent kernel per ST layer, its six GEMM phases on this same body.
//
// No pointer parameter here is __restrict__. In the persistent kernel the buffers
// these functions read were written earlier in the same launch by other blocks, and
// a load the compiler may route through the non-coherent read-only path (ld.global.nc,
// which restrict + const allows) could return a line cached before that write. The
// kernels of q8_rows_gemm.cu keep __restrict__ on their own parameters.
#pragma once

#include "wgmma.cuh"

namespace istvt {

// (i) LayerNorm (two-pass statistics, eps 1e-5) + per-row int8 quant of row `row`,
// by one warp, its codes at q + row * ldq. Mirrors kernels/linear._ln followed by
// _quant_rows.
template <typename T>
__device__ __forceinline__ void ln_quant_row(const T* x, const float* s, const float* b,
                                             int8_t* q, float* rs, int row, int D, int ldq,
                                             int lane) {
  const T* xr = x + static_cast<size_t>(row) * D;
  // order-independent statistics, so the plain version yields the same int8 codes
  float mean, r;
  row_ln_stats(xr, D, lane, mean, r);
  float amax = 0.f;
  for (int d = lane; d < D; d += 32)
    amax = fmaxf(amax, fabsf(ln_affine(to_f(xr[d]), mean, r, s[d], b[d])));
  const float rsv = row_scale(warp_max(amax));
  int8_t* qr = q + static_cast<size_t>(row) * ldq;
  for (int d = lane; d < D; d += 32)
    qr[d] = quant_code(ln_affine(to_f(xr[d]), mean, r, s[d], b[d]), rsv);
  if (lane == 0) rs[row] = rsv;
}

// (ii) Per-row int8 quant alone (_quant_rows) of row `row`, by one warp, its codes at
// q + row * ldq.
template <typename T>
__device__ __forceinline__ void quant_row(const T* x, int8_t* q, float* rs, int row, int D,
                                          int ldq, int lane) {
  const T* xr = x + static_cast<size_t>(row) * D;
  float amax = 0.f;
  for (int d = lane; d < D; d += 32) amax = fmaxf(amax, fabsf(to_f(xr[d])));
  const float rsv = row_scale(warp_max(amax));
  int8_t* qr = q + static_cast<size_t>(row) * ldq;
  for (int d = lane; d < D; d += 32) qr[d] = quant_code(to_f(xr[d]), rsv);
  if (lane == 0) rs[row] = rsv;
}

// (iii) The W8A8 GEMM on wgmma (q8_rows_gemm.cu's header says why this design):
// 128 x 128 x 128 block tiles, kQStages TMA-filled stages, warpgroups 0-1 consume,
// warpgroup 2 produces.
constexpr int kQBK = 128, kQThreads = 384;  // k-step (int8 elements = bytes), threads
// the ring's depth, and the registers a thread of the producer / consumer warpgroups
// keeps after setmaxnreg (of the block's 384 x 168 at launch)
constexpr int kQStages = 4, kQProducerRegs = 40, kQConsumerRegs = 232;
constexpr int kQStage = kTileM * kQBK;  // bytes of A (and of W, kTileN = kTileM) a stage
// Dynamic shared memory of a block: the A and W rings, the full / empty barriers, two
// slots (by tile parity) of the tile's column scales and bias [kTileN] each, and 1 KB
// to align the rings to the swizzle atom.
constexpr int kQSmem = kQStages * 2 * kQStage + 2 * kQStages * 8 + 4 * kTileN * 4 + 1024;

// The block's dynamic shared memory from its first 1024-byte boundary: the rings'
// base.
__device__ __forceinline__ unsigned char* q8_smem_base(unsigned char* smem_raw) {
  return smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
}

// The ring's full / empty barriers after the A and W stages at base.
__device__ __forceinline__ uint64_t* q8_ring_barriers(unsigned char* base) {
  return reinterpret_cast<uint64_t*>(base + 2 * kQStages * kQStage);
}

// A pair of adjacent elements of T, as a residual is read.
template <typename T> struct Pair2;
template <> struct Pair2<float> {
  using type = float2;
  static __device__ __forceinline__ float2 zero() { return make_float2(0.f, 0.f); }
};
template <> struct Pair2<__nv_bfloat16> {
  using type = __nv_bfloat162;
  static __device__ __forceinline__ __nv_bfloat162 zero() {
    return __floats2bfloat162_rn(0.f, 0.f);
  }
};
__device__ __forceinline__ float2 pair_f(float2 v) { return v; }
__device__ __forceinline__ float2 pair_f(__nv_bfloat162 v) { return __bfloat1622float2(v); }

// The registers of the GEMM's warpgroups (Regs of gemm_q8_tiles): a policy's
// producer() / consumer() run as each warpgroup starts, and kHoldRes says whether a
// consumer loads its tile's residual pairs (32 or 64 registers) before the main loop,
// holding them through it so that their latency hides under the products, or after
// it, in two halves of 8 pairs for the epilogue (q8_load_res: a policy short of
// registers). Q8RegsSplit, the standalone kernel's: the registers
// move from the producer to the consumers for the rest of the launch, and the
// residual is held.
struct Q8RegsSplit {
  static constexpr bool kHoldRes = true;
  static __device__ __forceinline__ void producer() { regs_dealloc<kQProducerRegs>(); }
  static __device__ __forceinline__ void consumer() { regs_alloc<kQConsumerRegs>(); }
};

// Residual pairs i0..i0 + 7 (of 16) of a consumer thread into side, as the GEMM's
// consumer loads them before its main loop: rows row0 and row0 + 8, columns col0 + 8 i.
template <typename TR, typename RP>
__device__ __forceinline__ void q8_load_res(RP (&side)[16][2], const TR* res, int row0, int col0,
                                            int M, int N, int i0) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
#pragma unroll
    for (int i = i0; i < i0 + 8; ++i) {
      const int col = col0 + i * 8;
      if (res != nullptr && row < M && col < N)
        side[i][h] = reinterpret_cast<const RP*>(res)[(static_cast<size_t>(row) * N + col) >> 1];
    }
  }
}

// The body of the GEMM, by all kQThreads threads of a block: out (M, N) =
// epilogue(A (M, K) @ W^T), W given K-major (N, K); int32 sums. The maps read A and
// W (int8, rows ld-padded) in 128 x 128-byte boxes. bias (N,) and res (M, N) in TR may
// be null. N % 4 == 0 (so the column pair at an even col is in bounds and aligned
// whenever col is). Persistent: the block walks the tiles blockIdx.x, + gridDim.x,
// ... of `grid`. smem_raw: the block's dynamic shared memory, kQSmem bytes; the ring's
// barriers at its q8_smem_base are initialised here, so they must hold no live
// barrier (mbar_inval the last call's). Regs: the registers' policy (Q8RegsSplit).
template <typename TO, typename TR, bool GELU, typename Regs>
__device__ __forceinline__ void gemm_q8_tiles(const CUtensorMap* tma_a, const CUtensorMap* tma_w,
                                              const float* rs, const float* ws,
                                              const float* bias, const TR* res, TO* out, int M,
                                              int N, const TileGrid& grid,
                                              unsigned char* smem_raw) {
  using RP = typename Pair2<TR>::type;
  // q8_smem_base, written out: through the call the standalone kernel's SASS moved
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* As = base;
  unsigned char* Ws = As + kQStages * kQStage;
  uint64_t* full = reinterpret_cast<uint64_t*>(Ws + kQStages * kQStage);
  uint64_t* empty = full + kQStages;
  float* sepi = reinterpret_cast<float*>(empty + kQStages);  // [2][ws | bias][kTileN]
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int tiles = grid.count();
  if (threadIdx.x == 0) {
    for (int s = 0; s < kQStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread keeps the ring full, across tiles
    Regs::producer();
    if (t == 0)
      produce_ring<kQStages>(grid, tiles, full, empty, 2 * kQStage,
                             [&](int s, int m0, int n0, int kt) {
                               tma_load_2d(As + s * kQStage, tma_a, &full[s], kt * kQBK, m0);
                               tma_load_2d(Ws + s * kQStage, tma_w, &full[s], kt * kQBK, n0);
                             });
  } else {
    // consumers: warpgroup wg owns rows m0 + 64 wg .. + 63 of each tile
    Regs::consumer();
    const int warp = t >> 5, lane = t & 31, g = lane >> 2, q = lane & 3;
    const int c = threadIdx.x;  // 0..255 over the consumers
    const unsigned a_base = smem_u32(As) + wg * 64 * kQBK;  // the warpgroup's 64 rows
    const unsigned w_base = smem_u32(Ws);
    int it = 0, parity = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, parity ^= 1) {
      int m0, n0, mt, z, kb, ke;
      grid.at(tile, m0, n0, mt, z, kb, ke);
      // the epilogue's operands, loaded now so that their latency hides under the main
      // loop: the tile's column scale and bias of column c (threads c < 128), this
      // thread's two row scales and its pairs of the residual, into registers
      float wsc = 0.f, bc = 0.f;
      if (c < kTileN && n0 + c < N) {
        wsc = ws[n0 + c];
        if (bias != nullptr) bc = bias[n0 + c];
      }
      float rsv[2];
      RP side[16][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wg * 64 + warp * 16 + g + 8 * h;
        rsv[h] = row < M ? rs[row] : 0.f;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int col = n0 + i * 8 + 2 * q;
          side[i][h] = Pair2<TR>::zero();
          if (Regs::kHoldRes && res != nullptr && row < M && col < N)
            side[i][h] =
                reinterpret_cast<const RP*>(res)[(static_cast<size_t>(row) * N + col) >> 1];
        }
      }
      int acc[64];
#pragma unroll
      for (int r = 0; r < 64; ++r) acc[r] = 0;
      for (int kt = kb; kt < ke; ++kt, ++it) {
        const int s = it % kQStages;
        mbar_wait(&full[s], (it / kQStages) & 1);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kQBK / 32; ++kk) {
          const unsigned a = a_base + s * kQStage;
          const unsigned w = w_base + s * kQStage;
          wgmma_m64n128k32_s8(acc, wgmma_desc(a + kk * 32, 16, 1024),
                              wgmma_desc(w + kk * 32, 16, 1024));
        }
        wgmma_commit();
        fence_regs(acc);
        wgmma_wait<0>();
        fence_regs(acc);
        if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with stage s
      }
      // not held: the first half of the residual pairs now, the second at the epilogue's
      // column 8, each half before the next store (loaded between the stores, each pair
      // would wait for the last: the compiler cannot rule out that out aliases res)
      if constexpr (!Regs::kHoldRes)
        q8_load_res(side, res, m0 + wg * 64 + warp * 16 + g, n0 + 2 * q, M, N, 0);

      // the column scales and bias to shared memory, in this tile's slot: the other
      // warpgroup may still read the last tile's slot in its epilogue, never the one
      // before it, since it met this barrier of the last tile after that epilogue
      float* sws = sepi + parity * 2 * kTileN;
      float* sbias = sws + kTileN;
      if (c < kTileN) {
        sws[c] = wsc;
        sbias[c] = bc;
      }
      bar_sync(256);

      // epilogue on the accumulators: thread (warp, g, q) holds rows 16 warp + g (+ 8),
      // columns 8 i + 2 q (+ 1): acc -> f32, * rs[row], * ws[col] (+ bias[col]) (+
      // res[row, col]) (-> tanh-GELU), one rounding to TO, in the JAX kernels' order
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        if constexpr (!Regs::kHoldRes)
          if (i == 8) q8_load_res(side, res, m0 + wg * 64 + warp * 16 + g, n0 + 2 * q, M, N, 8);
        const int cl = i * 8 + 2 * q, col = n0 + cl;
        if (col >= N) continue;  // N % 4 == 0: col + 1 < N too
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + wg * 64 + warp * 16 + g + 8 * h;
          if (row >= M) continue;
          float v0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * i + 2 * h]), rsv[h]), sws[cl]);
          float v1 =
              __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * i + 2 * h + 1]), rsv[h]), sws[cl + 1]);
          if (bias != nullptr) {
            v0 = __fadd_rn(v0, sbias[cl]);
            v1 = __fadd_rn(v1, sbias[cl + 1]);
          }
          if (res != nullptr) {
            const float2 r = pair_f(side[i][h]);
            v0 = __fadd_rn(v0, r.x);
            v1 = __fadd_rn(v1, r.y);
          }
          if (GELU) {
            v0 = gelu_tanh(v0);
            v1 = gelu_tanh(v1);
          }
          store_pair<TO>(out + static_cast<size_t>(row) * N + col, v0, v1, true);
        }
      }
    }
  }
}

}  // namespace istvt
