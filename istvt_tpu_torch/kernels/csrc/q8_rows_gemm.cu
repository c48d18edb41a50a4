// Row quantization and the W8A8 GEMM: the building blocks that the int8 serving
// kernels (kernels/quant.py) chain together.
//
// Replaces the in-kernel GEMM stages of the TPU kernels in
// istvt_tpu/kernels/quant.py:
//   * _ln_qkv_q8_temporal_kernel (#1, LN -> quant -> QKV) and _ln_matmul_q8_kernel
//     (#4, the same without the attention): ln_quant_rows, gemm (acc * rs * ws, rounded
//     to x's dtype);
//   * _mm_q8_ln_qkv_q8_spatial_kernel (#2, quant -> out-proj -> LN -> quant -> QKV) and
//     _mm_q8_ln_mm_q8_kernel (#8, the same without the attention): quant_rows, gemm
//     (+ b, into an f32 intermediate), ln_quant_rows, gemm;
//   * _matmul_q8_kernel / _matmul_q8_res_kernel (#5, quant -> GEMM + b [+ r]):
//     quant_rows, gemm (+ bias [+ residual], rounded to x's dtype);
//   * _ln_ff_q8_full_kernel (#7, LN -> quant -> fc1 -> GELU -> quant -> fc2 + b2 + x):
//     ln_quant_rows, gemm (+ b1, GELU, f32), quant_rows, gemm (+ b2, + x read in x's
//     own dtype, one rounding to it);
//   * _mm_q8_res_ln_ff_q8_kernel (#3, quant -> out-proj + residual -> LN -> quant ->
//     fc1 -> GELU -> quant -> fc2 + residual): quant_rows, gemm (+ b, + r, into an f32
//     y), then #7's four launches on y;
//   * _ln_ff_q8_kernel (#6, LN -> quant -> fc1 -> GELU -> bf16 fc2 + b2 + x): here
//     ln_quant_rows, gemm (+ b1, GELU, rounded to x's dtype), then float_gemm.cu's
//     gemm (+ b2, + x). The (rows, 2912) hidden makes a round trip through device
//     memory in x's dtype (5,152 x 2,912 x 2 bytes = 30 MB at the 2-clip slice, 240 MB
//     at B=16), where the TPU kernel keeps it in VMEM; the numbers are the same,
//     since JAX rounds the hidden to x's dtype before fc2.
//
// What bounds it on the H100: the GEMMs are int8 tensor-core work (about 7.1 TOP per
// B=16 forward, against 1,979 TOP/s); the row passes move bytes only. Each stage runs
// as its own launch with the intermediates in device memory.
//
// What the design does about it: the GEMM (gemm_q8_wgmma_kernel) is the float GEMM's
// design (float_gemm.cu) on the int8 tensor cores, built from the same parts of
// wgmma.cuh. A persistent block of 384 threads owns an SM and walks over 128 x 128
// output tiles; one producer thread fills a 4-stage ring of 128-deep A and W tiles
// (16 KB each) by TMA with the 128-byte swizzle, and two consumer warpgroups run
// wgmma m64n128k32 (s8 in, s32 sums) on 64 rows each, straight from shared memory.
// 8-bit wgmma reads both operands K-major only, so the weight comes as a K-major copy
// (N, Kp) of the stored (K, N) int8 codes, made once when the model is loaded
// (kernels/quant.kmajor): a transpose, no code changes. TMA wants row strides that are
// multiples of 16 bytes, and a 728-wide int8 row is not one: the activation codes
// (written here by the row passes) and the K-major copy have rows of Kp = K rounded
// up to 16 (736), while the tensor maps' K extent stays K, so TMA zero-fills the
// last k-tile's tail and never reads the pad bytes; rows past M and columns past N
// read as zeros too, and the epilogue masks its stores. The epilogue is the mma.sync
// tile's (q8_rows_gemm.cuh) in the same order, on the accumulator registers:
// acc -> f32, * rs[row], * ws[col] (+ bias[col]) (+ res[row, col] read in its own
// dtype) (-> tanh-GELU), one rounding to the output dtype; the s32 sums are exact in
// any order, so every output equals the mma.sync tile's bit for bit. The tile's
// column scales, bias, row scales and residual are loaded into registers before its
// main loop, so their latency hides under the products; the column scales and bias
// then go to shared memory for the epilogue. Measured on the H100 and left out
// (PERF.md): a 6-stage ring. The bodies of the row passes and the mma.sync tile are
// device functions in q8_rows_gemm.cuh, which q8_layer.cu (#9) runs inside its
// persistent kernel.
#include "q8_rows_gemm.cuh"
#include "wgmma.cuh"

namespace istvt {

// (i) LayerNorm + per-row int8 quant, one warp per row; the codes of row r at q + r ldq.
template <typename T>
__global__ void __launch_bounds__(256) ln_quant_rows_kernel(
    const T* __restrict__ x, const float* __restrict__ s, const float* __restrict__ b,
    int8_t* __restrict__ q, float* __restrict__ rs, int R, int D, int ldq) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= R) return;
  ln_quant_row(x, s, b, q, rs, row, D, ldq, threadIdx.x & 31);
}

// (ii) Per-row int8 quant alone, one warp per row.
template <typename T>
__global__ void __launch_bounds__(256) quant_rows_kernel(
    const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ rs, int R, int D,
    int ldq) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= R) return;
  quant_row(x, q, rs, row, D, ldq, threadIdx.x & 31);
}

// (iii) The W8A8 GEMM on wgmma (see the header): 128 x 128 x 128 block tiles, kQStages
// TMA-filled stages, warpgroups 0-1 consume, warpgroup 2 produces.
constexpr int kQBK = 128, kQThreads = 384;  // k-step (int8 elements = bytes), threads
// the ring's depth, and the registers a thread of the producer / consumer warpgroups
// keeps after setmaxnreg (of the block's 384 x 168 at launch)
constexpr int kQStages = 4, kQProducerRegs = 40, kQConsumerRegs = 232;
constexpr int kQStage = kTileM * kQBK;  // bytes of A (and of W, kTileN = kTileM) a stage
// Dynamic shared memory of a block: the A and W rings, the full / empty barriers, two
// slots (by tile parity) of the tile's column scales and bias [kTileN] each, and 1 KB
// to align the rings to the swizzle atom.
constexpr int kQSmem = kQStages * 2 * kQStage + 2 * kQStages * 8 + 4 * kTileN * 4 + 1024;

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

// out (M, N) = epilogue(A (M, K) @ W^T), W given K-major (N, K); int32 sums. The maps
// read A and W (int8, rows ld-padded) in 128 x 128-byte boxes. bias (N,) and res
// (M, N) in TR may be null. N % 4 == 0 (so the column pair at an even col is in
// bounds and aligned whenever col is). Persistent: each block walks the tiles
// blockIdx.x, + gridDim.x, ...
template <typename TO, typename TR, bool GELU>
__global__ void __launch_bounds__(kQThreads, 1) gemm_q8_wgmma_kernel(
    const __grid_constant__ CUtensorMap tma_a, const __grid_constant__ CUtensorMap tma_w,
    const float* __restrict__ rs, const float* __restrict__ ws, const float* __restrict__ bias,
    const TR* __restrict__ res, TO* __restrict__ out, int M, int N, TileGrid grid) {
  using RP = typename Pair2<TR>::type;
  extern __shared__ unsigned char smem_raw[];
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
    regs_dealloc<kQProducerRegs>();
    if (t == 0)
      produce_ring<kQStages>(grid, tiles, full, empty, 2 * kQStage,
                             [&](int s, int m0, int n0, int kt) {
                               tma_load_2d(As + s * kQStage, &tma_a, &full[s], kt * kQBK, m0);
                               tma_load_2d(Ws + s * kQStage, &tma_w, &full[s], kt * kQBK, n0);
                             });
  } else {
    // consumers: warpgroup wg owns rows m0 + 64 wg .. + 63 of each tile
    regs_alloc<kQConsumerRegs>();
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
          if (res != nullptr && row < M && col < N)
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
      // columns 8 i + 2 q (+ 1); gemm_q8_tile's arithmetic in its order
#pragma unroll
      for (int i = 0; i < 16; ++i) {
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

template <typename TO, typename TR, bool GELU>
int launch_gemm_q8(const CUtensorMap& ma, const CUtensorMap& mw, const void* rs, const void* ws,
                   const void* bias, const void* res, void* out, int M, int N, int K,
                   cudaStream_t st) {
  auto kern = gemm_q8_wgmma_kernel<TO, TR, GELU>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kQSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int nk = (K + kQBK - 1) / kQBK;
  const TileGrid grid{(N + kTileN - 1) / kTileN, (M + kTileM - 1) / kTileM, 1, nk, nk};
  const int tiles = grid.tn * grid.tm;
  kern<<<tiles < sm_count() ? tiles : sm_count(), kQThreads, kQSmem, st>>>(
      ma, mw, static_cast<const float*>(rs), static_cast<const float*>(ws),
      static_cast<const float*>(bias), static_cast<const TR*>(res), static_cast<TO*>(out), M, N,
      grid);
  return 0;
}

template <typename TO, typename TR>
int launch_gemm_q8_t(const CUtensorMap& ma, const CUtensorMap& mw, const void* rs,
                     const void* ws, const void* bias, const void* res, void* out, int gelu,
                     int M, int N, int K, cudaStream_t st) {
  return gelu ? launch_gemm_q8<TO, TR, true>(ma, mw, rs, ws, bias, res, out, M, N, K, st)
              : launch_gemm_q8<TO, TR, false>(ma, mw, rs, ws, bias, res, out, M, N, K, st);
}

}  // namespace istvt

using namespace istvt;

extern "C" {

// x (R, D) in x_dt -> codes q (row r at q + r ldq, ldq >= D), row scales rs (R,).
int istvt_ln_quant_rows(const void* x, int x_dt, const void* s, const void* b, void* q, int ldq,
                        void* rs, int R, int D, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const int blocks = (R + 7) / 8;
  auto S = static_cast<const float*>(s);
  auto B = static_cast<const float*>(b);
  auto Q = static_cast<int8_t*>(q);
  auto RS = static_cast<float*>(rs);
  if (x_dt == kBF16)
    ln_quant_rows_kernel<__nv_bfloat16><<<blocks, 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), S, B, Q, RS, R, D, ldq);
  else
    ln_quant_rows_kernel<float><<<blocks, 256, 0, st>>>(static_cast<const float*>(x), S, B, Q,
                                                        RS, R, D, ldq);
  return static_cast<int>(cudaGetLastError());
}

int istvt_quant_rows(const void* x, int x_dt, void* q, int ldq, void* rs, int R, int D,
                     void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const int blocks = (R + 7) / 8;
  auto Q = static_cast<int8_t*>(q);
  auto RS = static_cast<float*>(rs);
  if (x_dt == kBF16)
    quant_rows_kernel<__nv_bfloat16><<<blocks, 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), Q, RS, R, D, ldq);
  else
    quant_rows_kernel<float><<<blocks, 256, 0, st>>>(static_cast<const float*>(x), Q, RS, R, D,
                                                     ldq);
  return static_cast<int>(cudaGetLastError());
}

// out (M, N) = epilogue(A @ W^T): a the (M, K) int8 codes with rows lda bytes apart, w
// the int8 weight K-major, (N, K) with rows ldw bytes apart (lda, ldw multiples of 16,
// both 16-byte aligned; K % 4 == 0, N % 4 == 0; checked by the caller); rs (M,), ws
// (N,) f32; bias f32 (N,) and res (M, N) in res_dt may be null; out (M, N) in out_dt
// (0 f32, 1 bf16); gelu: tanh-GELU last.
int istvt_gemm_q8(const void* a, int lda, const void* w, int ldw, const void* rs,
                  const void* ws, const void* bias, const void* res, int res_dt, void* out,
                  int out_dt, int gelu, int M, int N, int K, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (M == 0 || N == 0) return 0;
  CUtensorMap ma, mw;
  if (K < 1 || N % 4 || !tile_map(&ma, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a, M, K, lda, kTileM) ||
      !tile_map(&mw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, N, K, ldw, kTileN) || sm_count() < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int rc;
  if (out_dt == kBF16)
    rc = res_dt == kBF16 ? launch_gemm_q8_t<__nv_bfloat16, __nv_bfloat16>(
                               ma, mw, rs, ws, bias, res, out, gelu, M, N, K, st)
                         : launch_gemm_q8_t<__nv_bfloat16, float>(ma, mw, rs, ws, bias, res,
                                                                  out, gelu, M, N, K, st);
  else
    rc = res_dt == kBF16 ? launch_gemm_q8_t<float, __nv_bfloat16>(ma, mw, rs, ws, bias, res, out,
                                                                  gelu, M, N, K, st)
                         : launch_gemm_q8_t<float, float>(ma, mw, rs, ws, bias, res, out, gelu, M,
                                                          N, K, st);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
