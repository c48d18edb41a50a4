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
// read as zeros too, and the epilogue masks its stores. The epilogue works on the
// accumulator registers in the JAX kernels' order: acc -> f32, * rs[row], * ws[col]
// (+ bias[col]) (+ res[row, col] read in its own dtype) (-> tanh-GELU), one rounding
// to the output dtype; the s32 sums are exact in any order, so every output equals
// the plain version's bit for bit (but GELU's tanhf). The tile's column scales, bias,
// row scales and residual are loaded into registers before its main loop, so their
// latency hides under the products; the column scales and bias then go to shared
// memory for the epilogue. Measured on the H100 and left out (PERF.md): a 6-stage
// ring. The bodies of the row passes and of the GEMM (gemm_q8_tiles) are device
// functions in q8_rows_gemm.cuh, which q8_layer.cu (#9) runs inside its persistent
// kernel.
#include "q8_rows_gemm.cuh"

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

// (iii) The W8A8 GEMM on wgmma (see the header; the body, gemm_q8_tiles, is in
// q8_rows_gemm.cuh): out (M, N) = epilogue(A (M, K) @ W^T), W given K-major (N, K).
template <typename TO, typename TR, bool GELU>
__global__ void __launch_bounds__(kQThreads, 1) gemm_q8_wgmma_kernel(
    const __grid_constant__ CUtensorMap tma_a, const __grid_constant__ CUtensorMap tma_w,
    const float* __restrict__ rs, const float* __restrict__ ws, const float* __restrict__ bias,
    const TR* __restrict__ res, TO* __restrict__ out, int M, int N, TileGrid grid) {
  extern __shared__ unsigned char smem_raw[];
  gemm_q8_tiles<TO, TR, GELU, Q8RegsSplit>(&tma_a, &tma_w, rs, ws, bias, res, out, M, N, grid,
                                           smem_raw);
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
