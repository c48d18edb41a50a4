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
// What bounds it on the H100: the GEMMs are int8 tensor-core work (about
// 7 TOP per B=16 forward); the row passes move bytes only. At the slice #4, #5 and
// the row passes are bound by bytes (the (rows, 1536) bf16 QKV written once is the
// largest stream), #8 and #6 by operations. This first version runs each stage as
// its own launch with the intermediates in device memory, so it is bound by those
// round trips and by the GEMM's single-buffered shared-memory pipeline (one
// __syncthreads pair per 32-deep k step, no cp.async/TMA, no wgmma). What the design
// does about it: the GEMM uses the int8 tensor cores through mma.sync m16n8k32
// (128x128 block tile, 8 warps of 64x32), transposes the (K, N) weight tile
// in registers with byte permutes so both fragments load as 32-bit words
// from padded, conflict-free shared memory, and fuses the whole f32
// epilogue (x row scale x column scale + bias + residual, tanh-GELU, cast)
// so the int32 accumulator never leaves registers. Rows need not fill the
// 128-row tile (B * 7 * 368 rows is a multiple of 128 only when B is one of
// 8; the 2-clip slice has 5,152): the A loads zero-fill rows >= M and the
// epilogue skips them. The bodies are device functions in q8_rows_gemm.cuh, which
// q8_layer.cu (#9) runs inside its persistent kernel.
#include "q8_rows_gemm.cuh"

namespace istvt {

// (i) LayerNorm + per-row int8 quant, one warp per row.
template <typename T>
__global__ void __launch_bounds__(256) ln_quant_rows_kernel(
    const T* __restrict__ x, const float* __restrict__ s, const float* __restrict__ b,
    int8_t* __restrict__ q, float* __restrict__ rs, int R, int D) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= R) return;
  ln_quant_row(x, s, b, q, rs, row, D, threadIdx.x & 31);
}

// (ii) Per-row int8 quant alone, one warp per row.
template <typename T>
__global__ void __launch_bounds__(256) quant_rows_kernel(
    const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ rs, int R, int D) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= R) return;
  quant_row(x, q, rs, row, D, threadIdx.x & 31);
}

// (iii) The W8A8 GEMM, one 128 x 128 output tile per block.
template <typename TO, typename TR, bool GELU>
__global__ void __launch_bounds__(256) gemm_q8_kernel(
    const int8_t* __restrict__ A, const int8_t* __restrict__ W,
    const float* __restrict__ rs, const float* __restrict__ ws,
    const float* __restrict__ bias, const TR* __restrict__ res,
    TO* __restrict__ out, int M, int N, int K) {
  __shared__ int smem[kGemmSmemInts];
  gemm_q8_tile<TO, TR, GELU>(A, W, rs, ws, bias, res, out, M, N, K, blockIdx.x, blockIdx.y,
                             smem);
}

template <typename TO, typename TR>
void launch_gemm(const void* a, const void* w, const void* rs, const void* ws, const void* bias,
                 const void* res, void* out, int gelu, int M, int N, int K, cudaStream_t st) {
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  auto A = static_cast<const int8_t*>(a);
  auto W = static_cast<const int8_t*>(w);
  auto RS = static_cast<const float*>(rs);
  auto WS = static_cast<const float*>(ws);
  auto B = static_cast<const float*>(bias);
  auto Rp = static_cast<const TR*>(res);
  auto O = static_cast<TO*>(out);
  if (gelu)
    gemm_q8_kernel<TO, TR, true><<<grid, 256, 0, st>>>(A, W, RS, WS, B, Rp, O, M, N, K);
  else
    gemm_q8_kernel<TO, TR, false><<<grid, 256, 0, st>>>(A, W, RS, WS, B, Rp, O, M, N, K);
}

}  // namespace istvt

using namespace istvt;

extern "C" {

int istvt_ln_quant_rows(const void* x, int x_dt, const void* s, const void* b, void* q,
                        void* rs, int R, int D, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const int blocks = (R + 7) / 8;
  auto S = static_cast<const float*>(s);
  auto B = static_cast<const float*>(b);
  auto Q = static_cast<int8_t*>(q);
  auto RS = static_cast<float*>(rs);
  if (x_dt == kBF16)
    ln_quant_rows_kernel<__nv_bfloat16><<<blocks, 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), S, B, Q, RS, R, D);
  else
    ln_quant_rows_kernel<float><<<blocks, 256, 0, st>>>(static_cast<const float*>(x), S, B, Q,
                                                        RS, R, D);
  return static_cast<int>(cudaGetLastError());
}

int istvt_quant_rows(const void* x, int x_dt, void* q, void* rs, int R, int D, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const int blocks = (R + 7) / 8;
  auto Q = static_cast<int8_t*>(q);
  auto RS = static_cast<float*>(rs);
  if (x_dt == kBF16)
    quant_rows_kernel<__nv_bfloat16><<<blocks, 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), Q, RS, R, D);
  else
    quant_rows_kernel<float><<<blocks, 256, 0, st>>>(static_cast<const float*>(x), Q, RS, R, D);
  return static_cast<int>(cudaGetLastError());
}

// res_dt / out_dt: 0 f32, 1 bf16. bias and res may be null.
int istvt_gemm_q8(const void* a, const void* w, const void* rs, const void* ws, const void* bias,
                  const void* res, int res_dt, void* out, int out_dt, int gelu, int M, int N,
                  int K, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (out_dt == kBF16) {
    if (res_dt == kBF16)
      launch_gemm<__nv_bfloat16, __nv_bfloat16>(a, w, rs, ws, bias, res, out, gelu, M, N, K, st);
    else
      launch_gemm<__nv_bfloat16, float>(a, w, rs, ws, bias, res, out, gelu, M, N, K, st);
  } else {
    if (res_dt == kBF16)
      launch_gemm<float, __nv_bfloat16>(a, w, rs, ws, bias, res, out, gelu, M, N, K, st);
    else
      launch_gemm<float, float>(a, w, rs, ws, bias, res, out, gelu, M, N, K, st);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
