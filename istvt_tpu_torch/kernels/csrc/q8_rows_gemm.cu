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
//   * _mm_q8_res_ln_ff_q8_kernel (#3, quant -> out-proj + residual -> LN -> quant ->
//     fc1 -> GELU -> quant -> fc2 + residual): quant_rows, gemm, ln_quant_rows, gemm
//     (+ b1, GELU, f32), quant_rows, gemm (+ b2, + y);
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
// epilogue skips them.
#include "common.cuh"

namespace istvt {

// (i) LayerNorm (two-pass statistics, eps 1e-5) + per-row int8 quant.
// One warp per row. Mirrors kernels/linear._ln followed by _quant_rows.
template <typename T>
__global__ void __launch_bounds__(256) ln_quant_rows_kernel(
    const T* __restrict__ x, const float* __restrict__ s, const float* __restrict__ b,
    int8_t* __restrict__ q, float* __restrict__ rs, int R, int D) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + warp;
  if (row >= R) return;
  const T* xr = x + static_cast<size_t>(row) * D;
  // order-independent statistics, so the plain version yields the same int8 codes
  float mean, r;
  row_ln_stats(xr, D, lane, mean, r);
  float amax = 0.f;
  for (int d = lane; d < D; d += 32)
    amax = fmaxf(amax, fabsf(ln_affine(to_f(xr[d]), mean, r, s[d], b[d])));
  const float rsv = row_scale(warp_max(amax));
  int8_t* qr = q + static_cast<size_t>(row) * D;
  for (int d = lane; d < D; d += 32)
    qr[d] = quant_code(ln_affine(to_f(xr[d]), mean, r, s[d], b[d]), rsv);
  if (lane == 0) rs[row] = rsv;
}

// (ii) Per-row int8 quant alone (_quant_rows). One warp per row.
template <typename T>
__global__ void __launch_bounds__(256) quant_rows_kernel(
    const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ rs, int R, int D) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + warp;
  if (row >= R) return;
  const T* xr = x + static_cast<size_t>(row) * D;
  float amax = 0.f;
  for (int d = lane; d < D; d += 32) amax = fmaxf(amax, fabsf(to_f(xr[d])));
  const float rsv = row_scale(warp_max(amax));
  int8_t* qr = q + static_cast<size_t>(row) * D;
  for (int d = lane; d < D; d += 32) qr[d] = quant_code(to_f(xr[d]), rsv);
  if (lane == 0) rs[row] = rsv;
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4], const int (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// (iii) out[M, N] = epilogue(A[M, K] (int8) @ W[K, N] (int8)), int32 accumulate.
// epilogue: f32 acc * rs[m] * ws[n] (+ bias[n]) (+ res[m, n]) (-> tanh-GELU),
// rounded once to TO. The order of the f32 operations is the JAX kernels'
// (acc * rs * ws + b + r). K % 4 == 0 and N % 4 == 0 (checked by the caller).
constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kLDS = kBK / 4 + 4;  // ints per shared row: 8 data + 4 pad

template <typename TO, typename TR, bool GELU>
__global__ void __launch_bounds__(256) gemm_q8_kernel(
    const int8_t* __restrict__ A, const int8_t* __restrict__ W,
    const float* __restrict__ rs, const float* __restrict__ ws,
    const float* __restrict__ bias, const TR* __restrict__ res,
    TO* __restrict__ out, int M, int N, int K) {
  __shared__ int As[kBM * kLDS];
  __shared__ int Bs[kBN * kLDS];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;   // 2 x 4 warps, 64 x 32 each
  const int g = lane >> 2, t = lane & 3;     // mma group / thread-in-group
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // A tile: 128 rows x 8 words, 4 words per thread, k-contiguous.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * 256, r = idx >> 3, c = idx & 7;
      const int gm = m0 + r, gk = k0 + c * 4;
      int v = 0;
      if (gm < M && gk < K) v = *reinterpret_cast<const int*>(A + static_cast<size_t>(gm) * K + gk);
      As[r * kLDS + c] = v;
    }
    // W tile: 32 k x 128 n bytes = 8 x 32 blocks of 4x4 bytes, one per thread;
    // each block is transposed in registers so Bs holds 4 consecutive k of
    // one column per word (the mma "col" B layout).
    {
      const int kb = tid & 7, nb = tid >> 3;
      const int gk = k0 + kb * 4, gn = n0 + nb * 4;
      int r[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        r[j] = (gk + j < K && gn < N)
                   ? *reinterpret_cast<const int*>(W + static_cast<size_t>(gk + j) * N + gn)
                   : 0;
      const int t0 = __byte_perm(r[0], r[1], 0x5140), t1 = __byte_perm(r[0], r[1], 0x7362);
      const int t2 = __byte_perm(r[2], r[3], 0x5140), t3 = __byte_perm(r[2], r[3], 0x7362);
      Bs[(nb * 4 + 0) * kLDS + kb] = __byte_perm(t0, t2, 0x5410);
      Bs[(nb * 4 + 1) * kLDS + kb] = __byte_perm(t0, t2, 0x7632);
      Bs[(nb * 4 + 2) * kLDS + kb] = __byte_perm(t1, t3, 0x5410);
      Bs[(nb * 4 + 3) * kLDS + kb] = __byte_perm(t1, t3, 0x7632);
    }
    __syncthreads();
    int af[4][4], bf[4][2];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int rb = wm * 64 + mi * 16 + g;
      af[mi][0] = As[rb * kLDS + t];
      af[mi][1] = As[(rb + 8) * kLDS + t];
      af[mi][2] = As[rb * kLDS + t + 4];
      af[mi][3] = As[(rb + 8) * kLDS + t + 4];
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int cb = wn * 32 + ni * 8 + g;
      bf[ni][0] = Bs[cb * kLDS + t];
      bf[ni][1] = Bs[cb * kLDS + t + 4];
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * 64 + mi * 16 + g + 8 * h;
      if (row >= M) continue;
      const float rsv = rs[row];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn * 32 + ni * 8 + t * 2 + e;
          if (col >= N) continue;
          const size_t o = static_cast<size_t>(row) * N + col;
          float v = __fmul_rn(__fmul_rn(__int2float_rn(acc[mi][ni][2 * h + e]), rsv), ws[col]);
          if (bias != nullptr) v = __fadd_rn(v, bias[col]);
          if (res != nullptr) v = __fadd_rn(v, to_f(res[o]));
          if (GELU) v = gelu_tanh(v);
          out[o] = from_f<TO>(v);
        }
      }
    }
  }
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
