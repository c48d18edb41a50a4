// LayerNorm rows and the float GEMM with its fused epilogue: the building blocks of
// the float fused forward's three projection kernels (kernels/linear.py,
// kernels/mlp.py).
//
// Replaces three TPU kernels:
//   * istvt_tpu/kernels/linear.py _ln_matmul_impl (_ln_matmul_kernel): LN -> x @ w,
//     here ln_rows then gemm;
//   * istvt_tpu/kernels/linear.py _matmul_bias_impl (_matmul_bias[_res]_kernel):
//     x @ w + b (+ r), here one gemm;
//   * istvt_tpu/kernels/mlp.py _ln_ff_res_impl (_ln_ff_res_kernel): x + fc2(gelu(fc1(LN x))),
//     here ln_rows, gemm (+ b1, tanh-GELU), gemm (+ b2, + x).
//
// What bounds them on the H100: at B=16 the GEMMs are 92 GFLOP (QKV), 31 GFLOP
// (out-projection) and 350 GFLOP (FF) per layer against 989 TFLOP/s of bf16 tensor
// cores, so they are bound by operations; the LN rows pass moves bytes only. The TPU
// kernels kept the normalised rows and the (N, 4D) FF hidden in VMEM; this first
// version writes both to device memory in the activation dtype (the numbers are the
// same: JAX casts both to that dtype before the next product), which costs one extra
// round trip per LN and 240 MB per FF layer at B=16 bf16.
//
// What the design does about it: the bf16 GEMM runs on the tensor cores through
// mma.sync m16n8k16 (f32 accumulate) with a 128x128x32 block tile, 8 warps of 64x32,
// and a two-stage cp.async pipeline in shared memory. A is read with ldmatrix; the
// weight stays in JAX's (in, out) = (K, N) row-major layout and ldmatrix.trans gives
// the mma its column-major B fragment, so no transposed copy is ever made. K = 728
// and N = 728 are not multiples of the tile: cp.async zero-fills the K tail and the
// M / N edges in shared memory (16-byte chunks, so K % 8 == N % 8 == 0 is required)
// and the epilogue masks the stores. The whole epilogue (+ bias, tanh-GELU,
// + residual in f32, one rounding) runs on the accumulator registers in the JAX
// order. Float32 inputs run a plain FMA tile (64x64, 4x4 outputs a thread): no TF32,
// so f32 results stay within rounding of the f32 reference. Not yet used: TMA,
// wgmma, a deeper pipeline, a persistent schedule, and fusing LN into the A load.
#include "common.cuh"

namespace istvt {

// (i) LayerNorm rows: y = LN(x) * s + b in x's dtype. One warp per row.
template <typename T>
__global__ void __launch_bounds__(256) ln_rows_kernel(
    const T* __restrict__ x, const float* __restrict__ s, const float* __restrict__ b,
    T* __restrict__ y, int R, int D) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + warp;
  if (row >= R) return;
  const T* xr = x + static_cast<size_t>(row) * D;
  float mean, r;
  row_ln_stats(xr, D, lane, mean, r);
  T* yr = y + static_cast<size_t>(row) * D;
  for (int d = lane; d < D; d += 32) yr[d] = from_f<T>(ln_affine(to_f(xr[d]), mean, r, s[d], b[d]));
}

// The f32 epilogue of every GEMM: acc (+ bias) (-> tanh-GELU) (+ res), rounded once.
template <typename T>
__device__ __forceinline__ void store_out(T* __restrict__ out, const float* __restrict__ bias,
                                          const T* __restrict__ res, bool gelu, float v,
                                          size_t o, int col) {
  if (bias != nullptr) v = __fadd_rn(v, bias[col]);
  if (gelu) v = gelu_tanh(v);
  if (res != nullptr) v = __fadd_rn(v, to_f(res[o]));
  out[o] = from_f<T>(v);
}

// (ii) bf16 tensor-core GEMM: out[M, N] = epilogue(A[M, K] @ W[K, N]).
constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kAS = kBK + 8;  // bf16 per A row in shared memory: 80 B, conflict-free ldmatrix
constexpr int kWS = kBN + 8;  // bf16 per W row in shared memory: 272 B

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = full ? 16 : 0;  // 0: write 16 zero bytes, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
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

// One k-step's tiles into shared memory: A 128 x 32 and W 32 x 128, 2 + 2 chunks of
// 16 B a thread; chunks past M, N or K are zero-filled.
__device__ __forceinline__ void load_tiles(__nv_bfloat16* As, __nv_bfloat16* Ws,
                                           const __nv_bfloat16* __restrict__ A,
                                           const __nv_bfloat16* __restrict__ W, int M, int N,
                                           int K, int m0, int n0, int k0, int tid) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + i * 256, r = idx >> 2, c = (idx & 3) * 8;
    const int gm = m0 + r, gk = k0 + c;
    const bool in = gm < M && gk < K;
    cp_async16(As + r * kAS + c, in ? A + static_cast<size_t>(gm) * K + gk : A, in);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + i * 256, r = idx >> 4, c = (idx & 15) * 8;
    const int gk = k0 + r, gn = n0 + c;
    const bool in = gk < K && gn < N;
    cp_async16(Ws + r * kWS + c, in ? W + static_cast<size_t>(gk) * N + gn : W, in);
  }
}

__global__ void __launch_bounds__(256) gemm_bf16_kernel(
    const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ W,
    const float* __restrict__ bias, const __nv_bfloat16* __restrict__ res,
    __nv_bfloat16* __restrict__ out, int gelu, int M, int N, int K) {
  __shared__ __align__(16) __nv_bfloat16 As[2][kBM * kAS];
  __shared__ __align__(16) __nv_bfloat16 Ws[2][kBK * kWS];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps, 64 x 32 each
  const int g = lane >> 2, t = lane & 3;    // mma group / thread-in-group
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nk = (K + kBK - 1) / kBK;
  load_tiles(As[0], Ws[0], A, W, M, N, K, m0, n0, 0, tid);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) load_tiles(As[cur ^ 1], Ws[cur ^ 1], A, W, M, N, K, m0, n0, (kt + 1) * kBK, tid);
    asm volatile("cp.async.commit_group;\n" ::);  // (possibly empty) group of step kt + 1
    asm volatile("cp.async.wait_group 1;\n" ::);  // step kt's tiles have landed
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      unsigned af[4][4], bfr[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_x4(af[mi], &As[cur][(wm * 64 + mi * 16 + (lane & 15)) * kAS + kk + (lane >> 4) * 8]);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        ldsm_x4_trans(bfr[nj], &Ws[cur][(kk + (lane & 15)) * kWS + wn * 32 + nj * 16 + (lane >> 4) * 8]);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[mi][ni], af[mi], bfr[ni >> 1][(ni & 1) * 2], bfr[ni >> 1][(ni & 1) * 2 + 1]);
    }
    __syncthreads();  // every warp is done with `cur` before step kt + 2 refills it
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * 64 + mi * 16 + g + 8 * h;
      if (row >= M) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn * 32 + ni * 8 + t * 2 + e;
          if (col < N)
            store_out(out, bias, res, gelu != 0, acc[mi][ni][2 * h + e],
                      static_cast<size_t>(row) * N + col, col);
        }
      }
    }
  }
}

// (iii) float32 GEMM on the FMA pipes (no TF32): 64 x 64 block tile, 16 deep,
// each thread 4 x 4 outputs at rows ty + 16 i, columns tx + 16 j.
constexpr int kFM = 64, kFN = 64, kFK = 16;

__global__ void __launch_bounds__(256) gemm_f32_kernel(
    const float* __restrict__ A, const float* __restrict__ W, const float* __restrict__ bias,
    const float* __restrict__ res, float* __restrict__ out, int gelu, int M, int N, int K) {
  __shared__ float As[kFK][kFM + 4];  // transposed: [k][m]
  __shared__ float Ws[kFK][kFN + 4];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * kFM, n0 = blockIdx.x * kFN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kFK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * 256, r = idx >> 4, c = idx & 15;
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? A[static_cast<size_t>(gm) * K + gk] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * 256, r = idx >> 6, c = idx & 63;
      const int gk = k0 + r, gn = n0 + c;
      Ws[r][c] = (gk < K && gn < N) ? W[static_cast<size_t>(gk) * N + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float a[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = Ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < N) store_out(out, bias, res, gelu != 0, acc[i][j], static_cast<size_t>(row) * N + col, col);
    }
  }
}

}  // namespace istvt

using namespace istvt;

extern "C" {

// x (R, D) -> y (R, D), both in dtype x_dt (0 f32, 1 bf16); s, b f32 (D,).
int istvt_ln_rows(const void* x, int x_dt, const void* s, const void* b, void* y, int R, int D,
                  void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const int blocks = (R + 7) / 8;
  auto S = static_cast<const float*>(s);
  auto B = static_cast<const float*>(b);
  if (x_dt == kBF16)
    ln_rows_kernel<__nv_bfloat16><<<blocks, 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), S, B, static_cast<__nv_bfloat16*>(y), R, D);
  else
    ln_rows_kernel<float><<<blocks, 256, 0, st>>>(static_cast<const float*>(x), S, B,
                                                  static_cast<float*>(y), R, D);
  return static_cast<int>(cudaGetLastError());
}

// out (M, N) = a (M, K) @ w (K, N) (+ bias) (-> tanh-GELU) (+ res); a, w, res, out
// in dtype dt (0 f32, 1 bf16), row-major, 16-byte aligned; bias f32 (N,); bias and
// res may be null. K % 8 == 0 and N % 8 == 0 (checked by the caller).
int istvt_gemm(const void* a, const void* w, int dt, const void* bias, const void* res,
               void* out, int gelu, int M, int N, int K, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto B = static_cast<const float*>(bias);
  if (dt == kBF16) {
    dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
    gemm_bf16_kernel<<<grid, 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(w), B,
        static_cast<const __nv_bfloat16*>(res), static_cast<__nv_bfloat16*>(out), gelu, M, N,
        K);
  } else {
    dim3 grid((N + kFN - 1) / kFN, (M + kFM - 1) / kFM);
    gemm_f32_kernel<<<grid, 256, 0, st>>>(static_cast<const float*>(a),
                                          static_cast<const float*>(w), B,
                                          static_cast<const float*>(res),
                                          static_cast<float*>(out), gelu, M, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
