// LayerNorm rows, the float GEMM with its fused epilogues, the LayerNorm-backward
// rows and a column-sum pass: the building blocks of the float fused path's
// projection kernels, forward and backward (kernels/linear.py, kernels/mlp.py).
//
// Replaces six TPU kernels, and serves as the second half of a seventh:
//   * istvt_tpu/kernels/linear.py _ln_matmul_impl (_ln_matmul_kernel): LN -> x @ w,
//     here ln_rows then gemm;
//   * istvt_tpu/kernels/linear.py _matmul_bias_impl (_matmul_bias[_res]_kernel):
//     x @ w + b (+ r), here one gemm;
//   * istvt_tpu/kernels/mlp.py _ln_ff_res_impl (_ln_ff_res_kernel): x + fc2(gelu(fc1(LN x))),
//     here ln_rows, gemm (+ b1, tanh-GELU), gemm (+ b2, + x); its training variant
//     (stash_h1) also writes the pre-GELU h1 from fc1's epilogue (`out2`);
//   * istvt_tpu/kernels/mlp.py _fused_ff_impl (_ff_kernel): fc2(gelu(fc1(x))) without
//     LN or residual, the attention-map path's feed-forward on its unpadded
//     B * 7 * 362 rows, here gemm (+ b1, tanh-GELU), gemm (+ b2);
//   * istvt_tpu/kernels/linear.py _ln_matmul_bwd_impl (_ln_matmul_bwd_kernel): here
//     ln_rows (y), gemm NT (dy = g w^T, f32), ln_bwd_rows (dx and the ds / db column
//     partials), colsum, gemm TN (dw = y^T g, f32);
//   * (fc2 of) istvt_tpu/kernels/quant.py _ln_ff_q8_impl (_ln_ff_q8_kernel, the
//     q8_ff='mixed' FF): gemm (+ b2, + x) on the GELU hidden that
//     q8_rows_gemm.cu's int8 fc1 rounded to x's dtype;
//   * istvt_tpu/kernels/mlp.py _ln_ff_bwd_impl (_ln_ff_bwd_kernel): here ln_rows (y),
//     gemm NT with the GELU-backward epilogue (dh1 = (g w2^T) * gelu'(h1) in x's dtype,
//     gelu(h1) for dw2, db1 column partials), colsum, gemm TN (dw2, dw1, f32), gemm NT
//     (dy = dh1 w1^T, f32), ln_bwd_rows (+ g; ds, dbn, db2 partials), colsum.
//
// What bounds them on the H100: at B=16 the GEMMs are 92 GFLOP (QKV), 31 GFLOP
// (out-projection) and 350 GFLOP (FF) per layer forward, and 3x / 5x that for the
// LN->GEMM / FF backward, against 989 TFLOP/s of bf16 tensor cores, so they are bound
// by operations; the rows passes move bytes only. The TPU kernels kept the normalised
// rows, the (N, 4D) FF hidden and the backward's dy / dh1 in VMEM; this first version
// writes them to device memory in the dtype JAX rounds them to (the activation dtype,
// or f32 where the JAX kernel keeps f32), so the numbers are the same at the cost of
// extra round trips. In f32 (the attention-map path's dtype) the GEMMs run on the FMA
// pipes, 67 TFLOP/s at most.
//
// What the design does about it: the bf16 GEMM runs on the tensor cores through
// mma.sync m16n8k16 (f32 accumulate) with a 128x128x32 block tile, 8 warps of 64x32,
// and a two-stage cp.async pipeline in shared memory. Each operand is read from its
// stored layout with ldmatrix, transposing where the mma wants the other order, so no
// transposed copy is ever made: NN (forward: A (M, K), W (K, N)), NT (dY = G W^T: the
// (K_out, N_out) = (N, K) weight is already the column-major B the mma wants, so
// ldmatrix without .trans) and TN (dW = Y^T G: A stored (K, M), ldmatrix.trans on A).
// K = 728 and N = 728 are not multiples of the tile: cp.async zero-fills the K tail and
// the M / N edges in shared memory (16-byte chunks, so every operand's contiguous
// extent must be a multiple of 8) and the epilogue masks the stores. The epilogue (+
// bias, stash, tanh-GELU, + residual; or the GELU derivative) runs on the accumulator
// registers in the JAX order, in f32, with one rounding. Column sums over rows (db1,
// ds, db) are written per block as partials and added by a second pass in a fixed
// order, not with atomics, so every result is deterministic. Float32 inputs run a
// plain FMA tile (64x64, 4x4 outputs a thread) with the same layouts and epilogues: no
// TF32, so f32 results stay within rounding of the f32 reference. Not yet used: TMA,
// wgmma, a deeper pipeline, a persistent schedule, split-K for the weight gradients
// (the 728 x 1536 dW grid is 72 tiles, under one wave of 132 SMs), and fusing LN into
// the A load.
#include "mma.cuh"

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

// tanh-GELU value and derivative (kernels/mlp._gelu_tanh_and_grad, term for term):
// u = c (h + a h^3), t = tanh u, val = h/2 (1 + t),
// dval = (1 + t)/2 + h/2 (1 - t^2) c (1 + 3a h^2).
__device__ __forceinline__ void gelu_tanh_and_grad(float h, float& val, float& dval) {
  const float c = 0.7978845608028654f, a = 0.044715f, a3 = 0.134145f;
  const float u = __fmul_rn(c, __fadd_rn(h, __fmul_rn(__fmul_rn(__fmul_rn(a, h), h), h)));
  const float t = tanhf(u);
  const float half_h = __fmul_rn(0.5f, h);
  const float one_t = __fadd_rn(1.0f, t);
  val = __fmul_rn(half_h, one_t);
  const float sech2 = __fsub_rn(1.0f, __fmul_rn(t, t));
  const float poly = __fadd_rn(1.0f, __fmul_rn(__fmul_rn(a3, h), h));
  dval = __fadd_rn(__fmul_rn(0.5f, one_t), __fmul_rn(__fmul_rn(__fmul_rn(half_h, sech2), c), poly));
}

// Operand layouts of a GEMM out (M, N) = A @ B: NN A (M, K), B (K, N); NT A (M, K),
// B given as (N, K); TN A given as (K, M), B (K, N). All row-major.
constexpr int kNN = 0, kNT = 1, kTN = 2;
// Epilogues (a template parameter, so the serving forward's GEMMs carry none of the
// training's code): kEpiStd acc (+ bias) (-> tanh-GELU) (+ res); kEpiStash the same
// with the pre-activation also stored to out2; kEpiGeluBwd acc * gelu'(aux) with
// gelu(aux) -> out2 and column sums -> part.
constexpr int kEpiStd = 0, kEpiGeluBwd = 1, kEpiStash = 2;

struct Epi {
  const float* bias;  // (N,) f32, or null (kEpiStd)
  const void* res;    // (M, N) in the input dtype, or null (kEpiStd)
  void* out2;         // (M, N) in the input dtype: kEpiStash the pre-activation,
                      // kEpiGeluBwd gelu(aux)
  const void* aux;    // (M, N) in the input dtype (kEpiGeluBwd)
  float* part;        // (gridDim.y, N) column sums of the f32 result per block row
                      // (kEpiGeluBwd)
  int gelu;
};

// The f32 epilogue value at (row, col) = flat index o, in the JAX order; writes the
// side output; the caller rounds the returned value once into out.
template <typename T, int EPI>
__device__ __forceinline__ float epi_value(const Epi& e, float v, size_t o, int col) {
  if (EPI == kEpiGeluBwd) {
    float val, dval;
    gelu_tanh_and_grad(to_f(static_cast<const T*>(e.aux)[o]), val, dval);
    static_cast<T*>(e.out2)[o] = from_f<T>(val);
    return __fmul_rn(v, dval);
  }
  if (e.bias != nullptr) v = __fadd_rn(v, e.bias[col]);
  if (EPI == kEpiStash) static_cast<T*>(e.out2)[o] = from_f<T>(v);
  if (e.gelu) v = gelu_tanh(v);
  if (e.res != nullptr) v = __fadd_rn(v, to_f(static_cast<const T*>(e.res)[o]));
  return v;
}

// (ii) bf16 tensor-core GEMM.
constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kAS = kBK + 8;  // bf16 per row of an X-major tile [x][k]: 80 B, no conflicts
constexpr int kWS = kBN + 8;  // bf16 per row of a K-major tile [k][x]: 272 B
// bf16 per stage of an operand's tile, K-major or X-major
__host__ __device__ constexpr int tile_elems(bool k_major) {
  return k_major ? kBK * kWS : kBM * kAS;
}

// One k-step's 128 x 32 tile of an operand into shared memory, 2 chunks of 16 B a
// thread; chunks past X or K are zero-filled. X-major: G is (X, K) row-major, tile
// [x][k] (stride kAS). K-major: G is (K, X) row-major, tile [k][x] (stride kWS).
template <bool KMajor>
__device__ __forceinline__ void load_op(__nv_bfloat16* S, const __nv_bfloat16* __restrict__ G,
                                        int X, int K, int x0, int k0, int tid) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + i * 256;
    if (KMajor) {
      const int r = idx >> 4, c = (idx & 15) * 8, gk = k0 + r, gx = x0 + c;
      const bool in = gk < K && gx < X;
      cp_async16(S + r * kWS + c, in ? G + static_cast<size_t>(gk) * X + gx : G, in);
    } else {
      const int r = idx >> 2, c = (idx & 3) * 8, gx = x0 + r, gk = k0 + c;
      const bool in = gx < X && gk < K;
      cp_async16(S + r * kAS + c, in ? G + static_cast<size_t>(gx) * K + gk : G, in);
    }
  }
}

// The mma A fragment of rows x0..x0+15, k kk..kk+15 (matrices: rows 0-7 / 8-15 by
// k 0-7, then by k 8-15).
template <bool KMajor>
__device__ __forceinline__ void frag_a(unsigned (&r)[4], const __nv_bfloat16* S, int x0, int kk,
                                       int lane) {
  if (KMajor)
    ldsm_x4_trans(r, &S[(kk + ((lane >> 4) << 3) + (lane & 7)) * kWS + x0 + ((lane >> 3) & 1) * 8]);
  else
    ldsm_x4(r, &S[(x0 + (lane & 15)) * kAS + kk + (lane >> 4) * 8]);
}

// The mma B fragments of columns x0..x0+15 (two n8 blocks), k kk..kk+15 (matrices:
// n 0-7 by k 0-7 / 8-15, then n 8-15 by k 0-7 / 8-15).
template <bool KMajor>
__device__ __forceinline__ void frag_b(unsigned (&r)[4], const __nv_bfloat16* S, int x0, int kk,
                                       int lane) {
  if (KMajor)
    ldsm_x4_trans(r, &S[(kk + (lane & 15)) * kWS + x0 + (lane >> 4) * 8]);
  else
    ldsm_x4(r, &S[(x0 + ((lane >> 4) << 3) + (lane & 7)) * kAS + kk + ((lane >> 3) & 1) * 8]);
}

template <int L, typename OutT, int EPI>
__global__ void __launch_bounds__(256) gemm_bf16_kernel(
    const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ B,
    OutT* __restrict__ out, Epi epi, int M, int N, int K) {
  constexpr bool kAk = L == kTN, kBk = L != kNT;  // is each operand stored K-major?
  __shared__ __align__(16) __nv_bfloat16 As[2][tile_elems(kAk)];
  __shared__ __align__(16) __nv_bfloat16 Bs[2][tile_elems(kBk)];
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
  load_op<kAk>(As[0], A, M, K, m0, 0, tid);
  load_op<kBk>(Bs[0], B, N, K, n0, 0, tid);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {
      load_op<kAk>(As[cur ^ 1], A, M, K, m0, (kt + 1) * kBK, tid);
      load_op<kBk>(Bs[cur ^ 1], B, N, K, n0, (kt + 1) * kBK, tid);
    }
    asm volatile("cp.async.commit_group;\n" ::);  // (possibly empty) group of step kt + 1
    asm volatile("cp.async.wait_group 1;\n" ::);  // step kt's tiles have landed
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      unsigned af[4][4], bfr[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) frag_a<kAk>(af[mi], As[cur], wm * 64 + mi * 16, kk, lane);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) frag_b<kBk>(bfr[nj], Bs[cur], wn * 32 + nj * 16, kk, lane);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[mi][ni], af[mi], bfr[ni >> 1][(ni & 1) * 2], bfr[ni >> 1][(ni & 1) * 2 + 1]);
    }
    __syncthreads();  // every warp is done with `cur` before step kt + 2 refills it
  }

  float csum[4][2];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) csum[ni][0] = csum[ni][1] = 0.f;
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
          if (col < N) {
            const size_t o = static_cast<size_t>(row) * N + col;
            const float v = epi_value<__nv_bfloat16, EPI>(epi, acc[mi][ni][2 * h + e], o, col);
            out[o] = from_f<OutT>(v);
            if (EPI == kEpiGeluBwd) csum[ni][e] += v;
          }
        }
      }
    }
  }
  if (EPI == kEpiGeluBwd) {
    // column sums of this block's 128 rows: over the 8 mma groups of a warp
    // (lane bits 2-4), then over the two warp rows, in a fixed order
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          csum[ni][e] += __shfl_xor_sync(0xffffffffu, csum[ni][e], off);
    float* red = reinterpret_cast<float*>(&As[0][0]);  // [2][128]; the tiles are done
    if (g == 0)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) red[wm * kBN + wn * 32 + ni * 8 + t * 2 + e] = csum[ni][e];
    __syncthreads();
    if (tid < kBN && n0 + tid < N)
      epi.part[static_cast<size_t>(blockIdx.y) * N + n0 + tid] = red[tid] + red[kBN + tid];
  }
}

// (iii) float32 GEMM on the FMA pipes (no TF32): 64 x 64 block tile, 16 deep,
// each thread 4 x 4 outputs at rows ty + 16 i, columns tx + 16 j.
constexpr int kFM = 64, kFN = 64, kFK = 16;

template <int L, int EPI>
__global__ void __launch_bounds__(256) gemm_f32_kernel(
    const float* __restrict__ A, const float* __restrict__ B, float* __restrict__ out, Epi epi,
    int M, int N, int K) {
  __shared__ float As[kFK][kFM + 4];  // [k][m]
  __shared__ float Bs[kFK][kFN + 4];  // [k][n]
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
      const int idx = tid + i * 256;
      if (L == kTN) {  // A stored (K, M)
        const int kk = idx >> 6, mm = idx & 63, gk = k0 + kk, gm = m0 + mm;
        As[kk][mm] = (gm < M && gk < K) ? A[static_cast<size_t>(gk) * M + gm] : 0.f;
      } else {
        const int mm = idx >> 4, kk = idx & 15, gm = m0 + mm, gk = k0 + kk;
        As[kk][mm] = (gm < M && gk < K) ? A[static_cast<size_t>(gm) * K + gk] : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * 256;
      if (L == kNT) {  // B stored (N, K)
        const int nn = idx >> 4, kk = idx & 15, gk = k0 + kk, gn = n0 + nn;
        Bs[kk][nn] = (gk < K && gn < N) ? B[static_cast<size_t>(gn) * K + gk] : 0.f;
      } else {
        const int kk = idx >> 6, nn = idx & 63, gk = k0 + kk, gn = n0 + nn;
        Bs[kk][nn] = (gk < K && gn < N) ? B[static_cast<size_t>(gk) * N + gn] : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float a[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }
  float csum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < N) {
        const size_t o = static_cast<size_t>(row) * N + col;
        const float v = epi_value<float, EPI>(epi, acc[i][j], o, col);
        out[o] = v;
        if (EPI == kEpiGeluBwd) csum[j] += v;
      }
    }
  }
  if (EPI == kEpiGeluBwd) {
    float* red = &As[0][0];  // [16][64]; the tiles are done
#pragma unroll
    for (int j = 0; j < 4; ++j) red[ty * kFN + tx + 16 * j] = csum[j];
    __syncthreads();
    if (tid < kFN && n0 + tid < N) {
      float v = 0.f;
      for (int r = 0; r < 16; ++r) v += red[r * kFN + tid];
      epi.part[static_cast<size_t>(blockIdx.y) * N + n0 + tid] = v;
    }
  }
}

// (iv) LayerNorm backward rows (kernels/linear._ln_bwd_rows): for the rows of x with
// f32 dy = dL/dy, dx = (dy s - mean(dy s) - xhat mean(dy s xhat)) rstd (+ res) in x's
// dtype; xhat and rstd are recomputed from x (row_ln_stats). One warp per row, rows
// strided over a fixed grid; the column sums of dy * xhat, dy (and res) over this
// block's rows go to part[(o, block, D)] for the colsum pass.
constexpr int kLnBwdMaxD = 1024;

template <typename T, int DPL>
__global__ void __launch_bounds__(256) ln_bwd_rows_kernel(
    const T* __restrict__ x, const float* __restrict__ s, const float* __restrict__ dy,
    const T* __restrict__ res, T* __restrict__ dx, float* __restrict__ part, int R, int D) {
  __shared__ float red[8][kLnBwdMaxD];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float as[DPL], ab[DPL], ar[DPL];
#pragma unroll
  for (int e = 0; e < DPL; ++e) as[e] = ab[e] = ar[e] = 0.f;
  for (long row = blockIdx.x * 8L + warp; row < R; row += gridDim.x * 8L) {
    const T* xr = x + row * D;
    const float* gr = dy + row * D;
    float mean, rstd;
    row_ln_stats(xr, D, lane, mean, rstd);
    float a1 = 0.f, a2 = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const int d = lane + 32 * e;
      if (d < D) {
        const float xh = __fmul_rn(to_f(xr[d]) - mean, rstd);
        const float dxh = __fmul_rn(gr[d], s[d]);
        a1 += dxh;
        a2 += __fmul_rn(dxh, xh);
      }
    }
    const float m1 = warp_sum(a1) / D, m2 = warp_sum(a2) / D;
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const int d = lane + 32 * e;
      if (d < D) {
        const float xh = __fmul_rn(to_f(xr[d]) - mean, rstd);
        const float g = gr[d];
        float v = __fmul_rn(__fsub_rn(__fsub_rn(__fmul_rn(g, s[d]), m1), __fmul_rn(xh, m2)), rstd);
        if (res != nullptr) {
          const float r = to_f(res[row * D + d]);
          v = __fadd_rn(v, r);
          ar[e] += r;
        }
        dx[row * D + d] = from_f<T>(v);
        as[e] += __fmul_rn(g, xh);
        ab[e] += g;
      }
    }
  }
  const int nout = res != nullptr ? 3 : 2;
  for (int o = 0; o < nout; ++o) {
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const int d = lane + 32 * e;
      if (d < D) red[warp][d] = o == 0 ? as[e] : (o == 1 ? ab[e] : ar[e]);
    }
    __syncthreads();
    for (int d = tid; d < D; d += 256) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) v += red[w][d];
      part[(static_cast<size_t>(o) * gridDim.x + blockIdx.x) * D + d] = v;
    }
    __syncthreads();
  }
}

// (v) out[o, n] = sum_p part[o, p, n] in p order (the second pass of every column sum).
__global__ void __launch_bounds__(256) colsum_kernel(const float* __restrict__ part, int nout,
                                                     int P, int N, float* __restrict__ out) {
  const long i = blockIdx.x * 256L + threadIdx.x;
  if (i >= static_cast<long>(nout) * N) return;
  const int o = static_cast<int>(i / N), n = static_cast<int>(i % N);
  const float* p = part + static_cast<size_t>(o) * P * N + n;
  float v = 0.f;
  for (int j = 0; j < P; ++j) v += p[static_cast<size_t>(j) * N];
  out[i] = v;
}

// The GELU-backward epilogue exists for the NT layout with an output in the input
// dtype only (ln_ff_residual_bwd's dh1), the stash for NN with an output in the input
// dtype only (ln_ff_residual_h1's fc1); other combinations are refused.
template <int L>
int launch_bf16(const void* a, const void* b, void* out, int out_f32, int mode, const Epi& epi,
                int M, int N, int K, cudaStream_t st) {
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  auto A = static_cast<const __nv_bfloat16*>(a);
  auto B = static_cast<const __nv_bfloat16*>(b);
  auto O = static_cast<__nv_bfloat16*>(out);
  if (mode == kEpiGeluBwd) {
    if (L != kNT || out_f32 || epi.part == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    gemm_bf16_kernel<kNT, __nv_bfloat16, kEpiGeluBwd><<<grid, 256, 0, st>>>(A, B, O, epi, M, N, K);
  } else if (epi.out2 != nullptr) {
    if (L != kNN || out_f32) return static_cast<int>(cudaErrorInvalidValue);
    gemm_bf16_kernel<kNN, __nv_bfloat16, kEpiStash><<<grid, 256, 0, st>>>(A, B, O, epi, M, N, K);
  } else if (out_f32) {
    gemm_bf16_kernel<L, float, kEpiStd><<<grid, 256, 0, st>>>(A, B, static_cast<float*>(out), epi,
                                                              M, N, K);
  } else {
    gemm_bf16_kernel<L, __nv_bfloat16, kEpiStd><<<grid, 256, 0, st>>>(A, B, O, epi, M, N, K);
  }
  return 0;
}

template <int L>
int launch_f32(const float* a, const float* b, float* out, int mode, const Epi& epi, int M, int N,
               int K, cudaStream_t st) {
  dim3 grid((N + kFN - 1) / kFN, (M + kFM - 1) / kFM);
  if (mode == kEpiGeluBwd) {
    if (L != kNT || epi.part == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    gemm_f32_kernel<kNT, kEpiGeluBwd><<<grid, 256, 0, st>>>(a, b, out, epi, M, N, K);
  } else if (epi.out2 != nullptr) {
    if (L != kNN) return static_cast<int>(cudaErrorInvalidValue);
    gemm_f32_kernel<kNN, kEpiStash><<<grid, 256, 0, st>>>(a, b, out, epi, M, N, K);
  } else {
    gemm_f32_kernel<L, kEpiStd><<<grid, 256, 0, st>>>(a, b, out, epi, M, N, K);
  }
  return 0;
}

template <typename T, int DPL>
void launch_ln_bwd(const void* x, const float* s, const float* dy, const void* res, void* dx,
                   float* part, int R, int D, int blocks, cudaStream_t st) {
  ln_bwd_rows_kernel<T, DPL><<<blocks, 256, 0, st>>>(static_cast<const T*>(x), s, dy,
                                                     static_cast<const T*>(res),
                                                     static_cast<T*>(dx), part, R, D);
}

template <typename T>
int launch_ln_bwd_t(const void* x, const float* s, const float* dy, const void* res, void* dx,
                    float* part, int R, int D, int blocks, cudaStream_t st) {
  const int dpl = (D + 31) / 32;
  if (dpl <= 4) launch_ln_bwd<T, 4>(x, s, dy, res, dx, part, R, D, blocks, st);
  else if (dpl <= 8) launch_ln_bwd<T, 8>(x, s, dy, res, dx, part, R, D, blocks, st);
  else if (dpl <= 16) launch_ln_bwd<T, 16>(x, s, dy, res, dx, part, R, D, blocks, st);
  else if (dpl <= 24) launch_ln_bwd<T, 24>(x, s, dy, res, dx, part, R, D, blocks, st);
  else if (dpl <= 32) launch_ln_bwd<T, 32>(x, s, dy, res, dx, part, R, D, blocks, st);
  else return static_cast<int>(cudaErrorInvalidValue);
  return 0;
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

// out (M, N) = epilogue(A @ B), f32 accumulation. a, b in dtype dt (0 f32, 1 bf16),
// row-major, 16-byte aligned, laid out as `layout` says (0 NN: a (M, K), b (K, N);
// 1 NT: a (M, K), b (N, K); 2 TN: a (K, M), b (K, N)); every operand's contiguous
// extent a multiple of 8 (checked by the caller). out in dt, or f32 when out_f32 (bf16
// inputs; f32 inputs always give f32). Epilogue `mode` 0: + bias (f32 (N,), or null),
// pre-activation -> out2 (dt, or null; layout NN, out in dt only), tanh-GELU if gelu,
// + res (dt, or null);
// mode 1 (layout NT, out in dt only): acc * gelu'(aux), gelu(aux) -> out2, with aux,
// out2 (M, N) in dt, and part (f32 (ceil(M / tile), N)) the per-block-row column sums
// of the f32 result (tile 128 rows for bf16, 64 for f32).
int istvt_gemm(const void* a, const void* b, int dt, int layout, void* out, int out_f32,
               const void* bias, const void* res, int gelu, void* out2, const void* aux,
               void* part, int mode, int M, int N, int K, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const Epi epi{static_cast<const float*>(bias), res, out2, aux, static_cast<float*>(part),
                gelu};
  int rc = 0;
  if (dt == kBF16) {
    switch (layout) {
      case kNN: rc = launch_bf16<kNN>(a, b, out, out_f32, mode, epi, M, N, K, st); break;
      case kNT: rc = launch_bf16<kNT>(a, b, out, out_f32, mode, epi, M, N, K, st); break;
      case kTN: rc = launch_bf16<kTN>(a, b, out, out_f32, mode, epi, M, N, K, st); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    auto A = static_cast<const float*>(a);
    auto B = static_cast<const float*>(b);
    auto O = static_cast<float*>(out);
    switch (layout) {
      case kNN: rc = launch_f32<kNN>(A, B, O, mode, epi, M, N, K, st); break;
      case kNT: rc = launch_f32<kNT>(A, B, O, mode, epi, M, N, K, st); break;
      case kTN: rc = launch_f32<kTN>(A, B, O, mode, epi, M, N, K, st); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// LayerNorm backward rows: x (R, D) in dtype dt, s f32 (D,), dy f32 (R, D), res (R, D)
// in dt or null -> dx (R, D) in dt; part f32 (2 or 3, blocks, D) the per-block column
// sums of dy * xhat, dy (and res). D <= 1024.
int istvt_ln_bwd_rows(const void* x, int dt, const void* s, const void* dy, const void* res,
                      void* dx, void* part, int R, int D, int blocks, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (D > kLnBwdMaxD) return static_cast<int>(cudaErrorInvalidValue);
  auto S = static_cast<const float*>(s);
  auto G = static_cast<const float*>(dy);
  auto P = static_cast<float*>(part);
  int rc = dt == kBF16 ? launch_ln_bwd_t<__nv_bfloat16>(x, S, G, res, dx, P, R, D, blocks, st)
                       : launch_ln_bwd_t<float>(x, S, G, res, dx, P, R, D, blocks, st);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// out (nout, N) = sum over p of part (nout, P, N), f32.
int istvt_colsum(const void* part, int nout, int P, int N, void* out, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const long n = static_cast<long>(nout) * N;
  colsum_kernel<<<static_cast<int>((n + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(part), nout, P, N, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
