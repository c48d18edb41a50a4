// The int8 row passes and the mma.sync W8A8 GEMM tile as device functions:
// q8_rows_gemm.cu launches the row passes as kernels of their own (one row per warp;
// its standalone GEMM is the wgmma one there), q8_layer.cu walks them all inside one
// persistent kernel per ST layer.
//
// No pointer parameter here is __restrict__. In the persistent kernel the buffers
// these functions read were written earlier in the same launch by other blocks, and
// a load the compiler may route through the non-coherent read-only path (ld.global.nc,
// which restrict + const allows) could return a line cached before that write. The
// kernels of q8_rows_gemm.cu keep __restrict__ on their own parameters.
#pragma once

#include "common.cuh"

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

__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4], const int (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// (iii) One 128 x 128 tile (tile_n, tile_m) of out[M, N] = epilogue(A[M, K] (int8) @
// W[K, N] (int8)), int32 accumulate, by 256 threads. epilogue: f32 acc * rs[m] * ws[n]
// (+ bias[n]) (+ res[m, n]) (-> tanh-GELU), rounded once to TO. The order of the f32
// operations is the JAX kernels' (acc * rs * ws + b + r). K % 4 == 0 and N % 4 == 0
// (checked by the caller). smem: kGemmSmemInts ints; the tile ends on a
// __syncthreads, so a block may start its next tile on the same memory.
constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kLDS = kBK / 4 + 4;  // ints per shared row: 8 data + 4 pad
constexpr int kGemmSmemInts = (kBM + kBN) * kLDS;

template <typename TO, typename TR, bool GELU>
__device__ __forceinline__ void gemm_q8_tile(const int8_t* A, const int8_t* W, const float* rs,
                                             const float* ws, const float* bias, const TR* res,
                                             TO* out, int M, int N, int K, int tile_n,
                                             int tile_m, int* smem) {
  int* As = smem;
  int* Bs = smem + kBM * kLDS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;   // 2 x 4 warps, 64 x 32 each
  const int g = lane >> 2, t = lane & 3;     // mma group / thread-in-group
  const int m0 = tile_m * kBM, n0 = tile_n * kBN;

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

}  // namespace istvt
