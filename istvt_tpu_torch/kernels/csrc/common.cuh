// Shared helpers for the serving kernels (q8_rows_gemm.cu, q8_attention.cu,
// float_gemm.cu).
//
// Activations are float32 or bfloat16 (dtype code 0 / 1, see kernels/_lib.py);
// every kernel computes in float32 and rounds to the activation dtype exactly
// where the JAX reference (istvt_tpu/kernels/) casts.
//
// Build without --use_fast_math: the row quantization divides (y / rs) and
// rounds half to even (rintf), as jnp.round does, and expf/tanhf stay the
// accurate versions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace istvt {

constexpr int kF32 = 0;
constexpr int kBF16 = 1;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The value a tensor of dtype T holds after storing v (round to nearest even).
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// Stores the pair (a, b) at p, p + 1 in T: as one 8- / 4-byte store if vec (p then
// has that alignment), else element by element.
template <typename T>
__device__ __forceinline__ void store_pair(T* p, float a, float b, bool vec);
template <>
__device__ __forceinline__ void store_pair<float>(float* p, float a, float b, bool vec) {
  if (vec) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    p[0] = a;
    p[1] = b;
  }
}
template <>
__device__ __forceinline__ void store_pair<__nv_bfloat16>(__nv_bfloat16* p, float a, float b,
                                                          bool vec) {
  if (vec) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    p[0] = from_f<__nv_bfloat16>(a);
    p[1] = from_f<__nv_bfloat16>(b);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// LayerNorm statistics of one row, one warp per row (kernels/linear._ln: two-pass
// variance, eps 1e-5): mean and 1 / sqrt(var + eps). Both sums run in double and
// round once to f32, so the f32 results do not depend on the summation order and
// the plain version (which does the same) gets the same values; 1 / sqrt with
// IEEE operations, not rsqrtf. xr is not __restrict__: the persistent layer kernel
// (q8_layer.cu) reads rows here that it wrote earlier in the same launch.
template <typename T>
__device__ __forceinline__ void row_ln_stats(const T* xr, int D, int lane,
                                             float& mean, float& rstd) {
  double sum = 0.0;
  for (int d = lane; d < D; d += 32) sum += static_cast<double>(to_f(xr[d]));
  mean = static_cast<float>(warp_sum(sum) / D);
  double ss = 0.0;
  for (int d = lane; d < D; d += 32) {
    float c = to_f(xr[d]) - mean;
    ss += static_cast<double>(__fmul_rn(c, c));
  }
  const float var = static_cast<float>(warp_sum(ss) / D);
  rstd = __fdiv_rn(1.0f, __fsqrt_rn(var + 1e-5f));
}

// (x - mean) * rstd * s + b, in that order, without FMA contraction.
__device__ __forceinline__ float ln_affine(float x, float mean, float rstd, float s, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(x - mean, rstd), s), b);
}

// jnp.clip(jnp.round(y / rs), -127, 127).astype(int8): true division, half to even.
__device__ __forceinline__ int8_t quant_code(float y, float rs) {
  float v = rintf(__fdiv_rn(y, rs));
  v = fminf(fmaxf(v, -127.0f), 127.0f);
  return static_cast<int8_t>(static_cast<int>(v));
}

// Row scale of _quant_rows: max(amax, 1e-6) / 127.
__device__ __forceinline__ float row_scale(float amax) {
  return __fdiv_rn(fmaxf(amax, 1e-6f), 127.0f);
}

// jax.nn.gelu(x, approximate=True): x * 0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 x^3))).
__device__ __forceinline__ float gelu_tanh(float x) {
  const float k = 0.7978845608028654f;
  float x3 = __fmul_rn(__fmul_rn(x, x), x);
  float inner = __fmul_rn(k, __fadd_rn(x, __fmul_rn(0.044715f, x3)));
  float cdf = __fmul_rn(0.5f, __fadd_rn(1.0f, tanhf(inner)));
  return __fmul_rn(x, cdf);
}

// Where the attention cores find row r of q, k and v (or of dq, dk and dv; P is a const
// or a mutable element pointer). `at(row0, col)` moves all three to row row0 and
// column col, e.g. to the first token of frame f and the first column of head h.
//   PackedRows: one [q | k | v] tensor of 3 inner columns (the serving and training
//     paths). Its addresses are those the cores computed before the kernel API's
//     entries came, so the generated code of #1, #2, #9 and #10 stays as it was.
//   SplitRows: three tensors with rows of rs elements (the kernel API's unpacked
//     entries #13, #14, #15: rs = H dh).
// rows<kPacked>(q, k, v, inner) makes the one or the other; a packed caller passes its
// qkv as q (k and v are not read).
template <typename P>
struct PackedRows {
  P base;
  int inner;
  __device__ __forceinline__ PackedRows at(size_t row0, int col) const {
    return {base + row0 * (3 * inner) + col, inner};
  }
  __device__ __forceinline__ P q(int r) const { return base + static_cast<size_t>(r) * (3 * inner); }
  __device__ __forceinline__ P k(int r) const { return q(r) + inner; }
  __device__ __forceinline__ P v(int r) const { return q(r) + 2 * inner; }
};

template <typename P>
struct SplitRows {
  P qb, kb, vb;
  int rs;
  __device__ __forceinline__ SplitRows at(size_t row0, int col) const {
    const size_t o = row0 * rs + col;
    return {qb + o, kb + o, vb + o, rs};
  }
  __device__ __forceinline__ P q(int r) const { return qb + static_cast<size_t>(r) * rs; }
  __device__ __forceinline__ P k(int r) const { return kb + static_cast<size_t>(r) * rs; }
  __device__ __forceinline__ P v(int r) const { return vb + static_cast<size_t>(r) * rs; }
};

template <bool kPacked, typename P>
__device__ __forceinline__ auto rows(P q, P k, P v, int inner) {
  if constexpr (kPacked) {
    return PackedRows<P>{q, inner};
  } else {
    return SplitRows<P>{q, k, v, inner};
  }
}

}  // namespace istvt
