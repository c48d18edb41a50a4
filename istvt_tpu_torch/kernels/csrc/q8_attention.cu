// The attention cores of both serving paths: (iv) self-subtract temporal
// attention and (v) masked per-frame spatial attention, on packed [q | k | v]
// activations in the activation dtype, written by the W8A8 QKV GEMM
// (q8_rows_gemm.cu, int8 path) or the float GEMM (float_gemm.cu, float path).
//
// Replaces two TPU kernels of the float fused path whole
// (istvt_tpu/kernels/attention.py fused_temporal_attention_packed and
// fused_frame_attention_packed, wrapped in kernels/attention.py), and the
// attention halves of two TPU kernels in istvt_tpu/kernels/quant.py, which
// compute the same math:
//   * _ln_qkv_q8_temporal_kernel (the fori_loop over query frames): softmax
//     over the T+1 = 7 frames for every (clip, location, head), after the
//     self-subtract cat(x[:2], x[2:] - x[1:-1]) on q and k, taken in the
//     activation dtype; weights normalised by one division at the end;
//   * _mm_q8_ln_qkv_q8_spatial_kernel (_mh_attention_vmem): softmax over the
//     S = 368 tokens of each frame per head, pad keys >= n_valid masked with
//     an additive -1e30, probabilities cast to the activation dtype before
//     the PV product.
//
// What bounds them on the H100: the temporal core is tiny (7x7 scores per
// location and head) and bound by reading qkv once; the spatial core is
// about 0.37 TFLOP per B=16 forward of f32 FMA work. The TPU kernel held the
// whole S x S f32 score tile of a frame in VMEM (368^2 x 4 B = 542 KB), which
// does not fit in the 227 KB of shared memory a block can use. What the
// design does about it: queries are tiled 32 to a block (4 per warp) and each
// lane keeps the full score row of its key slots in registers (12 chunks of
// 32 keys, S <= 384), so the exact softmax of the reference (normalise, then
// cast, then PV) is kept without an online rescale; keys and values stream
// through a 32-key shared-memory chunk, Q sits transposed in shared memory
// so a warp's 4 queries load as one broadcast float4. This first version
// stays on the FMA pipes in f32; moving QK^T and PV to the bf16 tensor cores
// is later work.
#include "common.cuh"

namespace istvt {

constexpr int kTMax = 8;  // T + 1 <= 8

// (iv) One warp per (clip, location, head); lane holds dims lane + 32 e.
template <typename T, int DPL>
__global__ void __launch_bounds__(256) temporal_attn_kernel(
    const T* __restrict__ qkv, T* __restrict__ out, int B, int T1, int S, int H, int inner,
    int dh, float scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long item = static_cast<long>(blockIdx.x) * 8 + warp;
  if (item >= static_cast<long>(B) * S * H) return;
  const int h = item % H;
  const int s = (item / H) % S;
  const int b = item / (static_cast<long>(H) * S);
  const int i3 = 3 * inner;

  float q[kTMax][DPL], k[kTMax][DPL], v[kTMax][DPL];
#pragma unroll
  for (int t = 0; t < kTMax; ++t) {
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const int d = lane + 32 * e;
      q[t][e] = k[t][e] = v[t][e] = 0.f;
      if (t < T1 && d < dh) {
        const T* base = qkv + (static_cast<size_t>(b * T1 + t) * S + s) * i3 + h * dh + d;
        q[t][e] = to_f(base[0]);
        k[t][e] = to_f(base[inner]);
        v[t][e] = to_f(base[2 * inner]);
      }
    }
  }
  // self-subtract in the activation dtype, rows 0 and 1 unchanged; descending
  // t so that q[t - 1] still holds the projected (unsubtracted) value
#pragma unroll
  for (int t = kTMax - 1; t >= 2; --t) {
    if (t < T1) {
#pragma unroll
      for (int e = 0; e < DPL; ++e) {
        q[t][e] = round_to<T>(q[t][e] - q[t - 1][e]);
        k[t][e] = round_to<T>(k[t][e] - k[t - 1][e]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kTMax; ++i) {
    if (i >= T1) break;
    float l[kTMax];
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < kTMax; ++j) {
      l[j] = -INFINITY;
      if (j < T1) {
        float p = 0.f;
#pragma unroll
        for (int e = 0; e < DPL; ++e) p = __fadd_rn(p, __fmul_rn(q[i][e], k[j][e]));
        l[j] = __fmul_rn(warp_sum(p), scale);
        m = fmaxf(m, l[j]);
      }
    }
    float den = 0.f;
    float acc[DPL];
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[e] = 0.f;
#pragma unroll
    for (int j = 0; j < kTMax; ++j) {
      if (j < T1) {
        const float w = expf(l[j] - m);
        den = __fadd_rn(den, w);
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[e] = __fadd_rn(acc[e], __fmul_rn(w, v[j][e]));
      }
    }
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const int d = lane + 32 * e;
      if (d < dh)
        out[(static_cast<size_t>(b * T1 + i) * S + s) * inner + h * dh + d] =
            from_f<T>(__fdiv_rn(acc[e], den));
    }
  }
}

// (v) Block = (query tile of 32, head, frame); warp w owns queries 4w..4w+3.
constexpr int kQT = 32, kQW = 4, kMaxCh = 12;  // S <= 12 * 32 = 384

template <typename T, int DH>
__global__ void __launch_bounds__(256) spatial_attn_kernel(
    const T* __restrict__ qkv, T* __restrict__ out, int S, int inner, int n_valid,
    float scale) {
  constexpr int DPL = DH >= 32 ? DH / 32 : 1;
  __shared__ __align__(16) float Qs[DH][kQT + 4];
  __shared__ float KV[32][DH + 1];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * kQT, h = blockIdx.y, f = blockIdx.z;
  const int i3 = 3 * inner;
  const T* base = qkv + static_cast<size_t>(f) * S * i3 + h * DH;
  const int nch = (S + 31) / 32;

  for (int idx = tid; idx < kQT * DH; idx += 256) {
    const int qq = idx / DH, d = idx % DH, row = q0 + qq;
    Qs[d][qq] = row < S ? to_f(base[static_cast<size_t>(row) * i3 + d]) : 0.f;
  }

  float sc[kQW][kMaxCh];
#pragma unroll
  for (int m = 0; m < kMaxCh; ++m) {
    if (m < nch) {
      __syncthreads();
      for (int idx = tid; idx < 32 * DH; idx += 256) {
        const int kk = idx / DH, d = idx % DH, key = m * 32 + kk;
        KV[kk][d] = key < S ? to_f(base[static_cast<size_t>(key) * i3 + inner + d]) : 0.f;
      }
      __syncthreads();
      float a[kQW] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
      for (int d = 0; d < DH; ++d) {
        const float kv = KV[lane][d];
        const float4 qv = *reinterpret_cast<const float4*>(&Qs[d][warp * kQW]);
        a[0] = fmaf(qv.x, kv, a[0]);
        a[1] = fmaf(qv.y, kv, a[1]);
        a[2] = fmaf(qv.z, kv, a[2]);
        a[3] = fmaf(qv.w, kv, a[3]);
      }
      const int key = m * 32 + lane;
#pragma unroll
      for (int qq = 0; qq < kQW; ++qq) {
        float v = __fmul_rn(a[qq], scale);
        if (key >= n_valid) v = __fadd_rn(v, -1e30f);
        sc[qq][m] = key < S ? v : -INFINITY;
      }
    } else {
#pragma unroll
      for (int qq = 0; qq < kQW; ++qq) sc[qq][m] = -INFINITY;
    }
  }
  // exact softmax per query row: max, exp, sum, normalise, round to T
#pragma unroll
  for (int qq = 0; qq < kQW; ++qq) {
    float mx = -INFINITY;
#pragma unroll
    for (int m = 0; m < kMaxCh; ++m) mx = fmaxf(mx, sc[qq][m]);
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int m = 0; m < kMaxCh; ++m) {
      sc[qq][m] = expf(sc[qq][m] - mx);
      sum += sc[qq][m];
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int m = 0; m < kMaxCh; ++m) sc[qq][m] = round_to<T>(__fdiv_rn(sc[qq][m], sum));
  }

  float o[kQW][DPL];
#pragma unroll
  for (int qq = 0; qq < kQW; ++qq)
#pragma unroll
    for (int e = 0; e < DPL; ++e) o[qq][e] = 0.f;
#pragma unroll
  for (int m = 0; m < kMaxCh; ++m) {
    if (m < nch) {
      __syncthreads();
      for (int idx = tid; idx < 32 * DH; idx += 256) {
        const int kk = idx / DH, d = idx % DH, key = m * 32 + kk;
        KV[kk][d] = key < S ? to_f(base[static_cast<size_t>(key) * i3 + 2 * inner + d]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int jj = 0; jj < 32; ++jj) {
        float p[kQW];
#pragma unroll
        for (int qq = 0; qq < kQW; ++qq) p[qq] = __shfl_sync(0xffffffffu, sc[qq][m], jj);
#pragma unroll
        for (int e = 0; e < DPL; ++e) {
          const int d = lane + 32 * e;
          const float vv = d < DH ? KV[jj][d] : 0.f;
#pragma unroll
          for (int qq = 0; qq < kQW; ++qq) o[qq][e] = fmaf(p[qq], vv, o[qq][e]);
        }
      }
    }
  }
#pragma unroll
  for (int qq = 0; qq < kQW; ++qq) {
    const int row = q0 + warp * kQW + qq;
    if (row >= S) continue;
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const int d = lane + 32 * e;
      if (d < DH) out[(static_cast<size_t>(f) * S + row) * inner + h * DH + d] = from_f<T>(o[qq][e]);
    }
  }
}

template <typename T>
int launch_temporal(const void* qkv, void* out, int B, int T1, int S, int H, int inner,
                    float scale, cudaStream_t st) {
  const int dh = inner / H;
  const long items = static_cast<long>(B) * S * H;
  const int blocks = static_cast<int>((items + 7) / 8);
  auto in = static_cast<const T*>(qkv);
  auto o = static_cast<T*>(out);
  if (dh <= 32)
    temporal_attn_kernel<T, 1><<<blocks, 256, 0, st>>>(in, o, B, T1, S, H, inner, dh, scale);
  else if (dh <= 64)
    temporal_attn_kernel<T, 2><<<blocks, 256, 0, st>>>(in, o, B, T1, S, H, inner, dh, scale);
  else
    temporal_attn_kernel<T, 4><<<blocks, 256, 0, st>>>(in, o, B, T1, S, H, inner, dh, scale);
  return 0;
}

template <typename T>
int launch_spatial(const void* qkv, void* out, int G, int S, int H, int inner, int n_valid,
                   float scale, cudaStream_t st) {
  const int dh = inner / H;
  dim3 grid((S + kQT - 1) / kQT, H, G);
  auto in = static_cast<const T*>(qkv);
  auto o = static_cast<T*>(out);
  switch (dh) {
    case 16: spatial_attn_kernel<T, 16><<<grid, 256, 0, st>>>(in, o, S, inner, n_valid, scale); break;
    case 32: spatial_attn_kernel<T, 32><<<grid, 256, 0, st>>>(in, o, S, inner, n_valid, scale); break;
    case 64: spatial_attn_kernel<T, 64><<<grid, 256, 0, st>>>(in, o, S, inner, n_valid, scale); break;
    case 128: spatial_attn_kernel<T, 128><<<grid, 256, 0, st>>>(in, o, S, inner, n_valid, scale); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace istvt

using namespace istvt;

extern "C" {

// qkv (B, T1, S, 3 inner) -> out (B, T1, S, inner); dt 0 f32, 1 bf16; T1 <= 8, inner / H <= 128.
int istvt_temporal_attn(const void* qkv, void* out, int dt, int B, int T1, int S, int H,
                        int inner, float scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  int rc = dt == kBF16 ? launch_temporal<__nv_bfloat16>(qkv, out, B, T1, S, H, inner, scale, st)
                       : launch_temporal<float>(qkv, out, B, T1, S, H, inner, scale, st);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// qkv (G, S, 3 inner) -> out (G, S, inner); keys >= n_valid masked; S <= 384,
// inner / H in {16, 32, 64, 128}.
int istvt_spatial_attn(const void* qkv, void* out, int dt, int G, int S, int H, int inner,
                       int n_valid, float scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  int rc = dt == kBF16
               ? launch_spatial<__nv_bfloat16>(qkv, out, G, S, H, inner, n_valid, scale, st)
               : launch_spatial<float>(qkv, out, G, S, H, inner, n_valid, scale, st);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
