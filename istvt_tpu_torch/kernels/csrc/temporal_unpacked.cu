// Self-subtract temporal attention on separate (unpacked) q, k, v, forward and
// backward: the kernel API's entries kernels/attention.fused_temporal_attention and
// fused_temporal_attention_bwd.
//
// Replaces two TPU kernels of istvt_tpu/kernels/attention.py:
//   * fused_temporal_attention (_temporal_kernel): per (clip, location, head), softmax
//     over the T + 1 frames of the self-subtracted q, k (cat(x[:2], x[2:] - x[1:-1]),
//     in the input dtype). Its roundings differ from the packed kernel's (#11,
//     q8_attention.cu), so it has a device function of its own. In the input dtype
//     T: each product q_i * k_j is rounded to T before the f32 lane sum; the
//     probabilities are normalised in f32, then rounded to T; out = sum_j p_j v_j runs
//     in T, each product and each partial sum rounded.
//   * fused_temporal_attention_bwd (_temporal_bwd_kernel): P recomputed per query row
//     from the subtracted streams; dp_j = sum of T-rounded do_i * v_j products in f32;
//     ds = (p (dp - sum p dp)) scale, rounded to T; dqs, dks and dv accumulate in T
//     (JAX's scratch refs are q.dtype), each product rounded first; then the
//     transposed self-subtract dx[0] = d[0], dx[t] = d[t] - d[t + 1] (1 <= t <= T1 - 2),
//     dx[T1 - 1] = d[T1 - 1].
// In f32 every rounding to T is exact, and both agree with the packed kernels' math
// up to summation order.
//
// What bounds them on the H100: 7 x 7 scores per (location, head) is tiny arithmetic
// (4 T1^2 dh products per item forward, 10 backward); both are bound by reading their
// inputs once and writing their outputs once (4 and 7 tensors of (B, T1, S, H dh)).
// What the design does about it: one warp per (clip, location, head), lane = feature
// dim (dh / 32 values a lane, dh <= 128), the item's T1 <= 8 rows of each stream in
// registers, so every input is read once and every output written once, with no
// shared memory. A warp reads dh contiguous elements a row, and the 8 warps of a
// block take neighbouring heads of one token, so a block reads whole token rows.
// Past T1 = 8 (JAX takes a whole clip of any T1) the general kernels below hold no row
// of every frame: they read the key frames' rows again from device memory (L1 / L2) in
// each sweep, recompute the logits (the same bits) in place of storing them, and sum
// dk and dv in the outputs themselves, which are in T as JAX's scratch refs are; the
// same operations in the same order.
#include "common.cuh"

namespace istvt {

constexpr int kUTMax = 8;  // the register kernels' T1; past it the general kernels

// Where warp item `item` = (clip b, location s, head h) finds frame t of a
// (B, T1, S, H dh) tensor: at(t) + d.
struct TemporalItem {
  size_t base;   // (b, 0, s, h dh)
  size_t frame;  // S H dh
  __device__ __forceinline__ TemporalItem(long item, int T1, int S, int H, int dh) {
    const int h = item % H;
    const int s = (item / H) % S;
    const long b = item / (static_cast<long>(H) * S);
    frame = static_cast<size_t>(S) * H * dh;
    base = static_cast<size_t>(b) * T1 * frame + (static_cast<size_t>(s) * H + h) * dh;
  }
  __device__ __forceinline__ size_t at(int t) const { return base + t * frame; }
};

// Load rows t < T1 of one stream (lane holds dims lane + 32 e < dh; the rest are 0).
template <typename T, int DPL>
__device__ __forceinline__ void load_rows(const T* x, const TemporalItem& it, int T1, int dh,
                                          int lane, float (&r)[kUTMax][DPL]) {
#pragma unroll
  for (int t = 0; t < kUTMax; ++t) {
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const int d = lane + 32 * e;
      r[t][e] = (t < T1 && d < dh) ? to_f(x[it.at(t) + d]) : 0.f;
    }
  }
}

// The self-subtract in T, rows 0 and 1 unchanged; descending t so that r[t - 1] still
// holds the unsubtracted row.
template <typename T, int DPL>
__device__ __forceinline__ void self_subtract(float (&r)[kUTMax][DPL], int T1) {
#pragma unroll
  for (int t = kUTMax - 1; t >= 2; --t) {
    if (t < T1) {
#pragma unroll
      for (int e = 0; e < DPL; ++e) r[t][e] = round_to<T>(__fsub_rn(r[t][e], r[t - 1][e]));
    }
  }
}

// sum_d f32(round_T(a_d * b_d)) over the warp.
template <typename T, int DPL>
__device__ __forceinline__ float rounded_dot(const float (&a)[DPL], const float (&b)[DPL]) {
  float p = 0.f;
#pragma unroll
  for (int e = 0; e < DPL; ++e) p = __fadd_rn(p, round_to<T>(__fmul_rn(a[e], b[e])));
  return warp_sum(p);
}

// p_j = softmax_j(l_j) in f32 (exp(l - max) / sum), for j < T1.
__device__ __forceinline__ void softmax_row(float (&l)[kUTMax], int T1) {
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < kUTMax; ++j)
    if (j < T1) m = fmaxf(m, l[j]);
  float den = 0.f;
#pragma unroll
  for (int j = 0; j < kUTMax; ++j) {
    if (j < T1) {
      l[j] = expf(l[j] - m);
      den = __fadd_rn(den, l[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kUTMax; ++j)
    if (j < T1) l[j] = __fdiv_rn(l[j], den);
}

// Forward: one warp per (clip, location, head).
template <typename T, int DPL>
__global__ void __launch_bounds__(256) temporal_unpacked_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int B, int T1, int S, int H, int dh, float scale) {
  const int lane = threadIdx.x & 31;
  const long item = static_cast<long>(blockIdx.x) * 8 + (threadIdx.x >> 5);
  if (item >= static_cast<long>(B) * S * H) return;
  const TemporalItem it(item, T1, S, H, dh);
  float qs[kUTMax][DPL], ks[kUTMax][DPL], vv[kUTMax][DPL];
  load_rows<T, DPL>(q, it, T1, dh, lane, qs);
  load_rows<T, DPL>(k, it, T1, dh, lane, ks);
  load_rows<T, DPL>(v, it, T1, dh, lane, vv);
  self_subtract<T, DPL>(qs, T1);
  self_subtract<T, DPL>(ks, T1);
#pragma unroll
  for (int i = 0; i < kUTMax; ++i) {
    if (i >= T1) break;
    float p[kUTMax];
#pragma unroll
    for (int j = 0; j < kUTMax; ++j)
      p[j] = j < T1 ? __fmul_rn(rounded_dot<T, DPL>(qs[i], ks[j]), scale) : 0.f;
    softmax_row(p, T1);
    float o[DPL];
#pragma unroll
    for (int e = 0; e < DPL; ++e) o[e] = 0.f;
#pragma unroll
    for (int j = 0; j < kUTMax; ++j) {
      if (j < T1) {
        const float pj = round_to<T>(p[j]);
#pragma unroll
        for (int e = 0; e < DPL; ++e) {
          const float term = round_to<T>(__fmul_rn(pj, vv[j][e]));
          o[e] = j == 0 ? term : round_to<T>(__fadd_rn(o[e], term));
        }
      }
    }
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const int d = lane + 32 * e;
      if (d < dh) out[it.at(i) + d] = from_f<T>(o[e]);
    }
  }
}

// Backward: one warp per (clip, location, head); dq, dk and dv written once each.
template <typename T, int DPL>
__global__ void __launch_bounds__(256) temporal_unpacked_bwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
    int B, int T1, int S, int H, int dh, float scale) {
  const int lane = threadIdx.x & 31;
  const long item = static_cast<long>(blockIdx.x) * 8 + (threadIdx.x >> 5);
  if (item >= static_cast<long>(B) * S * H) return;
  const TemporalItem it(item, T1, S, H, dh);
  float qs[kUTMax][DPL], ks[kUTMax][DPL], vv[kUTMax][DPL];
  load_rows<T, DPL>(q, it, T1, dh, lane, qs);
  load_rows<T, DPL>(k, it, T1, dh, lane, ks);
  load_rows<T, DPL>(v, it, T1, dh, lane, vv);
  self_subtract<T, DPL>(qs, T1);
  self_subtract<T, DPL>(ks, T1);
  float dks[kUTMax][DPL], dva[kUTMax][DPL];
#pragma unroll
  for (int t = 0; t < kUTMax; ++t)
#pragma unroll
    for (int e = 0; e < DPL; ++e) dks[t][e] = dva[t][e] = 0.f;
  float prev[DPL];  // dqs of the previous query row (the transposed subtract needs it)
#pragma unroll
  for (int e = 0; e < DPL; ++e) prev[e] = 0.f;

#pragma unroll
  for (int i = 0; i < kUTMax; ++i) {
    if (i >= T1) break;
    float go[DPL];
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const int d = lane + 32 * e;
      go[e] = d < dh ? to_f(dout[it.at(i) + d]) : 0.f;
    }
    float p[kUTMax], dp[kUTMax];
#pragma unroll
    for (int j = 0; j < kUTMax; ++j) {
      p[j] = j < T1 ? __fmul_rn(rounded_dot<T, DPL>(qs[i], ks[j]), scale) : 0.f;
      dp[j] = j < T1 ? rounded_dot<T, DPL>(go, vv[j]) : 0.f;
    }
    softmax_row(p, T1);
    float pdp = 0.f;
#pragma unroll
    for (int j = 0; j < kUTMax; ++j)
      if (j < T1) pdp = __fadd_rn(pdp, __fmul_rn(p[j], dp[j]));
    float dqs[DPL];
#pragma unroll
    for (int e = 0; e < DPL; ++e) dqs[e] = 0.f;
#pragma unroll
    for (int j = 0; j < kUTMax; ++j) {
      if (j < T1) {
        const float ds = round_to<T>(__fmul_rn(__fmul_rn(p[j], __fsub_rn(dp[j], pdp)), scale));
        const float pb = round_to<T>(p[j]);
#pragma unroll
        for (int e = 0; e < DPL; ++e) {
          const float tq = round_to<T>(__fmul_rn(ds, ks[j][e]));
          dqs[e] = j == 0 ? tq : round_to<T>(__fadd_rn(dqs[e], tq));
          dks[j][e] = round_to<T>(__fadd_rn(dks[j][e], round_to<T>(__fmul_rn(ds, qs[i][e]))));
          dva[j][e] = round_to<T>(__fadd_rn(dva[j][e], round_to<T>(__fmul_rn(pb, go[e]))));
        }
      }
    }
    // dq of row i - 1 now that dqs[i] is known: row 0 and row T1 - 1 pass through
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const int d = lane + 32 * e;
      if (d >= dh) continue;
      if (i >= 1) {
        const float g = i - 1 >= 1 ? __fsub_rn(prev[e], dqs[e]) : prev[e];
        dq[it.at(i - 1) + d] = from_f<T>(g);
      }
      if (i == T1 - 1) dq[it.at(i) + d] = from_f<T>(dqs[e]);
      prev[e] = dqs[e];
    }
  }
#pragma unroll
  for (int t = 0; t < kUTMax; ++t) {
    if (t >= T1) break;
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const int d = lane + 32 * e;
      if (d >= dh) continue;
      const float g = (t >= 1 && t + 1 < T1) ? __fsub_rn(dks[t][e], dks[t + 1][e]) : dks[t][e];
      dk[it.at(t) + d] = from_f<T>(g);
      dv[it.at(t) + d] = from_f<T>(dva[t][e]);
    }
  }
}

// --- any T1: one warp per (clip, location, head), as above

// Row t of a stream, this lane's dims (lane + 32 e < dh; else 0).
template <typename T, int DPL>
__device__ __forceinline__ void load_row(const T* x, size_t at, int dh, int lane,
                                         float (&r)[DPL]) {
#pragma unroll
  for (int e = 0; e < DPL; ++e) {
    const int d = lane + 32 * e;
    r[e] = d < dh ? to_f(x[at + d]) : 0.f;
  }
}

// Row t of a stream after the self-subtract in T (t >= 2: row t - row t - 1).
template <typename T, int DPL>
__device__ __forceinline__ void subtracted_row(const T* x, const TemporalItem& it, int t, int dh,
                                               int lane, float (&r)[DPL]) {
  load_row<T, DPL>(x, it.at(t), dh, lane, r);
  if (t >= 2) {
    float p[DPL];
    load_row<T, DPL>(x, it.at(t - 1), dh, lane, p);
#pragma unroll
    for (int e = 0; e < DPL; ++e) r[e] = round_to<T>(__fsub_rn(r[e], p[e]));
  }
}

// The scaled logit of query row qs against key frame j, as the register kernels'.
template <typename T, int DPL>
__device__ __forceinline__ float logit_any(const T* k, const TemporalItem& it, int j, int dh,
                                           int lane, const float (&qs)[DPL], float scale) {
  float ks[DPL];
  subtracted_row<T, DPL>(k, it, j, dh, lane, ks);
  return __fmul_rn(rounded_dot<T, DPL>(qs, ks), scale);
}

// softmax_row's max and sum of exp, over T1 logits recomputed each sweep.
template <typename T, int DPL>
__device__ __forceinline__ void softmax_stats_any(const T* k, const TemporalItem& it, int T1,
                                                  int dh, int lane, const float (&qs)[DPL],
                                                  float scale, float& m, float& den) {
  m = -INFINITY;
  for (int j = 0; j < T1; ++j) m = fmaxf(m, logit_any<T, DPL>(k, it, j, dh, lane, qs, scale));
  den = 0.f;
  for (int j = 0; j < T1; ++j)
    den = __fadd_rn(den, expf(logit_any<T, DPL>(k, it, j, dh, lane, qs, scale) - m));
}

// No __launch_bounds__: with one, ptxas held the f32 DPL = 1 instantiation to 32
// registers and spilled 12 bytes.
template <typename T, int DPL>
__global__ void temporal_unpacked_any_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int B, int T1, int S, int H, int dh, float scale) {
  const int lane = threadIdx.x & 31;
  const long item = static_cast<long>(blockIdx.x) * 8 + (threadIdx.x >> 5);
  if (item >= static_cast<long>(B) * S * H) return;
  const TemporalItem it(item, T1, S, H, dh);
  for (int i = 0; i < T1; ++i) {
    float qs[DPL];
    subtracted_row<T, DPL>(q, it, i, dh, lane, qs);
    float m, den;
    softmax_stats_any<T, DPL>(k, it, T1, dh, lane, qs, scale, m, den);
    float o[DPL];
#pragma unroll
    for (int e = 0; e < DPL; ++e) o[e] = 0.f;
    for (int j = 0; j < T1; ++j) {
      const float pj = round_to<T>(
          __fdiv_rn(expf(logit_any<T, DPL>(k, it, j, dh, lane, qs, scale) - m), den));
      float vv[DPL];
      load_row<T, DPL>(v, it.at(j), dh, lane, vv);
#pragma unroll
      for (int e = 0; e < DPL; ++e) {
        const float term = round_to<T>(__fmul_rn(pj, vv[e]));
        o[e] = j == 0 ? term : round_to<T>(__fadd_rn(o[e], term));
      }
    }
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const int d = lane + 32 * e;
      if (d < dh) out[it.at(i) + d] = from_f<T>(o[e]);
    }
  }
}

// Backward at any T1: dks and dv summed in dk and dv (in T) over the query frames, then
// dk's transposed self-subtract in place (ascending t: row t + 1 is read before it is
// rewritten).
template <typename T, int DPL>
__global__ void __launch_bounds__(256) temporal_unpacked_bwd_any_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
    int B, int T1, int S, int H, int dh, float scale) {
  const int lane = threadIdx.x & 31;
  const long item = static_cast<long>(blockIdx.x) * 8 + (threadIdx.x >> 5);
  if (item >= static_cast<long>(B) * S * H) return;
  const TemporalItem it(item, T1, S, H, dh);
  float prev[DPL];  // dqs of the previous query row
#pragma unroll
  for (int e = 0; e < DPL; ++e) prev[e] = 0.f;
  for (int i = 0; i < T1; ++i) {
    float qs[DPL], go[DPL];
    subtracted_row<T, DPL>(q, it, i, dh, lane, qs);
    load_row<T, DPL>(dout, it.at(i), dh, lane, go);
    float m, den;
    softmax_stats_any<T, DPL>(k, it, T1, dh, lane, qs, scale, m, den);
    auto p_at = [&](int j) {
      return __fdiv_rn(expf(logit_any<T, DPL>(k, it, j, dh, lane, qs, scale) - m), den);
    };
    auto dp_at = [&](int j) {
      float vv[DPL];
      load_row<T, DPL>(v, it.at(j), dh, lane, vv);
      return rounded_dot<T, DPL>(go, vv);
    };
    float pdp = 0.f;
    for (int j = 0; j < T1; ++j) pdp = __fadd_rn(pdp, __fmul_rn(p_at(j), dp_at(j)));
    float dqs[DPL];
#pragma unroll
    for (int e = 0; e < DPL; ++e) dqs[e] = 0.f;
    for (int j = 0; j < T1; ++j) {
      const float pj = p_at(j);
      const float ds = round_to<T>(__fmul_rn(__fmul_rn(pj, __fsub_rn(dp_at(j), pdp)), scale));
      const float pb = round_to<T>(pj);
      float ks[DPL];
      subtracted_row<T, DPL>(k, it, j, dh, lane, ks);
#pragma unroll
      for (int e = 0; e < DPL; ++e) {
        const int d = lane + 32 * e;
        const float tq = round_to<T>(__fmul_rn(ds, ks[e]));
        dqs[e] = j == 0 ? tq : round_to<T>(__fadd_rn(dqs[e], tq));
        if (d >= dh) continue;
        const size_t at = it.at(j) + d;
        const float sk = i == 0 ? 0.f : to_f(dk[at]), sv = i == 0 ? 0.f : to_f(dv[at]);
        dk[at] = from_f<T>(round_to<T>(__fadd_rn(sk, round_to<T>(__fmul_rn(ds, qs[e])))));
        dv[at] = from_f<T>(round_to<T>(__fadd_rn(sv, round_to<T>(__fmul_rn(pb, go[e])))));
      }
    }
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const int d = lane + 32 * e;
      if (d >= dh) continue;
      if (i >= 1) {
        const float g = i - 1 >= 1 ? __fsub_rn(prev[e], dqs[e]) : prev[e];
        dq[it.at(i - 1) + d] = from_f<T>(g);
      }
      if (i == T1 - 1) dq[it.at(i) + d] = from_f<T>(dqs[e]);
      prev[e] = dqs[e];
    }
  }
  for (int t = 1; t + 1 < T1; ++t) {
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const int d = lane + 32 * e;
      if (d >= dh) continue;
      dk[it.at(t) + d] = from_f<T>(__fsub_rn(to_f(dk[it.at(t) + d]), to_f(dk[it.at(t + 1) + d])));
    }
  }
}

template <typename T, int DPL>
void launch_unpacked_dpl(const T* q, const T* k, const T* v, T* o, int blocks, int B, int T1,
                         int S, int H, int dh, float scale, cudaStream_t st) {
  if (T1 <= kUTMax)
    temporal_unpacked_kernel<T, DPL><<<blocks, 256, 0, st>>>(q, k, v, o, B, T1, S, H, dh, scale);
  else
    temporal_unpacked_any_kernel<T, DPL><<<blocks, 256, 0, st>>>(q, k, v, o, B, T1, S, H, dh,
                                                                 scale);
}

template <typename T, int DPL>
void launch_unpacked_bwd_dpl(const T* q, const T* k, const T* v, const T* g, T* a, T* b, T* c,
                             int blocks, int B, int T1, int S, int H, int dh, float scale,
                             cudaStream_t st) {
  if (T1 <= kUTMax)
    temporal_unpacked_bwd_kernel<T, DPL><<<blocks, 256, 0, st>>>(q, k, v, g, a, b, c, B, T1, S, H,
                                                                 dh, scale);
  else
    temporal_unpacked_bwd_any_kernel<T, DPL><<<blocks, 256, 0, st>>>(q, k, v, g, a, b, c, B, T1,
                                                                     S, H, dh, scale);
}

template <typename T>
int launch_temporal_unpacked(const void* q, const void* k, const void* v, void* out, int B, int T1,
                             int S, int H, int dh, float scale, cudaStream_t st) {
  const long items = static_cast<long>(B) * S * H;
  const int blocks = static_cast<int>((items + 7) / 8);
  auto qp = static_cast<const T*>(q);
  auto kp = static_cast<const T*>(k);
  auto vp = static_cast<const T*>(v);
  auto o = static_cast<T*>(out);
  if (dh <= 32)
    launch_unpacked_dpl<T, 1>(qp, kp, vp, o, blocks, B, T1, S, H, dh, scale, st);
  else if (dh <= 64)
    launch_unpacked_dpl<T, 2>(qp, kp, vp, o, blocks, B, T1, S, H, dh, scale, st);
  else
    launch_unpacked_dpl<T, 4>(qp, kp, vp, o, blocks, B, T1, S, H, dh, scale, st);
  return 0;
}

template <typename T>
int launch_temporal_unpacked_bwd(const void* q, const void* k, const void* v, const void* dout,
                                 void* dq, void* dk, void* dv, int B, int T1, int S, int H,
                                 int dh, float scale, cudaStream_t st) {
  const long items = static_cast<long>(B) * S * H;
  const int blocks = static_cast<int>((items + 7) / 8);
  auto qp = static_cast<const T*>(q);
  auto kp = static_cast<const T*>(k);
  auto vp = static_cast<const T*>(v);
  auto g = static_cast<const T*>(dout);
  auto a = static_cast<T*>(dq);
  auto b = static_cast<T*>(dk);
  auto c = static_cast<T*>(dv);
  if (dh <= 32)
    launch_unpacked_bwd_dpl<T, 1>(qp, kp, vp, g, a, b, c, blocks, B, T1, S, H, dh, scale, st);
  else if (dh <= 64)
    launch_unpacked_bwd_dpl<T, 2>(qp, kp, vp, g, a, b, c, blocks, B, T1, S, H, dh, scale, st);
  else
    launch_unpacked_bwd_dpl<T, 4>(qp, kp, vp, g, a, b, c, blocks, B, T1, S, H, dh, scale, st);
  return 0;
}

}  // namespace istvt

using namespace istvt;

extern "C" {

// q, k, v (B, T1, S, H dh) pre-subtract -> out (B, T1, S, H dh); dt 0 f32, 1 bf16;
// T1 >= 2, dh <= 128.
int istvt_temporal_unpacked(const void* q, const void* k, const void* v, void* out, int dt, int B,
                            int T1, int S, int H, int dh, float scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  int rc = dt == kBF16
               ? launch_temporal_unpacked<__nv_bfloat16>(q, k, v, out, B, T1, S, H, dh, scale, st)
               : launch_temporal_unpacked<float>(q, k, v, out, B, T1, S, H, dh, scale, st);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// q, k, v, dout (B, T1, S, H dh) -> dq, dk, dv (B, T1, S, H dh) with respect to the
// pre-subtract streams; T1 >= 2, dh <= 128.
int istvt_temporal_unpacked_bwd(const void* q, const void* k, const void* v, const void* dout,
                                void* dq, void* dk, void* dv, int dt, int B, int T1, int S, int H,
                                int dh, float scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  int rc = dt == kBF16 ? launch_temporal_unpacked_bwd<__nv_bfloat16>(q, k, v, dout, dq, dk, dv, B,
                                                                     T1, S, H, dh, scale, st)
                       : launch_temporal_unpacked_bwd<float>(q, k, v, dout, dq, dk, dv, B, T1, S,
                                                             H, dh, scale, st);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
