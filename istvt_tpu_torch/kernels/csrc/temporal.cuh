// The self-subtract temporal attention core (iv) and its backward, as device functions
// on packed [q | k | v] rows: q8_attention.cu launches the forward as a kernel of its
// own (temporal_attn_kernel, #11 and the core of #1), q8_layer.cu runs it as #9's
// phase 3, attention_bwd.cu launches the backward (temporal_attn_bwd_kernel, #12).
// As in q8_attention.cuh, no pointer parameter is __restrict__ (#9 reads here what it
// wrote earlier in the same launch).
//
// What they compute (istvt_tpu/kernels/attention.py _temporal_packed_kernel and
// _temporal_packed_bwd_kernel): per (clip, location, head), softmax attention over the
// T1 frames after the self-subtract cat(x[:2], x[2:] - x[1:-1]) on q and k, taken
// in the activation dtype; f32 logits x dh^-0.5, max-shifted exp, the weights left
// unnormalised through PV and one division acc / den per output element. Backward: dq
// summed in f32 over the key frames and rounded once; dk and dv summed over the query
// frames in ascending order in the activation dtype, each term rounded first; then the
// transposed self-subtract, in the activation dtype.
//
// What bounds them on the H100: bytes. Per (clip, location) the forward reads T1 rows
// of 3 I and writes T1 rows of I (at B=16, I = 512, bf16: 126.6 + 42.2 MB, 0.050 ms at
// 3.35 TB/s) and does 4 T1^2 I operations (0.59 G at B=16: 0.009 ms at the 67 TFLOP/s
// of the f32 pipes); the backward reads qkv and dO and writes dqkv (295 MB, 0.088 ms)
// and does 10 T1^2 I operations (0.022 ms).
//
// The layout (a TPlan<V, L, C>, kernels/attention.temporal_plan picks it): the threads
// of one (clip, location) take all its heads, L lanes a head, consecutive threads on
// consecutive heads, so a block covers several locations and each warp load or store
// is a run of whole 128-byte lines of a q, k, v or output row. Lane l of a head holds
// elements (c L + l) V + [0, V) of each row, c < C:
//   * the wide form: one vector a lane, C = 1, L = dh / V rounded up to a power of
//     two. In the forward V is 16 bytes (8 bf16 or 4 f32; dh 64: 8 lanes in bf16, 16
//     in f32), so every global access is a 16-byte vector. In the backward V is 4
//     elements (16 bytes of f32, 8 of bf16; 16 lanes at dh 64): with 8 bf16 a lane
//     its registers (157) and its chain of dependent work a query frame doubled, and
//     at B=16 it took 0.387 ms against 0.178 with 4 (NVIDIA H100 80GB HBM3, 700 W);
//   * the narrow form, for a dh that is not a multiple of V: V = 1, L = 32, C = 1, 2 or
//     4 (element loads; the same arithmetic).
// Each score is summed over the lane's E = V C elements, then over the head's L lanes
// by a transposed reduction (head_sum: each shuffle step halves the partial sums a lane
// holds, so a score takes 7 shuffles a query row in all at L = 8 rather than 5 each),
// which leaves every score whole on one lane; its exp (and in the backward its p and
// ds) is computed there once and broadcast by one shuffle to the head's lanes. Sums of
// f32 products change order against the warp-per-head kernels these replace; every
// rounding and every __fmul_rn / __fadd_rn stays where it was (nothing is fused). A
// wide bf16 row is held as bf16 pairs: the self-subtract and the backward's dk / dv
// accumulation run on them as sub.rn / add.rn.bf16x2, which round the exact result
// once, as the f32 operation then a rounding to bf16 does (24 >= 2 x 8 + 2 bits, so
// the double rounding is innocuous).
//
// Bytes in flight: the forward keeps q, k and v of every frame in registers (96 words
// a lane at T1 = 8) and issues all 3 T1 loads before any arithmetic; the backward
// stages q, k, v and dO of every frame by cp.async into the lane's own slots of shared
// memory (4 T1 copies in flight a lane, no barrier: a lane reads only what it copied)
// and keeps only the dk / dv accumulators (32 words in bf16, 64 in f32) in registers.
// Measured at B=16 (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6): the forward at 66% of
// its byte bound in bf16 and 87% in f32, #12 at 49% and 79%; #12 is held back by its
// chains of dependent work more than by bytes (left out, its dk / dv updates took
// only 0.178 -> 0.159 ms in bf16).
//
// Those lanes hold a row of every frame at once, so they take T1 <= kTMax = 8 (the
// paper's T1 = 7). Longer clips (the JAX kernels take a whole clip of any T1 as one VMEM
// block) go to the general lanes, temporal_attn_lane_any and temporal_attn_bwd_lane_any:
// the same layout, plan and arithmetic, with nothing that scales with a compile-time T1
// in registers. Each lane stages the subtracted k and the v of every frame in its own
// slots (TSlots: dynamic shared memory, as many warps a block as the T1 slots fit, or a
// device scratch where not one warp's fit) and walks the key frames kTMax at a time, so
// that head_sum, head_max and head_bcast work on the same kTMax items as above. The
// forward keeps JAX's order by two sweeps over the keys per query frame: the first
// finds the max of the scaled scores, the second recomputes them (the same bits), takes
// exp(s - max) and sums den and the unnormalised PV in ascending j, then one division
// per element. The backward sweeps three times (the max; den and sum e dp; p, ds and the
// updates), q and dO of the query frame read from device memory, dk and dv summed in
// the activation dtype in two more slot rows (4 T1 slots a lane, as the kTMax lane's
// staging). At T1 <= kTMax one sweep's block is the whole clip, and the general lanes'
// arithmetic is the register lanes' step for step; they run only at T1 > kTMax.
#pragma once

#include <algorithm>

#include <type_traits>

#include "mma.cuh"

namespace istvt {

constexpr int kTMax = 8;                // the register lanes' T1; past it the general lanes
constexpr int kTemporalThreads = 256;   // temporal_attn_kernel's block
constexpr int kTemporalBwdThreads = 128;  // temporal_attn_bwd_kernel's block
constexpr int kTemporalBwdVec = 4;  // its wide form's vector: 16 bytes of f32, 8 of bf16

__host__ __device__ constexpr int pow2_ceil(int n) { return n <= 1 ? 1 : 2 * pow2_ceil((n + 1) / 2); }

template <int V_, int L_, int C_>
struct TPlan {
  static constexpr int V = V_, L = L_, C = C_;
};

// #9's plan at its compile-time dim_head: the wide form, as temporal_plan picks it.
template <typename T, int DH>
struct TemporalWide {
  static constexpr int V = 16 / sizeof(T);
  static_assert(DH % V == 0, "#9 takes the wide form only");
  using Plan = TPlan<V, pow2_ceil(DH / V), 1>;
};

// Calls f(TPlan<V, L, C>{}) for the plan (vec, lanes, chunks) if it is instantiated:
// the wide form with vectors of VW elements at L = 1 .. 128 / VW, the narrow form at
// C = 1, 2, 4.
template <int VW, typename F>
int with_temporal_plan(int vec, int lanes, int chunks, F&& f) {
  if (vec == VW && chunks == 1) {
    switch (lanes) {
      case 1: f(TPlan<VW, 1, 1>{}); return 0;
      case 2: f(TPlan<VW, 2, 1>{}); return 0;
      case 4: f(TPlan<VW, 4, 1>{}); return 0;
      case 8: f(TPlan<VW, 8, 1>{}); return 0;
      case 16: f(TPlan<VW, 16, 1>{}); return 0;
      case 32:
        if constexpr (VW <= 4) {
          f(TPlan<VW, 32, 1>{});
          return 0;
        }
        break;
      default: break;
    }
  } else if (vec == 1 && lanes == 32) {
    switch (chunks) {
      case 1: f(TPlan<1, 32, 1>{}); return 0;
      case 2: f(TPlan<1, 32, 2>{}); return 0;
      case 4: f(TPlan<1, 32, 4>{}); return 0;
      default: break;
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = full ? 8 : 0;  // 0: write 8 zero bytes, read nothing
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ uint32_t bf16x2_add(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// One lane's part of one row of a head: E = V C elements, held as W 32-bit words (bf16
// pairs in the wide bf16 form, else each element as an f32, exact for bf16).
template <typename T, int V, int L, int C>
struct TRow {
  static constexpr int E = V * C;
  static constexpr int kV = V;
  static constexpr bool kVec = V > 1;  // the wide form: one vector of kBytes a lane
  static constexpr int kBytes = V * sizeof(T);
  static constexpr bool kPacked = kVec && std::is_same<T, __nv_bfloat16>::value;
  static constexpr int W = kPacked ? E / 2 : E;
  static_assert(kVec ? C == 1 && (kBytes == 8 || kBytes == 16) : V == 1,
                "one 8- or 16-byte vector a lane, or C single elements");
  uint32_t w[W];

  __device__ __forceinline__ float at(int e) const {
    if constexpr (kPacked) {
      return __uint_as_float((e & 1) ? (w[e >> 1] & 0xffff0000u) : (w[e >> 1] << 16));
    } else {
      return __uint_as_float(w[e]);
    }
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < W; ++i) w[i] = 0u;
  }
  // The lane's elements of the head row at p (its first element); zeros where !on.
  __device__ __forceinline__ void load(const T* p, int lane, int dh, bool on) {
    if constexpr (kVec && kBytes == 16) {
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (on && lane * V < dh) u = *reinterpret_cast<const uint4*>(p + lane * V);
      w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
    } else if constexpr (kVec) {
      uint2 u = make_uint2(0u, 0u);
      if (on && lane * V < dh) u = *reinterpret_cast<const uint2*>(p + lane * V);
      w[0] = u.x, w[1] = u.y;
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int d = c * L + lane;
        w[c] = on && d < dh ? __float_as_uint(to_f(p[d])) : 0u;
      }
    }
  }
  __device__ __forceinline__ void store(T* p, int lane, int dh, bool on) const {
    if constexpr (kVec && kBytes == 16) {
      if (on && lane * V < dh) *reinterpret_cast<uint4*>(p + lane * V) = make_uint4(w[0], w[1], w[2], w[3]);
    } else if constexpr (kVec) {
      if (on && lane * V < dh) *reinterpret_cast<uint2*>(p + lane * V) = make_uint2(w[0], w[1]);
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int d = c * L + lane;
        if (on && d < dh) p[d] = from_f<T>(__uint_as_float(w[c]));
      }
    }
  }
  // The lane's shared-memory slot of W words (aligned to its size).
  __device__ __forceinline__ void to_shared(uint32_t* slot) const {
    if constexpr (W == 4) {
      *reinterpret_cast<uint4*>(slot) = make_uint4(w[0], w[1], w[2], w[3]);
    } else if constexpr (W == 2) {
      *reinterpret_cast<uint2*>(slot) = make_uint2(w[0], w[1]);
    } else {
      slot[0] = w[0];
    }
  }
  __device__ __forceinline__ void from_shared(const uint32_t* slot) {
    if constexpr (W == 4) {
      const uint4 u = *reinterpret_cast<const uint4*>(slot);
      w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
    } else if constexpr (W == 2) {
      const uint2 u = *reinterpret_cast<const uint2*>(slot);
      w[0] = u.x, w[1] = u.y;
    } else {
      w[0] = slot[0];
    }
  }
  // x rounded to T.
  __device__ __forceinline__ static TRow rounded(const float (&x)[E]) {
    TRow r;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      if constexpr (kPacked) r.w[i] = bf16x2_bits(x[2 * i], x[2 * i + 1]);
      else r.w[i] = __float_as_uint(round_to<T>(x[i]));
    }
    return r;
  }
  // a - b rounded to T.
  __device__ __forceinline__ static TRow sub(const TRow& a, const TRow& b) {
    TRow r;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      if constexpr (kPacked) r.w[i] = bf16x2_sub(a.w[i], b.w[i]);
      else r.w[i] = __float_as_uint(round_to<T>(__fsub_rn(a.at(i), b.at(i))));
    }
    return r;
  }
  // *this = round(*this + round(x)) in T, element by element.
  __device__ __forceinline__ void add_rounded(const float (&x)[E]) {
#pragma unroll
    for (int i = 0; i < W; ++i) {
      if constexpr (kPacked) {
        w[i] = bf16x2_add(w[i], bf16x2_bits(x[2 * i], x[2 * i + 1]));
      } else {
        w[i] = __float_as_uint(round_to<T>(__fadd_rn(at(i), round_to<T>(x[i]))));
      }
    }
  }
};

// Where head_sum<N, G, L> leaves item j (of N) of a head's L lanes: in slot(j) of lane
// owner(j) (and, for L > N, of the kSpread lanes after it, which hold copies); a lane
// holds R items, item(lane, r) in slot r.
template <int N, int L>
struct HeadItems {
  static constexpr int R = L <= N ? N / L : 1;
  static constexpr int kSpread = L <= N ? 1 : L / N;
  __device__ __forceinline__ static int item(int lane, int r) {
    return L <= N ? lane * R + r : lane / kSpread;
  }
  __host__ __device__ static constexpr int owner(int j) { return L <= N ? j / R : j * kSpread; }
  __host__ __device__ static constexpr int slot(int j) { return L <= N ? j % R : 0; }
};

template <int G, int n, int o, int M>
__device__ __forceinline__ void head_sum_step(float (&v)[M], int lane) {
  if constexpr (o > 0) {
    if constexpr (n > 1) {
      constexpr int half = n / 2 * G;
      const bool up = lane & o;
#pragma unroll
      for (int k = 0; k < half; ++k) {
        const float send = up ? v[k] : v[k + half];
        const float keep = up ? v[k + half] : v[k];
        v[k] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, o));
      }
      head_sum_step<G, n / 2, o / 2>(v, lane);
    } else {
#pragma unroll
      for (int k = 0; k < G; ++k) v[k] = __fadd_rn(v[k], __shfl_xor_sync(0xffffffffu, v[k], o));
      head_sum_step<G, 1, o / 2>(v, lane);
    }
  }
}

// v holds this lane's partial sums of N items of G floats (item j at v[j G .. j G + G));
// on return slot r (v[r G ..]) holds the whole sum over the head's L lanes of item
// HeadItems<N, L>::item(lane, r). The lanes of a head are an aligned group of L.
template <int N, int G, int L>
__device__ __forceinline__ void head_sum(float (&v)[N * G], int lane) {
  head_sum_step<G, N, L / 2>(v, lane);
}

// The max / sum of x over the head's items: one value a lane, lanes that hold copies
// (HeadItems::kSpread) counted once.
template <int L, int kSpread>
__device__ __forceinline__ float head_max(float x) {
#pragma unroll
  for (int o = L / 2; o >= kSpread && o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <int L, int kSpread>
__device__ __forceinline__ float head_total(float x) {
#pragma unroll
  for (int o = L / 2; o >= kSpread && o > 0; o >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Item j's value from the lane that holds it, to every lane of the head.
template <typename It, int L, int M>
__device__ __forceinline__ float head_bcast(const float (&v)[M], int j) {
  if constexpr (L == 1) {
    return v[It::slot(j)];
  } else {
    return __shfl_sync(0xffffffffu, v[It::slot(j)], It::owner(j), L);
  }
}

// Where thread g of a launch over B S H L threads works: head h of location s of clip
// b, lane l of the head.
struct TemporalSite {
  long b;
  int s, h, lane;
  template <int L>
  __device__ __forceinline__ static TemporalSite of(long g, int S, int H) {
    const long unit = g / L;
    const long bs = unit / H;
    return {bs / S, static_cast<int>(bs % S), static_cast<int>(unit % H),
            static_cast<int>(g & (L - 1))};
  }
  // row t of this location among rows of `width` elements, at head h's first column
  __device__ __forceinline__ size_t row(int t, int T1, int S, int width, int dh) const {
    return (static_cast<size_t>(b * T1 + t) * S + s) * width + static_cast<size_t>(h) * dh;
  }
};

// (iv) The forward, thread g of B S H L (every lane of the warp calls it, for the
// shuffles: those with !on compute on zeros and store nothing). qkv (B, T1, S, 3
// inner) -> out (B, T1, S, inner).
template <typename T, int V, int L, int C>
__device__ __forceinline__ void temporal_attn_lane(const T* qkv, T* out, int T1, int S, int H,
                                                   int inner, int dh, float scale, long g,
                                                   bool on) {
  using Row = TRow<T, V, L, C>;
  using It = HeadItems<kTMax, L>;
  constexpr int E = Row::E, R = It::R;
  const TemporalSite at = TemporalSite::of<L>(g, S, H);
  const int lane = at.lane;

  Row q[kTMax], k[kTMax], v[kTMax];
#pragma unroll
  for (int t = 0; t < kTMax; ++t) {
    if (t < T1) {
      const T* row = qkv + at.row(t, T1, S, 3 * inner, dh);
      q[t].load(row, lane, dh, on);
      k[t].load(row + inner, lane, dh, on);
      v[t].load(row + 2 * inner, lane, dh, on);
    } else {
      q[t].zero(), k[t].zero(), v[t].zero();
    }
  }
  // self-subtract in the activation dtype, rows 0 and 1 unchanged; descending t so
  // that q[t - 1] still holds the projected (unsubtracted) value
#pragma unroll
  for (int t = kTMax - 1; t >= 2; --t) {
    if (t < T1) {
      q[t] = Row::sub(q[t], q[t - 1]);
      k[t] = Row::sub(k[t], k[t - 1]);
    }
  }
#pragma unroll
  for (int i = 0; i < kTMax; ++i) {
    if (i >= T1) break;
    float l[kTMax];
#pragma unroll
    for (int j = 0; j < kTMax; ++j) {
      float p = 0.f;
      if (j < T1) {
#pragma unroll
        for (int e = 0; e < E; ++e) p = __fadd_rn(p, __fmul_rn(q[i].at(e), k[j].at(e)));
      }
      l[j] = p;
    }
    head_sum<kTMax, 1, L>(l, lane);
    // this lane's scores: scaled, -inf past T1; their max over the head, their exp
    float m = -INFINITY;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      l[r] = It::item(lane, r) < T1 ? __fmul_rn(l[r], scale) : -INFINITY;
      m = fmaxf(m, l[r]);
    }
    m = head_max<L, It::kSpread>(m);
#pragma unroll
    for (int r = 0; r < R; ++r) l[r] = expf(l[r] - m);
    float den = 0.f, acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.f;
#pragma unroll
    for (int j = 0; j < kTMax; ++j) {
      if (j < T1) {
        const float w = head_bcast<It, L>(l, j);
        den = __fadd_rn(den, w);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] = __fadd_rn(acc[e], __fmul_rn(w, v[j].at(e)));
      }
    }
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = __fdiv_rn(acc[e], den);
    Row::rounded(acc).store(out + at.row(i, T1, S, inner, dh), lane, dh, on);
  }
}

// (i) The backward, thread g of B S H L (every lane of the warp calls it). qkv (B, T1,
// S, 3 inner), dout (B, T1, S, inner) -> dqkv (B, T1, S, 3 inner). slots: this thread's
// first slot of TRow::W words of shared memory; slot (x, t) of q, k, v, dO (x = 0 .. 3)
// and frame t at slots + (x T1 + t) stride.
template <typename T, int V, int L, int C>
__device__ __forceinline__ void temporal_attn_bwd_lane(const T* qkv, const T* dout, T* dqkv,
                                                       int T1, int S, int H, int inner, int dh,
                                                       float scale, long g, bool on,
                                                       uint32_t* slots, int stride) {
  using Row = TRow<T, V, L, C>;
  using It = HeadItems<kTMax, L>;
  constexpr int E = Row::E, R = It::R;
  const TemporalSite at = TemporalSite::of<L>(g, S, H);
  const int lane = at.lane;
  auto slot = [&](int x, int t) { return slots + static_cast<size_t>(x * T1 + t) * stride; };
  auto staged = [&](int x, int t) {
    Row r;
    r.from_shared(slot(x, t));
    return r;
  };

  // stage q, k, v and dO of every frame: 4 T1 copies in flight
  for (int t = 0; t < T1; ++t) {
    const T* row = qkv + at.row(t, T1, S, 3 * inner, dh);
    const T* grow = dout + at.row(t, T1, S, inner, dh);
    if constexpr (Row::kVec) {
      const bool in = on && lane * V < dh;
      const int c = in ? lane * V : 0;  // a valid address for the zero fill
      if (!on) row = qkv, grow = dout;
      const T* src[4] = {row + c, row + inner + c, row + 2 * inner + c, grow + c};
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        if constexpr (Row::kBytes == 16) cp_async16(slot(x, t), src[x], in);
        else cp_async8(slot(x, t), src[x], in);
      }
    } else {
      Row r;
      r.load(row, lane, dh, on);
      r.to_shared(slot(0, t));
      r.load(row + inner, lane, dh, on);
      r.to_shared(slot(1, t));
      r.load(row + 2 * inner, lane, dh, on);
      r.to_shared(slot(2, t));
      r.load(grow, lane, dh, on);
      r.to_shared(slot(3, t));
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  // self-subtract of q and k in place, in the activation dtype, descending t
  for (int t = T1 - 1; t >= 2; --t) {
    Row::sub(staged(0, t), staged(0, t - 1)).to_shared(slot(0, t));
    Row::sub(staged(1, t), staged(1, t - 1)).to_shared(slot(1, t));
  }

  Row dk[kTMax], dv[kTMax], dq_last;
#pragma unroll
  for (int t = 0; t < kTMax; ++t) dk[t].zero(), dv[t].zero();
  dq_last.zero();
  auto out_row = [&](int t) { return dqkv + at.row(t, T1, S, 3 * inner, dh); };
#pragma unroll
  for (int i = 0; i < kTMax; ++i) {
    if (i >= T1) break;
    const Row qi = staged(0, i), gi = staged(3, i);
    // (l_j, dp_j) = (q_i . k_j, dO_i . v_j), item j of the head's sums
    float a[2 * kTMax];
#pragma unroll
    for (int j = 0; j < kTMax; ++j) {
      a[2 * j] = a[2 * j + 1] = 0.f;
      if (j < T1) {
        const Row kj = staged(1, j), vj = staged(2, j);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          a[2 * j] = __fadd_rn(a[2 * j], __fmul_rn(qi.at(e), kj.at(e)));
          a[2 * j + 1] = __fadd_rn(a[2 * j + 1], __fmul_rn(gi.at(e), vj.at(e)));
        }
      }
    }
    head_sum<kTMax, 2, L>(a, lane);
    float lg[R], dp[R], m = -INFINITY;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool in = It::item(lane, r) < T1;
      lg[r] = in ? __fmul_rn(a[2 * r], scale) : -INFINITY;
      dp[r] = in ? a[2 * r + 1] : 0.f;
      m = fmaxf(m, lg[r]);
    }
    m = head_max<L, It::kSpread>(m);
    float es[R], den = 0.f, pdp = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      es[r] = expf(lg[r] - m);
      den = __fadd_rn(den, es[r]);
      pdp = __fadd_rn(pdp, __fmul_rn(es[r], dp[r]));
    }
    den = head_total<L, It::kSpread>(den);
    pdp = __fdiv_rn(head_total<L, It::kSpread>(pdp), den);
    // p and ds once, on the lane that holds the item; then to every lane of the head
    float p[R], ds[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      // past T1, es = 0: p = 0 without the division (whose zero dividend takes its slow
      // path)
      p[r] = It::item(lane, r) < T1 ? __fdiv_rn(es[r], den) : 0.f;
      ds[r] = __fmul_rn(__fmul_rn(p[r], __fsub_rn(dp[r], pdp)), scale);
    }
    float dq[E];
#pragma unroll
    for (int e = 0; e < E; ++e) dq[e] = 0.f;
#pragma unroll
    for (int j = 0; j < kTMax; ++j) {
      if (j < T1) {
        const float pj = head_bcast<It, L>(p, j), dsj = head_bcast<It, L>(ds, j);
        const Row kj = staged(1, j);
        float xk[E], xv[E];
#pragma unroll
        for (int e = 0; e < E; ++e) {
          dq[e] = __fadd_rn(dq[e], __fmul_rn(dsj, kj.at(e)));
          xk[e] = __fmul_rn(dsj, qi.at(e));
          xv[e] = __fmul_rn(pj, gi.at(e));
        }
        dk[j].add_rounded(xk);
        dv[j].add_rounded(xv);
      }
    }
    // dq of frame i rounded once; the transposed self-subtract of frame i - 1:
    // d[0] = ds[0], d[t] = ds[t] - ds[t + 1] for 1 <= t < T1 - 1
    const Row dqi = Row::rounded(dq);
    if (i >= 1) (i >= 2 ? Row::sub(dq_last, dqi) : dq_last).store(out_row(i - 1), lane, dh, on);
    dq_last = dqi;
  }
  dq_last.store(out_row(T1 - 1), lane, dh, on);
#pragma unroll
  for (int t = 0; t < kTMax; ++t) {
    if (t >= T1) break;
    const int next = t + 1 < kTMax ? t + 1 : t;
    const Row gk = t >= 1 && t + 1 < T1 ? Row::sub(dk[t], dk[next]) : dk[t];
    gk.store(out_row(t) + inner, lane, dh, on);
    dv[t].store(out_row(t) + 2 * inner, lane, dh, on);
  }
}


// --- the general lanes, any T1 (see the header): staged rows and their slots

// Where a general lane keeps its staged rows: slot (x, t) at base + (x T1 + t) stride
// words, W = TRow::W words each. In dynamic shared memory the block's threads sit side
// by side (base = smem + threadIdx.x W, stride = blockDim.x W, filled by cp.async); in
// a device scratch the launch's threads do (base = scratch + g W, stride = threads x W).
struct TSlots {
  uint32_t* base;
  long stride;
  bool shared;
  __device__ __forceinline__ uint32_t* at(int x, int t, int T1) const {
    return base + static_cast<size_t>(x * T1 + t) * stride;
  }
};

// The slots of thread threadIdx.x of a launch of 1-D blocks with W-word rows: in the
// block's dynamic shared memory `smem`, or in `scratch` where it is given.
__device__ __forceinline__ TSlots temporal_slots(uint32_t* smem, uint32_t* scratch, int W) {
  if (scratch != nullptr) {
    const long g = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
    return {scratch + g * W, static_cast<long>(gridDim.x) * blockDim.x * W, false};
  }
  return {smem + threadIdx.x * W, static_cast<long>(blockDim.x) * W, true};
}

// This lane's part of the head row at p (its first element) into slot s, zeros where
// !on: by cp.async where the slots are in shared memory and the row is one vector a
// lane (any: a valid address for the zero fill), else through registers. Completed by
// the caller's cp_async_commit / cp_async_wait.
template <typename Row, typename T>
__device__ __forceinline__ void stage_row(uint32_t* s, const T* p, const T* any, int lane, int dh,
                                          bool on, bool shared) {
  if constexpr (Row::kVec) {
    if (shared) {
      const bool in = on && lane * Row::kV < dh;
      const T* src = in ? p + lane * Row::kV : any;
      if constexpr (Row::kBytes == 16) cp_async16(s, src, in);
      else cp_async8(s, src, in);
      return;
    }
  }
  Row r;
  r.load(p, lane, dh, on);
  r.to_shared(s);
}

// Warps a block of a general lane's kernel: as many as the block's shared memory holds
// at `words` slot words a thread, at most max_warps; 0 where not one warp's slots fit
// (the launch then puts them in a device scratch). < 0: a CUDA error.
inline int temporal_any_warps(long words, int max_warps) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return -static_cast<int>(e);
  return static_cast<int>(std::min<long>(max_warps, optin / (32L * 4 * words)));
}

// A general lane's launch: (threads a block, dynamic shared memory bytes, scratch
// bytes) for nslots T1 slots of W words a thread, blocks of at most kMaxThreads; scratch
// 0 unless not one warp's slots fit the block's shared memory. false on a CUDA error
// (in *err).
struct TemporalAnyLaunch {
  int threads, smem;
  long long scratch;
};

template <int kMaxThreads>
bool temporal_any_launch(long total, int T1, int nslots, int W, TemporalAnyLaunch* out,
                         int* err) {
  const long words = static_cast<long>(nslots) * T1 * W;
  const int warps = temporal_any_warps(words, kMaxThreads / 32);
  if (warps < 0) {
    *err = -warps;
    return false;
  }
  if (warps > 0) {
    *out = {32 * warps, static_cast<int>(32 * warps * words * 4), 0};
  } else {
    const long blocks = (total + kMaxThreads - 1) / kMaxThreads;
    *out = {kMaxThreads, 0, static_cast<long long>(blocks) * kMaxThreads * words * 4};
  }
  return true;
}

// Launches a general lane's kernel over `total` threads: blocks and shared memory by
// temporal_any_launch, its arguments then the scratch (passed where the slots go there;
// a null scratch then is cudaErrorInvalidValue). 0 or the CUDA error.
template <int kMaxThreads, typename Kern, typename... Args>
int launch_temporal_any(Kern kern, long total, int T1, int nslots, int W, void* scratch,
                        cudaStream_t st, Args... args) {
  TemporalAnyLaunch la;
  int err = 0;
  if (!temporal_any_launch<kMaxThreads>(total, T1, nslots, W, &la, &err)) return err;
  if (la.scratch > 0 && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (la.smem > 0) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, la.smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long blocks = (total + la.threads - 1) / la.threads;
  kern<<<static_cast<unsigned>(blocks), la.threads, la.smem, st>>>(
      args..., la.scratch > 0 ? static_cast<uint32_t*>(scratch) : nullptr);
  return 0;
}

// q of frame i, self-subtracted in the activation dtype (frames 0 and 1 as projected);
// prev holds frame i - 1's projected q on entry and frame i's on return.
template <typename Row, typename T>
__device__ __forceinline__ Row subtracted_q(const T* qkv, const TemporalSite& at, int i, int T1,
                                            int S, int inner, int dh, bool on, Row& prev) {
  Row q;
  q.load(qkv + at.row(i, T1, S, 3 * inner, dh), at.lane, dh, on);
  const Row raw = q;
  if (i >= 2) q = Row::sub(q, prev);
  prev = raw;
  return q;
}

// A general lane's scores q_i . k_j of key frames j0 .. j0 + kTMax - 1 (0 past T1),
// item j of head_sum's, then this lane's items scaled (-inf past T1); k_j from slot
// (0, j).
template <typename Row, typename It, int L>
__device__ __forceinline__ void any_scores(float (&l)[kTMax], const Row& qi, const TSlots& sl,
                                           int j0, int T1, int lane, float scale) {
#pragma unroll
  for (int j = 0; j < kTMax; ++j) {
    float p = 0.f;
    if (j0 + j < T1) {
      Row kj;
      kj.from_shared(sl.at(0, j0 + j, T1));
#pragma unroll
      for (int e = 0; e < Row::E; ++e) p = __fadd_rn(p, __fmul_rn(qi.at(e), kj.at(e)));
    }
    l[j] = p;
  }
  head_sum<kTMax, 1, L>(l, lane);
#pragma unroll
  for (int r = 0; r < It::R; ++r)
    l[r] = j0 + It::item(lane, r) < T1 ? __fmul_rn(l[r], scale) : -INFINITY;
}

// The backward's (l_j, dp_j) = (q_i . k_j, dO_i . v_j) of key frames j0 .. j0 + kTMax -
// 1, item j of head_sum's (pairs); without kDp only l (a[2 j + 1] = 0). k_j, v_j from
// slots (0, j), (1, j).
template <typename Row, int L, bool kDp>
__device__ __forceinline__ void any_sums(float (&a)[2 * kTMax], const Row& qi, const Row& gi,
                                         const TSlots& sl, int j0, int T1, int lane) {
#pragma unroll
  for (int j = 0; j < kTMax; ++j) {
    a[2 * j] = a[2 * j + 1] = 0.f;
    if (j0 + j < T1) {
      Row kj;
      kj.from_shared(sl.at(0, j0 + j, T1));
#pragma unroll
      for (int e = 0; e < Row::E; ++e) a[2 * j] = __fadd_rn(a[2 * j], __fmul_rn(qi.at(e), kj.at(e)));
      if constexpr (kDp) {
        Row vj;
        vj.from_shared(sl.at(1, j0 + j, T1));
#pragma unroll
        for (int e = 0; e < Row::E; ++e)
          a[2 * j + 1] = __fadd_rn(a[2 * j + 1], __fmul_rn(gi.at(e), vj.at(e)));
      }
    }
  }
  head_sum<kTMax, 2, L>(a, lane);
}

// (iv) The forward at any T1, thread g of B S H L (every lane of the warp calls it, as
// temporal_attn_lane). Slots: k (subtracted, x = 0) and v (x = 1) of every frame.
template <typename T, int V, int L, int C>
__device__ __forceinline__ void temporal_attn_lane_any(const T* qkv, T* out, int T1, int S, int H,
                                                       int inner, int dh, float scale, long g,
                                                       bool on, const TSlots& sl) {
  using Row = TRow<T, V, L, C>;
  using It = HeadItems<kTMax, L>;
  constexpr int E = Row::E, R = It::R;
  const TemporalSite at = TemporalSite::of<L>(g, S, H);
  const int lane = at.lane;
  auto staged = [&](int x, int t) {
    Row r;
    r.from_shared(sl.at(x, t, T1));
    return r;
  };
  for (int t = 0; t < T1; ++t) {
    const T* row = qkv + at.row(t, T1, S, 3 * inner, dh);
    stage_row<Row>(sl.at(0, t, T1), row + inner, qkv, lane, dh, on, sl.shared);
    stage_row<Row>(sl.at(1, t, T1), row + 2 * inner, qkv, lane, dh, on, sl.shared);
  }
  cp_async_commit();
  cp_async_wait<0>();
  // self-subtract of k in place, in the activation dtype, descending t
  for (int t = T1 - 1; t >= 2; --t) Row::sub(staged(0, t), staged(0, t - 1)).to_shared(sl.at(0, t, T1));

  Row qprev;
  qprev.zero();
  for (int i = 0; i < T1; ++i) {
    const Row qi = subtracted_q<Row>(qkv, at, i, T1, S, inner, dh, on, qprev);
    float m = -INFINITY;
    for (int j0 = 0; j0 < T1; j0 += kTMax) {
      float l[kTMax];
      any_scores<Row, It, L>(l, qi, sl, j0, T1, lane, scale);
#pragma unroll
      for (int r = 0; r < R; ++r) m = fmaxf(m, l[r]);
    }
    m = head_max<L, It::kSpread>(m);
    float den = 0.f, acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.f;
    for (int j0 = 0; j0 < T1; j0 += kTMax) {
      float l[kTMax];
      any_scores<Row, It, L>(l, qi, sl, j0, T1, lane, scale);
#pragma unroll
      for (int r = 0; r < R; ++r) l[r] = expf(l[r] - m);
#pragma unroll
      for (int j = 0; j < kTMax; ++j) {
        if (j0 + j < T1) {
          const float w = head_bcast<It, L>(l, j);
          den = __fadd_rn(den, w);
          const Row vj = staged(1, j0 + j);
#pragma unroll
          for (int e = 0; e < E; ++e) acc[e] = __fadd_rn(acc[e], __fmul_rn(w, vj.at(e)));
        }
      }
    }
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = __fdiv_rn(acc[e], den);
    Row::rounded(acc).store(out + at.row(i, T1, S, inner, dh), lane, dh, on);
  }
}

// (i) The backward at any T1, thread g of B S H L (every lane of the warp calls it).
// Slots: k (subtracted, x = 0) and v (x = 1) of every frame, and the dk (x = 2) and dv
// (x = 3) sums over the query frames so far.
template <typename T, int V, int L, int C>
__device__ __forceinline__ void temporal_attn_bwd_lane_any(const T* qkv, const T* dout, T* dqkv,
                                                           int T1, int S, int H, int inner,
                                                           int dh, float scale, long g, bool on,
                                                           const TSlots& sl) {
  using Row = TRow<T, V, L, C>;
  using It = HeadItems<kTMax, L>;
  constexpr int E = Row::E, R = It::R;
  const TemporalSite at = TemporalSite::of<L>(g, S, H);
  const int lane = at.lane;
  auto staged = [&](int x, int t) {
    Row r;
    r.from_shared(sl.at(x, t, T1));
    return r;
  };
  Row zero;
  zero.zero();
  for (int t = 0; t < T1; ++t) {
    const T* row = qkv + at.row(t, T1, S, 3 * inner, dh);
    stage_row<Row>(sl.at(0, t, T1), row + inner, qkv, lane, dh, on, sl.shared);
    stage_row<Row>(sl.at(1, t, T1), row + 2 * inner, qkv, lane, dh, on, sl.shared);
    zero.to_shared(sl.at(2, t, T1));
    zero.to_shared(sl.at(3, t, T1));
  }
  cp_async_commit();
  cp_async_wait<0>();
  for (int t = T1 - 1; t >= 2; --t) Row::sub(staged(0, t), staged(0, t - 1)).to_shared(sl.at(0, t, T1));

  auto out_row = [&](int t) { return dqkv + at.row(t, T1, S, 3 * inner, dh); };
  Row qprev, dq_last;
  qprev.zero();
  dq_last.zero();
  for (int i = 0; i < T1; ++i) {
    const Row qi = subtracted_q<Row>(qkv, at, i, T1, S, inner, dh, on, qprev);
    Row gi;
    gi.load(dout + at.row(i, T1, S, inner, dh), lane, dh, on);
    // sweep 1: the max of the scaled scores
    float m = -INFINITY;
    for (int j0 = 0; j0 < T1; j0 += kTMax) {
      float a[2 * kTMax];
      any_sums<Row, L, false>(a, qi, gi, sl, j0, T1, lane);
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (j0 + It::item(lane, r) < T1) m = fmaxf(m, __fmul_rn(a[2 * r], scale));
    }
    m = head_max<L, It::kSpread>(m);
    // sweep 2: den and sum e dp over this lane's items, then over the head
    float den = 0.f, pdp = 0.f;
    for (int j0 = 0; j0 < T1; j0 += kTMax) {
      float a[2 * kTMax];
      any_sums<Row, L, true>(a, qi, gi, sl, j0, T1, lane);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const bool in = j0 + It::item(lane, r) < T1;
        const float es = expf((in ? __fmul_rn(a[2 * r], scale) : -INFINITY) - m);
        den = __fadd_rn(den, es);
        pdp = __fadd_rn(pdp, __fmul_rn(es, in ? a[2 * r + 1] : 0.f));
      }
    }
    den = head_total<L, It::kSpread>(den);
    pdp = __fdiv_rn(head_total<L, It::kSpread>(pdp), den);
    // sweep 3: p and ds once, on the lane that holds the item; dq, and dk / dv in
    // their slots
    float dq[E];
#pragma unroll
    for (int e = 0; e < E; ++e) dq[e] = 0.f;
    for (int j0 = 0; j0 < T1; j0 += kTMax) {
      float a[2 * kTMax];
      any_sums<Row, L, true>(a, qi, gi, sl, j0, T1, lane);
      float p[R], ds[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const bool in = j0 + It::item(lane, r) < T1;
        const float es = expf((in ? __fmul_rn(a[2 * r], scale) : -INFINITY) - m);
        p[r] = in ? __fdiv_rn(es, den) : 0.f;
        ds[r] = __fmul_rn(__fmul_rn(p[r], __fsub_rn(in ? a[2 * r + 1] : 0.f, pdp)), scale);
      }
#pragma unroll
      for (int j = 0; j < kTMax; ++j) {
        if (j0 + j < T1) {
          const float pj = head_bcast<It, L>(p, j), dsj = head_bcast<It, L>(ds, j);
          const Row kj = staged(0, j0 + j);
          float xk[E], xv[E];
#pragma unroll
          for (int e = 0; e < E; ++e) {
            dq[e] = __fadd_rn(dq[e], __fmul_rn(dsj, kj.at(e)));
            xk[e] = __fmul_rn(dsj, qi.at(e));
            xv[e] = __fmul_rn(pj, gi.at(e));
          }
          Row dk = staged(2, j0 + j), dv = staged(3, j0 + j);
          dk.add_rounded(xk);
          dv.add_rounded(xv);
          dk.to_shared(sl.at(2, j0 + j, T1));
          dv.to_shared(sl.at(3, j0 + j, T1));
        }
      }
    }
    // dq of frame i rounded once; the transposed self-subtract of frame i - 1
    const Row dqi = Row::rounded(dq);
    if (i >= 1) (i >= 2 ? Row::sub(dq_last, dqi) : dq_last).store(out_row(i - 1), lane, dh, on);
    dq_last = dqi;
  }
  dq_last.store(out_row(T1 - 1), lane, dh, on);
  for (int t = 0; t < T1; ++t) {
    const Row gk = t >= 1 && t + 1 < T1 ? Row::sub(staged(2, t), staged(2, t + 1)) : staged(2, t);
    gk.store(out_row(t) + inner, lane, dh, on);
    staged(3, t).store(out_row(t) + 2 * inner, lane, dh, on);
  }
}

}  // namespace istvt
