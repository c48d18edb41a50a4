// The two attention cores as device functions: q8_attention.cu launches each as a
// kernel of its own, q8_layer.cu walks them inside one persistent kernel per ST
// layer (the temporal core, temporal_attn_lane, is in temporal.cuh). As in
// q8_rows_gemm.cuh, no pointer parameter is __restrict__ (the persistent kernel reads
// here what it wrote earlier in the same launch).
#pragma once

#include <type_traits>

#include "attention_tc.cuh"
#include "temporal.cuh"

namespace istvt {

// (v) Spatial attention of one (query tile, head, frame) by the block's threads (Tile,
// a TileThreads: 256 in the standalone kernels, 384 in #9):
// for each query row, f32 scores q.k (bf16 products on the tensor cores), x scale,
// -1e30 added for keys >= n_valid, the exact softmax in f32, p rounded to T, PV
// summed in f32, the output rounded to T (JAX's _mh_attention_vmem). Two tiles, one
// per activation dtype, chosen at compile time (the bf16 one never gives way to the
// f32 one):
//   * T = bf16: 16 rows a warp (128 queries a tile of 256 threads), on the tensor
//     cores (spatial_attn_tile_tc);
//   * T = float: 4 rows a warp (32 queries a tile of 256 threads), on the FMA pipes
//     (spatial_attn_tile_fma), so the f32 check holds at 1e-5 (TF32 would not).
// smem: spatial_smem_bytes<T, Tile>(DH) bytes, 16-byte aligned. A block may start its
// next tile on the same memory (the persistent ST layer #9 does): each tile's last
// shared-memory read is followed by a barrier that every warp passes before the next
// tile writes there, and no copy into shared memory is left in flight.
constexpr int kQW = 4, kMaxCh = 12;  // f32: 4 queries a warp; keys S <= 12 * 32 = 384
__host__ __device__ constexpr int spatial_smem_floats(int dh, int qt) {
  return dh * (qt + 4) + 32 * (dh + 1);
}

// Queries per tile: the grid's (and #9's tile walk's) unit.
template <typename T, typename Tile = Tile256>
__host__ __device__ constexpr int spatial_q_tile() {
  return std::is_same<T, float>::value ? kQW * Tile::kWarps : 16 * Tile::kWarps;
}

template <typename T, typename Tile = Tile256>
__host__ __device__ constexpr int spatial_smem_bytes(int dh) {
  return std::is_same<T, float>::value ? 4 * spatial_smem_floats(dh, spatial_q_tile<T, Tile>())
                                       : tc_smem_bytes(dh);
}

// The f32 tile: warp w owns queries 4w..4w+3 of the tile's QT, lane the keys 32 m +
// lane. smem: Q transposed, then one 32-key chunk of K or V; Q is rewritten only after
// every warp has passed the barrier before the tile's last V chunk.
template <int DH, typename Tile = Tile256, typename Rows>
__device__ __forceinline__ void spatial_attn_tile_fma(const Rows& src, float* out, int S,
                                                      int inner, int n_valid, float scale,
                                                      int q_tile, int h, int f, float* smem) {
  using T = float;
  constexpr int DPL = DH >= 32 ? DH / 32 : 1, QT = spatial_q_tile<T, Tile>();
  constexpr int kQS = QT + 4, kKS = DH + 1;  // row strides of Qs [DH][kQS], KV [32][kKS]
  float* Qs = smem;
  float* KV = smem + DH * kQS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = q_tile * QT;
  const Rows base = src.at(static_cast<size_t>(f) * S, h * DH);
  const int nch = (S + 31) / 32;

  for (int idx = tid; idx < QT * DH; idx += Tile::kThreads) {
    const int qq = idx / DH, d = idx % DH, row = q0 + qq;
    Qs[d * kQS + qq] = row < S ? to_f(base.q(row)[d]) : 0.f;
  }

  float sc[kQW][kMaxCh];
#pragma unroll
  for (int m = 0; m < kMaxCh; ++m) {
    if (m < nch) {
      Tile::sync();
      for (int idx = tid; idx < 32 * DH; idx += Tile::kThreads) {
        const int kk = idx / DH, d = idx % DH, key = m * 32 + kk;
        KV[kk * kKS + d] = key < S ? to_f(base.k(key)[d]) : 0.f;
      }
      Tile::sync();
      float a[kQW] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
      for (int d = 0; d < DH; ++d) {
        const float kv = KV[lane * kKS + d];
        const float4 qv = *reinterpret_cast<const float4*>(&Qs[d * kQS + warp * kQW]);
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
      Tile::sync();
      for (int idx = tid; idx < 32 * DH; idx += Tile::kThreads) {
        const int kk = idx / DH, d = idx % DH, key = m * 32 + kk;
        KV[kk * kKS + d] = key < S ? to_f(base.v(key)[d]) : 0.f;
      }
      Tile::sync();
#pragma unroll 4
      for (int jj = 0; jj < 32; ++jj) {
        float p[kQW];
#pragma unroll
        for (int qq = 0; qq < kQW; ++qq) p[qq] = __shfl_sync(0xffffffffu, sc[qq][m], jj);
#pragma unroll
        for (int e = 0; e < DPL; ++e) {
          const int d = lane + 32 * e;
          const float vv = d < DH ? KV[jj * kKS + d] : 0.f;
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

// The bf16 tile: warp w owns query rows 16 w..16 w + 15 of the tile's, held as mma A
// fragments. Keys stream through shared memory in chunks of tc_chunk(DH), two stages
// by cp.async, so the next chunk lands while this one computes. Sweep 1 (K chunks):
// QK^T, each row's max and sum of exp. Sweep 2 (K and V chunks): QK^T again, p =
// round_bf16(exp(s - max) / sum) as the A fragment of PV (JAX's order: normalise,
// round, then PV; the second QK^T costs S^2 dh more products, no rescale of O).
template <int DH, typename Tile = Tile256, typename Rows>
__device__ __forceinline__ void spatial_attn_tile_tc(const Rows& src, bf16* out, int S,
                                                     int inner, int n_valid, float scale,
                                                     int q_tile, int h, int f, bf16* smem) {
  constexpr int KC = tc_chunk(DH), LD = DH + 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const Rows base = src.at(static_cast<size_t>(f) * S, h * DH);
  const int nch = (S + KC - 1) / KC;
  using Stage = TcKvStage<DH, Rows, Tile::kThreads>;
  const Stage stage{base, smem, nch, S};
  stage(0);
  const int r0 = q_tile * spatial_q_tile<bf16, Tile>() + 16 * warp + g;
  unsigned qf[DH / 16][4];
  tc_rows_frag<DH>(qf, r0 < S ? base.q(r0) : nullptr, r0 + 8 < S ? base.q(r0 + 8) : nullptr, t);
  float mx[2], sm[2];  // rows r0, r0 + 8
  tc_softmax_stats<DH, Stage, Tile>(stage, qf, nch, S, n_valid, scale, mx, sm);

  float o[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  for (int c = 0; c < nch; ++c) {
    if (c + 1 < nch) {
      stage(nch + c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    Tile::sync();
    const bf16* kt = stage.at(nch + c);
    const bf16* vt = kt + KC * LD;
#pragma unroll
    for (int p = 0; p < KC / 16; ++p) {
      float s[2][4] = {};
      tc_mma_abt<DH>(s, qf, kt, 16 * p, lane);
      tc_mask(s, c * KC + 16 * p, t, S, n_valid, scale);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = __fdiv_rn(expf(s[j][e] - mx[e >> 1]), sm[e >> 1]);
      unsigned pa[4];
      tc_c_to_a(pa, s);
      tc_mma_ab<DH>(o, pa, vt, 16 * p, lane);
    }
    Tile::sync();
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + 8 * half;
    if (row >= S) continue;
    bf16* orow = out + (static_cast<size_t>(f) * S + row) * inner + h * DH;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      *reinterpret_cast<unsigned*>(orow + 8 * n + 2 * t) =
          pack_bf16(o[n][2 * half], o[n][2 * half + 1]);
  }
}

// The tile on q / k / v rows `src` (any Rows above); out has rows of `inner` elements.
template <typename T, int DH, typename Tile = Tile256, typename Rows>
__device__ __forceinline__ void spatial_attn_tile_rows(const Rows& src, T* out, int S, int inner,
                                                       int n_valid, float scale, int q_tile,
                                                       int h, int f, float* smem) {
  if constexpr (std::is_same<T, float>::value) {
    spatial_attn_tile_fma<DH, Tile>(src, out, S, inner, n_valid, scale, q_tile, h, f, smem);
  } else {
    spatial_attn_tile_tc<DH, Tile>(src, out, S, inner, n_valid, scale, q_tile, h, f,
                                   reinterpret_cast<bf16*>(smem));
  }
}

// The packed form, as #1, #2, #9 and #10 call it: qkv (G, S, 3 inner).
template <typename T, int DH, typename Tile = Tile256>
__device__ __forceinline__ void spatial_attn_tile(const T* qkv, T* out, int S, int inner,
                                                  int n_valid, float scale, int q_tile, int h,
                                                  int f, float* smem) {
  spatial_attn_tile_rows<T, DH, Tile>(PackedRows<const T*>{qkv, inner}, out, S, inner, n_valid,
                                      scale, q_tile, h, f, smem);
}

}  // namespace istvt
