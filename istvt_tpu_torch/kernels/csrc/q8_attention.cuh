// The two attention cores as device functions: q8_attention.cu launches each as a
// kernel of its own, q8_layer.cu walks them inside one persistent kernel per ST
// layer (the temporal core, temporal_attn_lane, is in temporal.cuh). As in
// q8_rows_gemm.cuh, no pointer parameter is __restrict__ (the persistent kernel reads
// here what it wrote earlier in the same launch).
#pragma once

#include <type_traits>

#include "attention_tf32.cuh"
#include "temporal.cuh"

namespace istvt {

// (v) Spatial attention of one (query tile, head, frame) by the block's threads (Tile,
// a TileThreads: 256 in the standalone kernels, 384 in #9), 16 query rows a warp: for
// each query row, f32 scores q.k, x scale, -1e30 added for keys >= n_valid, the exact
// softmax in f32, p rounded to T, PV summed in f32, the output rounded to T (JAX's
// _mh_attention_vmem). Both tiles run on the tensor cores, the one for the activation
// dtype chosen at compile time:
//   * T = bf16: bf16 products, mma.sync m16n8k16 (spatial_attn_tile_tc,
//     attention_tc.cuh);
//   * T = float: each product as three TF32 products, mma.sync m16n8k8
//     (spatial_attn_tile_tf32, attention_tf32.cuh), so the f32 check holds at 1e-5,
//     which one TF32 product would miss; p (not rounded in f32) is normalised after
//     PV.
// smem: spatial_smem_bytes<T, Tile>(DH) bytes, 16-byte aligned. A block may start its
// next tile on the same memory (the persistent ST layer #9 does): each tile's last
// shared-memory read is followed by a barrier that every warp passes before the next
// tile writes there (or, for a lane's own slots, by the same lane's program order), and
// no copy into shared memory is left in flight.

// The f32 tile's products in groups of fresh sums, the same bits in any grouping: QK^T
// in two key groups (tf32_scores), PV in column groups of two n8 tiles (tf32_ab), so
// that fewer accumulators are live at once: at dim_head 64 the standalone tile fits the
// 128 registers a thread of two blocks an SM has without a spill (whole-chunk groups
// spilled), at the cost of splitting A and P again for each group.
constexpr int kTf32QkGroups = 2;
template <int DH>
constexpr int kTf32PvGroups = DH / 16;

// Queries per tile: the grid's (and #9's tile walk's) unit.
template <typename Tile = Tile256>
__host__ __device__ constexpr int spatial_q_tile() {
  return 16 * Tile::kWarps;
}

template <typename T, typename Tile = Tile256>
__host__ __device__ constexpr int spatial_smem_bytes(int dh) {
  return std::is_same<T, float>::value
             ? 4 * (tf32_held_floats(dh, Tile::kWarps, 1) + tf32_stage_floats(dh, 2, 1, 1, 0))
             : tc_smem_bytes(dh);
}

// The f32 tile: warp w owns query rows 16 w..16 w + 15 of the tile's, held as raw A
// fragments in its lanes' slots. Keys and values stream in 32-row chunks split into
// hi / lo planes (Tf32Stage: K's for QK^T, V's for PV), in one sweep: each chunk's
// scores QK^T, the rows' running max (the same in the four threads of a row's quad),
// e = exp(s - max) (f32, unrounded) as the A fragment of PV, the output and the sums of
// e rescaled by exp(old max - new max) where the max grows, each chunk's PV summed
// afresh and folded in by an IEEE add; at the end the output times 1 / sum. p is not
// rounded in f32, so normalising after PV rather than before (JAX's order, which the
// bf16 tile keeps for its rounding of p) changes the result by f32 rounding alone, and
// saves the second QK^T.
template <int DH, typename Tile = Tile256, typename Rows>
__device__ __forceinline__ void spatial_attn_tile_tf32(const Rows& src, float* out, int S,
                                                       int inner, int n_valid, float scale,
                                                       int q_tile, int h, int f, float* smem) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const Rows base = src.at(static_cast<size_t>(f) * S, h * DH);
  const int nch = (S + kTfC - 1) / kTfC;
  using Stage = Tf32Stage<DH, Tile, 2, 1u, 2u>;  // K (T plane), V (A plane)
  static_assert(Stage::kFloats == tf32_stage_floats(DH, 2, 1, 1, 0), "the smem plan");
  const Stage st{smem + tf32_held_floats(DH, Tile::kWarps, 1)};
  const auto next = [&](int i) {
    st.issue([&](int s, int r) { return s ? base.v(r) : base.k(r); }, nullptr, i * kTfC, S, 3u);
  };
  next(0);
  float* qs = tf32_slots<DH>(smem, Tile::kWarps, 0, warp, lane);
  const int r0 = q_tile * spatial_q_tile<Tile>() + 16 * warp + g;
  tf32_hold<DH>(qs, r0 < S ? base.q(r0) : nullptr, r0 + 8 < S ? base.q(r0 + 8) : nullptr, t);

  float mx[2] = {-INFINITY, -INFINITY}, sm[2] = {0.f, 0.f};  // rows r0, r0 + 8
  float o[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  for (int c = 0; c < nch; ++c) {
    tf32_land<Tile>(st, 3u, c, nch, next);
    float s[4][4];
    tf32_scores<DH, kTf32QkGroups>(s, qs, st.bt(0), lane);
    tc_mask(s, c * kTfC, t, S, n_valid, scale);
    float corr[2];
    tf32_online(s, mx, sm, corr);
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = __fmul_rn(o[n][e], corr[e >> 1]);
    tf32_ab<DH, kTf32PvGroups<DH>>(o, s, st.ba(1), lane);
  }
  float rinv[2];
  tf32_row_sums(sm, rinv);
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = __fmul_rn(o[n][e], rinv[e >> 1]);
  float* orow = out + static_cast<size_t>(f) * S * inner + h * DH;
  tf32_store<DH>(o, r0 < S ? orow + static_cast<size_t>(r0) * inner : nullptr,
                 r0 + 8 < S ? orow + static_cast<size_t>(r0 + 8) * inner : nullptr, t);
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
  const int r0 = q_tile * spatial_q_tile<Tile>() + 16 * warp + g;
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
    spatial_attn_tile_tf32<DH, Tile>(src, out, S, inner, n_valid, scale, q_tile, h, f, smem);
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
