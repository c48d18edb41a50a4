// The backward of the float fused path's two attention cores (kernels/attention.py
// temporal_attention_packed_bwd, spatial_attention_packed_bwd), on the packed
// [q | k | v] activations the forward read, writing the packed [dq | dk | dv].
//
// Replaces two TPU kernels:
//   * istvt_tpu/kernels/attention.py fused_temporal_attention_packed_bwd
//     (_temporal_packed_bwd_kernel): the softmax over the T+1 = 7 frames per (clip,
//     location, head) after the self-subtract cat(x[:2], x[2:] - x[1:-1]) on q and k,
//     taken backward, then the transposed self-subtract
//     d[t] = ds[t] - ds[t + 1] (1 <= t < T) mapping the subtracted grads back to the
//     projections. The casts are JAX's: the subtracted q, k are rounded to the
//     activation dtype; dq is summed in f32 and rounded once; dk and dv are summed
//     over the query frames in the activation dtype, each term rounded first, as the
//     TPU kernel adds into its bf16 refs (so in bf16 the two agree term for term).
//   * istvt_tpu/kernels/attention.py fused_frame_attention_bwd (_attn_bwd_kernel):
//     per (frame, head), P = softmax(Q K^T s + mask) with keys >= n_valid masked,
//     dV = round(P)^T dO, dP = dO V^T, dS = round((P o (dP - rowsum(P o dP))) s),
//     dQ = dS K, dK = dS^T Q, f32 sums. rowsum(P o dP) is summed directly, as JAX
//     does, not taken as dO . O (O was rounded to the activation dtype). The same
//     kernels serve that function's own separate-tensor signature (the kernel API's
//     entry, kernels/attention.fused_frame_attention_bwd), reading q, k, v and
//     writing dq, dk, dv through SplitRows (common.cuh) instead of the packed rows.
//
// What bounds them on the H100: the temporal backward is tiny arithmetic (7x7 per
// location and head) and bound by reading qkv and dO once and writing dqkv once
// (295 MB at B=16 bf16, 0.088 ms at 3.35 TB/s). The spatial backward is 5 S^2 dh
// products per (frame, head), about 0.08 TFLOP per B=16 layer (9.5 GFLOP at the
// 2-clip slice: 0.0097 ms at 989 TFLOP/s of bf16, against 0.0110 ms for its bytes,
// so bytes bound it; in f32 three TF32 products of each, 0.059 ms at 495 TFLOP/s,
// bound by them). The TPU kernel held the whole S x S f32 score tile of a frame
// in VMEM (542 KB), which does not fit the 227 KB of shared memory of a block.
//
// What the design does about it: the temporal backward takes whole (clip, location)
// groups, L lanes a head, as the forward core does, each lane one vector of 4 elements
// (16 bytes of f32, 8 of bf16); each lane stages its q, k, v and dO rows by cp.async
// into its own slots of shared memory (all in flight at once), keeps only the dk / dv
// accumulators in registers, finishes each score on one lane by a transposed reduction
// and computes p and ds there once (temporal.cuh, temporal_attn_bwd_lane); past T1 = 8
// the general lane keeps the dk / dv sums in two more slot rows in place of q and dO
// (temporal_attn_bwd_lane_any, temporal_attn_bwd_any_kernel below). The
// spatial backward is two flash-style passes that recompute the probabilities, so
// nothing S x S is stored and no two blocks write the same output (no atomics): (a)
// per query tile, the exact softmax, rowsum(P o dP), dS and dQ, and per query row the
// softmax max, sum and rowsum; (b) per key tile, streaming query chunks: P from the
// stored max / sum (the scores summed in the same order as in (a), so P and dS are
// (a)'s), then dK and dV. Both dtypes run on the tensor cores with 128 rows a block (8
// warps x 16), the other side streaming through shared memory in chunks; pass (b)
// sweeps the queries once (K Q^T and V dO^T, then dV += round(P)^T dO and dK += dS^T
// Q). The exp per score, and in bf16 the IEEE division, kept so that P rounds as the
// reference's does, cost beyond the products. By activation dtype:
//   * bf16 (attention_tc.cuh): the rows held as mma A fragments, 64-row chunks, two
//     stages by cp.async; every product mma.sync m16n8k16 with f32 accumulators, P and
//     dS going from the accumulators into the next product as A fragments. Pass (a)
//     sweeps the keys three times (max and sum; rowsum(P o dP) from QK^T and dO V^T;
//     dS and dQ += dS K): 10 S^2 dh products in all against the 5 the math needs.
//   * f32 (attention_tf32.cuh): every product as three TF32 products on mma.sync
//     m16n8k8, so the f32 check (1e-5 max|plain|) holds; the rows' raw A fragments in
//     each lane's shared-memory slots, 32-row chunks split once into hi / lo planes, a
//     fresh sum each 32-deep k-step, P and dS into the next product from the
//     accumulators as in bf16. Pass (a) sweeps the keys twice: max, sum and
//     rowsum(P o dP) in one online sweep (P is not rounded in f32), then dS and dQ: 9
//     S^2 dh products (27 TF32 ones).
// dim_head <= 64 in both (pass (b)'s registers: dK and dV of 16 rows a warp, with the
// bf16 pass's K and V fragments).
#include "attention_tf32.cuh"
#include "temporal.cuh"

namespace istvt {

// (i) Temporal backward: thread g of B S H L, as the forward (temporal.cuh); each
// lane's q, k, v and dO rows staged in its own slots of dynamic shared memory (4 T1
// slots of one vector a thread). No __launch_bounds__: with one, ptxas held the f32
// L = 4 instantiation to 128 registers and spilled 12 bytes; without, every
// instantiation takes the registers it needs and none spills.
template <typename T, int V, int L, int C>
__global__ void temporal_attn_bwd_kernel(
    const T* __restrict__ qkv, const T* __restrict__ dout, T* __restrict__ dqkv, int T1, int S,
    int H, int inner, int dh, float scale, long total) {
  constexpr int W = TRow<T, V, L, C>::W;
  extern __shared__ uint4 tslots[];
  const long g = static_cast<long>(blockIdx.x) * kTemporalBwdThreads + threadIdx.x;
  temporal_attn_bwd_lane<T, V, L, C>(qkv, dout, dqkv, T1, S, H, inner, dh, scale, g, g < total,
                                     reinterpret_cast<uint32_t*>(tslots) + threadIdx.x * W,
                                     kTemporalBwdThreads * W);
}

// (i) at T1 > kTMax: thread g as above, in blocks of blockDim.x threads (as many warps as
// their 4 T1 slots fit the block's shared memory) whose slots are in dynamic shared
// memory, or in `scratch` where given (temporal.cuh, temporal_attn_bwd_lane_any).
template <typename T, int V, int L, int C>
__global__ void temporal_attn_bwd_any_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                                             T* __restrict__ dqkv, int T1, int S, int H,
                                             int inner, int dh, float scale, long total,
                                             uint32_t* __restrict__ scratch) {
  extern __shared__ uint4 any_slots[];
  const long g = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const TSlots sl = temporal_slots(reinterpret_cast<uint32_t*>(any_slots), scratch,
                                   TRow<T, V, L, C>::W);
  temporal_attn_bwd_lane_any<T, V, L, C>(qkv, dout, dqkv, T1, S, H, inner, dh, scale, g,
                                         g < total, sl);
}

// (ii) Spatial backward: two passes, 128 query (a) or key (b) rows a block of 256
// threads, 16 a warp.

// The f32 passes, on the tensor cores as three TF32 products (attention_tf32.cuh): the
// rows a warp owns held as raw A fragments in its lanes' shared-memory slots, the other
// side streaming in 32-row chunks split once into hi / lo planes, a fresh sum each
// 32-deep k-step. Shared memory (dynamic): the two held matrices of the block's 8 warps
// and the stage.
// Pass (a) stages K (T and A planes: QK^T, dS K) and V (T: dO V^T); pass (b) Q and dO
// (T and A planes each: K Q^T, dS^T Q; V dO^T, P^T dO) and the stats.
__host__ __device__ constexpr int tf32_bwd_smem_bytes(int dh, bool dkv) {
  return 4 * (tf32_held_floats(dh, 8, 2) +
              (dkv ? tf32_stage_floats(dh, 2, 2, 2, 3) : tf32_stage_floats(dh, 2, 2, 1, 0)));
}

// (a), f32: sweep 1 (K, V chunks), online: QK^T and dP = dO V^T, each row's max, sum
// of e = exp(s - max) and sum of e dP, rescaled where the max grows (tf32_online), so
// rowsum(P o dP) = (sum of e dP) / sum, still P o dP summed directly; sweep 2 (K, V
// chunks): P = e / sum (times the reciprocal), dS = (P o (dP - rowsum)) s, dQ += dS K.
// Writes dQ and stats (max, 1 / sum, rowsum). kPacked: q is the packed qkv (G, S, 3
// inner) and dq the packed dqkv; else q, k, v, dq, dk, dv are (G, S, inner) tensors of
// their own.
template <int DH, bool kPacked>
__device__ __forceinline__ void spatial_bwd_dq_tf32(const float* q, const float* k,
                                                    const float* v, const float* dout,
                                                    float* dq, float* stats, int S, int H,
                                                    int inner, int n_valid, float scale,
                                                    float* smem) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, f = blockIdx.z;
  const auto base = rows<kPacked>(q, k, v, inner).at(static_cast<size_t>(f) * S, h * DH);
  const float* gbase = dout + static_cast<size_t>(f) * S * inner + h * DH;
  const int nch = (S + kTfC - 1) / kTfC;
  using Stage = Tf32Stage<DH, Tile256, 2, 3u, 1u>;  // K (T and A planes), V (T)
  static_assert(Stage::kFloats == tf32_stage_floats(DH, 2, 2, 1, 0), "the smem plan");
  const Stage st{smem + tf32_held_floats(DH, 8, 2)};
  // chunk i: K and V rows of key chunk i % nch
  const auto next = [&](int i) {
    st.issue([&](int s, int r) { return s ? base.v(r) : base.k(r); }, nullptr,
             (i % nch) * kTfC, S, 3u);
  };
  next(0);
  float* qs = tf32_slots<DH>(smem, 8, 0, warp, lane);
  float* gs = tf32_slots<DH>(smem, 8, 1, warp, lane);
  const int r0 = blockIdx.x * kTcQT + 16 * warp + g;
  const bool in0 = r0 < S, in1 = r0 + 8 < S;
  tf32_hold<DH>(qs, in0 ? base.q(r0) : nullptr, in1 ? base.q(r0 + 8) : nullptr, t);
  tf32_hold<DH>(gs, in0 ? gbase + static_cast<size_t>(r0) * inner : nullptr,
                in1 ? gbase + static_cast<size_t>(r0 + 8) * inner : nullptr, t);

  // the scores (masked) and dP of key chunk c, its planes landed
  const auto s_dp = [&](int c, float (&sc)[4][4], float (&dp)[4][4]) {
    tf32_scores<DH>(sc, qs, st.bt(0), lane);
    tc_mask(sc, c * kTfC, t, S, n_valid, scale);
    tf32_scores<DH>(dp, gs, st.bt(1), lane);
  };
  float mx[2] = {-INFINITY, -INFINITY}, sm[2] = {0.f, 0.f}, pdp[2] = {0.f, 0.f};
  for (int c = 0; c < nch; ++c) {
    tf32_land<Tile256>(st, 3u, c, 2 * nch, next);
    float sc[4][4], dp[4][4], corr[2];
    s_dp(c, sc, dp);
    tf32_online(sc, mx, sm, corr);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float acc = __fmul_rn(pdp[r], corr[r]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) acc = __fadd_rn(acc, __fmul_rn(sc[j][e], dp[j][e]));
      pdp[r] = acc;
    }
  }
  float rinv[2];
  tf32_row_sums(sm, rinv);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    pdp[r] = __fadd_rn(pdp[r], __shfl_xor_sync(0xffffffffu, pdp[r], 1));
    pdp[r] = __fadd_rn(pdp[r], __shfl_xor_sync(0xffffffffu, pdp[r], 2));
    pdp[r] = __fmul_rn(pdp[r], rinv[r]);
  }
  // sweep 2: dS and dQ += dS K
  float o[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  for (int c = 0; c < nch; ++c) {
    tf32_land<Tile256>(st, 3u, nch + c, 2 * nch, next);
    float sc[4][4], dp[4][4];
    s_dp(c, sc, dp);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pr = __fmul_rn(expf(sc[j][e] - mx[e >> 1]), rinv[e >> 1]);
        dp[j][e] = __fmul_rn(__fmul_rn(pr, __fsub_rn(dp[j][e], pdp[e >> 1])), scale);
      }
    tf32_ab<DH>(o, dp, st.ba(0), lane);
  }
  const auto ob = rows<kPacked>(dq, dq, dq, inner).at(static_cast<size_t>(f) * S, h * DH);
  if (t == 0) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + 8 * half;
      if (row >= S) continue;
      float* sr = stats + ((static_cast<size_t>(f) * H + h) * S + row) * 3;
      sr[0] = mx[half];
      sr[1] = rinv[half];
      sr[2] = pdp[half];
    }
  }
  tf32_store<DH>(o, in0 ? ob.q(r0) : nullptr, in1 ? ob.q(r0 + 8) : nullptr, t);
}

// (b), f32: block = (key tile of 128, head, frame), warp w's 16 keys held as A fragments
// of K and V; query chunks stream Q, dO (split) and their stats rows. Per chunk: S^T =
// K Q^T and dP^T = V dO^T (the terms in (a)'s order), P^T from the stored max and 1 /
// sum by (a)'s operations (so P and dS are (a)'s bit for bit), dS^T, then dV += P^T dO
// and dK += dS^T Q, each chunk summed afresh. Writes dK and dV.
template <int DH, bool kPacked>
__device__ __forceinline__ void spatial_bwd_dkv_tf32(const float* q, const float* k,
                                                     const float* v, const float* dout,
                                                     float* dk_out, float* dv_out,
                                                     const float* stats, int S, int H,
                                                     int inner, int n_valid, float scale,
                                                     float* smem) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, f = blockIdx.z;
  const auto base = rows<kPacked>(q, k, v, inner).at(static_cast<size_t>(f) * S, h * DH);
  const float* gbase = dout + static_cast<size_t>(f) * S * inner + h * DH;
  const float* fstats = stats + (static_cast<size_t>(f) * H + h) * S * 3;
  const int nch = (S + kTfC - 1) / kTfC;
  using Stage = Tf32Stage<DH, Tile256, 2, 3u, 3u, 3>;  // Q, dO (T and A planes), stats
  static_assert(Stage::kFloats == tf32_stage_floats(DH, 2, 2, 2, 3), "the smem plan");
  const Stage st{smem + tf32_held_floats(DH, 8, 2)};
  // chunk i: Q and dO rows of query chunk i, and their stats
  const auto next = [&](int i) {
    st.issue([&](int s, int r) { return s ? gbase + static_cast<size_t>(r) * inner : base.q(r); },
             fstats, i * kTfC, S, 3u);
  };
  next(0);
  float* ks = tf32_slots<DH>(smem, 8, 0, warp, lane);
  float* vs = tf32_slots<DH>(smem, 8, 1, warp, lane);
  const int k0 = blockIdx.x * kTcQT + 16 * warp + g;  // keys k0, k0 + 8
  const bool in0 = k0 < S, in1 = k0 + 8 < S;
  tf32_hold<DH>(ks, in0 ? base.k(k0) : nullptr, in1 ? base.k(k0 + 8) : nullptr, t);
  tf32_hold<DH>(vs, in0 ? base.v(k0) : nullptr, in1 ? base.v(k0 + 8) : nullptr, t);
  float dk[DH / 8][4], dv[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int c = 0; c < nch; ++c) {
    tf32_land<Tile256>(st, 3u, c, nch, next);
    float sc[4][4], dp[4][4];
    tf32_scores<DH, 1, true>(sc, ks, st.bt(0), lane);
    tf32_scores<DH, 1, true>(dp, vs, st.bt(1), lane);
    const float* xs = st.extra();
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 8 * j + 2 * t + (e & 1);  // query in the chunk
        const int key = k0 + 8 * (e >> 1);
        float s = __fmul_rn(sc[j][e], scale);
        if (key >= n_valid) s = __fadd_rn(s, -1e30f);
        float pr = 0.f;
        if (c * kTfC + qi < S) pr = __fmul_rn(expf(s - xs[3 * qi]), xs[3 * qi + 1]);
        sc[j][e] = pr;
        dp[j][e] = __fmul_rn(__fmul_rn(pr, __fsub_rn(dp[j][e], xs[3 * qi + 2])), scale);
      }
    tf32_ab<DH>(dv, sc, st.ba(1), lane);
    tf32_ab<DH>(dk, dp, st.ba(0), lane);
  }
  // packed: dk_out is the dqkv (dk, dv at columns inner and 2 inner of its rows)
  const auto ob =
      rows<kPacked>(dk_out, dk_out, dv_out, inner).at(static_cast<size_t>(f) * S, h * DH);
  tf32_store<DH>(dk, in0 ? ob.k(k0) : nullptr, in1 ? ob.k(k0 + 8) : nullptr, t);
  tf32_store<DH>(dv, in0 ? ob.v(k0) : nullptr, in1 ? ob.v(k0 + 8) : nullptr, t);
}

// The bf16 passes, on the tensor cores (attention_tc.cuh): 128 query (a) or key (b)
// rows a block, 16 a warp as mma A fragments, the other side streaming through shared
// memory in chunks of tc_chunk(DH) rows, two stages by cp.async.
//
// The f32 score of (query, key) in both passes: the mma's sum of the same 16-wide
// k-steps of bf16 products, Q K^T in (a) and K Q^T in (b), x scale, -1e30 for masked
// keys; p = exp(s - max) / sum and dS from the same f32 operations, so (b) recomputes
// (a)'s P and dS.

// (a), bf16: sweep 1 (K chunks) each row's max and sum; sweep 2 (K, V chunks)
// rowsum(P o dP) from P and dP = dO V^T; sweep 3 (K, V chunks) dS = round((P o (dP -
// rowsum)) s) as an A fragment, dQ += dS K. Writes dQ and stats (max, sum, rowsum).
template <int DH, bool kPacked>
__device__ __forceinline__ void spatial_bwd_dq_tc(const bf16* q, const bf16* k, const bf16* v,
                                                  const bf16* dout, bf16* dq, float* stats,
                                                  int S, int H, int inner, int n_valid,
                                                  float scale) {
  constexpr int KC = tc_chunk(DH), LD = DH + 8;
  __shared__ __align__(16) bf16 smem[2 * 2 * KC * LD];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, f = blockIdx.z;
  const auto base = rows<kPacked>(q, k, v, inner).at(static_cast<size_t>(f) * S, h * DH);
  const bf16* gbase = dout + static_cast<size_t>(f) * S * inner + h * DH;
  const int nch = (S + KC - 1) / KC;
  const TcKvStage<DH, decltype(base)> stage{base, smem, nch, S};
  stage(0);
  const int r0 = blockIdx.x * kTcQT + 16 * warp + g;
  const bool in0 = r0 < S, in1 = r0 + 8 < S;
  unsigned qf[DH / 16][4], gf[DH / 16][4];
  tc_rows_frag<DH>(qf, in0 ? base.q(r0) : nullptr, in1 ? base.q(r0 + 8) : nullptr, t);
  tc_rows_frag<DH>(gf, in0 ? gbase + static_cast<size_t>(r0) * inner : nullptr,
                   in1 ? gbase + static_cast<size_t>(r0 + 8) * inner : nullptr, t);
  float mx[2], sm[2];
  tc_softmax_stats<DH>(stage, qf, nch, S, n_valid, scale, mx, sm);

  // P (f32) and dP of 16 keys at chunk offset x0 of staged chunk i
  auto p_dp = [&](int i, int c, int x0, float (&pr)[2][4], float (&dp)[2][4]) {
    const bf16* kt = stage.at(i);
    const bf16* vt = kt + KC * LD;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) pr[j][e] = dp[j][e] = 0.f;
    tc_mma_abt<DH>(pr, qf, kt, x0, lane);
    tc_mask(pr, c * KC + x0, t, S, n_valid, scale);
    tc_mma_abt<DH>(dp, gf, vt, x0, lane);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) pr[j][e] = __fdiv_rn(expf(pr[j][e] - mx[e >> 1]), sm[e >> 1]);
  };
  // sweep 2: rowsum(P o dP) per row, each thread over its columns, then the quad
  float pdp[2] = {0.f, 0.f};
  for (int c = 0; c < nch; ++c) {
    stage(nch + c + 1);  // the last one is sweep 3's first chunk
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int p = 0; p < KC / 16; ++p) {
      float pr[2][4], dp[2][4];
      p_dp(nch + c, c, 16 * p, pr, dp);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pdp[e >> 1] = __fadd_rn(pdp[e >> 1], __fmul_rn(pr[j][e], dp[j][e]));
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    pdp[r] = __fadd_rn(pdp[r], __shfl_xor_sync(0xffffffffu, pdp[r], 1));
    pdp[r] = __fadd_rn(pdp[r], __shfl_xor_sync(0xffffffffu, pdp[r], 2));
  }
  // sweep 3: dS and dQ += dS K
  float o[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  for (int c = 0; c < nch; ++c) {
    if (c + 1 < nch) {
      stage(2 * nch + c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < KC / 16; ++p) {
      float pr[2][4], dp[2][4];
      p_dp(2 * nch + c, c, 16 * p, pr, dp);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[j][e] = __fmul_rn(__fmul_rn(pr[j][e], __fsub_rn(dp[j][e], pdp[e >> 1])), scale);
      unsigned da[4];
      tc_c_to_a(da, dp);
      tc_mma_ab<DH>(o, da, stage.at(2 * nch + c), 16 * p, lane);
    }
    __syncthreads();
  }
  const auto ob = rows<kPacked>(dq, dq, dq, inner).at(static_cast<size_t>(f) * S, h * DH);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + 8 * half;
    if (row >= S) continue;
    if (t == 0) {
      float* st = stats + ((static_cast<size_t>(f) * H + h) * S + row) * 3;
      st[0] = mx[half];
      st[1] = sm[half];
      st[2] = pdp[half];
    }
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      *reinterpret_cast<unsigned*>(ob.q(row) + 8 * n + 2 * t) =
          pack_bf16(o[n][2 * half], o[n][2 * half + 1]);
  }
}

// (b), bf16: block = (key tile of 128, head, frame), warp w's 16 keys as A fragments
// of K and V; query chunks stream Q, dO and their stats rows through shared memory.
// Per 16 queries: S^T = K Q^T and dP^T = V dO^T, P^T from the stored max and sum,
// dS^T, then dV += round(P)^T dO and dK += dS^T Q. Writes dK and dV.
template <int DH>
__host__ __device__ constexpr int tc_qg_stage_bytes() {
  return 2 * tc_chunk(DH) * (DH + 8) * 2 + 3 * tc_chunk(DH) * 4;
}

template <int DH, typename Rows>
struct TcBwdQgStage {
  const Rows& base;
  const bf16* gbase;
  const float* fstats;
  unsigned char* smem;
  int S, inner;
  // staged chunk i: rows i QC.. of Q ([QC][DH + 8]), dO (after it) and stats (QC x 3 f32)
  __device__ __forceinline__ void operator()(int i) const {
    constexpr int QC = tc_chunk(DH), LD = DH + 8, SEG = DH / 8;
    bf16* buf = reinterpret_cast<bf16*>(smem + (i & 1) * tc_qg_stage_bytes<DH>());
    const int r0 = i * QC;
    for (int idx = threadIdx.x; idx < QC * SEG; idx += 256) {
      const int qq = idx / SEG, c = (idx % SEG) * 8, r = r0 + qq;
      const bool in = r < S;
      const int rr = in ? r : 0;
      cp_async16(buf + qq * LD + c, base.q(rr) + c, in);
      cp_async16(buf + (QC + qq) * LD + c, gbase + static_cast<size_t>(rr) * inner + c, in);
    }
    float* st = reinterpret_cast<float*>(buf + 2 * QC * LD);
    for (int idx = threadIdx.x; idx < 3 * QC; idx += 256) {
      const bool in = r0 + idx / 3 < S;
      cp_async4(st + idx, fstats + (in ? 3 * r0 + idx : 0), in);
    }
    cp_async_commit();
  }
  __device__ __forceinline__ const bf16* at(int i) const {
    return reinterpret_cast<const bf16*>(smem + (i & 1) * tc_qg_stage_bytes<DH>());
  }
};

template <int DH, bool kPacked>
__device__ __forceinline__ void spatial_bwd_dkv_tc(const bf16* q, const bf16* k, const bf16* v,
                                                   const bf16* dout, bf16* dk_out, bf16* dv_out,
                                                   const float* stats, int S, int H, int inner,
                                                   int n_valid, float scale) {
  constexpr int QC = tc_chunk(DH), LD = DH + 8;
  __shared__ __align__(16) unsigned char smem[2 * tc_qg_stage_bytes<DH>()];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, f = blockIdx.z;
  const auto base = rows<kPacked>(q, k, v, inner).at(static_cast<size_t>(f) * S, h * DH);
  const bf16* gbase = dout + static_cast<size_t>(f) * S * inner + h * DH;
  const float* fstats = stats + (static_cast<size_t>(f) * H + h) * S * 3;
  const int nch = (S + QC - 1) / QC;
  const TcBwdQgStage<DH, decltype(base)> stage{base, gbase, fstats, smem, S, inner};
  stage(0);
  const int k0 = blockIdx.x * kTcQT + 16 * warp + g;  // keys k0, k0 + 8
  const bool in0 = k0 < S, in1 = k0 + 8 < S;
  unsigned kf[DH / 16][4], vf[DH / 16][4];
  tc_rows_frag<DH>(kf, in0 ? base.k(k0) : nullptr, in1 ? base.k(k0 + 8) : nullptr, t);
  tc_rows_frag<DH>(vf, in0 ? base.v(k0) : nullptr, in1 ? base.v(k0 + 8) : nullptr, t);
  float dk[DH / 8][4], dv[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int c = 0; c < nch; ++c) {
    if (c + 1 < nch) {
      stage(c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* qt = stage.at(c);
    const bf16* gt = qt + QC * LD;
    const float* st = reinterpret_cast<const float*>(qt + 2 * QC * LD);
#pragma unroll
    for (int p = 0; p < QC / 16; ++p) {
      float sc[2][4] = {}, dp[2][4] = {};
      tc_mma_abt<DH>(sc, kf, qt, 16 * p, lane);
      tc_mma_abt<DH>(dp, vf, gt, 16 * p, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 16 * p + 8 * j + 2 * t + (e & 1);  // query in the chunk
          const int key = k0 + 8 * (e >> 1);
          float s = __fmul_rn(sc[j][e], scale);
          if (key >= n_valid) s = __fadd_rn(s, -1e30f);
          float pr = 0.f;
          if (c * QC + qi < S) pr = __fdiv_rn(expf(s - st[3 * qi]), st[3 * qi + 1]);
          sc[j][e] = pr;
          dp[j][e] = __fmul_rn(__fmul_rn(pr, __fsub_rn(dp[j][e], st[3 * qi + 2])), scale);
        }
      unsigned pa[4], da[4];
      tc_c_to_a(pa, sc);
      tc_c_to_a(da, dp);
      tc_mma_ab<DH>(dv, pa, gt, 16 * p, lane);
      tc_mma_ab<DH>(dk, da, qt, 16 * p, lane);
    }
    __syncthreads();
  }
  // packed: dk_out is the dqkv (dk, dv at columns inner and 2 inner of its rows)
  const auto ob =
      rows<kPacked>(dk_out, dk_out, dv_out, inner).at(static_cast<size_t>(f) * S, h * DH);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = k0 + 8 * half;
    if (key >= S) continue;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      *reinterpret_cast<unsigned*>(ob.k(key) + 8 * n + 2 * t) =
          pack_bf16(dk[n][2 * half], dk[n][2 * half + 1]);
      *reinterpret_cast<unsigned*>(ob.v(key) + 8 * n + 2 * t) =
          pack_bf16(dv[n][2 * half], dv[n][2 * half + 1]);
    }
  }
}

// The two passes by activation dtype, both on the tensor cores: f32 as three TF32
// products (its shared memory dynamic, above the 48 KB a static array may take), bf16
// on bf16 products. Launch bounds: for f32 one block an SM stated (its shared memory
// allows no more), so that ptxas takes the registers the passes need (without it, it
// aimed for two or three blocks and spilled); for bf16 none (0), as before.
template <typename T>
constexpr int kSpatialBwdMinBlocks = std::is_same<T, float>::value ? 1 : 0;

template <typename T, int DH, bool kPacked>
__global__ void __launch_bounds__(256, kSpatialBwdMinBlocks<T>) spatial_attn_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, T* __restrict__ dq, float* __restrict__ stats, int S, int H,
    int inner, int n_valid, float scale) {
  if constexpr (std::is_same<T, float>::value) {
    extern __shared__ float4 tf32_smem[];
    spatial_bwd_dq_tf32<DH, kPacked>(q, k, v, dout, dq, stats, S, H, inner, n_valid, scale,
                                     reinterpret_cast<float*>(tf32_smem));
  } else {
    spatial_bwd_dq_tc<DH, kPacked>(q, k, v, dout, dq, stats, S, H, inner, n_valid, scale);
  }
}

template <typename T, int DH, bool kPacked>
__global__ void __launch_bounds__(256, kSpatialBwdMinBlocks<T>) spatial_attn_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, T* __restrict__ dk_out, T* __restrict__ dv_out,
    const float* __restrict__ stats, int S, int H, int inner, int n_valid, float scale) {
  if constexpr (std::is_same<T, float>::value) {
    extern __shared__ float4 tf32_smem[];
    spatial_bwd_dkv_tf32<DH, kPacked>(q, k, v, dout, dk_out, dv_out, stats, S, H, inner,
                                      n_valid, scale, reinterpret_cast<float*>(tf32_smem));
  } else {
    spatial_bwd_dkv_tc<DH, kPacked>(q, k, v, dout, dk_out, dv_out, stats, S, H, inner, n_valid,
                                    scale);
  }
}

template <typename T>
int launch_temporal_bwd(const void* qkv, const void* dout, void* dqkv, int B, int T1, int S,
                        int H, int inner, float scale, int vec, int lanes, int chunks,
                        void* scratch, cudaStream_t st) {
  const long total = static_cast<long>(B) * S * H * lanes;
  const int blocks = static_cast<int>((total + kTemporalBwdThreads - 1) / kTemporalBwdThreads);
  auto in = static_cast<const T*>(qkv);
  auto g = static_cast<const T*>(dout);
  auto o = static_cast<T*>(dqkv);
  if (T1 > kTMax) {
    int err = 0;
    const int rc = with_temporal_plan<kTemporalBwdVec>(vec, lanes, chunks, [&](auto plan) {
      using P = decltype(plan);
      err = launch_temporal_any<kTemporalBwdThreads>(
          temporal_attn_bwd_any_kernel<T, P::V, P::L, P::C>, total, T1, 4,
          TRow<T, P::V, P::L, P::C>::W, scratch, st, in, g, o, T1, S, H, inner, inner / H, scale,
          total);
    });
    return rc != 0 ? rc : err;
  }
  cudaError_t err = cudaSuccess;
  const int rc = with_temporal_plan<kTemporalBwdVec>(vec, lanes, chunks, [&](auto plan) {
    using P = decltype(plan);
    auto kern = temporal_attn_bwd_kernel<T, P::V, P::L, P::C>;
    // 4 T1 slots of one vector (W words) a thread
    constexpr int slot_bytes = 4 * TRow<T, P::V, P::L, P::C>::W;
    static const cudaError_t attr =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             4 * kTMax * kTemporalBwdThreads * slot_bytes);
    err = attr;
    if (attr == cudaSuccess)
      kern<<<blocks, kTemporalBwdThreads, 4 * T1 * kTemporalBwdThreads * slot_bytes, st>>>(
          in, g, o, T1, S, H, inner, inner / H, scale, total);
  });
  return rc != 0 ? rc : static_cast<int>(err);
}

// Packed: q = qkv, dq = dqkv (k, v, dk, dv unused). Unpacked: six tensors of their own.
template <typename T, int DH, bool kPacked>
int launch_spatial_bwd_dh(const T* q, const T* k, const T* v, const T* g, T* dq, T* dk, T* dv,
                          float* stats, int G, int S, int H, int inner, int n_valid, float scale,
                          cudaStream_t st) {
  constexpr bool f32 = std::is_same<T, float>::value;
  constexpr int dq_bytes = f32 ? tf32_bwd_smem_bytes(DH, false) : 0;
  constexpr int dkv_bytes = f32 ? tf32_bwd_smem_bytes(DH, true) : 0;
  auto dq_kern = spatial_attn_bwd_dq_kernel<T, DH, kPacked>;
  auto dkv_kern = spatial_attn_bwd_dkv_kernel<T, DH, kPacked>;
  static const cudaError_t attr = [&] {
    if (!f32) return cudaSuccess;
    cudaError_t e =
        cudaFuncSetAttribute(dq_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(dkv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, dkv_bytes);
    return e;
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((S + kTcQT - 1) / kTcQT, H, G);
  dq_kern<<<grid, 256, dq_bytes, st>>>(q, k, v, g, dq, stats, S, H, inner, n_valid, scale);
  dkv_kern<<<grid, 256, dkv_bytes, st>>>(q, k, v, g, kPacked ? dq : dk, dv, stats, S, H, inner,
                                         n_valid, scale);
  return 0;
}

template <typename T, bool kPacked>
int launch_spatial_bwd(const void* q, const void* k, const void* v, const void* dout, void* dq,
                       void* dk, void* dv, void* stats, int G, int S, int H, int inner,
                       int n_valid, float scale, cudaStream_t st) {
  auto qp = static_cast<const T*>(q);
  auto kp = static_cast<const T*>(k);
  auto vp = static_cast<const T*>(v);
  auto g = static_cast<const T*>(dout);
  auto dqp = static_cast<T*>(dq);
  auto dkp = static_cast<T*>(dk);
  auto dvp = static_cast<T*>(dv);
  auto sts = static_cast<float*>(stats);
  switch (inner / H) {
    case 16:
      return launch_spatial_bwd_dh<T, 16, kPacked>(qp, kp, vp, g, dqp, dkp, dvp, sts, G, S, H,
                                                   inner, n_valid, scale, st);
    case 32:
      return launch_spatial_bwd_dh<T, 32, kPacked>(qp, kp, vp, g, dqp, dkp, dvp, sts, G, S, H,
                                                   inner, n_valid, scale, st);
    case 64:
      return launch_spatial_bwd_dh<T, 64, kPacked>(qp, kp, vp, g, dqp, dkp, dvp, sts, G, S, H,
                                                   inner, n_valid, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace istvt

using namespace istvt;

extern "C" {

// qkv (B, T1, S, 3 inner), dout (B, T1, S, inner) -> dqkv (B, T1, S, 3 inner); dt 0 f32,
// 1 bf16; T1 >= 2, inner / H <= 128; (vec, lanes, chunks) and scratch as
// istvt_temporal_attn's (istvt_temporal_scratch with backward 1).
int istvt_temporal_attn_bwd(const void* qkv, const void* dout, void* dqkv, int dt, int B,
                            int T1, int S, int H, int inner, float scale, int vec, int lanes,
                            int chunks, void* scratch, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  int rc = dt == kBF16 ? launch_temporal_bwd<__nv_bfloat16>(qkv, dout, dqkv, B, T1, S, H, inner,
                                                            scale, vec, lanes, chunks, scratch,
                                                            st)
                       : launch_temporal_bwd<float>(qkv, dout, dqkv, B, T1, S, H, inner, scale,
                                                    vec, lanes, chunks, scratch, st);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// qkv (G, S, 3 inner), dout (G, S, inner) -> dqkv (G, S, 3 inner); keys >= n_valid
// masked; stats f32 (G, H, S, 3) scratch; any S, inner / H in {16, 32, 64}.
int istvt_spatial_attn_bwd(const void* qkv, const void* dout, void* dqkv, void* stats, int dt,
                           int G, int S, int H, int inner, int n_valid, float scale,
                           void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  int rc = dt == kBF16
               ? launch_spatial_bwd<__nv_bfloat16, true>(qkv, nullptr, nullptr, dout, dqkv,
                                                         nullptr, nullptr, stats, G, S, H, inner,
                                                         n_valid, scale, st)
               : launch_spatial_bwd<float, true>(qkv, nullptr, nullptr, dout, dqkv, nullptr,
                                                 nullptr, stats, G, S, H, inner, n_valid, scale,
                                                 st);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// q, k, v, dout (G, S, inner) -> dq, dk, dv (G, S, inner); keys >= n_valid masked;
// stats f32 (G, H, S, 3) scratch; any S, inner / H in {16, 32, 64}.
int istvt_frame_attn_bwd(const void* q, const void* k, const void* v, const void* dout, void* dq,
                         void* dk, void* dv, void* stats, int dt, int G, int S, int H, int inner,
                         int n_valid, float scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  int rc = dt == kBF16 ? launch_spatial_bwd<__nv_bfloat16, false>(q, k, v, dout, dq, dk, dv,
                                                                  stats, G, S, H, inner, n_valid,
                                                                  scale, st)
                       : launch_spatial_bwd<float, false>(q, k, v, dout, dq, dk, dv, stats, G, S,
                                                          H, inner, n_valid, scale, st);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
