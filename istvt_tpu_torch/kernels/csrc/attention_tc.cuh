// The bf16 tensor-core pieces of the spatial attention cores, forward (q8_attention.cuh)
// and backward (attention_bwd.cu): one (frame, head), a tile of 128 query (or key)
// rows, 16 a warp held as mma A fragments, the other side streaming through shared
// memory in chunks of tc_chunk(dh) rows, two stages by cp.async. Every product is
// mma.sync m16n8k16 on bf16 operands with f32 accumulators (mma.cuh). Scores are
// f32 sums of bf16 q.k products, x scale, -1e30 added for keys >= n_valid, -inf for
// keys >= S; the exact softmax's max and sum come from a sweep of their own, so the
// probabilities are normalised before anything rounds them (JAX's order).
#pragma once

#include <type_traits>

#include "mma.cuh"

namespace istvt {

using bf16 = __nv_bfloat16;

constexpr int kTcWarps = 8, kTcQT = 16 * kTcWarps;  // 128 rows a tile, 16 a warp

// The block that runs a spatial tile: its kThreads threads (kWarps warps, each with
// 16 query rows), meeting at __syncthreads. 256 in
// the standalone kernels (TileThreads<256>, every template's default); 384 in the
// persistent ST layer #9, whose block is the int8 GEMM's.
template <int N>
struct TileThreads {
  static constexpr int kThreads = N, kWarps = N / 32;
  static __device__ __forceinline__ void sync() { __syncthreads(); }
};
using Tile256 = TileThreads<256>;

// Rows per staged chunk; a chunk's rows hold DH + 8 bf16 (the 16-byte pad keeps
// ldmatrix free of bank conflicts). The shared memory of the forward tile and of the
// backward's pass (a): two stages of a K and a V chunk.
__host__ __device__ constexpr int tc_chunk(int dh) { return dh > 64 ? 32 : 64; }
__host__ __device__ constexpr int tc_smem_bytes(int dh) {
  return 2 * 2 * tc_chunk(dh) * (dh + 8) * 2;
}

// Rows r0..r0+KC-1 of K (and of V at [KC][DH + 8] after it) of one (frame, head) into
// a shared-memory stage [KC][DH + 8] by cp.async, by the block's NT threads; rows >= S
// are zero-filled.
template <int DH, int NT = 256, typename Rows>
__device__ __forceinline__ void tc_stage_kv(const Rows& base, bf16* buf, int r0, int S,
                                            bool with_v) {
  constexpr int KC = tc_chunk(DH), LD = DH + 8, SEG = DH / 8;  // 16-byte pieces a row
  for (int idx = threadIdx.x; idx < KC * SEG; idx += NT) {
    const int kk = idx / SEG, c = (idx % SEG) * 8, r = r0 + kk;
    const bool in = r < S;
    const int rr = in ? r : 0;  // a valid address for the zero fill
    cp_async16(buf + kk * LD + c, base.k(rr) + c, in);
    if (with_v) cp_async16(buf + (KC + kk) * LD + c, base.v(rr) + c, in);
  }
}

// The K / V staging of a query tile's sweeps over the keys, chunk i into stage i & 1:
// K chunk i for i < nch (the softmax's max and sum), then K and V chunk (i - nch) %
// nch for every later sweep; by the block's NT threads.
template <int DH, typename Rows, int NT = 256>
struct TcKvStage {
  const Rows& base;
  bf16* smem;
  int nch, S;
  static constexpr int kStage = 2 * tc_chunk(DH) * (DH + 8);
  __device__ __forceinline__ void operator()(int i) const {
    const bool v = i >= nch;
    tc_stage_kv<DH, NT>(base, smem + (i & 1) * kStage, (v ? (i - nch) % nch : i) * tc_chunk(DH),
                        S, v);
    cp_async_commit();
  }
  __device__ __forceinline__ const bf16* at(int i) const { return smem + (i & 1) * kStage; }
};

// The A fragments (16 rows, DH columns) of rows r and r + 8 of a row-major bf16
// matrix, straight from device memory: p0 / p1 point at the two rows, nullptr for a
// row past the end (read as zeros).
template <int DH>
__device__ __forceinline__ void tc_rows_frag(unsigned (&a)[DH / 16][4], const bf16* p0,
                                             const bf16* p1, int t) {
  const unsigned* u0 = reinterpret_cast<const unsigned*>(p0);
  const unsigned* u1 = reinterpret_cast<const unsigned*>(p1);
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    a[kk][0] = u0 ? u0[8 * kk + t] : 0u;
    a[kk][1] = u1 ? u1[8 * kk + t] : 0u;
    a[kk][2] = u0 ? u0[8 * kk + 4 + t] : 0u;
    a[kk][3] = u1 ? u1[8 * kk + 4 + t] : 0u;
  }
}

// c[2][4] += A (16 x DH, fragments a) times rows x0..x0+15 of a [.][DH + 8] shared
// tile taken as B = tile^T (so c = A tile^T: two n8 column tiles).
template <int DH>
__device__ __forceinline__ void tc_mma_abt(float (&c)[2][4], const unsigned (&a)[DH / 16][4],
                                           const bf16* tile, int x0, int lane) {
  constexpr int LD = DH + 8;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    unsigned b[4];
    ldsm_x4(b, tile + (x0 + (lane & 7) + ((lane >> 4) << 3)) * LD + 16 * kk +
                   ((lane >> 3) & 1) * 8);
    mma_bf16(c[0], a[kk], b[0], b[1]);
    mma_bf16(c[1], a[kk], b[2], b[3]);
  }
}

// c[DH / 8][4] += A (16 x 16, fragment a) times rows x0..x0+15 of a [.][DH + 8] shared
// tile taken as B (c = A tile[x0 : x0 + 16]).
template <int DH>
__device__ __forceinline__ void tc_mma_ab(float (&c)[DH / 8][4], const unsigned (&a)[4],
                                          const bf16* tile, int x0, int lane) {
  constexpr int LD = DH + 8;
#pragma unroll
  for (int dp = 0; dp < DH / 16; ++dp) {
    unsigned b[4];
    ldsm_x4_trans(b, tile + (x0 + (lane & 15)) * LD + 16 * dp + (lane >> 4) * 8);
    mma_bf16(c[2 * dp], a, b[0], b[1]);
    mma_bf16(c[2 * dp + 1], a, b[2], b[3]);
  }
}

// The scores of one warp's 16 rows against 8 NJ keys from C fragments c (q.k sums):
// x scale, -1e30 added for keys >= n_valid, -inf for keys >= S. key0 is the key of
// the first column; column (j, e) is key0 + 8 j + 2 t + (e & 1).
template <int NJ>
__device__ __forceinline__ void tc_mask(float (&c)[NJ][4], int key0, int t, int S, int n_valid,
                                        float scale) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key0 + 8 * j + 2 * t + (e & 1);
      float v = __fmul_rn(c[j][e], scale);
      if (key >= n_valid) v = __fadd_rn(v, -1e30f);
      c[j][e] = key < S ? v : -INFINITY;
    }
}

// The A fragment of two C tiles (16 x 16) rounded to bf16.
__device__ __forceinline__ void tc_c_to_a(unsigned (&a)[4], const float (&c)[2][4]) {
  a[0] = pack_bf16(c[0][0], c[0][1]);
  a[1] = pack_bf16(c[0][2], c[0][3]);
  a[2] = pack_bf16(c[1][0], c[1][1]);
  a[3] = pack_bf16(c[1][2], c[1][3]);
}

// Row max and sum of exp over a quad's columns, kept per thread across chunks (the
// sum rescaled when the max grows) from this chunk's scores v of the row;
// tc_row_stats_merge gives every thread of the quad the row's max and sum.
template <int N>
__device__ __forceinline__ void tc_row_stats(float& mx, float& sm, const float (&v)[N]) {
  float nm = mx;
#pragma unroll
  for (int i = 0; i < N; ++i) nm = fmaxf(nm, v[i]);
  if (nm == -INFINITY) return;  // no finite score yet
  float acc = __fmul_rn(sm, expf(mx - nm));
#pragma unroll
  for (int i = 0; i < N; ++i) acc = __fadd_rn(acc, expf(v[i] - nm));
  mx = nm;
  sm = acc;
}

__device__ __forceinline__ void tc_row_stats_merge(float& mx, float& sm) {
  float m = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
  float l = mx == -INFINITY ? 0.f : __fmul_rn(sm, expf(mx - m));
  l = __fadd_rn(l, __shfl_xor_sync(0xffffffffu, l, 1));
  l = __fadd_rn(l, __shfl_xor_sync(0xffffffffu, l, 2));
  mx = m;
  sm = l;
}

// Sweep 1 of a query tile: K chunks 0..nch-1 (staged chunk i into stage i & 1 by
// stage(i); chunk 0 already in flight) against the warp's rows qf: each row's max and
// sum of exp, the same in the four threads of its quad. Stages chunk nch (the
// caller's next sweep) on its last step; ends on a barrier. Tile: the block's
// TileThreads.
template <int DH, typename Stage, typename Tile = Tile256>
__device__ __forceinline__ void tc_softmax_stats(const Stage& stage,
                                                 const unsigned (&qf)[DH / 16][4], int nch,
                                                 int S, int n_valid, float scale,
                                                 float (&mx)[2], float (&sm)[2]) {
  constexpr int KC = tc_chunk(DH);
  const int lane = threadIdx.x & 31, t = lane & 3;
  mx[0] = mx[1] = -INFINITY;
  sm[0] = sm[1] = 0.f;
  for (int c = 0; c < nch; ++c) {
    stage(c + 1);
    cp_async_wait<1>();
    Tile::sync();
    const bf16* kt = stage.at(c);
    float s[KC / 16][2][4];
#pragma unroll
    for (int p = 0; p < KC / 16; ++p) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[p][j][e] = 0.f;
      tc_mma_abt<DH>(s[p], qf, kt, 16 * p, lane);
      tc_mask(s[p], c * KC + 16 * p, t, S, n_valid, scale);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float v[KC / 4];
#pragma unroll
      for (int p = 0; p < KC / 16; ++p)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) v[4 * p + 2 * j + e] = s[p][j][2 * r + e];
      tc_row_stats(mx[r], sm[r], v);
    }
    Tile::sync();
  }
  tc_row_stats_merge(mx[0], sm[0]);
  tc_row_stats_merge(mx[1], sm[1]);
}

}  // namespace istvt
