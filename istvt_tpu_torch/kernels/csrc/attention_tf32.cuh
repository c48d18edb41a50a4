// The f32 tensor-core pieces of the spatial attention cores, forward (q8_attention.cuh)
// and backward (attention_bwd.cu): one (frame, head), 16 rows a warp (the bf16 tiles'
// 128 query or key rows in a block of 256 threads, 192 in #9's 384), every product
// c += a b taken as three TF32 products on mma.sync m16n8k8 (mma.cuh mma_3xtf32) of
// operands split x = x_hi + x_lo, each half rounded as cvt.rna.tf32.f32 rounds
// (split_tf32, in integer operations). One TF32 product misses the f32
// criterion (1e-5) some thirty-fold; three meet it with room to spare
// (tests/test_torch_spatial_f32.py models the sums on the CPU). What the design does:
//   * The rows a warp owns (queries; keys in the backward's pass (b)) are the A side.
//     Each lane keeps its raw f32 A fragments in its own slots of shared memory (16 x dh
//     floats a warp and matrix) and splits them when a chunk needs them, so that the
//     registers go to the accumulators (#9's 168 a thread hold the forward at dh 64).
//   * The other side streams in chunks of kTfC = 32 rows: the block copies the next
//     chunk's raw rows by cp.async while this one computes, then splits each element
//     once into hi and lo (a B element is split once a block, not once a warp), laid
//     out in the order of the mma's B fragment, so that one 16-byte load gives a thread
//     the four B values of three products, free of bank conflicts (Tf32Stage).
//   * The tensor cores round each product's f32 sum toward zero, so every 32-deep
//     k-step (4 products 8 deep) sums into a fresh accumulator that an IEEE add folds
//     in: Q K^T at dh 64 is two k-steps, P V one a 32-key chunk.
//   * P (and dS) go from the accumulators straight into the next product's A
//     fragment: C column 2t is taken as k index t and 2t + 1 as t + 4 (mma.cuh), and
//     B's rows in the same order.
//   * P is not rounded in f32, so the forward and the backward's first sweep keep an
//     online softmax (tf32_online): one pass over the keys where the bf16 tiles, which
//     round the normalised P, take two.
//   * A row's bits do not depend on the warps of the tile (each warp's sums are its
//     own), so #9's 12-warp tile gives the standalone kernel's bits.
#pragma once

#include "attention_tc.cuh"

namespace istvt {

constexpr int kTfC = 32;  // rows a staged chunk, and the depth of one fresh sum

// The planes a chunk's row source is split into, each element's hi and lo side by side in
// the order the mma's B fragment takes them, so that one 16-byte load gives a thread its
// b0 and b1 halves of a product (4 floats of B for 3 products):
//   * T, for A B^T (B's rows are the chunk's rows, read along them): row r, k-step kk,
//     lane t: (hi, hi, lo, lo) of columns 8 kk + t and 8 kk + t + 4, at r RT + 16 kk + 4 t;
//     RT = 2 DH + 16 floats (= 16 mod 32: a quarter-warp's loads free of bank conflicts);
//   * A, for A B (B's rows are the chunk's rows, read down a column): k-step kk, lane t,
//     column c: (hi, hi, lo, lo) of rows 8 kk + 2 t and 8 kk + 2 t + 1 (the order in
//     which the C columns of P stand in its A fragment, mma.cuh), at ((4 kk + t) CA + c) 4;
//     CA = DH + 2 (= 2 mod 8, likewise).
__host__ __device__ constexpr int tf32_t_floats(int dh) { return kTfC * (2 * dh + 16); }
__host__ __device__ constexpr int tf32_a_floats(int dh) { return 16 * (dh + 2) * 4; }

// Floats of shared memory: the held A fragments of `held` matrices for `warps` warps,
// and a Tf32Stage of `ns` row sources, nt of them split into T planes and na into A
// planes, with `nx` extra floats a row.
__host__ __device__ constexpr int tf32_held_floats(int dh, int warps, int held) {
  return held * warps * 16 * dh;
}
__host__ __device__ constexpr int tf32_stage_floats(int dh, int ns, int nt, int na, int nx) {
  return nt * tf32_t_floats(dh) + na * tf32_a_floats(dh) + 2 * nx * kTfC + ns * kTfC * dh;
}

// This lane's slots of held matrix m (of the block's `warps`): k-step kk's fragment
// a0..a3 at slot + 128 kk (one float4, the warp's lanes side by side).
template <int DH>
__device__ __forceinline__ float* tf32_slots(float* smem, int warps, int m, int warp, int lane) {
  return smem + (m * warps + warp) * 16 * DH + 4 * lane;
}

// Fills a lane's slots from rows p0 (row g of the warp's 16) and p1 (row g + 8); a null
// row reads as zeros. Each lane reads back only its own slots: no barrier.
template <int DH>
__device__ __forceinline__ void tf32_hold(float* slot, const float* p0, const float* p1, int t) {
#pragma unroll
  for (int kk = 0; kk < DH / 8; ++kk) {
    float4 a;
    a.x = p0 ? p0[8 * kk + t] : 0.f;
    a.y = p1 ? p1[8 * kk + t] : 0.f;
    a.z = p0 ? p0[8 * kk + t + 4] : 0.f;
    a.w = p1 ? p1[8 * kk + t + 4] : 0.f;
    *reinterpret_cast<float4*>(slot + 128 * kk) = a;
  }
}

// (hi, hi, lo, lo) of x0 and x1, as one 16-byte store.
__device__ __forceinline__ void tf32_store_pair(float* p, float x0, float x1) {
  uint4 v;
  split_tf32(x0, v.x, v.z);
  split_tf32(x1, v.y, v.w);
  *reinterpret_cast<uint4*>(p) = v;
}

// Chunks of NS row sources (rows r0..r0 + 31; zeros past S): source s split into a T
// plane if bit s of TM is set and an A plane if bit s of AM is, and NX floats a row
// beside them (taken as they are), by the block's Tile::kThreads threads. smem: each
// source's planes in turn (T, then A), the extras [NX kTfC], the raw rows [NS kTfC DH]
// and the raw extras [NX kTfC].
// Where source s's T plane (a = false) or A plane (a = true) starts in a stage.
template <int DH, unsigned TM, unsigned AM>
__host__ __device__ constexpr int tf32_plane_offset(int s, bool a) {
  int o = 0;
  for (int i = 0; i < s; ++i)
    o += ((TM >> i) & 1u) * tf32_t_floats(DH) + ((AM >> i) & 1u) * tf32_a_floats(DH);
  return o + (a ? ((TM >> s) & 1u) * tf32_t_floats(DH) : 0);
}

// threadIdx.x, opaque to the compiler: the staging loops' addresses are computed anew
// each chunk rather than hoisted out of the chunk loop, where they would hold registers
// through the products (in #9's 168 a thread they spilled).
__device__ __forceinline__ int tf32_tid() {
  int tid = threadIdx.x;
  asm volatile("" : "+r"(tid));
  return tid;
}

template <int DH, typename Tile, int NS, unsigned TM, unsigned AM, int NX = 0>
struct Tf32Stage {
  static constexpr int SEG = DH / 4, kPieces = NS * kTfC * SEG, kX = NX * kTfC;
  static constexpr int kPlanes = tf32_plane_offset<DH, TM, AM>(NS, false);
  static constexpr int kFloats = kPlanes + 2 * kX + NS * kTfC * DH;
  __host__ __device__ static constexpr int offset(int s, bool a) {
    return tf32_plane_offset<DH, TM, AM>(s, a);
  }
  float* smem;
  __device__ __forceinline__ const float* bt(int s) const { return smem + offset(s, false); }
  __device__ __forceinline__ const float* ba(int s) const { return smem + offset(s, true); }
  __device__ __forceinline__ float* extra() const { return smem + kPlanes; }
  __device__ __forceinline__ float* raw() const { return extra() + kX; }

  // This thread's copies of chunk rows r0.. of the sources in `mask` (row(s, r): row r
  // < S of source s) and of the extras (x: row r's NX floats at x + NX r), committed as
  // one group.
  template <typename Row>
  __device__ __forceinline__ void issue(const Row& row, const float* x, int r0, int S,
                                        unsigned mask) const {
    const int tid = tf32_tid();
    for (int idx = tid; idx < kPieces; idx += Tile::kThreads) {
      const int s = idx / (kTfC * SEG), r = r0 + (idx / SEG) % kTfC;
      if (!((mask >> s) & 1u)) continue;
      const bool in = r < S;
      cp_async16(raw() + 4 * idx, row(s, in ? r : 0) + 4 * (idx % SEG), in);
    }
    if constexpr (NX > 0)
      for (int idx = tid; idx < kX; idx += Tile::kThreads) {
        const bool in = r0 + idx / NX < S;
        cp_async4(raw() + NS * kTfC * DH + idx, x + (in ? NX * r0 + idx : 0), in);
      }
    cp_async_commit();
  }

  // Once every thread's copies have landed and a barrier made them visible: the sources
  // in `mask` split into their planes, the extras copied.
  __device__ __forceinline__ void split(unsigned mask) const {
    constexpr int KS = DH / 8, CA = DH + 2;
    const int tid = tf32_tid();
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      if (!((mask >> s) & 1u)) continue;
      const float* rs = raw() + s * kTfC * DH;
      if ((TM >> s) & 1u) {
        float* pt = smem + offset(s, false);
        for (int o = tid; o < kTfC * KS * 4; o += Tile::kThreads) {
          const int r = o / (4 * KS), kk = (o / 4) % KS, t = o % 4;
          const float* x = rs + r * DH + 8 * kk + t;
          tf32_store_pair(pt + r * (2 * DH + 16) + 16 * kk + 4 * t, x[0], x[4]);
        }
      }
      if ((AM >> s) & 1u) {
        float* pa = smem + offset(s, true);
        for (int o = tid; o < 16 * DH; o += Tile::kThreads) {
          const int c = o % DH, kt = o / DH;  // kt = 4 kk + t
          const float* x = rs + (8 * (kt / 4) + 2 * (kt % 4)) * DH + c;
          tf32_store_pair(pa + (kt * CA + c) * 4, x[0], x[DH]);
        }
      }
    }
    if constexpr (NX > 0)
      for (int idx = tid; idx < kX; idx += Tile::kThreads)
        extra()[idx] = raw()[NS * kTfC * DH + idx];
  }
};

// Chunk i of a tile's n: once this thread's copies landed and a barrier made every
// thread's visible (and every warp is done with chunk i - 1's planes), splits the
// sources in `mask` into the planes; once they are whole, starts the copies of chunk
// i + 1 by next(i + 1) (after that barrier, so that they land after every read of the
// raw rows). The planes are read until the next call's first barrier; no copy is in
// flight after the last chunk's call.
template <typename Tile, typename Stage, typename Next>
__device__ __forceinline__ void tf32_land(const Stage& st, unsigned mask, int i, int n,
                                          const Next& next) {
  cp_async_wait<0>();
  Tile::sync();
  st.split(mask);
  Tile::sync();
  if (i + 1 < n) next(i + 1);
}

// The split A fragment of one k-step from a lane's slot.
__device__ __forceinline__ void tf32_a(unsigned (&ah)[4], unsigned (&al)[4], const float* slot) {
  const float4 a = *reinterpret_cast<const float4*>(slot);
  split_tf32(a.x, ah[0], al[0]);
  split_tf32(a.y, ah[1], al[1]);
  split_tf32(a.z, ah[2], al[2]);
  split_tf32(a.w, ah[3], al[3]);
}

// c[j] = A B^T over DH for the NJ n8 tiles of B rows 8 j.. of the T plane bt; A from a
// lane's held slots. Each 32-deep k-step sums afresh, folded into c by an IEEE add.
// kSwap: A and B exchanged against the product whose bits this must equal (mma_3xtf32).
template <int DH, int NJ, bool kSwap = false>
__device__ __forceinline__ void tf32_abt(float (&c)[NJ][4], const float* slot, const float* bt,
                                         int lane) {
  constexpr int RT = 2 * DH + 16, KS = DH / 8;
  const float* b = bt + (lane >> 2) * RT + 4 * (lane & 3);
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < KS; k0 += kTfC / 8) {
    float part[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
#pragma unroll
    for (int kk = k0; kk < k0 + kTfC / 8 && kk < KS; ++kk) {
      unsigned ah[4], al[4];
      tf32_a(ah, al, slot + 128 * kk);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const uint4 v = *reinterpret_cast<const uint4*>(b + 8 * j * RT + 16 * kk);
        mma_3xtf32<kSwap>(part[j], ah, al, v.x, v.y, v.z, v.w);
      }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[j][e] = __fadd_rn(c[j][e], part[j][e]);
  }
}

// c = A B^T over the 32 rows of a chunk's T plane (tf32_abt), in NG groups of 32 / NG
// rows: each n8 tile is summed on its own, so any NG gives the same bits; more groups
// hold fewer fresh sums live (and split A once a group).
template <int DH, int NG = 1, bool kSwap = false>
__device__ __forceinline__ void tf32_scores(float (&c)[4][4], const float* slot,
                                            const float* bt, int lane) {
  constexpr int NJ = 4 / NG;
#pragma unroll
  for (int gi = 0; gi < NG; ++gi)
    tf32_abt<DH, NJ, kSwap>(*reinterpret_cast<float(*)[NJ][4]>(&c[gi * NJ][0]), slot,
                            bt + gi * 8 * NJ * (2 * DH + 16), lane);
}

// c[DH / 8] += P B over the 32 rows of the A plane ba: P the 16 x 32 f32 C tiles p (tile
// kk = columns 8 kk..), its k index t standing for column 8 kk + 2 t and t + 4 for
// 8 kk + 2 t + 1. Each of the NH column groups sums afresh over the 32 rows, folded into
// c by an IEEE add; more groups hold fewer fresh sums in registers (and split P once a
// group), with the same bits.
template <int DH, int NH = 1>
__device__ __forceinline__ void tf32_ab(float (&c)[DH / 8][4], const float (&p)[4][4],
                                        const float* ba, int lane) {
  constexpr int CA = DH + 2, NN = DH / 8 / NH;
  const float* b = ba + ((lane & 3) * CA + (lane >> 2)) * 4;
#pragma unroll
  for (int hh = 0; hh < NH; ++hh) {
    float part[NN][4];
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      unsigned ah[4], al[4];
      split_tf32(p[kk][0], ah[0], al[0]);  // (g, 2t)
      split_tf32(p[kk][2], ah[1], al[1]);  // (g + 8, 2t)
      split_tf32(p[kk][1], ah[2], al[2]);  // (g, 2t + 1)
      split_tf32(p[kk][3], ah[3], al[3]);  // (g + 8, 2t + 1)
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        const uint4 v =
            *reinterpret_cast<const uint4*>(b + (4 * kk * CA + 8 * (hh * NN + n)) * 4);
        mma_3xtf32(part[n], ah, al, v.x, v.y, v.z, v.w);
      }
    }
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[hh * NN + n][e] = __fadd_rn(c[hh * NN + n][e], part[n][e]);
  }
}

// One chunk of an online softmax over the scores s (16 rows x 32 keys; row r = 0 the
// lane's row g, 1 its row g + 8): each row's running max mx (the same in the four
// threads of its quad) grows to the chunk's, corr = exp(old max - new max), s becomes e =
// exp(s - max), and this thread's sum of e over its columns sm = sm corr + the chunk's,
// in column order. Keys at -inf give e = 0; a chunk holds a key < S, so the max is
// finite from the first chunk on (corr = exp(-inf) = 0 there).
__device__ __forceinline__ void tf32_online(float (&s)[4][4], float (&mx)[2], float (&sm)[2],
                                            float (&corr)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float m = mx[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) m = fmaxf(m, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    corr[r] = expf(mx[r] - m);
    mx[r] = m;
    float acc = __fmul_rn(sm[r], corr[r]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        s[j][e] = expf(s[j][e] - m);
        acc = __fadd_rn(acc, s[j][e]);
      }
    sm[r] = acc;
  }
}

// The rows' sums over the quad (each thread's sm over its columns, all at one max) and
// their reciprocals, the same in the four threads.
__device__ __forceinline__ void tf32_row_sums(float (&sm)[2], float (&rinv)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sm[r] = __fadd_rn(sm[r], __shfl_xor_sync(0xffffffffu, sm[r], 1));
    sm[r] = __fadd_rn(sm[r], __shfl_xor_sync(0xffffffffu, sm[r], 2));
    rinv[r] = __frcp_rn(sm[r]);
  }
}

// Rows r, r + 8 of a 16 x DH accumulator to out rows o0, o1 (null: not stored).
template <int DH>
__device__ __forceinline__ void tf32_store(const float (&c)[DH / 8][4], float* o0, float* o1,
                                           int t) {
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    if (o0) *reinterpret_cast<float2*>(o0 + 8 * n + 2 * t) = make_float2(c[n][0], c[n][1]);
    if (o1) *reinterpret_cast<float2*>(o1 + 8 * n + 2 * t) = make_float2(c[n][2], c[n][3]);
  }
}

}  // namespace istvt
