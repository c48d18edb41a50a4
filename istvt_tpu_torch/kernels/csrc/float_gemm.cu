// LayerNorm rows, the float GEMM with its fused epilogues, the LayerNorm-backward
// rows and a column-sum pass: the building blocks of the float fused path's
// projection kernels, forward and backward (kernels/linear.py, kernels/mlp.py).
//
// Replaces six TPU kernels, and serves as the second half of a seventh:
//   * istvt_tpu/kernels/linear.py _ln_matmul_impl (_ln_matmul_kernel): LN -> x @ w,
//     here ln_rows then gemm;
//   * istvt_tpu/kernels/linear.py _matmul_bias_impl (_matmul_bias[_res]_kernel):
//     x @ w + b (+ r), here one gemm;
//   * istvt_tpu/kernels/mlp.py _ln_ff_res_impl (_ln_ff_res_kernel): x + fc2(gelu(fc1(LN x))),
//     here ln_rows, gemm (+ b1, tanh-GELU), gemm (+ b2, + x); its training variant
//     (stash_h1) also writes the pre-GELU h1 from fc1's epilogue (`out2`);
//   * istvt_tpu/kernels/mlp.py _fused_ff_impl (_ff_kernel): fc2(gelu(fc1(x))) without
//     LN or residual, the attention-map path's feed-forward on its unpadded
//     B * 7 * 362 rows, here gemm (+ b1, tanh-GELU), gemm (+ b2);
//   * istvt_tpu/kernels/linear.py _ln_matmul_bwd_impl (_ln_matmul_bwd_kernel): here
//     ln_rows (y), gemm NT (dy = g w^T, f32), ln_bwd_rows (dx and the ds / db column
//     partials), colsum, gemm TN (dw = y^T g, f32);
//   * (fc2 of) istvt_tpu/kernels/quant.py _ln_ff_q8_impl (_ln_ff_q8_kernel, the
//     q8_ff='mixed' FF): gemm (+ b2, + x) on the GELU hidden that
//     q8_rows_gemm.cu's int8 fc1 rounded to x's dtype;
//   * istvt_tpu/kernels/mlp.py _ln_ff_bwd_impl (_ln_ff_bwd_kernel): here ln_rows (y),
//     gemm NT with the GELU-backward epilogue (dh1 = (g w2^T) * gelu'(h1) in x's dtype,
//     gelu(h1) for dw2, db1 column partials), colsum, gemm TN (dw2, dw1, f32), gemm NT
//     (dy = dh1 w1^T, f32), ln_bwd_rows (+ g; ds, dbn, db2 partials), colsum.
//
// What bounds them on the H100: at B=16 the GEMMs are 92 GFLOP (QKV), 31 GFLOP
// (out-projection) and 350 GFLOP (FF) per layer forward, and 3x / 5x that for the
// LN->GEMM / FF backward, against 989 TFLOP/s of bf16 tensor cores, so they are bound
// by operations; the rows passes move bytes only. The TPU kernels kept the normalised
// rows, the (N, 4D) FF hidden and the backward's dy / dh1 in VMEM; here they go
// through device memory in the dtype JAX rounds them to (the activation dtype, or f32
// where the JAX kernel keeps f32), so the numbers are the same at the cost of extra
// round trips. In f32 (the attention-map path's dtype, and the CLIs' serving and
// training without --bf16) the FMA pipes give 67 TFLOP/s at most; single-pass TF32
// (495 TFLOP/s) rounds each input to 11 bits and misses f32 accuracy by about 1e-3.
// So f32 runs three TF32 products on the tensor cores, a_lo b_hi + a_hi b_lo + a_hi
// b_hi with x = x_hi + x_lo, x_hi = rna_tf32(x), x_lo = rna_tf32(x - x_hi): the
// dropped a_lo b_lo and the roundings leave about 2^-21 of each product, as close to
// f32 as the FMA pipes' own summation order; the ceiling is 495 / 3 = 165 TFLOP/s.
//
// What the design does about it: both GEMMs are warp-specialised on Hopper's
// asynchronous units (wgmma.cuh). A block of 384 threads owns one SM and walks over
// 128 x 128 output tiles (persistent: one block per SM, the tiles taken in turn):
// warpgroup 2 gives up its registers (setmaxnreg) and one of its threads starts TMA
// loads of the k-step's A and B tiles into a ring of kStages stages in dynamic shared
// memory, running ahead into the next tile while the consumers finish one (an mbarrier
// pair per stage: "full" completes on the tiles' bytes, "empty" when all 8 consumer
// warps are done with the stage); warpgroups 0 and 1 take the registers and run wgmma
// on 64 rows each. TMA zero-fills the K tail (728 = 11 * 64 + 24) and the M / N edges,
// and the epilogue masks its stores.
//   * bf16: 64-deep k-steps, wgmma m64n128k16 straight from shared memory. Each
//     operand is read in its stored layout, no transposed copy: the TMA box and the
//     128-byte swizzle match the wgmma descriptor of that operand's major (NN: A
//     K-major, B N-major; NT: both K-major, the (N, K) weight as stored; TN: A M-major,
//     B N-major, through wgmma's transpose bits).
//   * f32: 32-deep k-steps (one 128-byte row of f32), wgmma m64n128k8 tf32, which has
//     no transpose bits. B is read from shared memory as two K-major planes, B_hi and
//     B_lo (N, K), that a pass writes once a call (tf32_planes_kernel: the weight for NN
//     and NT, 8.5 MB at most; for TN the (rows, N) gradient, transposed there). A is
//     loaded by each consumer from its stage in the stored major (K-major, or M-major
//     for TN), split into TF32 hi / lo in registers and given to wgmma as the register
//     operand, so the activations need no extra pass. A stage is 48 KB (A 16, B_hi 16,
//     B_lo 16); a k-step issues the small products before a_hi b_hi, in two halves of
//     six wgmma, the second half's loads and splits running while the first half's
//     products are in flight. The tensor cores round each wgmma's f32 sum toward zero,
//     so a k-step sums into a fresh accumulator that an IEEE add then folds into the
//     tile's sums: summed in one accumulator over K = 2912, the bias reached 7e-5, seven
//     times the f32 check's tolerance (PERF.md).
// The epilogue (+ bias, stash, tanh-GELU, + residual; or the GELU derivative) runs on
// the wgmma accumulator registers in the JAX order, in f32, with one rounding; its bias
// goes to shared memory and its residual or GELU input to registers before the tile's
// main loop, so their latency hides under it. Column sums over rows (db1, ds, db) are
// written per 128-row tile and added by a second pass in a fixed order, not with
// atomics, so every result is deterministic. The weight gradients (TN, K = the rows)
// are split along K where whole tiles would leave the SMs under a wave
// (kernels/linear.plan_splitk): each slice writes an f32 partial and colsum adds them
// in slice order. Measured on the H100 and left out (PERF.md): a 128 x 256 tile (slower
// but for TN), two blocks an SM (the wgmma needs more than the 80 registers a thread
// that leaves), a fifth stage, a second wgmma group in flight (bf16). Not yet used: an
// epilogue that overlaps the next tile's products (consumer warpgroups on alternate
// tiles), TMA stores, clusters and multicast (each block reads its A and B tiles from
// L2), fusing LN into the A load.
#include <type_traits>

#include "wgmma.cuh"

namespace istvt {

// (i) LayerNorm rows: y = LN(x) * s + b in x's dtype. One warp per row.
template <typename T>
__global__ void __launch_bounds__(256) ln_rows_kernel(
    const T* __restrict__ x, const float* __restrict__ s, const float* __restrict__ b,
    T* __restrict__ y, int R, int D) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + warp;
  if (row >= R) return;
  const T* xr = x + static_cast<size_t>(row) * D;
  float mean, r;
  row_ln_stats(xr, D, lane, mean, r);
  T* yr = y + static_cast<size_t>(row) * D;
  for (int d = lane; d < D; d += 32) yr[d] = from_f<T>(ln_affine(to_f(xr[d]), mean, r, s[d], b[d]));
}

// tanh-GELU value and derivative (kernels/mlp._gelu_tanh_and_grad, term for term):
// u = c (h + a h^3), t = tanh u, val = h/2 (1 + t),
// dval = (1 + t)/2 + h/2 (1 - t^2) c (1 + 3a h^2).
__device__ __forceinline__ void gelu_tanh_and_grad(float h, float& val, float& dval) {
  const float c = 0.7978845608028654f, a = 0.044715f, a3 = 0.134145f;
  const float u = __fmul_rn(c, __fadd_rn(h, __fmul_rn(__fmul_rn(__fmul_rn(a, h), h), h)));
  const float t = tanhf(u);
  const float half_h = __fmul_rn(0.5f, h);
  const float one_t = __fadd_rn(1.0f, t);
  val = __fmul_rn(half_h, one_t);
  const float sech2 = __fsub_rn(1.0f, __fmul_rn(t, t));
  const float poly = __fadd_rn(1.0f, __fmul_rn(__fmul_rn(a3, h), h));
  dval = __fadd_rn(__fmul_rn(0.5f, one_t), __fmul_rn(__fmul_rn(__fmul_rn(half_h, sech2), c), poly));
}

// Operand layouts of a GEMM out (M, N) = A @ B: NN A (M, K), B (K, N); NT A (M, K),
// B given as (N, K); TN A given as (K, M), B (K, N). All row-major.
constexpr int kNN = 0, kNT = 1, kTN = 2;
// Epilogues (a template parameter, so the serving forward's GEMMs carry none of the
// training's code): kEpiStd acc (+ bias) (-> tanh-GELU) (+ res); kEpiStash the same
// with the pre-activation also stored to out2; kEpiGeluBwd acc * gelu'(aux) with
// gelu(aux) -> out2 and column sums -> part.
constexpr int kEpiStd = 0, kEpiGeluBwd = 1, kEpiStash = 2;

struct Epi {
  const float* bias;  // (N,) f32, or null (kEpiStd)
  const void* res;    // (M, N) in the input dtype, or null (kEpiStd)
  void* out2;         // (M, N) in the input dtype: kEpiStash the pre-activation,
                      // kEpiGeluBwd gelu(aux)
  const void* aux;    // (M, N) in the input dtype (kEpiGeluBwd)
  float* part;        // (M tiles, N) column sums of the f32 result per tile of rows
                      // (kEpiGeluBwd)
  int gelu;
};

// The f32 epilogue value at (row, col) = flat index o, in the JAX order; writes the
// side output; the caller rounds the returned value once into out.
template <typename T, int EPI>
__device__ __forceinline__ float epi_value(const Epi& e, float v, size_t o, int col) {
  if (EPI == kEpiGeluBwd) {
    float val, dval;
    gelu_tanh_and_grad(to_f(static_cast<const T*>(e.aux)[o]), val, dval);
    static_cast<T*>(e.out2)[o] = from_f<T>(val);
    return __fmul_rn(v, dval);
  }
  if (e.bias != nullptr) v = __fadd_rn(v, e.bias[col]);
  if (EPI == kEpiStash) static_cast<T*>(e.out2)[o] = from_f<T>(v);
  if (e.gelu) v = gelu_tanh(v);
  if (e.res != nullptr) v = __fadd_rn(v, to_f(static_cast<const T*>(e.res)[o]));
  return v;
}

// (ii) the wgmma GEMMs (see the header): 128 x 128 output tiles, kStages TMA-filled
// stages, warpgroups 0-1 consume, warpgroup 2 produces; bf16 64 deep a k-step, f32 32.
constexpr int kBM = kTileM, kBN = kTileN, kBK = 64, kFK = 32, kGemmThreads = 384;
// the ring's depth, and the registers a thread of the producer / consumer warpgroups
// keeps after setmaxnreg (of the block's 384 x 168 at launch)
constexpr int kStages = 4, kProducerRegs = 40, kConsumerRegs = 232;

// Dynamic shared memory of a block: the rings (bf16: A and B; f32: A, B_hi and B_lo),
// the full / empty barriers, the column-sum scratch [8 warps][kBN], the bias tile [kBN],
// and 1 KB to align the rings to the swizzle atom.
constexpr int kGemmSmem = kStages * (kBM + kBN) * kBK * 2 + 2 * kStages * 8 + 9 * kBN * 4 + 1024;
constexpr int kF32Smem = kStages * (kBM + 2 * kBN) * kFK * 4 + 2 * kStages * 8 + 9 * kBN * 4 +
                         1024;

// A side tensor's pair of columns (col, col + 1) in registers, in the input dtype T.
template <typename T> struct PairOf;
template <> struct PairOf<__nv_bfloat16> { using type = __nv_bfloat162; };
template <> struct PairOf<float> { using type = float2; };
__device__ __forceinline__ float2 pair_f(__nv_bfloat162 v) { return __bfloat1622float2(v); }
__device__ __forceinline__ float2 pair_f(float2 v) { return v; }
template <typename T> __device__ __forceinline__ typename PairOf<T>::type zero_pair();
template <> __device__ __forceinline__ __nv_bfloat162 zero_pair<__nv_bfloat16>() {
  return __floats2bfloat162_rn(0.f, 0.f);
}
template <> __device__ __forceinline__ float2 zero_pair<float>() { return make_float2(0.f, 0.f); }

// Stores the pair (a, b) in T at the even flat index o of p.
template <typename T> __device__ __forceinline__ void store_side(void* p, size_t o, float a, float b);
template <>
__device__ __forceinline__ void store_side<__nv_bfloat16>(void* p, size_t o, float a, float b) {
  static_cast<__nv_bfloat162*>(p)[o >> 1] = __floats2bfloat162_rn(a, b);
}
template <> __device__ __forceinline__ void store_side<float>(void* p, size_t o, float a, float b) {
  static_cast<float2*>(p)[o >> 1] = make_float2(a, b);
}

// epi_value of the wgmma GEMMs on the pair of columns (col, col + 1) at the even flat
// index o: the same arithmetic in the same order, the pair of bias values `b` (read
// only if e.bias is set) and of the side tensor's values `side` (res for kEpiStd /
// kEpiStash, aux for kEpiGeluBwd; read only where they are set) given, the side
// output stored as a pair in the input dtype T.
template <typename T, int EPI>
__device__ __forceinline__ float2 epi_pair(const Epi& e, float v0, float v1, size_t o, float2 b,
                                           float2 side) {
  if (EPI == kEpiGeluBwd) {
    float val0, d0, val1, d1;
    gelu_tanh_and_grad(side.x, val0, d0);
    gelu_tanh_and_grad(side.y, val1, d1);
    store_side<T>(e.out2, o, val0, val1);
    return make_float2(__fmul_rn(v0, d0), __fmul_rn(v1, d1));
  }
  if (e.bias != nullptr) {
    v0 = __fadd_rn(v0, b.x);
    v1 = __fadd_rn(v1, b.y);
  }
  if (EPI == kEpiStash) store_side<T>(e.out2, o, v0, v1);
  if (e.gelu) {
    v0 = gelu_tanh(v0);
    v1 = gelu_tanh(v1);
  }
  if (e.res != nullptr) {
    v0 = __fadd_rn(v0, side.x);
    v1 = __fadd_rn(v1, side.y);
  }
  return make_float2(v0, v1);
}

// The epilogue's operands of a tile, read before its main loop so that their latency
// hides under it: (N even) this thread's pairs of res or aux, at its accumulator
// positions, zero where there are none.
template <typename T, int EPI>
__device__ __forceinline__ void load_side(typename PairOf<T>::type (&side)[16][2], const Epi& epi,
                                          bool vec, int M, int N, int m0, int n0, int wg,
                                          int warp, int g, int q) {
  using P = typename PairOf<T>::type;
  const P* side_g = static_cast<const P*>(EPI == kEpiGeluBwd ? epi.aux : epi.res);
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wg * 64 + warp * 16 + g + 8 * h;
      const int col = n0 + i * 8 + 2 * q;
      side[i][h] = zero_pair<T>();
      if (vec && side_g != nullptr && row < M && col < N)
        side[i][h] = side_g[(static_cast<size_t>(row) * N + col) >> 1];
    }
}

// The epilogue of a tile on the accumulators: thread (warpgroup wg, warp, g, q) holds
// rows 64 wg + 16 warp + g (+ 8), columns 8 i + 2 q (+ 1); the tile's bias columns are
// in sbias; kEpiGeluBwd's column sums go through red to epi.part's row mt.
template <typename T, typename OutT, int EPI>
__device__ __forceinline__ void store_tile(const float (&acc)[64],
                                           const typename PairOf<T>::type (&side)[16][2],
                                           const Epi& epi, OutT* dst, const float* sbias,
                                           float* red, bool vec, int M, int N, int m0, int n0,
                                           int mt, int wg, int warp, int g, int q) {
  const int c = threadIdx.x;  // 0..255 over the consumers
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int col = n0 + i * 8 + 2 * q;
    float csum[2] = {0.f, 0.f};  // kEpiGeluBwd: the column pair's sum over h
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wg * 64 + warp * 16 + g + 8 * h;
      if (row >= M || col >= N) continue;
      const size_t o = static_cast<size_t>(row) * N + col;
      const float a0 = acc[4 * i + 2 * h], a1 = acc[4 * i + 2 * h + 1];
      if (vec) {  // N even, so col + 1 < N too
        const int cl = col - n0;
        const float2 v = epi_pair<T, EPI>(epi, a0, a1, o, make_float2(sbias[cl], sbias[cl + 1]),
                                          pair_f(side[i][h]));
        store_pair<OutT>(dst + o, v.x, v.y, true);
        csum[0] += v.x;
        csum[1] += v.y;
      } else {
        const float v0 = epi_value<T, EPI>(epi, a0, o, col);
        if (col + 1 < N) {
          const float v1 = epi_value<T, EPI>(epi, a1, o + 1, col + 1);
          store_pair<OutT>(dst + o, v0, v1, false);
          csum[1] += v1;
        } else {
          dst[o] = from_f<OutT>(v0);
        }
        csum[0] += v0;
      }
    }
    if constexpr (EPI == kEpiGeluBwd) {
      // column sums of the tile's 128 rows: over the 8 row groups of a warp
      // (lane bits 2-4) here, then over the 8 consumer warps in order below
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          csum[e] += __shfl_xor_sync(0xffffffffu, csum[e], off);
        if (g == 0) red[(wg * 4 + warp) * kBN + i * 8 + 2 * q + e] = csum[e];
      }
    }
  }
  if constexpr (EPI == kEpiGeluBwd) {
    bar_sync(256);
    if (c < kBN && n0 + c < N) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) v += red[w * kBN + c];
      epi.part[static_cast<size_t>(mt) * N + n0 + c] = v;
    }
  }
}

// out (M, N) (+ z M N for split-K slice z's partial) = epilogue(A @ B), A's and B's
// k-tiles [z kslice, (z + 1) kslice) for slice z. Persistent: each block walks the
// tiles blockIdx.x, + gridDim.x, ...; the producer runs ahead into the next tile's
// loads while the consumers finish a tile's epilogue.
template <int L, typename OutT, int EPI>
__global__ void __launch_bounds__(kGemmThreads, 1) gemm_bf16_wgmma_kernel(
    const __grid_constant__ CUtensorMap tma_a, const __grid_constant__ CUtensorMap tma_b,
    OutT* __restrict__ out, Epi epi, int M, int N, TileGrid grid) {
  constexpr bool kAm = L == kTN;  // A stored (K, M): M-major
  constexpr bool kBn = L != kNT;  // B stored (K, N): N-major
  constexpr int kAStage = kBM * kBK, kBStage = kBN * kBK;  // elements
  constexpr unsigned kTxBytes = (kAStage + kBStage) * 2;  // the full boxes, edges too
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(base);
  __nv_bfloat16* Bs = As + kStages * kAStage;
  uint64_t* full = reinterpret_cast<uint64_t*>(Bs + kStages * kBStage);
  uint64_t* empty = full + kStages;
  float* red = reinterpret_cast<float*>(empty + kStages);
  float* sbias = red + 8 * kBN;
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int tiles = grid.count();
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread keeps the ring full, across tiles
    regs_dealloc<kProducerRegs>();
    if (t == 0)
      produce_ring<kStages>(grid, tiles, full, empty, kTxBytes, [&](int s, int m0, int n0, int kt) {
        const int k0 = kt * kBK;
        __nv_bfloat16* a = As + s * kAStage;
        __nv_bfloat16* b = Bs + s * kBStage;
        if (kAm) {  // two 64-wide M slabs of 64 K-rows
          tma_load_2d(a, &tma_a, &full[s], m0, k0);
          tma_load_2d(a + 64 * kBK, &tma_a, &full[s], m0 + 64, k0);
        } else {  // 128 rows of 64 K
          tma_load_2d(a, &tma_a, &full[s], k0, m0);
        }
        if (kBn) {
#pragma unroll
          for (int j = 0; j < kBN / 64; ++j)
            tma_load_2d(b + j * 64 * kBK, &tma_b, &full[s], n0 + 64 * j, k0);
        } else {
          tma_load_2d(b, &tma_b, &full[s], k0, n0);
        }
      });
  } else {
    // consumers: warpgroup wg owns rows m0 + 64 wg .. + 63 of each tile
    regs_alloc<kConsumerRegs>();
    const int warp = t >> 5, lane = t & 31, g = lane >> 2, q = lane & 3;
    const int c = threadIdx.x;      // 0..255 over the consumers
    const bool vec = (N & 1) == 0;  // the pair at an even column is 8- / 4-byte aligned
    // the warpgroup's 64 A rows (K-major) or its 64-wide M slab (M-major): 8 KB in
    const unsigned a_base = smem_u32(As) + wg * 64 * kBK * 2;
    const unsigned b_base = smem_u32(Bs);
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int m0, n0, mt, z, kb, ke;
      grid.at(tile, m0, n0, mt, z, kb, ke);
      // the tile's bias columns into shared memory (once both warpgroups are past the
      // last tile's epilogue), its res or aux pairs into registers
      bar_sync(256);
      if (epi.bias != nullptr && c < kBN) sbias[c] = n0 + c < N ? epi.bias[n0 + c] : 0.f;
      __nv_bfloat162 side[16][2];
      load_side<__nv_bfloat16, EPI>(side, epi, vec, M, N, m0, n0, wg, warp, g, q);
      bar_sync(256);  // sbias is written

      float acc[64];
#pragma unroll
      for (int r = 0; r < 64; ++r) acc[r] = 0.f;
      for (int kt = kb; kt < ke; ++kt, ++it) {
        const int s = it % kStages;
        mbar_wait(&full[s], (it / kStages) & 1);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          const unsigned a = a_base + s * kAStage * 2;
          const unsigned b = b_base + s * kBStage * 2;
          const uint64_t da = kAm ? wgmma_desc(a + kk * 2048, 8192, 1024)
                                  : wgmma_desc(a + kk * 32, 16, 1024);
          const uint64_t db = kBn ? wgmma_desc(b + kk * 2048, 8192, 1024)
                                  : wgmma_desc(b + kk * 32, 16, 1024);
          wgmma_m64n128k16<kAm, kBn>(acc, da, db);
        }
        wgmma_commit();
        fence_regs(acc);
        wgmma_wait<0>();
        fence_regs(acc);
        if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with stage s
      }
      store_tile<__nv_bfloat16, OutT, EPI>(acc, side, epi, out + static_cast<size_t>(z) * M * N,
                                           sbias, red, vec, M, N, m0, n0, mt, wg, warp, g, q);
    }
  }
}

// The TF32 hi / lo halves of this thread's A fragments for the 8-deep k-slices 2 h
// and 2 h + 1 of a stage's A tile `a` (128 rows x 32 k of f32, 128-byte swizzled):
// K-major, rows of 32 k; or (kAm, TN) M-major, four 32-wide M slabs of 32 k-rows.
// Element i of slice 2 h + j is (row 64 wg + 16 warp + g + 8 (i % 2), k 8 (2 h + j) + q
// + 4 (i / 2)) (wgmma_m64n128k8_tf32's A fragment); both layouts read it without bank
// conflicts but for the M-major's two-way ones.
template <bool kAm>
__device__ __forceinline__ void load_a_split(const float* a, int wg, int warp, int g, int q, int h,
                                             unsigned (&hi)[2][4], unsigned (&lo)[2][4]) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = wg * 64 + warp * 16 + g + 8 * (i & 1);
      const int k = 8 * (2 * h + j) + q + 4 * (i >> 1);
      float x;
      if (kAm) {
        const int mm = r & 31;
        x = a[(r >> 5) * 1024 + k * 32 + ((((mm >> 2) ^ (k & 7))) << 2) + (mm & 3)];
      } else {
        x = a[r * 32 + (((k >> 2) ^ (r & 7)) << 2) + (k & 3)];
      }
      hi[j][i] = tf32_rna(x);
      lo[j][i] = tf32_rna(__fsub_rn(x, __uint_as_float(hi[j][i])));
    }
}

// (iii) The f32 GEMM as three TF32 products (see the header): the bf16 kernel's ring,
// tile walk and epilogue; B from its two planes (N, K) hi and lo, A split in registers.
// The tensor cores round each product's f32 sum toward zero, a bias of half a unit of
// the sum's last place a wgmma, which over K / 8 x 3 wgmma into one sum (1,092 at K =
// 2912) grows with K to several times f32's error. So a k-step's twelve wgmma (k-slices
// 0-3: a_lo b_hi, a_hi b_lo, a_hi b_hi each) start a fresh sum `part` (the first with
// scale-d 0), in two halves committed as one group each (the second half's loads and
// splits overlap the first's products), and part is added to the tile's sums `acc`
// with an IEEE add once both groups are done: the truncation then falls on a 32-deep
// partial sum, of random sign from one k-step to the next. The next k-step's first
// half of A is loaded and split once the first half's group is done, under the second
// half's products.
template <int L, int EPI>
__global__ void __launch_bounds__(kGemmThreads, 1) gemm_f32_wgmma_kernel(
    const __grid_constant__ CUtensorMap tma_a, const __grid_constant__ CUtensorMap tma_bh,
    const __grid_constant__ CUtensorMap tma_bl, float* __restrict__ out, Epi epi, int M, int N,
    TileGrid grid) {
  constexpr bool kAm = L == kTN;  // A stored (K, M): M-major
  constexpr int kAStage = kBM * kFK, kBStage = kBN * kFK;  // elements
  constexpr unsigned kTxBytes = (kAStage + 2 * kBStage) * 4;  // the full boxes, edges too
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* As = reinterpret_cast<float*>(base);
  float* Bh = As + kStages * kAStage;
  float* Bl = Bh + kStages * kBStage;
  uint64_t* full = reinterpret_cast<uint64_t*>(Bl + kStages * kBStage);
  uint64_t* empty = full + kStages;
  float* red = reinterpret_cast<float*>(empty + kStages);
  float* sbias = red + 8 * kBN;
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int tiles = grid.count();
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    regs_dealloc<kProducerRegs>();
    if (t == 0)
      produce_ring<kStages>(grid, tiles, full, empty, kTxBytes, [&](int s, int m0, int n0, int kt) {
        const int k0 = kt * kFK;
        float* a = As + s * kAStage;
        if (kAm) {  // four 32-wide M slabs of 32 K-rows
#pragma unroll
          for (int j = 0; j < kBM / 32; ++j)
            tma_load_2d(a + j * 32 * kFK, &tma_a, &full[s], m0 + 32 * j, k0);
        } else {  // 128 rows of 32 K
          tma_load_2d(a, &tma_a, &full[s], k0, m0);
        }
        tma_load_2d(Bh + s * kBStage, &tma_bh, &full[s], k0, n0);
        tma_load_2d(Bl + s * kBStage, &tma_bl, &full[s], k0, n0);
      });
  } else {
    regs_alloc<kConsumerRegs>();
    const int warp = t >> 5, lane = t & 31, g = lane >> 2, q = lane & 3;
    const int c = threadIdx.x;
    const bool vec = (N & 1) == 0;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int m0, n0, mt, z, kb, ke;
      grid.at(tile, m0, n0, mt, z, kb, ke);
      bar_sync(256);
      if (epi.bias != nullptr && c < kBN) sbias[c] = n0 + c < N ? epi.bias[n0 + c] : 0.f;
      bar_sync(256);

      float acc[64], part[64];
#pragma unroll
      for (int r = 0; r < 64; ++r) acc[r] = part[r] = 0.f;
      // the first half of the next k-step's A fragments, loaded ahead
      unsigned nhi[2][4], nlo[2][4];
      if (kb < ke) {
        const int s = it % kStages;
        mbar_wait(&full[s], (it / kStages) & 1);
        load_a_split<kAm>(As + s * kAStage, wg, warp, g, q, 0, nhi, nlo);
      }
      for (int kt = kb; kt < ke; ++kt, ++it) {
        const int s = it % kStages;
        const float* a = As + s * kAStage;
        const unsigned bh = smem_u32(Bh + s * kBStage), bl = smem_u32(Bl + s * kBStage);
        unsigned ahi[2][4], alo[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (h == 1) load_a_split<kAm>(a, wg, warp, g, q, 1, ahi, alo);
          fence_regs(part);
          wgmma_fence();
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int kk = 2 * h + j;
            const unsigned(&hi)[4] = h == 0 ? nhi[j] : ahi[j];
            const unsigned(&lo)[4] = h == 0 ? nlo[j] : alo[j];
            const uint64_t dh = wgmma_desc(bh + kk * 32, 16, 1024);
            const uint64_t dl = wgmma_desc(bl + kk * 32, 16, 1024);
            wgmma_m64n128k8_tf32(part, lo, dh, kk != 0);
            wgmma_m64n128k8_tf32(part, hi, dl, 1);
            wgmma_m64n128k8_tf32(part, hi, dh, 1);
          }
          wgmma_commit();
        }
        // the first half's group is done, so its fragments may be overwritten with
        // the next k-step's while the second half's products run
        fence_regs(part);
        wgmma_wait<1>();
        fence_regs(part);
        if (kt + 1 < ke) {
          const int s1 = (it + 1) % kStages;
          mbar_wait(&full[s1], ((it + 1) / kStages) & 1);
          load_a_split<kAm>(As + s1 * kAStage, wg, warp, g, q, 0, nhi, nlo);
        }
        wgmma_wait<0>();
        fence_regs(part);
        if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with stage s
#pragma unroll
        for (int r = 0; r < 64; ++r) acc[r] = __fadd_rn(acc[r], part[r]);
      }
      // the epilogue's res or aux pairs, read after the main loop (its registers hold
      // part): their latency is not hidden
      float2 side[16][2];
      load_side<float, EPI>(side, epi, vec, M, N, m0, n0, wg, warp, g, q);
      store_tile<float, float, EPI>(acc, side, epi, out + static_cast<size_t>(z) * M * N, sbias,
                                    red, vec, M, N, m0, n0, mt, wg, warp, g, q);
    }
  }
}

// The B planes of the f32 GEMM: hi = rna_tf32(b), lo = rna_tf32(b - hi), each (N, kp)
// K-major, from b stored (N, K) (kT false: NT's weight) or (K, N) (kT: NN's weight, TN's
// gradient), transposed through a 32 x 32 shared-memory tile so that both the reads and
// the writes are 128-byte rows. Columns K .. kp - 1 are not written (TMA never reads
// them).
template <bool kT>
__global__ void __launch_bounds__(256) tf32_planes_kernel(const float* __restrict__ b,
                                                          float* __restrict__ hi,
                                                          float* __restrict__ lo, int N, int K,
                                                          int kp) {
  __shared__ float tile[32][33];
  const int k0 = blockIdx.x * 32, n0 = blockIdx.y * 32, tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  if (kT) {
    for (int i = ty; i < 32; i += 8) {
      const int k = k0 + i, n = n0 + tx;
      tile[i][tx] = k < K && n < N ? b[static_cast<size_t>(k) * N + n] : 0.f;
    }
    __syncthreads();
  }
  for (int i = ty; i < 32; i += 8) {
    const int n = n0 + i, k = k0 + tx;
    if (n >= N || k >= K) continue;
    const float x = kT ? tile[tx][i] : b[static_cast<size_t>(n) * K + k];
    const unsigned h = tf32_rna(x);
    const size_t o = static_cast<size_t>(n) * kp + k;
    hi[o] = __uint_as_float(h);
    lo[o] = __uint_as_float(tf32_rna(__fsub_rn(x, __uint_as_float(h))));
  }
}

// (iv) LayerNorm backward rows (kernels/linear._ln_bwd_rows): for the rows of x with
// f32 dy = dL/dy, dx = (dy s - mean(dy s) - xhat mean(dy s xhat)) rstd (+ res) in x's
// dtype; xhat and rstd are recomputed from x (row_ln_stats). One warp per row, rows
// strided over a fixed grid; the column sums of dy * xhat, dy (and res) over this
// block's rows go to part[(o, block, D)] for the colsum pass.
constexpr int kLnBwdMaxD = 1024;

template <typename T, int DPL>
__global__ void __launch_bounds__(256) ln_bwd_rows_kernel(
    const T* __restrict__ x, const float* __restrict__ s, const float* __restrict__ dy,
    const T* __restrict__ res, T* __restrict__ dx, float* __restrict__ part, int R, int D) {
  __shared__ float red[8][kLnBwdMaxD];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float as[DPL], ab[DPL], ar[DPL];
#pragma unroll
  for (int e = 0; e < DPL; ++e) as[e] = ab[e] = ar[e] = 0.f;
  for (long row = blockIdx.x * 8L + warp; row < R; row += gridDim.x * 8L) {
    const T* xr = x + row * D;
    const float* gr = dy + row * D;
    float mean, rstd;
    row_ln_stats(xr, D, lane, mean, rstd);
    float a1 = 0.f, a2 = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const int d = lane + 32 * e;
      if (d < D) {
        const float xh = __fmul_rn(to_f(xr[d]) - mean, rstd);
        const float dxh = __fmul_rn(gr[d], s[d]);
        a1 += dxh;
        a2 += __fmul_rn(dxh, xh);
      }
    }
    const float m1 = warp_sum(a1) / D, m2 = warp_sum(a2) / D;
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const int d = lane + 32 * e;
      if (d < D) {
        const float xh = __fmul_rn(to_f(xr[d]) - mean, rstd);
        const float g = gr[d];
        float v = __fmul_rn(__fsub_rn(__fsub_rn(__fmul_rn(g, s[d]), m1), __fmul_rn(xh, m2)), rstd);
        if (res != nullptr) {
          const float r = to_f(res[row * D + d]);
          v = __fadd_rn(v, r);
          ar[e] += r;
        }
        dx[row * D + d] = from_f<T>(v);
        as[e] += __fmul_rn(g, xh);
        ab[e] += g;
      }
    }
  }
  const int nout = res != nullptr ? 3 : 2;
  for (int o = 0; o < nout; ++o) {
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const int d = lane + 32 * e;
      if (d < D) red[warp][d] = o == 0 ? as[e] : (o == 1 ? ab[e] : ar[e]);
    }
    __syncthreads();
    for (int d = tid; d < D; d += 256) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) v += red[w][d];
      part[(static_cast<size_t>(o) * gridDim.x + blockIdx.x) * D + d] = v;
    }
    __syncthreads();
  }
}

// (v) out[o, n] = sum_p part[o, p, n] in p order (the second pass of every column sum).
__global__ void __launch_bounds__(256) colsum_kernel(const float* __restrict__ part, int nout,
                                                     int P, int N, float* __restrict__ out) {
  const long i = blockIdx.x * 256L + threadIdx.x;
  if (i >= static_cast<long>(nout) * N) return;
  const int o = static_cast<int>(i / N), n = static_cast<int>(i % N);
  const float* p = part + static_cast<size_t>(o) * P * N + n;
  float v = 0.f;
  for (int j = 0; j < P; ++j) v += p[static_cast<size_t>(j) * N];
  out[i] = v;
}


// The TMA map of a row-major (rows, cols) matrix of T (bf16 or f32) with rows ld
// elements apart, in boxes of 128 bytes x box_rows rows (wgmma.cuh's tile_map).
template <typename T>
bool tile_map_of(CUtensorMap* map, const void* base, int rows, int cols, long ld, int box_rows) {
  if (std::is_same<T, float>::value)
    return tile_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, base, rows, cols, ld, box_rows);
  return tile_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, rows, cols, ld, box_rows);
}

// One GEMM's operands: a as stored, and b as stored (bf16) or the B planes (f32: hi
// (N, kp), then lo), with the epilogue and the stream.
struct GemmArgs {
  const void* a;
  const void* b;
  Epi epi;
  int M, N, K, kp;
  cudaStream_t st;
};

// A persistent launch of kern over grid's tiles, one block an SM at most, with smem
// bytes of dynamic shared memory (allowed once per kernel by its caller: attr).
template <typename Kern, typename... Args>
int launch_tiles(Kern kern, cudaError_t attr, int smem, const TileGrid& grid, cudaStream_t st,
                 Args... args) {
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int tiles = grid.tn * grid.tm * grid.splits;
  if (tiles == 0) return 0;
  kern<<<tiles < sm_count() ? tiles : sm_count(), kGemmThreads, smem, st>>>(args..., grid);
  return 0;
}

template <typename T, int L, typename OutT, int EPI>
int launch_one(const GemmArgs& g, void* out, int splits, int kslice) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int bk = kF32 ? kFK : kBK;
  const TileGrid grid{(g.N + kBN - 1) / kBN, (g.M + kBM - 1) / kBM, splits, kslice,
                      (g.K + bk - 1) / bk};
  CUtensorMap ma, mb, ml;
  const bool a_ok = L == kTN ? tile_map_of<T>(&ma, g.a, g.K, g.M, g.M, kF32 ? 32 : 64)
                             : tile_map_of<T>(&ma, g.a, g.M, g.K, g.K, kBM);
  if (!a_ok || sm_count() < 1) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (kF32) {
    const float* hi = static_cast<const float*>(g.b);
    if (!tile_map_of<float>(&mb, hi, g.N, g.K, g.kp, kBN) ||
        !tile_map_of<float>(&ml, hi + static_cast<size_t>(g.N) * g.kp, g.N, g.K, g.kp, kBN))
      return static_cast<int>(cudaErrorInvalidValue);
    auto kern = gemm_f32_wgmma_kernel<L, EPI>;
    static const cudaError_t attr =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kF32Smem);
    return launch_tiles(kern, attr, kF32Smem, grid, g.st, ma, mb, ml, static_cast<float*>(out),
                        g.epi, g.M, g.N);
  } else {
    if (!(L == kNT ? tile_map_of<T>(&mb, g.b, g.N, g.K, g.K, kBN)
                   : tile_map_of<T>(&mb, g.b, g.K, g.N, g.N, 64)))
      return static_cast<int>(cudaErrorInvalidValue);
    auto kern = gemm_bf16_wgmma_kernel<L, OutT, EPI>;
    static const cudaError_t attr =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kGemmSmem);
    return launch_tiles(kern, attr, kGemmSmem, grid, g.st, ma, mb, static_cast<OutT*>(out), g.epi,
                        g.M, g.N);
  }
}

// The GELU-backward epilogue exists for the NT layout with an output in the input
// dtype only (ln_ff_residual_bwd's dh1), the stash for NN with an output in the input
// dtype only (ln_ff_residual_h1's fc1); split-K (splits > 1 slices of kslice k-tiles,
// f32 partials in ws, kernels/linear.plan_splitk) for an f32 output without epilogue
// only (the weight gradients); f32 inputs give an f32 output; other combinations are
// refused.
template <typename T, int L>
int launch_gemm(const GemmArgs& g, void* out, int out_f32, int mode, int splits, int kslice,
                void* ws) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  const int nk = (g.K + (kF32 ? kFK : kBK) - 1) / (kF32 ? kFK : kBK);
  const Epi& epi = g.epi;
  if (kF32 && !out_f32) return static_cast<int>(cudaErrorInvalidValue);
  if (splits > 1) {
    const long n = static_cast<long>(g.M) * g.N;
    if (mode != kEpiStd || epi.bias != nullptr || epi.res != nullptr || epi.out2 != nullptr ||
        epi.gelu || !out_f32 || ws == nullptr || kslice < 1 || (splits - 1) * kslice >= nk ||
        splits * kslice < nk || n > 0x7fffffffL)
      return static_cast<int>(cudaErrorInvalidValue);
    const int rc = launch_one<T, L, float, kEpiStd>(g, ws, splits, kslice);
    if (rc != 0) return rc;
    colsum_kernel<<<static_cast<int>((n + 255) / 256), 256, 0, g.st>>>(
        static_cast<const float*>(ws), 1, splits, static_cast<int>(n), static_cast<float*>(out));
    return 0;
  }
  kslice = nk > 0 ? nk : 1;
  const bool out_in_dt = out_f32 == kF32;
  if (mode == kEpiGeluBwd) {
    if (L != kNT || !out_in_dt || epi.part == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_one<T, kNT, T, kEpiGeluBwd>(g, out, 1, kslice);
  }
  if (epi.out2 != nullptr) {
    if (L != kNN || !out_in_dt) return static_cast<int>(cudaErrorInvalidValue);
    return launch_one<T, kNN, T, kEpiStash>(g, out, 1, kslice);
  }
  if (out_f32) return launch_one<T, L, float, kEpiStd>(g, out, 1, kslice);
  return launch_one<T, L, T, kEpiStd>(g, out, 1, kslice);
}

template <typename T>
int launch_layout(int layout, const GemmArgs& g, void* out, int out_f32, int mode, int splits,
                  int kslice, void* ws) {
  switch (layout) {
    case kNN: return launch_gemm<T, kNN>(g, out, out_f32, mode, splits, kslice, ws);
    case kNT: return launch_gemm<T, kNT>(g, out, out_f32, mode, splits, kslice, ws);
    case kTN: return launch_gemm<T, kTN>(g, out, out_f32, mode, splits, kslice, ws);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int DPL>
void launch_ln_bwd(const void* x, const float* s, const float* dy, const void* res, void* dx,
                   float* part, int R, int D, int blocks, cudaStream_t st) {
  ln_bwd_rows_kernel<T, DPL><<<blocks, 256, 0, st>>>(static_cast<const T*>(x), s, dy,
                                                     static_cast<const T*>(res),
                                                     static_cast<T*>(dx), part, R, D);
}

template <typename T>
int launch_ln_bwd_t(const void* x, const float* s, const float* dy, const void* res, void* dx,
                    float* part, int R, int D, int blocks, cudaStream_t st) {
  const int dpl = (D + 31) / 32;
  if (dpl <= 4) launch_ln_bwd<T, 4>(x, s, dy, res, dx, part, R, D, blocks, st);
  else if (dpl <= 8) launch_ln_bwd<T, 8>(x, s, dy, res, dx, part, R, D, blocks, st);
  else if (dpl <= 16) launch_ln_bwd<T, 16>(x, s, dy, res, dx, part, R, D, blocks, st);
  else if (dpl <= 24) launch_ln_bwd<T, 24>(x, s, dy, res, dx, part, R, D, blocks, st);
  else if (dpl <= 32) launch_ln_bwd<T, 32>(x, s, dy, res, dx, part, R, D, blocks, st);
  else return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace istvt

using namespace istvt;

extern "C" {

// x (R, D) -> y (R, D), both in dtype x_dt (0 f32, 1 bf16); s, b f32 (D,).
int istvt_ln_rows(const void* x, int x_dt, const void* s, const void* b, void* y, int R, int D,
                  void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const int blocks = (R + 7) / 8;
  auto S = static_cast<const float*>(s);
  auto B = static_cast<const float*>(b);
  if (x_dt == kBF16)
    ln_rows_kernel<__nv_bfloat16><<<blocks, 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), S, B, static_cast<__nv_bfloat16*>(y), R, D);
  else
    ln_rows_kernel<float><<<blocks, 256, 0, st>>>(static_cast<const float*>(x), S, B,
                                                  static_cast<float*>(y), R, D);
  return static_cast<int>(cudaGetLastError());
}

// out (M, N) = epilogue(A @ B), f32 accumulation. a, b in dtype dt (0 f32, 1 bf16),
// row-major, 16-byte aligned, laid out as `layout` says (0 NN: a (M, K), b (K, N);
// 1 NT: a (M, K), b (N, K); 2 TN: a (K, M), b (K, N)); every operand's contiguous
// extent a multiple of 8 (checked by the caller). out in dt, or f32 when out_f32 (bf16
// inputs; f32 inputs always give f32). Epilogue `mode` 0: + bias (f32 (N,), or null),
// pre-activation -> out2 (dt, or null; layout NN, out in dt only), tanh-GELU if gelu,
// + res (dt, or null);
// mode 1 (layout NT, out in dt only): acc * gelu'(aux), gelu(aux) -> out2, with aux,
// out2 (M, N) in dt, and part (f32 (ceil(M / 128), N)) the per-128-row column sums of
// the f32 result. splits > 1 (out f32, mode 0 without bias, res, gelu or out2): K is
// cut into `splits` slices of `kslice` k-tiles (64 deep for bf16, 32 for f32; the last
// slice shorter), each slice's product goes to its (M, N) f32 partial in ws (splits, M,
// N), and the partials are added into out in slice order; with splits = 1 kslice and ws
// are not read. f32 inputs also take `planes`, f32 (2, N, kp) with kp = K rounded up to
// a multiple of 4: the TF32 hi and lo planes of B, written here before the GEMM.
int istvt_gemm(const void* a, const void* b, int dt, int layout, void* out, int out_f32,
               const void* bias, const void* res, int gelu, void* out2, const void* aux,
               void* part, int mode, int M, int N, int K, int splits, int kslice, void* ws,
               void* planes, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const Epi epi{static_cast<const float*>(bias), res, out2, aux, static_cast<float*>(part),
                gelu};
  if (splits < 1 || layout < kNN || layout > kTN) return static_cast<int>(cudaErrorInvalidValue);
  int rc;
  if (dt == kBF16) {
    rc = launch_layout<__nv_bfloat16>(layout, GemmArgs{a, b, epi, M, N, K, K, st}, out, out_f32,
                                      mode, splits, kslice, ws);
  } else {
    if (planes == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const int kp = (K + 3) & ~3;
    auto hi = static_cast<float*>(planes);
    auto lo = hi + static_cast<size_t>(N) * kp;
    auto B = static_cast<const float*>(b);
    const dim3 pg((K + 31) / 32, (N + 31) / 32);
    if (K > 0 && N > 0) {
      if (layout == kNT)
        tf32_planes_kernel<false><<<pg, 256, 0, st>>>(B, hi, lo, N, K, kp);
      else
        tf32_planes_kernel<true><<<pg, 256, 0, st>>>(B, hi, lo, N, K, kp);
    }
    rc = launch_layout<float>(layout, GemmArgs{a, planes, epi, M, N, K, kp, st}, out, out_f32,
                              mode, splits, kslice, ws);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// LayerNorm backward rows: x (R, D) in dtype dt, s f32 (D,), dy f32 (R, D), res (R, D)
// in dt or null -> dx (R, D) in dt; part f32 (2 or 3, blocks, D) the per-block column
// sums of dy * xhat, dy (and res). D <= 1024.
int istvt_ln_bwd_rows(const void* x, int dt, const void* s, const void* dy, const void* res,
                      void* dx, void* part, int R, int D, int blocks, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (D > kLnBwdMaxD) return static_cast<int>(cudaErrorInvalidValue);
  auto S = static_cast<const float*>(s);
  auto G = static_cast<const float*>(dy);
  auto P = static_cast<float*>(part);
  int rc = dt == kBF16 ? launch_ln_bwd_t<__nv_bfloat16>(x, S, G, res, dx, P, R, D, blocks, st)
                       : launch_ln_bwd_t<float>(x, S, G, res, dx, P, R, D, blocks, st);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// out (nout, N) = sum over p of part (nout, P, N), f32.
int istvt_colsum(const void* part, int nout, int P, int N, void* out, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const long n = static_cast<long>(nout) * N;
  colsum_kernel<<<static_cast<int>((n + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(part), nout, P, N, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
