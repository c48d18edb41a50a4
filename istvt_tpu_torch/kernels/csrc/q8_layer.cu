// One whole int8 ST layer (temporal attention -> spatial attention -> PreNorm FF, with
// every residual) in one launch: kernels/quant.st_layer_q8.
//
// Replaces istvt_tpu/kernels/quant.py _st_layer_q8_kernel (#9, _st_layer_q8_impl),
// the TPU's whole-layer kernel: one program per clip, its (7, 368, 512 or 1536)
// intermediates in VMEM, only x entering and leaving device memory. Its quantization
// points are those of the ingest chain (#1 -> #2 -> #3), and so are this kernel's: it
// runs the same device code (q8_rows_gemm.cuh, q8_attention.cuh) in the same order, so
// on the same inputs its output equals that chain's bit for bit.
//
// What bounds it on the H100: the int8 GEMMs (2 * rows * (728 * 1536 * 2 + 512 * 728 *
// 2 + 728 * 2912 * 2) operations, 74 G at the 2-clip slice, 0.038 ms at the int8
// peak; 0.30 ms at B=16); x in and out is 15 MB there. One clip's layer state (7 x 368
// x 728 bf16 = 3.6 MiB, about 13 MB of scratch with the f32 FF hidden) does not fit
// the 227 KB of shared memory of an SM, so the TPU's one-program-per-clip design does
// not carry over. What the design does about it: one persistent cooperative kernel, one
// block of 384 threads on each SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor x
// SMs, launched with cudaLaunchCooperativeKernel, which refuses a grid that cannot be
// co-resident rather than deadlocking), walks the layer's 14 phases; in each, every
// block strides over that phase's work items (rows, 128 x 128 GEMM tiles, the
// temporal core's threads (L lanes a head of a (clip, location), temporal.cuh) or
// spatial (query tile, head, frame) tiles), and a
// grid-wide barrier (cooperative_groups::this_grid().sync()) separates one phase from
// the next. The intermediates live in a device workspace that the wrapper allocates
// (int8 codes, row scales, the packed qkv and the attention output in x's dtype, the
// 728-wide f32 stream and the f32 FF hidden, whose row scale needs the whole
// 2912-wide row before its quant pass). The workspace of a B=16 batch is 889 MB in
// bf16, far beyond the 50 MB L2, so the intermediates round-trip device memory as the
// chain's do; walking clip groups, or the FF in row chunks, so that they stay in L2 is
// later work.
//
// The six GEMM phases run the standalone int8 GEMM's body (gemm_q8_tiles,
// q8_rows_gemm.cuh; gemm_q8_wgmma_kernel launches the same code): warpgroups 0-1
// consume, running s8 wgmma m64n128k32 straight from shared memory, and one thread of
// warpgroup 2 feeds them A and W by TMA (128-byte swizzle) through a 4-stage mbarrier
// ring, with the same epilogue in the same order. So the block is the GEMM's, 384
// threads, and its dynamic shared memory the GEMM's kQSmem (133 KB, opted in with
// cudaFuncSetAttribute), whose ring region also holds the spatial phase's tile (36 KB
// at dim_head 64 in bf16, 98 KB in f32). What that takes inside one launch:
//   * the ring: each GEMM phase initialises the ring's barriers anew, after thread 0
//     has invalidated the last phase's (every thread has left them behind a grid
//     barrier), so the stage and parity counters start at 0 in every phase and a
//     block with no tile in a phase leaves nothing behind;
//   * the proxies: the row passes write the int8 codes with ordinary stores and the
//     next GEMM phase reads them by TMA (the async proxy), which a grid barrier alone
//     does not order: each writer fences (fence.proxy.async.global) before the
//     barrier, and every thread again before the GEMM; the spatial phase writes the
//     ring's shared memory by cp.async and ordinary stores, so it fences
//     (fence.proxy.async.shared::cta) before the next phase's TMA overwrites it;
//   * the codes: TMA wants row strides that are multiples of 16 bytes, so each row
//     pass writes its codes with rows padded_k(K) bytes apart (736 for K = 728) and the
//     tensor maps' K extent stays K (the pad is never read); the weights are read as
//     their K-major copies (quant.kmajor), nine tensor maps encoded on the host per
//     call and passed as one __grid_constant__ parameter;
//   * the spatial phase: all 12 warps of the block run one tile (LayerTile: 192
//     queries, 128 in the standalone kernels' 256-thread blocks; a row's bits are the
//     same in both), so that the one block an SM keeps as many warps at it as the
//     standalone blocks did; the row phases stride over all 12 warps, the temporal
//     phase over all 384 threads (the standalone kernel's layout and arithmetic, so
//     its a_t equals #1's bit for bit);
//   * registers: the kernel runs at the launch budget of 168 a thread (384 threads, one
//     block an SM) in every phase, GEMM included, without setmaxnreg (the phases
//     reconverge at every grid barrier; measured, moving registers to the consumers
//     and back around each GEMM phase spilled more, not less), and ptxas must report
//     no spill: so a consumer loads its residual after the main loop rather than
//     holding it in 32 or 64 registers through it (LayerRegs::kHoldRes; held, the bf16
//     instantiations spilled 12-24 bytes), in two halves, each before the next store
//     (read between the stores, each waited for the last: phase 10 took 2.8x the
//     standalone GEMM's time); and the loop bounds come from the parameter bank (in a
//     register, the spatial loop's spilled).
// Measured on an H100 80GB HBM3 at 700 W (PERF.md §6): 3.48 ms a layer at B=16 in
// bf16 (5.5-5.6 with the mma.sync GEMM tiles this design replaced; the #1 -> #2 -> #3
// chain's kernels take about 2.7), its GEMM phases at the standalone GEMM's time, its
// row passes at 1.8x the standalone row kernels' (12 warps an SM keep too few loads
// in flight), the spatial phase 1.2x the standalone core's. Left out: setmaxnreg
// around the GEMM phases (spilled more), the spatial tile on 8 of the 12 warps (0.65
// ms against 0.52 at B=16).
// The STAMP instantiation (tools/kernel_ms.py --layer-phases; never on a model path)
// has block 0 write %globaltimer at its start and after every grid barrier, with one
// more barrier after phase 14, so that stamps[k] - stamps[k - 1] is phase k's time.
#include <cooperative_groups.h>

#include "q8_attention.cuh"
#include "q8_rows_gemm.cuh"

namespace istvt {

namespace cg = cooperative_groups;

// Kernel parameters: the input and output, the layer's LayerNorms, column scales and
// biases (the arguments of _st_layer_q8_impl; its int8 weights reach the kernel as
// tensor maps, LayerMaps), then the workspace and the geometry.
struct LayerQ8 {
  const void* x;
  void* out;
  const float *st, *bt, *wst;
  const float *sot, *bot;
  const float *ss, *bs, *wss;
  const float *sos, *bos;
  const float *sf, *bf, *w1s, *b1;
  const float *w2s, *b2;
  int8_t* q;      // int8 codes of the current row pass, rows ldd / ldi / ldh bytes apart
  float* rs;      // (R,) their row scales
  void* qkv;      // (R, 3I) x's dtype: the temporal, then the spatial qkv
  void* a;        // (R, I) x's dtype: a_t, then a_s
  float* y;       // (R, D) f32: the t-out-proj output, then the residual stream y
  float* hid;     // (R, hid) f32: the FF hidden after GELU
  unsigned long long* stamps;  // 15 %globaltimer ns: the start, each phase's end (STAMP)
  int B, T1, S, D, H, inner, hdim, n_valid;
  int ldd, ldi, ldh;  // padded_k of D, inner and hdim: the codes' row strides
  // loop bounds, read from the parameter bank where they are compared (so that they
  // hold no register through the phases): the rows B T1 S, and the spatial phase's
  // query tiles per (frame, head) and tiles in all
  int rows, s_nqt, s_tiles;
  float scale;
};

// The GEMM phases' tensor maps: the codes as A at K = D, inner and hdim, and the six
// K-major weights (quant.kmajor) in _st_layer_q8_impl's order.
struct alignas(64) LayerMaps {
  CUtensorMap a_d, a_i, a_h, wqt, wot, wqs, wos, w1, w2;
};

constexpr int kLayerPtrs = 30;
constexpr int kLayerWarps = kQThreads / 32;
using LayerTile = TileThreads<kQThreads>;  // the spatial phase: every thread of the block

// Registers in the GEMM phases: the launch budget kept, the residual loaded after the
// main loop (see the header).
struct LayerRegs {
  static constexpr bool kHoldRes = false;
  static __device__ __forceinline__ void producer() {}
  static __device__ __forceinline__ void consumer() {}
};

__device__ __forceinline__ unsigned long long globaltimer_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// One GEMM phase: out (M, N) = epilogue(codes (M, K) @ W^T) on a fresh ring (`first`:
// no earlier phase left barriers to invalidate).
template <typename TO, typename TR, bool GELU>
__device__ __forceinline__ void gemm_phase(const CUtensorMap* ma, const CUtensorMap* mw,
                                           const float* rs, const float* ws, const float* bias,
                                           const TR* res, TO* out, int M, int N, int K,
                                           unsigned char* smem_raw, bool first) {
  if (!first && threadIdx.x == 0) {
    uint64_t* bars = q8_ring_barriers(q8_smem_base(smem_raw));
    for (int s = 0; s < 2 * kQStages; ++s) mbar_inval(&bars[s]);
  }
  fence_proxy_async_global();  // the codes' generic writes before this phase's TMA reads
  const int nk = (K + kQBK - 1) / kQBK;
  const TileGrid tiles{(N + kTileN - 1) / kTileN, (M + kTileM - 1) / kTileM, 1, nk, nk};
  gemm_q8_tiles<TO, TR, GELU, LayerRegs>(ma, mw, rs, ws, bias, res, out, M, N, tiles, smem_raw);
}

template <typename T, int DH, bool STAMP>
__global__ void __launch_bounds__(kQThreads, 1)
    st_layer_q8_kernel(const LayerQ8 p, const __grid_constant__ LayerMaps m) {
  extern __shared__ unsigned char smem_raw[];
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31;
  const int warp0 = blockIdx.x * kLayerWarps + (threadIdx.x >> 5);
  const int nwarps = gridDim.x * kLayerWarps;
  // A row pass: f(r, lane) for each of this warp's rows. In f32 the first row, the step
  // and the lane are computed anew for each pass: held through the phases, they were
  // what ptxas spilled around the f32 spatial tile. bf16 keeps the loop it had, and
  // stamper() below its test, so that the bf16 instantiations keep their SASS
  // instruction for instruction (tools/sass_diff.py against the commit before the f32
  // tile moved to the tensor cores): that is what shows the f32 redesign moved no bf16
  // time. One body for both needs bf16 #9 timed with it (kernel_ms.py --layer-phases).
  const auto row_pass = [&](const auto& f) {
    if constexpr (std::is_same<T, float>::value) {
      const int tid = tf32_tid(), step = gridDim.x * kLayerWarps;
      for (int r = blockIdx.x * kLayerWarps + (tid >> 5); r < p.rows; r += step) f(r, tid & 31);
    } else {
      for (int r = warp0; r < p.rows; r += nwarps) f(r, lane);
    }
  };
  const int D = p.D, I = p.inner, I3 = 3 * p.inner, HD = p.hdim;
  const T* x = static_cast<const T*>(p.x);
  T* out = static_cast<T*>(p.out);
  T* qkv = static_cast<T*>(p.qkv);
  T* a = static_cast<T*>(p.a);
  const float* no_bias = nullptr;
  const float* no_res = nullptr;
  int phase = 0;
  // the thread that writes the stamps, block 0's thread 0 (in f32 found anew at each
  // stamp: held through the phases, it was what ptxas spilled around the spatial tile;
  // bf16 as before, see row_pass)
  const auto stamper = [&]() {
    if constexpr (std::is_same<T, float>::value)
      return blockIdx.x == 0 && tf32_tid() == 0;
    else
      return blockIdx.x == 0 && threadIdx.x == 0;
  };
  // the end of a phase: the grid barrier, stamped in the STAMP instantiation
  auto next_phase = [&]() {
    grid.sync();
    ++phase;
    if (STAMP && stamper()) p.stamps[phase] = globaltimer_ns();
  };
  // the end of a row pass: its codes' writes ordered before the next phase's TMA
  auto rows_written = [&]() {
    fence_proxy_async_global();
    next_phase();
  };
  if (STAMP && stamper()) p.stamps[0] = globaltimer_ns();

  // --- temporal branch: LN -> int8 QKV -> self-subtract attention
  // (istvt_tpu/kernels/quant.py:720-761)
  // 1. LN + quant rows of x
  row_pass([&](int r, int ln) { ln_quant_row(x, p.st, p.bt, p.q, p.rs, r, D, p.ldd, ln); });
  rows_written();
  // 2. QKV_t, rounded to x's dtype
  gemm_phase<T, float, false>(&m.a_d, &m.wqt, p.rs, p.wst, no_bias, no_res, qkv, p.rows, I3, D,
                              smem_raw, true);
  next_phase();
  // 3. temporal core: the standalone kernel's threads, kQThreads a block-step (the
  // loop bound is uniform in a block, so every lane of a warp runs its shuffles); past
  // kTMax frames the general lane, its slots in the FF hidden's workspace (free until
  // phase 12), thread g's at g W words, the warps' span of threads apart (a warp wholly
  // past the last thread has no slots and skips the lane: no lane of it is needed). The
  // STAMP instantiation has the register lane only (the paper's T1 = 7; with the
  // general lane too, ptxas spilled its f32 instantiation at 168 registers)
  {
    using TP = typename TemporalWide<T, DH>::Plan;
    const long total = static_cast<long>(p.B) * p.S * p.H * TP::L;
    for (long g0 = static_cast<long>(blockIdx.x) * kQThreads; g0 < total;
         g0 += static_cast<long>(gridDim.x) * kQThreads) {
      const long g = g0 + threadIdx.x;
      if (STAMP || p.T1 <= kTMax) {
        temporal_attn_lane<T, TP::V, TP::L, TP::C>(qkv, a, p.T1, p.S, p.H, I, DH, p.scale, g,
                                                   g < total);
      } else if (g0 + (threadIdx.x & ~31) < total) {
        constexpr int W = TRow<T, TP::V, TP::L, TP::C>::W;
        const TSlots sl{reinterpret_cast<uint32_t*>(p.hid) + g * W, (total + 31) / 32 * 32 * W,
                        false};
        temporal_attn_lane_any<T, TP::V, TP::L, TP::C>(qkv, a, p.T1, p.S, p.H, I, DH, p.scale,
                                                       g, g < total, sl);
      }
    }
  }
  next_phase();
  // --- spatial branch: out-proj -> LN -> int8 QKV -> per-frame attention (:763-786)
  // 4. quant rows of a_t
  row_pass([&](int r, int ln) { quant_row(a, p.q, p.rs, r, I, p.ldi, ln); });
  rows_written();
  // 5. out-proj_t + b into the f32 y
  gemm_phase<float, float, false>(&m.a_i, &m.wot, p.rs, p.sot, p.bot, no_res, p.y, p.rows, D, I,
                                  smem_raw, false);
  next_phase();
  // 6. LN + quant rows of y
  row_pass([&](int r, int ln) {
    ln_quant_row<float>(p.y, p.ss, p.bs, p.q, p.rs, r, D, p.ldd, ln);
  });
  rows_written();
  // 7. QKV_s, rounded to x's dtype
  gemm_phase<T, float, false>(&m.a_d, &m.wqs, p.rs, p.wss, no_bias, no_res, qkv, p.rows, I3, D,
                              smem_raw, false);
  next_phase();
  // 8. spatial core: masked softmax over n_valid keys, P cast to x's dtype before PV; the
  // block's 12 warps on one tile of 192 queries in the ring's memory
  for (int t = blockIdx.x; t < p.s_tiles; t += gridDim.x)
    spatial_attn_tile<T, DH, LayerTile>(qkv, a, p.S, I, p.n_valid, p.scale, t % p.s_nqt,
                                        (t / p.s_nqt) % p.H, t / (p.s_nqt * p.H),
                                        reinterpret_cast<float*>(q8_smem_base(smem_raw)));
  fence_proxy_async_shared();  // before the next GEMM phase's TMA writes the same memory
  next_phase();
  // --- out-proj + residual -> PreNorm fully-int8 FF (:788-833)
  // 9. quant rows of a_s
  row_pass([&](int r, int ln) { quant_row(a, p.q, p.rs, r, I, p.ldi, ln); });
  rows_written();
  // 10. out-proj_s + b + x into the f32 y
  gemm_phase<float, T, false>(&m.a_i, &m.wos, p.rs, p.sos, p.bos, x, p.y, p.rows, D, I, smem_raw,
                              false);
  next_phase();
  // 11. LN + quant rows of y
  row_pass([&](int r, int ln) {
    ln_quant_row<float>(p.y, p.sf, p.bf, p.q, p.rs, r, D, p.ldd, ln);
  });
  rows_written();
  // 12. fc1 + b1 -> tanh-GELU, f32
  gemm_phase<float, float, true>(&m.a_d, &m.w1, p.rs, p.w1s, p.b1, no_res, p.hid, p.rows, HD, D,
                                 smem_raw, false);
  next_phase();
  // 13. quant rows of the hidden (each needs its whole row: after the barrier)
  row_pass([&](int r, int ln) { quant_row<float>(p.hid, p.q, p.rs, r, HD, p.ldh, ln); });
  rows_written();
  // 14. fc2 + b2 + y, one rounding to x's dtype
  gemm_phase<T, float, false>(&m.a_h, &m.w2, p.rs, p.w2s, p.b2, p.y, out, p.rows, D, HD, smem_raw,
                              false);
  if (STAMP) next_phase();  // phase 14's end, for its stamp
}

template <typename T, int DH, bool STAMP>
int launch_layer(const LayerQ8& p, const LayerMaps& maps, cudaStream_t st) {
  auto kern = st_layer_q8_kernel<T, DH, STAMP>;
  static_assert(spatial_smem_bytes<T, LayerTile>(DH) <= 2 * kQStages * kQStage,
                "the spatial tile lives in the GEMM ring's stages");
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kQSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kQThreads, kQSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  if (STAMP && p.T1 > kTMax) return static_cast<int>(cudaErrorInvalidValue);
  if (p.T1 > kTMax) {
    // phase 3's slots (2 T1 rows of W words for every thread of the warps' span) in the
    // FF hidden's workspace of rows x hdim floats
    using TP = typename TemporalWide<T, DH>::Plan;
    const long total = static_cast<long>(p.B) * p.S * p.H * TP::L;
    const long words = 2L * p.T1 * ((total + 31) / 32 * 32) * TRow<T, TP::V, TP::L, TP::C>::W;
    if (words > static_cast<long>(p.rows) * p.hdim) return static_cast<int>(cudaErrorInvalidValue);
  }
  LayerQ8 params = p;
  constexpr int QT = spatial_q_tile<LayerTile>();
  params.s_nqt = (p.S + QT - 1) / QT;
  params.s_tiles = params.s_nqt * p.H * p.B * p.T1;
  LayerMaps m = maps;
  void* args[] = {&params, &m};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern), dim3(per_sm * sms),
                                  dim3(kQThreads), args, kQSmem, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// dim_head 64 (the model's) and 16 (the small test geometry): each instantiation of
// the whole layer adds to the build; the stamped one exists at 64 only.
template <typename T>
int launch_layer_dh(const LayerQ8& p, const LayerMaps& maps, cudaStream_t st) {
  switch (p.inner / p.H) {
    case 16:
      if (p.stamps != nullptr) return static_cast<int>(cudaErrorInvalidValue);
      return launch_layer<T, 16, false>(p, maps, st);
    case 64:
      return p.stamps != nullptr ? launch_layer<T, 64, true>(p, maps, st)
                                 : launch_layer<T, 64, false>(p, maps, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

inline int padded_k(int k) { return (k + 15) / 16 * 16; }

}  // namespace istvt

using namespace istvt;

extern "C" {

// ptrs: kLayerPtrs device pointers in kernels/quant._LAYER_PTRS' order, the int8
// weights as their K-major copies (quant.kmajor: (N, padded_k(K)), contiguous); x (B,
// T1, S, D) and out (not aliasing x) in dtype dt (0 f32, 1 bf16); the codes q hold B
// T1 S rows of max(padded_k(D), padded_k(inner), padded_k(hdim)) bytes; any T1 >= 2 and
// S, inner / H in {16, 64}, D, 3 inner and hdim divisible by 4 (past T1 = 8, phase 3's
// slots must fit the FF hidden's workspace, else cudaErrorInvalidValue). stamps: null, or
// 15 u64 on the card for the phase stamps (inner / H 64 and T1 <= 8 only).
int istvt_st_layer_q8(const void* const* ptrs, int dt, int B, int T1, int S, int D, int H,
                      int inner, int hdim, int n_valid, float scale, void* stamps,
                      void* stream) {
  int i = 0;
  auto F = [&]() { return static_cast<const float*>(ptrs[i++]); };
  auto W = [&]() { return ptrs[i++]; };
  LayerQ8 p;
  p.x = ptrs[i++];
  p.out = const_cast<void*>(ptrs[i++]);
  p.st = F(); p.bt = F(); const void* wqt = W(); p.wst = F();
  const void* wot = W(); p.sot = F(); p.bot = F();
  p.ss = F(); p.bs = F(); const void* wqs = W(); p.wss = F();
  const void* wos = W(); p.sos = F(); p.bos = F();
  p.sf = F(); p.bf = F(); const void* w1 = W(); p.w1s = F(); p.b1 = F();
  const void* w2 = W(); p.w2s = F(); p.b2 = F();
  p.q = static_cast<int8_t*>(const_cast<void*>(W()));
  p.rs = const_cast<float*>(F());
  p.qkv = const_cast<void*>(ptrs[i++]);
  p.a = const_cast<void*>(ptrs[i++]);
  p.y = const_cast<float*>(F());
  p.hid = const_cast<float*>(F());
  if (i != kLayerPtrs) return static_cast<int>(cudaErrorInvalidValue);
  p.stamps = static_cast<unsigned long long*>(stamps);
  p.B = B; p.T1 = T1; p.S = S; p.D = D; p.H = H; p.inner = inner; p.hdim = hdim;
  p.n_valid = n_valid; p.scale = scale;
  p.ldd = padded_k(D); p.ldi = padded_k(inner); p.ldh = padded_k(hdim);
  const int R = B * T1 * S, I3 = 3 * inner;
  p.rows = R;
  constexpr auto U8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  LayerMaps m;
  const bool mapped =
      tile_map(&m.a_d, U8, 1, p.q, R, D, p.ldd, kTileM) &&
      tile_map(&m.a_i, U8, 1, p.q, R, inner, p.ldi, kTileM) &&
      tile_map(&m.a_h, U8, 1, p.q, R, hdim, p.ldh, kTileM) &&
      tile_map(&m.wqt, U8, 1, wqt, I3, D, p.ldd, kTileN) &&
      tile_map(&m.wot, U8, 1, wot, D, inner, p.ldi, kTileN) &&
      tile_map(&m.wqs, U8, 1, wqs, I3, D, p.ldd, kTileN) &&
      tile_map(&m.wos, U8, 1, wos, D, inner, p.ldi, kTileN) &&
      tile_map(&m.w1, U8, 1, w1, hdim, D, p.ldd, kTileN) &&
      tile_map(&m.w2, U8, 1, w2, D, hdim, p.ldh, kTileN);
  if (!mapped) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  return dt == kBF16 ? launch_layer_dh<__nv_bfloat16>(p, m, st)
                     : launch_layer_dh<float>(p, m, st);
}

}  // extern "C"
