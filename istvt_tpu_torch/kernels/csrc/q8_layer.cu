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
// peak); x in and out is 15 MB there. One clip's layer state (7 x 368 x 728 bf16 =
// 3.6 MiB, about 13 MB of scratch with the f32 FF hidden) does not fit the 227 KB of
// shared memory of an SM, so the TPU's one-program-per-clip design does not carry
// over. What the design does about it: one persistent cooperative kernel, as many
// blocks as fit on the card at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor x
// SMs, launched with cudaLaunchCooperativeKernel, which refuses a grid that cannot be
// co-resident rather than deadlocking), walks the layer's 14 phases; in each, every
// block strides over that phase's work items (rows, 128 x 128 GEMM tiles, temporal
// (clip, location, head) items or spatial (query tile, head, frame) tiles), and a
// grid-wide barrier (cooperative_groups::this_grid().sync()) separates one phase from
// the next. The intermediates live in a device workspace that the wrapper allocates
// (int8 codes, row scales, the packed qkv and the attention output in x's dtype, the
// 728-wide f32 stream and the f32 FF hidden, whose row scale needs the whole
// 2912-wide row before its quant pass). The workspace of a B=16 batch is 889 MB in bf16,
// far beyond the 50 MB L2, so the intermediates round-trip device memory as the chain's
// do; walking clip groups, or the FF in row chunks, so that they stay in L2 is later
// work. One
// dynamic shared-memory buffer serves the largest phase (the spatial core's: 36 KB at
// dim_head 64 in bf16, its tensor-core tile's two stages of K and V chunks; 17.5 KB in
// f32; under the 48 KB that needs no opt-in). The spatial phase walks (query tile of
// spatial_q_tile<T>(), head, frame) tiles, 128 queries in bf16 and 32 in f32. The
// kernel's registers are those of its hungriest phase; __launch_bounds__ caps them at
// 128 so that two blocks of 256 threads share an SM, as the separate kernels' blocks
// did.
#include <cooperative_groups.h>

#include "q8_attention.cuh"
#include "q8_rows_gemm.cuh"

namespace istvt {

namespace cg = cooperative_groups;

// Kernel parameters, in the order of kernels/quant._LAYER_PTRS: the input and output,
// the layer's LayerNorms, int8 weights with their column scales and biases (the
// arguments of _st_layer_q8_impl), then the workspace.
struct LayerQ8 {
  const void* x;
  void* out;
  const float *st, *bt;
  const int8_t* wqt;
  const float* wst;
  const int8_t* wot;
  const float *sot, *bot;
  const float *ss, *bs;
  const int8_t* wqs;
  const float* wss;
  const int8_t* wos;
  const float *sos, *bos;
  const float *sf, *bf;
  const int8_t* w1q;
  const float *w1s, *b1;
  const int8_t* w2q;
  const float *w2s, *b2;
  int8_t* q;      // (R, max(D, I, hid)) int8 codes of the current row pass
  float* rs;      // (R,) their row scales
  void* qkv;      // (R, 3I) x's dtype: the temporal, then the spatial qkv
  void* a;        // (R, I) x's dtype: a_t, then a_s
  float* y;       // (R, D) f32: the t-out-proj output, then the residual stream y
  float* hid;     // (R, hid) f32: the FF hidden after GELU
  int B, T1, S, D, H, inner, hdim, n_valid;
  float scale;
};
constexpr int kLayerPtrs = 30;
constexpr int kThreads = 256;

// One GEMM phase: every block strides over the 128 x 128 output tiles, the n tiles of
// one row tile on neighbouring blocks (so they share the A rows in L2).
template <typename TO, typename TR, bool GELU>
__device__ __forceinline__ void gemm_q8_phase(const int8_t* A, const int8_t* W, const float* rs,
                                              const float* ws, const float* bias,
                                              const TR* res, TO* out, int M, int N, int K,
                                              int* smem) {
  const int tn = (N + kBN - 1) / kBN, tiles = tn * ((M + kBM - 1) / kBM);
  for (int t = blockIdx.x; t < tiles; t += gridDim.x)
    gemm_q8_tile<TO, TR, GELU>(A, W, rs, ws, bias, res, out, M, N, K, t % tn, t / tn, smem);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 2) st_layer_q8_kernel(const LayerQ8 p) {
  constexpr int DPL = DH <= 32 ? 1 : DH / 32;
  extern __shared__ int4 smem_raw[];
  int* smem = reinterpret_cast<int*>(smem_raw);
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31;
  const int warp0 = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int nwarps = gridDim.x * (kThreads / 32);
  const int R = p.B * p.T1 * p.S, D = p.D, I = p.inner, I3 = 3 * p.inner, HD = p.hdim;
  const T* x = static_cast<const T*>(p.x);
  T* out = static_cast<T*>(p.out);
  T* qkv = static_cast<T*>(p.qkv);
  T* a = static_cast<T*>(p.a);
  const float* no_bias = nullptr;
  const float* no_res = nullptr;

  // --- temporal branch: LN -> int8 QKV -> self-subtract attention
  // (istvt_tpu/kernels/quant.py:720-761)
  // 1. LN + quant rows of x
  for (int r = warp0; r < R; r += nwarps) ln_quant_row(x, p.st, p.bt, p.q, p.rs, r, D, D, lane);
  grid.sync();
  // 2. QKV_t, rounded to x's dtype
  gemm_q8_phase<T, float, false>(p.q, p.wqt, p.rs, p.wst, no_bias, no_res, qkv, R, I3, D, smem);
  grid.sync();
  // 3. temporal core
  const long items = static_cast<long>(p.B) * p.S * p.H;
  for (long it = warp0; it < items; it += nwarps)
    temporal_attn_item<T, DPL>(qkv, a, p.T1, p.S, p.H, I, DH, p.scale, it, lane);
  grid.sync();
  // --- spatial branch: out-proj -> LN -> int8 QKV -> per-frame attention (:763-786)
  // 4. quant rows of a_t
  for (int r = warp0; r < R; r += nwarps) quant_row(a, p.q, p.rs, r, I, I, lane);
  grid.sync();
  // 5. out-proj_t + b into the f32 y
  gemm_q8_phase<float, float, false>(p.q, p.wot, p.rs, p.sot, p.bot, no_res, p.y, R, D, I, smem);
  grid.sync();
  // 6. LN + quant rows of y
  for (int r = warp0; r < R; r += nwarps)
    ln_quant_row<float>(p.y, p.ss, p.bs, p.q, p.rs, r, D, D, lane);
  grid.sync();
  // 7. QKV_s, rounded to x's dtype
  gemm_q8_phase<T, float, false>(p.q, p.wqs, p.rs, p.wss, no_bias, no_res, qkv, R, I3, D, smem);
  grid.sync();
  // 8. spatial core: masked softmax over n_valid keys, P cast to x's dtype before PV
  constexpr int QT = spatial_q_tile<T>();
  const int nqt = (p.S + QT - 1) / QT, s_tiles = nqt * p.H * p.B * p.T1;
  for (int t = blockIdx.x; t < s_tiles; t += gridDim.x)
    spatial_attn_tile<T, DH>(qkv, a, p.S, I, p.n_valid, p.scale, t % nqt, (t / nqt) % p.H,
                             t / (nqt * p.H), reinterpret_cast<float*>(smem));
  grid.sync();
  // --- out-proj + residual -> PreNorm fully-int8 FF (:788-833)
  // 9. quant rows of a_s
  for (int r = warp0; r < R; r += nwarps) quant_row(a, p.q, p.rs, r, I, I, lane);
  grid.sync();
  // 10. out-proj_s + b + x into the f32 y
  gemm_q8_phase<float, T, false>(p.q, p.wos, p.rs, p.sos, p.bos, x, p.y, R, D, I, smem);
  grid.sync();
  // 11. LN + quant rows of y
  for (int r = warp0; r < R; r += nwarps)
    ln_quant_row<float>(p.y, p.sf, p.bf, p.q, p.rs, r, D, D, lane);
  grid.sync();
  // 12. fc1 + b1 -> tanh-GELU, f32
  gemm_q8_phase<float, float, true>(p.q, p.w1q, p.rs, p.w1s, p.b1, no_res, p.hid, R, HD, D,
                                    smem);
  grid.sync();
  // 13. quant rows of the hidden (each needs its whole row: after the barrier)
  for (int r = warp0; r < R; r += nwarps) quant_row<float>(p.hid, p.q, p.rs, r, HD, HD, lane);
  grid.sync();
  // 14. fc2 + b2 + y, one rounding to x's dtype
  gemm_q8_phase<T, float, false>(p.q, p.w2q, p.rs, p.w2s, p.b2, p.y, out, R, D, HD, smem);
}

template <typename T, int DH>
int launch_layer(const LayerQ8& p, cudaStream_t st) {
  auto kern = st_layer_q8_kernel<T, DH>;
  constexpr int smem_bytes = 4 * kGemmSmemInts > spatial_smem_bytes<T>(DH)
                                 ? 4 * kGemmSmemInts
                                 : spatial_smem_bytes<T>(DH);
  static_assert(smem_bytes <= 48 * 1024, "above 48 KB needs cudaFuncSetAttribute");
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  LayerQ8 params = p;
  void* args[] = {&params};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern), dim3(per_sm * sms),
                                  dim3(kThreads), args, smem_bytes, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// dim_head 64 (the model's) and 16 (the small test geometry): each
// instantiation of the whole layer adds to the build.
template <typename T>
int launch_layer_dh(const LayerQ8& p, cudaStream_t st) {
  switch (p.inner / p.H) {
    case 16: return launch_layer<T, 16>(p, st);
    case 64: return launch_layer<T, 64>(p, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace istvt

using namespace istvt;

extern "C" {

// ptrs: kLayerPtrs device pointers in LayerQ8's order (kernels/quant._LAYER_PTRS);
// x (B, T1, S, D) and out (not aliasing x) in dtype dt (0 f32, 1 bf16); T1 <= 8,
// S <= 384, inner / H in {16, 64}, D, 3 inner and hdim divisible by 4.
int istvt_st_layer_q8(const void* const* ptrs, int dt, int B, int T1, int S, int D, int H,
                      int inner, int hdim, int n_valid, float scale, void* stream) {
  int i = 0;
  auto F = [&]() { return static_cast<const float*>(ptrs[i++]); };
  auto Q = [&]() { return static_cast<const int8_t*>(ptrs[i++]); };
  LayerQ8 p;
  p.x = ptrs[i++];
  p.out = const_cast<void*>(ptrs[i++]);
  p.st = F(); p.bt = F(); p.wqt = Q(); p.wst = F();
  p.wot = Q(); p.sot = F(); p.bot = F();
  p.ss = F(); p.bs = F(); p.wqs = Q(); p.wss = F();
  p.wos = Q(); p.sos = F(); p.bos = F();
  p.sf = F(); p.bf = F(); p.w1q = Q(); p.w1s = F(); p.b1 = F();
  p.w2q = Q(); p.w2s = F(); p.b2 = F();
  p.q = const_cast<int8_t*>(Q());
  p.rs = const_cast<float*>(F());
  p.qkv = const_cast<void*>(ptrs[i++]);
  p.a = const_cast<void*>(ptrs[i++]);
  p.y = const_cast<float*>(F());
  p.hid = const_cast<float*>(F());
  if (i != kLayerPtrs) return static_cast<int>(cudaErrorInvalidValue);
  p.B = B; p.T1 = T1; p.S = S; p.D = D; p.H = H; p.inner = inner; p.hdim = hdim;
  p.n_valid = n_valid; p.scale = scale;
  auto st = static_cast<cudaStream_t>(stream);
  return dt == kBF16 ? launch_layer_dh<__nv_bfloat16>(p, st) : launch_layer_dh<float>(p, st);
}

}  // extern "C"
