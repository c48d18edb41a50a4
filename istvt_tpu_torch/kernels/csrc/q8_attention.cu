// The attention cores of both serving paths: (iv) self-subtract temporal
// attention and (v) masked per-frame spatial attention, on packed [q | k | v]
// activations in the activation dtype, written by the W8A8 QKV GEMM
// (q8_rows_gemm.cu, int8 path) or the float GEMM (float_gemm.cu, float path).
//
// Replaces two TPU kernels of the float fused path whole
// (istvt_tpu/kernels/attention.py fused_temporal_attention_packed and
// fused_frame_attention_packed, wrapped in kernels/attention.py), and the
// attention halves of two TPU kernels in istvt_tpu/kernels/quant.py, which
// compute the same math:
//   * _ln_qkv_q8_temporal_kernel (the fori_loop over query frames): softmax
//     over the T+1 = 7 frames for every (clip, location, head), after the
//     self-subtract cat(x[:2], x[2:] - x[1:-1]) on q and k, taken in the
//     activation dtype; weights normalised by one division at the end;
//   * _mm_q8_ln_qkv_q8_spatial_kernel (_mh_attention_vmem): softmax over the
//     S = 368 tokens of each frame per head, pad keys >= n_valid masked with
//     an additive -1e30, probabilities cast to the activation dtype before
//     the PV product.
//
// What bounds them on the H100: the temporal core is tiny (7x7 scores per
// location and head) and bound by reading qkv once and writing its output once; its
// design (whole (clip, location) groups, L lanes a head on 16-byte vectors, scores
// finished on one lane by a transposed reduction) is in temporal.cuh, with its note.
// The spatial core does 4 S^2 dh
// operations per (frame, head) (0.37 TFLOP per B=16 forward; 3.8 GFLOP at the
// 2-clip slice, whose bytes take 0.0063 ms at 3.35 TB/s and whose operations 0.0039
// ms at 989 TFLOP/s of bf16, so bytes bound it). The TPU kernel held the whole S x S
// f32 score tile of a frame in VMEM (368^2 x 4 B = 542 KB), which does not fit in the
// 227 KB of shared memory a block can use. What the design does about it (both tiles
// in q8_attention.cuh, chosen by the activation dtype at compile time; both stream the
// keys past the query rows, nothing S x S is stored):
//   * bf16, on the tensor cores: 128 queries a block (8 warps x 16 rows, their q
//     held as mma A fragments), so one staging of a frame-head's K and V serves 128
//     queries; K and V stream through shared memory in 64-key chunks (32 at dim_head
//     128), two stages by cp.async, and every product is mma.sync m16n8k16 (bf16
//     operands, f32 accumulators, ldmatrix fragments). The exact softmax of the
//     reference (normalise, cast, then PV) is kept without an online rescale of the
//     output: a first sweep over the keys gives each row's max and sum, a second
//     recomputes QK^T and feeds p = round(exp(s - max) / sum) straight from the
//     accumulators into PV as the A fragment. The extra QK^T is S^2 dh products; the
//     exp and the IEEE division per score (kept, so p rounds as the reference's
//     does) and the two barriers per chunk are what it spends beyond the bound.
//   * f32, on the tensor cores as well: each product as three TF32 products (a_lo b_hi
//     + a_hi b_lo + a_hi b_hi, mma.sync m16n8k8; attention_tf32.cuh), so the f32 check
//     holds at 1e-5, which one TF32 product would miss. The bf16 tile's 16 query rows a
//     warp; each lane holds its raw q fragments in its own shared-memory slots (the
//     registers go to the accumulators), keys and values stream in 32-key chunks that
//     each thread copies by cp.async and splits once into hi / lo planes, each 32-deep
//     k-step sums afresh (the tensor cores round each product's sum toward zero), and
//     since p is not rounded in f32 one online sweep over the keys replaces the two.
//     Its work in f32 is three times the products: 0.188 ms at 495 TFLOP/s of TF32 for
//     a B=16 forward, above the bytes' 0.101 ms.
// The bodies are device functions in q8_attention.cuh and temporal.cuh, which
// q8_layer.cu (#9) runs inside its persistent kernel.
//
// The spatial core also serves the kernel API's unpacked entries, on separate
// q, k, v tensors (SplitRows) and without a mask (n_valid = S):
//   * istvt_tpu/kernels/attention.py fused_frame_attention_mh (_attn_kernel_mh):
//     q, k, v (G, S, H dh), every head of a frame;
//   * fused_frame_attention (_attn_kernel): q, k, v (G, S, dh), the same with H = 1.
// Both compute _mh_attention_vmem's math (f32 scores, exact softmax, the
// probabilities cast to v's dtype before PV), which is #10's.
#include "q8_attention.cuh"

namespace istvt {

// (iv) Thread g of B S H L: lane g % L of head (g / L) % H of location (g / L H) % S
// of clip g / (L H S) (temporal.cuh).
template <typename T, int V, int L, int C>
__global__ void __launch_bounds__(kTemporalThreads) temporal_attn_kernel(
    const T* __restrict__ qkv, T* __restrict__ out, int T1, int S, int H, int inner, int dh,
    float scale, long total) {
  const long g = static_cast<long>(blockIdx.x) * kTemporalThreads + threadIdx.x;
  temporal_attn_lane<T, V, L, C>(qkv, out, T1, S, H, inner, dh, scale, g, g < total);
}

// (iv) at T1 > kTMax: thread g as above, in blocks of blockDim.x threads (as many warps
// as their slots of T1 rows fit the block's shared memory, temporal_any_warps) whose
// slots are in dynamic shared memory, or in `scratch` where given (temporal.cuh). No
// __launch_bounds__: with one, ptxas held 12 instantiations to 80 registers and spilled
// 8-24 bytes around the division's slow-path calls.
template <typename T, int V, int L, int C>
__global__ void temporal_attn_any_kernel(
    const T* __restrict__ qkv, T* __restrict__ out, int T1, int S, int H, int inner, int dh,
    float scale, long total, uint32_t* __restrict__ scratch) {
  extern __shared__ uint4 any_slots[];
  const long g = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const TSlots sl = temporal_slots(reinterpret_cast<uint32_t*>(any_slots), scratch,
                                   TRow<T, V, L, C>::W);
  temporal_attn_lane_any<T, V, L, C>(qkv, out, T1, S, H, inner, dh, scale, g, g < total, sl);
}

// (v) Block = (query tile of spatial_q_tile(), head, frame). The bf16 tile's shared
// memory is static; the f32 tile's, above the 48 KB a static array may take, dynamic
// (spatial_smem_bytes, opted in by launch_tile). Launch bounds: for f32 two blocks an SM
// stated (one at dim_head 128), so that ptxas neither aims for more blocks and spills
// (without it) nor spreads into registers that would keep a second block out; for bf16
// none (0), as before.
template <typename T, int DH>
constexpr int kSpatialMinBlocks = std::is_same<T, float>::value ? (DH > 64 ? 1 : 2) : 0;

template <typename T, int DH>
__global__ void __launch_bounds__(256, kSpatialMinBlocks<T, DH>) spatial_attn_kernel(
    const T* __restrict__ qkv, T* __restrict__ out, int S, int inner, int n_valid,
    float scale) {
  if constexpr (std::is_same<T, float>::value) {
    extern __shared__ float4 tf32_smem[];
    spatial_attn_tile<T, DH>(qkv, out, S, inner, n_valid, scale, blockIdx.x, blockIdx.y,
                             blockIdx.z, reinterpret_cast<float*>(tf32_smem));
  } else {
    __shared__ __align__(16) unsigned char smem[spatial_smem_bytes<T>(DH)];
    spatial_attn_tile<T, DH>(qkv, out, S, inner, n_valid, scale, blockIdx.x, blockIdx.y,
                             blockIdx.z, reinterpret_cast<float*>(smem));
  }
}

// (v) on separate q, k, v: block = (query tile, head, frame), no mask.
template <typename T, int DH>
__global__ void __launch_bounds__(256, kSpatialMinBlocks<T, DH>) frame_attn_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int S, int inner, float scale) {
  const SplitRows<const T*> rows{q, k, v, inner};
  if constexpr (std::is_same<T, float>::value) {
    extern __shared__ float4 tf32_smem[];
    spatial_attn_tile_rows<T, DH>(rows, out, S, inner, S, scale, blockIdx.x, blockIdx.y,
                                  blockIdx.z, reinterpret_cast<float*>(tf32_smem));
  } else {
    __shared__ __align__(16) unsigned char smem[spatial_smem_bytes<T>(DH)];
    spatial_attn_tile_rows<T, DH>(rows, out, S, inner, S, scale, blockIdx.x, blockIdx.y,
                                  blockIdx.z, reinterpret_cast<float*>(smem));
  }
}

// Launches a spatial tile kernel on the grid of (query tiles, H, G) with the f32 tile's
// dynamic shared memory (opted in once an instantiation); 0 or the CUDA error.
template <typename T, int DH, typename Kern, typename... Args>
int launch_tile(Kern kern, int G, int S, int H, cudaStream_t st, Args... args) {
  const int bytes = std::is_same<T, float>::value ? spatial_smem_bytes<T>(DH) : 0;
  static const cudaError_t attr =
      bytes ? cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)
            : cudaSuccess;
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((S + spatial_q_tile() - 1) / spatial_q_tile(), H, G);
  kern<<<grid, 256, bytes, st>>>(args...);
  return 0;
}

template <typename T>
int launch_temporal(const void* qkv, void* out, int B, int T1, int S, int H, int inner,
                    float scale, int vec, int lanes, int chunks, void* scratch, cudaStream_t st) {
  const long total = static_cast<long>(B) * S * H * lanes;
  auto in = static_cast<const T*>(qkv);
  auto o = static_cast<T*>(out);
  if (T1 <= kTMax) {
    const int blocks = static_cast<int>((total + kTemporalThreads - 1) / kTemporalThreads);
    return with_temporal_plan<16 / sizeof(T)>(vec, lanes, chunks, [&](auto plan) {
      using P = decltype(plan);
      temporal_attn_kernel<T, P::V, P::L, P::C><<<blocks, kTemporalThreads, 0, st>>>(
          in, o, T1, S, H, inner, inner / H, scale, total);
    });
  }
  int err = 0;
  const int rc = with_temporal_plan<16 / sizeof(T)>(vec, lanes, chunks, [&](auto plan) {
    using P = decltype(plan);
    err = launch_temporal_any<kTemporalThreads>(
        temporal_attn_any_kernel<T, P::V, P::L, P::C>, total, T1, 2,
        TRow<T, P::V, P::L, P::C>::W, scratch, st, in, o, T1, S, H, inner, inner / H, scale,
        total);
  });
  return rc != 0 ? rc : err;
}

// The bytes of device scratch the general lanes need at T1 (0 where their slots fit
// shared memory, or at T1 <= kTMax): nslots 2 (the forward) or 4 (the backward) rows a
// thread of the plan (vec, lanes, chunks) in dtype dt.
template <typename T, int VW, int kMaxThreads>
int temporal_scratch(int nslots, int B, int T1, int S, int H, int vec, int lanes, int chunks,
                     long long* bytes) {
  *bytes = 0;
  if (T1 <= kTMax) return 0;
  int err = 0;
  const long total = static_cast<long>(B) * S * H * lanes;
  const int rc = with_temporal_plan<VW>(vec, lanes, chunks, [&](auto plan) {
    using P = decltype(plan);
    TemporalAnyLaunch la;
    if (temporal_any_launch<kMaxThreads>(total, T1, nslots, TRow<T, P::V, P::L, P::C>::W, &la,
                                         &err))
      *bytes = la.scratch;
  });
  return rc != 0 ? rc : err;
}

template <typename T, int DH>
int launch_spatial_dh(const T* in, T* o, int G, int S, int H, int inner, int n_valid,
                      float scale, cudaStream_t st) {
  return launch_tile<T, DH>(spatial_attn_kernel<T, DH>, G, S, H, st, in, o, S, inner, n_valid,
                            scale);
}

template <typename T>
int launch_spatial(const void* qkv, void* out, int G, int S, int H, int inner, int n_valid,
                   float scale, cudaStream_t st) {
  auto in = static_cast<const T*>(qkv);
  auto o = static_cast<T*>(out);
  switch (inner / H) {
    case 16: return launch_spatial_dh<T, 16>(in, o, G, S, H, inner, n_valid, scale, st);
    case 32: return launch_spatial_dh<T, 32>(in, o, G, S, H, inner, n_valid, scale, st);
    case 64: return launch_spatial_dh<T, 64>(in, o, G, S, H, inner, n_valid, scale, st);
    case 128: return launch_spatial_dh<T, 128>(in, o, G, S, H, inner, n_valid, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int DH>
int launch_frame_dh(const T* q, const T* k, const T* v, T* o, int G, int S, int H, int inner,
                    float scale, cudaStream_t st) {
  return launch_tile<T, DH>(frame_attn_kernel<T, DH>, G, S, H, st, q, k, v, o, S, inner, scale);
}

template <typename T>
int launch_frame(const void* q, const void* k, const void* v, void* out, int G, int S, int H,
                 int inner, float scale, cudaStream_t st) {
  auto qp = static_cast<const T*>(q);
  auto kp = static_cast<const T*>(k);
  auto vp = static_cast<const T*>(v);
  auto o = static_cast<T*>(out);
  switch (inner / H) {
    case 16: return launch_frame_dh<T, 16>(qp, kp, vp, o, G, S, H, inner, scale, st);
    case 32: return launch_frame_dh<T, 32>(qp, kp, vp, o, G, S, H, inner, scale, st);
    case 64: return launch_frame_dh<T, 64>(qp, kp, vp, o, G, S, H, inner, scale, st);
    case 128: return launch_frame_dh<T, 128>(qp, kp, vp, o, G, S, H, inner, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace istvt

using namespace istvt;

extern "C" {

// qkv (B, T1, S, 3 inner) -> out (B, T1, S, inner); dt 0 f32, 1 bf16; T1 >= 2, inner / H <=
// 128; (vec, lanes, chunks): the head's layout (kernels/attention.temporal_plan), one that
// with_temporal_plan instantiates; scratch: istvt_temporal_scratch's bytes of device
// memory, or null where it gives 0.
int istvt_temporal_attn(const void* qkv, void* out, int dt, int B, int T1, int S, int H,
                        int inner, float scale, int vec, int lanes, int chunks, void* scratch,
                        void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  int rc = dt == kBF16 ? launch_temporal<__nv_bfloat16>(qkv, out, B, T1, S, H, inner, scale,
                                                        vec, lanes, chunks, scratch, st)
                       : launch_temporal<float>(qkv, out, B, T1, S, H, inner, scale, vec, lanes,
                                                chunks, scratch, st);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// The device scratch (bytes, in *bytes) that the temporal core (backward 0) or #12
// (backward 1) needs at this geometry and plan: 0 unless T1 > 8 and not one warp's slots
// of T1 rows fit a block's shared memory.
int istvt_temporal_scratch(int dt, int backward, int B, int T1, int S, int H, int vec,
                           int lanes, int chunks, long long* bytes) {
  if (backward)
    return dt == kBF16 ? temporal_scratch<__nv_bfloat16, kTemporalBwdVec, kTemporalBwdThreads>(
                             4, B, T1, S, H, vec, lanes, chunks, bytes)
                       : temporal_scratch<float, kTemporalBwdVec, kTemporalBwdThreads>(
                             4, B, T1, S, H, vec, lanes, chunks, bytes);
  return dt == kBF16 ? temporal_scratch<__nv_bfloat16, 8, kTemporalThreads>(
                           2, B, T1, S, H, vec, lanes, chunks, bytes)
                     : temporal_scratch<float, 4, kTemporalThreads>(2, B, T1, S, H, vec, lanes,
                                                                     chunks, bytes);
}

// qkv (G, S, 3 inner) -> out (G, S, inner); keys >= n_valid masked; any S, inner / H in
// {16, 32, 64, 128}.
int istvt_spatial_attn(const void* qkv, void* out, int dt, int G, int S, int H, int inner,
                       int n_valid, float scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  int rc = dt == kBF16
               ? launch_spatial<__nv_bfloat16>(qkv, out, G, S, H, inner, n_valid, scale, st)
               : launch_spatial<float>(qkv, out, G, S, H, inner, n_valid, scale, st);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// q, k, v (G, S, inner) -> out (G, S, inner), no mask; any S, inner / H in
// {16, 32, 64, 128}.
int istvt_frame_attn(const void* q, const void* k, const void* v, void* out, int dt, int G, int S,
                     int H, int inner, float scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  int rc = dt == kBF16 ? launch_frame<__nv_bfloat16>(q, k, v, out, G, S, H, inner, scale, st)
                       : launch_frame<float>(q, k, v, out, G, S, H, inner, scale, st);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
