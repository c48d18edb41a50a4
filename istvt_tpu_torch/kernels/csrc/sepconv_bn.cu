// [ReLU ->] depthwise 3x3 (pad 1, stride 1) -> pointwise 1x1 -> folded eval-BN affine, in
// one kernel: kernels/conv.sepconv_bn.
//
// Replaces istvt_tpu/kernels/conv.py _sepconv_bn_impl (_sepconv_kernel), with its
// roundings: x is read as f32 and ReLU'd if relu_in; the 9 taps run in f32 (products
// and sums unfused, taps in (di, dj) order) with dw in f32; the depthwise sum is
// rounded to x's dtype T; the pointwise product multiplies it by pw (in T) with f32
// accumulation; then o * a + b in f32, rounded to T.
//
// What bounds it on the H100: at the Xception stem's stride-1 units (12 frames of
// 147^2 x 64 -> 128 up to 37^2 x 256 -> 728) reading x once and writing the output
// once, 0.01-0.04 ms at 3.35 TB/s in bf16; the pointwise product is 2 Cin Cout
// operations a pixel, 4-17 GFLOP. The TPU kernel holds one whole frame in VMEM (5.5 MB
// at 147^2 x 64 in f32), which a block's 227 KB of shared memory cannot.
// What the design does about it: a block owns 64 output pixels of one image row and 64
// output channels. It walks Cin in chunks of 32: it stages the three input rows of the
// chunk with their one-pixel halo (zeros outside the image, so the tile edges need no
// other case) in shared memory, computes the chunk's depthwise sums for its 64 pixels
// into shared memory, rounded as JAX rounds them, stages the matching 32 x 64 slice of
// pw, and accumulates the pointwise product, 4 pixels x 4 channels a thread, on the
// FMA pipes in f32 (TF32 would miss the f32 check by about 1e-3). The affine is the
// epilogue. Each of the Cout / 64 channel tiles recomputes the depthwise (9 / 64 of
// the pointwise work). Tensor cores (wgmma, TMA) and keeping the depthwise in shared
// memory across channel tiles are later work.
#include "common.cuh"

namespace istvt {

constexpr int kPx = 64;              // output pixels of one row a block
constexpr int kCo = 64;              // output channels a block
constexpr int kCi = 32;              // input channels a chunk
constexpr int kHalo = kPx + 2;       // input columns of the chunk
constexpr int kHaloS = kHalo + 1;    // odd row stride: the staging writes do not collide
constexpr int kDwS = kPx + 4;        // row stride of the depthwise tile (float4 reads)

template <typename T, bool kRelu>
__global__ void __launch_bounds__(256) sepconv_bn_kernel(
    const T* __restrict__ x, const float* __restrict__ dw, const T* __restrict__ pw,
    const float* __restrict__ a, const float* __restrict__ b, T* __restrict__ out, int H, int W,
    int Cin, int Cout) {
  __shared__ float halo[3][kCi][kHaloS];          // input rows y-1..y+1, chunk channels
  __shared__ __align__(16) float dws[kCi][kDwS];  // depthwise sums, rounded to T
  __shared__ __align__(16) float pws[kCi][kCo];   // pw rows of the chunk
  __shared__ float taps[9][kCi];                   // dw of the chunk

  const int tid = threadIdx.x;
  const int segs = (W + kPx - 1) / kPx;
  const int x0 = (blockIdx.x % segs) * kPx;
  const int y = blockIdx.x / segs;
  const int co0 = blockIdx.y * kCo;
  const int n = blockIdx.z;
  const T* xn = x + static_cast<size_t>(n) * H * W * Cin;
  const int ty = tid / 16, tx = tid % 16;  // pointwise: pixels 4 ty.., channels 4 tx..

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += kCi) {
    __syncthreads();  // the previous chunk's reads of dws / pws are done
    // stage the halo rows: channel fastest in global memory (NHWC)
    for (int idx = tid; idx < 3 * kHalo * kCi; idx += 256) {
      const int c = idx % kCi, col = (idx / kCi) % kHalo, r = idx / (kCi * kHalo);
      const int yy = y - 1 + r, xx = x0 - 1 + col, ci = c0 + c;
      float v = 0.f;
      if (yy >= 0 && yy < H && xx >= 0 && xx < W && ci < Cin) {
        v = to_f(xn[(static_cast<size_t>(yy) * W + xx) * Cin + ci]);
        if (kRelu) v = fmaxf(v, 0.f);
      }
      halo[r][c][col] = v;
    }
    for (int idx = tid; idx < 9 * kCi; idx += 256) {
      const int c = idx % kCi, t = idx / kCi;
      taps[t][c] = c0 + c < Cin ? dw[t * Cin + c0 + c] : 0.f;
    }
    for (int idx = tid; idx < kCi * kCo; idx += 256) {
      const int co = idx % kCo, c = idx / kCo;
      pws[c][co] = (c0 + c < Cin && co0 + co < Cout)
                       ? to_f(pw[static_cast<size_t>(c0 + c) * Cout + co0 + co])
                       : 0.f;
    }
    __syncthreads();
    // depthwise: thread -> pixel tid % 64, channels tid / 64 + 4 i
#pragma unroll
    for (int i = 0; i < kCi * kPx / 256; ++i) {
      const int px = tid % kPx, c = tid / kPx + 4 * i;
      float s = 0.f;
#pragma unroll
      for (int di = 0; di < 3; ++di)
#pragma unroll
        for (int dj = 0; dj < 3; ++dj) {
          const float tap = __fmul_rn(halo[di][c][px + dj], taps[di * 3 + dj][c]);
          s = di == 0 && dj == 0 ? tap : __fadd_rn(s, tap);
        }
      dws[c][px] = round_to<T>(s);
    }
    __syncthreads();
    // pointwise: acc[pixel][channel] += dws[c][pixel] * pws[c][channel]
#pragma unroll 8
    for (int c = 0; c < kCi; ++c) {
      const float4 av = *reinterpret_cast<const float4*>(&dws[c][4 * ty]);
      const float4 bv = *reinterpret_cast<const float4*>(&pws[c][4 * tx]);
      const float ar[4] = {av.x, av.y, av.z, av.w}, br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
  }
  // epilogue: o * a + b in f32, rounded to T
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int xx = x0 + 4 * ty + i;
    if (xx >= W) continue;
    T* orow = out + ((static_cast<size_t>(n) * H + y) * W + xx) * Cout;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + 4 * tx + j;
      if (co < Cout) orow[co] = from_f<T>(__fadd_rn(__fmul_rn(acc[i][j], a[co]), b[co]));
    }
  }
}

template <typename T>
int launch_sepconv_bn(const void* x, const void* dw, const void* pw, const void* a, const void* b,
                      void* out, int N, int H, int W, int Cin, int Cout, int relu_in,
                      cudaStream_t st) {
  dim3 grid(H * ((W + kPx - 1) / kPx), (Cout + kCo - 1) / kCo, N);
  auto xp = static_cast<const T*>(x);
  auto dwp = static_cast<const float*>(dw);
  auto pwp = static_cast<const T*>(pw);
  auto ap = static_cast<const float*>(a);
  auto bp = static_cast<const float*>(b);
  auto o = static_cast<T*>(out);
  if (relu_in)
    sepconv_bn_kernel<T, true><<<grid, 256, 0, st>>>(xp, dwp, pwp, ap, bp, o, H, W, Cin, Cout);
  else
    sepconv_bn_kernel<T, false><<<grid, 256, 0, st>>>(xp, dwp, pwp, ap, bp, o, H, W, Cin, Cout);
  return 0;
}

}  // namespace istvt

using namespace istvt;

extern "C" {

// x (N, H, W, Cin) NHWC in dt (0 f32, 1 bf16), dw (9, Cin) f32, pw (Cin, Cout) in dt,
// a, b (Cout,) f32 -> out (N, H, W, Cout) in dt.
int istvt_sepconv_bn(const void* x, const void* dw, const void* pw, const void* a, const void* b,
                     void* out, int dt, int N, int H, int W, int Cin, int Cout, int relu_in,
                     void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  int rc = dt == kBF16 ? launch_sepconv_bn<__nv_bfloat16>(x, dw, pw, a, b, out, N, H, W, Cin,
                                                          Cout, relu_in, st)
                       : launch_sepconv_bn<float>(x, dw, pw, a, b, out, N, H, W, Cin, Cout,
                                                  relu_in, st);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
