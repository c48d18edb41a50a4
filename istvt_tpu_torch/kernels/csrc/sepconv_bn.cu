// [ReLU ->] depthwise 3x3 (pad 1, stride 1) -> pointwise 1x1 -> folded eval-BN affine, in
// one kernel: kernels/conv.sepconv_bn.
//
// Replaces istvt_tpu/kernels/conv.py _sepconv_bn_impl (_sepconv_kernel), with its
// roundings: x is read as f32 and ReLU'd if relu_in; the 9 taps run in f32 (products
// and sums unfused, taps in (di, dj) order) with dw in f32; the depthwise sum is
// rounded to x's dtype T; the pointwise product multiplies it by pw (in T) with f32
// accumulation; then o * a + b in f32, rounded to T. Only the pointwise product's
// summation order is the kernel's own.
//
// What bounds it on the H100: at the Xception stem's stride-1 units (12 frames of
// 147^2 x 64 -> 128 up to 37^2 x 256 -> 728) reading x once and writing the output
// once, 0.010-0.040 ms at 3.35 TB/s in bf16 (twice that in f32); the pointwise product
// is 2 Cin Cout operations a pixel, 4-9 GFLOP, 0.004-0.009 ms on the bf16 tensor cores
// and three times that as three TF32 products; the depthwise's 18 f32 operations a
// pixel and channel run on the FMA pipes. The TPU kernel holds one whole frame in VMEM
// (5.5 MB at 147^2 x 64 in f32), which a block's 227 KB of shared memory cannot.
// What the design does about it (kernels/conv._sepconv_plan picks the tiles):
//   * A block owns a tile of 128 output pixels of one frame, 8 x 16 or 16 x 8, and N-tiles
//     of 64 output channels: all of Cout, or a share of them (blockIdx.y) where the pixel
//     tiles alone would leave the card's block slots empty.
//   * The depthwise runs once a pixel tile, not once an N-tile: the halo of 128 bytes of
//     channels at a time ((th + 2) x (tw + 2) pixels) is staged in shared memory by 16-byte
//     cp.async (zeros outside the image, so the tile edges need no other case; element
//     by element where Cin or x's alignment does not allow 16 bytes), each lane walks
//     one pixel column down the tile with its channels' taps in registers (each x value
//     read once for the three rows it feeds), and the sums, rounded to T, form the
//     GEMM's A tile, 128 x Cin in T, resident in shared memory (rows padded by 16 bytes:
//     ldmatrix reads free of bank conflicts).
//     Where Cin does not fit (past 736 channels in bf16, 320 in f32), A holds Cin in
//     chunks and each N-tile recomputes them.
//   * The pointwise runs on the tensor cores, 8 warps of 32 pixels x 32 channels: bf16
//     on mma.sync m16n8k16 (A by ldmatrix, pw by ldmatrix.trans); f32 as three TF32
//     products (mma.cuh mma_3xtf32: the split operands' lo hi + hi lo + hi hi) on
//     m16n8k8, each 32-deep k-step summed afresh and folded in by an IEEE add, since the
//     tensor cores truncate their sums (one TF32 product would miss the f32 check by
//     ~1e-3; tests/test_torch_sepconv.py models the sums on the CPU). pw streams through
//     a ring of 4 stages of 32 x 64 by cp.async, across N-tile boundaries.
//   * The epilogue applies o * a + b in f32 and, after a 4 x 4 transpose within each
//     quad of lanes (shuffles), stores 8 consecutive channels a lane in 16-byte vectors.
// Halo chunks staged by TMA into two buffers on mbarriers of their own, with persistent
// blocks loading the next tile's halo during this one's products, measured slower at
// every stem unit (PERF.md, PR 22): the halo's latency is not what bounds the kernel.
#include "mma.cuh"

namespace istvt {

constexpr int kSepM = 128;                 // output pixels a block (th x tw)
constexpr int kSepN = 64;                  // output channels an N-tile
constexpr int kSepK = 32;                  // pw rows a ring stage; one f32 fresh sum
constexpr int kSepStages = 4;              // ring stages
constexpr int kSepBS = kSepN + 8;          // ring row stride (elements; 144 / 288 bytes)
constexpr int kSepHaloC = 128;             // bytes of channels a halo chunk (4 a lane)
constexpr int kSepThreads = 256;
constexpr int kSepWarps = kSepThreads / 32;
constexpr int kSepMaxSmem = 232448;        // an H100 block's dynamic shared memory

// Shared memory of a launch, bytes: the A tile (128 rows of aw columns, padded by 16
// bytes), the halo chunk and the ring (kernels/conv._sepconv_plan computes the same).
template <typename T>
constexpr int sep_smem(int aw, int th, int tw) {
  return kSepM * (aw + 16 / static_cast<int>(sizeof(T))) * static_cast<int>(sizeof(T)) +
         (th + 2) * (tw + 2) * kSepHaloC +
         kSepStages * kSepK * kSepBS * static_cast<int>(sizeof(T));
}

struct SepGeom {
  int H, W, Cin, Cout;
  int th, tw, tiles_y, tiles_x;  // the pixel tile and the tiles a frame
  int kp;                        // Cin rounded up to kSepK
  int kc;                        // A columns a chunk (kp where all of Cin fits)
  int as;                        // A row stride, elements
  int n_tiles, per_split;        // N-tiles of Cout, N-tiles a blockIdx.y
  bool vec_x, vec_pw, vec_out;   // 16-byte copies allowed (alignment, Cin, Cout)
};

// This lane's E = 4 / sizeof(T) channels of one halo pixel, as f32 (ReLU'd if kRelu).

template <typename T, bool kRelu>
__device__ __forceinline__ void halo_load(const unsigned char* px, int lane,
                                          float (&v)[4 / sizeof(T)]) {
  if constexpr (sizeof(T) == 2) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(px + 4 * lane));
    v[0] = f.x;
    v[1] = f.y;
  } else {
    v[0] = *reinterpret_cast<const float*>(px + 4 * lane);
  }
#pragma unroll
  for (int e = 0; e < static_cast<int>(4 / sizeof(T)); ++e)
    if (kRelu) v[e] = fmaxf(v[e], 0.f);
}

// The depthwise of A's columns [ac0, ac0 + aw) (channels; aw a multiple of kSepK) for the
// block's pixel tile at (y0, x0) of frame xf, into As (column 0 = channel ac0).
template <typename T, bool kRelu>
__device__ __forceinline__ void sep_depthwise(const T* __restrict__ x, const T* __restrict__ xf,
                                              const float* __restrict__ dw, T* As,
                                              unsigned char* halo, const SepGeom& g, int y0,
                                              int x0, int ac0, int aw) {
  constexpr int E = 4 / sizeof(T);
  constexpr int HCH = kSepHaloC / sizeof(T);
  constexpr int V = 16 / sizeof(T);
  constexpr int VP = kSepHaloC / 16;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hw = g.tw + 2, hpx = (g.th + 2) * hw;
  for (int hc0 = ac0; hc0 < ac0 + aw; hc0 += HCH) {
    __syncthreads();  // every reader of A's last columns and of the halo is done
    if (g.vec_x) {
      for (int i = tid; i < hpx * VP; i += kSepThreads) {
        const int hp = i / VP, c = hc0 + (i % VP) * V;
        const int gy = y0 - 1 + hp / hw, gx = x0 - 1 + hp % hw;
        const bool in = gy >= 0 && gy < g.H && gx >= 0 && gx < g.W && c < g.Cin;
        cp_async16(halo + hp * kSepHaloC + (i % VP) * 16,
                   in ? xf + (static_cast<size_t>(gy) * g.W + gx) * g.Cin + c : x, in);
      }
      cp_async_commit();
      cp_async_wait<0>();  // (the ring's groups in flight complete too: harmless)
    } else {
      for (int i = tid; i < hpx * HCH; i += kSepThreads) {
        const int hp = i / HCH, c = hc0 + i % HCH;
        const int gy = y0 - 1 + hp / hw, gx = x0 - 1 + hp % hw;
        const bool in = gy >= 0 && gy < g.H && gx >= 0 && gx < g.W && c < g.Cin;
        reinterpret_cast<T*>(halo + hp * kSepHaloC)[i % HCH] =
            in ? xf[(static_cast<size_t>(gy) * g.W + gx) * g.Cin + c] : from_f<T>(0.f);
      }
    }
    __syncthreads();
    const int c = hc0 + lane * E;
    float w[9][E];
#pragma unroll
    for (int t = 0; t < 9; ++t)
#pragma unroll
      for (int e = 0; e < E; ++e) w[t][e] = c + e < g.Cin ? dw[t * g.Cin + c + e] : 0.f;
    const bool keep = c < ac0 + aw;
    T* acol = As + (c - ac0);
    for (int col = warp; col < g.tw; col += kSepWarps) {
      // rows y, y + 1, y + 2 of the halo around output (y, col), 3 columns each
      float r[3][3][E];
#pragma unroll
      for (int di = 0; di < 2; ++di)
#pragma unroll
        for (int dj = 0; dj < 3; ++dj)
          halo_load<T, kRelu>(halo + (di * hw + col + dj) * kSepHaloC, lane, r[di][dj]);
      for (int y = 0; y < g.th; ++y) {
#pragma unroll
        for (int dj = 0; dj < 3; ++dj)
          halo_load<T, kRelu>(halo + ((y + 2) * hw + col + dj) * kSepHaloC, lane, r[2][dj]);
        float s[E];
#pragma unroll
        for (int e = 0; e < E; ++e) {
          s[e] = __fmul_rn(r[0][0][e], w[0][e]);
#pragma unroll
          for (int t = 1; t < 9; ++t) s[e] = __fadd_rn(s[e], __fmul_rn(r[t / 3][t % 3][e], w[t][e]));
        }
        T* dst = acol + (y * g.tw + col) * g.as;
        if (keep) {
          if constexpr (sizeof(T) == 2)
            *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(s[0], s[1]);
          else
            *dst = s[0];
        }
#pragma unroll
        for (int dj = 0; dj < 3; ++dj)
#pragma unroll
          for (int e = 0; e < E; ++e) {
            r[0][dj][e] = r[1][dj][e];
            r[1][dj][e] = r[2][dj][e];
          }
      }
    }
  }
}

// Copies ring step t's pw slice (rows k0 .. k0 + 31, columns n0 .. n0 + 63; zeros past
// Cin / Cout) into its stage, by cp.async where vec_pw; commits a group either way.
template <typename T>
__device__ __forceinline__ void sep_issue(const T* __restrict__ pw, T* ring, const SepGeom& g,
                                          int t, int total, int nt0, int ks_n) {
  if (t < total) {
    const int tid = threadIdx.x;
    const int n0 = (nt0 + t / ks_n) * kSepN, k0 = (t % ks_n) * kSepK;
    T* dst = ring + (t % kSepStages) * kSepK * kSepBS;
    if (g.vec_pw) {
      constexpr int V = 16 / sizeof(T), VR = kSepN / V;
      for (int i = tid; i < kSepK * VR; i += kSepThreads) {
        const int r = i / VR, c = (i % VR) * V;
        const bool in = k0 + r < g.Cin && n0 + c < g.Cout;
        cp_async16(dst + r * kSepBS + c,
                   in ? pw + static_cast<size_t>(k0 + r) * g.Cout + n0 + c : pw, in);
      }
    } else {
      for (int i = tid; i < kSepK * kSepN; i += kSepThreads) {
        const int r = i / kSepN, c = i % kSepN;
        const bool in = k0 + r < g.Cin && n0 + c < g.Cout;
        dst[r * kSepBS + c] =
            in ? pw[static_cast<size_t>(k0 + r) * g.Cout + n0 + c] : from_f<T>(0.f);
      }
    }
  }
  cp_async_commit();
}

// acc (the warp's 32 x 32: 2 m16 x 4 n8 tiles) += A[rows, kcol .. kcol + 31] . bs (one
// ring stage). bf16: two m16n8k16 steps; f32: four m16n8k8 steps of three TF32
// products into a fresh sum, folded into acc at the end (one 32-deep k-step).
template <typename T>
__device__ __forceinline__ void sep_products(float (&acc)[2][4][4], const T* As, int as,
                                             int kcol, const T* bs, int wm, int wn, int lane) {
  const int lr = (lane & 7) + 8 * ((lane >> 3) & 1);  // ldmatrix: this lane's row
  if constexpr (sizeof(T) == 2) {
    const int lk = 8 * (lane >> 4);
#pragma unroll
    for (int kk = 0; kk < kSepK / 16; ++kk) {
      unsigned af[2][4], bf[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4(af[mi], As + (wm * 32 + mi * 16 + lr) * as + kcol + kk * 16 + lk);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        ldsm_x4_trans(bf[nj], bs + (kk * 16 + lr) * kSepBS + wn * 32 + nj * 16 + lk);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
          mma_bf16(acc[mi][nj], af[mi], bf[nj >> 1][2 * (nj & 1)], bf[nj >> 1][2 * (nj & 1) + 1]);
    }
  } else {
    const int lk = 4 * (lane >> 4), g = lane >> 2, t = lane & 3;
    float part[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int q = 0; q < 4; ++q) part[mi][nj][q] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kSepK / 8; ++kk) {
      unsigned ah[2][4], al[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        unsigned raw[4];
        ldsm_x4(raw, As + (wm * 32 + mi * 16 + lr) * as + kcol + kk * 8 + lk);
#pragma unroll
        for (int q = 0; q < 4; ++q) split_tf32(__uint_as_float(raw[q]), ah[mi][q], al[mi][q]);
      }
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const T* bc = bs + (kk * 8 + t) * kSepBS + wn * 32 + nj * 8 + g;
        unsigned bh0, bl0, bh1, bl1;
        split_tf32(bc[0], bh0, bl0);
        split_tf32(bc[4 * kSepBS], bh1, bl1);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          mma_3xtf32(part[mi][nj], ah[mi], al[mi], bh0, bh1, bl0, bl1);
      }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mi][nj][q] = __fadd_rn(acc[mi][nj][q], part[mi][nj][q]);
  }
}

// w[j] of quad lane t becomes w[t] of quad lane j (a 4 x 4 transpose within each quad):
// lane t then holds n8 tile t's columns 2j, 2j + 1 in w[j], 8 consecutive channels.
__device__ __forceinline__ void quad_transpose(unsigned (&w)[4], int lane) {
  const int t = lane & 3;
  auto pick = [&](int j) { return j == 0 ? w[0] : j == 1 ? w[1] : j == 2 ? w[2] : w[3]; };
  unsigned r[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j == t) r[j] = w[j];
#pragma unroll
  for (int s = 1; s < 4; ++s) {
    const int src = (t - s) & 3;
    const unsigned v = __shfl_sync(0xffffffffu, pick((t + s) & 3), (lane & ~3) | src);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j == src) r[j] = v;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) w[j] = r[j];
}

// o * a + b of the warp's 32 x 32 accumulators, rounded to T, stored: 8 channels a lane
// (16 bytes in bf16, twice 16 in f32) where vec_out and the 8 are within Cout, else one
// by one; pixels off the image are not stored.
template <typename T>
__device__ __forceinline__ void sep_epilogue(const float (&acc)[2][4][4],
                                             const float* __restrict__ a,
                                             const float* __restrict__ b, T* __restrict__ out,
                                             const SepGeom& g, int frame, int y0, int x0,
                                             int n0, int wm, int wn, int lane) {
  const int gq = lane >> 2, tq = lane & 3;
  const int cb = n0 + wn * 32;
  float av[4][2], bv[4][2];
#pragma unroll
  for (int nj = 0; nj < 4; ++nj)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int co = cb + nj * 8 + 2 * tq + e;
      av[nj][e] = co < g.Cout ? a[co] : 0.f;
      bv[nj][e] = co < g.Cout ? b[co] : 0.f;
    }
  const int co = cb + 8 * tq;  // this lane's channels after the transpose
  const bool vec = g.vec_out && co + 8 <= g.Cout;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float o[4][2];
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          o[nj][e] = __fadd_rn(__fmul_rn(acc[mi][nj][2 * h + e], av[nj][e]), bv[nj][e]);
      const int p = wm * 32 + mi * 16 + gq + 8 * h;
      const int gy = y0 + p / g.tw, gx = x0 + p % g.tw;
      const bool on = gy < g.H && gx < g.W;
      T* dst = out + ((static_cast<size_t>(frame) * g.H + gy) * g.W + gx) * g.Cout + co;
      if constexpr (sizeof(T) == 2) {
        unsigned wv[4];
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) wv[nj] = pack_bf16(o[nj][0], o[nj][1]);
        quad_transpose(wv, lane);
        if (on) {
          if (vec) {
            *reinterpret_cast<uint4*>(dst) = make_uint4(wv[0], wv[1], wv[2], wv[3]);
          } else {
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const __nv_bfloat162 pr = *reinterpret_cast<const __nv_bfloat162*>(&wv[k]);
              if (co + 2 * k < g.Cout) dst[2 * k] = pr.x;
              if (co + 2 * k + 1 < g.Cout) dst[2 * k + 1] = pr.y;
            }
          }
        }
      } else {
        unsigned lo[4], hi[4];
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          lo[nj] = __float_as_uint(o[nj][0]);
          hi[nj] = __float_as_uint(o[nj][1]);
        }
        quad_transpose(lo, lane);
        quad_transpose(hi, lane);
        if (on) {
          float v[8];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            v[2 * k] = __uint_as_float(lo[k]);
            v[2 * k + 1] = __uint_as_float(hi[k]);
          }
          if (vec) {
            reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
            reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
          } else {
#pragma unroll
            for (int k = 0; k < 8; ++k)
              if (co + k < g.Cout) dst[k] = v[k];
          }
        }
      }
    }
}

// One block: pixel tile blockIdx.x (frame, tile row, tile column), N-tiles
// blockIdx.y * per_split onward. The ring's steps run over (N-tile, 32-deep k-step);
// the depthwise runs before the first step of each A chunk (once, where Cin fits).
template <typename T, bool kRelu>
__global__ void __launch_bounds__(kSepThreads, sizeof(T) == 2 ? 2 : 1) sepconv_bn_kernel(
    const T* __restrict__ x, const float* __restrict__ dw, const T* __restrict__ pw,
    const float* __restrict__ a, const float* __restrict__ b, T* __restrict__ out, SepGeom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);
  unsigned char* halo = smem + kSepM * g.as * sizeof(T);
  T* ring = reinterpret_cast<T*>(halo + (g.th + 2) * (g.tw + 2) * kSepHaloC);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 3, wn = warp >> 2;  // the warp's 32 rows and 32 columns
  int bx = blockIdx.x;
  const int tx = bx % g.tiles_x;
  bx /= g.tiles_x;
  const int ty = bx % g.tiles_y, frame = bx / g.tiles_y;
  const int y0 = ty * g.th, x0 = tx * g.tw;
  const int nt0 = blockIdx.y * g.per_split;
  const int nts = min(g.per_split, g.n_tiles - nt0);
  const T* xf = x + static_cast<size_t>(frame) * g.H * g.W * g.Cin;
  const int ks_n = g.kp / kSepK, ks_c = g.kc / kSepK;  // k-steps an N-tile, an A chunk
  const bool chunked = g.kc < g.kp;
  const int total = nts * ks_n;

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][nj][q] = 0.f;

#pragma unroll
  for (int s = 0; s < kSepStages - 1; ++s) sep_issue(pw, ring, g, s, total, nt0, ks_n);
  for (int t = 0; t < total; ++t) {
    const int nt = t / ks_n, ks = t % ks_n, ac0 = (ks / ks_c) * g.kc;
    if (ks % ks_c == 0 && (chunked || nt == 0))
      sep_depthwise<T, kRelu>(x, xf, dw, As, halo, g, y0, x0, ac0, min(g.kc, g.kp - ac0));
    cp_async_wait<kSepStages - 2>();
    __syncthreads();  // step t's stage and A are in; step t - 1's readers are done
    sep_issue(pw, ring, g, t + kSepStages - 1, total, nt0, ks_n);
    sep_products<T>(acc, As, g.as, ks * kSepK - ac0, ring + (t % kSepStages) * kSepK * kSepBS,
                    wm, wn, lane);
    if (ks == ks_n - 1) {
      sep_epilogue<T>(acc, a, b, out, g, frame, y0, x0, (nt0 + nt) * kSepN, wm, wn, lane);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mi][nj][q] = 0.f;
    }
  }
  cp_async_wait<0>();
}

template <typename T, bool kRelu>
int launch_sepconv(const void* x, const void* dw, const void* pw, const void* a, const void* b,
                   void* out, int N, const SepGeom& g, int splits, int smem, cudaStream_t st) {
  auto kern = sepconv_bn_kernel<T, kRelu>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSepMaxSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(N * g.tiles_y * g.tiles_x, splits);
  kern<<<grid, kSepThreads, smem, st>>>(static_cast<const T*>(x), static_cast<const float*>(dw),
                                        static_cast<const T*>(pw), static_cast<const float*>(a),
                                        static_cast<const float*>(b), static_cast<T*>(out), g);
  return 0;
}

template <typename T>
int launch_sepconv_bn(const void* x, const void* dw, const void* pw, const void* a, const void* b,
                      void* out, int N, int H, int W, int Cin, int Cout, int relu_in, int th,
                      int tw, int per_split, int kc, int smem, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  SepGeom g;
  g.H = H, g.W = W, g.Cin = Cin, g.Cout = Cout, g.th = th, g.tw = tw;
  g.tiles_y = (H + th - 1) / th, g.tiles_x = (W + tw - 1) / tw;
  g.kp = (Cin + kSepK - 1) / kSepK * kSepK;
  g.kc = kc;
  const int aw = kc < g.kp ? kc : g.kp;
  g.as = aw + V;
  g.n_tiles = (Cout + kSepN - 1) / kSepN;
  g.per_split = per_split;
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  g.vec_x = Cin % V == 0 && aligned(x);
  g.vec_pw = Cout % V == 0 && aligned(pw);
  g.vec_out = Cout % V == 0 && aligned(out);
  // the plan (kernels/conv._sepconv_plan) must be one this kernel takes
  const bool chunk_ok = kc == g.kp || (kc % 64 == 0 && kc < g.kp);
  if (N < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1 || th * tw != kSepM ||
      !(th == 8 || th == 16) || kc < kSepK || !chunk_ok || per_split < 1 ||
      smem != sep_smem<T>(aw, th, tw) || smem > kSepMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const int splits = (g.n_tiles + per_split - 1) / per_split;
  return relu_in ? launch_sepconv<T, true>(x, dw, pw, a, b, out, N, g, splits, smem, st)
                 : launch_sepconv<T, false>(x, dw, pw, a, b, out, N, g, splits, smem, st);
}

}  // namespace istvt

using namespace istvt;

extern "C" {

// x (N, H, W, Cin) NHWC in dt (0 f32, 1 bf16), dw (9, Cin) f32, pw (Cin, Cout) in dt,
// a, b (Cout,) f32 -> out (N, H, W, Cout) in dt; the tile plan of kernels/conv._sepconv_plan:
// th x tw pixels, per_split N-tiles a blockIdx.y, A chunks of kc columns, smem bytes.
int istvt_sepconv_bn(const void* x, const void* dw, const void* pw, const void* a, const void* b,
                     void* out, int dt, int N, int H, int W, int Cin, int Cout, int relu_in,
                     int th, int tw, int per_split, int kc, int smem, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  int rc = dt == kBF16 ? launch_sepconv_bn<__nv_bfloat16>(x, dw, pw, a, b, out, N, H, W, Cin,
                                                          Cout, relu_in, th, tw, per_split, kc,
                                                          smem, st)
                       : launch_sepconv_bn<float>(x, dw, pw, a, b, out, N, H, W, Cin, Cout,
                                                  relu_in, th, tw, per_split, kc, smem, st);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
