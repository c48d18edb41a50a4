// Two facts about mma.sync with tf32 operands (m16n8k8, f32 accumulators) on the card,
// which the f32 spatial attention tiles (istvt_tpu_torch/kernels/csrc/attention_tf32.cuh)
// are built around:
//   1. how it rounds its f32 sum: 1 + 0.75 ulp (and -1 - 0.75 ulp) from one product
//      added to the accumulator comes back as 1 (-1) if the sum is rounded toward zero,
//      as 1 + 1 ulp if to nearest; the tiles start a fresh sum every 32-deep k-step;
//   2. its rate: independent products, 8 accumulators a warp, 4 blocks of 256 threads
//      an SM, in TFLOP/s of TF32 (and bf16 m16n8k16 beside it), the ceiling of a tile
//      built on mma.sync rather than wgmma.
// tests/test_torch_kernels_gpu.py -k mma_sync_tf32 builds it and holds fact 1; fact 2 is a
// reading. Build and run on the card (the build directory is the kernels' own, ignored
// by git):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 \
//       -o istvt_tpu_torch/kernels/build/mma_tf32_probe tools/mma_tf32_probe.cu
//   istvt_tpu_torch/kernels/build/mma_tf32_probe
#include <cstdio>

#include <cuda_runtime.h>

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Lane 0 holds A[0][0] = +-1.5, B[0][0] = 2^-24, C[0][0] = +-1: D[0][0] = +-(1 + 0.75 ulp).
__global__ void rounding(float* out) {
  const bool l0 = threadIdx.x == 0;
  for (int sign = 0; sign < 2; ++sign) {
    const float s = sign ? -1.f : 1.f;
    unsigned a[4] = {l0 ? __float_as_uint(1.5f * s) : 0u, 0u, 0u, 0u};
    float c[4] = {l0 ? s : 0.f, 0.f, 0.f, 0.f};
    mma_tf32(c, a, l0 ? __float_as_uint(ldexpf(1.f, -24)) : 0u, 0u);
    if (l0) out[sign] = c[0];
  }
}

template <bool TF32>
__global__ void rate(float* out, int iters, unsigned seed) {
  float c[8][4] = {};
  const unsigned a[4] = {seed, seed * 3, seed * 5, seed * 7};
  const unsigned b0 = seed ^ threadIdx.x, b1 = seed + threadIdx.x;
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (TF32)
        mma_tf32(c[j], a, b0 + j, b1);
      else
        mma_bf16(c[j], a, b0 + j, b1);
    }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  if (s == 1.2345f) out[threadIdx.x] = s;  // never: keeps the products
}

template <bool TF32>
double tflops(float* out, int blocks) {
  const int iters = 4096;
  rate<TF32><<<blocks, 256>>>(out, 16, 1u);  // warm-up
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  rate<TF32><<<blocks, 256>>>(out, iters, 1u);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  const double mmas = double(blocks) * 8 * iters * 8;  // warps x iterations x accumulators
  return mmas * (TF32 ? 2.0 * 16 * 8 * 8 : 2.0 * 16 * 8 * 16) / (ms * 1e-3) / 1e12;
}

int main() {
  float* out;
  if (cudaMalloc(&out, 4096) != cudaSuccess) return 1;
  rounding<<<1, 32>>>(out);
  float h[2];
  cudaMemcpy(h, out, sizeof h, cudaMemcpyDeviceToHost);
  printf("mma.sync tf32 sum: 1 + 0.75 ulp -> %.9g, -1 - 0.75 ulp -> %.9g: %s\n", h[0], h[1],
         h[0] == 1.f && h[1] == -1.f   ? "rounded toward zero"
         : h[0] > 1.f && h[1] < -1.f ? "rounded to nearest"
                                     : "neither");
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  printf("mma.sync rate, 4 blocks of 256 threads an SM, 8 accumulators a warp: "
         "tf32 m16n8k8 %.1f TFLOP/s, bf16 m16n8k16 %.1f TFLOP/s\n",
         tflops<true>(out, 4 * sms), tflops<false>(out, 4 * sms));
  cudaFree(out);
  return cudaGetLastError() == cudaSuccess ? 0 : 1;
}
