// The rate of TF32 mma.sync m16n8k8 on this card when nothing else runs: the
// practical ceiling of the 3xTF32 kernels built on tf32_mma.cuh, which issue
// mma.sync (only wgmma reaches the data sheet's dense TF32 peak). Not a port
// of a TPU kernel and on no path of the package: chip_smoke.py times it
// beside the kernels to read their tensor-core share against it.
//
// Each warp runs `iters` rounds of kAcc independent products (no chain waits
// on another), one block of `threads` per SM as the stage kernel runs.

#include <cuda_runtime.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kAcc = 8;   // independent accumulators per warp

__global__ void mma_rate_kernel(float* out, int iters) {
  unsigned a[4], b[2];
  for (int e = 0; e < 4; ++e) a[e] = __float_as_uint(1.f + 1e-3f * threadIdx.x + e);
  for (int e = 0; e < 2; ++e) b[e] = __float_as_uint(0.5f + e);
  float c[kAcc][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < kAcc; ++k) mma_tf32(c[k], a, b);
  }
  float s = 0.f;
  for (int k = 0; k < kAcc; ++k) s += c[k][0] + c[k][1] + c[k][2] + c[k][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

// out: blocks * threads floats. Each warp does iters * 8 m16n8k8 products
// (2048 FLOPs each). Returns a cudaError_t.
extern "C" int mma_rate(float* out, int blocks, int threads, int iters, void* stream) {
  if (blocks < 1 || threads < 32 || threads % 32 != 0 || iters < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  mma_rate_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}
