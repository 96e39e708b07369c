// bf16 products on the tensor cores (mma.sync m16n8k16 .bf16, fp32
// accumulator) for the generator-stage kernel's fast modes (gen_stage.cu),
// the two TPU contraction modes of the JAX stage kernels:
//
// - 'bf16x3': each operand x is split as hi = bf16(x) and lo = bf16(x - hi),
//   both rounded to nearest even (what astype(bfloat16) does), and a b
//   accumulates lo_a hi_b + hi_a lo_b + hi_a hi_b; the dropped lo_a lo_b is
//   ~2^-16 of the product (JAX _split_bf16 / _make_dot). A bf16 product is
//   exact in fp32, so these are the JAX kernel's products; three run at the
//   989 TFLOP/s bf16 rate, the time of 1.5 TF32 products.
// - 'default': one product of the operands rounded to bf16 (round to
//   nearest even), what Precision.DEFAULT does on a TPU.
//
// Fragments (PTX m16n8k16 .bf16, two bf16 per 32-bit register, the lower k
// in the low half): lane (g, t) = (lane / 4, lane % 4) holds A rows g
// (registers 0 and 2) and g + 8 (1 and 3) at k = 2t, 2t + 1 (registers 0, 1)
// and 2t + 8, 2t + 9 (2, 3), B k = 2t, 2t + 1 (register 0) and 2t + 8, 2t + 9
// (register 1) at column g, and C as m16n8k8 does (rows g and g + 8,
// columns 2t and 2t + 1).
//
// Everything here has internal linkage, as in tf32_mma.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}

// x rounded to bf16 (nearest even), as an fp32 value.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// (a, b) as one register, a in the low half, each rounded to bf16.
__device__ __forceinline__ unsigned pack_bf16(float a, float b) {
  return bf16x2_bits(__floats2bfloat162_rn(a, b));
}

// (a, b) = hi + lo as two registers of bf16 pairs, a in the low halves.
__device__ __forceinline__ void split_bf16(float a, float b, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = pack_bf16(a - f.x, b - f.y);
}

// c += a b on one m16n8k16 tile, bf16 operands, fp32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b from split operands: the three bf16 products, small ones first.
__device__ __forceinline__ void mma_bf16x3(float (&c)[4], const unsigned (&ah)[4],
                                           const unsigned (&al)[4], const unsigned (&bh)[2],
                                           const unsigned (&bl)[2]) {
  mma_bf16(c, al, bh);
  mma_bf16(c, ah, bl);
  mma_bf16(c, ah, bh);
}

// acc += a b with the three products summed in a fresh accumulator and added
// in fp32 (round to nearest), so the accumulator's rounding toward zero does
// not compound along acc (as mma_3xtf32_add in tf32_mma.cuh).
__device__ __forceinline__ void mma_bf16x3_add(float (&acc)[4], const unsigned (&ah)[4],
                                               const unsigned (&al)[4], const unsigned (&bh)[2],
                                               const unsigned (&bl)[2]) {
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  mma_bf16x3(c, ah, al, bh, bl);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += c[e];
}

}  // namespace
