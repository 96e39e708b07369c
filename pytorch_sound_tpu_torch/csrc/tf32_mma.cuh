// fp32-accurate products on the TF32 tensor cores (3xTF32 mma.sync m16n8k8)
// and the cp.async copies that stage their operands, shared by the
// flash-attention kernels (flash_attention.cu), the grouped-conv weight
// gradient (grouped_conv.cu) and the generator-stage convs (gen_stage.cu).
//
// - 3xTF32. Each operand x is split as hi + lo, hi = x rounded to TF32 (10
//   mantissa bits) and lo = x - hi (split_tf32), and a b accumulates
//   lo_a hi_b + hi_a lo_b + hi_a hi_b: the dropped lo_a lo_b is ~2^-22 of the
//   product, so each product is as close to fp32 as a CUDA-core FMA (one TF32
//   pass would be ~1e-3 off). The 3x work runs at the 495 TFLOP/s TF32 rate,
//   7x the 67 TFLOP/s fp32 CUDA-core peak, so the bound of a kernel built on
//   it is 3 FLOPs / 495e12 per fp32 FLOP.
// - Partial sums. The tensor cores' fp32 accumulator rounds toward zero, a
//   bias that grows with each product in a chain, so callers sum a bounded
//   run of products in a fresh accumulator and add it to their total in fp32
//   (add_part, mma_3xtf32_rn, mma_3xtf32_add).
// - Fragments (PTX m16n8k8 .tf32): lane (g, t) = (lane / 4, lane % 4) holds A
//   rows g and g + 8 at columns t and t + 4, B rows t and t + 4 at column g,
//   and C rows g and g + 8 at columns 2t and 2t + 1.
//
// Everything here has internal linkage (an unnamed namespace), so each
// translation unit that includes it keeps its own copy and the objects link
// into one library.

#pragma once

#include <cuda_runtime.h>

namespace {

// x = hi + lo as two TF32 operands. The tensor cores read only the top 19
// bits of a TF32 operand (sign, exponent, 10 mantissa bits), so hi is x plus
// half a TF32 ulp (x rounded to nearest once read) and lo the exact rest
// x - hi, truncated to TF32 by the same read: |lo| <= 2^-11 |x| and the part
// of lo that is lost <= 2^-21 |x|. Three integer / fp32 instructions, where
// cvt.rna.tf32.f32 twice takes nine.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = __float_as_uint(x) + 0x1000u;
  lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u));
}

// c += a b on one m16n8k8 tile, TF32 operands, fp32 accumulator.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += a b as mma_3xtf32_rn computes it, the fresh accumulator started by
// the first product (its C operand the constant 0) rather than zeroed
// registers.
__device__ __forceinline__ void mma_3xtf32_add(float (&acc)[4], const unsigned (&ah)[4],
                                               const unsigned (&al)[4], const unsigned (&bh)[2],
                                               const unsigned (&bl)[2]) {
  const float z = 0.f;
  float c[4];
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(al[0]), "r"(al[1]), "r"(al[2]), "r"(al[3]), "r"(bh[0]), "r"(bh[1]), "f"(z));
  mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += c[e];
}

// c += a b at fp32 accuracy: the three TF32 products, small ones first.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const unsigned (&ah)[4],
                                           const unsigned (&al)[4], const unsigned (&bh)[2],
                                           const unsigned (&bl)[2]) {
  mma_tf32(c, al, bh);
  mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

// c += a b with the three products summed in a fresh accumulator and added
// to c in fp32 (round to nearest), so the accumulator's rounding toward zero
// never compounds along c.
__device__ __forceinline__ void mma_3xtf32_rn(float (&c)[4], const unsigned (&ah)[4],
                                              const unsigned (&al)[4], const unsigned (&bh)[2],
                                              const unsigned (&bl)[2]) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_3xtf32(t, ah, al, bh, bl);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += t[e];
}

// acc += part, in fp32 with round to nearest, and part = 0: each run of
// products is summed apart and added here, which keeps the accumulator's
// biased rounding to one run.
template <int NC>
__device__ __forceinline__ void add_part(float (&acc)[NC][4], float (&part)[NC][4]) {
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[n][e] += part[n][e];
      part[n][e] = 0.f;
    }
}

// The A operand (16 x 8, rows r0.., columns c0..) of a row-major shared tile,
// split: lane (g, t) holds rows g and g + 8 at columns t and t + 4.
__device__ __forceinline__ void load_a(const float* s, int ld, int r0, int c0, int g, int t,
                                       unsigned (&hi)[4], unsigned (&lo)[4]) {
  const float* p = s + (r0 + g) * ld + c0 + t;
  split_tf32(p[0], hi[0], lo[0]);
  split_tf32(p[8 * ld], hi[1], lo[1]);
  split_tf32(p[4], hi[2], lo[2]);
  split_tf32(p[8 * ld + 4], hi[3], lo[3]);
}

// The B operand (8 x 8) with B[k][n] = s[k0 + k][n0 + n] of a row-major
// shared tile (lane (g, t): rows t and t + 4, column g).
__device__ __forceinline__ void load_b(const float* s, int ld, int k0, int n0, int g, int t,
                                       unsigned (&hi)[2], unsigned (&lo)[2]) {
  const float* p = s + (k0 + t) * ld + n0 + g;
  split_tf32(p[0], hi[0], lo[0]);
  split_tf32(p[4 * ld], hi[1], lo[1]);
}

// The B operand with B[k][n] = s[n0 + n][c0 + k]: a transposed read of rows
// n0.. (lane (g, t): row g, columns t and t + 4).
__device__ __forceinline__ void load_bt(const float* s, int ld, int n0, int c0, int g, int t,
                                        unsigned (&hi)[2], unsigned (&lo)[2]) {
  const float* p = s + (n0 + g) * ld + c0 + t;
  split_tf32(p[0], hi[0], lo[0]);
  split_tf32(p[4], hi[1], lo[1]);
}

// The B operand with B[k][n] = s[r0 + perm(k)][c0 + n], the contraction
// permuted as the accumulator layout gives it (k = t <-> row 2t, k = t + 4
// <-> row 2t + 1).
__device__ __forceinline__ void load_bp(const float* s, int ld, int r0, int c0, int g, int t,
                                        unsigned (&hi)[2], unsigned (&lo)[2]) {
  const float* p = s + (r0 + 2 * t) * ld + c0 + g;
  split_tf32(p[0], hi[0], lo[0]);
  split_tf32(p[ld], hi[1], lo[1]);
}

// The A operand from an accumulator tile c (rows g, g + 8; columns 2t, 2t + 1),
// split, with the contraction permuted as load_bp reads B.
__device__ __forceinline__ void acc_as_a(const float (&c)[4], unsigned (&hi)[4],
                                         unsigned (&lo)[4]) {
  split_tf32(c[0], hi[0], lo[0]);
  split_tf32(c[2], hi[1], lo[1]);
  split_tf32(c[1], hi[2], lo[2]);
  split_tf32(c[3], hi[3], lo[3]);
}

// Asynchronous global -> shared copies of 16 or 4 bytes; `bytes` below the
// copy's size zero-fills the rest (0: the destination is zeroed and nothing
// is read).
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most N groups of this thread's copies are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_one() { cp_async_wait<1>(); }

}  // namespace
