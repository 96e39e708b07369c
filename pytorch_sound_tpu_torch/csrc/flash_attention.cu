// Flash attention on fp32 (N * H, T, D) tensors: the forward (o and the
// row logsumexp), and the backward as two kernels, dK / dV and dQ.
//
// Replaces the TPU kernels of pytorch_sound_tpu/ops/pallas/flash_attention.py:
// _kernel (K5a, flash_attention) and _fwd_res_kernel (K5b's forward) by
// flash_attention_forward, _bwd_dkv_kernel by flash_attention_dkv and
// _bwd_dq_kernel by flash_attention_dq.
//
//   forward  s = q k^T / sqrt(D), masked keys -1e30; o = softmax(s) v;
//            lse = m + log(max(l, 1e-30)) per query row
//   dK / dV  p = exp(s - lse); dv = p^T do; dp = do v^T;
//            ds = p (dp - di) / sqrt(D); dk = ds^T q      (di = rowsum(o do))
//   dQ       dq = ds k
//
// What bounds it on an H100: arithmetic. Per (query, key) pair the forward
// does two D-long dot products (4 D FLOPs), dK / dV four (8 D), dQ three
// (6 D); at T = 4096, D = 64 that is ~1,000 FLOPs per byte that must move,
// far above the card's ridge. The (T, T) score matrix never reaches device
// memory.
//
// Common to all three: the TPU grid's sequential KV axis, with its running
// state in VMEM scratch, becomes a loop inside one block. A block owns one
// (n * h, query tile) for the forward and dQ, or one (n * h, key tile) for
// dK / dV, and walks the other axis tile by tile through shared memory;
// nothing is carried between blocks, so no sum needs atomics and every result
// is deterministic (a rerun is bit-identical). The TPU's 128-lane padding of
// D, its lane-replicated m / l / lse buffers and the bf16x3 split are not
// carried over; each head width is padded to the next of 16 / 32 / 64 / 128 /
// 192 / 256 in shared memory only.
//
// The forward: fp32 on the CUDA cores. 256 threads form a 16 x 16 grid over
// each 64 x 64 score tile: thread (ty, tx) owns rows ty * RM + i and columns
// tx + 16 j, so one shared load feeds RM or CN FMAs; tiles have an odd row
// stride (D + 1) so a warp reading 16 rows at one column hits 16 banks; the
// running max and denominator live per row in registers, reduced with
// shuffles.
//
// The backward (dK / dV and dQ) runs on the tensor cores at fp32 accuracy:
//
// - 3xTF32. Every product is mma.sync m16n8k8 with TF32 operands and an fp32
//   accumulator. Each operand x is split as hi + lo, hi = x rounded to TF32
//   (10 mantissa bits) and lo = x - hi (split_tf32), and a b accumulates
//   lo_a hi_b + hi_a lo_b + hi_a hi_b: the dropped lo_a lo_b is ~2^-22 of the
//   product, so each product is as close to fp32 as a CUDA-core FMA (one
//   TF32 pass would be ~1e-3 off). The 3x work runs at the 495 TFLOP/s TF32
//   rate, 7x the 67 TFLOP/s fp32 CUDA-core peak, so the bound is 3 FLOPs /
//   495e12 where the forward's is FLOPs / 67e12.
// - Partial sums. The tensor cores' fp32 accumulator rounds toward zero, a
//   bias that grows with each product in a chain: summed over 4096 queries
//   in one accumulator, dK / dV / dQ were 4e-5 of their max abs off the
//   plain fp32 version. So dv, dk and dq take a fresh accumulator per
//   other-axis tile (add_part), and s and dp one per 8-deep step
//   (mma_3xtf32_rn), each added to the total with an fp32 add (round to
//   nearest). s and dp need the finer step because ds = p (dp - di) cancels:
//   for an item with one valid key p = 1 and dp = di exactly, so its dK is
//   rounding noise, and a chain's bias put it over the fp32 tolerance where
//   per-step sums keep it at the plain fp32 version's own noise.
// - Warps and tiles. A block is 4 warps; each warp owns 16 rows of the
//   block's own axis (keys for dK / dV, queries for dQ) and computes their
//   s and dp against the whole other-axis tile (BN keys or queries), then
//   p and ds in registers, then its rows of dv / dk or dq. dK / dV finishes
//   dV += p^T do before it computes dp, so s, dp and one partial are never
//   live together with both accumulators. The accumulator layout of s (row
//   g, columns 2t, 2t + 1 of each 8-column tile) is reused as the A operand
//   of the next product without a trip through shared memory: the
//   contraction index of each 8-wide step is permuted (operand column t <->
//   tile column 2t, t + 4 <-> 2t + 1), and the B operand is read with the
//   same permutation. Where the accumulators would not fit the registers,
//   2 or 4 warps share each 16 rows and split the head width between them
//   (both compute s and dp): dK / dV above D = 64, dQ above D = 128. D = 128
//   and up take 32-row other-axis tiles.
// - Staging. Tiles of the other axis (q, do, lse, di for dK / dV; k, v for
//   dQ) stream through a two-stage ring with cp.async: 16-byte copies when
//   D % 4 == 0 and the rows are 16-byte aligned, else 4-byte ones; the next
//   tile's copy overlaps the current tile's products. Rows have a stride of
//   D + 4 floats (16-byte aligned; 4 mod 32 banks, so the fragment loads of
//   a warp, 8 rows x 4 columns or 4 row pairs x 8 columns, hit 32 banks).
//   At D = 64 a block takes 104 KB, two blocks per SM.
// - Skipping masked key tiles. For an item with at least one valid key a
//   masked key's p = exp(-1e30 - lse) is exactly 0 in fp32, so a key tile
//   whose keys are all masked changes nothing: its dK / dV block writes
//   zeros and returns, and the dQ loop skips it (the copy too). Liveness is
//   read from key_valid on the card (__syncthreads_or over a tile's flags),
//   for any mask, not only suffixes. An item whose keys are all masked is
//   never skipped: there lse rounds to -1e30 and every masked key has p = 1,
//   as in the plain version.
//
// Masking: a key with key_valid < 0.5 scores -1e30 (finite, as in JAX), so a
// query whose keys are all masked gets the mean of v over its Tk keys; keys
// past Tk (tile padding) score -inf and never count.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>
#include <cmath>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid of threads over each score tile
constexpr float kNegInf = -1e30f;

// Rows [0, rows) of a row-major (., d) tensor into a BR x (DP + 1) shared
// tile; rows past `rows` and columns past d are zero.
template <int BR, int DP>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          int rows, int d) {
  constexpr int LD = DP + 1;
  for (int e = threadIdx.x; e < BR * DP; e += kThreads) {
    const int r = e / DP, c = e - r * DP;
    dst[r * LD + c] =
        (r < rows && c < d) ? __ldg(src + static_cast<size_t>(r) * d + c) : 0.f;
  }
}

// s[i][j] = sum_c A[ty * RM + i][c] B[tx + 16 j][c] over one padded head width.
template <int RM, int CN, int DP>
__device__ __forceinline__ void dot_tile(const float* A, const float* B, int ty,
                                         int tx, float (&s)[RM][CN]) {
  constexpr int LD = DP + 1;
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int c = 0; c < DP; ++c) {
    float a[RM], b[CN];
#pragma unroll
    for (int i = 0; i < RM; ++i) a[i] = A[(ty * RM + i) * LD + c];
#pragma unroll
    for (int j = 0; j < CN; ++j) b[j] = B[(tx + 16 * j) * LD + c];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

// acc[i][j] += sum_c P[ty * RM + i][c] X[c][tx + 16 j], c < BC; P has row
// stride BC + 1, X row stride DP + 1.
template <int RM, int BC, int DP>
__device__ __forceinline__ void acc_tile(const float* P, const float* X, int ty,
                                         int tx, float (&acc)[RM][DP / 16]) {
  constexpr int LD = DP + 1;
#pragma unroll 4
  for (int c = 0; c < BC; ++c) {
    float p[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) p[i] = P[(ty * RM + i) * (BC + 1) + c];
#pragma unroll
    for (int j = 0; j < DP / 16; ++j) {
      const float x = X[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i) acc[i][j] = fmaf(p[i], x, acc[i][j]);
    }
  }
}

// Reductions over the 16 threads of a tile row (the low four lane bits).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The key's class: 0 attends, 1 is masked (scores -1e30), 2 lies past Tk.
__device__ __forceinline__ int key_class(int col, int tk, const float* valid) {
  if (col >= tk) return 2;
  return (valid != nullptr && __ldg(valid + col) < 0.5f) ? 1 : 0;
}

__device__ __forceinline__ float masked_score(float dot, float scale, int cls) {
  return cls == 0 ? dot * scale : (cls == 1 ? kNegInf : -INFINITY);
}

// One block per (n * h, BQ-row query tile): o and, when lse is not null, the
// row logsumexp, over BK-key tiles.
template <int DP, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ key_valid,
                     float* __restrict__ o, float* __restrict__ lse, int heads,
                     int tq, int tk, int d, float scale) {
  constexpr int LD = DP + 1, RM = BQ / 16, CN = BK / 16, NJ = DP / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;  // BQ x (BK + 1)

  const int q_tiles = (tq + BQ - 1) / BQ;
  const int b = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x - b * q_tiles) * BQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* valid = key_valid ? key_valid + static_cast<size_t>(b / heads) * tk : nullptr;
  const float* kb = k + static_cast<size_t>(b) * tk * d;
  const float* vb = v + static_cast<size_t>(b) * tk * d;
  load_tile<BQ, DP>(Qs, q + (static_cast<size_t>(b) * tq + q0) * d, tq - q0, d);

  float m[RM], l[RM], acc[RM][NJ];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < tk; k0 += BK) {
    __syncthreads();  // the last tile's Ps and Vs are read
    load_tile<BK, DP>(Ks, kb + static_cast<size_t>(k0) * d, tk - k0, d);
    load_tile<BK, DP>(Vs, vb + static_cast<size_t>(k0) * d, tk - k0, d);
    __syncthreads();
    float s[RM][CN];
    dot_tile<RM, CN, DP>(Qs, Ks, ty, tx, s);
    int cls[CN];
#pragma unroll
    for (int j = 0; j < CN; ++j) cls[j] = key_class(k0 + tx + 16 * j, tk, valid);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        s[i][j] = masked_score(s[i][j], scale, cls[j]);
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[(ty * RM + i) * (BK + 1) + tx + 16 * j] = p;
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    acc_tile<RM, BK, DP>(Ps, Vs, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q0 + ty * RM + i;
    if (row >= tq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* orow = o + (static_cast<size_t>(b) * tq + row) * d;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col < d) orow[col] = acc[i][j] / denom;
    }
    if (lse != nullptr && tx == 0) lse[static_cast<size_t>(b) * tq + row] = m[i] + logf(denom);
  }
}


// ---- the backward: 3xTF32 mma.sync, cp.async two-stage ring ----

constexpr int kBwdWarps = 4;
constexpr int kBwdThreads = 32 * kBwdWarps;

// The backward's tiles at padded head width DP: SPLIT warps share each 16
// rows of the block's own axis and split the head width of their
// accumulators, so the block owns ROWS rows; BN rows of the other axis per
// step; shared row stride LD.
template <int DP, int SPLIT>
struct BwdTile {
  static constexpr int ROWS = 16 * kBwdWarps / SPLIT;
  static constexpr int BN = DP > 64 ? 32 : 64;
  static constexpr int LD = DP + 4;
  static constexpr int NT = BN / 8;           // 8-wide tiles of the other axis
  static constexpr int NC = DP / SPLIT / 8;   // 8-wide tiles of a warp's accumulators
};

// dK / dV keeps two accumulators of the head width and dQ one, so dK / dV
// splits the head width among warps from a narrower D on.
__host__ __device__ constexpr int dkv_split(int dp) { return dp <= 64 ? 1 : dp <= 128 ? 2 : 4; }
__host__ __device__ constexpr int dq_split(int dp) { return dp <= 128 ? 1 : 2; }

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
// never compounds along c: s and dp, on which ds = p (dp - di) cancels.
__device__ __forceinline__ void mma_3xtf32_rn(float (&c)[4], const unsigned (&ah)[4],
                                              const unsigned (&al)[4], const unsigned (&bh)[2],
                                              const unsigned (&bl)[2]) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_3xtf32(t, ah, al, bh, bl);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += t[e];
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

// The B operand (8 x 8) with B[k][n] = s[n0 + n][c0 + k]: a transposed read
// of rows n0.. (lane (g, t): row g, columns t and t + 4).
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

// c[n] = the warp's 16 rows (r0..) of `a` times rows 8 n.. of `b`, over the
// padded head width DP: s = K Q^T, dp = V dO^T for dK / dV, s = Q K^T,
// dp = dO V^T for dQ.
template <int DP, int NT>
__device__ __forceinline__ void row_products(const float* a, const float* b, int ld, int r0,
                                             int g, int t, float (&c)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < DP; kk += 8) {
    unsigned ah[4], al[4];
    load_a(a, ld, r0, kk, g, t, ah, al);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      unsigned bh[2], bl[2];
      load_bt(b, ld, 8 * n, kk, g, t, bh, bl);
      mma_3xtf32_rn(c[n], ah, al, bh, bl);
    }
  }
}

// part[n] += a b: the warp's accumulator tile `a` (16 rows x BN other-axis
// columns, as row_products leaves it) as the A operand, times `b`'s rows
// 0..BN at columns c0 + 8 n..: dV += p^T dO, dK += ds^T Q, dQ += ds K.
template <int NT, int NC>
__device__ __forceinline__ void tile_products(const float (&a)[NT][4], const float* b, int ld,
                                              int c0, int g, int t, float (&part)[NC][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    unsigned ah[4], al[4];
    acc_as_a(a[j], ah, al);
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      unsigned bh[2], bl[2];
      load_bp(b, ld, 8 * j, c0 + 8 * n, g, t, bh, bl);
      mma_3xtf32(part[n], ah, al, bh, bl);
    }
  }
}

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

// Wait until at most one group of this thread's copies is in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// Rows [0, rows) of a row-major (., d) tensor into an R x (DP + 4) shared
// tile, asynchronously; rows past `rows` and columns past d are zero-filled.
// vec: d % 4 == 0 and 16-byte aligned rows, so 16-byte copies.
template <int R, int DP>
__device__ __forceinline__ void stage_tile(float* dst, const float* __restrict__ src, int rows,
                                           int d, bool vec) {
  constexpr int LD = DP + 4;
  if (vec) {
    for (int e = threadIdx.x; e < R * (DP / 4); e += kBwdThreads) {
      const int r = e / (DP / 4), c = 4 * (e - r * (DP / 4));
      const bool in = r < rows && c < d;
      cp_async16(dst + r * LD + c, in ? src + static_cast<size_t>(r) * d + c : src, in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < R * DP; e += kBwdThreads) {
      const int r = e / DP, c = e - r * DP;
      const bool in = r < rows && c < d;
      cp_async4(dst + r * LD + c, in ? src + static_cast<size_t>(r) * d + c : src, in ? 4 : 0);
    }
  }
}

// True when a key of [k0, min(k0 + n, tk)) is valid (key_class 0); a barrier,
// so every thread of the block calls it.
__device__ __forceinline__ bool any_valid(const float* valid, int k0, int n, int tk) {
  bool any = false;
  for (int e = threadIdx.x; e < n && k0 + e < tk; e += kBwdThreads)
    any = any || !(__ldg(valid + k0 + e) < 0.5f);
  return __syncthreads_or(any) != 0;
}

// The first BN-key tile from `t` on with a valid key, or `tiles`.
__device__ __forceinline__ int next_live(const float* valid, int t, int tiles, int bn, int tk) {
  while (t < tiles && !any_valid(valid, t * bn, bn, tk)) ++t;
  return t;
}

// acc += part, in fp32 with round to nearest: the tensor cores' accumulator
// rounds toward zero, so each tile's products are summed apart and added
// here, which keeps the biased rounding to one tile's chain of products.
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

// One block per (n * h, ROWS-key tile): dK and dV over BN-row query tiles.
template <int DP>
__global__ void __launch_bounds__(kBwdThreads)
    flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ key_valid,
                     const float* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ di, float* __restrict__ dk,
                     float* __restrict__ dv, int heads, int tq, int tk, int d, float scale,
                     int vec) {
  using T = BwdTile<DP, dkv_split(DP)>;
  constexpr int LD = T::LD, R = T::ROWS, BN = T::BN, NT = T::NT, NC = T::NC;
  constexpr int STAGE = 2 * BN * LD + 2 * BN;  // q, do, lse, di of one query tile
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + R * LD;
  float* ring = Vs + R * LD;

  const int k_tiles = (tk + R - 1) / R;
  const int b = blockIdx.x / k_tiles;
  const int k0 = (blockIdx.x - b * k_tiles) * R;
  const float* valid = key_valid ? key_valid + static_cast<size_t>(b / heads) * tk : nullptr;
  const size_t kbase = (static_cast<size_t>(b) * tk + k0) * d;
  // a tile of masked keys in an item with a valid key: p = 0, so dk = dv = 0
  if (valid != nullptr && !any_valid(valid, k0, R, tk) && any_valid(valid, 0, tk, tk)) {
    const int n = min(R, tk - k0) * d;
    for (int e = threadIdx.x; e < n; e += kBwdThreads) dk[kbase + e] = dv[kbase + e] = 0.f;
    return;
  }

  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int r0 = 16 * (warp % (R / 16)), c0 = 8 * NC * (warp / (R / 16));
  const float* qb = q + static_cast<size_t>(b) * tq * d;
  const float* dob = dout + static_cast<size_t>(b) * tq * d;
  const float* lseb = lse + static_cast<size_t>(b) * tq;
  const float* dib = di + static_cast<size_t>(b) * tq;
  auto stage = [&](int q0, float* st) {
    stage_tile<BN, DP>(st, qb + static_cast<size_t>(q0) * d, tq - q0, d, vec);
    stage_tile<BN, DP>(st + BN * LD, dob + static_cast<size_t>(q0) * d, tq - q0, d, vec);
    for (int e = threadIdx.x; e < BN; e += kBwdThreads) {
      const int row = q0 + e < tq ? q0 + e : 0;
      cp_async4(st + 2 * BN * LD + e, lseb + row, q0 + e < tq ? 4 : 0);
      cp_async4(st + 2 * BN * LD + BN + e, dib + row, q0 + e < tq ? 4 : 0);
    }
  };
  stage_tile<R, DP>(Ks, k + kbase, tk - k0, d, vec);
  stage_tile<R, DP>(Vs, v + kbase, tk - k0, d, vec);
  stage(0, ring);
  cp_async_commit();
  const int cls[2] = {key_class(k0 + r0 + g, tk, valid), key_class(k0 + r0 + g + 8, tk, valid)};

  float dk_acc[NC][4], dv_acc[NC][4], part[NC][4];
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = part[n][e] = 0.f;

  const int q_tiles = (tq + BN - 1) / BN;
  for (int it = 0; it < q_tiles; ++it) {
    if (it + 1 < q_tiles) stage((it + 1) * BN, ring + ((it + 1) & 1) * STAGE);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();  // this tile's copies, from every thread, have landed
    const float* Qs = ring + (it & 1) * STAGE;
    const float* dOs = Qs + BN * LD;
    const float* lse_s = dOs + BN * LD;
    const float* di_s = lse_s + BN;
    const int q0 = it * BN;

    // p = exp(K Q^T scale - lse) on the warp's 16 keys x BN queries (rows g,
    // g + 8; query columns 8 n + 2 t, + 1)
    float s[NT][4];
    row_products<DP>(Ks, Qs, LD, r0, g, t, s);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * n + 2 * t + (e & 1);
        s[n][e] = q0 + qc < tq
                      ? expf(masked_score(s[n][e], scale, cls[e >> 1]) - lse_s[qc])
                      : 0.f;
      }
    // dV += P^T dO over the tile's queries
    tile_products(s, dOs, LD, c0, g, t, part);
    add_part(dv_acc, part);
    // ds = p (V dO^T - di) scale, then dK += dS^T Q
    float ds[NT][4];
    row_products<DP>(Vs, dOs, LD, r0, g, t, ds);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[n][e] = s[n][e] * (ds[n][e] - di_s[8 * n + 2 * t + (e & 1)]) * scale;
    tile_products(ds, Qs, LD, c0, g, t, part);
    add_part(dk_acc, part);
    __syncthreads();  // the stage is read before the next copy overwrites it
  }

#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int row = k0 + r0 + g + 8 * (e >> 1);
    if (row >= tk) continue;
    const size_t off = (static_cast<size_t>(b) * tk + row) * d;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int col = c0 + 8 * n + 2 * t + (e & 1);
      if (col < d) {
        dk[off + col] = dk_acc[n][e];
        dv[off + col] = dv_acc[n][e];
      }
    }
  }
}

// One block per (n * h, ROWS-row query tile): dQ over the live BN-key tiles.
template <int DP>
__global__ void __launch_bounds__(kBwdThreads)
    flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ key_valid,
                    const float* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ di, float* __restrict__ dq, int heads, int tq,
                    int tk, int d, float scale, int vec) {
  using T = BwdTile<DP, dq_split(DP)>;
  constexpr int LD = T::LD, R = T::ROWS, BN = T::BN, NT = T::NT, NC = T::NC;
  constexpr int STAGE = 2 * BN * LD;  // k, v of one key tile
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + R * LD;
  float* ring = dOs + R * LD;

  const int q_tiles = (tq + R - 1) / R;
  const int b = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x - b * q_tiles) * R;
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int r0 = 16 * (warp % (R / 16)), c0 = 8 * NC * (warp / (R / 16));
  const float* valid = key_valid ? key_valid + static_cast<size_t>(b / heads) * tk : nullptr;
  const size_t qbase = (static_cast<size_t>(b) * tq + q0) * d;
  const float* kb = k + static_cast<size_t>(b) * tk * d;
  const float* vb = v + static_cast<size_t>(b) * tk * d;
  auto stage = [&](int kt, float* st) {
    const int k0 = kt * BN;
    stage_tile<BN, DP>(st, kb + static_cast<size_t>(k0) * d, tk - k0, d, vec);
    stage_tile<BN, DP>(st + BN * LD, vb + static_cast<size_t>(k0) * d, tk - k0, d, vec);
  };

  // Key tiles with no valid key are skipped when the item has a valid key;
  // in an item with none, every key has p = 1 and no tile is skipped.
  const int k_tiles = (tk + BN - 1) / BN;
  int kt = valid != nullptr ? next_live(valid, 0, k_tiles, BN, tk) : 0;
  const bool skip = kt < k_tiles && valid != nullptr;
  if (!skip) kt = 0;
  stage_tile<R, DP>(Qs, q + qbase, tq - q0, d, vec);
  stage_tile<R, DP>(dOs, dout + qbase, tq - q0, d, vec);
  stage(kt, ring);
  cp_async_commit();

  float lse_r[2], di_r[2], dq_acc[NC][4], part[NC][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + g + 8 * i;
    const bool in = row < tq;  // a padded row's p is exp(s - inf) = 0
    lse_r[i] = in ? __ldg(lse + static_cast<size_t>(b) * tq + row) : INFINITY;
    di_r[i] = in ? __ldg(di + static_cast<size_t>(b) * tq + row) : 0.f;
  }
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[n][e] = part[n][e] = 0.f;

  for (int it = 0; kt < k_tiles; ++it) {
    const int next = skip ? next_live(valid, kt + 1, k_tiles, BN, tk) : kt + 1;
    if (next < k_tiles) stage(next, ring + ((it + 1) & 1) * STAGE);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();  // this tile's copies, from every thread, have landed
    const float* Ks = ring + (it & 1) * STAGE;
    const float* Vs = Ks + BN * LD;

    // s = Q K^T and dp = dO V^T on the warp's 16 queries x BN keys
    float s[NT][4], dp[NT][4];
    row_products<DP>(Qs, Ks, LD, r0, g, t, s);
    row_products<DP>(dOs, Vs, LD, r0, g, t, dp);
    // ds into dp (rows g, g + 8; key columns 8 n + 2 t, + 1)
    const int k0 = kt * BN;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int cls[2] = {key_class(k0 + 8 * n + 2 * t, tk, valid),
                          key_class(k0 + 8 * n + 2 * t + 1, tk, valid)};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(masked_score(s[n][e], scale, cls[e & 1]) - lse_r[e >> 1]);
        dp[n][e] = p * (dp[n][e] - di_r[e >> 1]) * scale;
      }
    }
    // dQ += dS K over the tile's keys
    tile_products(dp, Ks, LD, c0, g, t, part);
    add_part(dq_acc, part);
    __syncthreads();  // the stage is read before the next copy overwrites it
    kt = next;
  }

#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int row = q0 + r0 + g + 8 * (e >> 1);
    if (row >= tq) continue;
    float* dqrow = dq + (static_cast<size_t>(b) * tq + row) * d;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int col = c0 + 8 * n + 2 * t + (e & 1);
      if (col < d) dqrow[col] = dq_acc[n][e];
    }
  }
}

struct Shape {
  int bh, heads, tq, tk, d;
  float scale;
};

bool valid_shape(const Shape& s) {
  return s.bh >= 1 && s.heads >= 1 && s.bh % s.heads == 0 && s.tq >= 1 && s.tk >= 1 &&
         s.d >= 1 && s.d <= 256;
}

// Launch `kernel` on `blocks` blocks of `threads` with `smem` bytes of dynamic
// shared memory, raising the block's limit past 48 KB first.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int threads, long long blocks, size_t smem, cudaStream_t stream,
           Args... args) {
  if (blocks < 1 || blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

long long tiles(int t, int tile) { return (t + tile - 1) / tile; }

template <int DP>
int forward(const Shape& s, const float* q, const float* k, const float* v,
            const float* key_valid, float* o, float* lse, cudaStream_t st) {
  constexpr int BQ = 64, BK = 64, LD = DP + 1;
  const size_t smem = sizeof(float) * ((BQ + 2 * BK) * LD + BQ * (BK + 1));
  return launch(flash_fwd_kernel<DP, BQ, BK>, kThreads, s.bh * tiles(s.tq, BQ), smem, st, q, k,
                v, key_valid, o, lse, s.heads, s.tq, s.tk, s.d, s.scale);
}

// 16-byte copies need d % 4 == 0 and 16-byte aligned tensors.
int vec_rows(int d, const float* q, const float* k, const float* v, const float* dout) {
  const auto bits = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout);
  return d % 4 == 0 && bits % 16 == 0;
}

template <int DP>
int dkv(const Shape& s, const float* q, const float* k, const float* v,
        const float* key_valid, const float* dout, const float* lse, const float* di,
        float* dk, float* dv, cudaStream_t st) {
  using T = BwdTile<DP, dkv_split(DP)>;
  const size_t smem = sizeof(float) * (2 * T::ROWS * T::LD + 2 * (2 * T::BN * T::LD + 2 * T::BN));
  return launch(flash_dkv_kernel<DP>, kBwdThreads, s.bh * tiles(s.tk, T::ROWS), smem, st, q, k,
                v, key_valid, dout, lse, di, dk, dv, s.heads, s.tq, s.tk, s.d, s.scale,
                vec_rows(s.d, q, k, v, dout));
}

template <int DP>
int dq(const Shape& s, const float* q, const float* k, const float* v,
       const float* key_valid, const float* dout, const float* lse, const float* di,
       float* dqo, cudaStream_t st) {
  using T = BwdTile<DP, dq_split(DP)>;
  const size_t smem = sizeof(float) * (2 * T::ROWS * T::LD + 2 * (2 * T::BN * T::LD));
  return launch(flash_dq_kernel<DP>, kBwdThreads, s.bh * tiles(s.tq, T::ROWS), smem, st, q, k,
                v, key_valid, dout, lse, di, dqo, s.heads, s.tq, s.tk, s.d, s.scale,
                vec_rows(s.d, q, k, v, dout));
}

// The head width padded in shared memory: 16, 32, 64, 128, 192 or 256.
#define PSTT_BY_HEAD_DIM(FN, ...)                 \
  if (s.d <= 16) return FN<16>(__VA_ARGS__);      \
  if (s.d <= 32) return FN<32>(__VA_ARGS__);      \
  if (s.d <= 64) return FN<64>(__VA_ARGS__);      \
  if (s.d <= 128) return FN<128>(__VA_ARGS__);    \
  if (s.d <= 192) return FN<192>(__VA_ARGS__);    \
  return FN<256>(__VA_ARGS__)

}  // namespace

// o (bh, tq, d) and, when lse is not null, lse (bh, tq) of softmax attention
// of q (bh, tq, d) over k, v (bh, tk, d); key_valid (bh / heads, tk), 1 =
// attend, or null for all keys; scale is 1 / sqrt(d). Returns a cudaError_t;
// 0 when launched.
extern "C" int flash_attention_forward(const float* q, const float* k, const float* v,
                                       const float* key_valid, float* o, float* lse,
                                       int bh, int heads, int tq, int tk, int d,
                                       float scale, void* stream) {
  const Shape s{bh, heads, tq, tk, d, scale};
  if (!valid_shape(s)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  PSTT_BY_HEAD_DIM(forward, s, q, k, v, key_valid, o, lse, st);
}

// dk, dv (bh, tk, d) from the cotangent dout (bh, tq, d), the forward's lse
// and di = rowsum(o * dout) (bh, tq).
extern "C" int flash_attention_dkv(const float* q, const float* k, const float* v,
                                   const float* key_valid, const float* dout,
                                   const float* lse, const float* di, float* dk,
                                   float* dv, int bh, int heads, int tq, int tk, int d,
                                   float scale, void* stream) {
  const Shape s{bh, heads, tq, tk, d, scale};
  if (!valid_shape(s)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  PSTT_BY_HEAD_DIM(dkv, s, q, k, v, key_valid, dout, lse, di, dk, dv, st);
}

// dq (bh, tq, d) from the same inputs.
extern "C" int flash_attention_dq(const float* q, const float* k, const float* v,
                                  const float* key_valid, const float* dout,
                                  const float* lse, const float* di, float* dq_out,
                                  int bh, int heads, int tq, int tk, int d, float scale,
                                  void* stream) {
  const Shape s{bh, heads, tq, tk, d, scale};
  if (!valid_shape(s)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  PSTT_BY_HEAD_DIM(dq, s, q, k, v, key_valid, dout, lse, di, dq_out, st);
}
