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
// All three run on the tensor cores at fp32 accuracy (tf32_mma.cuh):
//
// - 3xTF32. Every product is mma.sync m16n8k8 with TF32 operands split as
//   hi + lo and three products per pair, as close to fp32 as a CUDA-core FMA;
//   the bound is 3 FLOPs / 495e12 (the TF32 rate) where fp32 would be
//   FLOPs / 67e12.
// - Partial sums. The tensor cores' fp32 accumulator rounds toward zero, a
//   bias that grows with each product in a chain: summed over 4096 queries
//   in one accumulator, dK / dV / dQ were 4e-5 of their max abs off the
//   plain fp32 version. So o, dv, dk and dq take a fresh accumulator per
//   other-axis tile (add_part), and s and dp one per 8-deep step
//   (mma_3xtf32_rn), each added to the total with an fp32 add (round to
//   nearest). s and dp need the finer step because ds = p (dp - di) cancels:
//   for an item with one valid key p = 1 and dp = di exactly, so its dK is
//   rounding noise, and a chain's bias put it over the fp32 tolerance where
//   per-step sums keep it at the plain fp32 version's own noise.
// - Warps and tiles. A backward block is 4 warps, a forward block 8; each
//   warp owns 16 rows of the block's own axis (queries for the forward and
//   dQ, keys for dK / dV) and computes their s (and dp) against the whole
//   other-axis tile (BN keys or queries), then p (and ds) in registers, then
//   its rows of o, dv / dk or dq. dK / dV finishes dV += p^T do before it computes dp, so s, dp and
//   one partial are never live together with both accumulators. The
//   accumulator layout of s (row g, columns 2t, 2t + 1 of each 8-column
//   tile) is reused as the A operand of the next product without a trip
//   through shared memory: the contraction index of each 8-wide step is
//   permuted (operand column t <-> tile column 2t, t + 4 <-> 2t + 1), and
//   the B operand is read with the same permutation. Where the accumulators
//   would not fit the registers, 2 or 4 warps share each 16 rows and split
//   the head width between them (all compute s and dp): dK / dV above
//   D = 64, the forward and dQ above D = 128. D = 128 and up take 32-row
//   other-axis tiles.
// - The forward's online softmax runs on the accumulator layout: each lane
//   holds rows g and g + 8 of its warp's 16, so the row max and row sum of
//   a key tile reduce over the 4 lanes of a quad (two shuffles), and m, l
//   and the rescale of o by alpha = exp(m - m_new) stay in fp32 registers.
//   A forward block owns 128 queries in 8 warps (104 KB of shared memory at
//   D = 64): on the H100 it measured faster than dQ's 64 queries in 4 warps
//   at D = 64 and 256 and as fast at 128, since it stages each K / V tile
//   for twice the queries.
// - Staging. Tiles of the other axis (k, v for the forward and dQ; q, do,
//   lse, di for dK / dV) stream through a two-stage ring with cp.async:
//   16-byte copies when D % 4 == 0 and the rows are 16-byte aligned, else
//   4-byte ones; the next tile's copy overlaps the current tile's products.
//   Rows have a stride of D + 4 floats (16-byte aligned; 4 mod 32 banks, so
//   the fragment loads of a warp, 8 rows x 4 columns or 4 row pairs x 8
//   columns, hit 32 banks). At D = 64 a dK / dV block takes 104 KB, two
//   blocks per SM.
// - Skipping masked key tiles. In an item with at least one valid key, a
//   key tile whose keys are all masked changes no result, bit for bit. In
//   the forward: once a valid key has been seen, a masked key's
//   p = exp(-1e30 - m) is exactly 0 in fp32 and alpha = 1; masked tiles
//   before the first valid one leave m = -1e30, and the first live tile's
//   alpha = exp(-1e30 - m_new) = 0 exactly wipes what they summed. In the
//   backward a masked key's p = exp(-1e30 - lse) is exactly 0. So the
//   forward and dQ walk (and stage) only live key tiles, and a dK / dV block
//   whose keys are all masked writes zeros and returns. Liveness is read
//   from key_valid on the card (__syncthreads_or over a tile's flags), for
//   any mask, not only suffixes. An item whose keys are all masked is never
//   skipped: there every key scores -1e30, p = 1 and lse rounds to -1e30,
//   as in the plain version. Without key_valid nothing is skipped.
//
// Masking: a key with key_valid < 0.5 scores -1e30 (finite, as in JAX), so a
// query whose keys are all masked gets the mean of v over its Tk keys; keys
// past Tk (tile padding) score -inf and never count.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>
#include <cmath>

#include "tf32_mma.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// The key's class: 0 attends, 1 is masked (scores -1e30), 2 lies past Tk.
__device__ __forceinline__ int key_class(int col, int tk, const float* valid) {
  if (col >= tk) return 2;
  return (valid != nullptr && __ldg(valid + col) < 0.5f) ? 1 : 0;
}

__device__ __forceinline__ float masked_score(float dot, float scale, int cls) {
  return cls == 0 ? dot * scale : (cls == 1 ? kNegInf : -INFINITY);
}

constexpr int kBwdWarps = 4;
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kFwdWarps = 8;
constexpr int kFwdThreads = 32 * kFwdWarps;

// The tiles at padded head width DP for a block of WARPS warps: SPLIT warps
// share each 16 rows of the block's own axis and split the head width of
// their accumulators, so the block owns ROWS rows; BN rows of the other axis
// per step; shared row stride LD. The forward takes dQ's split (one
// accumulator of the head width, beside its partial) with kFwdWarps warps.
template <int DP, int SPLIT, int WARPS = kBwdWarps>
struct BwdTile {
  static constexpr int ROWS = 16 * WARPS / SPLIT;
  static constexpr int BN = DP > 64 ? 32 : 64;
  static constexpr int LD = DP + 4;
  static constexpr int NT = BN / 8;           // 8-wide tiles of the other axis
  static constexpr int NC = DP / SPLIT / 8;   // 8-wide tiles of a warp's accumulators
};

// dK / dV keeps two accumulators of the head width and dQ one, so dK / dV
// splits the head width among warps from a narrower D on.
__host__ __device__ constexpr int dkv_split(int dp) { return dp <= 64 ? 1 : dp <= 128 ? 2 : 4; }
__host__ __device__ constexpr int dq_split(int dp) { return dp <= 128 ? 1 : 2; }

// c[n] = the warp's 16 rows (r0..) of `a` times rows 8 n.. of `b`, over the
// padded head width DP: s = Q K^T for the forward, s = K Q^T, dp = V dO^T
// for dK / dV, s = Q K^T, dp = dO V^T for dQ.
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
// 0..BN at columns c0 + 8 n..: o += p V, dV += p^T dO, dK += ds^T Q,
// dQ += ds K.
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

// Rows [0, rows) of a row-major (., d) tensor into an R x (DP + 4) shared
// tile, asynchronously; rows past `rows` and columns past d are zero-filled.
// vec: d % 4 == 0 and 16-byte aligned rows, so 16-byte copies. NTH: the
// block's threads.
template <int R, int DP, int NTH = kBwdThreads>
__device__ __forceinline__ void stage_tile(float* dst, const float* __restrict__ src, int rows,
                                           int d, bool vec) {
  constexpr int LD = DP + 4;
  if (vec) {
    for (int e = threadIdx.x; e < R * (DP / 4); e += NTH) {
      const int r = e / (DP / 4), c = 4 * (e - r * (DP / 4));
      const bool in = r < rows && c < d;
      cp_async16(dst + r * LD + c, in ? src + static_cast<size_t>(r) * d + c : src, in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < R * DP; e += NTH) {
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
  for (int e = threadIdx.x; e < n && k0 + e < tk; e += blockDim.x)
    any = any || !(__ldg(valid + k0 + e) < 0.5f);
  return __syncthreads_or(any) != 0;
}

// The first BN-key tile from `t` on with a valid key, or `tiles`.
__device__ __forceinline__ int next_live(const float* valid, int t, int tiles, int bn, int tk) {
  while (t < tiles && !any_valid(valid, t * bn, bn, tk)) ++t;
  return t;
}

// One block per (n * h, ROWS-row query tile): o and, when lse is not null,
// the row logsumexp, over the live BN-key tiles.
template <int DP>
__global__ void __launch_bounds__(kFwdThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ key_valid,
                     float* __restrict__ o, float* __restrict__ lse, int heads, int tq,
                     int tk, int d, float scale, int vec) {
  using T = BwdTile<DP, dq_split(DP), kFwdWarps>;
  constexpr int LD = T::LD, R = T::ROWS, BN = T::BN, NT = T::NT, NC = T::NC;
  constexpr int STAGE = 2 * BN * LD;  // k, v of one key tile
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* ring = Qs + R * LD;

  const int q_tiles = (tq + R - 1) / R;
  const int b = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x - b * q_tiles) * R;
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int r0 = 16 * (warp % (R / 16)), c0 = 8 * NC * (warp / (R / 16));
  const float* valid = key_valid ? key_valid + static_cast<size_t>(b / heads) * tk : nullptr;
  const float* kb = k + static_cast<size_t>(b) * tk * d;
  const float* vb = v + static_cast<size_t>(b) * tk * d;
  auto stage = [&](int kt, float* st) {
    const int k0 = kt * BN;
    stage_tile<BN, DP, kFwdThreads>(st, kb + static_cast<size_t>(k0) * d, tk - k0, d, vec);
    stage_tile<BN, DP, kFwdThreads>(st + BN * LD, vb + static_cast<size_t>(k0) * d, tk - k0, d,
                                    vec);
  };

  // Key tiles with no valid key are skipped when the item has a valid key
  // (they change neither o nor lse); in an item with none, every key has
  // p = 1 and no tile is skipped.
  const int k_tiles = (tk + BN - 1) / BN;
  int kt = valid != nullptr ? next_live(valid, 0, k_tiles, BN, tk) : 0;
  const bool skip = kt < k_tiles && valid != nullptr;
  if (!skip) kt = 0;
  stage_tile<R, DP, kFwdThreads>(Qs, q + (static_cast<size_t>(b) * tq + q0) * d, tq - q0, d, vec);
  stage(kt, ring);
  cp_async_commit();

  // rows g and g + 8 of the warp's 16: running max, denominator, o
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f}, o_acc[NC][4], part[NC][4];
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[n][e] = part[n][e] = 0.f;

  for (int it = 0; kt < k_tiles; ++it) {
    const int next = skip ? next_live(valid, kt + 1, k_tiles, BN, tk) : kt + 1;
    if (next < k_tiles) stage(next, ring + ((it + 1) & 1) * STAGE);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();  // this tile's copies, from every thread, have landed
    const float* Ks = ring + (it & 1) * STAGE;
    const float* Vs = Ks + BN * LD;

    // s = Q K^T scale, masked, on the warp's 16 queries x BN keys (rows g,
    // g + 8; key columns 8 n + 2 t, + 1), and its row max over the quad
    float s[NT][4];
    row_products<DP>(Qs, Ks, LD, r0, g, t, s);
    const int k0 = kt * BN;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int cls[2] = {key_class(k0 + 8 * n + 2 * t, tk, valid),
                          key_class(k0 + 8 * n + 2 * t + 1, tk, valid)};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = masked_score(s[n][e], scale, cls[e & 1]);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_r[i], mx[i]);
      alpha[i] = expf(m_r[i] - m_new);
      m_r[i] = m_new;
    }
    // p = exp(s - m) in place, its row sums, and o rescaled by alpha
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m_r[e >> 1]);
        sum[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l_r[i] = l_r[i] * alpha[i] + sum[i];
    }
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o_acc[n][e] *= alpha[e >> 1];
    // o += P V over the tile's keys, in a fresh accumulator
    tile_products(s, Vs, LD, c0, g, t, part);
    add_part(o_acc, part);
    __syncthreads();  // the stage is read before the next copy overwrites it
    kt = next;
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + g + 8 * i;
    if (row >= tq) continue;
    const float denom = fmaxf(l_r[i], 1e-30f);
    float* orow = o + (static_cast<size_t>(b) * tq + row) * d;
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + 8 * n + 2 * t + e;
        if (col < d) orow[col] = o_acc[n][2 * i + e] / denom;
      }
    if (lse != nullptr && c0 == 0 && t == 0)
      lse[static_cast<size_t>(b) * tq + row] = m_r[i] + logf(denom);
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

// 16-byte copies need d % 4 == 0 and 16-byte aligned tensors.
int vec_rows(int d, const float* q, const float* k, const float* v, const float* dout) {
  const auto bits = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout);
  return d % 4 == 0 && bits % 16 == 0;
}

template <int DP>
int forward(const Shape& s, const float* q, const float* k, const float* v,
            const float* key_valid, float* o, float* lse, cudaStream_t st) {
  using T = BwdTile<DP, dq_split(DP), kFwdWarps>;
  const size_t smem = sizeof(float) * (T::ROWS * T::LD + 2 * (2 * T::BN * T::LD));
  return launch(flash_fwd_kernel<DP>, kFwdThreads, s.bh * tiles(s.tq, T::ROWS), smem, st, q, k,
                v, key_valid, o, lse, s.heads, s.tq, s.tk, s.d, s.scale,
                vec_rows(s.d, q, k, v, q));
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
