// Fused HiFi-GAN generator upsample stage (inference), fp32, and its
// resblock-only mode.
//
// Replaces two TPU kernels:
//
// - fused_generator_stage (pytorch_sound_tpu/ops/pallas/gen_stage.py, body
//   _stage_kernel), entry point gen_stage_forward. One launch computes one
//   whole stage:
//
//     [conv_pre (k odd, pad (k - 1) / 2) on stage 0, masked to [0, T_in)]
//     -> leaky_relu(0.1) -> ConvTranspose1d(2C -> C, stride u, pad (k_up - u) / 2)
//     -> mean of the ResBlock1 stacks, each conv output masked to [0, T_out)
//     [-> leaky_relu(0.01) -> conv_post -> tanh   on the last stage, C <= 64]
//
// - fused_resblock_stage (pytorch_sound_tpu/ops/pallas/resblock.py, body
//   _stage_kernel), entry point resblock_stage_forward: the same kernel with
//   the upsample off. The stage input x (N, C, T) is read straight into the
//   input buffer, masked to [0, T), and the mean of the ResBlock1 stacks is
//   written out.
//
// What bounds it on an H100: arithmetic. The 18 resblock convs of HiFi-GAN
// v1 / v2 are 126 C^2 multiply-adds per output sample (8.26 M at v1's C =
// 256), against 8 bytes of input and output, so a stage is compute bound; the
// unfused version is instead bound by ~14 round trips of the activations
// through device memory.
//
// What the design does about it. A tile of TT output samples and a 64-sample
// halo on each side (HALO >= the 60-sample receptive field of kernels 3/7/11 x
// dilations 1/3/5, plus 3 for conv_post) stays on chip for the whole stage,
// in three (TT + 128)-sample buffers per channel: the stage input h, the
// block's running residual and the intermediate, plus the block sum.
// Activations never leave the chip inside a stage. Each conv only computes
// the positions that later layers still need (the halo shrinks layer by
// layer), and every conv output is multiplied by the sequence-edge mask,
// which reproduces per-layer zero padding exactly. Each thread holds an
// 8-channel x 4-position register tile, so one shared-memory load feeds eight
// FMAs and one weight load four; the tap loop is unrolled for HiFi-GAN's
// kernel sizes; weights are read through the read-only cache and stay
// L2-resident (2 MB at C = 64, 33 MB at C = 256). The transposed conv and
// conv_pre use an 8-channel x 2-position tile, the positions of one
// polyphase phase, so their weight loads (from L2: the buffers leave ~25 KB
// of L1) are shared by the warp and each feeds two FMAs; one output per
// thread, as first written, left them waiting on L2 for half of v1's decode.
//
// Two layouts, by width:
//
// - C <= 64 (single block): one block of 512 threads per (item, tile) holds
//   every channel; the tile is the widest of 1024 ... 64 whose buffers fit
//   the 227 KB a block may use.
// - C = 128 or 256 (cluster): at 256 channels even a 64-sample tile needs
//   662 KB, so a thread-block cluster of C / 32 blocks (384 threads each)
//   owns one (item, tile), each block 32 channels of every buffer. A conv's
//   block computes its own 32 output channels: it reads its own input slice
//   in place and copies each peer's slice of the input rows the conv reads
//   from the peer's shared memory (distributed shared memory) into a staging
//   buffer, one peer after the other in rank order; cluster.sync() stands
//   where the single-block layout has __syncthreads() between convs. A
//   32-channel slice fits a 256-sample tile in 224 KB. On stage 0 every block
//   computes conv_pre for all 2C input rows its transposed conv reads (4 % of
//   the stage's work, done once per block).
//
// Each output's summation order is fixed (input channel, then tap) and does
// not depend on its tile, so a chunked decode matches a whole one. Plain
// fp32 FMA: no tensor cores yet.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>

namespace cg = cooperative_groups;

namespace {

constexpr int kHalo = 64;
// Plan capacity. HiFi-GAN v1 / v2 use 3 blocks of 6 convs; a plan sized to
// exactly that ran ~1.5 % slower per decode on an H100, cause not isolated.
constexpr int kMaxBlocks = 8;
constexpr int kMaxConvs = 32;
constexpr int kThreads = 512;      // single-block layout
constexpr int kWideThreads = 384;  // cluster layout: 12 warps, one per task of
                                   // a 32-channel slice and a 256-sample tile
constexpr int kSlice = 32;         // channels per block in the cluster layout
constexpr int kMaxRanks = 8;       // blocks per cluster (the portable limit)
constexpr int kCoTile = 8;         // output channels per thread
constexpr int kStrip = 4;          // positions per thread, 32 apart (conflict-free)
constexpr int kUpStrip = 2;        // the same in the transposed conv and conv_pre

struct Plan {
  const float* w[kMaxConvs];  // (C, C, k) each, in execution order
  const float* b[kMaxConvs];  // (C,)
  int k[kMaxConvs];
  int d[kMaxConvs];
  int lo[kMaxConvs];          // tile-local output range [lo, hi) of each conv
  int hi[kMaxConvs];
  int rounds[kMaxBlocks];     // conv pairs per ResBlock1
  int n_blocks;
  int h_lo, h_hi;             // range of the stage input the blocks read
  int a_lo, a_hi;             // range of the block sum kept (centre + post halo)
  int ranks;                  // blocks per (item, tile): 1, or the cluster size
  int cs;                     // channels per block: C / ranks
  int xs_off;                 // offset (floats) of the input span in shared memory
};

struct Stage {
  const float* x;             // (n, 2C, t_in); (n, c_mel, t_in) with conv_pre;
                              // (n, C, t_out) without the upsample
  float* out;                 // (n, C, t_out), or (n, 1, t_out) with conv_post
  int c, t_in, t_out;
  int u, k_up, pad, q_stride; // k_up == 0: no upsample (the resblock mode)
  const float* up_w;          // (2C, C, k_up)
  const float* up_b;          // (C,)
  const float* pre_w;         // (2C, c_mel, pre_k)
  const float* pre_b;         // (2C,)
  int c_mel, pre_k;           // pre_k == 0: no conv_pre
  const float* post_w;        // (1, C, post_k)
  const float* post_b;        // (1,)
  int post_k;                 // 0: no conv_post
  int tile_t;
};

// Where one conv runs: this block's channel slice of a tile.
struct Tile {
  int c, cs, ranks, rank, L, base, t_out;
  float* stage;               // peer staging buffer (cs, L); cluster layout only
};

__device__ __forceinline__ float lrelu(float v, float slope) {
  return v > 0.f ? v : v * slope;
}

__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && (a < 0) != (b < 0)) ? q - 1 : q;
}

// Between convs: the whole cluster in the cluster layout (peers read each
// other's buffers), the block otherwise.
__device__ __forceinline__ void stage_sync(int ranks) {
  if (ranks > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// Copies rows [in_lo, in_hi) (widened to 16-byte boundaries) of every channel
// of peer block `peer`'s buffer `src` into the staging buffer, at the same
// offsets. Buffers start at multiples of L floats and L is a multiple of 64,
// so the float4 accesses are aligned.
__device__ void copy_peer_slice(const Tile& tl, const float* src, int peer, int in_lo,
                                int in_hi) {
  const float* from = cg::this_cluster().map_shared_rank(const_cast<float*>(src), peer);
  const int lo4 = in_lo & ~3;
  const int hi4 = min(tl.L, (in_hi + 3) & ~3);
  const int w4 = (hi4 - lo4) / 4;
  for (int e = threadIdx.x; e < tl.cs * w4; e += blockDim.x) {
    const int off = (e / w4) * tl.L + lo4 + 4 * (e % w4);
    *reinterpret_cast<float4*>(tl.stage + off) = *reinterpret_cast<const float4*>(from + off);
  }
}

// dst[co][p] = act(mask(p) * (bias[co] + sum_ci sum_j w[co][ci][j]
//                   * in(src[ci][p + (j - half) * d]))) (+ res[co][p])
// for p in [lo, hi) and this block's output channels co, where in =
// leaky_relu(0.1) if kLreluIn else identity and act = leaky_relu(0.1) if
// kLreluOut else identity. The input channels ci run over every block's slice
// in rank order; a peer's slice is staged first. Each warp takes one task (8
// channels x 128 positions) per wave and keeps its sums in registers across
// the slices. The kernel size kK is fixed at compile time, so the tap loop
// unrolls.
template <int kK, bool kLreluIn, bool kLreluOut>
__device__ void conv_layer(const Tile& tl, const float* src, float* dst, const float* res,
                           const float* __restrict__ w, const float* __restrict__ bias,
                           int d, int lo, int hi) {
  constexpr int k = kK;
  constexpr int half = (k - 1) / 2;
  const int span = 32 * kStrip;
  const int L = tl.L;
  const int n_chunks = (hi - lo + span - 1) / span;
  const int n_tasks = (tl.cs / kCoTile) * n_chunks;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const size_t w_co = static_cast<size_t>(tl.c) * k;   // weight stride per output channel
  for (int wave = 0; wave < n_tasks; wave += n_warps) {
    const int task = wave + warp;
    const bool active = task < n_tasks;
    const int co0 = (task / n_chunks) * kCoTile;       // in this block's slice
    const int p0 = lo + (task % n_chunks) * span + lane;
    float acc[kCoTile][kStrip];
#pragma unroll
    for (int c = 0; c < kCoTile; ++c)
#pragma unroll
      for (int s = 0; s < kStrip; ++s) acc[c][s] = 0.f;
    for (int peer = 0; peer < tl.ranks; ++peer) {
      const bool remote = peer != tl.rank;
      const float* in = src;
      if (remote) {
        copy_peer_slice(tl, src, peer, lo - half * d, hi + half * d);
        __syncthreads();
        in = tl.stage;
      }
      if (active) {
        const float* wp =
            w + (static_cast<size_t>(tl.rank * tl.cs + co0) * tl.c + peer * tl.cs) * k;
        for (int ci = 0; ci < tl.cs; ++ci) {
          const float* row = in + ci * L;
          const float* wrow = wp + ci * k;
#pragma unroll
          for (int j = 0; j < k; ++j) {
            const int off = (j - half) * d;
            float v[kStrip];
#pragma unroll
            for (int s = 0; s < kStrip; ++s) {
              const int p = p0 + 32 * s;
              const float x = p < hi ? row[p + off] : 0.f;
              v[s] = kLreluIn ? lrelu(x, 0.1f) : x;
            }
#pragma unroll
            for (int c = 0; c < kCoTile; ++c) {
              const float wv = __ldg(wrow + c * w_co + j);
#pragma unroll
              for (int s = 0; s < kStrip; ++s) acc[c][s] = fmaf(wv, v[s], acc[c][s]);
            }
          }
        }
      }
      if (remote) __syncthreads();      // the staging buffer is reused
    }
    if (!active) continue;
#pragma unroll
    for (int c = 0; c < kCoTile; ++c) {
      const int co = co0 + c;
      const float bv = __ldg(bias + tl.rank * tl.cs + co);
#pragma unroll
      for (int s = 0; s < kStrip; ++s) {
        const int p = p0 + 32 * s;
        if (p < hi) {
          const int g = tl.base + p;
          float y = (g >= 0 && g < tl.t_out) ? acc[c][s] + bv : 0.f;
          if (kLreluOut) y = lrelu(y, 0.1f);
          if (res != nullptr) y += res[co * L + p];
          dst[co * L + p] = y;
        }
      }
    }
  }
}

// One ResBlock1 conv with its kernel size dispatched to an unrolled instance:
// HiFi-GAN's 3 / 7 / 11, the only sizes the entry points accept.
template <bool kLreluIn, bool kLreluOut>
__device__ void conv_any(const Tile& tl, int k, const float* src, float* dst,
                         const float* res, const float* w, const float* b, int d, int lo,
                         int hi) {
  if (k == 3)
    conv_layer<3, kLreluIn, kLreluOut>(tl, src, dst, res, w, b, d, lo, hi);
  else if (k == 7)
    conv_layer<7, kLreluIn, kLreluOut>(tl, src, dst, res, w, b, d, lo, hi);
  else
    conv_layer<11, kLreluIn, kLreluOut>(tl, src, dst, res, w, b, d, lo, hi);
}

// The input rows the tile's transposed conv reads, q in [q_lo, q_lo +
// q_stride), all 2C channels: leaky_relu(0.1) of x, or of conv_pre(mel)
// computed here, zero outside [0, t_in).
__device__ void load_input_span(const Stage& s, const Plan& plan, float* smem, int n,
                                int q_lo) {
  float* xs = smem + plan.xs_off;
  const int c_in = 2 * s.c;
  if (s.pre_k == 0) {
    const float* xn = s.x + static_cast<size_t>(n) * c_in * s.t_in;
    for (int e = threadIdx.x; e < c_in * s.q_stride; e += blockDim.x) {
      const int ci = e / s.q_stride;
      const int q = q_lo + e % s.q_stride;
      xs[e] = (q >= 0 && q < s.t_in)
                  ? lrelu(__ldg(xn + static_cast<size_t>(ci) * s.t_in + q), 0.1f)
                  : 0.f;
    }
    return;
  }
  // conv_pre: mel rows [q_lo - ph, q_lo + q_stride + ph), zero outside
  // [0, t_in), staged at the start of shared memory (h and the residual are
  // not written yet)
  float* mel = smem;
  const int ph = (s.pre_k - 1) / 2;
  const int m_w = s.q_stride + s.pre_k - 1;
  const float* mn = s.x + static_cast<size_t>(n) * s.c_mel * s.t_in;
  for (int e = threadIdx.x; e < s.c_mel * m_w; e += blockDim.x) {
    const int cm = e / m_w;
    const int q = q_lo - ph + e % m_w;
    mel[e] = (q >= 0 && q < s.t_in) ? __ldg(mn + static_cast<size_t>(cm) * s.t_in + q) : 0.f;
  }
  __syncthreads();
  // a task is 8 rows x 64 positions: each weight load feeds two FMAs, and
  // the 16 sums give each thread independent work
  const int span = 32 * kUpStrip;
  const int n_chunks = (s.q_stride + span - 1) / span;
  const int n_tasks = (c_in / kCoTile) * n_chunks;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t w_ci = static_cast<size_t>(s.c_mel) * s.pre_k;   // weight stride per row
  for (int task = warp; task < n_tasks; task += blockDim.x >> 5) {
    const int ci0 = task / n_chunks * kCoTile;
    const int r0 = task % n_chunks * span + lane;
    float acc[kCoTile][kUpStrip];
#pragma unroll
    for (int c = 0; c < kCoTile; ++c)
#pragma unroll
      for (int t = 0; t < kUpStrip; ++t) acc[c][t] = 0.f;
    for (int cm = 0; cm < s.c_mel; ++cm) {
      const float* mr = mel + cm * m_w;
      const float* wr = s.pre_w + ci0 * w_ci + cm * s.pre_k;
      for (int j = 0; j < s.pre_k; ++j) {
        float v[kUpStrip];
#pragma unroll
        for (int t = 0; t < kUpStrip; ++t) {
          const int r = r0 + 32 * t;
          v[t] = r < s.q_stride ? mr[r + j] : 0.f;
        }
#pragma unroll
        for (int c = 0; c < kCoTile; ++c) {
          const float wv = __ldg(wr + c * w_ci + j);
#pragma unroll
          for (int t = 0; t < kUpStrip; ++t) acc[c][t] = fmaf(wv, v[t], acc[c][t]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kCoTile; ++c) {
      const float bv = __ldg(s.pre_b + ci0 + c);
#pragma unroll
      for (int t = 0; t < kUpStrip; ++t) {
        const int r = r0 + 32 * t;
        const int q = q_lo + r;
        if (r < s.q_stride)
          xs[(ci0 + c) * s.q_stride + r] =
              (q >= 0 && q < s.t_in) ? lrelu(acc[c][t] + bv, 0.1f) : 0.f;
      }
    }
  }
}

// 2. The transposed conv into h, polyphase: output l (global g = base + l) of
// phase r = (g + pad) % u takes taps j = r + m*u from input row (g + pad) / u
// - m; masked to [0, t_out). base is a multiple of u, so the phase and the
// row offset follow from l alone. A task is 8 output channels x 64 outputs of
// one phase, the lanes on consecutive input rows: each weight load feeds two
// FMAs and is the same across the warp.
__device__ void conv_transpose(const Stage& s, const Plan& plan, const float* xs,
                               float* hbuf, int L, int base, int co_base) {
  const int u = s.u;
  const int m_taps = (s.k_up + u - 1) / u;
  const int span = 32 * kUpStrip;
  const int n_chunks = ((plan.h_hi - plan.h_lo + u - 1) / u + span - 1) / span;
  const int n_tasks = (plan.cs / kCoTile) * u * n_chunks;
  const int row0 = (plan.h_lo + s.pad) / u - (m_taps - 1);   // input row of xs[.][0]
  const int c_in = 2 * s.c;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int task = warp; task < n_tasks; task += blockDim.x >> 5) {
    const int co0 = task / (u * n_chunks) * kCoTile;
    const int r = task / n_chunks % u;
    const int a0 = task % n_chunks * span + lane;
    const int l_r = plan.h_lo + ((r - s.pad - plan.h_lo) % u + u) % u;   // first l of phase r
    int l[kUpStrip], q0[kUpStrip];
#pragma unroll
    for (int t = 0; t < kUpStrip; ++t) {
      l[t] = l_r + (a0 + 32 * t) * u;
      q0[t] = (l[t] + s.pad) / u - row0;
    }
    float acc[kCoTile][kUpStrip];
#pragma unroll
    for (int c = 0; c < kCoTile; ++c)
#pragma unroll
      for (int t = 0; t < kUpStrip; ++t) acc[c][t] = 0.f;
    for (int ci = 0; ci < c_in; ++ci) {
      const float* wr = s.up_w + (static_cast<size_t>(ci) * s.c + co_base + co0) * s.k_up;
      const float* xr = xs + ci * s.q_stride;
      for (int m = 0; m < m_taps; ++m) {
        const int j = r + m * u;
        if (j >= s.k_up) break;
        float v[kUpStrip];
#pragma unroll
        for (int t = 0; t < kUpStrip; ++t) v[t] = l[t] < plan.h_hi ? xr[q0[t] - m] : 0.f;
#pragma unroll
        for (int c = 0; c < kCoTile; ++c) {
          const float wv = __ldg(wr + c * s.k_up + j);
#pragma unroll
          for (int t = 0; t < kUpStrip; ++t) acc[c][t] = fmaf(wv, v[t], acc[c][t]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kCoTile; ++c) {
      const int co = co0 + c;
      const float bv = __ldg(s.up_b + co_base + co);
#pragma unroll
      for (int t = 0; t < kUpStrip; ++t) {
        if (l[t] >= plan.h_hi) continue;
        const int g = base + l[t];
        hbuf[co * L + l[t]] = (g >= 0 && g < s.t_out) ? acc[c][t] + bv : 0.f;
      }
    }
  }
}

template <int kNT>
__global__ void __launch_bounds__(kNT) gen_stage_kernel(const Stage s, const Plan plan) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ranks = plan.ranks;
  const int cs = plan.cs;
  const int L = s.tile_t + 2 * kHalo;
  const int A = plan.a_hi - plan.a_lo;
  float* hbuf = smem;               // stage input h            (cs, L)
  float* xb = hbuf + cs * L;        // block running residual   (cs, L)
  float* tb = xb + cs * L;          // conv1 output             (cs, L)
  float* st = tb + cs * L;          // peer staging (cluster)   (cs, L)
  float* acc = st + (ranks > 1 ? cs * L : 0);   // sum over blocks (cs, A)

  const int rank = blockIdx.x % ranks;
  const int n = blockIdx.y;
  const int t0 = (blockIdx.x / ranks) * s.tile_t;
  const int base = t0 - kHalo;      // global position of tile-local index 0
  const int co_base = rank * cs;    // first channel of this block's slice
  const int h_w = plan.h_hi - plan.h_lo;

  if (s.k_up == 0) {
    // 1-2. resblock mode: this block's channels of x, masked to [0, t_out)
    const float* xn = s.x + (static_cast<size_t>(n) * s.c + co_base) * s.t_out;
    for (int e = threadIdx.x; e < cs * h_w; e += blockDim.x) {
      const int co = e / h_w;
      const int l = plan.h_lo + e % h_w;
      const int g = base + l;
      hbuf[co * L + l] =
          (g >= 0 && g < s.t_out) ? __ldg(xn + static_cast<size_t>(co) * s.t_out + g) : 0.f;
    }
  } else {
    // 1. the input rows the tile's transposed conv reads
    const int m_taps = (s.k_up + s.u - 1) / s.u;
    const int q_lo = floor_div(base + plan.h_lo + s.pad, s.u) - (m_taps - 1);
    load_input_span(s, plan, smem, n, q_lo);
    __syncthreads();

    // 2. transposed conv
    conv_transpose(s, plan, smem + plan.xs_off, hbuf, L, base, co_base);
  }
  stage_sync(ranks);

  // 3. ResBlock1 stacks: xb = h; per round xb += conv2(lrelu(conv1(lrelu(xb)))).
  //    conv1 stores lrelu of its (masked) output, which only conv2 reads.
  const Tile tl = {s.c, cs, ranks, rank, L, base, s.t_out, st};
  int ci = 0;
  for (int b = 0; b < plan.n_blocks; ++b) {
    for (int r = 0; r < plan.rounds[b]; ++r) {
      const float* src = r == 0 ? hbuf : xb;
      conv_any<true, true>(tl, plan.k[ci], src, tb, nullptr, plan.w[ci], plan.b[ci],
                           plan.d[ci], plan.lo[ci], plan.hi[ci]);
      ++ci;
      stage_sync(ranks);
      conv_any<false, false>(tl, plan.k[ci], tb, xb, src, plan.w[ci], plan.b[ci],
                             plan.d[ci], plan.lo[ci], plan.hi[ci]);
      ++ci;
      stage_sync(ranks);
    }
    for (int e = threadIdx.x; e < cs * A; e += blockDim.x) {
      const int co = e / A;
      const int l = plan.a_lo + e % A;
      acc[e] = (b == 0 ? 0.f : acc[e]) + xb[co * L + l];
    }
    __syncthreads();
  }

  // 4. mean of the blocks, written out; or conv_post + tanh on the last stage
  const float n_blocks = static_cast<float>(plan.n_blocks);
  if (s.post_k == 0) {
    float* on = s.out + (static_cast<size_t>(n) * s.c + co_base) * s.t_out;
    for (int e = threadIdx.x; e < cs * s.tile_t; e += blockDim.x) {
      const int co = e / s.tile_t;
      const int p = e % s.tile_t;
      const int g = t0 + p;
      if (g < s.t_out)
        on[static_cast<size_t>(co) * s.t_out + g] =
            acc[co * A + kHalo + p - plan.a_lo] / n_blocks;
    }
    return;
  }
  for (int e = threadIdx.x; e < cs * A; e += blockDim.x)
    acc[e] = lrelu(acc[e] / n_blocks, 0.01f);
  __syncthreads();
  const int ph = (s.post_k - 1) / 2;
  float* on = s.out + static_cast<size_t>(n) * s.t_out;
  for (int p = threadIdx.x; p < s.tile_t; p += blockDim.x) {
    const int g = t0 + p;
    if (g >= s.t_out) continue;
    float a = 0.f;
    for (int c = 0; c < s.c; ++c) {
      const float* row = acc + c * A + kHalo + p - ph - plan.a_lo;
      for (int j = 0; j < s.post_k; ++j)
        a = fmaf(row[j], __ldg(s.post_w + c * s.post_k + j), a);
    }
    on[g] = tanhf(a + __ldg(s.post_b));
  }
}

// Plans a tile of tile_t output samples: each conv's output range, walked
// back from the block sum (a conv's output range is what the next layer or
// the block sum reads; its input range is that widened by its reach). Sets
// s.q_stride (the input rows the tile's transposed conv reads) and
// plan.xs_off. Returns the tile's dynamic shared memory in bytes, or 0 when
// a block's receptive field exceeds the halo.
size_t plan_tile(Plan& plan, Stage& s, int tile_t) {
  const int L = tile_t + 2 * kHalo;
  const int ph = s.post_k > 0 ? (s.post_k - 1) / 2 : 0;
  plan.a_lo = kHalo - ph;
  plan.a_hi = kHalo + tile_t + ph;
  plan.h_lo = plan.a_lo;
  plan.h_hi = plan.a_hi;
  int first = 0;
  for (int b = 0; b < plan.n_blocks; ++b) {
    const int nc = 2 * plan.rounds[b];
    int lo = plan.a_lo, hi = plan.a_hi;
    for (int i = first + nc - 1; i >= first; --i) {
      plan.lo[i] = lo;
      plan.hi[i] = hi;
      const int reach = (plan.k[i] - 1) / 2 * plan.d[i];
      lo -= reach;
      hi += reach;
    }
    if (lo < 0 || hi > L) return 0;
    plan.h_lo = std::min(plan.h_lo, lo);
    plan.h_hi = std::max(plan.h_hi, hi);
    first += nc;
  }
  const size_t cs = plan.cs;
  const size_t A = plan.a_hi - plan.a_lo;
  // h, the residual and the intermediate (and the peer staging buffer in the
  // cluster layout), (cs, L) each, and the block sum (cs, A)
  const size_t bufs = ((plan.ranks > 1 ? 4 : 3) * static_cast<size_t>(L) + A) * cs;
  if (s.k_up == 0) {
    s.q_stride = 0;
    plan.xs_off = 0;
    return bufs * sizeof(float);
  }
  const int m_taps = (s.k_up + s.u - 1) / s.u;
  // base = t0 - kHalo is a multiple of u, so the row span is the same for
  // every tile
  s.q_stride = (plan.h_hi - 1 + s.pad) / s.u - (plan.h_lo + s.pad) / s.u + m_taps;
  // the input span (2C, q_stride) reuses the intermediate onwards; conv_pre's
  // mel rows sit before it, in h and the residual
  const size_t mel = s.pre_k > 0 ? static_cast<size_t>(s.c_mel) * (s.q_stride + s.pre_k - 1) : 0;
  const size_t xs_off = std::max(2 * cs * L, mel);
  plan.xs_off = static_cast<int>(xs_off);
  return std::max(bufs, xs_off + 2 * static_cast<size_t>(s.c) * s.q_stride) * sizeof(float);
}

// Fills the plan's convs and layout, picks the widest tile of 1024 ... 64
// output samples whose buffers fit the card (and, in the cluster layout, of
// which at least one cluster can be resident), and launches on `stream`.
int launch(Stage s, Plan plan, int n, int n_convs, const int* conv_k, const int* conv_d,
           const void* const* conv_w, const void* const* conv_b, void* stream) {
  for (int i = 0; i < n_convs; ++i) {
    if ((conv_k[i] != 3 && conv_k[i] != 7 && conv_k[i] != 11) || conv_d[i] < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    plan.w[i] = static_cast<const float*>(conv_w[i]);
    plan.b[i] = static_cast<const float*>(conv_b[i]);
    plan.k[i] = conv_k[i];
    plan.d[i] = conv_d[i];
  }
  if (s.c <= 64) {
    plan.ranks = 1;
  } else if (s.c % kSlice == 0 && s.c / kSlice <= kMaxRanks) {
    plan.ranks = s.c / kSlice;
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  plan.cs = s.c / plan.ranks;
  const bool wide = plan.ranks > 1;
  void (*kernel)(const Stage, const Plan) =
      wide ? gen_stage_kernel<kWideThreads> : gen_stage_kernel<kThreads>;
  const int threads = wide ? kWideThreads : kThreads;

  int device = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);

  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = plan.ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.blockDim = dim3(threads);
  config.stream = static_cast<cudaStream_t>(stream);
  config.attrs = attr;
  config.numAttrs = wide ? 1 : 0;

  size_t bytes = 0;
  for (int t = 1024; t >= kHalo; t /= 2) {
    bytes = plan_tile(plan, s, t);
    if (bytes == 0) return static_cast<int>(cudaErrorInvalidValue);
    if (bytes > static_cast<size_t>(limit)) continue;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    config.gridDim = dim3(((s.t_out + t - 1) / t) * plan.ranks, n);
    config.dynamicSmemBytes = bytes;
    if (wide) {
      int clusters = 0;
      err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (clusters < 1) continue;
    }
    s.tile_t = t;
    break;
  }
  if (s.tile_t == 0) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaLaunchKernelEx(&config, kernel, s, plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Checks and copies the ResBlock1 plan: n_blocks blocks of rounds[b] conv
// pairs. Returns the number of convs, or -1.
int fill_blocks(Plan& plan, int n_blocks, const int* rounds) {
  if (n_blocks < 1 || n_blocks > kMaxBlocks) return -1;
  plan.n_blocks = n_blocks;
  int n_convs = 0;
  for (int b = 0; b < n_blocks; ++b) {
    if (rounds[b] < 1 || n_convs + 2 * rounds[b] > kMaxConvs) return -1;
    plan.rounds[b] = rounds[b];
    n_convs += 2 * rounds[b];
  }
  return n_convs;
}

bool width_ok(int c) {
  return (c >= kCoTile && c <= 64 && c % kCoTile == 0) ||
         (c > 64 && c % kSlice == 0 && c / kSlice <= kMaxRanks);
}

}  // namespace

// x (n, 2c, t_in) -> out (n, c, u * t_in), or (n, 1, u * t_in) when post_k > 0
// (c <= 64: conv_post reads every channel, which one block holds only there).
// With pre_k > 0, x is the mel (n, c_mel, t_in) and conv_pre (pre_w (2c,
// c_mel, pre_k), pre_b (2c,)) runs first. Block b runs rounds[b] conv pairs;
// conv i has kernel conv_k[i] (3, 7 or 11), dilation conv_d[i], weight
// conv_w[i] (c, c, k) and bias conv_b[i] (c,). Widths: c <= 64 a multiple of
// 8 (one block per tile), or a multiple of 32 up to 256 (a cluster of c / 32
// blocks per tile). The host arrays are read before return. Returns a
// cudaError_t; 0 when launched.
extern "C" int gen_stage_forward(const float* x, float* out, int n, int c,
                                 int t_in, int u, int k_up, const float* up_w,
                                 const float* up_b, int n_blocks,
                                 const int* rounds, const int* conv_k,
                                 const int* conv_d, const void* const* conv_w,
                                 const void* const* conv_b, const float* post_w,
                                 const float* post_b, int post_k,
                                 const float* pre_w, const float* pre_b, int c_mel,
                                 int pre_k, void* stream) {
  if (n < 1 || t_in < 1 || !width_ok(c) || u < 1 || kHalo % u != 0 ||
      (k_up - u) % 2 != 0 || k_up < u || (k_up - u) / 2 >= u || post_k < 0 ||
      (post_k > 0 && (post_k % 2 == 0 || c > 64)) || pre_k < 0 ||
      (pre_k > 0 && (pre_k % 2 == 0 || c_mel < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  Plan plan = {};
  const int n_convs = fill_blocks(plan, n_blocks, rounds);
  if (n_convs < 0) return static_cast<int>(cudaErrorInvalidValue);
  Stage s = {};
  s.x = x;
  s.out = out;
  s.c = c;
  s.t_in = t_in;
  s.t_out = t_in * u;
  s.u = u;
  s.k_up = k_up;
  s.pad = (k_up - u) / 2;
  s.up_w = up_w;
  s.up_b = up_b;
  s.pre_w = pre_w;
  s.pre_b = pre_b;
  s.c_mel = c_mel;
  s.pre_k = pre_k;
  s.post_w = post_w;
  s.post_b = post_b;
  s.post_k = post_k;
  return launch(s, plan, n, n_convs, conv_k, conv_d, conv_w, conv_b, stream);
}

// x (n, c, t) -> out (n, c, t): the mean of the ResBlock1 stacks, every conv
// masked to [0, t); the blocks and widths as gen_stage_forward takes them.
extern "C" int resblock_stage_forward(const float* x, float* out, int n, int c, int t,
                                      int n_blocks, const int* rounds,
                                      const int* conv_k, const int* conv_d,
                                      const void* const* conv_w,
                                      const void* const* conv_b, void* stream) {
  if (n < 1 || t < 1 || !width_ok(c)) return static_cast<int>(cudaErrorInvalidValue);
  Plan plan = {};
  const int n_convs = fill_blocks(plan, n_blocks, rounds);
  if (n_convs < 0) return static_cast<int>(cudaErrorInvalidValue);
  Stage s = {};
  s.x = x;
  s.out = out;
  s.c = c;
  s.t_in = t;
  s.t_out = t;
  s.u = 1;
  return launch(s, plan, n, n_convs, conv_k, conv_d, conv_w, conv_b, stream);
}
