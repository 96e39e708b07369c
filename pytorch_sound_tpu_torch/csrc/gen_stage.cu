// Fused HiFi-GAN generator upsample stage (inference), fp32 or the bf16
// fast modes, and its resblock-only mode.
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
// which reproduces per-layer zero padding exactly.
//
// The resblock convs and the transposed conv run on the tensor cores at fp32
// accuracy: 3xTF32 mma.sync m16n8k8 (tf32_mma.cuh), 3 TF32 products per fp32
// one, so their bound is 3 FLOPs at the 495 TFLOP/s TF32 rate where the CUDA
// cores' is one at 67 TFLOP/s. A resblock conv is one GEMM per tap: M =
// positions (16 per m-tile), N = output channels (8 per n-tile), K = input
// channels (8 per k-step).
// - A (activations) is read from the shared-memory buffers at p + (j - half)
//   d, leaky_relu'd at the load where the conv's input takes it, and split
//   into TF32 hi / lo in registers.
// - B (weights) is split before the stage kernel into TF32 hi / lo in the
//   B-fragment order (tf32_split_kernel below, whose plain version is
//   ops/cuda/gen_stage.py: tf32_fragments): a lane loads its hi / lo pair of
//   one fragment with one 16-byte read, and no weight is split in the stage
//   kernel. The entry points run the split on every call, one launch for
//   all the stage's weights into scratch taken with cudaMallocAsync on the
//   caller's stream, so no split is kept that a write to the weights could
//   leave stale.
// - A warp holds MI x NI = 8 tiles (NI n-tiles of 8 channels, MI m-tiles of
//   16 positions; NI = 4 where the width allows): each A fragment feeds 3 NI
//   products, each B fragment 3 MI. At the warp, a B fragment (512 bytes)
//   feeds 4 MI FLOP per byte (8 at MI = 2). The warps of a block read the
//   same fragments in the same order within a chunk, so L1 serves most of
//   them again and L2 sees each block's weight slice about once per conv:
//   R / 4 FLOP per byte for an R-position conv (64-92 at a 256-sample
//   tile). A weight ring in shared memory would cost tile width (the
//   buffers fill the 227 KB), and with it halo recompute.
// - Summation: each output sums its input channels in chunks of 16 (kKC), in
//   a fixed order (the block's own slice first, then the others in rank
//   order), and within a chunk tap by tap. The tensor cores' accumulator
//   rounds toward zero, so runs of products are summed in a fresh
//   accumulator and added to the fp32 total: in the cluster layout each tap
//   of a chunk (two k-steps) in a run accumulator; in the single-block
//   layout each k-step's three products (mma_3xtf32_add), which spares the
//   run accumulator's 32 registers, which its 512-thread kernels lack (they
//   spilled). Measured in one call each way: per-k-step sums made the
//   cluster layout slower, per-tap runs the narrow single-block widths
//   slower. CPU emulation of a ResBlock1 stack at C = 256, k = 11:
//   4.0e-7 (tap runs) and 4.2e-7 (k-step runs) of the max abs off fp64 (the
//   fp32 plain version 3.5e-7); one chain over everything 3.9e-5; one TF32
//   pass 2.8e-4 (tests/test_torch_gen_stage_tc.py).
//   The order does not depend on the tile or the place in an mma tile, so a
//   chunked decode matches a whole one; no atomics, so a rerun is
//   bit-identical.
// - Bank conflicts: buffer rows are L floats apart and L is a multiple of
//   64, so a fragment's 4 channel rows at one position would share a bank.
//   Rather than padding the rows (which costs the tile: C = 64 and the
//   cluster slices would drop to half-width tiles, 26 % more recompute at
//   C = 64), positions are swizzled within 32-float blocks: element (row,
//   col) sits at row * L + (col ^ swz(row)), swz(row) = 8 ((row & 3) ^
//   ((row >> 2) & 1)), which makes A-fragment loads and accumulator-order
//   stores conflict-free and costs no memory.
// - The transposed conv is one such GEMM per polyphase phase (conv_transpose),
//   its A the input span in shared memory (rows q_row = 8 mod 16 floats
//   apart, conflict-free), its B the upsample weight's fragments. On the
//   CUDA cores it took 16-34 % of a v1 stage; on the tensor cores 4-8 %.
//   conv_pre (stage 0 only) stays on the CUDA cores: with the transposed
//   conv it takes 17 % of v1's stage 0, each block of a cluster computing
//   all 2C rows its transposed conv reads.
// What holds the convs back on an H100 (chip_smoke.py phase 9): mma.sync
// m16n8k8 TF32 reaches ~310 TFLOP/s on the card when nothing else runs (63 %
// of the dense TF32 peak; only wgmma reaches the rest), and K3 issues its
// useful products at about a quarter of that. Variants tried on the card
// (probe builds, not kept): without the products a conv keeps a small part
// of its time, without the A loads and splits nearly all of it; weight
// reads that always hit L1, or no peer staging in the cluster layout, each
// save a smaller part; 8 warps of 16 tiles, 16 of 4, fewer n-tiles per
// warp, a weight prefetch into L1, the products issued pass by pass across
// the tiles, the tap loop unrolled, and an even split of (m-tile, half)
// units over the warps (tests/test_torch_gen_stage_tc.py reckons the
// imbalance it removes) were all as fast or slower, the last two by
// spilling. So the mma stream waits on its operands and on the warps that
// hold two m-tiles.
// The conv_pre loop uses an 8-channel x 2-position tile on the CUDA cores,
// the weight loads shared by the warp, each feeding two FMAs.
//
// Contraction modes (the JAX kernels' `precision`; the entry points' `mode`):
// every product of the stage (conv_pre, the transposed conv, the resblock
// convs, conv_post) is taken in the mode; leaky_relu, the biases, the
// residual adds, the block mean and tanh stay fp32.
// - kHighest ('highest'): 3xTF32 as above, fp32 accuracy.
// - kBf16x3 ('bf16x3') and kDefault ('default'): bf16 mma.sync m16n8k16
//   (bf16_mma.cuh), three products of bf16 hi / lo splits or one of
//   bf16-rounded operands, rounded to nearest even as JAX's astype does.
//   A k-step takes one kKC-channel chunk; lane (g, t) holds channels t, t + 4
//   (k = 2t, 2t + 1) and t + 8, t + 12 (k = 2t + 8, 2t + 9), a permutation of
//   the contraction that makes its A loads the two TF32 k-steps' loads (the
//   swizzle and the input span's row stride keep them conflict-free) and
//   that the weight fragments repeat (bf16_split_kernel; plain version
//   ops/cuda/gen_stage.py: bf16_fragments). A half chunk (C = 8 mod 16)
//   runs a whole k-step with the upper 8 channels zero. Activations stay
//   fp32 in shared memory and are split or rounded in registers after
//   leaky_relu; conv_pre and conv_post, on the CUDA cores, take the same
//   products as fp32 FMAs of the split or rounded operands (each bf16
//   product is exact in fp32). Sums as in kHighest: bf16x3 sums each
//   k-step's three products in a fresh accumulator; kDefault chains its one
//   product per k-step in the single-block layout (the accumulator's
//   rounding toward zero, ~2^-23 per k-step, is far below bf16's 2^-9).
//
// Two layouts, by width:
//
// - C <= 64 (single block): one block of 512 threads per (item, tile) holds
//   every channel; the tile is the widest of 1024 ... 64 whose buffers fit
//   the 227 KB a block may use. Warps split the output channels into groups
//   of NI n-tiles (NI = 4, 2 or 1, the largest that divides C / 8) and the
//   positions round robin; a conv takes one or more waves.
// - C = 128 or 256 (cluster): at 256 channels even a 64-sample tile needs
//   662 KB, so a thread-block cluster of C / 32 blocks (384 threads each)
//   owns one (item, tile), each block 32 channels of every buffer and a
//   256-sample tile (224 KB). A conv's block computes its own 32 output
//   channels over every input channel: its own slice in place, each peer's
//   16-channel chunks through a two-chunk staging buffer. The copy of the
//   next peer chunk (distributed shared memory, map_shared_rank, into
//   registers) is issued before this chunk's products and stored after
//   them, so the exchange overlaps the tensor cores; one barrier per chunk.
//   Reading peers' A fragments straight through distributed shared memory
//   instead would fetch each remote element once per tap (11 times at k =
//   11) over the cluster network, whose bandwidth per SM is a fraction of
//   shared memory's; staging fetches it once. cluster.sync() stands where
//   the single-block layout has __syncthreads() between convs. On stage 0
//   every block computes conv_pre for all 2C input rows its transposed conv
//   reads (4 % of the stage's work, done once per block; see above).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>

#include "bf16_mma.cuh"
#include "tf32_mma.cuh"

namespace cg = cooperative_groups;

namespace {

// The kernel's dynamic shared memory. conv_layer indexes it by 32-bit offsets
// so that its loads are shared-memory loads with 32-bit addresses.
extern __shared__ float4 smem4[];

constexpr int kHalo = 64;
// Plan capacity. HiFi-GAN v1 / v2 use 3 blocks of 6 convs; a plan sized to
// exactly that ran ~1.5 % slower per decode on an H100, cause not isolated.
constexpr int kMaxBlocks = 8;
constexpr int kMaxConvs = 32;
constexpr int kThreads = 512;      // single-block layout
constexpr int kWideThreads = 384;  // cluster layout: 12 warps
constexpr int kSlice = 32;         // channels per block in the cluster layout
constexpr int kMaxRanks = 8;       // blocks per cluster (the portable limit)
constexpr int kWideMaxTile = 256;  // the cluster layout's tile (what 224 KB holds)
constexpr int kCoTile = 8;         // conv_pre: output rows per thread
constexpr int kUpStrip = 2;        // conv_pre: positions per thread
constexpr int kKC = 16;            // input channels per chunk of a resblock conv
constexpr int kTiles = 8;          // mma tiles (MI x NI) per warp
constexpr int kHighest = 0;        // contraction modes (see the note above)
constexpr int kBf16x3 = 1;
constexpr int kDefault = 2;
// float4 copies per thread of one peer chunk (kKC rows of the widest tile)
constexpr int kStageVec = kKC * (kWideMaxTile + 2 * kHalo) / 4 / kWideThreads;
static_assert(kStageVec * kWideThreads * 4 == kKC * (kWideMaxTile + 2 * kHalo),
              "a peer chunk splits evenly over the cluster layout's threads");

struct Plan {
  const float4* w[kMaxConvs]; // each (C, C, k) weight as TF32 or bf16
                              // fragments, in execution order (see conv_layer)
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
  int u, k_up, pad;           // k_up == 0: no upsample (the resblock mode)
  int q_stride, q_row;        // input rows a tile's transposed conv reads; the
                              // row stride of their span in shared memory
  const float4* up_w;         // (2C, C, k_up) as TF32 or bf16 fragments of its
                              // (C, 2C, k_up) transpose (see conv_transpose)
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
  int stage;                  // offset (floats) of the two peer chunks (kKC, L)
                              // each; cluster layout only
};

// Buffer rows are L floats apart (L a multiple of 64); position col of row
// sits at col ^ swz(row), a permutation inside each 32-float block that puts
// an A fragment's (rows t, t + 4; 8 positions) and an accumulator tile's
// (rows 2t, 2t + 1) loads and stores on 32 distinct banks.
__device__ __forceinline__ int swz(int row) { return ((row & 3) ^ ((row >> 2) & 1)) << 3; }

__device__ __forceinline__ int at(int row, int col, int L) { return row * L + (col ^ swz(row)); }

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

// One bf16 k-step of conv_layer (kBf16x3, kDefault) over a kKC-channel chunk
// whose rows start at cb: lane (g, t) loads channels t, t + 4, t + 8 and t +
// 12 (the upper two only when `full`, else zero) at positions p0 + stride i
// and 8 later for its cnt m-tiles, splits (kBf16x3) or rounds (kDefault)
// them in pairs after leaky_relu (kLreluIn), and takes the products with the
// weight fragments at frag + 32 n of its NI n-tiles: into part (the cluster
// layout's run of a tap) or into acc (kBf16x3 through a fresh accumulator).
template <int MI, int NI, bool kLreluIn, bool kWide, int kMode>
__device__ __forceinline__ void bf16_step(const float* sm, const float4* __restrict__ wf,
                                          size_t frag, int cb, int L, int p0, int stride,
                                          int cnt, bool full, int t, int swa0, int swa1,
                                          float (&acc)[MI * NI][4], float (&part)[MI * NI][4]) {
  unsigned bh[NI][2], bl[NI][2];
#pragma unroll
  for (int n = 0; n < NI; ++n) {
    if constexpr (kMode == kBf16x3) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(wf) + frag + 32 * n);
      bh[n][0] = v.x;
      bh[n][1] = v.y;
      bl[n][0] = v.z;
      bl[n][1] = v.w;
    } else {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(wf) + frag + 32 * n);
      bh[n][0] = v.x;
      bh[n][1] = v.y;
    }
  }
  const int r0 = cb + t * L;   // channel rows t, t + 4, t + 8, t + 12
  const int r1 = r0 + 4 * L;
  const int r2 = r0 + 8 * L;
  const int r3 = r0 + 12 * L;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    if (i < cnt) {
      const int p = p0 + stride * i;
      const int pa = p ^ swa0, pb = (p + 8) ^ swa0, pc = p ^ swa1, pd = (p + 8) ^ swa1;
      // registers 0-3: (row g, k 2t / 2t + 1), (row g + 8, ...), the same at
      // k 2t + 8 / 2t + 9
      float a[8] = {sm[r0 + pa], sm[r1 + pc], sm[r0 + pb], sm[r1 + pd], 0.f, 0.f, 0.f, 0.f};
      if (full) {
        a[4] = sm[r2 + pa];
        a[5] = sm[r3 + pc];
        a[6] = sm[r2 + pb];
        a[7] = sm[r3 + pd];
      }
      unsigned ah[4], al[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x0 = kLreluIn ? lrelu(a[2 * e], 0.1f) : a[2 * e];
        const float x1 = kLreluIn ? lrelu(a[2 * e + 1], 0.1f) : a[2 * e + 1];
        if constexpr (kMode == kBf16x3)
          split_bf16(x0, x1, ah[e], al[e]);
        else
          ah[e] = pack_bf16(x0, x1);
      }
#pragma unroll
      for (int n = 0; n < NI; ++n) {
        if constexpr (kMode == kBf16x3) {
          if constexpr (kWide)
            mma_bf16x3(part[i * NI + n], ah, al, bh[n], bl[n]);
          else
            mma_bf16x3_add(acc[i * NI + n], ah, al, bh[n], bl[n]);
        } else if constexpr (kWide) {
          mma_bf16(part[i * NI + n], ah, bh[n]);
        } else {
          mma_bf16(acc[i * NI + n], ah, bh[n]);
        }
      }
    }
  }
}

// dst[co][p] = act(mask(p) * (bias[co] + sum_ci sum_j w[co][ci][j]
//                   * in(src[ci][p + (j - half) * d]))) (+ res[co][p])
// for p in [lo, hi) and this block's output channels co, where in =
// leaky_relu(0.1) if kLreluIn else identity and act = leaky_relu(0.1) if
// kLreluOut else identity; on the tensor cores in mode kMode.
//
// kHighest: wf holds the weight as TF32 fragments: float4 ((j S + s) S + n)
// 32 + lane (S = C / 8; lane = 4 g + t) is {hi, hi, lo, lo} of w[8n + g][8s +
// t][j] and w[8n + g][8s + t + 4][j], the B operand of k-step s, n-tile n,
// tap j. kBf16x3 / kDefault: bf16 fragments, ((j S16 + s) N + n) 32 + lane
// (S16 = ceil(C / 16) k-steps, N = C / 8 n-tiles) holds the registers
// {hi(16s + t, 16s + t + 4), hi(16s + t + 8, 16s + t + 12)} of w[8n + g]
// at tap j, then the same of lo in bf16x3 (a uint4; a uint2 in kDefault).
//
// The warps split this block's channels into groups of NI n-tiles and the
// m-tiles of [lo, hi) round robin within a group, MI = kTiles / NI per warp
// and wave. Each output sums the input channels in kKC-channel chunks, the
// block's own slice first, then tap by tap, each run of products (a tap of
// a chunk in the cluster layout, a k-step otherwise) in a fresh accumulator.
// In the cluster layout a peer's chunk is read from the staging buffer: its
// copy was loaded into registers before the previous chunk's products and
// stored after them.
template <int kK, bool kLreluIn, bool kLreluOut, int NI, bool kWide, int kMode>
__device__ void conv_layer(const Tile& tl, int src, int dst, int res,
                           const float4* __restrict__ wf, const float* __restrict__ bias,
                           int d, int lo, int hi) {
  constexpr int MI = kTiles / NI;
  constexpr int half = (kK - 1) / 2;
  float* const sm = reinterpret_cast<float*>(smem4);
  const int L = tl.L;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n_groups = tl.cs / (8 * NI);
  const int wm = (blockDim.x >> 5) / n_groups;   // warps per channel group
  const int ng = warp / wm;                      // >= n_groups: idle warp
  const int wi = warp % wm;
  const int S = tl.c / 8;
  const int S16 = (tl.c + 15) / 16;              // bf16 k-steps
  const int n0 = tl.rank * (tl.cs / 8) + ng * NI;  // this warp's first n-tile
  const int m_tiles = (hi - lo + 15) / 16;
  const int per_wave = wm * MI;
  const int waves = (m_tiles + per_wave - 1) / per_wave;
  const int own = (tl.cs + kKC - 1) / kKC;       // chunks per block slice
  const int n_chunks = own * tl.ranks;           // the last may hold one k-step
  // the input rows a peer chunk's copy covers, widened to whole 32-float
  // swizzle blocks; float4 copies of the swizzled rows keep their layout
  const int in_lo = max(0, (lo - half * d) & ~31);
  const int in_hi = min(L, (hi + half * d + 31) & ~31);
  const int w4 = (in_hi - in_lo) >> 2;
  const int swa0 = t << 3;                       // swz(row) of A rows t and t + 4
  const int swa1 = (t ^ 1) << 3;

  for (int wave = 0; wave < waves; ++wave) {
    const int m_first = wave * per_wave + wi;
    const int cnt =
        ng < n_groups ? max(0, min(MI, (m_tiles - m_first + wm - 1) / wm)) : 0;
    const int pos0 = lo + 16 * m_first + g;      // position of fragment row g, slot 0
    float acc[MI * NI][4], part[MI * NI][4];
#pragma unroll
    for (int i = 0; i < MI * NI; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = part[i][e] = 0.f;

    for (int cc = 0; cc < n_chunks; ++cc) {
      const int c = (cc + tl.rank * own) % n_chunks;   // own slice first
      const int cb = c / own == tl.rank ? src + (c % own) * kKC * L
                                        : tl.stage + (cc & 1) * kKC * L;
      // issue the next chunk's copy when a peer holds it
      const int nc = (c + 1) % n_chunks;
      const bool fetch = kWide && cc + 1 < n_chunks && nc / own != tl.rank;
      float4 pre[kStageVec];
      if (fetch) {
        const float* from = cg::this_cluster().map_shared_rank(sm + src, nc / own) +
                            (nc % own) * kKC * L + in_lo;
#pragma unroll
        for (int r = 0; r < kStageVec; ++r) {
          const int e = threadIdx.x + r * blockDim.x;
          if (e < kKC * w4)
            pre[r] = *reinterpret_cast<const float4*>(from + (e / w4) * L + 4 * (e % w4));
        }
      }
      if (cnt > 0) {
        const int steps = min(kKC, tl.c - c * kKC) / 8;   // 2, or 1 on a last half chunk
#pragma unroll 1
        for (int j = 0; j < kK; ++j) {
          const int off = (j - half) * d;
          if constexpr (kMode != kHighest) {
            bf16_step<MI, NI, kLreluIn, kWide, kMode>(
                sm, wf, (static_cast<size_t>(j * S16 + c) * S + n0) * 32 + lane, cb, L,
                pos0 + off, 16 * wm, cnt, steps == 2, t, swa0, swa1, acc, part);
          } else {
            const float4* wj =
                wf + (static_cast<size_t>(j * S + c * (kKC / 8)) * S + n0) * 32 + lane;
#pragma unroll
            for (int s = 0; s < kKC / 8; ++s) {
              if (s >= steps) break;
              unsigned bh[NI][2], bl[NI][2];
#pragma unroll
              for (int n = 0; n < NI; ++n) {
                const float4 v = __ldg(wj + (s * S + n) * 32);
                bh[n][0] = __float_as_uint(v.x);
                bh[n][1] = __float_as_uint(v.y);
                bl[n][0] = __float_as_uint(v.z);
                bl[n][1] = __float_as_uint(v.w);
              }
              const int r0 = cb + (8 * s + t) * L;   // channel rows t and t + 4
              const int r1 = r0 + 4 * L;
#pragma unroll
              for (int i = 0; i < MI; ++i) {
                if (i < cnt) {
                  const int p = pos0 + 16 * wm * i + off;
                  const float a[4] = {sm[r0 + (p ^ swa0)], sm[r0 + ((p + 8) ^ swa0)],
                                      sm[r1 + (p ^ swa1)], sm[r1 + ((p + 8) ^ swa1)]};
                  unsigned ah[4], al[4];
#pragma unroll
                  for (int e = 0; e < 4; ++e)
                    split_tf32(kLreluIn ? lrelu(a[e], 0.1f) : a[e], ah[e], al[e]);
                  if constexpr (kWide) {
#pragma unroll
                    for (int n = 0; n < NI; ++n)
                      mma_3xtf32(part[i * NI + n], ah, al, bh[n], bl[n]);
                  } else {
#pragma unroll
                    for (int n = 0; n < NI; ++n)
                      mma_3xtf32_add(acc[i * NI + n], ah, al, bh[n], bl[n]);
                  }
                }
              }
            }
          }
          if constexpr (kWide) {
            // one tap of the chunk summed apart, added in fp32
#pragma unroll
            for (int i = 0; i < MI; ++i)
              if (i < cnt)
#pragma unroll
                for (int n = 0; n < NI; ++n)
#pragma unroll
                  for (int e = 0; e < 4; ++e) {
                    acc[i * NI + n][e] += part[i * NI + n][e];
                    part[i * NI + n][e] = 0.f;
                  }
          }
        }
      }
      if (fetch) {
        float* to = sm + tl.stage + ((cc + 1) & 1) * kKC * L + in_lo;
#pragma unroll
        for (int r = 0; r < kStageVec; ++r) {
          const int e = threadIdx.x + r * blockDim.x;
          if (e < kKC * w4)
            *reinterpret_cast<float4*>(to + (e / w4) * L + 4 * (e % w4)) = pre[r];
        }
      }
      if (kWide) __syncthreads();   // the staged chunk is complete; the other is free
    }

    // accumulator tile: rows g, g + 8 (positions), columns 2t, 2t + 1 (channels)
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      if (i >= cnt) continue;
#pragma unroll
      for (int n = 0; n < NI; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int co = (ng * NI + n) * 8 + 2 * t + (e & 1);   // in this block's slice
          const int p = pos0 + 16 * wm * i + 8 * (e >> 1);
          if (p >= hi) continue;
          const int gp = tl.base + p;
          float y = (gp >= 0 && gp < tl.t_out)
                        ? acc[i * NI + n][e] + __ldg(bias + tl.rank * tl.cs + co)
                        : 0.f;
          if (kLreluOut) y = lrelu(y, 0.1f);
          const int o = at(co, p, L);
          if (res >= 0) y += sm[res + o];
          sm[dst + o] = y;
        }
      }
    }
  }
}

// One ResBlock1 conv with its kernel size dispatched to an unrolled instance:
// HiFi-GAN's 3 / 7 / 11, the only sizes the entry points accept.
template <bool kLreluIn, bool kLreluOut, int NI, bool kWide, int kMode>
__device__ void conv_any(const Tile& tl, int k, int src, int dst, int res, const float4* w,
                         const float* b, int d, int lo, int hi) {
  if (k == 3)
    conv_layer<3, kLreluIn, kLreluOut, NI, kWide, kMode>(tl, src, dst, res, w, b, d, lo, hi);
  else if (k == 7)
    conv_layer<7, kLreluIn, kLreluOut, NI, kWide, kMode>(tl, src, dst, res, w, b, d, lo, hi);
  else
    conv_layer<11, kLreluIn, kLreluOut, NI, kWide, kMode>(tl, src, dst, res, w, b, d, lo, hi);
}

// The input rows the tile's transposed conv reads, q in [q_lo, q_lo +
// q_stride), all 2C channels (rows q_row floats apart): leaky_relu(0.1) of x,
// or of conv_pre(mel) computed here (its products in mode kMode), zero
// outside [0, t_in).
template <int kMode>
__device__ void load_input_span(const Stage& s, const Plan& plan, float* smem, int n,
                                int q_lo) {
  float* xs = smem + plan.xs_off;
  const int c_in = 2 * s.c;
  if (s.pre_k == 0) {
    const float* xn = s.x + static_cast<size_t>(n) * c_in * s.t_in;
    for (int e = threadIdx.x; e < c_in * s.q_stride; e += blockDim.x) {
      const int ci = e / s.q_stride;
      const int r = e % s.q_stride;
      const int q = q_lo + r;
      xs[ci * s.q_row + r] = (q >= 0 && q < s.t_in)
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
        float v[kUpStrip], vl[kUpStrip];
#pragma unroll
        for (int t = 0; t < kUpStrip; ++t) {
          const int r = r0 + 32 * t;
          v[t] = r < s.q_stride ? mr[r + j] : 0.f;
          if constexpr (kMode != kHighest) {   // v = bf16 hi, vl = lo
            const float h = round_bf16(v[t]);
            vl[t] = round_bf16(v[t] - h);
            v[t] = h;
          }
        }
#pragma unroll
        for (int c = 0; c < kCoTile; ++c) {
          const float wv = __ldg(wr + c * w_ci + j);
          if constexpr (kMode == kHighest) {
#pragma unroll
            for (int t = 0; t < kUpStrip; ++t) acc[c][t] = fmaf(wv, v[t], acc[c][t]);
          } else {
            const float wh = round_bf16(wv);
            const float wl = round_bf16(wv - wh);
#pragma unroll
            for (int t = 0; t < kUpStrip; ++t) {
              if constexpr (kMode == kBf16x3) {
                acc[c][t] = fmaf(wl, v[t], acc[c][t]);
                acc[c][t] = fmaf(wh, vl[t], acc[c][t]);
              }
              acc[c][t] = fmaf(wh, v[t], acc[c][t]);
            }
          }
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
          xs[(ci0 + c) * s.q_row + r] =
              (q >= 0 && q < s.t_in) ? lrelu(acc[c][t] + bv, 0.1f) : 0.f;
      }
    }
  }
}

// 2. The transposed conv into h on the tensor cores (3xTF32), polyphase:
// output l (global g = base + l) of phase r = (g + pad) % u takes taps j = r
// + m u from input row (g + pad) / u - m; masked to [0, t_out). base is a
// multiple of u, so the phase and the row follow from l. Per phase it is a
// GEMM: M = the phase's outputs (16 per m-tile, consecutive input rows), N =
// this block's output channels, K = 2C input channels x the phase's taps.
// A is the input span xs (2C rows q_row floats apart, q_row = 8 mod 16: the
// fragment loads hit 32 banks); B the weight as TF32 fragments of its (C, 2C,
// k_up) transpose, laid out as conv_layer's. Warps split the channels as in
// conv_layer and take the (phase, m-tile) units round robin, one at a time;
// each output sums its taps in order and each tap's input channels by
// k-step, each k-step's products in a fresh accumulator. In the bf16 modes a
// k-step covers 16 input channels, lane (g, t) taking rows t, t + 4, t + 8
// and t + 12 as conv_layer does, and kDefault chains its products.
template <int NI, int kMode>
__device__ void conv_transpose(const Stage& s, const Plan& plan, int L, int base, int rank) {
  float* const sm = reinterpret_cast<float*>(smem4);
  const int u = s.u;
  const int m_taps = (s.k_up + u - 1) / u;
  const int row0 = (plan.h_lo + s.pad) / u - (m_taps - 1);   // input row of xs column 0
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n_groups = plan.cs / (8 * NI);
  const int wm = (blockDim.x >> 5) / n_groups;
  const int ng = warp / wm;
  if (ng >= n_groups) return;
  const int N = s.c / 8;                   // n-tiles of the output
  const int S = s.c / 4;                   // k-steps over the 2C input channels
  const int n0 = rank * (plan.cs / 8) + ng * NI;
  const int per_phase = ((plan.h_hi - plan.h_lo + u - 1) / u + 15) / 16;
  const int qr = s.q_row;
  for (int unit = warp % wm; unit < u * per_phase; unit += wm) {
    const int r = unit / per_phase;
    const int a0 = unit % per_phase * 16;                      // first output of the tile
    const int l_r = plan.h_lo + ((r - s.pad - plan.h_lo) % u + u) % u;   // first l of phase r
    const int n_r = (plan.h_hi - l_r + u - 1) / u;            // outputs of phase r
    // xs columns of A rows g and g + 8 at tap 0 (rows past the phase read
    // its last output's and are not stored)
    const int q = plan.xs_off + (l_r + s.pad) / u - row0 + t * qr;
    const int c0 = q + min(a0 + g, n_r - 1);
    const int c1 = q + min(a0 + g + 8, n_r - 1);
    float acc[NI][4] = {};
    for (int m = 0; m < m_taps; ++m) {
      const int j = r + m * u;
      if (j >= s.k_up) break;
      if constexpr (kMode != kHighest) {
        const size_t fj = (static_cast<size_t>(j) * (S / 2) * N + n0) * 32 + lane;
#pragma unroll 2
        for (int ks = 0; ks < S / 2; ++ks) {
          unsigned bh[NI][2], bl[NI][2];
#pragma unroll
          for (int n = 0; n < NI; ++n) {
            if constexpr (kMode == kBf16x3) {
              const uint4 v = __ldg(reinterpret_cast<const uint4*>(s.up_w) + fj + (ks * N + n) * 32);
              bh[n][0] = v.x;
              bh[n][1] = v.y;
              bl[n][0] = v.z;
              bl[n][1] = v.w;
            } else {
              const uint2 v = __ldg(reinterpret_cast<const uint2*>(s.up_w) + fj + (ks * N + n) * 32);
              bh[n][0] = v.x;
              bh[n][1] = v.y;
            }
          }
          const int k0 = 16 * ks * qr - m;
          const float a[8] = {sm[c0 + k0],          sm[c0 + k0 + 4 * qr],  sm[c1 + k0],
                              sm[c1 + k0 + 4 * qr], sm[c0 + k0 + 8 * qr],  sm[c0 + k0 + 12 * qr],
                              sm[c1 + k0 + 8 * qr], sm[c1 + k0 + 12 * qr]};
          unsigned ah[4], al[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if constexpr (kMode == kBf16x3)
              split_bf16(a[2 * e], a[2 * e + 1], ah[e], al[e]);
            else
              ah[e] = pack_bf16(a[2 * e], a[2 * e + 1]);
          }
#pragma unroll
          for (int n = 0; n < NI; ++n) {
            if constexpr (kMode == kBf16x3)
              mma_bf16x3_add(acc[n], ah, al, bh[n], bl[n]);
            else
              mma_bf16(acc[n], ah, bh[n]);
          }
        }
        continue;
      }
      const float4* wj = s.up_w + (static_cast<size_t>(j) * S * N + n0) * 32 + lane;
#pragma unroll 2
      for (int ks = 0; ks < S; ++ks) {
        unsigned bh[NI][2], bl[NI][2];
#pragma unroll
        for (int n = 0; n < NI; ++n) {
          const float4 v = __ldg(wj + (ks * N + n) * 32);
          bh[n][0] = __float_as_uint(v.x);
          bh[n][1] = __float_as_uint(v.y);
          bl[n][0] = __float_as_uint(v.z);
          bl[n][1] = __float_as_uint(v.w);
        }
        const int k0 = 8 * ks * qr - m;
        const float a[4] = {sm[c0 + k0], sm[c1 + k0], sm[c0 + k0 + 4 * qr],
                            sm[c1 + k0 + 4 * qr]};
        unsigned ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(a[e], ah[e], al[e]);
#pragma unroll
        for (int n = 0; n < NI; ++n) mma_3xtf32_add(acc[n], ah, al, bh[n], bl[n]);
      }
    }
    // accumulator tile: rows g, g + 8 (outputs), columns 2t, 2t + 1 (channels)
#pragma unroll
    for (int n = 0; n < NI; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int co = (ng * NI + n) * 8 + 2 * t + (e & 1);   // in this block's slice
        const int a = a0 + g + 8 * (e >> 1);
        if (a >= n_r) continue;
        const int l = l_r + a * u;
        const int gp = base + l;
        sm[at(co, l, L)] = (gp >= 0 && gp < s.t_out)
                               ? acc[n][e] + __ldg(s.up_b + rank * plan.cs + co)
                               : 0.f;
      }
    }
  }
}

template <int kNT, int NI, int kMode>
__global__ void __launch_bounds__(kNT) gen_stage_kernel(const Stage s, const Plan plan) {
  constexpr bool kWide = kNT == kWideThreads;   // the cluster layout
  float* smem = reinterpret_cast<float*>(smem4);
  const int ranks = plan.ranks;
  const int cs = plan.cs;
  const int L = s.tile_t + 2 * kHalo;
  const int A = plan.a_hi - plan.a_lo;
  // buffers as offsets (floats) into shared memory, which conv_layer takes
  const int h_at = 0;               // stage input h            (cs, L)
  const int x_at = cs * L;          // block running residual   (cs, L)
  const int t_at = 2 * cs * L;      // conv1 output             (cs, L)
  const int st_at = 3 * cs * L;     // peer staging (cluster)   (2 kKC, L)
  float* hbuf = smem + h_at;
  float* xb = smem + x_at;
  float* acc = smem + st_at + (ranks > 1 ? 2 * kKC * L : 0);   // sum over blocks (cs, A)

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
      hbuf[at(co, l, L)] =
          (g >= 0 && g < s.t_out) ? __ldg(xn + static_cast<size_t>(co) * s.t_out + g) : 0.f;
    }
  } else {
    // 1. the input rows the tile's transposed conv reads
    const int m_taps = (s.k_up + s.u - 1) / s.u;
    const int q_lo = floor_div(base + plan.h_lo + s.pad, s.u) - (m_taps - 1);
    load_input_span<kMode>(s, plan, smem, n, q_lo);
    __syncthreads();

    // 2. transposed conv
    conv_transpose<NI, kMode>(s, plan, L, base, rank);
  }
  stage_sync(ranks);

  // 3. ResBlock1 stacks: xb = h; per round xb += conv2(lrelu(conv1(lrelu(xb)))).
  //    conv1 stores lrelu of its (masked) output, which only conv2 reads.
  const Tile tl = {s.c, cs, ranks, rank, L, base, s.t_out, st_at};
  int ci = 0;
  for (int b = 0; b < plan.n_blocks; ++b) {
    for (int r = 0; r < plan.rounds[b]; ++r) {
      const int src = r == 0 ? h_at : x_at;
      conv_any<true, true, NI, kWide, kMode>(tl, plan.k[ci], src, t_at, -1, plan.w[ci], plan.b[ci],
                                      plan.d[ci], plan.lo[ci], plan.hi[ci]);
      ++ci;
      stage_sync(ranks);
      conv_any<false, false, NI, kWide, kMode>(tl, plan.k[ci], t_at, x_at, src, plan.w[ci],
                                        plan.b[ci], plan.d[ci], plan.lo[ci], plan.hi[ci]);
      ++ci;
      stage_sync(ranks);
    }
    for (int e = threadIdx.x; e < cs * A; e += blockDim.x) {
      const int co = e / A;
      const int l = plan.a_lo + e % A;
      acc[e] = (b == 0 ? 0.f : acc[e]) + xb[at(co, l, L)];
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
      for (int j = 0; j < s.post_k; ++j) {
        if constexpr (kMode == kHighest) {
          a = fmaf(row[j], __ldg(s.post_w + c * s.post_k + j), a);
        } else {   // the split or rounded products, as conv_pre's
          const float w = __ldg(s.post_w + c * s.post_k + j);
          const float wh = round_bf16(w), h = round_bf16(row[j]);
          if constexpr (kMode == kBf16x3) {
            a = fmaf(round_bf16(w - wh), h, a);
            a = fmaf(wh, round_bf16(row[j] - h), a);
          }
          a = fmaf(wh, h, a);
        }
      }
    }
    on[g] = tanhf(a + __ldg(s.post_b));
  }
}

// Plans a tile of tile_t output samples: each conv's output range, walked
// back from the block sum (a conv's output range is what the next layer or
// the block sum reads; its input range is that widened by its reach). Sets
// s.q_stride (the input rows the tile's transposed conv reads), s.q_row and
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
  // h, the residual and the intermediate, (cs, L) each, the two peer chunks
  // (kKC, L) in the cluster layout, and the block sum (cs, A)
  const size_t bufs = (3 * static_cast<size_t>(L) + A) * cs +
                      (plan.ranks > 1 ? 2 * kKC * static_cast<size_t>(L) : 0);
  if (s.k_up == 0) {
    s.q_stride = s.q_row = 0;
    plan.xs_off = 0;
    return bufs * sizeof(float);
  }
  const int m_taps = (s.k_up + s.u - 1) / s.u;
  // base = t0 - kHalo is a multiple of u, so the row span is the same for
  // every tile; its rows are stored q_row = 8 mod 16 floats apart
  s.q_stride = (plan.h_hi - 1 + s.pad) / s.u - (plan.h_lo + s.pad) / s.u + m_taps;
  s.q_row = s.q_stride + (24 - s.q_stride % 16) % 16;
  // the input span (2C, q_row) reuses the intermediate onwards; conv_pre's
  // mel rows sit before it, in h and the residual
  const size_t mel = s.pre_k > 0 ? static_cast<size_t>(s.c_mel) * (s.q_stride + s.pre_k - 1) : 0;
  const size_t xs_off = std::max(2 * cs * L, mel);
  plan.xs_off = static_cast<int>(xs_off);
  return std::max(bufs, xs_off + 2 * static_cast<size_t>(s.c) * s.q_row) * sizeof(float);
}

// tf32_split_kernel: a stage's weights (its transposed conv and up to
// kMaxConvs resblock convs) in one launch, in one struct passed by value
// (about 1.3 KB of kernel parameters).
constexpr int kMaxSplits = 40;
static_assert(kMaxSplits >= kMaxConvs + 1, "one split job per weight of a stage");

struct SplitJobs {
  const float* w[kMaxSplits];
  long long start[kMaxSplits + 1];   // element offsets: weight j is [start[j], start[j + 1])
  int c_out[kMaxSplits], c_in[kMaxSplits], k[kMaxSplits], transposed[kMaxSplits];
  int n;
};

// Weight j, read as (c_out, c_in, k) (a ConvTranspose1d weight (c_in, c_out,
// k) through its transpose), written to out[2 start[j], 2 start[j + 1]) as
// (k, c_in / 8, c_out / 8, 8, 4, 2, 2) = (tap, k-step s, n-tile, g, t,
// hi / lo, h): entry w[8 n + g][8 s + 4 h + t][tap], hi rounded to TF32 the
// way split_tf32 (tf32_mma.cuh) rounds, lo = w - hi. One thread per weight
// entry writes its hi and lo.
__global__ void tf32_split_kernel(const __grid_constant__ SplitJobs jobs,
                                  float* __restrict__ out) {
  const long long total = jobs.start[jobs.n];
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       e < total; e += step) {
    int j = 0;
    while (e >= jobs.start[j + 1]) ++j;
    const long long l = e - jobs.start[j];
    const int co = jobs.c_out[j], ci = jobs.c_in[j], k = jobs.k[j];
    const int h = static_cast<int>(l & 1), t = static_cast<int>((l >> 1) & 3);
    const int g = static_cast<int>((l >> 3) & 7);
    long long r = l >> 6;
    const int nt = static_cast<int>(r % (co / 8));
    r /= co / 8;
    const int ks = static_cast<int>(r % (ci / 8));
    const int tap = static_cast<int>(r / (ci / 8));
    const long long o = 8 * nt + g, i = 8 * ks + 4 * h + t;
    const long long src = jobs.transposed[j] ? (i * co + o) * k + tap : (o * ci + i) * k + tap;
    const float v = __ldg(jobs.w[j] + src);
    const float hi = __uint_as_float((__float_as_uint(v) + 0x1000u) & 0xffffe000u);
    float* dst = out + 2 * jobs.start[j] + ((l >> 1) << 2) + h;
    dst[0] = hi;
    dst[2] = v - hi;
  }
}

// bf16_split_kernel: the bf16 modes' twin of tf32_split_kernel, whose jobs
// count the entries of each weight with c_in padded to a multiple of 16
// (stage_jobs with bf16 set). Weight j, read as (c_out, c_in, k), is written
// to out[parts start[j], parts start[j + 1]) (bf16 elements) as (k, c_in16 /
// 16, c_out / 8, 8, 4, parts, 2, 2) = (tap, k-step s, n-tile, g, t, hi / lo,
// register r, half h): entry w[8 n + g][16 s + 8 r + 4 h + t][tap], zero past
// c_in; hi = bf16(w) and lo = bf16(w - hi), rounded to nearest even (parts
// 2, kBf16x3), or hi alone (parts 1, kDefault). One thread per entry.
__global__ void bf16_split_kernel(const __grid_constant__ SplitJobs jobs,
                                  __nv_bfloat16* __restrict__ out, int parts) {
  const long long total = jobs.start[jobs.n];
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       e < total; e += step) {
    int j = 0;
    while (e >= jobs.start[j + 1]) ++j;
    const long long l = e - jobs.start[j];
    const int co = jobs.c_out[j], ci = jobs.c_in[j], k = jobs.k[j];
    const int s16 = (ci + 15) / 16;
    const int h = static_cast<int>(l & 1), r = static_cast<int>((l >> 1) & 1);
    const int t = static_cast<int>((l >> 2) & 3), g = static_cast<int>((l >> 4) & 7);
    long long q = l >> 7;
    const int nt = static_cast<int>(q % (co / 8));
    q /= co / 8;
    const int ks = static_cast<int>(q % s16);
    const int tap = static_cast<int>(q / s16);
    const long long o = 8 * nt + g, i = 16 * ks + 8 * r + 4 * h + t;
    const long long src = jobs.transposed[j] ? (i * co + o) * k + tap : (o * ci + i) * k + tap;
    const float v = i < ci ? __ldg(jobs.w[j] + src) : 0.f;
    const __nv_bfloat16 hi = __float2bfloat16_rn(v);
    __nv_bfloat16* dst = out + parts * (jobs.start[j] + ((l >> 2) << 2)) + (l & 3);
    dst[0] = hi;
    if (parts == 2) dst[4] = __float2bfloat16_rn(v - __bfloat162float(hi));
  }
}

// The split jobs of a stage: its transposed conv first (when s.k_up > 0),
// then its resblock convs in plan order; with bf16, each weight's c_in
// counted padded to a multiple of 16 (bf16_split_kernel).
SplitJobs stage_jobs(const Stage& s, int n_convs, const int* conv_k, const float* up_w,
                     const void* const* conv_w, bool bf16) {
  SplitJobs jobs = {};
  auto add = [&jobs, bf16](const float* w, int c_out, int c_in, int k, int transposed) {
    const int j = jobs.n++;
    jobs.w[j] = w;
    jobs.c_out[j] = c_out;
    jobs.c_in[j] = c_in;
    jobs.k[j] = k;
    jobs.transposed[j] = transposed;
    const long long rows = bf16 ? (c_in + 15) / 16 * 16 : c_in;
    jobs.start[j + 1] = jobs.start[j] + static_cast<long long>(c_out) * rows * k;
  };
  if (s.k_up > 0) add(up_w, s.c, 2 * s.c, s.k_up, 1);
  for (int i = 0; i < n_convs; ++i) add(static_cast<const float*>(conv_w[i]), s.c, s.c, conv_k[i], 0);
  return jobs;
}

int launch_stage(Stage s, Plan plan, int n, int mode, void* stream);

// Checks the convs, splits the stage's weights (up_w, conv_w: the raw fp32
// weights) into TF32 or (bf16 modes) bf16 fragments in scratch on `stream`,
// fills the plan, and launches the stage kernel in `mode` there; the scratch
// is freed on the stream after it.
int launch(Stage s, Plan plan, int n, int mode, int n_convs, const int* conv_k,
           const int* conv_d, const float* up_w, const void* const* conv_w,
           const void* const* conv_b, void* stream) {
  if (mode != kHighest && mode != kBf16x3 && mode != kDefault)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < n_convs; ++i) {
    if ((conv_k[i] != 3 && conv_k[i] != 7 && conv_k[i] != 11) || conv_d[i] < 1)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const bool bf16 = mode != kHighest;
  const int parts = mode == kBf16x3 ? 2 : 1;    // bf16 elements per padded entry
  const SplitJobs jobs = stage_jobs(s, n_convs, conv_k, up_w, conv_w, bf16);
  float* frags = nullptr;
  cudaError_t err = cudaMallocAsync(
      reinterpret_cast<void**>(&frags),
      bf16 ? parts * jobs.start[jobs.n] * sizeof(__nv_bfloat16)
           : 2 * jobs.start[jobs.n] * sizeof(float), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (jobs.start[jobs.n] + 255) / 256;
  const int grid = static_cast<int>(blocks < 1056 ? blocks : 1056);
  if (bf16)
    bf16_split_kernel<<<grid, 256, 0, st>>>(jobs, reinterpret_cast<__nv_bfloat16*>(frags),
                                            parts);
  else
    tf32_split_kernel<<<grid, 256, 0, st>>>(jobs, frags);
  int code = static_cast<int>(cudaGetLastError());
  if (code == 0) {
    const int first = s.k_up > 0 ? 1 : 0;
    if (s.k_up > 0) s.up_w = reinterpret_cast<const float4*>(frags);
    for (int i = 0; i < n_convs; ++i) {
      // each weight's start is a multiple of 128 entries: 16-byte aligned
      const long long at = jobs.start[first + i];
      plan.w[i] = bf16 ? reinterpret_cast<const float4*>(
                             reinterpret_cast<const __nv_bfloat16*>(frags) + parts * at)
                       : reinterpret_cast<const float4*>(frags + 2 * at);
      plan.b[i] = static_cast<const float*>(conv_b[i]);
      plan.k[i] = conv_k[i];
      plan.d[i] = conv_d[i];
    }
    code = launch_stage(s, plan, n, mode, stream);
  }
  err = cudaFreeAsync(frags, st);
  return code != 0 ? code : static_cast<int>(err);
}

using StageKernel = void (*)(const Stage, const Plan);

// The stage kernel of a width in mode kMode: n-tiles per warp 4 in the
// cluster layout (its 32-channel slice), else the largest of 4, 2, 1 that
// divides the width's n-tiles.
template <int kMode>
StageKernel stage_kernel(bool wide, int n_tiles) {
  void (*kernel)(const Stage, const Plan) =
      wide                ? gen_stage_kernel<kWideThreads, 4, kMode>
      : n_tiles % 4 == 0  ? gen_stage_kernel<kThreads, 4, kMode>
      : n_tiles % 2 == 0  ? gen_stage_kernel<kThreads, 2, kMode>
                          : gen_stage_kernel<kThreads, 1, kMode>;
  return kernel;
}

// Picks the widest tile of 1024 ... 64 output samples whose buffers fit the
// card (and, in the cluster layout, of which at least one cluster can be
// resident), and launches the stage kernel in `mode` on `stream`.
int launch_stage(Stage s, Plan plan, int n, int mode, void* stream) {
  if (s.c <= 64) {
    plan.ranks = 1;
  } else if (s.c % kSlice == 0 && s.c / kSlice <= kMaxRanks) {
    plan.ranks = s.c / kSlice;
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  plan.cs = s.c / plan.ranks;
  const bool wide = plan.ranks > 1;
  const int n_tiles = s.c / 8;
  const StageKernel kernel = mode == kBf16x3   ? stage_kernel<kBf16x3>(wide, n_tiles)
                             : mode == kDefault ? stage_kernel<kDefault>(wide, n_tiles)
                                                : stage_kernel<kHighest>(wide, n_tiles);
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
  for (int t = wide ? kWideMaxTile : 1024; t >= kHalo; t /= 2) {
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
  return (c >= 8 && c <= 64 && c % 8 == 0) ||
         (c > 64 && c % kSlice == 0 && c / kSlice <= kMaxRanks);
}

}  // namespace

// x (n, 2c, t_in) -> out (n, c, u * t_in), or (n, 1, u * t_in) when post_k > 0
// (c <= 64: conv_post reads every channel, which one block holds only there).
// up_w is the transposed conv's weight (2c, c, k_up), up_b (c,). With
// pre_k > 0, x is the mel (n, c_mel, t_in) and conv_pre (pre_w (2c, c_mel,
// pre_k), pre_b (2c,)) runs first. Block b runs rounds[b] conv pairs; conv i
// has kernel conv_k[i] (3, 7 or 11), dilation conv_d[i], weight conv_w[i]
// (c, c, k) and bias conv_b[i] (c,). mode: the products' contraction, 0
// 'highest' (3xTF32), 1 'bf16x3', 2 'default'. The weights are fp32 as the
// module holds them: two launches, the TF32 or bf16 split of up_w and conv_w
// into scratch (cudaMallocAsync / cudaFreeAsync on `stream`), then the stage
// in that mode. Widths:
// c <= 64 a multiple of 8 (one block per tile), or a multiple of 32 up to
// 256 (a cluster of c / 32 blocks per tile). The host arrays are read before
// return. Returns a cudaError_t; 0 when launched.
extern "C" int gen_stage_forward(const float* x, float* out, int n, int c,
                                 int t_in, int u, int k_up, const float* up_w,
                                 const float* up_b, int n_blocks,
                                 const int* rounds, const int* conv_k,
                                 const int* conv_d, const void* const* conv_w,
                                 const void* const* conv_b, const float* post_w,
                                 const float* post_b, int post_k,
                                 const float* pre_w, const float* pre_b, int c_mel,
                                 int pre_k, int mode, void* stream) {
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
  s.up_b = up_b;
  s.pre_w = pre_w;
  s.pre_b = pre_b;
  s.c_mel = c_mel;
  s.pre_k = pre_k;
  s.post_w = post_w;
  s.post_b = post_b;
  s.post_k = post_k;
  return launch(s, plan, n, mode, n_convs, conv_k, conv_d, up_w, conv_w, conv_b, stream);
}

// x (n, c, t) -> out (n, c, t): the mean of the ResBlock1 stacks, every conv
// masked to [0, t); the blocks, widths and modes as gen_stage_forward takes
// them (the JAX resblock kernel has no 'bf16x3'; the wrapper refuses it).
extern "C" int resblock_stage_forward(const float* x, float* out, int n, int c, int t,
                                      int n_blocks, const int* rounds,
                                      const int* conv_k, const int* conv_d,
                                      const void* const* conv_w,
                                      const void* const* conv_b, int mode, void* stream) {
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
  return launch(s, plan, n, mode, n_convs, conv_k, conv_d, nullptr, conv_w, conv_b, stream);
}

