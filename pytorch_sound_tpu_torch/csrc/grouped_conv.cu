// Grouped / strided / dilated conv1d on NCT fp32: the forward with fused bias
// and leaky_relu, the input gradient, and a deterministic weight gradient.
//
// Replaces the TPU kernels of pytorch_sound_tpu/ops/pallas/grouped_conv.py:
// _shifted_matmul (K6a), which runs the forward (_fwd_impl), the input
// gradient (_dx_impl) and ConvTranspose1d (_convt_fwd_impl, the input
// gradient of the mirror conv), and _dw_impl (K6b, the weight gradient).
//
//   forward  y[n, co, t]  = lrelu(b[co] + sum_{ci in group(co), m}
//                                   w[co, ci, m] x[n, ci, t s + d m - p])
//   dx       dx[n, ci, u] = sum_{co in group(ci), m, t : u = t s + d m - p}
//                                   w[co, ci, m] gy[n, co, t]
//   dw       dw[co, ci, m] = sum_{n, t} gy[n, co, t] x[n, ci, t s + d m - p]
//
// What bounds it on an H100: arithmetic. The HiFi-GAN critics' body convs do
// 40-800 FLOP per byte they must move (MSD L5: 128 x 41 taps per output),
// above the card's ~20 FLOP/B fp32 ridge; only the first layers (one input
// channel) and conv_post (one output channel) are bound by bytes.
//
// Each of the three is one implicit GEMM per group, and three kernels run
// them, chosen by the GEMM's rows per group (forward and dw: output channels;
// dx: input channels):
//
// conv_tap_kernel: the forward and dx from 16 rows and one 32-deep stage of
// reduction on (every critic conv but its first layer and conv_post, whose
// one input or output channel leaves a reduction of 3-15 or one row; v2's
// upsamples but the last one's ConvTranspose1d, 8 rows). It replaces
// _shifted_matmul's "J shifted matmuls over a phase-folded input" and keeps
// its reuse: the k taps of a conv read the same input row at shifts. Bound:
// 3 TF32 FLOPs per FLOP (3xTF32 mma.sync m16n8k8, tf32_mma.cuh: each operand
// split into a TF32 hi and lo, three products per pair, fp32-accurate) at
// the 495 TFLOP/s TF32 rate. Rows x columns (item, time) flattened x
// reduction (channel, tap) in 32-deep stages through a three-stage cp.async
// ring, one barrier a stage; 4 warps over the tile conv_dw_kernel takes for
// the same rows.
//   - A (the weight) arrives in 16-byte copies of rows contiguous along the
//     reduction: w itself in the forward; dx's A, w[co, ci, m0 + ms i]
//     gathered per phase ([group][phase][ci][(co, i)], as the JAX package's
//     _pack_dx_taps packs it outside its kernel), and a forward whose rows
//     are not whole 16-byte pieces, are first packed by pack_tap_a_kernel
//     into scratch the entry point takes stream-ordered (cudaMallocAsync on
//     the caller's stream; the C signatures take none). Each warp splits
//     the A fragments it reads.
//   - B is not gathered per (tap, column). Per stage and per channel the
//     stage touches, the source window of the block's columns over all taps
//     (forward: x[n, ci, t0 s - p .. (t0 + BN - 1) s + d (k - 1) - p]; dx:
//     the phase's gy window, stride 1) lands once by 4-byte cp.async (zero
//     padding by zero-fill) and the B fragments of every tap read it at
//     their shift, split where they are read. At stride s the window is
//     stored by phase (u mod s), each phase row pitched so that a
//     fragment's four taps hit different banks (tap_pitch). A column tile
//     that spans items (the period critics' folded items of 10-51 outputs,
//     the scale critics' last layers of 33-128) holds one window segment per
//     item, each with its own tail of span / s entries: short items need no
//     per-element gather.
//   - dx is one GEMM per (group, stride phase): outputs u = rho + s j read
//     the taps m that reach an integer cotangent time, a residue class m0 +
//     ms i (ms = s / gcd(s, d); 10 or 11 of K = 41 at stride 4), at time
//     j + base - i d / gcd(s, d): no tap outside the phase is visited.
//   - Each stage's products go to a fresh accumulator added in fp32
//     (add_part): the tensor cores' accumulator rounds toward zero, and one
//     chain over a reduction of 5,120 terms would carry that bias into the
//     result. Every output has one writer, no atomics: a rerun is
//     bit-identical. Bias and leaky_relu run in the epilogue.
//   - What held it back (ops/cuda/k6a_probe.py's variants of this source on
//     the H100, sums over the 58 layers chip_smoke.py's phase 8.1 runs): the
//     staging and the instructions around the products more than the
//     tensor cores. Without the compute loop the staging alone keeps about
//     half the time (49 % forward, 55 % dx), without the staging the
//     compute loop keeps 68 / 74 %: the two overlap only in part. One TF32
//     product instead of three saves 24 / 21 %. Two ring stages tie three
//     on the forward and lose 2 % on dx; 64-deep stages (+11 / +8 %), 8-warp
//     128 x 128 tiles (+8 / +7 %) and a fresh accumulator per k-step instead
//     of per stage (+7 %) lose. Two earlier drafts cost more than they
//     saved: a pass splitting the landed window into hi / lo before each
//     stage's barrier, and A pre-split into hi / lo fragments by the pack
//     (twice A's bytes through L2 for every 64-column tile).
//
// conv_dw_kernel: dw from 16 output channels per group (every critic layer
// but conv_post, every upsample's mirror conv), 3xTF32 as above. Rows are
// output channels, columns (input channel, tap) pairs, and the reduction
// runs over (item, time) positions in 32-deep stages. The A tile (gy rows,
// contiguous in time) and the B tile (x gathered with the conv's index map,
// zero padding from cp.async's zero-fill, no im2col copy) stream through a
// two-stage cp.async ring with one barrier per stage. gy arrives in 16-byte
// copies: where t_out % 4 != 0 or gy is not 16-byte aligned (the period
// critics, the scale critics below full rate), the entry point first pads
// its rows to a multiple of 4 in scratch, which measured a quarter faster on
// those layers than 4-byte copies of gy and costs one pass over gy. Each
// stage's products go to a fresh accumulator added in fp32 (add_part). A
// block is 4 warps over a 128 x 64, 64 x 64, 32 x 128 or 16 x 256 tile (by
// the rows per group), each warp 4 x 4, 2 x 4, 2 x 4 or 1 x 8 mma tiles;
// rows of the shared tiles are padded (32 + 4 and BN + 8 floats) so that
// every fragment load hits 32 banks. On the H100 the instructions that stage
// and split its operands hold it back, not the tensor cores: a variant
// without the products kept about two thirds of the time. Every element of x
// arrives by its own 4-byte cp.async with its index arithmetic, and every
// operand is split for each warp that reads it; 128-row tiles (fewer copies
// per product) measured faster than 64-row ones from 128 rows on, and 8-warp
// 128 x 128 tiles or a deeper ring slower over the critics' layers.
//
// conv_gemm_kernel: below 16 rows, where an m16 tile would waste most of its
// rows (conv_post has one; a first layer's dx one; v2's last upsample's
// ConvTranspose1d eight), on the CUDA cores in fp32. A block owns a BM x BN
// tile of the GEMM's output: columns are (item, time) flattened (forward,
// dx), so short sequences still fill a tile, or (channel, tap) pairs (dw).
// The reduction runs in chunks of 16 through shared memory: the weight (or
// cotangent) tile, and the input tile gathered straight from the unpadded NCT
// tensor with the conv's index map (zero padding by masking, no im2col copy).
// The next chunk is loaded into registers while this one's FMAs run, then
// stored to the second of two shared buffers (one barrier per chunk). Each
// thread keeps a TM x TN register tile, so one shared load feeds TN (or TM)
// FMAs. Its one-row tile splits the reduction over 8 slices. dx walks
// (group, stride phase) as the tap kernel does. Bias and leaky_relu run in
// the epilogue.
//
// dw is deterministic on both of its kernels: the (item, time) reduction is
// cut into `splits` fixed chunks; each block writes its partial tile to
// scratch, and a second pass of the same entry point sums the chunks in a
// fixed order. No float atomics, so a rerun is bit-identical.
//
// Two precisions, the TPU kernel's two (`precision` of the entry points):
//   - highest (0): the above, fp32-accurate products.
//   - default (1): each operand rounded to bf16 (round to nearest even, as
//     astype(bfloat16)), the products summed in fp32 (the forward: x and w;
//     dx: gy and w; dw: x and gy). On the tensor cores one bf16 mma.sync
//     m16n8k16 per 16-deep k-step (bf16_mma.cuh); lane (g, t) takes the
//     reduction indices t, t + 4, t + 8, t + 12 of the step (the m16n8k16
//     pairs (2t, 2t + 1), (2t + 8, 2t + 9) mapped to them), so the fp32
//     tiles and their swizzles are read as the 3xTF32 path reads them, two
//     8-deep steps at a time. On the CUDA cores fp32 FMAs of the rounded
//     operands: exact bf16 products, as on the tensor cores. The packed A
//     (dx's phase gather, a forward's unaligned rows) is rounded once when
//     packed; bias and leaky_relu apply to the fp32 accumulator.
// Tensors are float32 or, all of x / w / gy and the output together,
// bfloat16 (`bf16`; the bias stays float32). bf16 operands make every
// product exact in either precision, so they run the default path. They are
// read as bf16 (half the bytes) and widened into the same fp32 shared tiles
// as float32 tensors (cp.async has no 2-byte copy: the gathered elements
// are loaded and stored by the threads, gy's rows in 8-byte pieces of 4;
// dw's gather takes kLoadBatch positions' loads before their stores, which
// measured 22.0 against 27.4 ms over the critics' convs on an H100, where
// the same batching of the tap kernel's window measured slower, 31.8
// against 20.5 ms forward, and is not kept); the output is rounded to bf16
// once, from the fp32 accumulator after bias and slope. dw returns the
// weight's dtype: its fp32 sums always go through the splits' scratch, and
// the pass that adds them rounds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>

#include "bf16_mma.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 16;  // reduction chunk through shared memory
constexpr int kLoadBatch = 8;  // bf16 positions dw's gather loads before it stores them

enum Mode { kFwd = 0, kDx = 1, kDw = 2 };
enum Prec { kHighest = 0, kDefault = 1 };

// Element i of a float32 tensor, or of a bfloat16 one (bf16 != 0), as fp32.
__device__ __forceinline__ float load_el(const void* p, size_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : __ldg(static_cast<const float*>(p) + i);
}

// Element i of a float32 or bfloat16 (rounded to nearest even) tensor = v.
__device__ __forceinline__ void store_el(void* p, size_t i, float v, int bf16) {
  if (bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

// The A operand (16 x 16) of an fp32 row-major shared tile as bf16 pairs,
// rounded: lane (g, t) holds rows g and g + 8 at reduction indices c0 + t,
// + 4 (registers 0, 1) and c0 + t + 8, + 12 (registers 2, 3).
__device__ __forceinline__ void load_a_bf16(const float* s, int ld, int r0, int c0, int g,
                                            int t, unsigned (&a)[4]) {
  const float* p = s + (r0 + g) * ld + c0 + t;
  a[0] = pack_bf16(p[0], p[4]);
  a[1] = pack_bf16(p[8 * ld], p[8 * ld + 4]);
  a[2] = pack_bf16(p[8], p[12]);
  a[3] = pack_bf16(p[8 * ld + 8], p[8 * ld + 12]);
}

// The B operand (16 x 8) with B[k][n] = s[k0 + k][n0 + n] in the same
// reduction order (lane (g, t): rows t, t + 4 and t + 8, t + 12 at column g).
__device__ __forceinline__ void load_b_bf16(const float* s, int ld, int k0, int n0, int g,
                                            int t, unsigned (&b)[2]) {
  const float* p = s + (k0 + t) * ld + n0 + g;
  b[0] = pack_bf16(p[0], p[4 * ld]);
  b[1] = pack_bf16(p[8 * ld], p[12 * ld]);
}

struct Geom {
  int n, cin, t_in, cout, t_out, k, stride, pad, dil, groups;
};

__host__ __device__ inline int gcd_int(int a, int b) {
  while (b) {
    const int r = a % b;
    a = b;
    b = r;
  }
  return a;
}

__host__ __device__ inline int mod_pos(int a, int m) { return ((a % m) + m) % m; }

// The taps of one stride phase of dx: outputs u = rho + stride * j,
// j < j_count, read taps m = m0 + ms * i, i < n_taps, at cotangent time
// t = j + base - i * dstep.
struct DxPhase {
  int m0, ms, n_taps, base, dstep, j_count;
};

__host__ __device__ inline DxPhase dx_phase(const Geom& g, int rho) {
  DxPhase p;
  const int gc = gcd_int(g.stride, g.dil);
  p.ms = g.stride / gc;
  p.dstep = g.dil / gc;
  p.m0 = -1;
  for (int m = 0; m < p.ms && m < g.k; ++m)
    if (mod_pos(rho + g.pad - g.dil * m, g.stride) == 0) {
      p.m0 = m;
      break;
    }
  p.n_taps = p.m0 < 0 ? 0 : (g.k - 1 - p.m0) / p.ms + 1;
  p.base = p.m0 < 0 ? 0 : (rho + g.pad - g.dil * p.m0) / g.stride;  // exact
  p.j_count = rho < g.t_in ? (g.t_in - rho + g.stride - 1) / g.stride : 0;
  return p;
}

template <int TM>
__device__ __forceinline__ void load_rows(const float* src, float (&a)[TM]) {
  if constexpr (TM % 4 == 0) {
#pragma unroll
    for (int i = 0; i < TM; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(src + i);
      a[i] = v.x;
      a[i + 1] = v.y;
      a[i + 2] = v.z;
      a[i + 3] = v.w;
    }
  } else if constexpr (TM % 2 == 0) {
#pragma unroll
    for (int i = 0; i < TM; i += 2) {
      const float2 v = *reinterpret_cast<const float2*>(src + i);
      a[i] = v.x;
      a[i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = src[i];
  }
}

// One BM x BN output tile of the GEMM of MODE. Operands:
//   kFwd: a = w (cout, cg, k), b = x (n, cin, t_in), out = y (n, cout, t_out),
//         blockIdx.z = group;
//   kDx:  a = w, b = gy (n, cout, t_out), out = dx (n, cin, t_in),
//         blockIdx.z = group * stride + phase;
//   kDw:  a = gy, b = x, out = dw (cout, cg, k), or with chunk < n * t_out the
//         partial sums (splits, cout, cg, k); blockIdx.z = group * splits + split.
// bias (nullable) and the slope apply in the forward and dx epilogues. With
// KS > 1 the block's NT threads form KS slices that take turns over the
// reduction's chunks (one-row tiles, whose columns are few and reductions
// long); slice 0 adds the slices' sums in slice order. a and b are float32,
// or bfloat16 with bf16 (then so is out in the forward and dx; dw's out is
// always fp32 sums); with rnd each operand is rounded to bf16 as it is
// loaded (precision default).
template <int MODE, int BM, int BN, int TM, int TN, int NT, int KS>
__global__ void __launch_bounds__(NT)
    conv_gemm_kernel(Geom g, const void* __restrict__ a_src,
                     const void* __restrict__ b_src,
                     const float* __restrict__ bias, void* __restrict__ out,
                     int has_slope, float slope, int splits, int chunk, int bf16,
                     int rnd) {
  constexpr int NS = NT / KS;          // threads per slice
  constexpr int kTX = BN / TN;        // threads along the columns
  constexpr int kRowStep = NS / BN;    // gathered-tile rows per pass
  static_assert((BM / TM) * kTX == NS, "tile does not match the block");
  static_assert(NS % BN == 0 && kBK % kRowStep == 0, "bad column tile");
  static_assert(KS == 1 || (TM == 1 && TN == 1), "slices take one-entry tiles");
  constexpr int kAPasses = (BM * kBK + NS - 1) / NS;
  __shared__ __align__(16) float As[KS][2][kBK][BM + 4];
  __shared__ float Bs[KS][2][kBK][BN];

  const int cg = g.cin / g.groups;
  const int cog = g.cout / g.groups;
  const int tid = threadIdx.x % NS;
  const int slice = threadIdx.x / NS;
  const int tx = tid % kTX;
  const int ty = tid / kTX;

  int grp, rows, ncols, r_begin, r_end;
  DxPhase ph{};
  int rho = 0, split = 0;
  if (MODE == kFwd) {
    grp = blockIdx.z;
    rows = cog;
    ncols = g.n * g.t_out;
    r_begin = 0;
    r_end = cg * g.k;
  } else if (MODE == kDx) {
    grp = blockIdx.z / g.stride;
    rho = blockIdx.z % g.stride;
    ph = dx_phase(g, rho);
    rows = cg;
    ncols = g.n * ph.j_count;
    r_begin = 0;
    r_end = cog * ph.n_taps;
  } else {
    grp = blockIdx.z / splits;
    split = blockIdx.z % splits;
    rows = cog;
    ncols = cg * g.k;
    const int q_total = g.n * g.t_out;
    r_begin = split * chunk;
    r_end = min(q_total, r_begin + chunk);
  }
  const int m_base = blockIdx.y * BM;
  const int c_base = blockIdx.x * BN;
  if (c_base >= ncols || m_base >= rows) return;  // whole block: a ragged grid

  // The column this thread gathers for the B tile, fixed for the whole loop.
  const int b_col = tid % BN;
  const int b_row0 = tid / BN;
  const int c = c_base + b_col;
  const bool c_ok = c < ncols;
  int col_pos = 0;               // kFwd: t s - p; kDx: j + base; kDw: d m - p
  size_t col_off = 0;            // kFwd: x row block; kDx: gy row block; kDw: ci * t_in
  if (c_ok) {
    if (MODE == kFwd) {
      const int n_ = c / g.t_out, t = c - n_ * g.t_out;
      col_off = (static_cast<size_t>(n_) * g.cin + grp * cg) * g.t_in;
      col_pos = t * g.stride - g.pad;
    } else if (MODE == kDx) {
      const int n_ = c / ph.j_count, j = c - n_ * ph.j_count;
      col_off = (static_cast<size_t>(n_) * g.cout + grp * cog) * g.t_out;
      col_pos = j + ph.base;
    } else {
      const int ci = c / g.k, m = c - ci * g.k;
      col_off = static_cast<size_t>(grp * cg + ci) * g.t_in;
      col_pos = g.dil * m - g.pad;
    }
  }
  // The A-tile entries this thread loads: reduction offset a_kk, rows a_row0 +
  // (NS / kBK) j.
  const int a_kk = tid % kBK;
  const int a_row0 = tid / kBK;
  // the decomposition's divisor of the B tile's reduction index
  const int b_div = MODE == kFwd ? g.k : (MODE == kDx ? ph.n_taps : g.t_out);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // The next chunk's operands are loaded into registers while this chunk's
  // FMAs run, then stored to the other shared buffer: one barrier per chunk.
  float a_reg[kAPasses];
  float b_reg[kBK / kRowStep];
  auto operand = [&](const void* src, size_t i) {
    const float v = load_el(src, i, bf16);
    return rnd ? round_bf16(v) : v;
  };
  auto fetch = [&](int r0) {
    {  // A tile entries (a_kk, a_row0 + (NS / kBK) j)
      const int r = r0 + a_kk;
      const bool r_ok = r < r_end;
      size_t a_off = 0, a_stride = 0;  // element of row 0; step from one row to the next
      if (r_ok) {
        if (MODE == kFwd) {
          a_off = static_cast<size_t>(grp * cog) * cg * g.k + r;
          a_stride = static_cast<size_t>(cg) * g.k;
        } else if (MODE == kDx) {
          const int co = r / ph.n_taps, i = r - co * ph.n_taps;
          a_off = static_cast<size_t>(grp * cog + co) * cg * g.k + ph.m0 + ph.ms * i;
          a_stride = g.k;
        } else {
          const int n_ = r / g.t_out, t = r - n_ * g.t_out;
          a_off = (static_cast<size_t>(n_) * g.cout + grp * cog) * g.t_out + t;
          a_stride = g.t_out;
        }
      }
#pragma unroll
      for (int j = 0; j < kAPasses; ++j) {
        const int gr = m_base + a_row0 + j * (NS / kBK);
        a_reg[j] = (r_ok && gr < rows) ? operand(a_src, a_off + gr * a_stride) : 0.f;
      }
    }
    {  // B tile entries (b_row0 + kRowStep i, b_col), gathered with the
       // conv's index map
      int rr = r0 + b_row0;
      int hi = 0, lo = 0;  // rr = hi * b_div + lo
      if (b_div > 0) {
        hi = rr / b_div;
        lo = rr - hi * b_div;
      }
#pragma unroll
      for (int i = 0; i < kBK / kRowStep; ++i) {
        float v = 0.f;
        if (c_ok && rr < r_end) {
          if (MODE == kFwd) {  // hi = ci, lo = m
            const int pos = col_pos + g.dil * lo;
            if (pos >= 0 && pos < g.t_in)
              v = operand(b_src, col_off + static_cast<size_t>(hi) * g.t_in + pos);
          } else if (MODE == kDx) {  // hi = co, lo = i
            const int t = col_pos - lo * ph.dstep;
            if (t >= 0 && t < g.t_out)
              v = operand(b_src, col_off + static_cast<size_t>(hi) * g.t_out + t);
          } else {  // hi = n, lo = t
            const int pos = lo * g.stride + col_pos;
            if (pos >= 0 && pos < g.t_in)
              v = operand(b_src, static_cast<size_t>(hi) * g.cin * g.t_in + col_off + pos);
          }
        }
        b_reg[i] = v;
        rr += kRowStep;
        lo += kRowStep;
        while (b_div > 0 && lo >= b_div) {
          lo -= b_div;
          ++hi;
        }
      }
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int j = 0; j < kAPasses; ++j) {
      const int row = a_row0 + j * (NS / kBK);
      if (row < BM) As[slice][buf][a_kk][row] = a_reg[j];
    }
#pragma unroll
    for (int i = 0; i < kBK / kRowStep; ++i)
      Bs[slice][buf][b_row0 + i * kRowStep][b_col] = b_reg[i];
  };

  // step st: this slice takes chunk st * KS + slice
  const int steps = ((r_end - r_begin + kBK - 1) / kBK + KS - 1) / KS;
  int buf = 0;
  if (steps > 0) {
    fetch(r_begin + slice * kBK);
    stash(0);
  }
  __syncthreads();
  for (int st = 0; st < steps; ++st) {
    const bool more = st + 1 < steps;
    if (more) fetch(r_begin + ((st + 1) * KS + slice) * kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[TM];
      float b[TN];
      load_rows<TM>(&As[slice][buf][kk][ty * TM], a);
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[slice][buf][kk][tx + j * kTX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) stash(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }
  if constexpr (KS > 1) {
    __shared__ float red[KS][NS];
    red[slice][tid] = acc[0][0];
    __syncthreads();
    if (slice != 0) return;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < KS; ++i) sum += red[i][tid];
    acc[0][0] = sum;
  }

  // epilogue
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int cc = c_base + tx + j * kTX;
    if (cc >= ncols) continue;
    size_t base = 0, row_step = 0;
    if (MODE == kFwd) {
      const int n_ = cc / g.t_out, t = cc - n_ * g.t_out;
      base = (static_cast<size_t>(n_) * g.cout + grp * cog) * g.t_out + t;
      row_step = g.t_out;
    } else if (MODE == kDx) {
      const int n_ = cc / ph.j_count, jj = cc - n_ * ph.j_count;
      base = (static_cast<size_t>(n_) * g.cin + grp * cg) * g.t_in + rho + g.stride * jj;
      row_step = g.t_in;
    } else {
      base = static_cast<size_t>(split) * g.cout * cg * g.k +
             static_cast<size_t>(grp * cog) * cg * g.k + cc;
      row_step = static_cast<size_t>(cg) * g.k;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = m_base + ty * TM + i;
      if (row >= rows) continue;
      float v = acc[i][j];
      if (MODE != kDw) {
        if (bias != nullptr) v += __ldg(bias + grp * (MODE == kFwd ? cog : cg) + row);
        if (has_slope) v = v > 0.f ? v : slope * v;
      }
      store_el(out, base + row * row_step, v, MODE == kDw ? 0 : bf16);
    }
  }
}

// ---- the weight gradient on the tensor cores ----

constexpr int kDwBK = 32;       // (item, time) positions per stage
constexpr int kDwMinRows = 16;  // rows per group from which dw takes conv_dw_kernel

// conv_dw_kernel's BM x BN block tile: WM x WN warps (NTH threads), each MI
// 16-row by NJ 8-column mma tiles; shared tiles As[row][position] (row
// stride LDA) and Bs[position][column] (LDB), STAGE floats per ring stage.
template <int BM, int BN, int WM, int WN>
struct DwTile {
  static constexpr int NTH = 32 * WM * WN;
  static constexpr int MI = BM / WM / 16;
  static constexpr int NJ = BN / WN / 8;
  static constexpr int LDA = kDwBK + 4;
  static constexpr int LDB = BN + 8;
  static constexpr int STAGE = BM * LDA + kDwBK * LDB;
  static_assert(MI >= 1 && NJ >= 1 && MI * WM * 16 == BM && NJ * WN * 8 == BN, "bad dw tile");
};

// One BM x BN tile of one group's dw over one split's positions [split *
// chunk, min(n * t_out, (split + 1) * chunk)); out = dw (cout, cg, k), or the
// partial sums (splits, cout, cg, k). blockIdx.z = group * splits + split.
// gy's rows are whole 16-byte pieces (t_out % 4 == 0, gy 16-byte aligned),
// or with bf16 whole 8-byte pieces of 4 (t_out % 4 == 0, 8-byte aligned).
// P: kHighest (3xTF32 m16n8k8) or kDefault (bf16 m16n8k16).
template <int BM, int BN, int WM, int WN, int P>
__global__ void __launch_bounds__(32 * WM * WN)
    conv_dw_kernel(Geom g, const void* __restrict__ gy, const void* __restrict__ x,
                   float* __restrict__ out, int splits, int chunk, int bf16) {
  using T = DwTile<BM, BN, WM, WN>;
  constexpr int BK = kDwBK, LDA = T::LDA, LDB = T::LDB, MI = T::MI, NJ = T::NJ;
  constexpr int NTH = T::NTH;
  constexpr int CT = BN > NTH ? BN / NTH : 1;  // columns a thread gathers
  constexpr int PR = BN > NTH ? 1 : NTH / BN;  // its positions' spacing
  extern __shared__ __align__(16) float smem[];

  const int cg = g.cin / g.groups, cog = g.cout / g.groups, ncols = cg * g.k;
  const int grp = blockIdx.z / splits, split = blockIdx.z % splits;
  const int m_base = blockIdx.y * BM, c_base = blockIdx.x * BN;
  const int r_begin = split * chunk;
  const int r_end = min(g.n * g.t_out, r_begin + chunk);
  const int tid = threadIdx.x;

  // The B columns this thread gathers: x channel offset and tap offset d m - p
  const int b_p0 = BN > NTH ? 0 : tid / BN;
  size_t ch_off[CT];
  int tap[CT];
  bool col_ok[CT];
#pragma unroll
  for (int j = 0; j < CT; ++j) {
    const int c = c_base + tid % BN + j * NTH;
    col_ok[j] = c < ncols;
    const int ci = col_ok[j] ? c / g.k : 0, m = col_ok[j] ? c - ci * g.k : 0;
    ch_off[j] = static_cast<size_t>(grp * cg + ci) * g.t_in;
    tap[j] = g.dil * m - g.pad;
  }
  const size_t item_x = static_cast<size_t>(g.cin) * g.t_in;
  const size_t item_gy = static_cast<size_t>(g.cout) * g.t_out;
  const size_t gy_rows = static_cast<size_t>(grp * cog + m_base) * g.t_out;
  const float* gy32 = static_cast<const float*>(gy);
  const float* x32 = static_cast<const float*>(x);

  auto stage = [&](int r, float* st) {
    float* As = st;
    float* Bs = st + BM * LDA;
    // A: gy[n, row, t .. t + 3] at positions r + pl .. + 3 (one item, as
    // t_out % 4 == 0) -> As[row][pl ..]; each thread keeps one position
    // quad (pl) and walks rows
    {
      constexpr int U = BK / 4;  // quads per row
      const int pl = 4 * (tid % U);
      const int pos = r + pl;
      const bool pos_ok = pos < r_end;
      const int n_ = pos_ok ? pos / g.t_out : 0;
      const size_t src = gy_rows + n_ * item_gy + (pos_ok ? pos - n_ * g.t_out : 0);
      constexpr int RS = NTH / U;  // rows apart; each thread takes BM / RS rows
      if (bf16) {  // all of the thread's 8-byte loads in flight, then the stores
        uint2 q[BM / RS];
#pragma unroll
        for (int i = 0; i < BM / RS; ++i) {
          const int row = tid / U + i * RS;
          q[i] = pos_ok && m_base + row < cog
                     ? *reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(gy) +
                                                       src + static_cast<size_t>(row) * g.t_out)
                     : make_uint2(0u, 0u);
        }
#pragma unroll
        for (int i = 0; i < BM / RS; ++i)  // bf16 bits -> fp32: the high half of the word
          *reinterpret_cast<float4*>(As + (tid / U + i * RS) * LDA + pl) =
              make_float4(__uint_as_float(q[i].x << 16), __uint_as_float(q[i].x & 0xffff0000u),
                          __uint_as_float(q[i].y << 16), __uint_as_float(q[i].y & 0xffff0000u));
      } else {
        for (int row = tid / U; row < BM; row += RS) {
          const bool ok = pos_ok && m_base + row < cog;
          cp_async16(As + row * LDA + pl, ok ? gy32 + src + static_cast<size_t>(row) * g.t_out
                                             : gy32, ok ? 16 : 0);
        }
      }
    }
    // B: x[n, ci, t s + d m - p] at position r + b_p0 + PR i -> Bs[pos][col]
    int pos = r + b_p0;
    int n_ = pos / g.t_out, t_ = pos - n_ * g.t_out;
    auto next = [&]() {
      pos += PR;
      t_ += PR;
      while (t_ >= g.t_out) {
        t_ -= g.t_out;
        ++n_;
      }
    };
    if (bf16) {  // kLoadBatch positions' loads in flight, then their stores
      static_assert((BK / PR) % kLoadBatch == 0, "positions per thread");
      for (int i0 = 0; i0 < BK / PR; i0 += kLoadBatch) {
        float v[kLoadBatch][CT];
#pragma unroll
        for (int i = 0; i < kLoadBatch; ++i) {
          const bool pos_ok = pos < r_end;
          const size_t xb = n_ * item_x;
#pragma unroll
          for (int j = 0; j < CT; ++j) {
            const int u = t_ * g.stride + tap[j];
            v[i][j] = pos_ok && col_ok[j] && u >= 0 && u < g.t_in
                          ? load_el(x, xb + ch_off[j] + u, 1) : 0.f;
          }
          next();
        }
#pragma unroll
        for (int i = 0; i < kLoadBatch; ++i)
#pragma unroll
          for (int j = 0; j < CT; ++j)
            Bs[(b_p0 + PR * (i0 + i)) * LDB + tid % BN + j * NTH] = v[i][j];
      }
    } else {
#pragma unroll 4
      for (int i = 0; i < BK / PR; ++i) {
        const bool pos_ok = pos < r_end;
        const size_t xb = n_ * item_x;
#pragma unroll
        for (int j = 0; j < CT; ++j) {
          const int u = t_ * g.stride + tap[j];
          const bool ok = pos_ok && col_ok[j] && u >= 0 && u < g.t_in;
          cp_async4(Bs + (b_p0 + PR * i) * LDB + tid % BN + j * NTH,
                    ok ? x32 + xb + ch_off[j] + u : x32, ok ? 4 : 0);
        }
        next();
      }
    }
  };

  const int warp = tid / 32, gl = (tid % 32) / 4, tl = tid % 4;
  const int wr0 = 16 * MI * (warp % WM), wc0 = 8 * NJ * (warp / WM);
  float acc[MI * NJ][4], part[MI * NJ][4];
#pragma unroll
  for (int i = 0; i < MI * NJ; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = part[i][e] = 0.f;

  // The ring: stage it + 1 is copied while stage it is multiplied. One
  // barrier per stage: after it, every thread has landed stage it's copies
  // and finished reading stage it - 1, whose buffer the next copy takes.
  const int steps = (r_end - r_begin + BK - 1) / BK;
  stage(r_begin, smem);
  cp_async_commit();
  for (int it = 0; it < steps; ++it) {
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < steps) stage(r_begin + (it + 1) * BK, smem + ((it + 1) & 1) * T::STAGE);
    cp_async_commit();
    const float* As = smem + (it & 1) * T::STAGE;
    const float* Bs = As + BM * LDA;
    if constexpr (P == kHighest) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 8) {
        unsigned ah[MI][4], al[MI][4];
#pragma unroll
        for (int i = 0; i < MI; ++i) load_a(As, LDA, wr0 + 16 * i, kk, gl, tl, ah[i], al[i]);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          unsigned bh[2], bl[2];
          load_b(Bs, LDB, kk, wc0 + 8 * j, gl, tl, bh, bl);
#pragma unroll
          for (int i = 0; i < MI; ++i) mma_3xtf32(part[i * NJ + j], ah[i], al[i], bh, bl);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        unsigned a[MI][4];
#pragma unroll
        for (int i = 0; i < MI; ++i) load_a_bf16(As, LDA, wr0 + 16 * i, kk, gl, tl, a[i]);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          unsigned b[2];
          load_b_bf16(Bs, LDB, kk, wc0 + 8 * j, gl, tl, b);
#pragma unroll
          for (int i = 0; i < MI; ++i) mma_bf16(part[i * NJ + j], a[i], b);
        }
      }
    }
    add_part(acc, part);
  }

  float* base = out + static_cast<size_t>(split) * g.cout * ncols +
                static_cast<size_t>(grp * cog + m_base) * ncols + c_base;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = wr0 + 16 * i + gl + 8 * (e >> 1);
        const int col = wc0 + 8 * j + 2 * tl + (e & 1);
        if (m_base + row < cog && c_base + col < ncols)
          base[static_cast<size_t>(row) * ncols + col] = acc[i * NJ + j][e];
      }
}

// ---- the forward and the input gradient on the tensor cores ----

constexpr int kTapBK = 32;       // reduction indices (channel, tap) per stage
constexpr int kTapStages = 3;    // the cp.async ring: two stages in flight
constexpr int kTapMinRows = 16;  // GEMM rows per group from which fwd / dx take conv_tap_kernel
constexpr int kTapMaxSmem = 232448;  // bytes of shared memory a block may take

// The tap GEMM of one block: out[row, (item, j)] = sum over (c, m) of
// A[row, (c, m)] src[item, c, j S + off(m)], with off(m) = off_min + rel(m).
//   forward: rows co, channels ci, taps m < k, S = stride, rel = d m,
//            off_min = -pad, j < t_out;
//   dx:      rows ci, channels co, taps i < n_taps of the block's phase,
//            S = 1, rel = (n_taps - 1 - i) dstep, off_min = base - (n_taps -
//            1) dstep, j < j_count, out at u = rho + stride j.
// Host plan (TapPlan) and kernel share the window layout: per channel slot,
// S phase rows of `lpp` floats; entry (phase f, idx) holds src position
// (j_first + idx - sb) S + f + off_min of the segment (item) it falls in.
struct TapPlan {
  int depth, kp;   // the reduction's length (the longest phase's in dx) and A's packed row
  int qx;          // extra window entries per segment: span / S
  int lpp;         // phase-row pitch (>= bn + nseg qx)
  int ldw;         // channel-slot pitch: S lpp
  int nch;         // channel slots per stage
  int stage;       // floats per ring stage
  size_t smem;     // bytes
};

// One column tile's window rows are pitched so that a B fragment (4 taps of
// one channel at lanes t, 8 columns at lanes g) hits 32 banks: at stride S
// the 4 taps fall in up to 4 phase rows, which a pitch of 16 (S = 2), 11
// (S = 3) or 8 (S >= 4) floats mod 32 sets apart.
inline int tap_pitch(int lp, int s) {
  if (s == 1) return lp;
  const int want = s == 2 ? 16 : (s == 3 ? 11 : 8);
  return lp + (((want - lp) % 32) + 32) % 32;
}

// conv_tap_kernel's BM x BN block tile: WM x WN warps, each MI x NJ mma tiles.
template <int BM, int BN, int WM, int WN>
struct TapTile {
  static constexpr int NTH = 32 * WM * WN;
  static constexpr int MI = BM / WM / 16;
  static constexpr int NJ = BN / WN / 8;
  static constexpr int LDA = kTapBK + 4;
  static_assert(MI >= 1 && NJ >= 1 && MI * WM * 16 == BM && NJ * WN * 8 == BN, "bad tap tile");
};

// The A operand of the tap GEMM of MODE as rows of kp floats, zero past
// the reduction: per block z (kFwd: group; kDx: group * stride + phase) R
// rows. forward A[co][(ci, m)] = w[co, ci, m] (rows not whole 16-byte
// pieces, or a bf16 w); dx A[ci][(co, i)] = w[co, ci, m0 + ms i], the
// phase's taps. w is float32 or bfloat16 (bf16); rnd rounds each tap to
// bf16 once, here (precision default).
template <int MODE>
__global__ void pack_tap_a_kernel(Geom g, int kp, const void* __restrict__ w,
                                  float* __restrict__ pack, size_t count, int bf16, int rnd) {
  const int cg = g.cin / g.groups, cog = g.cout / g.groups;
  const int rows = MODE == kFwd ? cog : cg;
  for (size_t e = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; e < count;
       e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t zr = e / kp;
    const int r = static_cast<int>(e - zr * kp);
    const int z = static_cast<int>(zr / rows), row = static_cast<int>(zr - z * rows);
    float a = 0.f;
    if (MODE == kFwd) {
      if (r < cg * g.k) a = load_el(w, zr * cg * g.k + r, bf16);
    } else {
      const DxPhase ph = dx_phase(g, z % g.stride);
      if (r < cog * ph.n_taps) {
        const int co = r / ph.n_taps, i = r - co * ph.n_taps;
        a = load_el(w, (static_cast<size_t>(z / g.stride * cog + co) * cg + row) * g.k +
                           ph.m0 + ph.ms * i, bf16);
      }
    }
    pack[e] = rnd ? round_bf16(a) : a;
  }
}

// One BM x BN tile of the tap GEMM of MODE (kFwd: blockIdx.z = group; kDx:
// blockIdx.z = group * stride + phase). The reduction runs over (channel,
// tap) in stages of kTapBK: A in 16-byte copies of rows of lda floats (w
// itself or its pack; block z's rows from a + z * a_z) and, per channel the
// stage touches, the source window of the block's columns over all taps,
// staged once and read by the B fragments of every tap. A kTapStages-deep
// cp.async ring. P: kHighest (3xTF32 m16n8k8) or kDefault (bf16 m16n8k16).
// src and out are float32, or bfloat16 with bf16 (its window then loaded
// and widened by the threads); A is fp32 (w itself, or its pack).
template <int MODE, int BM, int BN, int WM, int WN, int P>
__global__ void __launch_bounds__(32 * WM * WN)
    conv_tap_kernel(Geom g, TapPlan p, const float* __restrict__ a, int lda, size_t a_z,
                    const void* __restrict__ src, const float* __restrict__ bias,
                    void* __restrict__ out, int has_slope, float slope, int bf16) {
  using TT = TapTile<BM, BN, WM, WN>;
  constexpr int BK = kTapBK, LDA = TT::LDA, MI = TT::MI, NJ = TT::NJ, NTH = TT::NTH;
  constexpr int A_STAGE = BM * LDA;  // floats of A per stage
  extern __shared__ __align__(16) float smem[];

  const int cg = g.cin / g.groups, cog = g.cout / g.groups;
  int grp, rho = 0, R, C, T, S, J, off_min, t_src, c_total, dstep = 0;
  DxPhase ph{};
  if (MODE == kFwd) {
    grp = blockIdx.z;
    R = cog, C = cg, T = g.k, S = g.stride, J = g.t_out, off_min = -g.pad;
    t_src = g.t_in, c_total = g.cin;
  } else {
    grp = blockIdx.z / g.stride;
    rho = blockIdx.z % g.stride;
    ph = dx_phase(g, rho);
    R = cg, C = cog, T = ph.n_taps, S = 1, J = ph.j_count;
    dstep = ph.dstep;
    off_min = ph.base - (T - 1) * ph.dstep;
    t_src = g.t_out, c_total = g.cout;
  }
  const int ncols = g.n * J, K = C * T;
  const int m_base = blockIdx.y * BM, c_base = blockIdx.x * BN;
  if (c_base >= ncols || m_base >= R) return;  // whole block: a ragged grid
  const int tid = threadIdx.x;
  const int n0 = c_base / J, c_end = min(c_base + BN, ncols);
  const int ent = S * p.lpp;  // window entries per channel slot

  int* tab_n = reinterpret_cast<int*>(smem + kTapStages * p.stage);
  int* tab_u = tab_n + ent;
  int* tapoff = tab_u + ent;
  // Per window entry its item and source position (-1: zero), and per tap
  // its entry offset phase * lpp + rel / S: fixed for the block.
  for (int e = tid; e < ent; e += NTH) {
    const int f = e / p.lpp, idx = e - f * p.lpp;
    int n_ = n0, col0 = c_base, sb = 0, u = -1;
    while (col0 < c_end) {
      const int cnt = min((n_ + 1) * J, c_end) - col0;
      if (idx < sb + cnt + p.qx) {
        u = (col0 - n_ * J + idx - sb) * S + f + off_min;
        if (u >= t_src) u = -1;
        break;
      }
      sb += cnt + p.qx;
      col0 += cnt;
      ++n_;
    }
    tab_n[e] = n_;
    tab_u[e] = u;
  }
  for (int m = tid; m < T; m += NTH) {
    const int rel = MODE == kFwd ? g.dil * m : (T - 1 - m) * dstep;
    tapoff[m] = (rel % S) * p.lpp + rel / S;
  }
  __syncthreads();

  const size_t src_grp = static_cast<size_t>(grp) * C * t_src;
  const size_t item_src = static_cast<size_t>(c_total) * t_src;
  const float* src32 = static_cast<const float*>(src);
  auto channels = [&](int r0) {  // first channel of a stage and how many it touches
    return make_int2(r0 / T, (r0 + BK - 1) / T - r0 / T + 1);
  };

  const float* a_rows = a + blockIdx.z * a_z + static_cast<size_t>(m_base) * lda;
  auto stage = [&](int r0, float* st) {
    float* As = st;
    float* win = st + A_STAGE;
    int* offtab = reinterpret_cast<int*>(win + p.nch * p.ldw);
    {  // A: rows m_base.., reduction r0 .. (zero past the rows and K)
      const int q = 4 * (tid % (BK / 4));
      const bool r_ok = r0 + q < K;  // lda % 4 == 0: a quad is whole or out
      for (int row = tid / (BK / 4); row < BM; row += NTH / (BK / 4)) {
        const bool ok = r_ok && m_base + row < R;
        cp_async16(As + row * LDA + q, ok ? a_rows + static_cast<size_t>(row) * lda + r0 + q : a,
                   ok ? 16 : 0);
      }
    }
    // the window of each channel the stage touches (zero beyond C)
    const int2 ch = channels(r0);
    for (int e = tid; e < ent; e += NTH) {
      const int u = tab_u[e];
      const size_t row = src_grp + tab_n[e] * item_src + u;  // read only where u >= 0
      for (int cs = 0; cs < ch.y; ++cs) {
        const bool ok = u >= 0 && ch.x + cs < C;
        const size_t el = row + static_cast<size_t>(ch.x + cs) * t_src;
        if (bf16)
          win[cs * p.ldw + e] = ok ? load_el(src, el, 1) : 0.f;
        else
          cp_async4(win + cs * p.ldw + e, ok ? src32 + el : src32, ok ? 4 : 0);
      }
    }
    if (tid < BK) {
      const int r = r0 + tid, c = r / T, m = r - c * T;
      offtab[tid] = (c - ch.x) * p.ldw + tapoff[m];
    }
  };

  const int warp = tid / 32, gl = (tid % 32) / 4, tl = tid % 4;
  const int wr0 = 16 * MI * (warp % WM), wc0 = 8 * NJ * (warp / WM);
  // each lane's B column per n-tile: its window index (column - c_base +
  // segment * qx); 0 for columns past the end (their outputs are not stored)
  int colbase[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int col = c_base + wc0 + 8 * j + gl;
    colbase[j] = col < ncols ? col - c_base + (col / J - n0) * p.qx : 0;
  }
  float acc[MI * NJ][4], part[MI * NJ][4];
#pragma unroll
  for (int i = 0; i < MI * NJ; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = part[i][e] = 0.f;

  // The ring: stages it + 1 and it + 2 are in flight while stage it is
  // multiplied. One barrier per stage: after it, every thread has landed
  // stage it's copies and finished reading stage it - 1, whose buffer the
  // next copy takes.
  constexpr int NS = kTapStages;
  const int steps = (K + BK - 1) / BK;
  for (int s0 = 0; s0 < NS - 1; ++s0) {
    if (s0 < steps) stage(s0 * BK, smem + s0 * p.stage);
    cp_async_commit();
  }
  for (int it = 0; it < steps; ++it) {
    const float* st = smem + (it % NS) * p.stage;
    cp_async_wait<NS - 2>();
    __syncthreads();
    if (it + NS - 1 < steps) stage((it + NS - 1) * BK, smem + ((it + NS - 1) % NS) * p.stage);
    cp_async_commit();
    const float* As = st;
    const float* win = st + A_STAGE;
    const int* offtab = reinterpret_cast<const int*>(win + p.nch * p.ldw);
    if constexpr (P == kHighest) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 8) {
        const int o0 = offtab[kk + tl], o1 = offtab[kk + tl + 4];
        unsigned ah[MI][4], al[MI][4];
#pragma unroll
        for (int i = 0; i < MI; ++i) load_a(As, LDA, wr0 + 16 * i, kk, gl, tl, ah[i], al[i]);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          unsigned bh[2], bl[2];
          split_tf32(win[o0 + colbase[j]], bh[0], bl[0]);
          split_tf32(win[o1 + colbase[j]], bh[1], bl[1]);
#pragma unroll
          for (int i = 0; i < MI; ++i) mma_3xtf32(part[i * NJ + j], ah[i], al[i], bh, bl);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {  // lane t: indices t, t + 4, t + 8, t + 12
        const int o0 = offtab[kk + tl], o1 = offtab[kk + tl + 4];
        const int o2 = offtab[kk + tl + 8], o3 = offtab[kk + tl + 12];
        unsigned a16[MI][4];
#pragma unroll
        for (int i = 0; i < MI; ++i) load_a_bf16(As, LDA, wr0 + 16 * i, kk, gl, tl, a16[i]);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const unsigned b16[2] = {pack_bf16(win[o0 + colbase[j]], win[o1 + colbase[j]]),
                                   pack_bf16(win[o2 + colbase[j]], win[o3 + colbase[j]])};
#pragma unroll
          for (int i = 0; i < MI; ++i) mma_bf16(part[i * NJ + j], a16[i], b16);
        }
      }
    }
    add_part(acc, part);
  }

  // epilogue: bias, leaky_relu, one writer per output
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = c_base + wc0 + 8 * j + 2 * tl + h;
      if (col >= ncols) continue;
      const int n_ = col / J, jj = col - n_ * J;
      size_t base, row_step;
      if (MODE == kFwd) {
        base = (static_cast<size_t>(n_) * g.cout + grp * cog) * g.t_out + jj;
        row_step = g.t_out;
      } else {
        base = (static_cast<size_t>(n_) * g.cin + grp * cg) * g.t_in + rho + g.stride * jj;
        row_step = g.t_in;
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int row = m_base + wr0 + 16 * i + gl + 8 * e2;
          if (row >= R) continue;
          float v = acc[i * NJ + j][2 * e2 + h];
          if (bias != nullptr) v += __ldg(bias + grp * R + row);
          if (has_slope) v = v > 0.f ? v : slope * v;
          store_el(out, base + row * row_step, v, bf16);
        }
    }
}

// dst (rows, t_pad) = src (rows, t) with each row zero-padded to t_pad, of
// floats or (E = __nv_bfloat16) bf16 values.
template <typename E>
__global__ void pad_rows_kernel(const E* __restrict__ src, E* __restrict__ dst, size_t rows,
                                int t, int t_pad) {
  const size_t count = rows * t_pad;
  for (size_t e = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; e < count;
       e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t r = e / t_pad;
    const int c = static_cast<int>(e - r * t_pad);
    dst[e] = c < t ? src[r * t + c] : E(0.f);
  }
}

// dw[e] = sum over the splits of part[split, e], in split order; dw float32
// or bfloat16 (bf16: the sum rounded once).
__global__ void sum_splits_kernel(const float* __restrict__ part, void* __restrict__ dw,
                                  size_t count, int splits, int bf16) {
  for (size_t e = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       e < count; e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int sp = 0; sp < splits; ++sp) s += part[sp * count + e];
    store_el(dw, e, s, bf16);
  }
}

// The operands and options of one entry point's GEMM: a and b as the
// kernels take them (float32, or bfloat16 with bf16), the bias, the output
// (dw: fp32 sums), the epilogue's slope, dw's splits, and the precision.
struct Args {
  const void* a;
  const void* b;
  const float* bias;
  void* out;
  int has_slope;
  float slope;
  int splits, chunk;
  int prec, bf16;
};

template <int MODE, int BM, int BN, int TM, int TN, int NT, int KS>
int launch(const Geom& g, int rows, int ncols, int grid_z, const Args& q, cudaStream_t stream) {
  const dim3 grid((ncols + BN - 1) / BN, (rows + BM - 1) / BM, grid_z);
  if (grid.y > 65535u || grid.z > 65535u)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  conv_gemm_kernel<MODE, BM, BN, TM, TN, NT, KS><<<grid, NT, 0, stream>>>(
      g, q.a, q.b, q.bias, q.out, q.has_slope, q.slope, q.splits, q.chunk, q.bf16,
      q.prec == kDefault);
  return static_cast<int>(cudaGetLastError());
}

// The tile follows the GEMM's row count (channels per group): wide rows take
// 128-row tiles, narrow ones trade rows for columns so that few rows waste
// little. For the forward and dx a 128 x 128 tile does twice a 128 x 64
// tile's work and feeds twice the FMAs from each shared load; counted 1.25x
// faster per FMA, it is taken unless it needs nearly as many waves of blocks
// over the SMs (MSD L5 at scale 1: 136 blocks for 132 SMs take 2 waves, as do
// 264 blocks of 128 x 64 at half the work each). dw comes here only below
// kDwMinRows rows. One
// row (cg = 1 at dx of the first layers, cout = 1 at conv_post) takes 32
// columns per block and splits the reduction over 8 slices of a warp each:
// conv_post has few columns and a long reduction, which wide tiles would
// leave to a few SMs. Keep in step with ops/cuda/grouped_conv.py::dw_tile.
template <int MODE>
int dispatch(const Geom& g, int rows, int ncols, int grid_z, const Args& q,
             cudaStream_t stream) {
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  auto waves = [&](int bm, int bn) {
    const long long blocks = static_cast<long long>((ncols + bn - 1) / bn) *
                             ((rows + bm - 1) / bm) * grid_z;
    return (blocks + sms - 1) / sms;
  };
#define PSTT_LAUNCH(BM, BN, TM, TN, KS) \
  return launch<MODE, BM, BN, TM, TN, kThreads, KS>(g, rows, ncols, grid_z, q, stream)
  if (rows >= 128 && 8 * waves(128, 128) <= 5 * waves(128, 64))
    PSTT_LAUNCH(128, 128, 8, 8, 1);
  if (rows >= 128) PSTT_LAUNCH(128, 64, 8, 4, 1);
  if (rows >= 64) PSTT_LAUNCH(64, 64, 4, 4, 1);
  if (rows >= 32) PSTT_LAUNCH(32, 128, 4, 4, 1);
  if (rows >= 16) PSTT_LAUNCH(16, 256, 4, 4, 1);
  if (rows >= 2) PSTT_LAUNCH(8, 256, 2, 4, 1);
  PSTT_LAUNCH(1, 32, 1, 1, 8);
#undef PSTT_LAUNCH
}

template <int BM, int BN, int WM, int WN, int P>
int launch_dw_prec(const Geom& g, const Args& q, cudaStream_t stream) {
  using T = DwTile<BM, BN, WM, WN>;
  const int rows = g.cout / g.groups, ncols = (g.cin / g.groups) * g.k;
  const dim3 grid((ncols + BN - 1) / BN, (rows + BM - 1) / BM, g.groups * q.splits);
  if (grid.y > 65535u || grid.z > 65535u)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = sizeof(float) * 2 * T::STAGE;
  const cudaError_t err = cudaFuncSetAttribute(
      conv_dw_kernel<BM, BN, WM, WN, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  conv_dw_kernel<BM, BN, WM, WN, P><<<grid, T::NTH, smem, stream>>>(
      g, q.a, q.b, static_cast<float*>(q.out), q.splits, q.chunk, q.bf16);
  return static_cast<int>(cudaGetLastError());
}

// conv_dw_kernel in the precision of q (bf16 tensors: default).
template <int BM, int BN, int WM, int WN>
int launch_dw(const Geom& g, const Args& q, cudaStream_t stream) {
  return q.prec == kDefault ? launch_dw_prec<BM, BN, WM, WN, kDefault>(g, q, stream)
                            : launch_dw_prec<BM, BN, WM, WN, kHighest>(g, q, stream);
}

// conv_dw_kernel's tile by rows per group (>= kDwMinRows). Keep in step with
// ops/cuda/grouped_conv.py::dw_tile.
int dispatch_dw(const Geom& g, const Args& q, cudaStream_t stream) {
  const int rows = g.cout / g.groups;
  if (rows >= 128) return launch_dw<128, 64, 2, 2>(g, q, stream);
  if (rows >= 64) return launch_dw<64, 64, 2, 2>(g, q, stream);
  if (rows >= 32) return launch_dw<32, 128, 1, 4>(g, q, stream);
  return launch_dw<16, 256, 1, 4>(g, q, stream);
}

// The tap kernel's plan for MODE at a BM x BN tile: the window of the
// shortest items (most segments per tile) over the widest tap span, the
// channel slots of the phase with the fewest taps. smem = 0: no tap to run
// (dx with no tap in any phase cannot happen: every tap lies in one phase).
TapPlan tap_plan(int mode, const Geom& g, int bm, int bn) {
  TapPlan p{};
  int s, t_min, t_max, span, j_min;
  if (mode == kFwd) {
    s = g.stride;
    t_min = t_max = g.k;
    span = g.dil * (g.k - 1);
    j_min = g.t_out;
  } else {
    s = 1;
    t_min = g.k;
    t_max = 1;
    for (int rho = 0; rho < g.stride; ++rho) {
      const int taps = dx_phase(g, rho).n_taps;
      if (taps > 0) {
        t_min = std::min(t_min, taps);
        t_max = std::max(t_max, taps);
      }
    }
    span = (t_max - 1) * (g.dil / gcd_int(g.stride, g.dil));
    j_min = std::max(1, g.t_in / g.stride);
  }
  const int nseg = std::min(g.n, (bn - 1) / j_min + 2);
  const int depth = mode == kFwd ? (g.cin / g.groups) * g.k : (g.cout / g.groups) * t_max;
  p.depth = depth;
  p.kp = (depth + kTapBK - 1) / kTapBK * kTapBK;
  p.qx = span / s;
  p.lpp = tap_pitch(bn + nseg * p.qx, s);
  p.ldw = s * p.lpp;
  p.nch = (kTapBK - 1) / t_min + 2;
  p.stage = (bm * (kTapBK + 4) + p.nch * p.ldw + kTapBK + 3) / 4 * 4;
  p.smem = sizeof(float) * (kTapStages * static_cast<size_t>(p.stage) + 2 * p.ldw + g.k);
  return p;
}

// Scratch for the packed A, stream-ordered on the caller's stream (the C
// entry points take no scratch argument): freed scratch stays in the
// device's pool for the next call instead of going back to the driver.
cudaError_t tap_scratch(void** ptr, size_t bytes, cudaStream_t stream) {
  int device = 0;
  cudaMemPool_t pool;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetDefaultMemPool(&pool, device);
  if (err == cudaSuccess) {
    uint64_t keep = ~0ull;
    err = cudaMemPoolSetAttribute(pool, cudaMemPoolAttrReleaseThreshold, &keep);
  }
  return err == cudaSuccess ? cudaMallocAsync(ptr, bytes, stream) : err;
}

// Launches the tap kernel on A: w itself for a float32 forward whose rows
// are whole 16-byte pieces, else A packed into scratch first (dx always: its
// A is gathered per phase; a bf16 w: A is fp32), rounded there in default.
template <int MODE, int BM, int BN, int WM, int WN, int P>
int launch_tap(const Geom& g, const TapPlan& p, int grid_z, int rows, int ncols, const Args& q,
               cudaStream_t stream) {
  const dim3 grid((ncols + BN - 1) / BN, (rows + BM - 1) / BM, grid_z);
  if (grid.y > 65535u || grid.z > 65535u)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  auto kernel = conv_tap_kernel<MODE, BM, BN, WM, WN, P>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(p.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int depth = (g.cin / g.groups) * g.k;
  if (MODE == kFwd && !q.bf16 && depth % 4 == 0 && reinterpret_cast<uintptr_t>(q.a) % 16 == 0) {
    kernel<<<grid, TapTile<BM, BN, WM, WN>::NTH, p.smem, stream>>>(
        g, p, static_cast<const float*>(q.a), depth, static_cast<size_t>(rows) * depth, q.b,
        q.bias, q.out, q.has_slope, q.slope, q.bf16);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t count = static_cast<size_t>(grid_z) * rows * p.kp;
  float* pack = nullptr;
  err = tap_scratch(reinterpret_cast<void**>(&pack), count * sizeof(float), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t blocks = std::min<size_t>(4096, (count + 255) / 256);
  pack_tap_a_kernel<MODE><<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
      g, p.kp, q.a, pack, count, q.bf16, P == kDefault);
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    kernel<<<grid, TapTile<BM, BN, WM, WN>::NTH, p.smem, stream>>>(
        g, p, pack, p.kp, static_cast<size_t>(rows) * p.kp, q.b, q.bias, q.out, q.has_slope,
        q.slope, q.bf16);
    err = cudaGetLastError();
  }
  const cudaError_t freed = cudaFreeAsync(pack, stream);
  return static_cast<int>(err != cudaSuccess ? err : freed);
}

// The forward or dx of MODE on the tensor cores from kTapMinRows GEMM rows
// per group and one stage of reduction, its tile by rows (as
// conv_dw_kernel's) and its products by q's precision; -1 where the rows or
// the reduction are fewer (the critics' first layers: one input channel) or
// the window does not fit a block: the caller then takes conv_gemm_kernel.
// Keep in step with ops/cuda/grouped_conv.py::tap_tile and fwd_kernel.
template <int MODE>
int dispatch_tap(const Geom& g, int rows, int ncols, int grid_z, const Args& q,
                 cudaStream_t stream) {
  if (rows < kTapMinRows) return -1;
#define PSTT_TAP(BM, BN, WM, WN)                                                               \
  {                                                                                            \
    const TapPlan p = tap_plan(MODE, g, BM, BN);                                               \
    if (p.depth < kTapBK || p.smem > static_cast<size_t>(kTapMaxSmem)) return -1;              \
    return q.prec == kDefault                                                                  \
               ? launch_tap<MODE, BM, BN, WM, WN, kDefault>(g, p, grid_z, rows, ncols, q, stream) \
               : launch_tap<MODE, BM, BN, WM, WN, kHighest>(g, p, grid_z, rows, ncols, q, stream); \
  }
  if (rows >= 128) PSTT_TAP(128, 64, 2, 2)
  if (rows >= 64) PSTT_TAP(64, 64, 2, 2)
  if (rows >= 32) PSTT_TAP(32, 128, 1, 4)
  PSTT_TAP(16, 256, 1, 4)
#undef PSTT_TAP
}

bool valid_geom(const Geom& g) {
  if (g.n < 1 || g.cin < 1 || g.cout < 1 || g.t_in < 1 || g.k < 1 ||
      g.stride < 1 || g.dil < 1 || g.pad < 0 || g.groups < 1 ||
      g.cin % g.groups || g.cout % g.groups)
    return false;
  const int t_out = (g.t_in + 2 * g.pad - g.dil * (g.k - 1) - 1) / g.stride + 1;
  // flattened (item, time) columns are int
  return g.t_out >= 1 && g.t_out == t_out &&
         static_cast<long long>(g.n) * g.t_in < (1LL << 31) &&
         static_cast<long long>(g.n) * g.t_out < (1LL << 31);
}

// The precision the kernels run: bf16 tensors make every product exact, so
// they run default whatever was asked; -1 for an unknown precision.
int effective_prec(int precision, int bf16) {
  if (precision != kHighest && precision != kDefault) return -1;
  return bf16 ? kDefault : precision;
}

}  // namespace

// y (n, cout, t_out) = lrelu(conv1d(x (n, cin, t_in), w (cout, cin / groups,
// k)) + b); b may be null, has_slope 0 skips the leaky_relu. precision 0
// (highest) or 1 (default); bf16: x, w and y are bfloat16 (b float32).
// Returns a cudaError_t; 0 when launched.
extern "C" int grouped_conv_forward(const void* x, const void* w,
                                    const float* b, void* y, int n, int cin,
                                    int t_in, int cout, int t_out, int k,
                                    int stride, int pad, int dil, int groups,
                                    int has_slope, float slope, int precision, int bf16,
                                    void* stream) {
  const Geom g{n, cin, t_in, cout, t_out, k, stride, pad, dil, groups};
  const int prec = effective_prec(precision, bf16);
  if (!valid_geom(g) || prec < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args q{w, x, b, y, has_slope, slope, 1, 0, prec, bf16};
  const int tc = dispatch_tap<kFwd>(g, cout / groups, n * t_out, groups, q, st);
  if (tc >= 0) return tc;
  return dispatch<kFwd>(g, cout / groups, n * t_out, groups, q, st);
}

// dx (n, cin, t_in) of the conv above from its cotangent gy (n, cout, t_out),
// then + b (cin,) and leaky_relu when given: a ConvTranspose1d of gy with
// weight w (cout, cin, k) is this with groups 1 and dilation 1. precision
// and bf16 (gy, w and dx) as above.
extern "C" int grouped_conv_input_grad(const void* gy, const void* w,
                                       const float* b, void* dx, int n,
                                       int cin, int t_in, int cout, int t_out,
                                       int k, int stride, int pad, int dil,
                                       int groups, int has_slope, float slope,
                                       int precision, int bf16, void* stream) {
  const Geom g{n, cin, t_in, cout, t_out, k, stride, pad, dil, groups};
  const int prec = effective_prec(precision, bf16);
  if (!valid_geom(g) || prec < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int j_max = (t_in + stride - 1) / stride;  // phase 0 has the most
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args q{w, gy, b, dx, has_slope, slope, 1, 0, prec, bf16};
  const int tc = dispatch_tap<kDx>(g, cin / groups, n * j_max, groups * stride, q, st);
  if (tc >= 0) return tc;
  return dispatch<kDx>(g, cin / groups, n * j_max, groups * stride, q, st);
}

// dw (cout, cin / groups, k) of the conv above from x and gy; precision as
// above; bf16: x, gy and dw are bfloat16. The fp32 sums are staged in
// scratch when splits > 1 or bf16: it starts with splits * cout * (cin /
// groups) * k floats, rounded up to a multiple of 4: the reduction over n *
// t_out is cut into splits chunks whose partial sums a second pass adds in a
// fixed order (deterministic, no atomics) and writes in dw's dtype. With
// cout / groups >= 16 (the tensor-core kernel), when t_out % 4 != 0 or gy is
// not aligned to its rows' copies (16 bytes, bf16 8), n * cout *
// round_up(t_out, 4) elements of gy's dtype follow (at the start when
// nothing is staged): gy with its rows zero-padded, which the kernel reads in
// whole pieces of 4 (padded positions add zero products).
extern "C" int grouped_conv_weight_grad(const void* x, const void* gy,
                                        void* dw, float* scratch, int n,
                                        int cin, int t_in, int cout, int t_out,
                                        int k, int stride, int pad, int dil,
                                        int groups, int splits, int precision, int bf16,
                                        void* stream) {
  const Geom g{n, cin, t_in, cout, t_out, k, stride, pad, dil, groups};
  const int prec = effective_prec(precision, bf16);
  const bool staged = splits > 1 || bf16;
  if (!valid_geom(g) || prec < 0 || splits < 1 || (staged && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  // the tensor-core kernel from kDwMinRows rows per group, its chunks whole
  // 32-position stages, on gy padded where its rows are not whole pieces;
  // below, the CUDA-core kernel in 16-position chunks
  const bool tc = cout / groups >= kDwMinRows;
  const int piece = bf16 ? 8 : 16;  // bytes of gy's row copies (4 elements)
  const bool padded = tc && (t_out % 4 != 0 || reinterpret_cast<uintptr_t>(gy) % piece != 0);
  Geom ga = g;
  if (padded) ga.t_out = (t_out + 3) / 4 * 4;
  if ((padded && scratch == nullptr) || static_cast<long long>(n) * ga.t_out >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t count = static_cast<size_t>(cout) * (cin / groups) * k;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* a = gy;
  if (padded) {
    float* gyp = scratch + (staged ? (splits * count + 3) / 4 * 4 : 0);
    if (reinterpret_cast<uintptr_t>(gyp) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    const size_t rows = static_cast<size_t>(n) * cout;
    const size_t blocks = std::min<size_t>(4096, (rows * ga.t_out + 255) / 256);
    if (bf16)
      pad_rows_kernel<<<static_cast<unsigned>(blocks), 256, 0, st>>>(
          static_cast<const __nv_bfloat16*>(gy), reinterpret_cast<__nv_bfloat16*>(gyp), rows,
          t_out, ga.t_out);
    else
      pad_rows_kernel<<<static_cast<unsigned>(blocks), 256, 0, st>>>(
          static_cast<const float*>(gy), gyp, rows, t_out, ga.t_out);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    a = gyp;
  }
  const int depth = tc ? kDwBK : kBK;
  const int q_total = n * ga.t_out;
  int chunk = (q_total + splits - 1) / splits;
  chunk = (chunk + depth - 1) / depth * depth;
  const int used = (q_total + chunk - 1) / chunk;
  void* target = used > 1 || bf16 ? static_cast<void*>(scratch) : dw;
  const Args q{a, x, nullptr, target, 0, 0.f, used, chunk, prec, bf16};
  int err = tc ? dispatch_dw(ga, q, st)
               : dispatch<kDw>(g, cout / groups, (cin / groups) * k, groups * used,
                               Args{gy, x, nullptr, target, 0, 0.f, used, chunk, prec, bf16},
                               st);
  if (err != 0 || target == dw) return err;
  const int threads = 256;
  size_t blocks = (count + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;
  sum_splits_kernel<<<static_cast<unsigned>(blocks), threads, 0, st>>>(scratch, dw, count,
                                                                      used, bf16);
  return static_cast<int>(cudaGetLastError());
}
