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
// What the design does about it: each of the three is one implicit GEMM per
// group, tiled for the CUDA cores in fp32 (no tensor cores yet). A block owns a
// BM x BN tile of the GEMM's output: rows are output channels (forward, dw) or
// input channels (dx); columns are (item, time) flattened (forward, dx), so
// short sequences still fill a tile, or (channel, tap) pairs (dw). The
// reduction runs in chunks of 16 through shared memory: the weight (or
// cotangent) tile, and the input tile gathered straight from the unpadded NCT
// tensor with the conv's index map (zero padding by masking, no im2col copy).
// The next chunk is loaded into registers while this one's FMAs run, then
// stored to the second of two shared buffers (one barrier per chunk). Each
// thread keeps a TM x TN register tile, so one shared load feeds TN (or TM)
// FMAs; columns are interleaved across threads so that shared reads of the
// gathered tile and the global stores are contiguous across a warp. Bias and
// leaky_relu run in the epilogue. The tile shape follows the rows per group
// and the number of blocks (see dispatch).
//
// dx gathers, one output element per register-tile entry, with no float
// atomics: blockIdx.z walks (group, stride phase). For outputs u = phase + s j
// the taps m that reach an integer t satisfy d m = u + p (mod s), a single
// residue class m0 + ms i (ms = s / gcd(s, d)), so the reduction runs over
// (co, i) with t = j + base - i d / gcd(s, d): taps that do not divide the
// stride are never visited and the inner loop has no branch on them
// (K = 41 at stride 4: 10 or 11 taps per phase).
//
// dw is deterministic: the (item, time) reduction is cut into `splits` fixed
// chunks; each block writes its partial tile to scratch, and a second pass of
// the same entry point sums the chunks in a fixed order. No float atomics, so a
// rerun is bit-identical.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 16;  // reduction chunk through shared memory

enum Mode { kFwd = 0, kDx = 1, kDw = 2 };

struct Geom {
  int n, cin, t_in, cout, t_out, k, stride, pad, dil, groups;
};

__device__ __forceinline__ int gcd_int(int a, int b) {
  while (b) {
    const int r = a % b;
    a = b;
    b = r;
  }
  return a;
}

__device__ __forceinline__ int mod_pos(int a, int m) { return ((a % m) + m) % m; }

// The taps of one stride phase of dx: outputs u = rho + stride * j,
// j < j_count, read taps m = m0 + ms * i, i < n_taps, at cotangent time
// t = j + base - i * dstep.
struct DxPhase {
  int m0, ms, n_taps, base, dstep, j_count;
};

__device__ DxPhase dx_phase(const Geom& g, int rho) {
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
// long); slice 0 adds the slices' sums in slice order.
template <int MODE, int BM, int BN, int TM, int TN, int NT, int KS>
__global__ void __launch_bounds__(NT)
    conv_gemm_kernel(Geom g, const float* __restrict__ a_src,
                     const float* __restrict__ b_src,
                     const float* __restrict__ bias, float* __restrict__ out,
                     int has_slope, float slope, int splits, int chunk) {
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
  const float* col_ptr = b_src;  // kFwd: x row block; kDx: gy row block
  int col_pos = 0;               // kFwd: t s - p; kDx: j + base; kDw: d m - p
  size_t col_off = 0;            // kDw: ci * t_in
  if (c_ok) {
    if (MODE == kFwd) {
      const int n_ = c / g.t_out, t = c - n_ * g.t_out;
      col_ptr = b_src + (static_cast<size_t>(n_) * g.cin + grp * cg) * g.t_in;
      col_pos = t * g.stride - g.pad;
    } else if (MODE == kDx) {
      const int n_ = c / ph.j_count, j = c - n_ * ph.j_count;
      col_ptr = b_src + (static_cast<size_t>(n_) * g.cout + grp * cog) * g.t_out;
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
  auto fetch = [&](int r0) {
    {  // A tile entries (a_kk, a_row0 + (NS / kBK) j)
      const int r = r0 + a_kk;
      const bool r_ok = r < r_end;
      const float* a_ptr = a_src;
      size_t a_stride = 0;  // address step from one row to the next
      if (r_ok) {
        if (MODE == kFwd) {
          a_ptr = a_src + static_cast<size_t>(grp * cog) * cg * g.k + r;
          a_stride = static_cast<size_t>(cg) * g.k;
        } else if (MODE == kDx) {
          const int co = r / ph.n_taps, i = r - co * ph.n_taps;
          a_ptr = a_src + static_cast<size_t>(grp * cog + co) * cg * g.k +
                  ph.m0 + ph.ms * i;
          a_stride = g.k;
        } else {
          const int n_ = r / g.t_out, t = r - n_ * g.t_out;
          a_ptr = a_src + (static_cast<size_t>(n_) * g.cout + grp * cog) * g.t_out + t;
          a_stride = g.t_out;
        }
      }
#pragma unroll
      for (int j = 0; j < kAPasses; ++j) {
        const int gr = m_base + a_row0 + j * (NS / kBK);
        a_reg[j] = (r_ok && gr < rows) ? __ldg(a_ptr + gr * a_stride) : 0.f;
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
              v = __ldg(col_ptr + static_cast<size_t>(hi) * g.t_in + pos);
          } else if (MODE == kDx) {  // hi = co, lo = i
            const int t = col_pos - lo * ph.dstep;
            if (t >= 0 && t < g.t_out)
              v = __ldg(col_ptr + static_cast<size_t>(hi) * g.t_out + t);
          } else {  // hi = n, lo = t
            const int pos = lo * g.stride + col_pos;
            if (pos >= 0 && pos < g.t_in)
              v = __ldg(b_src + static_cast<size_t>(hi) * g.cin * g.t_in +
                        col_off + pos);
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
      out[base + row * row_step] = v;
    }
  }
}

// dw[e] = sum over the splits of part[split, e], in split order.
__global__ void sum_splits_kernel(const float* __restrict__ part,
                                  float* __restrict__ dw, size_t count,
                                  int splits) {
  for (size_t e = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       e < count; e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int sp = 0; sp < splits; ++sp) s += part[sp * count + e];
    dw[e] = s;
  }
}

template <int MODE, int BM, int BN, int TM, int TN, int NT, int KS>
int launch(const Geom& g, int rows, int ncols, int grid_z, const float* a,
           const float* b, const float* bias, float* out, int has_slope,
           float slope, int splits, int chunk, cudaStream_t stream) {
  const dim3 grid((ncols + BN - 1) / BN, (rows + BM - 1) / BM, grid_z);
  if (grid.y > 65535u || grid.z > 65535u)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  conv_gemm_kernel<MODE, BM, BN, TM, TN, NT, KS><<<grid, NT, 0, stream>>>(
      g, a, b, bias, out, has_slope, slope, splits, chunk);
  return static_cast<int>(cudaGetLastError());
}

// The tile follows the GEMM's row count (channels per group): wide rows take
// 128-row tiles, narrow ones trade rows for columns so that few rows waste
// little. For the forward and dx a 128 x 128 tile does twice a 128 x 64
// tile's work and feeds twice the FMAs from each shared load; counted 1.25x
// faster per FMA, it is taken unless it needs nearly as many waves of blocks
// over the SMs (MSD L5 at scale 1: 136 blocks for 132 SMs take 2 waves, as do
// 264 blocks of 128 x 64 at half the work each); dw takes 128 x 64, its
// reduction split supplies the blocks. One
// row (cg = 1 at dx of the first layers, cout = 1 at conv_post) takes 32
// columns per block and splits the reduction over 8 slices of a warp each:
// conv_post has few columns and a long reduction, which wide tiles would
// leave to a few SMs. Keep in step with ops/cuda/grouped_conv.py::dw_tile.
template <int MODE>
int dispatch(const Geom& g, int rows, int ncols, int grid_z, const float* a,
             const float* b, const float* bias, float* out, int has_slope,
             float slope, int splits, int chunk, cudaStream_t stream) {
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  auto waves = [&](int bm, int bn) {
    const long long blocks = static_cast<long long>((ncols + bn - 1) / bn) *
                             ((rows + bm - 1) / bm) * grid_z;
    return (blocks + sms - 1) / sms;
  };
#define PSTT_LAUNCH(BM, BN, TM, TN, KS)                                       \
  return launch<MODE, BM, BN, TM, TN, kThreads, KS>(                         \
      g, rows, ncols, grid_z, a, b, bias, out, has_slope, slope, splits, chunk, \
      stream)
  if (rows >= 128 && MODE != kDw && 8 * waves(128, 128) <= 5 * waves(128, 64))
    PSTT_LAUNCH(128, 128, 8, 8, 1);
  if (rows >= 128) PSTT_LAUNCH(128, 64, 8, 4, 1);
  if (rows >= 64) PSTT_LAUNCH(64, 64, 4, 4, 1);
  if (rows >= 32) PSTT_LAUNCH(32, 128, 4, 4, 1);
  if (rows >= 16) PSTT_LAUNCH(16, 256, 4, 4, 1);
  if (rows >= 2) PSTT_LAUNCH(8, 256, 2, 4, 1);
  PSTT_LAUNCH(1, 32, 1, 1, 8);
#undef PSTT_LAUNCH
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

}  // namespace

// y (n, cout, t_out) = lrelu(conv1d(x (n, cin, t_in), w (cout, cin / groups,
// k)) + b); b may be null, has_slope 0 skips the leaky_relu. Returns a
// cudaError_t; 0 when launched.
extern "C" int grouped_conv_forward(const float* x, const float* w,
                                    const float* b, float* y, int n, int cin,
                                    int t_in, int cout, int t_out, int k,
                                    int stride, int pad, int dil, int groups,
                                    int has_slope, float slope, void* stream) {
  const Geom g{n, cin, t_in, cout, t_out, k, stride, pad, dil, groups};
  if (!valid_geom(g)) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<kFwd>(g, cout / groups, n * t_out, groups, w, x, b, y,
                        has_slope, slope, 1, 0, static_cast<cudaStream_t>(stream));
}

// dx (n, cin, t_in) of the conv above from its cotangent gy (n, cout, t_out),
// then + b (cin,) and leaky_relu when given: a ConvTranspose1d of gy with
// weight w (cout, cin, k) is this with groups 1 and dilation 1.
extern "C" int grouped_conv_input_grad(const float* gy, const float* w,
                                       const float* b, float* dx, int n,
                                       int cin, int t_in, int cout, int t_out,
                                       int k, int stride, int pad, int dil,
                                       int groups, int has_slope, float slope,
                                       void* stream) {
  const Geom g{n, cin, t_in, cout, t_out, k, stride, pad, dil, groups};
  if (!valid_geom(g)) return static_cast<int>(cudaErrorInvalidValue);
  const int j_max = (t_in + stride - 1) / stride;  // phase 0 has the most
  return dispatch<kDx>(g, cin / groups, n * j_max, groups * stride, w, gy, b,
                       dx, has_slope, slope, 1, 0,
                       static_cast<cudaStream_t>(stream));
}

// dw (cout, cin / groups, k) of the conv above from x and gy. With splits > 1,
// scratch holds splits * cout * (cin / groups) * k floats: the reduction over
// n * t_out is cut into splits chunks whose partial sums a second pass adds in
// a fixed order (deterministic, no atomics).
extern "C" int grouped_conv_weight_grad(const float* x, const float* gy,
                                        float* dw, float* scratch, int n,
                                        int cin, int t_in, int cout, int t_out,
                                        int k, int stride, int pad, int dil,
                                        int groups, int splits, void* stream) {
  const Geom g{n, cin, t_in, cout, t_out, k, stride, pad, dil, groups};
  if (!valid_geom(g) || splits < 1 || (splits > 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int q_total = n * t_out;
  int chunk = (q_total + splits - 1) / splits;
  chunk = (chunk + kBK - 1) / kBK * kBK;
  const int used = (q_total + chunk - 1) / chunk;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* target = used > 1 ? scratch : dw;
  int err = dispatch<kDw>(g, cout / groups, (cin / groups) * k, groups * used,
                          gy, x, nullptr, target, 0, 0.f, used, chunk, st);
  if (err != 0 || used == 1) return err;
  const size_t count = static_cast<size_t>(cout) * (cin / groups) * k;
  const int threads = 256;
  size_t blocks = (count + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;
  sum_splits_kernel<<<static_cast<unsigned>(blocks), threads, 0, st>>>(
      scratch, dw, count, used);
  return static_cast<int>(cudaGetLastError());
}
