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
// far above the card's ~20 FLOP/B fp32 ridge. The (T, T) score matrix never
// reaches device memory.
//
// What the design does about it: the TPU grid's sequential KV axis, with its
// running max / denominator / accumulator in VMEM scratch, becomes a loop
// inside one block. A block owns one (n * h, 64-row query tile) for the
// forward and dQ, or one (n * h, key tile) for dK / dV, and walks the other
// axis tile by tile through shared memory; nothing is carried between blocks,
// so no sum needs atomics and every result is deterministic. The 256 threads
// form a 16 x 16 grid over each score tile: thread (ty, tx) owns rows ty * RM
// + i and columns tx + 16 j, so one shared load of a row entry feeds CN FMAs
// and one of a column entry RM. Tiles are stored with an odd row stride (D + 1
// floats, the padded head width + 1), so a warp reading 16 different rows at
// one column hits 16 banks. The running max and denominator are per row in
// registers, replicated over the 16 threads of a row and reduced with
// shuffles. All arithmetic is fp32 on the CUDA cores (no tensor cores, TMA or
// bf16 yet); the TPU's 128-lane padding of D, its lane-replicated m / l / lse
// buffers and the bf16x3 split are not carried over. Each head width is
// padded to the next of 16 / 32 / 64 / 128 / 192 / 256 in shared memory only;
// at D > 128 the backward kernels take 32-row key tiles so four tiles fit in
// 227 KB of dynamic shared memory (cudaFuncSetAttribute).
//
// Masking: a key with key_valid < 0.5 scores -1e30 (finite, as in JAX), so a
// query whose keys are all masked gets the mean of v over its Tk keys; keys
// past Tk (tile padding) score -inf and never count.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
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

// One block per (n * h, BK-key tile): dK and dV over BQ-row query tiles.
template <int DP, int BK, int BQ>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ key_valid,
                     const float* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ di, float* __restrict__ dk,
                     float* __restrict__ dv, int heads, int tq, int tk, int d,
                     float scale) {
  constexpr int LD = DP + 1, RM = BK / 16, CN = BQ / 16, NJ = DP / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* dOs = Qs + BQ * LD;
  float* Pt = dOs + BQ * LD;       // BK x (BQ + 1): p transposed
  float* dSt = Pt + BK * (BQ + 1);  // BK x (BQ + 1): ds transposed
  float* lse_s = dSt + BK * (BQ + 1);
  float* di_s = lse_s + BQ;

  const int k_tiles = (tk + BK - 1) / BK;
  const int b = blockIdx.x / k_tiles;
  const int k0 = (blockIdx.x - b * k_tiles) * BK;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* valid = key_valid ? key_valid + static_cast<size_t>(b / heads) * tk : nullptr;
  const size_t kbase = (static_cast<size_t>(b) * tk + k0) * d;
  const float* qb = q + static_cast<size_t>(b) * tq * d;
  const float* dob = dout + static_cast<size_t>(b) * tq * d;
  load_tile<BK, DP>(Ks, k + kbase, tk - k0, d);
  load_tile<BK, DP>(Vs, v + kbase, tk - k0, d);
  int cls[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) cls[i] = key_class(k0 + ty * RM + i, tk, valid);

  float dk_acc[RM][NJ], dv_acc[RM][NJ];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int q0 = 0; q0 < tq; q0 += BQ) {
    __syncthreads();  // the last tile's Pt, dSt, Qs and dOs are read
    load_tile<BQ, DP>(Qs, qb + static_cast<size_t>(q0) * d, tq - q0, d);
    load_tile<BQ, DP>(dOs, dob + static_cast<size_t>(q0) * d, tq - q0, d);
    for (int e = threadIdx.x; e < BQ; e += kThreads) {
      const bool in = q0 + e < tq;  // a padded row's p is exp(s - inf) = 0
      lse_s[e] = in ? __ldg(lse + static_cast<size_t>(b) * tq + q0 + e) : INFINITY;
      di_s[e] = in ? __ldg(di + static_cast<size_t>(b) * tq + q0 + e) : 0.f;
    }
    __syncthreads();
    float s[RM][CN], dp[RM][CN];
    dot_tile<RM, CN, DP>(Ks, Qs, ty, tx, s);    // s[key][query]
    dot_tile<RM, CN, DP>(Vs, dOs, ty, tx, dp);  // dp[key][query]
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int qc = tx + 16 * j;
        const float p = expf(masked_score(s[i][j], scale, cls[i]) - lse_s[qc]);
        Pt[(ty * RM + i) * (BQ + 1) + qc] = p;
        dSt[(ty * RM + i) * (BQ + 1) + qc] = p * (dp[i][j] - di_s[qc]) * scale;
      }
    __syncthreads();
    acc_tile<RM, BQ, DP>(Pt, dOs, ty, tx, dv_acc);
    acc_tile<RM, BQ, DP>(dSt, Qs, ty, tx, dk_acc);
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = k0 + ty * RM + i;
    if (row >= tk) continue;
    const size_t off = (static_cast<size_t>(b) * tk + row) * d;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col < d) {
        dk[off + col] = dk_acc[i][j];
        dv[off + col] = dv_acc[i][j];
      }
    }
  }
}

// One block per (n * h, BQ-row query tile): dQ over BK-key tiles.
template <int DP, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ key_valid,
                    const float* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ di, float* __restrict__ dq, int heads,
                    int tq, int tk, int d, float scale) {
  constexpr int LD = DP + 1, RM = BQ / 16, CN = BK / 16, NJ = DP / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* dSs = Vs + BK * LD;  // BQ x (BK + 1)

  const int q_tiles = (tq + BQ - 1) / BQ;
  const int b = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x - b * q_tiles) * BQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* valid = key_valid ? key_valid + static_cast<size_t>(b / heads) * tk : nullptr;
  const size_t qbase = (static_cast<size_t>(b) * tq + q0) * d;
  const float* kb = k + static_cast<size_t>(b) * tk * d;
  const float* vb = v + static_cast<size_t>(b) * tk * d;
  load_tile<BQ, DP>(Qs, q + qbase, tq - q0, d);
  load_tile<BQ, DP>(dOs, dout + qbase, tq - q0, d);
  float lse_r[RM], di_r[RM], dq_acc[RM][NJ];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q0 + ty * RM + i;
    const bool in = row < tq;
    lse_r[i] = in ? __ldg(lse + static_cast<size_t>(b) * tq + row) : INFINITY;
    di_r[i] = in ? __ldg(di + static_cast<size_t>(b) * tq + row) : 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) dq_acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < tk; k0 += BK) {
    __syncthreads();  // the last tile's dSs, Ks and Vs are read
    load_tile<BK, DP>(Ks, kb + static_cast<size_t>(k0) * d, tk - k0, d);
    load_tile<BK, DP>(Vs, vb + static_cast<size_t>(k0) * d, tk - k0, d);
    __syncthreads();
    float s[RM][CN], dp[RM][CN];
    dot_tile<RM, CN, DP>(Qs, Ks, ty, tx, s);
    dot_tile<RM, CN, DP>(dOs, Vs, ty, tx, dp);
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const int cls = key_class(k0 + tx + 16 * j, tk, valid);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float p = expf(masked_score(s[i][j], scale, cls) - lse_r[i]);
        dSs[(ty * RM + i) * (BK + 1) + tx + 16 * j] = p * (dp[i][j] - di_r[i]) * scale;
      }
    }
    __syncthreads();
    acc_tile<RM, BK, DP>(dSs, Ks, ty, tx, dq_acc);
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q0 + ty * RM + i;
    if (row >= tq) continue;
    float* dqrow = dq + (static_cast<size_t>(b) * tq + row) * d;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col < d) dqrow[col] = dq_acc[i][j];
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

// Launch `kernel` on `blocks` blocks with `smem` bytes of dynamic shared
// memory, raising the block's limit past 48 KB first.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, long long blocks, size_t smem, cudaStream_t stream,
           Args... args) {
  if (blocks < 1 || blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

long long tiles(int t, int tile) { return (t + tile - 1) / tile; }

template <int DP>
int forward(const Shape& s, const float* q, const float* k, const float* v,
            const float* key_valid, float* o, float* lse, cudaStream_t st) {
  constexpr int BQ = 64, BK = 64, LD = DP + 1;
  const size_t smem = sizeof(float) * ((BQ + 2 * BK) * LD + BQ * (BK + 1));
  return launch(flash_fwd_kernel<DP, BQ, BK>, s.bh * tiles(s.tq, BQ), smem, st, q, k, v,
                key_valid, o, lse, s.heads, s.tq, s.tk, s.d, s.scale);
}

template <int DP>
int dkv(const Shape& s, const float* q, const float* k, const float* v,
        const float* key_valid, const float* dout, const float* lse, const float* di,
        float* dk, float* dv, cudaStream_t st) {
  constexpr int BK = DP > 128 ? 32 : 64, BQ = 64, LD = DP + 1;
  const size_t smem =
      sizeof(float) * (2 * (BK + BQ) * LD + 2 * BK * (BQ + 1) + 2 * BQ);
  return launch(flash_dkv_kernel<DP, BK, BQ>, s.bh * tiles(s.tk, BK), smem, st, q, k, v,
                key_valid, dout, lse, di, dk, dv, s.heads, s.tq, s.tk, s.d, s.scale);
}

template <int DP>
int dq(const Shape& s, const float* q, const float* k, const float* v,
       const float* key_valid, const float* dout, const float* lse, const float* di,
       float* dqo, cudaStream_t st) {
  constexpr int BQ = 64, BK = DP > 128 ? 32 : 64, LD = DP + 1;
  const size_t smem = sizeof(float) * (2 * (BQ + BK) * LD + BQ * (BK + 1));
  return launch(flash_dq_kernel<DP, BQ, BK>, s.bh * tiles(s.tq, BQ), smem, st, q, k, v,
                key_valid, dout, lse, di, dqo, s.heads, s.tq, s.tk, s.d, s.scale);
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
