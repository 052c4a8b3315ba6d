// train_fused: the fused training chain of EMGNet's dense stack, one
// kernel per dense block each way, with the dropout masks drawn in the
// kernels and never stored.
//
// Replaces: the JAX package's ops/train_fused.py::_fwd_block_call (K5f,
//   train_fused.py:362; body _fwd_block_kernel :183), ::_bwd_block_call
//   (K5b, :412; body _bwd_block_kernel :239) and ::extract_prng_masks (K5m,
//   :777; body _mask_kernel :771 over _draw_mask :146), tied together by the
//   custom VJP _chain (:526-666).
//
// What they compute, for block i with input x (N, K), weights W (K, F):
//   K5f: h = dropout(a_in x + c_in) (the previous block's BatchNorm affine
//        and its dropout, applied on load); r = relu(h W + b); the column
//        sums of r and r^2, finished into the BatchNorm statistics of r:
//        stats (5, F) = mean, var = max(0, E[r^2] - mean^2), rstd =
//        1/sqrt(var + eps), a = gamma rstd, c = beta - mean a.
//   K5b: dy = a (dz - S1/N - xhat S2/N) [r > 0] with xhat = (r - mean) rstd
//        and (S1, S2) = (sum dz, sum dz xhat); h recomputed as in K5f;
//        dx = dropout^T(dy W^T); dW = h^T dy; db = sum dy; and, for the
//        block below, the same two sums of dx against its own xhat.
//   K5m: the {0,1} f32 dropout mask of one block.
//
// What bounds them on an H100: at the train step's N = 328 rows and K = F
// = 512, K5f does 0.17 GFLOP on 2.4 MB (2.6 us at the 67 TFLOP/s f32 SIMT
// peak against 0.7 us of bytes) and K5b twice the FLOP: operations. At
// this size the launch and the dependent k-loop dominate, far above both.
//
// Design. The TPU summed the statistics, dW and db across a sequential grid
// of row tiles in VMEM. Blocks here run in parallel in no order, so:
//  * every GEMM is a plain SIMT tile of 32 x 64 outputs, 16-deep k-steps
//    staged through shared memory, 128 threads with a 4 x 4 micro-tile each;
//    each output is one thread's sequential fmaf chain over k;
//  * column sums over rows (K5f's sum r, sum r^2; K5b's two sums for the
//    block below) are written as one partial per row tile; the last row
//    tile of a column strip to finish (an integer ticket after a
//    __threadfence, as contrastive_loss.cu does) adds them in row-tile order
//    and finishes the statistics, so the small glue the JAX package left to
//    XLA costs no launches. No float atomics: a rerun gives the same bits.
//    The ticket counters are reset by that last tile, so one zeroed buffer
//    serves every launch on the stream;
//  * K5b is one launch with two roles of block: dgrad tiles (N x K outputs,
//    contraction over F) and wgrad tiles (K x F outputs, contraction over
//    the N rows, looped inside the block); the wgrad tiles of the first K
//    strip also sum db. dy is recomputed on load by both roles;
//  * dropout bits come from a counter-based Philox4x32-10: key = the step's
//    two seed words, counter = (column / 4, row, dropped block, 0), one call
//    giving the bits of four neighbouring columns. A mask is a function of
//    (seed words, block, row, column) only, never of the launch geometry,
//    so the backward redraws the forward's bits and K5m replays them. An
//    element is kept iff its 32 bits are <= the keep threshold, computed
//    here from keep exactly as the plain version's keep_threshold does. The
//    coordinate is the index of the block whose output is dropped (i - 1
//    for block i's input).
//  * the seed words and keep are read from device memory, so a step never
//    waits for the host.
//  * the elementwise parts use the _rn intrinsics, so nothing is contracted
//    into an fma: h and dy are exactly the plain version's.
//
// Layouts: x, r, dz, dx (N, K or F) f32 row-major; W and dW (K, F) with
// element strides (wsk, wsn), so the transpose of a Linear weight is taken
// without a copy; stats (5, F) rows mean, var, rstd, a, c; sums (2, F) rows
// sum dz, sum dz xhat; partial (row tiles, 2, width) scratch; tickets one
// uint32 per column strip, 0 at launch.
#include <cuda_runtime.h>
#include <curand_philox4x32_x.h>

namespace {

constexpr int kBM = 32, kBN = 64, kBK = 16, kThreads = 128;
constexpr unsigned kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
constexpr unsigned kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
constexpr float kKeepClip = 0.99999994f;  // the largest f32 below 1

__device__ __forceinline__ uint4 philox_round(uint4 c, uint2 k) {
  const unsigned hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
  const unsigned hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
  return make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
}

__device__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    c = philox_round(c, k);
    k.x += kW0;
    k.y += kW1;
  }
  return philox_round(c, k);
}

// the bits of columns 4*col4 .. 4*col4+3 of `row` in block `block`'s mask
__device__ __forceinline__ uint4 mask_bits(const int* seed, int block, int row,
                                           int col4) {
  return philox4x32_10(
      make_uint4((unsigned)col4, (unsigned)row, (unsigned)block, 0u),
      make_uint2((unsigned)seed[0], (unsigned)seed[1]));
}

__device__ __forceinline__ unsigned word(uint4 v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

__device__ __forceinline__ unsigned keep_threshold(float keep) {
  if (keep >= 1.0f) return 0xFFFFFFFFu;  // rate 0 keeps everything
  return (unsigned)__fmul_rn(fminf(fmaxf(keep, 0.0f), kKeepClip),
                             4294967296.0f);
}

// Dropout on a block's input: none (keep null), drawn (seed), or given
// (mask (N, K), kept where > 0).
struct Dropout {
  const int* seed;
  const float* keep;
  const float* mask;
  int block;
};

struct Keep {
  float value;
  unsigned threshold;
};

__device__ __forceinline__ Keep read_keep(const Dropout& d) {
  const float v = d.keep ? *d.keep : 1.0f;
  return {v, keep_threshold(v)};
}

// h = dropout(a x + c) at x[n, k0 .. k0+3] (k0 a multiple of 4); 0 past
// the edges.
__device__ __forceinline__ void load_input4(const float* __restrict__ x,
                                            int N, int K, int n, int k0,
                                            const float* a, const float* c,
                                            const Dropout& d, Keep kp,
                                            float out[4]) {
  uint4 bits = make_uint4(0u, 0u, 0u, 0u);
  if (d.keep && !d.mask && n < N) bits = mask_bits(d.seed, d.block, n, k0 >> 2);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = k0 + j;
    if (n >= N || k >= K) {
      out[j] = 0.0f;
      continue;
    }
    const size_t i = (size_t)n * K + k;
    float z = x[i];
    if (a) z = __fadd_rn(__fmul_rn(z, a[k]), c[k]);
    if (d.keep) {
      const bool kept =
          d.mask ? d.mask[i] > 0.0f : word(bits, j) <= kp.threshold;
      z = kept ? __fdiv_rn(z, kp.value) : 0.0f;
    }
    out[j] = z;
  }
}

// acc[i][j] += sum_kk As[kk][ty*4+i] * Bs[kk][tx*4+j], in kk order
__device__ __forceinline__ void mma_tile(const float (&As)[kBK][kBM],
                                         const float (&Bs)[kBK][kBN],
                                         float (&acc)[4][4], int tx, int ty) {
#pragma unroll
  for (int kk = 0; kk < kBK; ++kk) {
    const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
    const float4 wv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
    const float ar[4] = {av.x, av.y, av.z, av.w};
    const float wr[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], wr[j], acc[i][j]);
  }
}

// Column sums of the two staged tiles into this row tile's partials, then
// the ticket: returns true in the last row tile of the strip to finish.
// Threads [0, 64) sum S[0], [64, 128) S[1], rows in order.
__device__ bool tile_partials(const float (&S)[2][kBM][kBN + 1],
                              float* __restrict__ partial,
                              unsigned* __restrict__ ticket, int row_tile,
                              int n_row_tiles, int col0, int width) {
  __shared__ bool last;
  const int n = threadIdx.x % kBN, which = threadIdx.x / kBN;
  float s = 0.0f;
  for (int m = 0; m < kBM; ++m) s = __fadd_rn(s, S[which][m][n]);
  if (col0 + n < width)
    partial[((size_t)row_tile * 2 + which) * width + col0 + n] = s;
  __threadfence();  // the partials reach device memory before the ticket
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(ticket, 1u) == (unsigned)(n_row_tiles - 1);
  __syncthreads();
  return last;
}

// In the last row tile: the strip's two column sums, over row tiles in
// order, for the calling thread's column (threadIdx.x < kBN).
__device__ __forceinline__ float2 strip_sums(const float* __restrict__ partial,
                                             int n_row_tiles, int col,
                                             int width) {
  float s1 = 0.0f, s2 = 0.0f;
  for (int t = 0; t < n_row_tiles; ++t) {
    s1 = __fadd_rn(s1, __ldcg(&partial[((size_t)t * 2) * width + col]));
    s2 = __fadd_rn(s2, __ldcg(&partial[((size_t)t * 2 + 1) * width + col]));
  }
  return make_float2(s1, s2);
}

__global__ void __launch_bounds__(kThreads) dense_block_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ b, const float* __restrict__ gamma,
    const float* __restrict__ beta, const float* __restrict__ in_stats,
    Dropout d, float* __restrict__ r, float* __restrict__ partial,
    unsigned* __restrict__ tickets, float* __restrict__ stats, int N, int K,
    int F, int wsk, int wsn, float eps) {
  __shared__ __align__(16) float As[kBK][kBM];
  __shared__ __align__(16) float Bs[kBK][kBN];
  __shared__ float S[2][kBM][kBN + 1];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.x * kBM, col0 = blockIdx.y * kBN;
  const float* a_in = in_stats ? in_stats + 3 * K : nullptr;
  const float* c_in = in_stats ? in_stats + 4 * K : nullptr;
  const Keep kp = read_keep(d);
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += kBK) {
    {
      const int m = tid / 4, kq = (tid % 4) * 4;
      float h[4];
      load_input4(x, N, K, row0 + m, k0 + kq, a_in, c_in, d, kp, h);
#pragma unroll
      for (int j = 0; j < 4; ++j) As[kq + j][m] = h[j];
    }
#pragma unroll
    for (int i = 0; i < kBK * kBN / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int kk = idx / kBN, n = idx % kBN;
      const int gk = k0 + kk, gn = col0 + n;
      Bs[kk][n] = (gk < K && gn < F)
                      ? w[(size_t)gk * wsk + (size_t)gn * wsn]
                      : 0.0f;
    }
    __syncthreads();
    mma_tile(As, Bs, acc, tx, ty);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = ty * 4 + i, gm = row0 + m;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = tx * 4 + j, gn = col0 + n;
      float v = 0.0f;
      if (gm < N && gn < F) {
        v = fmaxf(__fadd_rn(acc[i][j], b[gn]), 0.0f);
        r[(size_t)gm * F + gn] = v;
      }
      S[0][m][n] = v;
      S[1][m][n] = __fmul_rn(v, v);
    }
  }
  __syncthreads();
  if (!tile_partials(S, partial, &tickets[blockIdx.y], blockIdx.x, gridDim.x,
                     col0, F))
    return;
  const int gn = col0 + tid;
  if (tid < kBN && gn < F) {
    const float2 s = strip_sums(partial, gridDim.x, gn, F);
    const float nf = (float)N;
    const float mean = __fdiv_rn(s.x, nf);
    const float var =
        fmaxf(0.0f, __fsub_rn(__fdiv_rn(s.y, nf), __fmul_rn(mean, mean)));
    const float rstd = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
    const float a = __fmul_rn(gamma[gn], rstd);
    stats[gn] = mean;
    stats[F + gn] = var;
    stats[2 * F + gn] = rstd;
    stats[3 * F + gn] = a;
    stats[4 * F + gn] = __fsub_rn(beta[gn], __fmul_rn(mean, a));
  }
  if (tid == 0) tickets[blockIdx.y] = 0u;  // ready for the next launch
}

// dy at (n, f): the BatchNorm backward finished, times the ReLU's mask
__device__ __forceinline__ float dy_value(const float* __restrict__ dz,
                                          const float* __restrict__ r,
                                          const float* __restrict__ stats,
                                          const float* __restrict__ sums,
                                          int N, int F, int n, int f,
                                          float inv_n) {
  if (n >= N || f >= F) return 0.0f;
  const size_t i = (size_t)n * F + f;
  const float rv = r[i];
  const float xn = __fmul_rn(__fsub_rn(rv, stats[f]), stats[2 * F + f]);
  float t = __fsub_rn(dz[i], __fmul_rn(sums[f], inv_n));
  t = __fsub_rn(t, __fmul_rn(xn, __fmul_rn(sums[F + f], inv_n)));
  return rv > 0.0f ? __fmul_rn(stats[3 * F + f], t) : 0.0f;
}

__global__ void __launch_bounds__(kThreads) dense_block_bwd_kernel(
    const float* __restrict__ dz, const float* __restrict__ r,
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ stats, const float* __restrict__ sums,
    const float* __restrict__ in_stats, Dropout d, float* __restrict__ dx,
    float* __restrict__ dw, float* __restrict__ db,
    float* __restrict__ out_sums, float* __restrict__ partial,
    unsigned* __restrict__ tickets, int N, int K, int F, int wsk, int wsn,
    int n_dgrad_blocks) {
  __shared__ __align__(16) float As[kBK][kBM];
  __shared__ __align__(16) float Bs[kBK][kBN];
  __shared__ float S[2][kBM][kBN + 1];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float inv_n = __fdiv_rn(1.0f, (float)N);
  const Keep kp = read_keep(d);
  float acc[4][4] = {};

  if ((int)blockIdx.x < n_dgrad_blocks) {
    // ---- dgrad: dx tile (rows n, columns k), contraction over f
    const int n_row_tiles = (N + kBM - 1) / kBM;
    const int rt = blockIdx.x % n_row_tiles, kt = blockIdx.x / n_row_tiles;
    const int row0 = rt * kBM, col0 = kt * kBN;
    for (int f0 = 0; f0 < F; f0 += kBK) {
      {
        const int m = tid / 4, fq = (tid % 4) * 4;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          As[fq + j][m] =
              dy_value(dz, r, stats, sums, N, F, row0 + m, f0 + fq + j, inv_n);
      }
#pragma unroll
      for (int i = 0; i < kBK * kBN / kThreads; ++i) {
        const int idx = tid + i * kThreads;
        const int fl = idx / kBN, kl = idx % kBN;
        const int gf = f0 + fl, gk = col0 + kl;
        Bs[fl][kl] = (gk < K && gf < F)
                         ? w[(size_t)gk * wsk + (size_t)gf * wsn]
                         : 0.0f;
      }
      __syncthreads();
      mma_tile(As, Bs, acc, tx, ty);
      __syncthreads();
    }
    const float* mean_in = in_stats;
    const float* rstd_in = in_stats ? in_stats + 2 * K : nullptr;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = ty * 4 + i, gm = row0 + m;
      const int kq = col0 + tx * 4;
      uint4 bits = make_uint4(0u, 0u, 0u, 0u);
      if (d.keep && !d.mask && gm < N)
        bits = mask_bits(d.seed, d.block, gm, kq >> 2);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gk = kq + j;
        float v = 0.0f, vx = 0.0f;
        if (gm < N && gk < K) {
          const size_t e = (size_t)gm * K + gk;
          v = acc[i][j];
          if (d.keep) {
            const bool kept =
                d.mask ? d.mask[e] > 0.0f : word(bits, j) <= kp.threshold;
            v = kept ? __fdiv_rn(v, kp.value) : 0.0f;
          }
          dx[e] = v;
          if (out_sums)
            vx = __fmul_rn(
                v, __fmul_rn(__fsub_rn(x[e], mean_in[gk]), rstd_in[gk]));
        }
        S[0][m][tx * 4 + j] = v;
        S[1][m][tx * 4 + j] = vx;
      }
    }
    if (!out_sums) return;
    __syncthreads();
    if (!tile_partials(S, partial, &tickets[kt], rt, n_row_tiles, col0, K))
      return;
    const int gk = col0 + tid;
    if (tid < kBN && gk < K) {
      const float2 s = strip_sums(partial, n_row_tiles, gk, K);
      out_sums[gk] = s.x;
      out_sums[K + gk] = s.y;
    }
    if (tid == 0) tickets[kt] = 0u;
    return;
  }

  // ---- wgrad: dW tile (rows k, columns f), contraction over the N rows;
  // the tiles of the first k strip also sum db
  const int n_k_tiles = (K + kBM - 1) / kBM;
  const int wid = blockIdx.x - n_dgrad_blocks;
  const int ktw = wid % n_k_tiles, ft = wid / n_k_tiles;
  const int row0 = ktw * kBM, col0 = ft * kBN;
  const float* a_in = in_stats ? in_stats + 3 * K : nullptr;
  const float* c_in = in_stats ? in_stats + 4 * K : nullptr;
  float db_acc = 0.0f;
  for (int n0 = 0; n0 < N; n0 += kBK) {
    {
      const int nl = tid / 8, kq = (tid % 8) * 4;
      float h[4];
      load_input4(x, N, K, n0 + nl, row0 + kq, a_in, c_in, d, kp, h);
#pragma unroll
      for (int j = 0; j < 4; ++j) As[nl][kq + j] = h[j];
    }
#pragma unroll
    for (int i = 0; i < kBK * kBN / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int nl = idx / kBN, fl = idx % kBN;
      Bs[nl][fl] = dy_value(dz, r, stats, sums, N, F, n0 + nl, col0 + fl, inv_n);
    }
    __syncthreads();
    if (ktw == 0 && tid < kBN)
      for (int nl = 0; nl < kBK; ++nl) db_acc = __fadd_rn(db_acc, Bs[nl][tid]);
    mma_tile(As, Bs, acc, tx, ty);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gk = row0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gf = col0 + tx * 4 + j;
      if (gk < K && gf < F) dw[(size_t)gk * wsk + (size_t)gf * wsn] = acc[i][j];
    }
  }
  if (ktw == 0 && tid < kBN && col0 + tid < F) db[col0 + tid] = db_acc;
}

__global__ void dropout_masks_kernel(const int* __restrict__ seed,
                                     const float* __restrict__ keep,
                                     float* __restrict__ out, int N, int F,
                                     int block) {
  const int groups = (F + 3) / 4;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)N * groups) return;
  const int n = (int)(i / groups), g = (int)(i % groups);
  const unsigned thr = keep_threshold(*keep);
  const uint4 bits = mask_bits(seed, block, n, g);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int f = g * 4 + j;
    if (f < F) out[(size_t)n * F + f] = word(bits, j) <= thr ? 1.0f : 0.0f;
  }
}

// The kernels' Philox4x32-10 beside the CUDA toolkit's, on the same
// counters and keys: a check of the generator, on no path of the step.
__global__ void philox_check_kernel(const unsigned* __restrict__ ctr,
                                    const unsigned* __restrict__ key,
                                    unsigned* __restrict__ ours,
                                    unsigned* __restrict__ theirs, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint4 c = make_uint4(ctr[4 * i], ctr[4 * i + 1], ctr[4 * i + 2],
                             ctr[4 * i + 3]);
  const uint2 k = make_uint2(key[2 * i], key[2 * i + 1]);
  const uint4 a = philox4x32_10(c, k);
  const uint4 b = curand_Philox4x32_10(c, k);
  ours[4 * i] = a.x;
  ours[4 * i + 1] = a.y;
  ours[4 * i + 2] = a.z;
  ours[4 * i + 3] = a.w;
  theirs[4 * i] = b.x;
  theirs[4 * i + 1] = b.y;
  theirs[4 * i + 2] = b.z;
  theirs[4 * i + 3] = b.w;
}

bool bad_dropout(const int* seed, const float* keep, const float* mask) {
  return keep != nullptr && seed == nullptr && mask == nullptr;
}

}  // namespace

extern "C" int dense_block_fwd_launch(
    const float* x, const float* w, const float* b, const float* gamma,
    const float* beta, const float* in_stats, const int* seed,
    const float* keep, const float* mask, float* r, float* partial,
    unsigned* tickets, float* stats, int N, int K, int F, int wsk, int wsn,
    int drop_block, float eps, void* stream) {
  if (N < 1 || K < 1 || F < 1 || bad_dropout(seed, keep, mask))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kBM - 1) / kBM, (F + kBN - 1) / kBN);
  dense_block_fwd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x, w, b, gamma, beta, in_stats, Dropout{seed, keep, mask, drop_block},
      r, partial, tickets, stats, N, K, F, wsk, wsn, eps);
  return (int)cudaGetLastError();
}

extern "C" int dense_block_bwd_launch(
    const float* dz, const float* r, const float* x, const float* w,
    const float* stats, const float* sums, const float* in_stats,
    const int* seed, const float* keep, const float* mask, float* dx,
    float* dw, float* db, float* out_sums, float* partial, unsigned* tickets,
    int N, int K, int F, int wsk, int wsn, int drop_block, void* stream) {
  if (N < 1 || K < 1 || F < 1 || bad_dropout(seed, keep, mask) ||
      (in_stats == nullptr) != (out_sums == nullptr))
    return (int)cudaErrorInvalidValue;
  const int n_dgrad = ((N + kBM - 1) / kBM) * ((K + kBN - 1) / kBN);
  const int n_wgrad = ((K + kBM - 1) / kBM) * ((F + kBN - 1) / kBN);
  dense_block_bwd_kernel<<<n_dgrad + n_wgrad, kThreads, 0,
                           (cudaStream_t)stream>>>(
      dz, r, x, w, stats, sums, in_stats, Dropout{seed, keep, mask, drop_block},
      dx, dw, db, out_sums, partial, tickets, N, K, F, wsk, wsn, n_dgrad);
  return (int)cudaGetLastError();
}

extern "C" int dropout_masks_launch(const int* seed, const float* keep,
                                    float* out, int N, int F, int block,
                                    void* stream) {
  if (N < 1 || F < 1) return (int)cudaErrorInvalidValue;
  const long long threads = (long long)N * ((F + 3) / 4);
  const int per_block = 256;
  dropout_masks_kernel<<<(unsigned)((threads + per_block - 1) / per_block),
                         per_block, 0, (cudaStream_t)stream>>>(seed, keep, out,
                                                               N, F, block);
  return (int)cudaGetLastError();
}

extern "C" int philox_check_launch(const unsigned* ctr, const unsigned* key,
                                   unsigned* ours, unsigned* theirs, int n,
                                   void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  philox_check_kernel<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      ctr, key, ours, theirs, n);
  return (int)cudaGetLastError();
}
