// encoder_chain: the folded EMGNet inference chain of the serve path.
//
// Replaces: the JAX package's ops/pallas_ops.py::_enc_kernel
//   (fused_encoder_logits, pallas_ops.py:460-508) and the matmul chain
//   inside ::_tick_chain_kernel (pallas_ops.py:588-593) and
//   ::_batched_tick_chain_kernel (pallas_ops.py:801-808).
//
// Two kernels, launched 9 + 1 times per chain at full width:
//   encoder_layer: out = relu(h @ W + b), then, for the batched engine,
//     out = out * a[s] + c[s] with s the row's session (the per-session
//     BatchNorm affine of pallas_ops.py:805);
//   encoder_head: e = h @ Wh + bh; e /= ||e|| (no eps); scores = e @ Gt.
//
// What bounds it on an H100: at the batched replay's shapes (25 ticks x
// 32,768 sessions = 819,200 rows) the operations, 2 x 2,573,968 f32 FLOP
// per row against the 67 TFLOP/s f32 SIMT peak; the 10.3 MB of weights
// are re-read from L2 by every row tile. At one row (the per-tick step)
// it is the k-loop's serial latency: only N/64 = 8 or 12 CTAs run, each
// walking 32-48 dependent k-steps of global loads and __syncthreads.
// chip_smoke.py's profiler trace of the step reads about 0.41 ms of
// device time per 10-launch chain on an H100, most of the step's time;
// a split-K or GEMV layout for small M is later work.
//
// Design: the TPU kept the whole ~10 MB chain resident in VMEM across a
// sequential grid. An SM has at most 227 KB of shared memory, so here each
// layer is its own launch and the weights stream through L2 (50 MB holds
// them all). The layer kernel is a plain tiled SIMT GEMM: 64x64 output
// tiles, 16-deep k-steps staged through shared memory, 256 threads each
// owning a 4x4 micro-tile. Each output element is one thread's sequential
// fmaf chain over k = 0..K-1, so a row's result does not depend on which
// tile it falls in or on how many rows the call has: a one-tick `step`
// and a K-tick `steps` give identical scores. Rows are ordered (tick,
// session), so the session of row r is r % S and a row tile reads 64
// consecutive sessions' affines. The banded conv fold's zero blocks are
// multiplied like any other weights; skipping them is later work.
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 16, kThreads = 256;

__global__ void __launch_bounds__(kThreads) encoder_layer_kernel(
    const float* __restrict__ h, const float* __restrict__ w,
    const float* __restrict__ b, const float* __restrict__ a,
    const float* __restrict__ c, float* __restrict__ out, int M, int K,
    int N, int S) {
  __shared__ __align__(16) float As[kBK][kBM];  // A tile, transposed
  __shared__ __align__(16) float Ws[kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long row0 = (long long)blockIdx.x * kBM;
  const int col0 = blockIdx.y * kBN;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < (kBM * kBK) / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int m = idx / kBK, kk = idx % kBK;
      const long long gm = row0 + m;
      const int gk = k0 + kk;
      As[kk][m] = (gm < M && gk < K) ? h[gm * K + gk] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < (kBK * kBN) / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int kk = idx / kBN, n = idx % kBN;
      const int gk = k0 + kk, gn = col0 + n;
      Ws[kk][n] = (gk < K && gn < N) ? w[(long long)gk * N + gn] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 wv = *reinterpret_cast<const float4*>(&Ws[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float wr[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], wr[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long r = row0 + ty * 4 + i;
    if (r >= M) continue;
    const long long s = a ? r % S : 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = col0 + tx * 4 + j;
      if (n >= N) continue;
      float v = fmaxf(__fadd_rn(acc[i][j], b[n]), 0.0f);
      if (a) v = __fadd_rn(__fmul_rn(v, a[s * N + n]), c[s * N + n]);
      out[r * N + n] = v;
    }
  }
}

constexpr int kMaxE = 32;  // embedding width held per lane

__global__ void encoder_head_kernel(
    const float* __restrict__ h, const float* __restrict__ wh,
    const float* __restrict__ bh, const float* __restrict__ gt,
    float* __restrict__ out, int M, int K, int E, int C) {
  // Wh transposed to (E, K), so the lanes' consecutive k hit consecutive
  // banks | Gt (E, C)
  extern __shared__ float smem[];
  float* wht_s = smem;
  float* gt_s = smem + K * E;
  for (int i = threadIdx.x; i < K * E; i += blockDim.x)
    wht_s[(i % E) * K + i / E] = wh[i];
  for (int i = threadIdx.x; i < E * C; i += blockDim.x) gt_s[i] = gt[i];
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;
  for (long long r = (long long)blockIdx.x * warps + threadIdx.x / 32; r < M;
       r += (long long)gridDim.x * warps) {
    float e[kMaxE];
#pragma unroll
    for (int j = 0; j < kMaxE; ++j) e[j] = 0.0f;
    for (int k = lane; k < K; k += 32) {
      const float x = h[r * K + k];
#pragma unroll
      for (int j = 0; j < kMaxE; ++j)
        if (j < E) e[j] = fmaf(x, wht_s[j * K + k], e[j]);
    }
    float sq = 0.0f;
#pragma unroll
    for (int j = 0; j < kMaxE; ++j) {
      if (j < E) {
        for (int off = 16; off > 0; off >>= 1)
          e[j] += __shfl_xor_sync(0xffffffffu, e[j], off);
        e[j] += bh[j];
        sq = fmaf(e[j], e[j], sq);
      }
    }
    const float norm = sqrtf(sq);
    for (int cls = lane; cls < C; cls += 32) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < kMaxE; ++j)
        if (j < E) acc = fmaf(e[j] / norm, gt_s[j * C + cls], acc);
      out[r * C + cls] = acc;
    }
  }
}

}  // namespace

extern "C" int encoder_layer_launch(const float* h, const float* w,
                                    const float* b, const float* a,
                                    const float* c, float* out, int M, int K,
                                    int N, int S, void* stream) {
  if ((a == nullptr) != (c == nullptr) || (a && S < 1))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  if (M > 0 && N > 0)
    encoder_layer_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        h, w, b, a, c, out, M, K, N, S);
  return (int)cudaGetLastError();
}

extern "C" int encoder_head_launch(const float* h, const float* wh,
                                   const float* bh, const float* gt,
                                   float* out, int M, int K, int E, int C,
                                   void* stream) {
  if (E > kMaxE) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)K * E + (size_t)E * C);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        encoder_head_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = 256, rows_per_block = threads / 32;
  long long blocks = ((long long)M + rows_per_block - 1) / rows_per_block;
  if (blocks > 132 * 8) blocks = 132 * 8;  // grid-stride over the rest
  if (blocks > 0)
    encoder_head_kernel<<<(unsigned)blocks, threads, smem,
                          (cudaStream_t)stream>>>(h, wh, bh, gt, out, M, K,
                                                  E, C);
  return (int)cudaGetLastError();
}
