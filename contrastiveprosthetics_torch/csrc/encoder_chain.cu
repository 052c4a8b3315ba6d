// encoder_chain: the folded EMGNet inference chain of the serve path.
//
// Replaces: the JAX package's ops/pallas_ops.py::_enc_kernel
//   (fused_encoder_logits, pallas_ops.py:460-508) and the matmul chain
//   inside ::_tick_chain_kernel (pallas_ops.py:588-593) and
//   ::_batched_tick_chain_kernel (pallas_ops.py:801-808).
//
// One host call per chain (encoder_chain_launch) issues 9 + 1 launches at
// full width:
//   a layer kernel per hidden layer: out = relu(h @ W + b), then, for the
//     batched engine, out = out * a[s] + c[s] with s = r % S the row's
//     session (the per-session BatchNorm affine of pallas_ops.py:805);
//   encoder_head_kernel: e = h @ Wh + bh; e /= ||e|| (no eps); e @ Gt, in
//     f32 on the CUDA cores.
//
// A bf16 fold (the JAX package's dtype=bfloat16 folds, pallas_ops.py:318-
// 322) runs the bf16 variant instead, encoder_chain_bf16_launch: the same
// launches, one bf16 MMA pass a product, a bf16 scratch (see "bf16
// variant" below). Everything above this paragraph is the f32 chain's.
//
// Arithmetic: 3xTF32 on the tensor cores (mma.sync m16n8k8 .tf32). Each
// operand splits as x = big + small, big = cvt.rna.tf32(x), small =
// cvt.rna.tf32(x - big). Each k8 chunk sums small*big, big*small and
// big*big, in that order, in the tensor core from zero, and the chunk's sum
// is added to the row's f32 sum with one round-to-nearest add. The dropped
// small*small and small's own rounding leave about 2^-22 of each product.
// The tensor core's own f32 accumulation does not round to nearest: fed
// the running sum 3 x 96 times per 768-wide output, it put 2 of 656 scores
// of chip_smoke.py's calibrated sessions 2.2e-5 from the plain f32 version
// (atol 2e-5). With the per-chunk add the chain is about as far from
// float64 as the plain f32 version is (chip_smoke.py reports both), well
// within rtol 2e-4, atol 2e-5 of it. One TF32 pass keeps 10 mantissa bits,
// ~5e-4 per product, and misses that tolerance by 4x
// (tests/test_torch_port_encoder_tf32.py). The kernel rounds to TF32 with
// its own instructions, so torch.backends.cuda.matmul.allow_tf32 has no
// effect on it.
//
// What bounds it on an H100: at the batched replay's 819,200 rows, the
// operations: 3 TF32 products x 2 x 2,573,968 MACs per row over 495
// TFLOP/s, 25.6 ms (mma.sync reaches only part of that rate, which wgmma
// alone reaches); the bytes (activations read and written once per layer,
// 15 GB in and 17 GB out, and the affines) take ~10 ms at 3.35 TB/s. At
// one row (the per-tick step) it is latency: each output tile is one
// warp's chain of ceil(K/8) chunks of 3 dependent MMAs.
//
// Design. Two tilings of the same per-element arithmetic, chosen by the
// caller from the row count M alone (ops/kernels.py::encoder_regime):
//  * large (encoder_layer_large_kernel): 128 x 128 output tiles, 8 warps
//    of 64 x 32, two CTAs to an SM, BK = 32, a 3-stage ring of 16-byte
//    cp.async copies that keeps the next k-tiles in flight; A rows padded
//    to 36 floats and B rows to 136 so fragment loads hit 32 distinct
//    banks. The epilogue stages the tile through shared memory, adds the
//    bias, ReLU and the session's affine on float4s and stores 16 bytes a
//    thread. Row tiles are walked session block by session block across
//    the ticks, so a block's affine rows stay in L2 for all of its ticks,
//    and the column tiles of one row tile run next to each other, so A is
//    read from device memory once.
//  * small (encoder_layer_small_kernel): 16-row tiles (padded rows zero
//    and never stored) by 8 columns, one warp each, so N = 512-768 spreads
//    over 64-96 CTAs; each CTA stages its weights, then its rows in 4
//    cp.async groups along K, and starts its MMA chain as the first lands.
// Every layer and the head launch with programmatic stream serialization:
// a kernel fetches its weights, waits for the previous grid (its input),
// then lets the next layer launch and fetch its own weights meanwhile.
// A row sits at the same place of its m16 tile in both (r % 16), walks the
// same k8 chunks in the same order with the same three products, and no
// sum is split over K or over CTAs: a row's scores have the same bits
// whatever M is and whichever tiling ran them, and reruns repeat them.
// The first layer's K = 12 is zero-filled to 16. The banded conv fold's
// zero blocks are multiplied like any other weights; skipping them is
// later work.
//
// The config axis (the crossval sweep's validation, the JAX package's
// jax.vmap of fused_encoder_logits over C configs' folds): one call runs C
// chains, each on its own M rows. Every array holds the C configs' one
// after another, so config c's activations are rows c*M .. c*M + M - 1 of a
// (C*M, width) matrix and its weights rows c*K .. c*K + K - 1 of a (C*K, N)
// one. Every layer's and the head's grid takes one more dimension over
// configs (the small tiling's z, the large tiling's and the head's y); a
// CTA addresses its config's rows and weights from its config's first,
// and tiles, chunks and sums are as at C = 1, so config c's scores are
// bit-equal to a call on its chain alone and C = 1 is that call. The large
// tilings keep their config's input and weight pointers in shared memory,
// read where a k-tile's copies are issued: held in registers through the k
// loop, they spilled the bf16 tiling at its 128 registers. Per-session
// affines (the batched engine) take C = 1.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "tf32_mma.cuh"

namespace {

// A fragment (m16 x k8, row-major, stride ld floats) at p = &A[g][t]:
// rows g and g + 8, columns t and t + 4.
__device__ __forceinline__ void load_a(const float* p, int ld, bool lo,
                                       bool hi, uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
  split_tf32(lo ? p[0] : 0.0f, big[0], small[0]);
  split_tf32(hi ? p[8 * ld] : 0.0f, big[1], small[1]);
  split_tf32(lo ? p[4] : 0.0f, big[2], small[2]);
  split_tf32(hi ? p[8 * ld + 4] : 0.0f, big[3], small[3]);
}

// Programmatic dependent launch: a kernel fetches its weights, then waits
// for the previous grid in the stream (its input) to finish, then lets the
// next one launch and fetch its own weights meanwhile.
__device__ __forceinline__ void wait_for_input() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// ------------------------------------------------------------- epilogue
// bias, ReLU, then the session's affine, on 4 columns n..n+3 of row `row`
__device__ __forceinline__ float4 finish4(float4 v, const float* __restrict__ b,
                                          const float* __restrict__ a,
                                          const float* __restrict__ c,
                                          long long row, int n, int N, int S) {
  const float4 bias = *reinterpret_cast<const float4*>(b + n);
  v.x = fmaxf(__fadd_rn(v.x, bias.x), 0.0f);
  v.y = fmaxf(__fadd_rn(v.y, bias.y), 0.0f);
  v.z = fmaxf(__fadd_rn(v.z, bias.z), 0.0f);
  v.w = fmaxf(__fadd_rn(v.w, bias.w), 0.0f);
  if (a != nullptr) {
    const long long off = (row % S) * N + n;
    const float4 av = *reinterpret_cast<const float4*>(a + off);
    const float4 cv = *reinterpret_cast<const float4*>(c + off);
    v.x = __fadd_rn(__fmul_rn(v.x, av.x), cv.x);
    v.y = __fadd_rn(__fmul_rn(v.y, av.y), cv.y);
    v.z = __fadd_rn(__fmul_rn(v.z, av.z), cv.z);
    v.w = __fadd_rn(__fmul_rn(v.w, av.w), cv.w);
  }
  return v;
}

// ------------------------------------------------------- large tiling
constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kWarpsM = 2, kWarpsN = 4, kMinBlocks = 2, kStages = 3;
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kMI = kBM / kWarpsM / 16, kNI = kBN / kWarpsN / 8;
constexpr int kAS = kBK + 4;  // A row stride: fragment banks 4g + t
constexpr int kBS = kBN + 8;  // B row stride: fragment banks 8t + g
constexpr int kCS = kBN + 8;  // staged output stride: float2 stores 8g + 2t
constexpr int kStageFloats = kBM * kAS + kBK * kBS;
constexpr size_t kLargeSmem = sizeof(float) * kStages * kStageFloats;
static_assert(kBM * kCS <= kStages * kStageFloats, "output tile fits");

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    encoder_layer_large_kernel(const float* __restrict__ h,
                               const float* __restrict__ w,
                               const float* __restrict__ b,
                               const float* __restrict__ a,
                               const float* __restrict__ c,
                               float* __restrict__ out, int M, int K, int N,
                               int S, int tiles_per_tick, int ticks) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n_tiles = (N + kBN - 1) / kBN;
  const int nt = blockIdx.x % n_tiles;
  int rt = blockIdx.x / n_tiles;
  if (tiles_per_tick > 0)  // session block by session block over the ticks
    rt = (rt % ticks) * tiles_per_tick + rt / ticks;
  const long long row0 = (long long)rt * kBM;
  const int col0 = nt * kBN;
  const int k_tiles = (K + kBK - 1) / kBK;
  const int k_chunks = (K + 7) / 8;
  // this config's input rows and weights, read where the copies are issued
  __shared__ const float* volatile cfg_h;
  __shared__ const float* volatile cfg_w;
  if (tid == 0) {
    cfg_h = h + (long long)blockIdx.y * M * K;
    cfg_w = w + (long long)blockIdx.y * K * N;
  }
  __syncthreads();

  auto load_a_tile = [&](int kt, int stage) {
    float* As = smem + stage * kStageFloats;
    const int k0 = kt * kBK;
#pragma unroll
    for (int i = 0; i < kBM * kBK / 4 / kThreads; ++i) {
      const int id = tid + i * kThreads;
      const int m = id / (kBK / 4), kc = (id % (kBK / 4)) * 4;
      const long long gm = row0 + m;
      const int gk = k0 + kc;
      const bool ok = gm < M && gk < K;
      cp_async16(As + m * kAS + kc, ok ? cfg_h + gm * K + gk : h, ok);
    }
  };
  auto load_b_tile = [&](int kt, int stage) {
    float* Bs = smem + stage * kStageFloats + kBM * kAS;
    const int k0 = kt * kBK;
#pragma unroll
    for (int i = 0; i < kBK * kBN / 4 / kThreads; ++i) {
      const int id = tid + i * kThreads;
      const int kr = id / (kBN / 4), nc = (id % (kBN / 4)) * 4;
      const int gk = k0 + kr, gn = col0 + nc;
      const bool ok = gk < K && gn < N;
      cp_async16(Bs + kr * kBS + nc, ok ? cfg_w + (long long)gk * N + gn : w,
                 ok);
    }
  };

  // the first stages' weights, then the input once the previous layer is
  // done: one commit group per stage, the weights riding in the first
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s)
    if (s < k_tiles) load_b_tile(s, s);
  wait_for_input();
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles) load_a_tile(s, s);
    cp_async_commit();
  }

  float acc[kMI][kNI][4] = {};
  const int wm = (warp % kWarpsM) * (kBM / kWarpsM);
  const int wn = (warp / kWarpsM) * (kBN / kWarpsN);
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < k_tiles) {
      load_a_tile(next, next % kStages);
      load_b_tile(next, next % kStages);
    }
    cp_async_commit();
    const float* As = smem + (kt % kStages) * kStageFloats;
    const float* Bs = As + kBM * kAS;
    const int n_kk = min(kBK / 8, k_chunks - kt * (kBK / 8));
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {
      if (kk < n_kk) {
        uint32_t a_big[kMI][4], a_small[kMI][4];
#pragma unroll
        for (int mi = 0; mi < kMI; ++mi)
          load_a(As + (wm + mi * 16 + g) * kAS + kk * 8 + t, kAS, true, true,
                 a_big[mi], a_small[mi]);
#pragma unroll
        for (int ni = 0; ni < kNI; ++ni) {
          const float* q = Bs + (kk * 8 + t) * kBS + wn + ni * 8 + g;
          uint32_t bb0, bs0, bb1, bs1;
          split_tf32(q[0], bb0, bs0);
          split_tf32(q[4 * kBS], bb1, bs1);
          // mma_3xtf32's order for each accumulator, the row fragments
          // interleaved so that no MMA waits on the one before
          float p[kMI][4] = {};
#pragma unroll
          for (int mi = 0; mi < kMI; ++mi)
            mma_tf32(p[mi], a_small[mi], bb0, bb1);
#pragma unroll
          for (int mi = 0; mi < kMI; ++mi)
            mma_tf32(p[mi], a_big[mi], bs0, bs1);
#pragma unroll
          for (int mi = 0; mi < kMI; ++mi)
            mma_tf32(p[mi], a_big[mi], bb0, bb1);
#pragma unroll
          for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              acc[mi][ni][i] = __fadd_rn(acc[mi][ni][i], p[mi][i]);
        }
      }
    }
  }

  // epilogue: stage the tile, then bias/ReLU/affine and 16-byte stores
  cp_async_wait<0>();
  __syncthreads();
  float* Cs = smem;
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni) {
      const int r = wm + mi * 16 + g, col = wn + ni * 8 + 2 * t;
      *reinterpret_cast<float2*>(Cs + r * kCS + col) =
          make_float2(acc[mi][ni][0], acc[mi][ni][1]);
      *reinterpret_cast<float2*>(Cs + (r + 8) * kCS + col) =
          make_float2(acc[mi][ni][2], acc[mi][ni][3]);
    }
  __syncthreads();
#pragma unroll 4
  for (int i = 0; i < kBM * kBN / 4 / kThreads; ++i) {
    const int id = tid + i * kThreads;
    const int m = id / (kBN / 4), nc = (id % (kBN / 4)) * 4;
    const long long gm = row0 + m;
    const int gn = col0 + nc;
    if (gm < M && gn < N) {
      const float4 v = *reinterpret_cast<const float4*>(Cs + m * kCS + nc);
      *reinterpret_cast<float4*>(out + ((long long)blockIdx.y * M + gm) * N +
                                 gn) =
          finish4(v, b + (long long)blockIdx.y * N, a, c, gm, gn, N, S);
    }
  }
}

// ------------------------------------------------------- small tiling
constexpr int kSM = 16, kSN = 8, kGroups = 4;

__host__ __device__ constexpr int small_a_stride(int K) {
  return (K + 31) / 32 * 32 + 4;  // fragment banks 4g + t
}

__host__ __device__ constexpr size_t small_smem(int K) {
  return sizeof(float) *
         ((size_t)kSM * small_a_stride(K) + (size_t)(K + 7) / 8 * 8 * kSN);
}

__global__ void __launch_bounds__(32) encoder_layer_small_kernel(
    const float* __restrict__ h, const float* __restrict__ w,
    const float* __restrict__ b, const float* __restrict__ a,
    const float* __restrict__ c, float* __restrict__ out, int M, int K, int N,
    int S) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  const int col0 = blockIdx.x * kSN;
  // the tile's first row, in the config and over all configs; the config's
  // first weight row
  const long long row0 = (long long)blockIdx.y * kSM;
  const long long grow0 = (long long)blockIdx.z * M + row0;
  const int wrow0 = blockIdx.z * K;
  const int rows = (int)min((long long)kSM, M - row0);
  const int k_chunks = (K + 7) / 8;
  const int lda = small_a_stride(K);
  float* As = smem;              // rows < `rows` only; the rest never read
  float* Bs = smem + kSM * lda;  // (k_chunks * 8) x 8, zero past K and N

  // all of this CTA's weights (one commit group), then the input rows once
  // the previous layer is done, in kGroups commit groups along K
  for (int i = lane; i < k_chunks * 8 * 2; i += 32) {
    const int k = i / 2, n = col0 + (i % 2) * 4;
    const bool ok = k < K && n < N;
    cp_async16(Bs + k * kSN + (i % 2) * 4,
               ok ? w + (long long)(wrow0 + k) * N + n : w, ok);
  }
  cp_async_commit();
  wait_for_input();
#pragma unroll
  for (int gi = 0; gi < kGroups; ++gi) {
    const int k_lo = gi * k_chunks / kGroups * 8;
    const int k_hi = (gi + 1) * k_chunks / kGroups * 8;
    const int per_row = (k_hi - k_lo) / 4;
    for (int i = lane; i < rows * per_row; i += 32) {
      const int r = i / per_row, k = k_lo + (i % per_row) * 4;
      const bool ok = k < K;
      cp_async16(As + r * lda + k, ok ? h + (grow0 + r) * K + k : h, ok);
    }
    cp_async_commit();
  }

  float d[4] = {};
  const bool lo = g < rows, hi = g + 8 < rows;
#pragma unroll
  for (int gi = 0; gi < kGroups; ++gi) {
    if (gi == 0) cp_async_wait<kGroups - 1>();
    if (gi == 1) cp_async_wait<kGroups - 2>();
    if (gi == 2) cp_async_wait<kGroups - 3>();
    if (gi == 3) cp_async_wait<0>();
    __syncthreads();  // one warp: the other lanes' copies are visible
    const int c_lo = gi * k_chunks / kGroups;
    const int c_hi = (gi + 1) * k_chunks / kGroups;
#pragma unroll 4
    for (int ch = c_lo; ch < c_hi; ++ch) {
      uint32_t a_big[4], a_small[4];
      load_a(As + g * lda + ch * 8 + t, lda, lo, hi, a_big, a_small);
      const float* q = Bs + (ch * 8 + t) * kSN + g;
      uint32_t bb0, bs0, bb1, bs1;
      split_tf32(q[0], bb0, bs0);
      split_tf32(q[4 * kSN], bb1, bs1);
      mma_3xtf32(d, a_big, a_small, bb0, bb1, bs0, bs1);
    }
  }

  // lane (g, t) holds rows g, g+8 at columns 2t, 2t+1; pair lanes t, t^1
  // so that an even t stores row g and an odd t row g+8, 4 columns each
  const unsigned full = 0xffffffffu;
  const float p0 = __shfl_xor_sync(full, d[0], 1);
  const float p1 = __shfl_xor_sync(full, d[1], 1);
  const float p2 = __shfl_xor_sync(full, d[2], 1);
  const float p3 = __shfl_xor_sync(full, d[3], 1);
  const bool even = (t & 1) == 0;
  const int r = even ? g : g + 8;
  const int n = col0 + (even ? 2 * t : 2 * t - 2);
  if (r < rows && n < N) {
    const float4 v = even ? make_float4(d[0], d[1], p0, p1)
                          : make_float4(p2, p3, d[2], d[3]);
    *reinterpret_cast<float4*>(out + (grow0 + r) * N + n) =
        finish4(v, b + (long long)blockIdx.z * N, a, c, row0 + r, n, N, S);
  }
}

// ---------------------------------------------------------------- head
constexpr int kMaxE = 32;  // embedding width held per lane

__global__ void __launch_bounds__(256) encoder_head_kernel(
    const float* __restrict__ h, const float* __restrict__ wh,
    const float* __restrict__ bh, const float* __restrict__ gt,
    float* __restrict__ out, int M, int K, int E, int C) {
  // this config's head and class embeddings; its rows follow the configs'
  // before it
  const long long grow0 = (long long)blockIdx.y * M;
  wh += blockIdx.y * (long long)K * E;
  bh += blockIdx.y * (long long)E;
  gt += blockIdx.y * (long long)E * C;
  // Wh transposed to (E, K), so the lanes' consecutive k hit consecutive
  // banks | Gt (E, C); E % 4 == 0, so a float4 of Wh lies in one row
  extern __shared__ __align__(16) float head_smem[];
  float* wht_s = head_smem;
  float* gt_s = head_smem + K * E;
#pragma unroll 4
  for (int i = threadIdx.x; i < K * E / 4; i += blockDim.x) {
    const float4 v = reinterpret_cast<const float4*>(wh)[i];
    const int k = 4 * i / E, j = 4 * i % E;
    wht_s[j * K + k] = v.x;
    wht_s[(j + 1) * K + k] = v.y;
    wht_s[(j + 2) * K + k] = v.z;
    wht_s[(j + 3) * K + k] = v.w;
  }
  for (int i = threadIdx.x; i < E * C; i += blockDim.x) gt_s[i] = gt[i];
  wait_for_input();
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;
  for (long long r = (long long)blockIdx.x * warps + threadIdx.x / 32; r < M;
       r += (long long)gridDim.x * warps) {
    float e[kMaxE];
#pragma unroll
    for (int j = 0; j < kMaxE; ++j) e[j] = 0.0f;
#pragma unroll 4
    for (int k = lane; k < K; k += 32) {
      const float x = h[(grow0 + r) * K + k];
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
#pragma unroll
    for (int j = 0; j < kMaxE; ++j) e[j] /= norm;
    for (int cls = lane; cls < C; cls += 32) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < kMaxE; ++j)
        if (j < E) acc = fmaf(e[j], gt_s[j * C + cls], acc);
      out[(grow0 + r) * C + cls] = acc;
    }
  }
}

cudaError_t allow_smem(const void* kernel, size_t bytes, size_t* allowed) {
  if (bytes <= 48 * 1024 || bytes <= *allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *allowed = bytes;
  return err;
}

size_t large_allowed = 0, small_allowed = 0, head_allowed = 0;

// launch with programmatic stream serialization (see wait_for_input)
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), dim3 grid, int threads,
                   size_t smem, cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// ------------------------------------------------------- bf16 variant
// The same two tilings and head on a bf16 fold (weights and Gt bf16,
// biases and affines f32), one bf16 mma.sync m16n8k16 pass a product: a
// product of two bf16 values is exact in f32, so no split. As in the f32
// kernels, each k16 chunk is summed in the tensor core from zero and added
// to the row's f32 sum with one round-to-nearest add. A layer's input is
// rounded to bf16 (round to nearest even) where its fragments are formed:
// the f32 frames of layer 0 pair by pair as the fragments are loaded, the
// scratch of every later layer already in bf16. The scratch between layers
// is bf16 (this variant's choice): the epilogue adds the bias, applies
// ReLU and the affine in f32, then rounds once to bf16 and stores; the
// next dot reads only that rounded value, which is what rounding at the
// dot gives, at half the activation bytes. The first layer's K = 12 is
// zero-filled to 16 inside the kernels (copies past K write zeros), not
// in the fold. A row's place in its m16 tile, its chunks and their order
// are the f32 kernels', so a row's scores have the same bits whatever M
// and whichever tiling ran them.
constexpr int kHBK = 32;        // k of a large-tiling stage: two k16 chunks
constexpr int kHBS = kBN + 8;   // B row stride, bf16: 16-bit loads 4t + g/2

template <typename In>
struct Bf16Large {
  static constexpr int kVec = 16 / sizeof(In);  // elements a 16-byte copy
  // A row stride: f32 as the f32 kernel's; bf16 words at 4g + t
  static constexpr int kAS = sizeof(In) == 4 ? kHBK + 4 : kHBK + 8;
  static constexpr int kABytes = kBM * kAS * (int)sizeof(In);
  static constexpr int kStageBytes = kABytes + kHBK * kHBS * 2;
  static constexpr size_t kSmem =
      (size_t)kStages * kStageBytes > sizeof(float) * kBM * kCS
          ? (size_t)kStages * kStageBytes
          : sizeof(float) * kBM * kCS;  // the epilogue's f32 tile
};

// two consecutive elements of a layer's input as a bf16x2 word
__device__ __forceinline__ uint32_t bf16_pair(const float* p) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  return pack_bf16x2(v.x, v.y);
}
__device__ __forceinline__ uint32_t bf16_pair(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment (m16 x k16, row-major, stride ld) at p = &A[g][2t]: rows g
// and g + 8, columns 2t, 2t + 1 and 2t + 8, 2t + 9
template <typename In>
__device__ __forceinline__ void load_a_bf16(const In* p, int ld, bool lo,
                                            bool hi, uint32_t (&a)[4]) {
  a[0] = lo ? bf16_pair(p) : 0u;
  a[1] = hi ? bf16_pair(p + 8 * ld) : 0u;
  a[2] = lo ? bf16_pair(p + 8) : 0u;
  a[3] = hi ? bf16_pair(p + 8 * ld + 8) : 0u;
}

// B fragment word at q = &B[2t][g] (k16 x n8 of a row-major (k, n) tile):
// rows 2t and 2t + 1 of column g
__device__ __forceinline__ uint32_t load_b_bf16(const uint16_t* q, int ld) {
  return (uint32_t)q[0] | ((uint32_t)q[ld] << 16);
}

// 4 finished f32 columns rounded to bf16 and stored (8 bytes)
__device__ __forceinline__ void store4_bf16(uint16_t* p, float4 v) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(pack_bf16x2(v.x, v.y), pack_bf16x2(v.z, v.w));
}

// Layer 0 (f32 frames, paired and rounded as its fragments load) needs
// more registers than 128 would give without spilling: one CTA an SM there
// (its K = 12 is one k16 chunk), two for the bf16 layers.
template <typename In>
__global__ void __launch_bounds__(kThreads, sizeof(In) == 4 ? 1 : kMinBlocks)
    encoder_layer_large_bf16_kernel(const In* __restrict__ h,
                                    const uint16_t* __restrict__ w,
                                    const float* __restrict__ b,
                                    const float* __restrict__ a,
                                    const float* __restrict__ c,
                                    uint16_t* __restrict__ out, int M, int K,
                                    int N, int S, int tiles_per_tick,
                                    int ticks) {
  using L = Bf16Large<In>;
  extern __shared__ __align__(16) float smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n_tiles = (N + kBN - 1) / kBN;
  const int nt = blockIdx.x % n_tiles;
  int rt = blockIdx.x / n_tiles;
  if (tiles_per_tick > 0)  // session block by session block over the ticks
    rt = (rt % ticks) * tiles_per_tick + rt / ticks;
  const long long row0 = (long long)rt * kBM;
  const int col0 = nt * kBN;
  const int k_tiles = (K + kHBK - 1) / kHBK;
  const int k_chunks = (K + 15) / 16;
  // this config's input rows and weights, read where the copies are issued
  __shared__ const In* volatile cfg_h;
  __shared__ const uint16_t* volatile cfg_w;
  if (tid == 0) {
    cfg_h = h + (long long)blockIdx.y * M * K;
    cfg_w = w + (long long)blockIdx.y * K * N;
  }
  __syncthreads();

  auto load_a_tile = [&](int kt, int stage) {
    In* As = reinterpret_cast<In*>(base + stage * L::kStageBytes);
    const int k0 = kt * kHBK;
#pragma unroll
    for (int i = 0; i < kBM * kHBK / L::kVec / kThreads; ++i) {
      const int id = tid + i * kThreads;
      const int m = id / (kHBK / L::kVec);
      const int kc = (id % (kHBK / L::kVec)) * L::kVec;
      const long long gm = row0 + m;
      const int gk = k0 + kc;
      const bool ok = gm < M && gk < K;
      cp_async16(As + m * L::kAS + kc, ok ? cfg_h + gm * K + gk : h, ok);
    }
  };
  auto load_b_tile = [&](int kt, int stage) {
    uint16_t* Bs = reinterpret_cast<uint16_t*>(base + stage * L::kStageBytes +
                                               L::kABytes);
    const int k0 = kt * kHBK;
#pragma unroll
    for (int i = 0; i < kHBK * kBN / 8 / kThreads; ++i) {
      const int id = tid + i * kThreads;
      const int kr = id / (kBN / 8), nc = (id % (kBN / 8)) * 8;
      const int gk = k0 + kr, gn = col0 + nc;
      const bool ok = gk < K && gn < N;
      cp_async16(Bs + kr * kHBS + nc, ok ? cfg_w + (long long)gk * N + gn : w,
                 ok);
    }
  };

  // the first stages' weights, then the input once the previous layer is
  // done: one commit group per stage, the weights riding in the first
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s)
    if (s < k_tiles) load_b_tile(s, s);
  wait_for_input();
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles) load_a_tile(s, s);
    cp_async_commit();
  }

  float acc[kMI][kNI][4] = {};
  const int wm = (warp % kWarpsM) * (kBM / kWarpsM);
  const int wn = (warp / kWarpsM) * (kBN / kWarpsN);
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < k_tiles) {
      load_a_tile(next, next % kStages);
      load_b_tile(next, next % kStages);
    }
    cp_async_commit();
    const In* As =
        reinterpret_cast<const In*>(base + (kt % kStages) * L::kStageBytes);
    const uint16_t* Bs = reinterpret_cast<const uint16_t*>(
        base + (kt % kStages) * L::kStageBytes + L::kABytes);
    const int n_kk = min(kHBK / 16, k_chunks - kt * (kHBK / 16));
#pragma unroll
    for (int kk = 0; kk < kHBK / 16; ++kk) {
      if (kk < n_kk) {
        uint32_t af[kMI][4];
#pragma unroll
        for (int mi = 0; mi < kMI; ++mi)
          load_a_bf16(As + (wm + mi * 16 + g) * L::kAS + kk * 16 + 2 * t,
                      L::kAS, true, true, af[mi]);
#pragma unroll
        for (int ni = 0; ni < kNI; ++ni) {
          const uint16_t* q = Bs + (kk * 16 + 2 * t) * kHBS + wn + ni * 8 + g;
          const uint32_t b0 = load_b_bf16(q, kHBS);
          const uint32_t b1 = load_b_bf16(q + 8 * kHBS, kHBS);
          // one fragment's chunk sum at a time: four product registers
          // instead of sixteen keep the tile's registers under 128
#pragma unroll
          for (int mi = 0; mi < kMI; ++mi) {
            float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            mma_bf16(p, af[mi], b0, b1);
#pragma unroll
            for (int i = 0; i < 4; ++i)
              acc[mi][ni][i] = __fadd_rn(acc[mi][ni][i], p[i]);
          }
        }
      }
    }
  }

  // epilogue: stage the f32 tile, then bias/ReLU/affine in f32, one
  // rounding to bf16 and 8-byte stores
  cp_async_wait<0>();
  __syncthreads();
  float* Cs = smem;
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni) {
      const int r = wm + mi * 16 + g, col = wn + ni * 8 + 2 * t;
      *reinterpret_cast<float2*>(Cs + r * kCS + col) =
          make_float2(acc[mi][ni][0], acc[mi][ni][1]);
      *reinterpret_cast<float2*>(Cs + (r + 8) * kCS + col) =
          make_float2(acc[mi][ni][2], acc[mi][ni][3]);
    }
  __syncthreads();
#pragma unroll 4
  for (int i = 0; i < kBM * kBN / 4 / kThreads; ++i) {
    const int id = tid + i * kThreads;
    const int m = id / (kBN / 4), nc = (id % (kBN / 4)) * 4;
    const long long gm = row0 + m;
    const int gn = col0 + nc;
    if (gm < M && gn < N) {
      const float4 v = *reinterpret_cast<const float4*>(Cs + m * kCS + nc);
      store4_bf16(out + ((long long)blockIdx.y * M + gm) * N + gn,
                  finish4(v, b + (long long)blockIdx.y * N, a, c, gm, gn, N,
                          S));
    }
  }
}

// the small tiling's A row stride in elements: f32 as the f32 kernel's,
// bf16 K rounded up to 64 plus 8 (fragment words at 4g + t)
template <typename In>
__host__ __device__ constexpr int small_bf16_a_stride(int K) {
  return sizeof(In) == 4 ? small_a_stride(K) : (K + 63) / 64 * 64 + 8;
}

template <typename In>
__host__ __device__ constexpr size_t small_bf16_smem(int K) {
  return sizeof(In) * (size_t)kSM * small_bf16_a_stride<In>(K) +
         sizeof(uint16_t) * (size_t)((K + 15) / 16 * 16) * kSN;
}

template <typename In>
__global__ void __launch_bounds__(32) encoder_layer_small_bf16_kernel(
    const In* __restrict__ h, const uint16_t* __restrict__ w,
    const float* __restrict__ b, const float* __restrict__ a,
    const float* __restrict__ c, uint16_t* __restrict__ out, int M, int K,
    int N, int S) {
  constexpr int kVec = 16 / sizeof(In);
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  const int col0 = blockIdx.x * kSN;
  // the tile's first row, in the config and over all configs; the config's
  // first weight row
  const long long row0 = (long long)blockIdx.y * kSM;
  const long long grow0 = (long long)blockIdx.z * M + row0;
  const int wrow0 = blockIdx.z * K;
  const int rows = (int)min((long long)kSM, M - row0);
  const int k_chunks = (K + 15) / 16;
  const int lda = small_bf16_a_stride<In>(K);
  In* As = reinterpret_cast<In*>(smem);  // rows < `rows` only are read
  // (k_chunks * 16) x 8, zero past K; N % 8 == 0, so a column block lies
  // wholly inside N
  uint16_t* Bs = reinterpret_cast<uint16_t*>(As + kSM * lda);

  // all of this CTA's weights (one commit group), then the input rows once
  // the previous layer is done, in kGroups commit groups along K
  for (int k = lane; k < k_chunks * 16; k += 32) {
    const bool ok = k < K;
    cp_async16(Bs + k * kSN, ok ? w + (long long)(wrow0 + k) * N + col0 : w,
               ok);
  }
  cp_async_commit();
  wait_for_input();
#pragma unroll
  for (int gi = 0; gi < kGroups; ++gi) {
    const int k_lo = gi * k_chunks / kGroups * 16;
    const int k_hi = (gi + 1) * k_chunks / kGroups * 16;
    const int per_row = (k_hi - k_lo) / kVec;
    for (int i = lane; i < rows * per_row; i += 32) {
      const int r = i / per_row, k = k_lo + (i % per_row) * kVec;
      const bool ok = k < K;
      cp_async16(As + r * lda + k, ok ? h + (grow0 + r) * K + k : h, ok);
    }
    cp_async_commit();
  }

  float d[4] = {};
  const bool lo = g < rows, hi = g + 8 < rows;
#pragma unroll
  for (int gi = 0; gi < kGroups; ++gi) {
    if (gi == 0) cp_async_wait<kGroups - 1>();
    if (gi == 1) cp_async_wait<kGroups - 2>();
    if (gi == 2) cp_async_wait<kGroups - 3>();
    if (gi == 3) cp_async_wait<0>();
    __syncthreads();  // one warp: the other lanes' copies are visible
    const int c_lo = gi * k_chunks / kGroups;
    const int c_hi = (gi + 1) * k_chunks / kGroups;
#pragma unroll 4
    for (int ch = c_lo; ch < c_hi; ++ch) {
      uint32_t af[4];
      load_a_bf16(As + g * lda + ch * 16 + 2 * t, lda, lo, hi, af);
      const uint16_t* q = Bs + (ch * 16 + 2 * t) * kSN + g;
      float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      mma_bf16(p, af, load_b_bf16(q, kSN), load_b_bf16(q + 8 * kSN, kSN));
#pragma unroll
      for (int i = 0; i < 4; ++i) d[i] = __fadd_rn(d[i], p[i]);
    }
  }

  // as the f32 kernel: an even t stores row g, an odd t row g + 8
  const unsigned full = 0xffffffffu;
  const float p0 = __shfl_xor_sync(full, d[0], 1);
  const float p1 = __shfl_xor_sync(full, d[1], 1);
  const float p2 = __shfl_xor_sync(full, d[2], 1);
  const float p3 = __shfl_xor_sync(full, d[3], 1);
  const bool even = (t & 1) == 0;
  const int r = even ? g : g + 8;
  const int n = col0 + (even ? 2 * t : 2 * t - 2);
  if (r < rows && n < N) {
    const float4 v = even ? make_float4(d[0], d[1], p0, p1)
                          : make_float4(p2, p3, d[2], d[3]);
    store4_bf16(out + (grow0 + r) * N + n,
                finish4(v, b + (long long)blockIdx.z * N, a, c, row0 + r, n,
                        N, S));
  }
}

// e = h @ Wh + bh (h and Wh bf16, exact products, f32 sums), e /= ||e||
// in f32, then e rounded to bf16 times the bf16 Gt, summed in f32; the
// f32 head's lanes and order
__global__ void __launch_bounds__(256) encoder_head_bf16_kernel(
    const uint16_t* __restrict__ h, const uint16_t* __restrict__ wh,
    const float* __restrict__ bh, const uint16_t* __restrict__ gt,
    float* __restrict__ out, int M, int K, int E, int C) {
  // this config's head and class embeddings; its rows follow the configs'
  // before it
  const long long grow0 = (long long)blockIdx.y * M;
  wh += blockIdx.y * (long long)K * E;
  bh += blockIdx.y * (long long)E;
  gt += blockIdx.y * (long long)E * C;
  // Wh transposed to (E, K) and Gt (E, C), both in f32 (exact)
  extern __shared__ __align__(16) float head_smem[];
  float* wht_s = head_smem;
  float* gt_s = head_smem + K * E;
  for (int i = threadIdx.x; i < K * E; i += blockDim.x)
    wht_s[(i % E) * K + i / E] = bf16_to_f32(wh[i]);
  for (int i = threadIdx.x; i < E * C; i += blockDim.x)
    gt_s[i] = bf16_to_f32(gt[i]);
  wait_for_input();
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;
  for (long long r = (long long)blockIdx.x * warps + threadIdx.x / 32; r < M;
       r += (long long)gridDim.x * warps) {
    float e[kMaxE];
#pragma unroll
    for (int j = 0; j < kMaxE; ++j) e[j] = 0.0f;
#pragma unroll 4
    for (int k = lane; k < K; k += 32) {
      const float x = bf16_to_f32(h[(grow0 + r) * K + k]);
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
#pragma unroll
    for (int j = 0; j < kMaxE; ++j) e[j] = round_bf16(e[j] / norm);
    for (int cls = lane; cls < C; cls += 32) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < kMaxE; ++j)
        if (j < E) acc = fmaf(e[j], gt_s[j * C + cls], acc);
      out[(grow0 + r) * C + cls] = acc;
    }
  }
}

// one bf16 layer, its input f32 (layer 0) or bf16, in the tiling `regime`
template <typename In>
cudaError_t bf16_layer(const In* h, const uint16_t* w, const float* b,
                       const float* a, const float* c, uint16_t* out, int M,
                       int K, int N, int S, int regime, int tiles_per_tick,
                       int ticks, int n_cfg, cudaStream_t stream) {
  static size_t small_ok = 0, large_ok = 0;
  cudaError_t err;
  if (regime == 0) {
    const size_t smem = small_bf16_smem<In>(K);
    err = allow_smem((const void*)encoder_layer_small_bf16_kernel<In>, smem,
                     &small_ok);
    if (err != cudaSuccess) return err;
    const dim3 grid((N + kSN - 1) / kSN, (M + kSM - 1) / kSM, n_cfg);
    err = launch(encoder_layer_small_bf16_kernel<In>, grid, 32, smem, stream,
                 h, w, b, a, c, out, M, K, N, S);
  } else {
    const size_t smem = Bf16Large<In>::kSmem;
    err = allow_smem((const void*)encoder_layer_large_bf16_kernel<In>, smem,
                     &large_ok);
    if (err != cudaSuccess) return err;
    const long long blocks =
        (long long)((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
    err = launch(encoder_layer_large_bf16_kernel<In>,
                 dim3((unsigned)blocks, n_cfg), kThreads, smem, stream, h, w,
                 b, a, c, out, M, K, N, S, tiles_per_tick, ticks);
  }
  if (err == cudaSuccess) err = cudaGetLastError();
  return err;
}

size_t head_bf16_allowed = 0;

// The head's CTAs of one config: a warp a row, at most 132 x 8 CTAs in all
// (grid-stride over the rest)
unsigned head_blocks(int M, int n_cfg) {
  const int threads = 256, rows_per_block = threads / 32;
  long long blocks = ((long long)M + rows_per_block - 1) / rows_per_block;
  long long cap = 132 * 8 / n_cfg;
  if (cap < 1) cap = 1;
  return (unsigned)(blocks < cap ? blocks : cap);
}

}  // namespace

// The whole chain in one call. `layers`: per hidden layer j, the pointers
// w_j (K_j, N_j), b_j (N_j), a_j, c_j (S, N_j) or null, null; then Wh (K,
// E), bh (E), Gt (E, C). `widths`: K_0, N_0 .. N_{n_hidden-1}, E, C, all
// hidden widths multiples of 4 and every pointer 16-byte aligned.
// `scratch` holds 2 x n_cfg x M x max(N_j) floats. `regime` 0 runs the
// small-row tiling, 1 the large one. n_cfg configs (the config axis
// above): frames (n_cfg, M, K_0), each weight, bias and Gt the configs' one
// after another, scores (n_cfg, M, C); no affines unless n_cfg is 1.
// Returns the first launch's cudaError_t that is not cudaSuccess.
extern "C" int encoder_chain_launch(const void* const* layers,
                                    const int* widths, int n_hidden,
                                    const float* frames, float* scratch,
                                    float* scores, int M, int n_cfg, int S,
                                    int regime, void* stream_ptr) {
  const cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (M <= 0) return (int)cudaSuccess;
  const bool affine = layers[2] != nullptr;
  if (S < 1 || (affine && M % S) || (regime != 0 && regime != 1) ||
      n_cfg < 1 || n_cfg > 65535 || (affine && n_cfg != 1))
    return (int)cudaErrorInvalidValue;
  long long max_n = 0;
  for (int j = 0; j < n_hidden; ++j) {
    if (widths[j] % 4 || widths[j + 1] % 4) return (int)cudaErrorInvalidValue;
    if ((layers[4 * j + 2] == nullptr) != !affine ||
        (layers[4 * j + 3] == nullptr) != !affine)
      return (int)cudaErrorInvalidValue;
    if (widths[j + 1] > max_n) max_n = widths[j + 1];
  }
  // the large tiling walks a session block's ticks together when row tiles
  // hold whole session blocks
  const int tiles_per_tick = affine && S % kBM == 0 ? S / kBM : 0;
  const int ticks = M / S;

  const float* h = frames;
  for (int j = 0; j < n_hidden; ++j) {
    const int K = widths[j], N = widths[j + 1];
    const float* w = static_cast<const float*>(layers[4 * j]);
    const float* b = static_cast<const float*>(layers[4 * j + 1]);
    const float* a = static_cast<const float*>(layers[4 * j + 2]);
    const float* c = static_cast<const float*>(layers[4 * j + 3]);
    float* out = scratch + (size_t)(j & 1) * n_cfg * (size_t)M * max_n;
    cudaError_t err;
    if (regime == 0) {
      const size_t smem = small_smem(K);
      err = allow_smem((const void*)encoder_layer_small_kernel, smem,
                       &small_allowed);
      if (err != cudaSuccess) return (int)err;
      const dim3 grid((N + kSN - 1) / kSN, (M + kSM - 1) / kSM, n_cfg);
      err = launch(encoder_layer_small_kernel, grid, 32, smem, stream, h, w,
                   b, a, c, out, M, K, N, S);
    } else {
      err = allow_smem((const void*)encoder_layer_large_kernel, kLargeSmem,
                       &large_allowed);
      if (err != cudaSuccess) return (int)err;
      const long long blocks =
          (long long)((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
      err = launch(encoder_layer_large_kernel, dim3((unsigned)blocks, n_cfg),
                   kThreads, kLargeSmem, stream, h, w, b, a, c, out, M, K, N,
                   S, tiles_per_tick, ticks);
    }
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    h = out;
  }

  const int K = widths[n_hidden], E = widths[n_hidden + 1],
            C = widths[n_hidden + 2];
  if (E > kMaxE || E % 4) return (int)cudaErrorInvalidValue;
  const float* wh = static_cast<const float*>(layers[4 * n_hidden]);
  const float* bh = static_cast<const float*>(layers[4 * n_hidden + 1]);
  const float* gt = static_cast<const float*>(layers[4 * n_hidden + 2]);
  const size_t smem = sizeof(float) * ((size_t)K * E + (size_t)E * C);
  cudaError_t err =
      allow_smem((const void*)encoder_head_kernel, smem, &head_allowed);
  if (err != cudaSuccess) return (int)err;
  err = launch(encoder_head_kernel, dim3(head_blocks(M, n_cfg), n_cfg), 256,
               smem, stream, h, wh, bh, gt, scores, M, K, E, C);
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}

// The bf16 variant (see "bf16 variant" above): the same table, but every
// w_j, Wh and Gt bf16 (uint16_t bits) and `scratch` 2 x n_cfg x M x
// max(N_j) bf16; frames, biases, affines and scores f32. K_0 a multiple of
// 4, every other width a multiple of 8. Returns as encoder_chain_launch.
extern "C" int encoder_chain_bf16_launch(const void* const* layers,
                                         const int* widths, int n_hidden,
                                         const float* frames,
                                         void* scratch_ptr, float* scores,
                                         int M, int n_cfg, int S, int regime,
                                         void* stream_ptr) {
  const cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (M <= 0) return (int)cudaSuccess;
  const bool affine = layers[2] != nullptr;
  if (S < 1 || (affine && M % S) || (regime != 0 && regime != 1) ||
      n_cfg < 1 || n_cfg > 65535 || (affine && n_cfg != 1))
    return (int)cudaErrorInvalidValue;
  long long max_n = 0;
  for (int j = 0; j < n_hidden; ++j) {
    if (widths[j] % (j == 0 ? 4 : 8) || widths[j + 1] % 8)
      return (int)cudaErrorInvalidValue;
    if ((layers[4 * j + 2] == nullptr) != !affine ||
        (layers[4 * j + 3] == nullptr) != !affine)
      return (int)cudaErrorInvalidValue;
    if (widths[j + 1] > max_n) max_n = widths[j + 1];
  }
  const int tiles_per_tick = affine && S % kBM == 0 ? S / kBM : 0;
  const int ticks = M / S;

  uint16_t* scratch = static_cast<uint16_t*>(scratch_ptr);
  const uint16_t* h = nullptr;
  for (int j = 0; j < n_hidden; ++j) {
    const int K = widths[j], N = widths[j + 1];
    const uint16_t* w = static_cast<const uint16_t*>(layers[4 * j]);
    const float* b = static_cast<const float*>(layers[4 * j + 1]);
    const float* a = static_cast<const float*>(layers[4 * j + 2]);
    const float* c = static_cast<const float*>(layers[4 * j + 3]);
    uint16_t* out = scratch + (size_t)(j & 1) * n_cfg * (size_t)M * max_n;
    const cudaError_t err =
        j == 0 ? bf16_layer(frames, w, b, a, c, out, M, K, N, S, regime,
                            tiles_per_tick, ticks, n_cfg, stream)
               : bf16_layer(h, w, b, a, c, out, M, K, N, S, regime,
                            tiles_per_tick, ticks, n_cfg, stream);
    if (err != cudaSuccess) return (int)err;
    h = out;
  }

  const int K = widths[n_hidden], E = widths[n_hidden + 1],
            C = widths[n_hidden + 2];
  if (E > kMaxE) return (int)cudaErrorInvalidValue;
  const uint16_t* wh = static_cast<const uint16_t*>(layers[4 * n_hidden]);
  const float* bh = static_cast<const float*>(layers[4 * n_hidden + 1]);
  const uint16_t* gt = static_cast<const uint16_t*>(layers[4 * n_hidden + 2]);
  const size_t smem = sizeof(float) * ((size_t)K * E + (size_t)E * C);
  cudaError_t err = allow_smem((const void*)encoder_head_bf16_kernel, smem,
                               &head_bf16_allowed);
  if (err != cudaSuccess) return (int)err;
  err = launch(encoder_head_bf16_kernel, dim3(head_blocks(M, n_cfg), n_cfg),
               256, smem, stream, h, wh, bh, gt, scores, M, K, E, C);
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}
