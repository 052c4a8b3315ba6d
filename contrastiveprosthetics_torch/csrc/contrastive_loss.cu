// contrastive_loss: the fused symmetric contrastive loss of a train step
// (forward) and its gradient (backward), for C configs of N items each.
//
// Replaces: the JAX package's ops/pallas_ops.py::_pallas_loss_call
//   (K1f, pallas_ops.py:185; body _loss_kernel :145, per item _loss_item
//   :112) and ::_pallas_bwd_call (K1b, :213; body _bwd_kernel :169), tied
//   together by the custom VJP fused_contrastive_loss (:1034-1057). The
//   JAX sweep vmaps that loss over its configs; here the config axis is
//   the leading axis of e and g.
//
// What it computes, per config c and item n, with e, g (T, d) L2-normalized:
//   logits = e g^T (T, T);
//   loss_n = (sum_r (lse_row_r - logits_rr) + sum_c (lse_col_c - logits_cc))
//            / (2T),  loss[c] = mean_n loss_n (summed in item order);
//   correct[c] = number of rows whose first maximum is the diagonal;
//   backward: dlogits = (softmax_row - I + softmax_col - I) / (2T N),
//   de = dlogits g * dloss[c], dg = dlogits^T e * dloss[c].
//
// What bounds it on an H100: latency, not bytes or operations. At the
// train step's shape (C=1, N=8, T=41, d=16) it reads 42 KB and does ~0.5
// MFLOP each way, a bound of about 0.01 ms; at the sweep's C=150 it reads
// 6.3 MB, about 2 us. What costs time is one launch, the copy in, and the
// dependent steps inside an item: shared-memory loads that feed the next
// instruction, expf chains, barriers. The design:
// - one CTA per item in both directions, so the train step's 8 items run
//   on 8 SMs. The forward needs one sum per config; its CTAs form a
//   thread-block cluster (up to 8 per config, each taking items rank,
//   rank + 8, ...); each CTA stores its items' losses into rank 0's shared
//   memory, and rank 0 sums them in index order after one cluster
//   barrier. No scratch, no memset, no ticket, no float
//   atomics, one launch each way; a config's bits depend neither on C nor
//   on its position in the batch;
// - e and g rows arrive by 16-byte cp.async, all in flight at once, at a
//   row stride of an odd number of float4s, so a warp's 16-byte reads hit
//   distinct banks; each thread computes a 4 x 4 tile of logits (rows and
//   columns T/4 apart) from float4 reads, each logit a chain over d in
//   order;
// - each row's or column's max, first maximum and log-sum-exp is taken by
//   kLanes lanes with __shfl_xor_sync; each lane keeps four independent
//   partial chains, so its loads and expf overlap; the logits' row stride
//   is odd, so column reads do not conflict either;
// - the backward recomputes the logits as the TPU kernel does, overwrites
//   them with dlogits, and each thread computes 2 rows x 4 columns of de or
//   dg, a chain over T in order. It reads dloss[c] on the card, so it never
//   syncs with the host.
// Math is exact-rounded expf/logf/fmaf (no fast math); f32 SIMT, no TF32.
//
// Layouts: e, g, de, dg (C, N, T, d) f32 contiguous; dloss (C,); out (2, C)
// = (loss, correct). Limits: 1 <= T, d <= 64, 1 <= N <= 8192 (rank 0 holds
// every item's loss), 1 <= C <= 65535.
#include <climits>
#include <cmath>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "tf32_mma.cuh"  // cp_async16 only: K1 runs in f32, not TF32

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxT = 64, kMaxD = 64, kMaxN = 8192, kMaxC = 65535;
constexpr int kThreads = 256;
constexpr int kMaxCluster = 8;  // CTAs per config in the forward (portable)
constexpr int kLanes = 2;       // lanes that reduce one row or column

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }
// row stride of the staged e and g: an odd number of float4s
__host__ __device__ constexpr int row_stride(int d) {
  return 4 * (((d + 3) / 4) | 1);
}
// row stride of the logits: odd, so a column's reads hit distinct banks
__host__ __device__ constexpr int logit_stride(int T) { return T | 1; }
// one item's shared memory in floats: its rows of e and of g, its logits,
// then 3T for the per-line results (fwd: 2T terms and T hits; bwd: T + T
// log-sum-exps)
__host__ __device__ constexpr int item_floats(int T, int d) {
  return 2 * T * row_stride(d) + round4(T * logit_stride(T)) + round4(3 * T);
}

struct Item {
  float *es, *gs, *L, *aux;
};

__device__ Item item_at(float* smem, int T, int d) {
  Item it;
  it.es = smem;
  it.gs = it.es + T * row_stride(d);
  it.L = it.gs + T * row_stride(d);
  it.aux = it.L + round4(T * logit_stride(T));
  return it;
}

// Stage item `item` of e and g, zero-padded to the row stride. Rows of
// whole float4s from 16-byte aligned arrays go by cp.async, every copy in
// flight at once; other shapes by plain loads. The caller syncs the block.
__device__ void stage(const float* __restrict__ e, const float* __restrict__ g,
                      const Item& it, size_t item, int T, int d, bool async) {
  const int s = row_stride(d);
  const size_t base = item * T * d;
  if (async) {
    const int q = d / 4;
    for (int i = threadIdx.x; i < T * q; i += blockDim.x) {
      const int r = i / q, k = 4 * (i - r * q);
      cp_async16(it.es + r * s + k, e + base + (size_t)r * d + k, true);
      cp_async16(it.gs + r * s + k, g + base + (size_t)r * d + k, true);
    }
    cp_async_commit();
    cp_async_wait<0>();
    return;
  }
  for (int i = threadIdx.x; i < T * s; i += blockDim.x) {
    const int r = i / s, k = i - r * s;
    const size_t src = base + (size_t)r * d + k;
    it.es[i] = k < d ? e[src] : 0.0f;
    it.gs[i] = k < d ? g[src] : 0.0f;
  }
}

// The item's logits: thread tiles of rows ti + nt*i, columns tj + nt*j.
__device__ void logits(const Item& it, int T, int d) {
  const int s = row_stride(d), ld = logit_stride(T), nt = (T + 3) / 4;
  for (int tile = threadIdx.x; tile < nt * nt; tile += blockDim.x) {
    const int ti = tile / nt, tj = tile - ti * nt;
    int rows[4], cols[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      rows[i] = min(ti + nt * i, T - 1);  // a padded row reads a real one
      cols[i] = min(tj + nt * i, T - 1);
    }
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 1
    for (int k = 0; k < d; k += 4) {
      float4 a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(it.es + rows[i] * s + k);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 b =
            *reinterpret_cast<const float4*>(it.gs + cols[j] * s + k);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][j] = fmaf(a[i].x, b.x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b.y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, b.z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, b.w, acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (ti + nt * i < T && tj + nt * j < T)
          it.L[(ti + nt * i) * ld + tj + nt * j] = acc[i][j];
  }
}

// Log-sum-exp of the T entries x[j * step], over the kLanes lanes of this
// group; every lane of the group returns the same bits. A lane's entries
// j = lane + kLanes * (4 q + p) feed partial chain p, so four loads and
// four expf are in flight at a time. `first` is the first index that
// reaches the max (JAX's first-max rule, pallas_ops.py:128-141).
__device__ float line_lse(const float* x, int step, int T, int& first) {
  const int lane = threadIdx.x % kLanes;
  float m[4];
  int arg[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    m[p] = -INFINITY;
    arg[p] = INT_MAX;
  }
  for (int j0 = lane; j0 < T; j0 += 4 * kLanes)
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int j = j0 + p * kLanes;
      const float v = j < T ? x[j * step] : -INFINITY;
      if (v > m[p]) {
        m[p] = v;
        arg[p] = j;
      }
    }
  float mx = m[0];
  int at = arg[0];
#pragma unroll
  for (int p = 1; p < 4; ++p)
    if (m[p] > mx || (m[p] == mx && arg[p] < at)) {
      mx = m[p];
      at = arg[p];
    }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off /= 2) {
    const float mo = __shfl_xor_sync(0xffffffffu, mx, off);
    const int ao = __shfl_xor_sync(0xffffffffu, at, off);
    if (mo > mx || (mo == mx && ao < at)) {
      mx = mo;
      at = ao;
    }
  }
  float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int j0 = lane; j0 < T; j0 += 4 * kLanes)
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int j = j0 + p * kLanes;  // expf(-inf) adds an exact 0
      part[p] += expf((j < T ? x[j * step] : -INFINITY) - mx);
    }
  float sum = (part[0] + part[1]) + (part[2] + part[3]);
#pragma unroll
  for (int off = kLanes / 2; off > 0; off /= 2)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  first = at;
  return mx + logf(sum);
}

// Every row and column of the item, a group of kLanes lanes per line. The
// loop runs the same trips on every lane of a warp, so the shuffles always
// have the whole warp; a group past the end redoes a real line and stores
// nothing. fwd: aux = T row terms, T column terms, T hits; bwd: aux = T
// row and T column log-sum-exps.
__device__ void lines(const Item& it, int T, bool fwd) {
  const int groups = 32 / kLanes, ld = logit_stride(T);
  const int warp = threadIdx.x / 32, n_warps = blockDim.x / 32;
  for (int base = warp * groups; base < 2 * T; base += n_warps * groups) {
    const int line = base + (threadIdx.x % 32) / kLanes;
    const bool valid = line < 2 * T;
    const int q = valid ? line : base;
    const bool col = q >= T;
    const int idx = col ? q - T : q;
    int first;
    const float lse = line_lse(it.L + (col ? idx : idx * ld), col ? ld : 1,
                               T, first);
    if (!valid || threadIdx.x % kLanes != 0) continue;
    if (fwd) {
      it.aux[q] = lse - it.L[idx * ld + idx];
      if (!col) it.aux[2 * T + idx] = first == idx ? 1.0f : 0.0f;
    } else {
      it.aux[q] = lse;
    }
  }
}

// Grid (cluster size, C), one cluster per config; CTA `rank` takes items
// rank, rank + size, ... and writes each one's loss and hit count into
// rank 0's shared memory (a remote store does not wait), where rank 0 sums
// them in item order after one cluster barrier.
__global__ void __launch_bounds__(kThreads)
    contrastive_loss_fwd_kernel(const float* __restrict__ e,
                                const float* __restrict__ g,
                                float* __restrict__ out, int C, int N, int T,
                                int d, bool async) {
  extern __shared__ __align__(16) float sm[];
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int size = (int)cluster.num_blocks();
  const int c = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Item it = item_at(sm, T, d);
  float* items = sm + item_floats(T, d);  // (2, N): loss, hits; rank 0's
  float* items0 = cluster.map_shared_rank(items, 0);
  for (int n = rank; n < N; n += size) {
    stage(e, g, it, (size_t)c * N + n, T, d, async);
    __syncthreads();
    logits(it, T, d);
    __syncthreads();
    lines(it, T, true);
    __syncthreads();
    if (warp == 0) {  // the item's 2T terms and T hits, by a fixed tree
      float t = 0.0f, h = 0.0f;
      for (int q = lane; q < 2 * T; q += 32) t += it.aux[q];
      for (int q = lane; q < T; q += 32) h += it.aux[2 * T + q];
#pragma unroll
      for (int off = 16; off > 0; off /= 2) {
        t += __shfl_xor_sync(0xffffffffu, t, off);
        h += __shfl_xor_sync(0xffffffffu, h, off);
      }
      if (lane == 0) {
        items0[n] = t / (2.0f * T);
        items0[N + n] = h;
      }
    }
    __syncthreads();  // the next item overwrites this one
  }
  cluster.sync();  // every item's loss has reached rank 0
  if (rank == 0 && threadIdx.x == 0) {
    float loss = 0.0f, correct = 0.0f;
    for (int n = 0; n < N; ++n) {  // item index order
      loss += items[n];
      correct += items[N + n];
    }
    out[c] = loss / (float)N;
    out[C + c] = correct;
  }
}

// Grid (N, C), one CTA per item.
__global__ void __launch_bounds__(kThreads)
    contrastive_loss_bwd_kernel(const float* __restrict__ e,
                                const float* __restrict__ g,
                                const float* __restrict__ dloss,
                                float* __restrict__ de,
                                float* __restrict__ dg, int N, int T, int d,
                                bool async) {
  extern __shared__ __align__(16) float sm[];
  const int n = blockIdx.x, c = blockIdx.y;
  const size_t item = (size_t)c * N + n;
  const int s = row_stride(d), ld = logit_stride(T);
  const Item it = item_at(sm, T, d);
  stage(e, g, it, item, T, d, async);
  __syncthreads();
  logits(it, T, d);
  __syncthreads();
  lines(it, T, false);
  __syncthreads();
  // dlogits, a warp per row and a lane per column
  const float inv = __frcp_rn(2.0f * T * N);
  const int lane = threadIdx.x % 32;
  for (int r = threadIdx.x / 32; r < T; r += blockDim.x / 32) {
    const float lse_r = it.aux[r];
    for (int cc = lane; cc < T; cc += 32) {
      const float l = it.L[r * ld + cc];
      const float eye = r == cc ? 1.0f : 0.0f;
      const float p_row = expf(l - lse_r);
      const float p_col = expf(l - it.aux[T + cc]);
      it.L[r * ld + cc] = (p_row - eye + p_col - eye) * inv;
    }
  }
  __syncthreads();
  // de = dl g, dg = dl^T e: a thread takes rows ti and ti + nh, columns
  // k .. k + 3 of one of them, each a chain over j in order
  const float up = dloss[c];
  const int nh = (T + 1) / 2, nk = (d + 3) / 4, tiles = nh * nk;
  for (int t = threadIdx.x; t < 2 * tiles; t += blockDim.x) {
    const bool grad_g = t >= tiles;
    const int tt = grad_g ? t - tiles : t;
    const int ti = tt / nk, k = 4 * (tt - ti * nk);
    const int r0 = ti, r1 = min(ti + nh, T - 1);
    const float* other = grad_g ? it.es : it.gs;
    // dl[r][j] for de, dl[j][r] for dg
    const int lr = grad_g ? 1 : ld, lj = grad_g ? ld : 1;
    float a0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, a1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
    for (int j = 0; j < T; ++j) {
      const float l0 = it.L[r0 * lr + j * lj], l1 = it.L[r1 * lr + j * lj];
      const float4 v = *reinterpret_cast<const float4*>(other + j * s + k);
      a0[0] = fmaf(l0, v.x, a0[0]);
      a0[1] = fmaf(l0, v.y, a0[1]);
      a0[2] = fmaf(l0, v.z, a0[2]);
      a0[3] = fmaf(l0, v.w, a0[3]);
      a1[0] = fmaf(l1, v.x, a1[0]);
      a1[1] = fmaf(l1, v.y, a1[1]);
      a1[2] = fmaf(l1, v.z, a1[2]);
      a1[3] = fmaf(l1, v.w, a1[3]);
    }
    float* dst = (grad_g ? dg : de) + item * T * d;
    for (int q = 0; q < 4 && k + q < d; ++q) {
      dst[r0 * d + k + q] = a0[q] * up;
      if (ti + nh < T) dst[r1 * d + k + q] = a1[q] * up;
    }
  }
}

__global__ void empty_kernel() {}

int check(int C, int N, int T, int d) {
  return C < 1 || C > kMaxC || N < 1 || N > kMaxN || T < 1 || T > kMaxT ||
                 d < 1 || d > kMaxD
             ? (int)cudaErrorInvalidValue
             : (int)cudaSuccess;
}

// Whether rows go by 16-byte cp.async: whole float4s, aligned arrays.
bool async_rows(const float* e, const float* g, int d) {
  return d % 4 == 0 && (reinterpret_cast<uintptr_t>(e) % 16) == 0 &&
         (reinterpret_cast<uintptr_t>(g) % 16) == 0;
}

int cluster_size(int N) { return N < kMaxCluster ? N : kMaxCluster; }

size_t fwd_smem(int N, int T, int d) {
  return sizeof(float) * ((size_t)item_floats(T, d) + 2 * (size_t)N);
}

size_t bwd_smem(int T, int d) {
  return sizeof(float) * (size_t)item_floats(T, d);
}

int allow(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return (int)cudaSuccess;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The forward's launch: a cluster of cluster_size(N) CTAs per config.
template <class... Params, class... Args>
int launch_fwd(void (*kernel)(Params...), int C, int N, size_t smem,
               void* stream, Args... args) {
  int rc = allow((const void*)kernel, smem);
  if (rc != 0) return rc;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster_size(N);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(cluster_size(N), C);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = (cudaStream_t)stream;
  config.attrs = attr;
  config.numAttrs = 1;
  rc = (int)cudaLaunchKernelEx(&config, kernel, args...);
  return rc != 0 ? rc : (int)cudaGetLastError();
}

}  // namespace

extern "C" int contrastive_loss_fwd_launch(const float* e, const float* g,
                                           float* out, int C, int N, int T,
                                           int d, void* stream) {
  const int rc = check(C, N, T, d);
  if (rc != 0) return rc;
  return launch_fwd(contrastive_loss_fwd_kernel, C, N, fwd_smem(N, T, d),
                    stream, e, g, out, C, N, T, d, async_rows(e, g, d));
}

extern "C" int contrastive_loss_bwd_launch(const float* e, const float* g,
                                           const float* dloss, float* de,
                                           float* dg, int C, int N, int T,
                                           int d, void* stream) {
  int rc = check(C, N, T, d);
  if (rc != 0) return rc;
  const size_t smem = bwd_smem(T, d);
  rc = allow((const void*)contrastive_loss_bwd_kernel, smem);
  if (rc != 0) return rc;
  contrastive_loss_bwd_kernel<<<dim3(N, C), kThreads, smem,
                                (cudaStream_t)stream>>>(
      e, g, dloss, de, dg, N, T, d, async_rows(e, g, d));
  return (int)cudaGetLastError();
}

// An empty kernel launched with the grid, block, cluster and shared memory
// of the forward (backward 0) or the backward (1) at this shape: the floor
// that launch latency alone sets.
extern "C" int contrastive_loss_floor_launch(int backward, int C, int N, int T,
                                             int d, void* stream) {
  int rc = check(C, N, T, d);
  if (rc != 0) return rc;
  if (!backward)
    return launch_fwd(empty_kernel, C, N, fwd_smem(N, T, d), stream);
  const size_t smem = bwd_smem(T, d);
  rc = allow((const void*)empty_kernel, smem);
  if (rc != 0) return rc;
  empty_kernel<<<dim3(N, C), kThreads, smem, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
