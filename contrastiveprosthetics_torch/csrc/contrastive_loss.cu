// contrastive_loss: the fused symmetric contrastive loss of a train step
// (forward) and its gradient (backward).
//
// Replaces: the JAX package's ops/pallas_ops.py::_pallas_loss_call
//   (K1f, pallas_ops.py:185; body _loss_kernel :145, per item _loss_item
//   :112) and ::_pallas_bwd_call (K1b, :213; body _bwd_kernel :169), tied
//   together by the custom VJP fused_contrastive_loss (:1034-1057).
//
// What it computes, per item n of N, with e, g (T, d) L2-normalized:
//   logits = e g^T (T, T);
//   loss_n = (sum_r (lse_row_r - logits_rr) + sum_c (lse_col_c - logits_cc))
//            / (2T),  loss = mean_n loss_n;
//   correct = number of rows whose first maximum is the diagonal;
//   backward: dlogits = (softmax_row - I + softmax_col - I) / (2T N),
//   de = dlogits g * dloss, dg = dlogits^T e * dloss.
//
// What bounds it on an H100: neither bytes nor operations. At the train
// step's shape (N=8, T=41, d=16) it reads 42 KB and does ~0.9 MFLOP, a
// bound of about 0.01 ms, far below one launch's latency. So the design
// keeps each direction to one launch and every intermediate on chip.
//
// Design: one block per item. The block stages its item's e and g in
// shared memory, computes the T x T logits there (each one a sequential
// fmaf chain over d), then 64 threads take the row log-sum-exps and 64
// the column ones at the same time (max first, then expf/logf: no fast
// math). The TPU kernel summed the scalars in SMEM across its sequential
// grid; blocks here run in no order, so each block writes its item's loss
// and count to an (N,) scratch, and the last block to finish (an integer
// ticket, no float atomics) sums the N items in index order and divides
// by N. Two runs give the same bits, and N is any batch size, the smaller
// tail batch included: nothing is padded. The backward recomputes the
// logits, overwrites them with dlogits, and reads the upstream scalar from
// device memory, so it never syncs with the host.
//
// Layouts: e, g, de, dg (N, T, d) f32 contiguous; items (2, N) f32 scratch;
// ticket one uint32 that is 0 at launch; out (2,) f32 = (loss, correct).
#include <cmath>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxT = 64, kMaxD = 64, kThreads = 2 * kMaxT;

__host__ __device__ constexpr int shared_floats(int T, int d) {
  // e, g; logits with a padded row; lse_r, lse_c, term_r, term_c, hit
  return 2 * T * d + T * (T + 1) + 5 * T;
}

// Stage item n's e and g, then logits L[r*(T+1)+c] = e_r . g_c.
__device__ void item_logits(const float* __restrict__ e,
                            const float* __restrict__ g, float* es, float* gs,
                            float* L, int n, int T, int d) {
  const size_t base = (size_t)n * T * d;
  for (int i = threadIdx.x; i < T * d; i += blockDim.x) {
    es[i] = e[base + i];
    gs[i] = g[base + i];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < T * T; i += blockDim.x) {
    const int r = i / T, c = i % T;
    float acc = 0.0f;
    for (int k = 0; k < d; ++k) acc = fmaf(es[r * d + k], gs[c * d + k], acc);
    L[r * (T + 1) + c] = acc;
  }
  __syncthreads();
}

// Threads [0, T) reduce rows, [kMaxT, kMaxT + T) columns: log-sum-exp
// with the max subtracted first; rows also find their first maximum.
__device__ void log_sum_exps(const float* L, int T, float* lse_r,
                             float* lse_c, float* hit) {
  const int t = threadIdx.x;
  const int ld = T + 1;
  if (t < T) {
    float m = -INFINITY;
    int arg = 0;
    for (int c = 0; c < T; ++c) {
      const float v = L[t * ld + c];
      if (v > m) {
        m = v;
        arg = c;
      }
    }
    float s = 0.0f;
    for (int c = 0; c < T; ++c) s += expf(L[t * ld + c] - m);
    lse_r[t] = m + logf(s);
    hit[t] = arg == t ? 1.0f : 0.0f;
  } else if (t >= kMaxT && t < kMaxT + T) {
    const int c = t - kMaxT;
    float m = -INFINITY;
    for (int r = 0; r < T; ++r) m = fmaxf(m, L[r * ld + c]);
    float s = 0.0f;
    for (int r = 0; r < T; ++r) s += expf(L[r * ld + c] - m);
    lse_c[c] = m + logf(s);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
    contrastive_loss_fwd_kernel(const float* __restrict__ e,
                                const float* __restrict__ g,
                                float* __restrict__ items,
                                unsigned* __restrict__ ticket,
                                float* __restrict__ out, int N, int T, int d) {
  extern __shared__ float sm[];
  float* es = sm;
  float* gs = es + T * d;
  float* L = gs + T * d;
  float* lse_r = L + T * (T + 1);
  float* lse_c = lse_r + T;
  float* hit = lse_c + T;
  const int n = blockIdx.x;
  item_logits(e, g, es, gs, L, n, T, d);
  log_sum_exps(L, T, lse_r, lse_c, hit);
  if (threadIdx.x != 0) return;
  float rows = 0.0f, cols = 0.0f, correct = 0.0f;
  for (int i = 0; i < T; ++i) {
    const float diag = L[i * (T + 1) + i];
    rows += lse_r[i] - diag;
    cols += lse_c[i] - diag;
    correct += hit[i];
  }
  items[n] = (rows + cols) / (2.0f * T);
  items[N + n] = correct;
  __threadfence();  // this item's results reach device memory first
  if (atomicAdd(ticket, 1u) != (unsigned)(N - 1)) return;
  // the last block: every item is written; sum them in index order
  const volatile float* vitems = items;
  float loss = 0.0f, total = 0.0f;
  for (int i = 0; i < N; ++i) {
    loss += vitems[i];
    total += vitems[N + i];
  }
  out[0] = loss / (float)N;
  out[1] = total;
}

__global__ void __launch_bounds__(kThreads)
    contrastive_loss_bwd_kernel(const float* __restrict__ e,
                                const float* __restrict__ g,
                                const float* __restrict__ dloss,
                                float* __restrict__ de,
                                float* __restrict__ dg, int N, int T, int d) {
  extern __shared__ float sm[];
  float* es = sm;
  float* gs = es + T * d;
  float* L = gs + T * d;
  float* lse_r = L + T * (T + 1);
  float* lse_c = lse_r + T;
  float* hit = lse_c + T;
  const int n = blockIdx.x;
  const int ld = T + 1;
  item_logits(e, g, es, gs, L, n, T, d);
  log_sum_exps(L, T, lse_r, lse_c, hit);
  const float denom = 2.0f * T * N;
  for (int i = threadIdx.x; i < T * T; i += blockDim.x) {
    const int r = i / T, c = i % T;
    const float l = L[r * ld + c];
    const float eye = r == c ? 1.0f : 0.0f;
    const float p_row = expf(l - lse_r[r]);
    const float p_col = expf(l - lse_c[c]);
    L[r * ld + c] = (p_row - eye + p_col - eye) / denom;
  }
  __syncthreads();
  const float up = *dloss;
  const size_t base = (size_t)n * T * d;
  for (int i = threadIdx.x; i < T * d; i += blockDim.x) {
    const int r = i / d, k = i % d;
    float acc_e = 0.0f, acc_g = 0.0f;
    for (int j = 0; j < T; ++j) {
      acc_e = fmaf(L[r * ld + j], gs[j * d + k], acc_e);  // (dl g)[r, k]
      acc_g = fmaf(L[j * ld + r], es[j * d + k], acc_g);  // (dl^T e)[r, k]
    }
    de[base + i] = acc_e * up;
    dg[base + i] = acc_g * up;
  }
}

int prepare(const void* kernel, int N, int T, int d, size_t* smem) {
  if (N < 1 || T < 1 || T > kMaxT || d < 1 || d > kMaxD)
    return (int)cudaErrorInvalidValue;
  *smem = sizeof(float) * (size_t)shared_floats(T, d);
  if (*smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  return (int)cudaSuccess;
}

}  // namespace

extern "C" int contrastive_loss_fwd_launch(const float* e, const float* g,
                                           float* items, unsigned* ticket,
                                           float* out, int N, int T, int d,
                                           void* stream) {
  size_t smem = 0;
  const int rc =
      prepare((const void*)contrastive_loss_fwd_kernel, N, T, d, &smem);
  if (rc != 0) return rc;
  contrastive_loss_fwd_kernel<<<N, kThreads, smem, (cudaStream_t)stream>>>(
      e, g, items, ticket, out, N, T, d);
  return (int)cudaGetLastError();
}

extern "C" int contrastive_loss_bwd_launch(const float* e, const float* g,
                                           const float* dloss, float* de,
                                           float* dg, int N, int T, int d,
                                           void* stream) {
  size_t smem = 0;
  const int rc =
      prepare((const void*)contrastive_loss_bwd_kernel, N, T, d, &smem);
  if (rc != 0) return rc;
  contrastive_loss_bwd_kernel<<<N, kThreads, smem, (cudaStream_t)stream>>>(
      e, g, dloss, de, dg, N, T, d);
  return (int)cudaGetLastError();
}
