// vote_scan: subset-masked prediction and majority vote of the serve tick.
//
// Replaces: the per-tick tail of the TPU kernels
//   the JAX package's ops/pallas_ops.py::_tick_chain_kernel
//     (fused_tick_chain, pallas_ops.py:595-617) and
//   the JAX package's ops/pallas_ops.py::_batched_tick_chain_kernel
//     (fused_tick_chain_batched, pallas_ops.py:810-828),
//   which repeat serve/stream.py:268-284: scores masked with finfo(f32).min,
//   first-max argmax (smallest class on ties), vote window shifted,
//   n_seen = min(n_seen + 1, W), counts over the valid suffix, masked
//   classes set to -1, first-max vote.
//
// What bounds it on an H100: bytes. It reads K*S*C scores once and writes
// two ints per (tick, session); the work per score is a compare.
//
// Design: the vote window depends only on the per-tick preds, so after the
// encoder has scored every tick of the recording this is one pass with one
// thread per session walking its K ticks in order. The window is carried as
// class ids (the engine's StreamCarry layout), not the TPU kernel's one-hot
// rows, and the counts are a small per-thread histogram. Each thread reads
// its own contiguous C-float score row per tick; neighbouring threads'
// rows share cache lines, which L1 serves.
//
// Layouts: scores (K, S, C) f32; masks (S, C) bool as bytes; votes (S, W)
// int32 (oldest first); n_seen (S,) int32; preds and vote outputs (K, S).
#include <cfloat>
#include <climits>
#include <cmath>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxW = 64, kMaxC = 128;

__global__ void vote_scan_kernel(
    const float* __restrict__ scores, const unsigned char* __restrict__ masks,
    const int* __restrict__ votes_in, const int* __restrict__ nseen_in,
    int* __restrict__ preds, int* __restrict__ vote_out,
    int* __restrict__ votes_out, int* __restrict__ nseen_out, int K, int S,
    int C, int W) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const unsigned char* mask = masks + (size_t)s * C;
  int win[kMaxW];
  for (int t = 0; t < W; ++t) win[t] = votes_in[(size_t)s * W + t];
  int n_seen = nseen_in[s];
  int counts[kMaxC];

  for (int k = 0; k < K; ++k) {
    const float* row = scores + ((size_t)k * S + s) * C;
    float best = -INFINITY;
    int pred = 0;
    for (int c = 0; c < C; ++c) {
      const float v = mask[c] ? row[c] : -FLT_MAX;
      if (v > best) {
        best = v;
        pred = c;
      }
    }
    for (int t = 0; t + 1 < W; ++t) win[t] = win[t + 1];
    win[W - 1] = pred;
    n_seen = min(n_seen + 1, W);
    for (int c = 0; c < C; ++c) counts[c] = 0;
    for (int t = W - n_seen; t < W; ++t)
      if ((unsigned)win[t] < (unsigned)C) ++counts[win[t]];
    int vote = 0, top = INT_MIN;
    for (int c = 0; c < C; ++c) {
      const int v = mask[c] ? counts[c] : -1;
      if (v > top) {
        top = v;
        vote = c;
      }
    }
    preds[(size_t)k * S + s] = pred;
    vote_out[(size_t)k * S + s] = vote;
  }
  for (int t = 0; t < W; ++t) votes_out[(size_t)s * W + t] = win[t];
  nseen_out[s] = n_seen;
}

}  // namespace

extern "C" int vote_scan_launch(const float* scores,
                                const unsigned char* masks,
                                const int* votes_in, const int* nseen_in,
                                int* preds, int* vote_out, int* votes_out,
                                int* nseen_out, int K, int S, int C, int W,
                                void* stream) {
  if (W < 1 || W > kMaxW || C < 1 || C > kMaxC)
    return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const int grid = (S + threads - 1) / threads;
  if (grid > 0)
    vote_scan_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        scores, masks, votes_in, nseen_in, preds, vote_out, votes_out,
        nseen_out, K, S, C, W);
  return (int)cudaGetLastError();
}
