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
// two ints per (tick, session), and the masked scores where asked; the work
// per score is a compare.
//
// Design: nothing carries from one tick to the next. The vote at tick k
// depends only on the carried window votes_in (oldest first), n_seen_0 and
// preds k-W+1 .. k: n_seen_k = min(n_seen_0 + k + 1, W), and the window is
// the last W entries of [votes_in | preds_0 .. preds_k]. So one launch runs
// a grid of (session group, tick chunk) CTAs, each in two phases:
//   1. preds: a group of 8 lanes per (tick, session) reads the C-float row
//      (consecutive groups take consecutive sessions' rows, so a warp reads
//      contiguous memory), takes the masked first max by value, then index,
//      over lanes with __shfl_xor_sync, and writes the pred to shared
//      memory. A lane's classes are a compile-time number of slots (the
//      kernel is a template on a class bound: 48, which takes the config's
//      41 classes, or 128), so all its loads are in flight at once. A
//      chunk that does not start at tick 0 recomputes the W-1 preds before
//      it (a halo read of their scores); ticks before 0 come from
//      votes_in.
//   2. votes: a group per session fills a class histogram in shared memory
//      from the valid suffix of the chunk's first tick (shared atomics),
//      then walks the chunk's ticks, moving the counts by the pred that
//      enters the suffix and the one that leaves it; at each tick it takes
//      the first max of (count, or -1 for a masked class) as one key per
//      class, (count + 1) << 8 | (255 - class), reduced by max. (A recount
//      of the whole window per (tick, session) cost as much as phase 1 at
//      the batched shape.)
// Chunks are a whole recording where there are enough session groups to
// fill the card (each score read once), and 8 ticks where there are not,
// so that a long single-session replay spreads over many CTAs. No thread
// keeps a run-time-indexed array: the window and the counts live in shared
// memory.
//
// Layouts: scores (K, S, C) f32; masks (S, C) bool as bytes; votes (S, W)
// int32 (oldest first); n_seen (S,) int32; preds and vote outputs (K, S);
// the optional masked scores (K, S, C) f32 (null: not written).
#include <cfloat>
#include <climits>
#include <cmath>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxW = 64, kMaxC = 128;
constexpr int kThreads = 256, kLanes = 8;          // lanes per (tick, session)
constexpr int kGroups = kThreads / kLanes;         // 32 per CTA
constexpr int kMaxG = 32;                          // sessions per CTA
constexpr int kLongChunk = 32, kShortChunk = 8;    // ticks per CTA
constexpr int kFillCtas = 264;                     // 2 per SM of an H100

// CB: a bound on the class count (C <= CB), so that a lane's classes are a
// compile-time number of slots
template <int CB>
__global__ void __launch_bounds__(kThreads) vote_scan_kernel(
    const float* __restrict__ scores, const unsigned char* __restrict__ masks,
    const int* __restrict__ votes_in, const int* __restrict__ nseen_in,
    int* __restrict__ preds, int* __restrict__ vote_out,
    int* __restrict__ votes_out, int* __restrict__ nseen_out,
    float* __restrict__ masked_out, int K, int S, int C, int W, int chunk) {
  // spred[jj * ns + sl]: the pred of tick k0 - (W - 1) + jj, session s0 + sl
  __shared__ int spred[(kLongChunk + kMaxW - 1) * kMaxG];
  constexpr int kSlots = CB / kLanes;  // classes per lane
  __shared__ int hist[kGroups * CB];
  __shared__ unsigned char smask[kMaxG * CB];
  __shared__ int snseen[kMaxG];

  const int s0 = blockIdx.x * kMaxG, ns = min(kMaxG, S - s0);
  const int k0 = blockIdx.y * chunk, nt = max(0, min(chunk, K - k0));
  const int first = k0 - (W - 1);  // the tick of spred's row 0
  const int group = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;

  for (int i = threadIdx.x; i < ns * C; i += kThreads)
    smask[(i / C) * CB + i % C] = masks[(size_t)s0 * C + i];
  for (int sl = threadIdx.x; sl < ns; sl += kThreads)
    snseen[sl] = nseen_in[s0 + sl];
  // ---- 1. preds of ticks first .. k0 + nt - 1 (the halo, then the chunk);
  // halo ticks before 0 are the carried window's last entries
  const int carried = max(0, -first);  // rows of spred from votes_in
  for (int i = threadIdx.x; i < ns * carried; i += kThreads) {
    const int sl = i / carried, jj = i % carried;
    spred[jj * ns + sl] = votes_in[(size_t)(s0 + sl) * W + W + first + jj];
  }
  __syncthreads();

  const int n_pred = (nt + W - 1 - carried) * ns;
  for (int base = 0; base < n_pred; base += kGroups) {  // uniform per warp
    const int item = base + group;
    const int jj = carried + item / ns, sl = item % ns;
    const int j = first + jj, s = s0 + sl;  // j >= 0
    const bool computed = item < n_pred;
    float best = -INFINITY;
    int idx = INT_MAX;
    const float* row = scores + ((size_t)j * S + s) * C;
    // every load of the row in flight at once: a compile-time number of
    // slots, predicated on the class count (no loop-carried wait per class)
    float x[kSlots];
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int c = lane + i * kLanes;
      x[i] = computed && c < C ? row[c] : 0.0f;
    }
    if (computed) {
      const unsigned char* m = smask + sl * CB;
      float* out = (masked_out != nullptr && j >= k0)
                       ? masked_out + ((size_t)j * S + s) * C : nullptr;
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        const int c = lane + i * kLanes;
        if (c < C) {
          const float v = m[c] ? x[i] : -FLT_MAX;
          if (out != nullptr) out[c] = v;
          if (i == 0 || v > best) {  // a lane's classes in rising order
            best = v;
            idx = c;
          }
        }
      }
    }
#pragma unroll
    for (int o = kLanes / 2; o > 0; o /= 2) {  // first max over the group
      const float ov = __shfl_xor_sync(0xffffffffu, best, o);
      const int oi = __shfl_xor_sync(0xffffffffu, idx, o);
      if (ov > best || (ov == best && oi < idx)) {
        best = ov;
        idx = oi;
      }
    }
    if (computed && lane == 0) {
      spred[jj * ns + sl] = idx;
      if (j >= k0) preds[(size_t)j * S + s] = idx;
    }
  }
  __syncthreads();

  // ---- 2. votes of ticks k0 .. k0 + nt - 1: a group per session keeps the
  // class histogram of its window's valid suffix, counted once at tick k0,
  // then moved tick by tick by the pred that enters and the one that leaves
  static_assert(kGroups == kMaxG, "a group per session of the CTA");
  int* h = hist + group * CB;
  const bool live = group < ns && nt > 0;
  const int sl = group, s = s0 + sl;
  const int n0 = live ? snseen[sl] : 0;
#pragma unroll
  for (int i = 0; i < kSlots; ++i)
    if (live && lane + i * kLanes < C) h[lane + i * kLanes] = 0;
  __syncwarp();
  const int n_k0 = live ? min(n0 + k0 + 1, W) : 0;
  for (int t = lane; t < n_k0; t += kLanes) {  // tick k0's valid suffix
    const int cls = spred[(k0 - n_k0 + 1 + t - first) * ns + sl];
    if ((unsigned)cls < (unsigned)C) atomicAdd(&h[cls], 1);
  }
  for (int k = k0; k < k0 + nt; ++k) {  // uniform over the CTA
    if (k > k0 && live && lane == 0) {
      if (n0 + k >= W) {  // full at k-1 and at k: tick k-W leaves
        const int out = spred[(k - W - first) * ns + sl];
        if ((unsigned)out < (unsigned)C) --h[out];
      }
      if (n0 + k >= 0) {  // n_k >= 1: tick k enters
        const int in = spred[(k - first) * ns + sl];
        if ((unsigned)in < (unsigned)C) ++h[in];
      }
    }
    __syncwarp();
    unsigned key = 0;
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int c = lane + i * kLanes;
      if (live && c < C) {
        const int v = smask[sl * CB + c] ? h[c] : -1;
        key = max(key, ((unsigned)(v + 1) << 8) | (unsigned)(255 - c));
      }
    }
#pragma unroll
    for (int o = kLanes / 2; o > 0; o /= 2)
      key = max(key, __shfl_xor_sync(0xffffffffu, key, o));
    if (live && lane == 0)
      vote_out[(size_t)k * S + s] = 255 - (int)(key & 255u);
    __syncwarp();  // the counts are read before lane 0 moves them
  }

  // ---- 3. the outgoing window and n_seen, by the CTA of the last tick
  if (k0 + nt == K) {
    for (int i = threadIdx.x; i < ns * W; i += kThreads) {
      const int sl = i / W, t = i % W, s = s0 + sl, j = K - W + t;
      votes_out[(size_t)s * W + t] =  // spred holds them all unless K == 0
          j >= first ? spred[(j - first) * ns + sl]
                     : votes_in[(size_t)s * W + W + j];
    }
    for (int sl = threadIdx.x; sl < ns; sl += kThreads)
      nseen_out[s0 + sl] = K > 0 ? min(snseen[sl] + K, W) : snseen[sl];
  }
}

}  // namespace

extern "C" int vote_scan_launch(const float* scores,
                                const unsigned char* masks,
                                const int* votes_in, const int* nseen_in,
                                int* preds, int* vote_out, int* votes_out,
                                int* nseen_out, float* masked_out, int K,
                                int S, int C, int W, void* stream) {
  if (W < 1 || W > kMaxW || C < 1 || C > kMaxC || K < 0 || S < 0)
    return (int)cudaErrorInvalidValue;
  if (S == 0) return (int)cudaSuccess;
  const int groups = (S + kMaxG - 1) / kMaxG;
  const int chunk = groups >= kFillCtas ? kLongChunk : kShortChunk;
  const int chunks = K > 0 ? (K + chunk - 1) / chunk : 1;
  if (chunks > 65535) return (int)cudaErrorInvalidValue;
  // the config's 41 classes take the 48-class instance
  auto kernel = C <= 48 ? vote_scan_kernel<48> : vote_scan_kernel<kMaxC>;
  kernel<<<dim3(groups, chunks), kThreads, 0, (cudaStream_t)stream>>>(
      scores, masks, votes_in, nseen_in, preds, vote_out, votes_out,
      nseen_out, masked_out, K, S, C, W, chunk);
  return (int)cudaGetLastError();
}
