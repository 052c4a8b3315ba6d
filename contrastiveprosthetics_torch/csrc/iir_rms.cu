// iir_rms_frames: the ingest's and the calibration's band-pass and RMS.
//
// Replaces: no Pallas kernel. The JAX package leaves this work to XLA:
//   the JAX package's ops/signal.py::sosfilt (a lax.scan over samples,
//   :65) and ops/signal.py::moving_rms (:128), as preprocess_segment
//   (:149) runs them for ingest (vmapped over a subject's segments,
//   data/ingest.py:63-84) and serve/stream.py::preprocess_recording for
//   calibration (:356-366), each followed by a downsample; and the host's
//   segment extraction before it (data/ingest.py:44-60, a boolean mask per
//   (stimulus, repetition) over each recording).
// It computes, from zero filter state, independently for each (b, d):
//   xb[t] = x[rows[b, t], d] with a row table, else x[b, t, d]
//   y = sosfilt(sos, prescale * xb)   (transposed direct form II)
//   frames[b, f, d] = sqrt(sum_{k < W} y[f * stride + k]^2 / W), f < n_frames
// i.e. the valid-mode leading-window RMS at every stride-th start.
//
// What bounds it on an H100: at the corpus (11,316 segments x 2,010
// samples x 12 channels, 1.09 GB read) the bytes, 0.34 ms at 3.35 TB/s,
// and close behind them the issue rate: every lane issues ~14 instructions
// a step. At one subject (246 segments: 369 warps for 528 schedulers) or
// one calibration recording (1 segment) the recurrence: a section's state
// update is a loop-carried line of 4 dependent f32 operations a sample
// (z0 -> yk -> a1*yk -> - -> + z1).
//
// Design:
// - Four lanes per (segment, channel) chain, lane j runs section j, skewed:
//   at step s lane j filters sample s - kSkew * j. Its input is lane j-1's
//   output of kSkew steps before, passed by __shfl_up_sync within the
//   chain's 4 lanes, so the loop-carried path of a step is one section's 4
//   operations, not the cascade's 16. kSkew is 2, not 1: a shuffle's result
//   is used one step after it is issued, so its latency stays off that
//   path; and lane 0's sample is chosen by an explicit select, so no write
//   waits for the shuffle (see select_f32). Before its first sample a lane
//   filters zeros from zero state, which leaves its state zero (up to the
//   sign of zero, and only squares reach the frames), so the skew's
//   prologue is exact.
// - A CTA takes kSegs = 2 segments: 24 chains x 4 lanes = 96 threads, 3
//   warps. One subject's 246 segments are 123 CTAs, one per SM and a warp
//   per scheduler on 3 of its 4; a calibration recording is one CTA.
// - The input is staged in shared memory, a ring of kStages chunks of
//   kChunk steps loaded by 16-byte cp.async copies ahead of the recurrence
//   (a sample's 12 channels are three copies). With a row table, sample t
//   of segment b is row rows[b, t] of a recording x (N, D): the table's
//   entries for a chunk are loaded into registers a chunk before its copies
//   are issued, so no thread waits on an index. A row outside [0, N) is
//   read as zeros (the wrapper refuses such a table before the launch).
// - The last lane squares its output and writes each window's sum into a
//   small ring in shared memory; after each chunk's barrier the CTA takes
//   the roots of every (segment, frame) row the chunk finished and stores
//   it as three 16-byte stores, so no division or root (and no branch of
//   theirs) sits among the recurrence's instructions.
// - The kernel is a template on the stride. At STRIDE = 20 (ingest and
//   calibration) a chunk is a whole number of strides and windows do not
//   overlap, so once the chunk's steps unroll, each step's part (in a
//   window, a frame's last sample, neither) is fixed at compile time and a
//   window's squares are added as they come, oldest first: no per-sample
//   test and no shift line. STRIDE = 0 takes any stride (1 for the compat
//   mask): the last W squares in a register shift line, and a frame when
//   the last lane reaches the next frame's last sample.
// The filter runs only as far as the last frame's window needs. The
// arithmetic uses explicit round-to-nearest intrinsics (no FMA
// contraction) in the plain version's order: yk = b0*y + z0;
// z0' = b1*y - a1*yk + z1; z1' = b2*y - a2*yk; each window's squares summed
// oldest first; rms = sqrt(sum / W). Frames equal the plain version's on
// the card bit for bit.
//
// Layouts (f32 and int32, contiguous): x (N, D) with rows (B, T), or
// x (B, T, D) without; x and frames 16-byte aligned; sos (n_sec, 6);
// frames (B, n_frames, D).
#include <cuda_runtime.h>

#include "tf32_mma.cuh"  // cp_async16/commit/wait, select_f32, in_register

namespace {

// the instantiated (n_sec, rms_window, D): the config's
constexpr int kNSec = 4, kRmsW = 11, kD = 12;
constexpr int kSegs = 2;                          // segments per CTA
constexpr int kThreads = kSegs * kD * kNSec;      // 96
constexpr int kSkew = 2;  // steps from lane j to j+1: one value pending
constexpr int kLag = kSkew * (kNSec - 1);         // the last lane's delay
constexpr int kChunk = 80;                        // steps per ring chunk
constexpr int kStages = 3;                        // chunks in the ring
constexpr int kCopies = kSegs * kChunk * kD / 4;  // 16-byte copies a chunk
constexpr int kCopiesPerThread = kCopies / kThreads;
static_assert(kCopies % kThreads == 0, "a chunk's copies spread evenly");
static_assert(kChunk >= kLag + kRmsW - 1, "chunk 0 holds the first frame");

template <int STRIDE>
__global__ void __launch_bounds__(kThreads) iir_rms_frames_kernel(
    const float* __restrict__ x, const int* __restrict__ rows,
    const float* __restrict__ sos, float* __restrict__ frames, int N, int B,
    int T, int stride, int n_frames, float prescale) {
  static_assert(STRIDE == 0 || (STRIDE >= kRmsW && kChunk % STRIDE == 0),
                "a fixed stride: whole strides a chunk, windows apart");
  // frames a chunk can finish, at most; the output ring holds two chunks'
  constexpr int kStride = STRIDE ? STRIDE : 1;
  constexpr int kOut = 2 * kChunk / kStride;
  __shared__ __align__(16) float ring[kStages][kSegs][kChunk][kD];
  __shared__ __align__(16) float outs[kOut][kSegs][kD];

  const int tid = threadIdx.x;
  const int lane = tid % kNSec;  // the section this thread runs
  const int seg = tid / kNSec / kD, d = tid / kNSec % kD;
  const int b_first = blockIdx.x * kSegs;
  const int t_end = (n_frames - 1) * stride + kRmsW;  // samples the frames use
  const int n_chunks = (t_end + kLag + kChunk - 1) / kChunk;

  // the rows of x this thread copies for a chunk (-1: none, zeros)
  int src[kCopiesPerThread];
  auto rows_of = [&](int c) {
#pragma unroll
    for (int k = 0; k < kCopiesPerThread; ++k) {
      const int q = tid + k * kThreads;  // = (s * kChunk + i) * 3 + part
      const int s = q / (3 * kChunk), t = c * kChunk + q / 3 % kChunk;
      int r = -1;
      if (b_first + s < B && t < t_end) {
        const long long o = (long long)(b_first + s) * T + t;
        r = rows ? rows[o] : (int)o;
      }
      src[k] = r;
    }
  };
  auto stage = [&](int c) {  // chunk c into ring slot c % kStages
    if (c < n_chunks) {
      float* slot = &ring[c % kStages][0][0][0];
#pragma unroll
      for (int k = 0; k < kCopiesPerThread; ++k) {
        const int q = tid + k * kThreads;
        const bool ok = src[k] >= 0 && src[k] < N;
        cp_async16(slot + (q / 3) * kD + (q % 3) * 4,
                   x + (ok ? (size_t)src[k] * kD + (q % 3) * 4 : 0), ok);
      }
    }
    cp_async_commit();  // one group per chunk, empty past the end
  };
  int f = 0, flushed = 0;  // frames' sums written into outs, and stored
  auto flush = [&]() {  // frames [flushed, f) as 16-byte stores of rows
    const int last = min(f, n_frames);
    for (int q = tid; q < (last - flushed) * kSegs * 3; q += kThreads) {
      const int part = q % 3, s = q / 3 % kSegs, fr = flushed + q / 3 / kSegs;
      if (b_first + s < B) {
        float4 v =
            *reinterpret_cast<const float4*>(&outs[fr % kOut][s][part * 4]);
        v.x = __fsqrt_rn(__fdiv_rn(v.x, (float)kRmsW));
        v.y = __fsqrt_rn(__fdiv_rn(v.y, (float)kRmsW));
        v.z = __fsqrt_rn(__fdiv_rn(v.z, (float)kRmsW));
        v.w = __fsqrt_rn(__fdiv_rn(v.w, (float)kRmsW));
        *reinterpret_cast<float4*>(
            frames + ((size_t)(b_first + s) * n_frames + fr) * kD + part * 4) =
            v;
      }
    }
    flushed = last;
  };

#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    rows_of(c);
    stage(c);
  }
  rows_of(kStages - 1);

  const float ps = in_register(prescale);
  const float b0 = sos[6 * lane + 0], b1 = sos[6 * lane + 1],
              b2 = sos[6 * lane + 2], a1 = sos[6 * lane + 4],
              a2 = sos[6 * lane + 5];
  float z0 = 0.0f, z1 = 0.0f;
  float prev = 0.0f;  // this lane's output of the last step
  float pend = 0.0f;  // lane j-1's output for this lane's next sample
  float acc = 0.0f;   // STRIDE > 0: the open window's sum of squares
  float sq[kRmsW];    // STRIDE == 0: the last lane's last W squares
#pragma unroll
  for (int k = 0; k < kRmsW; ++k) sq[k] = 0.0f;
  int next = kRmsW - 1;  // STRIDE == 0: the sample that ends frame f

#pragma unroll 1
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kStages - 2>();  // this thread's copies of chunk c landed
    __syncthreads();  // everyone's; chunk c-1 read and its frames in outs
    flush();
    stage(c + kStages - 1);  // into chunk c-1's slot
    rows_of(c + kStages);
    const float* xin = &ring[c % kStages][seg][0][d];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const float up = __shfl_up_sync(0xffffffffu, prev, 1, kNSec);
      const float y = select_f32(lane == 0, __fmul_rn(xin[i * kD], ps), pend);
      pend = up;
      const float yk = __fadd_rn(__fmul_rn(b0, y), z0);
      z0 = __fadd_rn(__fsub_rn(__fmul_rn(b1, y), __fmul_rn(a1, yk)), z1);
      z1 = __fsub_rn(__fmul_rn(b2, y), __fmul_rn(a2, yk));
      prev = yk;
      // the last lane is at sample c * kChunk + i - kLag
      if (STRIDE > 0) {  // i's place in its stride, fixed once unrolled
        const int rel = ((i - kLag) % kStride + kStride) % kStride;
        if (rel < kRmsW) {
          const float s2 = __fmul_rn(yk, yk);
          acc = rel == 0 ? s2 : __fadd_rn(acc, s2);
        }
        if (rel == kRmsW - 1 && (c > 0 || i >= kLag + kRmsW - 1)) {
          if (lane == kNSec - 1) outs[f % kOut][seg][d] = acc;
          ++f;  // past n_frames too: flush stores no more than n_frames
        }
      } else {
#pragma unroll
        for (int k = 0; k < kRmsW - 1; ++k) sq[k] = sq[k + 1];
        sq[kRmsW - 1] = __fmul_rn(yk, yk);
        if (c * kChunk + i - kLag == next) {  // the same for every thread
          acc = sq[0];
#pragma unroll
          for (int k = 1; k < kRmsW; ++k) acc = __fadd_rn(acc, sq[k]);
          if (lane == kNSec - 1) outs[f % kOut][seg][d] = acc;
          ++f;
          next += stride;
        }
      }
    }
  }
  __syncthreads();
  flush();
  cp_async_wait<0>();
}

// The card's latency of one dependent f32 add, for the recurrence floor
// reported beside iir_rms_frames: one thread runs n dependent __fadd_rn
// (n a multiple of 16) and records the SM cycles they took.
__global__ void fadd_latency_kernel(float* v, long long* cycles, int n) {
  float a = v[0];
  const float step = v[1];
  const long long t0 = clock64();
#pragma unroll 1
  for (int i = 0; i < n; i += 16) {
#pragma unroll
    for (int k = 0; k < 16; ++k) a = __fadd_rn(a, step);
  }
  const long long t1 = clock64();
  v[0] = a;
  cycles[0] = t1 - t0;
}

}  // namespace

extern "C" int iir_rms_frames_launch(const float* x, const int* rows,
                                     const float* sos, float* frames, int N,
                                     int B, int T, int D, int n_sec,
                                     int rms_window, int stride,
                                     int n_frames, float prescale,
                                     void* stream) {
  if (n_sec != kNSec || rms_window != kRmsW || D != kD || N < 0 || B < 0 ||
      T < 0 || stride < 1 || n_frames < 0)
    return (int)cudaErrorInvalidValue;
  if (!rows && (long long)B * T != N)
    return (int)cudaErrorInvalidValue;  // without a table x is (B, T, D)
  if (n_frames > 0 &&
      (long long)(n_frames - 1) * stride + rms_window > (long long)T)
    return (int)cudaErrorInvalidValue;  // a frame's window past the end
  if (((reinterpret_cast<size_t>(x) | reinterpret_cast<size_t>(frames)) &
       15) != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || n_frames == 0) return (int)cudaSuccess;
  const int grid = (B + kSegs - 1) / kSegs;
  if (stride == 20) {
    auto kernel = iir_rms_frames_kernel<20>;
    kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        x, rows, sos, frames, N, B, T, stride, n_frames, prescale);
  } else {
    auto kernel = iir_rms_frames_kernel<0>;
    kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        x, rows, sos, frames, N, B, T, stride, n_frames, prescale);
  }
  return (int)cudaGetLastError();
}

extern "C" int fadd_latency_launch(float* v, long long* cycles, int n,
                                   void* stream) {
  if (n < 16 || n % 16 != 0) return (int)cudaErrorInvalidValue;
  fadd_latency_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(v, cycles, n);
  return (int)cudaGetLastError();
}
