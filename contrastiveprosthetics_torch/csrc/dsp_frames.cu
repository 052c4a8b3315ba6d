// dsp_frames: the streaming DSP front end of the serve tick chain.
//
// Replaces: the per-sample part of the TPU kernels
//   the JAX package's ops/pallas_ops.py::_tick_chain_kernel
//     (fused_tick_chain, pallas_ops.py:544-586) and
//   the JAX package's ops/pallas_ops.py::_batched_tick_chain_kernel
//     (fused_tick_chain_batched, pallas_ops.py:772-799):
//   x2^10 prescale -> 4-section SOS band-pass in transposed direct form II
//   -> trailing window-11 RMS at each 20-sample block end -> (x-mean)/std.
//
// What bounds it on an H100: bytes at many sessions. Each (session,
// channel) lane reads K*factor raw samples once and writes K frames, 37
// flops per 4-byte sample (~9 flop/byte), below the card's 20 flop/byte f32
// balance point (67 TFLOP/s over 3.35 TB/s). At one session it is the
// recurrence itself: each sample's 4 sections form one dependent chain.
//
// Design: the IIR/RMS state depends only on the raw input, so a recording
// is one pass. A CTA takes up to kSessions sessions; one thread per
// (session, channel) runs that channel's IIR over every sample in order,
// with the coefficients and state in registers. The CTA stages its
// sessions' upcoming ticks into shared memory ahead of the recurrence with
// 16-byte cp.async copies, in a ring of kStages chunks (a (tick, session)
// block is factor*D contiguous floats, so a chunk is a few contiguous
// runs); at one session the whole CTA copies while 12 threads run the
// chains. The recurrence reads only shared memory and writes each tick's
// last rms_window filtered samples back in place. After each chunk, every
// thread of the CTA takes (tick, session, channel) frames from those
// samples in parallel and stores them coalesced. The kernel is a template
// on (n_sec, factor, rms_window, D), so every loop over sections, samples
// and the RMS window has a compile-time bound and unrolls: no array lives
// in local memory. The launcher takes the config's (4, 20, 11, 12) and
// refuses any other. The arithmetic uses explicit round-to-nearest
// intrinsics (no FMA contraction) in the plain version's operation order:
// yk = b0*y + z0; z0' = b1*y - a1*yk + z1; z1' = b2*y - a2*yk; the RMS sum
// in window order; rms = sqrt(sum / window). Frames, IIR state and tail
// equal the plain version's on the card bit for bit.
//
// Layouts (all f32, contiguous): blocks (K, S, factor, D), 16-byte
// aligned; iir (S, n_sec, 2, D); tail (S, rms_window-1, D); sos (n_sec, 6);
// mean, std (D,); frames (K, S, D).
#include <cuda_runtime.h>

#include "tf32_mma.cuh"  // cp_async16, cp_async_commit, cp_async_wait

namespace {

constexpr int kThreads = 128;
constexpr int kSessions = 10;      // per CTA: 120 chain threads of 128
constexpr int kStages = 3;         // chunks in the ring
constexpr int kChunkBlocks = 8;    // (tick, session) blocks per chunk, at least

template <int NSEC, int FACTOR, int RMSW, int D>
__global__ void __launch_bounds__(kThreads) dsp_frames_kernel(
    const float* __restrict__ blocks, const float* __restrict__ iir_in,
    const float* __restrict__ tail_in, const float* __restrict__ sos,
    const float* __restrict__ mean, const float* __restrict__ std_,
    float* __restrict__ frames, float* __restrict__ iir_out,
    float* __restrict__ tail_out, int K, int S, int chunk, float prescale) {
  static_assert(FACTOR >= RMSW, "a frame's window lies inside its tick");
  static_assert((FACTOR * D) % 4 == 0, "a (tick, session) block is whole "
                                       "16-byte vectors");
  constexpr int kBlock = FACTOR * D;  // floats of one (tick, session) block
  constexpr int kVec = kBlock / 4;
  constexpr int R = RMSW - 1;
  extern __shared__ __align__(16) float smem[];

  const int s0 = blockIdx.x * kSessions, ns = min(kSessions, S - s0);
  const int tid = threadIdx.x;
  const int slot_floats = chunk * ns * kBlock;
  const int n_chunks = (K + chunk - 1) / chunk;

  // chunk c's ticks, sessions s0 .. s0+ns-1 into ring slot c % kStages
  auto stage = [&](int c) {
    if (c < n_chunks) {
      const int k0 = c * chunk, nt = min(chunk, K - k0);
      float* dst = smem + (c % kStages) * slot_floats;
      const int per_tick = ns * kVec;
      for (int v = tid; v < nt * per_tick; v += kThreads) {
        const int t = v / per_tick, r = v % per_tick;
        const float* src =
            blocks + ((size_t)(k0 + t) * S + s0) * kBlock + (size_t)r * 4;
        cp_async16(dst + t * ns * kBlock + r * 4, src, true);
      }
    }
    cp_async_commit();  // one group per chunk, empty past the end
  };
  for (int c = 0; c < kStages - 1; ++c) stage(c);

  // the chain thread of (session s0 + sl, channel d), if this is one
  const bool chain = tid < ns * D;
  const int sl = tid / D, d = tid % D;
  float b0[NSEC], b1[NSEC], b2[NSEC], a1[NSEC], a2[NSEC], z0[NSEC], z1[NSEC];
  if (chain) {
    const float* z_in = iir_in + (size_t)(s0 + sl) * NSEC * 2 * D + d;
#pragma unroll
    for (int j = 0; j < NSEC; ++j) {
      b0[j] = sos[6 * j + 0];
      b1[j] = sos[6 * j + 1];
      b2[j] = sos[6 * j + 2];
      a1[j] = sos[6 * j + 4];
      a2[j] = sos[6 * j + 5];
      z0[j] = z_in[(2 * j + 0) * D];
      z1[j] = z_in[(2 * j + 1) * D];
    }
  }

  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kStages - 2>();  // this thread's copies of chunk c landed
    __syncthreads();  // everyone's; and chunk c-1's frames are all read
    stage(c + kStages - 1);  // into chunk c-1's slot
    const int k0 = c * chunk, nt = min(chunk, K - k0);
    float* buf = smem + (c % kStages) * slot_floats;

    if (chain) {
#pragma unroll 1
      for (int t = 0; t < nt; ++t) {
        float* x = buf + (t * ns + sl) * kBlock + d;
#pragma unroll
        for (int i = 0; i < FACTOR; ++i) {
          float y = __fmul_rn(x[i * D], prescale);
#pragma unroll
          for (int j = 0; j < NSEC; ++j) {
            const float yk = __fadd_rn(__fmul_rn(b0[j], y), z0[j]);
            z0[j] = __fadd_rn(__fsub_rn(__fmul_rn(b1[j], y),
                                        __fmul_rn(a1[j], yk)), z1[j]);
            z1[j] = __fsub_rn(__fmul_rn(b2[j], y), __fmul_rn(a2[j], yk));
            y = yk;
          }
          if (i >= FACTOR - RMSW) x[i * D] = y;  // the RMS window, in place
        }
      }
    }
    __syncthreads();

    // frames of this chunk, (tick, session, channel) over the whole CTA
    for (int f = tid; f < nt * ns * D; f += kThreads) {
      const int blk = f / D, ch = f % D;  // blk = t * ns + session
      const float* w = buf + blk * kBlock + (FACTOR - RMSW) * D + ch;
      float acc = __fmul_rn(w[0], w[0]);
#pragma unroll
      for (int i = 1; i < RMSW; ++i)
        acc = __fadd_rn(acc, __fmul_rn(w[i * D], w[i * D]));
      const float rms = __fsqrt_rn(__fdiv_rn(acc, (float)RMSW));
      const int t = blk / ns, s = s0 + blk % ns;
      frames[((size_t)(k0 + t) * S + s) * D + ch] =
          __fdiv_rn(__fsub_rn(rms, mean[ch]), std_[ch]);
    }
  }
  cp_async_wait<0>();

  if (chain) {
    const int s = s0 + sl;
    float* z_out = iir_out + (size_t)s * NSEC * 2 * D + d;
#pragma unroll
    for (int j = 0; j < NSEC; ++j) {
      z_out[(2 * j + 0) * D] = z0[j];
      z_out[(2 * j + 1) * D] = z1[j];
    }
    // the last tick's last R filtered samples, still in its ring slot
    float* tail = tail_out + (size_t)s * R * D + d;
    if (K > 0) {
      const int c = n_chunks - 1, t = K - 1 - c * chunk;
      const float* x = smem + (c % kStages) * slot_floats +
                       (t * ns + sl) * kBlock + (FACTOR - R) * D + d;
#pragma unroll
      for (int r = 0; r < R; ++r) tail[r * D] = x[r * D];
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r)
        tail[r * D] = tail_in[(size_t)s * R * D + r * D + d];
    }
  }
}

}  // namespace

extern "C" int dsp_frames_launch(
    const float* blocks, const float* iir_in, const float* tail_in,
    const float* sos, const float* mean, const float* std_, float* frames,
    float* iir_out, float* tail_out, int K, int S, int factor, int D,
    int n_sec, int rms_window, float prescale, void* stream) {
  // the instantiated (n_sec, factor, rms_window, D): the config's
  if (n_sec != 4 || factor != 20 || rms_window != 11 || D != 12 || K < 0 ||
      S < 0 || (reinterpret_cast<size_t>(blocks) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (S == 0) return (int)cudaSuccess;
  const int per_cta = S < kSessions ? S : kSessions;
  const int chunk = (kChunkBlocks + per_cta - 1) / per_cta;  // ticks
  const int grid = (S + kSessions - 1) / kSessions;
  const size_t smem =
      (size_t)kStages * chunk * per_cta * 20 * 12 * sizeof(float);
  auto kernel = dsp_frames_kernel<4, 20, 11, 12>;
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      blocks, iir_in, tail_in, sos, mean, std_, frames, iir_out, tail_out, K,
      S, chunk, prescale);
  return (int)cudaGetLastError();
}
