// iir_rms_frames: the ingest's and the calibration's band-pass and RMS.
//
// Replaces: no Pallas kernel. The JAX package leaves this work to XLA:
//   the JAX package's ops/signal.py::sosfilt (a lax.scan over samples,
//   :65) and ops/signal.py::moving_rms (:128), as preprocess_segment
//   (:149) runs them for ingest (vmapped over a subject's segments,
//   data/ingest.py:63-84) and serve/stream.py::preprocess_recording for
//   calibration (:356-366), each followed by a downsample.
// It computes, from zero filter state, independently for each (b, d):
//   y = sosfilt(sos, prescale * x[b, :, d])   (transposed direct form II)
//   frames[b, f, d] = sqrt(sum_{k < W} y[f * stride + k]^2 / W), f < n_frames
// i.e. the valid-mode leading-window RMS at every stride-th start.
//
// What bounds it on an H100: at the corpus shape (11,316 segments x 2,010
// samples x 12 channels, 1.09 GB in) the bytes, 0.33 ms at 3.35 TB/s, near
// the f32 issue rate (~50 instructions a sample). At one subject (2,952
// chains) or one calibration recording (12 chains) the recurrence: each
// sample's 4 sections form one dependent chain, ~9 dependent instructions
// a section.
//
// Design: one thread per (b, d) chain, the 4 sections' coefficients and
// state in registers, the last W squares in a register shift line (the
// kernel is a template on (n_sec, W, D), so every loop over sections and
// the window unrolls and no array lives in local memory; the launcher
// takes the config's (4, 11, 12) only). A warp's 32 chains are about three
// segments' 12 channels, so each load and each frame store is a few
// 48-byte runs. The next kChunk samples are loaded into registers before
// the current chunk's recurrence runs, so their latency hides behind it.
// The filter runs only as far as the last frame's window needs. The
// arithmetic uses explicit round-to-nearest intrinsics (no FMA
// contraction) in the plain version's order: yk = b0*y + z0;
// z0' = b1*y - a1*yk + z1; z1' = b2*y - a2*yk; each window's squares summed
// oldest first; rms = sqrt(sum / W). Frames equal the plain version's on
// the card bit for bit.
//
// Layouts (f32, contiguous): x (B, T, D); sos (n_sec, 6); frames
// (B, n_frames, D).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 8;  // samples loaded ahead of the recurrence

template <int NSEC, int RMSW, int D>
__global__ void __launch_bounds__(kThreads) iir_rms_frames_kernel(
    const float* __restrict__ x, const float* __restrict__ sos,
    float* __restrict__ frames, int B, int T, int stride, int n_frames,
    float prescale) {
  const long long chain = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (chain >= (long long)B * D) return;
  const int b = (int)(chain / D), d = (int)(chain % D);
  const float* xs = x + (size_t)b * T * D + d;
  float* out = frames + (size_t)b * n_frames * D + d;

  float b0[NSEC], b1[NSEC], b2[NSEC], a1[NSEC], a2[NSEC], z0[NSEC], z1[NSEC];
#pragma unroll
  for (int j = 0; j < NSEC; ++j) {
    b0[j] = sos[6 * j + 0];
    b1[j] = sos[6 * j + 1];
    b2[j] = sos[6 * j + 2];
    a1[j] = sos[6 * j + 4];
    a2[j] = sos[6 * j + 5];
    z0[j] = 0.0f;
    z1[j] = 0.0f;
  }
  float sq[RMSW];  // squares of the last RMSW filtered samples, oldest first
#pragma unroll
  for (int k = 0; k < RMSW; ++k) sq[k] = 0.0f;

  const int t_end = (n_frames - 1) * stride + RMSW;  // samples the frames use
  int next = RMSW - 1;  // the sample that completes the next frame
  int f = 0;
  float ahead[kChunk];
#pragma unroll
  for (int i = 0; i < kChunk; ++i)
    ahead[i] = i < t_end ? xs[(size_t)i * D] : 0.0f;

#pragma unroll 1
  for (int t0 = 0; t0 < t_end; t0 += kChunk) {
    float cur[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) cur[i] = ahead[i];
    const int t1 = t0 + kChunk;
#pragma unroll
    for (int i = 0; i < kChunk; ++i)
      ahead[i] = t1 + i < t_end ? xs[(size_t)(t1 + i) * D] : 0.0f;

#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const int t = t0 + i;
      if (t < t_end) {
        float y = __fmul_rn(cur[i], prescale);
#pragma unroll
        for (int j = 0; j < NSEC; ++j) {
          const float yk = __fadd_rn(__fmul_rn(b0[j], y), z0[j]);
          z0[j] = __fadd_rn(__fsub_rn(__fmul_rn(b1[j], y),
                                      __fmul_rn(a1[j], yk)), z1[j]);
          z1[j] = __fsub_rn(__fmul_rn(b2[j], y), __fmul_rn(a2[j], yk));
          y = yk;
        }
#pragma unroll
        for (int k = 0; k < RMSW - 1; ++k) sq[k] = sq[k + 1];
        sq[RMSW - 1] = __fmul_rn(y, y);
        if (t == next) {  // the same t for every thread: no divergence
          float acc = sq[0];
#pragma unroll
          for (int k = 1; k < RMSW; ++k) acc = __fadd_rn(acc, sq[k]);
          out[(size_t)f * D] = __fsqrt_rn(__fdiv_rn(acc, (float)RMSW));
          ++f;
          next += stride;
        }
      }
    }
  }
}

}  // namespace

extern "C" int iir_rms_frames_launch(const float* x, const float* sos,
                                     float* frames, int B, int T, int D,
                                     int n_sec, int rms_window, int stride,
                                     int n_frames, float prescale,
                                     void* stream) {
  // the instantiated (n_sec, rms_window, D): the config's
  if (n_sec != 4 || rms_window != 11 || D != 12 || B < 0 || T < 0 ||
      stride < 1 || n_frames < 0)
    return (int)cudaErrorInvalidValue;
  if (n_frames > 0 &&
      (long long)(n_frames - 1) * stride + rms_window > (long long)T)
    return (int)cudaErrorInvalidValue;  // a frame's window past the end
  if (B == 0 || n_frames == 0) return (int)cudaSuccess;
  const long long chains = (long long)B * 12;
  const int grid = (int)((chains + kThreads - 1) / kThreads);
  auto kernel = iir_rms_frames_kernel<4, 11, 12>;
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x, sos, frames, B, T, stride, n_frames, prescale);
  return (int)cudaGetLastError();
}
