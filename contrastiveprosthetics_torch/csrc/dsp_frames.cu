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
// What bounds it on an H100: bytes. Each (session, channel) lane reads
// K*factor raw samples once and writes K frames, 37 flops per 4-byte
// sample (~9 flop/byte), below the card's 20 flop/byte f32 balance point
// (67 TFLOP/s over 3.35 TB/s). Each lane's samples form one dependent
// chain, so the card needs many lanes in flight to hide the latency.
//
// Design: the TPU made the tick the sequential grid step because its
// weights sat in VMEM across ticks. The IIR/RMS state depends only on the
// raw input, so here the whole recording is one pass: one thread per
// (session, channel) walks its K*factor samples in order, the IIR
// registers stay in registers and the RMS history in a small local
// buffer. S*12 lanes fill the card at user-scale session counts. The
// arithmetic uses explicit round-to-nearest intrinsics (no FMA
// contraction) in the plain version's operation order: yk = b0*y + z0;
// z0' = b1*y - a1*yk + z1; z1' = b2*y - a2*yk; rms = sqrt(sum / window).
// Frames, IIR state and tail equal the plain version's on the card bit for
// bit (chip_smoke.py holds them to exact equality).
//
// Layouts (all f32, contiguous): blocks (K, S, factor, D); iir (S, n_sec,
// 2, D); tail (S, rms_window-1, D); sos (n_sec, 6); mean, std (D,);
// frames (K, S, D).
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSections = 8;
constexpr int kMaxBuffer = 128;  // (rms_window - 1) + factor

__global__ void dsp_frames_kernel(
    const float* __restrict__ blocks, const float* __restrict__ iir_in,
    const float* __restrict__ tail_in, const float* __restrict__ sos,
    const float* __restrict__ mean, const float* __restrict__ std_,
    float* __restrict__ frames, float* __restrict__ iir_out,
    float* __restrict__ tail_out, int K, int S, int factor, int D,
    int n_sec, int rms_window, float prescale) {
  const long long lane = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (lane >= (long long)S * D) return;
  const int s = (int)(lane / D);
  const int d = (int)(lane % D);
  const int R = rms_window - 1;

  float b0[kMaxSections], b1[kMaxSections], b2[kMaxSections];
  float a1[kMaxSections], a2[kMaxSections];
  float z0[kMaxSections], z1[kMaxSections];
  const float* z_in = iir_in + (size_t)s * n_sec * 2 * D + d;
#pragma unroll
  for (int k = 0; k < kMaxSections; ++k) {
    if (k < n_sec) {
      b0[k] = sos[6 * k + 0];
      b1[k] = sos[6 * k + 1];
      b2[k] = sos[6 * k + 2];
      a1[k] = sos[6 * k + 4];
      a2[k] = sos[6 * k + 5];
      z0[k] = z_in[(2 * k + 0) * D];
      z1[k] = z_in[(2 * k + 1) * D];
    }
  }
  float buf[kMaxBuffer];  // [tail (R) | this block's filtered samples]
  for (int r = 0; r < R; ++r) buf[r] = tail_in[((size_t)s * R + r) * D + d];
  const float mu = mean[d], sd = std_[d];

  for (int k = 0; k < K; ++k) {
    const float* x = blocks + ((size_t)k * S + s) * factor * D + d;
    for (int t = 0; t < factor; ++t) {
      float y = __fmul_rn(x[(size_t)t * D], prescale);
#pragma unroll
      for (int j = 0; j < kMaxSections; ++j) {
        if (j < n_sec) {
          const float yk = __fadd_rn(__fmul_rn(b0[j], y), z0[j]);
          z0[j] = __fadd_rn(__fsub_rn(__fmul_rn(b1[j], y),
                                      __fmul_rn(a1[j], yk)), z1[j]);
          z1[j] = __fsub_rn(__fmul_rn(b2[j], y), __fmul_rn(a2[j], yk));
          y = yk;
        }
      }
      buf[R + t] = y;
    }
    const int first = R + factor - rms_window;
    float acc = __fmul_rn(buf[first], buf[first]);
    for (int i = 1; i < rms_window; ++i)
      acc = __fadd_rn(acc, __fmul_rn(buf[first + i], buf[first + i]));
    const float rms = __fsqrt_rn(__fdiv_rn(acc, (float)rms_window));
    frames[((size_t)k * S + s) * D + d] = __fdiv_rn(__fsub_rn(rms, mu), sd);
    for (int r = 0; r < R; ++r) buf[r] = buf[factor + r];
  }

  float* z_out = iir_out + (size_t)s * n_sec * 2 * D + d;
#pragma unroll
  for (int k = 0; k < kMaxSections; ++k) {
    if (k < n_sec) {
      z_out[(2 * k + 0) * D] = z0[k];
      z_out[(2 * k + 1) * D] = z1[k];
    }
  }
  for (int r = 0; r < R; ++r) tail_out[((size_t)s * R + r) * D + d] = buf[r];
}

}  // namespace

extern "C" int dsp_frames_launch(
    const float* blocks, const float* iir_in, const float* tail_in,
    const float* sos, const float* mean, const float* std_, float* frames,
    float* iir_out, float* tail_out, int K, int S, int factor, int D,
    int n_sec, int rms_window, float prescale, void* stream) {
  if (n_sec > kMaxSections || rms_window - 1 + factor > kMaxBuffer ||
      factor < 1 || rms_window < 1)
    return (int)cudaErrorInvalidValue;
  const long long lanes = (long long)S * D;
  const int threads = 256;
  const long long grid = (lanes + threads - 1) / threads;
  if (grid > 0)
    dsp_frames_kernel<<<(unsigned)grid, threads, 0, (cudaStream_t)stream>>>(
        blocks, iir_in, tail_in, sos, mean, std_, frames, iir_out, tail_out,
        K, S, factor, D, n_sec, rms_window, prescale);
  return (int)cudaGetLastError();
}
