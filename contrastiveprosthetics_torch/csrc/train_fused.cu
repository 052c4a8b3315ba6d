// train_fused: the fused training chain of EMGNet's dense stack, one
// kernel per dense block each way, with the dropout masks drawn in the
// kernels and never stored.
//
// Replaces: the JAX package's ops/train_fused.py::_fwd_block_call (K5f,
//   train_fused.py:362; body _fwd_block_kernel :183), ::_bwd_block_call
//   (K5b, :412; body _bwd_block_kernel :239) and ::extract_prng_masks (K5m,
//   :777; body _mask_kernel :771 over _draw_mask :146), tied together by the
//   custom VJP _chain (:526-666), whose last block's affine and dropout XLA
//   ran (:593-600, backward :624-633; the oracle's :760-762).
//
// What they compute, for block i with input x (N, K), weights W (K, F):
//   K5f: h = dropout(a_in x + c_in) (the previous block's BatchNorm affine
//        and its dropout, applied on load); r = relu(h W + b); the column
//        sums of r and r^2, finished into the BatchNorm statistics of r:
//        stats (5, F) = mean, var = max(0, E[r^2] - mean^2), rstd =
//        1/sqrt(var + eps), a = gamma rstd, c = beta - mean a.
//   K5b: dy = a (dz - S1/N - xhat S2/N) [r > 0] with xhat = (r - mean) rstd
//        and (S1, S2) = (sum dz, sum dz xhat); h recomputed as in K5f;
//        dx = dropout^T(dy W^T); dW = h^T dy; db = sum dy; and, for the
//        block below, the same two sums of dx against its own xhat.
//   chain_tail_fwd: h_L = dropout(a r + c) of the top block (K5m's draw on
//        the chain's path, applied where it is drawn);
//   chain_tail_bwd: dz = dropout^T(dh) and the top BatchNorm's two sums
//        (sum dz, sum dz xhat);
//   K5m: the {0,1} f32 dropout mask of one block, a replay for explicit
//        masks, tests and checks; no kernel of the chain stores a mask.
//
// What bounds them on an H100: at the train step's N = 328 rows and K = F
// = 512, K5f does 2 x 328 x 512 x 512 = 0.17 GFLOP on 2.4 MB; in 3xTF32
// that is 3 x 0.17 GFLOP over 495 TFLOP/s, 1.04 us, against 0.72 us of
// bytes (2.6 us at the 67 TFLOP/s f32 SIMT peak); K5b twice the
// operations. Measured on an H100 (PERF.md) they sit far above that: at
// tiles small enough to give 132 SMs work, the copies from L2 (every x
// tile read by each column tile, every weight tile by each row tile),
// mma.sync's TF32 rate times three products, and a fixed ~5 us of launch,
// epilogue and ticket each take a share; of the tiles, ring depths and
// k-tile depths tried, only K5b's wider tiles (fewer copies) moved them.
//
// Arithmetic: 3xTF32 on the tensor cores (tf32_mma.cuh): mma.sync
// m16n8k8, each k8 chunk's three products summed from zero, then one
// round-to-nearest add into the f32 accumulator. Chunks run in k order and
// no sum is split over K, so r, dx and dW have the same bits whatever the
// tiling or the weight layout.
//
// Design. Every GEMM (K5f; K5b's dgrad dx = dy W^T and wgrad dW = h^T dy)
// runs the same pipeline over k-tiles 32 deep (run_pipeline):
//  * a ring of 4 slots filled by 16-byte cp.async copies of each operand's
//    tile as it lies in device memory (x, dz and r rows; the weight along
//    whichever dimension is contiguous), zero past the edges, rows padded
//    so that fragment reads hit 32 distinct banks; the copies of the next
//    two k-tiles stay in flight while one is computed;
//  * one pass over each landed tile applies the operand's elementwise part
//    once per CTA -- h = dropout(a_in x + c_in) with one Philox call per 4
//    columns, or dy from dz, r and the column vectors staged when the CTA
//    starts -- and writes the f32 result back in place; each warp splits
//    its fragments into TF32 halves in registers. (Writing both halves to
//    shared memory, so that each element is split once per CTA, doubles the
//    shared-memory traffic and was no faster on the card.) The pass for
//    k-tile kt + 1 runs in the shadow of the MMAs of kt, between the same
//    two barriers;
//  * the epilogue stages the tile in shared memory and stores 16 bytes a
//    thread along the output's contiguous dimension, dW included in either
//    layout.
// Column sums over rows (K5f's sum r, sum r^2; K5b's two sums for the block
// below) are written as one partial per row tile; the last row tile of a
// column strip to finish (an integer ticket after a __threadfence) adds
// them in row-tile order and finishes the statistics, so the glue the JAX
// package left to XLA costs no launch. On a dp rank (a part of the global
// batch's rows) K5f ends there instead, writing the strip's sums: they are
// summed over the ranks and finished between launches, and K5b then takes
// the global sums and the global row count for its 1/N. No float atomics:
// a rerun gives the same bits. The ticket counters are reset by that last
// tile, so one zeroed buffer serves every launch on the stream. db is
// summed by the wgrad tiles of the first k strip: each thread over its rows
// in order, then the threads of a column in a fixed order.
// K5b is one launch with two roles of CTA: dgrad tiles (first in the grid;
// N x K outputs, contraction over F) and wgrad tiles (K x F outputs,
// contraction over the N rows, ragged rows zero-filled). At N = 328 and
// K = F = 512, K5f's tiling 0 launches 21 x 16 = 336 CTAs of 4 warps, two
// or three on every SM, and K5b's 88 + 128 = 216 CTAs of 8 warps, whose
// wider tiles read dz and r from L2 half as often as 32 x 32 ones.
//
// Dropout bits come from a counter-based Philox4x32-10: key = the step's
// two seed words, counter = (column / 4, row, dropped block, 0), one call
// giving the bits of four neighbouring columns; the row is the global
// batch's (a dp rank's launch adds its row base). A mask is a function of
// (seed words, block, row, column) only, never of the launch geometry, so
// the backward redraws the forward's bits and K5m replays them. An element
// is kept iff its 32 bits are <= the keep threshold, computed here from
// keep exactly as the plain version's keep_threshold does. The coordinate
// is the index of the block whose output is dropped (i - 1 for block i's
// input). The seed words and keep are read from device memory, so a step
// never waits for the host. The elementwise parts use the _rn intrinsics,
// so nothing is contracted into an fma: h and dy are exactly the plain
// version's.
//
// The tail pair is bound by bytes: at N = 328, F = 512 the forward moves
// x and h (1.34 MB, 0.40 us at 3.35 TB/s), the backward dh, r and dz (2.02
// MB, 0.60 us), each below an empty launch (~0.83 us on an H100). So each
// is one launch of 16-byte loads and stores with the mask drawn in
// registers (one Philox call per 4 columns, drop4's bits and rounding);
// the backward's column sums run one CTA per 8-column strip, rows split
// over its threads, in f64, combined in a fixed order in shared memory: no
// ticket, scratch or memset, where one CTA per row tile would need them.
// What is left is latency (PERF.md): so the forward issues its loads
// before it reads the seed words and keep, the backward's sums take two
// stages of 512 threads rather than a tree of barriers, and the one-row
// kernels take a flat grid rather than a loop over rows.
//
// Layouts: x, r, dz, dx (N, K or F) f32 row-major; W and dW (K, F) either
// row-major or the transpose of a row-major (F, K) Linear weight, dW laid
// out as W; K and F multiples of 4 and every array 16-byte aligned (the
// launchers refuse the rest); stats (5, F) rows mean, var, rstd, a, c;
// sums (2, F) rows sum dz, sum dz xhat; partial (row tiles, 2, width)
// scratch; tickets one uint32 per column strip, 0 at launch.
//
// The config axis (the crossval sweep's stacked step, the JAX package's
// jax.vmap of fused_emg_embed over C configs): every kernel takes C and a
// grid dimension over configs (K5f's z, the others' y). Every array holds
// the C configs' arrays one after another (x (C, N, K), W (C, K, F) in
// either layout, stats (C, 5, F), seeds (C, 2), keep (C,), partials and
// tickets one set a config), and a CTA first moves its pointers to its own
// config's. Nothing else changes: config c's tiles, sum orders and Philox
// counters are the single-config kernel's, so its outputs are bit-equal to
// a launch on config c alone, and C = 1 is that launch.
//
// bf16 variants (the JAX chain's compute_dtype=bfloat16, ChainCfg.dtype
// :127, rounding points :203-236, :266-324, the tail :593-601, :624-638):
// the same templates instantiated on the stored element type bf16 (its 16
// bits, bf16_mma.cuh) for x, W, r, dz, dx and the tail's r, h, dh, dz;
// statistics, sums, biases, dW and db stay f32. Each bf16 operand's
// 16-byte copies (8 values) land in a raw tile beside the f32 tile; the
// elementwise pass reads the raw tile, computes in f32 exactly as the f32
// kernels do, and writes the f32 tile, unrounded; the bf16 MMA rounds it
// to bf16 where its fragments are formed (one mma.sync m16n8k16 pass a
// product: a product of two bf16 values is exact in f32). So h = bf16(a x
// + c, dropped), dyc = bf16(dy) in both GEMMs, while db sums the unrounded
// dy in the pass, and the lower block's two sums take the unrounded f32 dh
// after its dropout. K5f rounds r to bf16 before it stores it and sums r
// and r^2 from the rounded values; K5b's dx and the tails' h and dz are
// rounded once when stored. k16 chunks run in k order, each added with one
// round-to-nearest add, so the bits hold across tilings as in f32. The
// bf16 kernels take K and F multiples of 8 (a copy's 8 values).
#include <cuda_runtime.h>
#include <curand_philox4x32_x.h>
#include <limits.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "tf32_mma.cuh"

namespace {

// ------------------------------------------------------ element types
using bf16_t = uint16_t;  // a stored bf16 value's 16 bits

// value: whether E is bf16; kChunk: the depth of a k chunk, the unit of
// one round-to-nearest add (m16n8k8 in 3xTF32, m16n8k16 in bf16)
template <class E>
struct Bf16 {
  static constexpr bool value = false;
  static constexpr int kChunk = 8;
};
template <>
struct Bf16<bf16_t> {
  static constexpr bool value = true;
  static constexpr int kChunk = 16;
};

// 4 consecutive elements as f32: one float4, or 4 bf16 (8 bytes) widened
// exactly
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16_t* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(bf16_to_f32(u.x & 0xFFFFu), bf16_to_f32(u.x >> 16),
                     bf16_to_f32(u.y & 0xFFFFu), bf16_to_f32(u.y >> 16));
}
// ... the same through the read-only cache for f32
__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ldg4(const bf16_t* p) { return load4(p); }

// 4 f32 values stored as they are, or rounded to bf16 (8 bytes)
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(bf16_t* p, float4 v) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(pack_bf16x2(v.x, v.y), pack_bf16x2(v.z, v.w));
}

__device__ __forceinline__ float4 round4_bf16(float4 v) {
  return make_float4(round_bf16(v.x), round_bf16(v.y), round_bf16(v.z),
                     round_bf16(v.w));
}

// ------------------------------------------------------------- tilings
template <int BM_, int BN_, int WARPS_M_, int WARPS_N_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_;
  static constexpr int WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr int kThreads = 32 * WARPS_M * WARPS_N;
  static constexpr int MI = BM / WARPS_M / 16, NI = BN / WARPS_N / 8;
  static_assert(MI >= 1 && NI >= 1 && MI * 16 * WARPS_M == BM &&
                    NI * 8 * WARPS_N == BN,
                "the warps' m16 x n8 tiles cover the block's tile");
};

constexpr int kBK = 32;     // depth of a k-tile
constexpr int kStages = 4;  // cp.async ring slots


// Tilings: output tile rows x columns, then warps along rows x columns;
// tiling 0 is the chain's. The wrapper (ops/train_fused.py FWD_TILES,
// DGRAD_TILES) sizes partials and tickets from the same (rows, columns).
using FwdTile0 = Tile<16, 32, 1, 4>;
using FwdTile1 = Tile<16, 64, 1, 8>;
using DgradTile0 = Tile<32, 64, 2, 4>;
using WgradTile0 = Tile<64, 32, 4, 2>;
using DgradTile1 = Tile<32, 32, 2, 2>;
using WgradTile1 = Tile<32, 32, 2, 2>;

// ------------------------------------------------------------- Philox
constexpr unsigned kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
constexpr unsigned kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
constexpr float kKeepClip = 0.99999994f;  // the largest f32 below 1

__device__ __forceinline__ uint4 philox_round(uint4 c, uint2 k) {
  const unsigned hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
  const unsigned hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
  return make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    c = philox_round(c, k);
    k.x += kW0;
    k.y += kW1;
  }
  return philox_round(c, k);
}

// the bits of columns 4*col4 .. 4*col4+3 of `row` in block `block`'s mask
__device__ __forceinline__ uint4 mask_bits(uint2 key, int block, int row,
                                           int col4) {
  return philox4x32_10(
      make_uint4((unsigned)col4, (unsigned)row, (unsigned)block, 0u), key);
}

__device__ __forceinline__ unsigned word(uint4 v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

__device__ __forceinline__ unsigned keep_threshold(float keep) {
  if (keep >= 1.0f) return 0xFFFFFFFFu;  // rate 0 keeps everything
  return (unsigned)__fmul_rn(fminf(fmaxf(keep, 0.0f), kKeepClip),
                             4294967296.0f);
}

// Dropout on a block's input: none (keep null), drawn (seed), or given
// (mask (N, K), kept where > 0). row_base: the global row of the launch's
// row 0 (a dp rank's rows of the global batch), added to the row wherever
// a Philox counter is formed; a given mask is indexed by the launch's row.
struct Dropout {
  const int* seed;
  const float* keep;
  const float* mask;
  int block;
  int row_base;
};

// config c's dropout: its seed words, its keep and its mask (of
// mask_stride elements a config)
__device__ __forceinline__ Dropout config_dropout(Dropout d, int c,
                                                  size_t mask_stride) {
  if (d.seed) d.seed += 2 * (size_t)c;
  if (d.keep) d.keep += c;
  if (d.mask) d.mask += (size_t)c * mask_stride;
  return d;
}

// The same, read once per CTA.
struct Drop {
  bool on;
  const float* mask;
  uint2 key;
  unsigned threshold;
  float keep;
  int block;
  int row_base;
};

__device__ __forceinline__ Drop read_drop(const Dropout& d) {
  Drop r;
  r.on = d.keep != nullptr;
  r.mask = d.mask;
  r.keep = r.on ? *d.keep : 1.0f;
  r.threshold = keep_threshold(r.keep);
  r.key = r.on && !d.mask ? make_uint2((unsigned)d.seed[0], (unsigned)d.seed[1])
                          : make_uint2(0u, 0u);
  r.block = d.block;
  r.row_base = d.row_base;
  return r;
}

// dropout of block d.block's mask at (n, k .. k+3), n < N and k < K
__device__ __forceinline__ float4 drop4(float4 v, const Drop& d, int n, int k,
                                        int K) {
  if (!d.on) return v;
  bool kept[4];
  if (d.mask) {
    const float4 m =
        __ldg(reinterpret_cast<const float4*>(d.mask + (size_t)n * K + k));
    kept[0] = m.x > 0.0f;
    kept[1] = m.y > 0.0f;
    kept[2] = m.z > 0.0f;
    kept[3] = m.w > 0.0f;
  } else {
    const uint4 bits = mask_bits(d.key, d.block, d.row_base + n, k >> 2);
#pragma unroll
    for (int j = 0; j < 4; ++j) kept[j] = word(bits, j) <= d.threshold;
  }
  v.x = kept[0] ? __fdiv_rn(v.x, d.keep) : 0.0f;
  v.y = kept[1] ? __fdiv_rn(v.y, d.keep) : 0.0f;
  v.z = kept[2] ? __fdiv_rn(v.z, d.keep) : 0.0f;
  v.w = kept[3] ? __fdiv_rn(v.w, d.keep) : 0.0f;
  return v;
}

// ------------------------------------------------ elementwise operands
// a v + c, rounded as the plain version's mul then add
__device__ __forceinline__ float4 affine4(float4 v, float4 a, float4 c) {
  return make_float4(__fadd_rn(__fmul_rn(v.x, a.x), c.x),
                     __fadd_rn(__fmul_rn(v.y, a.y), c.y),
                     __fadd_rn(__fmul_rn(v.z, a.z), c.z),
                     __fadd_rn(__fmul_rn(v.w, a.w), c.w));
}

// h = dropout(a x + c) at x[n, k .. k+3], 0 past the edges; a and c hold
// the affine of columns k_base.., or a is null (no affine)
__device__ __forceinline__ float4 block_input4(float4 v, int n, int k, int N,
                                               int K, const float* a,
                                               const float* c, int k_base,
                                               const Drop& d) {
  if (n >= N || k >= K) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (a)
    v = affine4(v, *reinterpret_cast<const float4*>(a + k - k_base),
                *reinterpret_cast<const float4*>(c + k - k_base));
  return drop4(v, d, n, k, K);
}

// dy's column vectors for column f at slot j of rows of width W: mean,
// rstd, a, S1/N, S2/N
__device__ __forceinline__ void stage_dy_vectors(float* vec, int W, int j,
                                                 int f, const float* stats,
                                                 const float* sums, int F,
                                                 float inv_n) {
  vec[j] = stats[f];
  vec[W + j] = stats[2 * F + f];
  vec[2 * W + j] = stats[3 * F + f];
  vec[3 * W + j] = __fmul_rn(sums[f], inv_n);
  vec[4 * W + j] = __fmul_rn(sums[F + f], inv_n);
}

__device__ __forceinline__ float dy1(float dz, float r, float mean, float rstd,
                                     float a, float u1, float u2) {
  const float xn = __fmul_rn(__fsub_rn(r, mean), rstd);
  const float t = __fsub_rn(__fsub_rn(dz, u1), __fmul_rn(xn, u2));
  return r > 0.0f ? __fmul_rn(a, t) : 0.0f;
}

// dy at (n, f .. f+3), 0 past the edges; vec as stage_dy_vectors left it,
// for columns f_base..
__device__ __forceinline__ float4 dy4(float4 dz, float4 r, int n, int f,
                                      int N, int F, const float* vec, int W,
                                      int f_base) {
  if (n >= N || f >= F) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int j = f - f_base;
  const float4 mean = *reinterpret_cast<const float4*>(vec + j);
  const float4 rstd = *reinterpret_cast<const float4*>(vec + W + j);
  const float4 a = *reinterpret_cast<const float4*>(vec + 2 * W + j);
  const float4 u1 = *reinterpret_cast<const float4*>(vec + 3 * W + j);
  const float4 u2 = *reinterpret_cast<const float4*>(vec + 4 * W + j);
  return make_float4(dy1(dz.x, r.x, mean.x, rstd.x, a.x, u1.x, u2.x),
                     dy1(dz.y, r.y, mean.y, rstd.y, a.y, u1.y, u2.y),
                     dy1(dz.z, r.z, mean.z, rstd.z, a.z, u1.z, u2.z),
                     dy1(dz.w, r.w, mean.w, rstd.w, a.w, u1.w, u2.w));
}

// -------------------------------------------------- the k-tile pipeline
// One operand's k-tile in a ring slot, in the orientation it has in device
// memory: KD_OUTER false [EXT][kBK], rows of kBK + 4 floats (fragment
// reads at (x = g, kd = t) hit banks 4g + t); KD_OUTER true [kBK][EXT],
// rows of EXT + 8 (banks 8t + g).
template <int EXT, bool KD_OUTER>
struct Operand {
  static constexpr int kRows = KD_OUTER ? kBK : EXT;
  static constexpr int kCols = KD_OUTER ? EXT : kBK;
  static constexpr int kLd = KD_OUTER ? EXT + 8 : kBK + 4;
  static constexpr int kTile = kRows * kLd;
  __device__ static __forceinline__ int at(int x, int kd) {
    return KD_OUTER ? kd * kLd + x : x * kLd + kd;
  }
};

// A bf16 operand's k-tile as its copies land, before its elementwise pass
// writes Op's f32 tile: Op's rows and columns, rows of kCols + 8 values
// (16-byte copies), kWords 32-bit words in a ring slot.
template <class Op>
struct Raw {
  static constexpr int kLd = Op::kCols + 8;
  static constexpr int kElems = Op::kRows * kLd;
  static constexpr int kWords = kElems / 2;
};

// 16-byte cp.async copies of the R x C tile at (r0, c0) of a row-major
// (rows, cols) array with row stride ld, into rows of LD elements; zeros
// past the array's edges. A copy carries 4 f32 or 8 bf16 values, and cols
// is a multiple of that.
template <int R, int C, int LD, int T, class E>
__device__ __forceinline__ void load_tile(E* dst, const E* __restrict__ src,
                                          int ld, int r0, int rows, int c0,
                                          int cols) {
  constexpr int kV = 16 / (int)sizeof(E);
  constexpr int kPieces = R * C / kV;
#pragma unroll
  for (int p = 0; p < (kPieces + T - 1) / T; ++p) {
    const int i = threadIdx.x + p * T;
    if (kPieces % T == 0 || i < kPieces) {
      const int r = i / (C / kV), c = (i % (C / kV)) * kV;
      const bool ok = r0 + r < rows && c0 + c < cols;
      cp_async16(dst + r * LD + c,
                 ok ? src + (size_t)(r0 + r) * ld + c0 + c : src, ok);
    }
  }
}

// A thread's float4s of an R x C tile: one column quad, every kStep-th row
template <int R, int C, int T>
struct Pieces {
  static constexpr int kQuads = C / 4;
  static_assert(T % kQuads == 0, "a thread keeps one column quad");
  static constexpr int kStep = T / kQuads;
  static constexpr int kPer = (R + kStep - 1) / kStep;
  __device__ static __forceinline__ int col() {
    return (threadIdx.x % kQuads) * 4;
  }
  __device__ static __forceinline__ int row(int p) {
    return threadIdx.x / kQuads + p * kStep;
  }
  __device__ static __forceinline__ bool has(int p) {
    return R % kStep == 0 || row(p) < R;
  }
};

// op(row, col, float4) on the thread's float4s of the R x C tile in rows of
// LD floats at `raw`, written back in place. Loads first, then the ops
// (which may share their column's loads), then the stores.
template <int R, int C, int LD, int T, class Op>
__device__ __forceinline__ void prep_tile(float* raw, Op op) {
  using P = Pieces<R, C, T>;
  const int c = P::col();
  float4 v[P::kPer];
#pragma unroll
  for (int p = 0; p < P::kPer; ++p)
    if (P::has(p))
      v[p] = *reinterpret_cast<const float4*>(raw + P::row(p) * LD + c);
#pragma unroll
  for (int p = 0; p < P::kPer; ++p)
    if (P::has(p)) v[p] = op(P::row(p), c, v[p]);
#pragma unroll
  for (int p = 0; p < P::kPer; ++p)
    if (P::has(p))
      *reinterpret_cast<float4*>(raw + P::row(p) * LD + c) = v[p];
}

// ... for a bf16 operand: op on the thread's float4s of the raw R x C tile
// (rows of LDR values), widened to f32, written to the f32 tile `dst` (rows
// of LD floats) unrounded
template <int R, int C, int LD, int LDR, int T, class Op>
__device__ __forceinline__ void prep_tile_from(float* dst, const bf16_t* raw,
                                               Op op) {
  using P = Pieces<R, C, T>;
  const int c = P::col();
  float4 v[P::kPer];
#pragma unroll
  for (int p = 0; p < P::kPer; ++p)
    if (P::has(p)) v[p] = load4(raw + P::row(p) * LDR + c);
#pragma unroll
  for (int p = 0; p < P::kPer; ++p)
    if (P::has(p)) v[p] = op(P::row(p), c, v[p]);
#pragma unroll
  for (int p = 0; p < P::kPer; ++p)
    if (P::has(p))
      *reinterpret_cast<float4*>(dst + P::row(p) * LD + c) = v[p];
}

// an operand with no elementwise part (the weight): widened as it is
struct Widen {
  __device__ __forceinline__ float4 operator()(int, int, float4 v) const {
    return v;
  }
};

// The MMAs of one k-tile, issued before the chunk sums are added: the
// warp's MI x NI m16n8 tiles at (wm, wn) from the f32 ring slots a and b,
// each fragment split into TF32 halves in registers, each chunk's three
// products (mma_3xtf32's) into p[chunk] from zero (chunks past n_chunks
// stay 0). KC is the chunk depth, 8 here and 16 for bf16.
template <class G, int KC = 8>
struct ChunkSums {
  float p[kBK / KC][G::MI][G::NI][4];
};

template <class G, class A, class B>
__device__ __forceinline__ void mma_ktile(const float* a, const float* b,
                                          int n_chunks, ChunkSums<G>& cs,
                                          int wm, int wn, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < kBK / 8; ++kk) {
#pragma unroll
    for (int mi = 0; mi < G::MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < G::NI; ++ni)
#pragma unroll
        for (int q = 0; q < 4; ++q) cs.p[kk][mi][ni][q] = 0.0f;
    if (kk < n_chunks) {
      const int kd = kk * 8 + t;
      uint32_t ab[G::MI][4], as[G::MI][4];
#pragma unroll
      for (int mi = 0; mi < G::MI; ++mi) {
        const int m = wm + mi * 16 + g;
        const int o[4] = {A::at(m, kd), A::at(m + 8, kd), A::at(m, kd + 4),
                          A::at(m + 8, kd + 4)};
#pragma unroll
        for (int q = 0; q < 4; ++q)
          split_tf32(a[o[q]], ab[mi][q], as[mi][q]);
      }
#pragma unroll
      for (int ni = 0; ni < G::NI; ++ni) {
        const int n = wn + ni * 8 + g;
        uint32_t bb0, bb1, bs0, bs1;
        split_tf32(b[B::at(n, kd)], bb0, bs0);
        split_tf32(b[B::at(n, kd + 4)], bb1, bs1);
#pragma unroll
        for (int mi = 0; mi < G::MI; ++mi) {  // mma_3xtf32's products
          mma_tf32(cs.p[kk][mi][ni], as[mi], bb0, bb1);
          mma_tf32(cs.p[kk][mi][ni], ab[mi], bs0, bs1);
          mma_tf32(cs.p[kk][mi][ni], ab[mi], bb0, bb1);
        }
      }
    }
  }
}

// ... the bf16 MMAs of one k-tile: each k16 chunk's fragments rounded to
// bf16 from the f32 slots (pairs along k, the lower index in the low half),
// one m16n8k16 pass into p[chunk] from zero
template <class G, class A, class B>
__device__ __forceinline__ void mma_ktile_bf16(const float* a, const float* b,
                                               int n_chunks,
                                               ChunkSums<G, 16>& cs, int wm,
                                               int wn, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
    for (int mi = 0; mi < G::MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < G::NI; ++ni)
#pragma unroll
        for (int q = 0; q < 4; ++q) cs.p[kk][mi][ni][q] = 0.0f;
    if (kk < n_chunks) {
      const int kd = kk * 16 + 2 * t;
      uint32_t af[G::MI][4];
#pragma unroll
      for (int mi = 0; mi < G::MI; ++mi) {
        const int m = wm + mi * 16 + g;
        af[mi][0] = pack_bf16x2(a[A::at(m, kd)], a[A::at(m, kd + 1)]);
        af[mi][1] = pack_bf16x2(a[A::at(m + 8, kd)], a[A::at(m + 8, kd + 1)]);
        af[mi][2] = pack_bf16x2(a[A::at(m, kd + 8)], a[A::at(m, kd + 9)]);
        af[mi][3] =
            pack_bf16x2(a[A::at(m + 8, kd + 8)], a[A::at(m + 8, kd + 9)]);
      }
#pragma unroll
      for (int ni = 0; ni < G::NI; ++ni) {
        const int n = wn + ni * 8 + g;
        const uint32_t b0 = pack_bf16x2(b[B::at(n, kd)], b[B::at(n, kd + 1)]);
        const uint32_t b1 =
            pack_bf16x2(b[B::at(n, kd + 8)], b[B::at(n, kd + 9)]);
#pragma unroll
        for (int mi = 0; mi < G::MI; ++mi)
          mma_bf16(cs.p[kk][mi][ni], af[mi], b0, b1);
      }
    }
  }
}

// The MMAs of a k-tile in the element type's arithmetic
template <class E, class G, class A, class B>
__device__ __forceinline__ void mma_ktile_of(const float* a, const float* b,
                                             int n_chunks,
                                             ChunkSums<G, Bf16<E>::kChunk>& cs,
                                             int wm, int wn, int g, int t) {
  if constexpr (Bf16<E>::value)
    mma_ktile_bf16<G, A, B>(a, b, n_chunks, cs, wm, wn, g, t);
  else
    mma_ktile<G, A, B>(a, b, n_chunks, cs, wm, wn, g, t);
}

// chunks of k-tile kt with data, of a contraction `depth` long
template <class E>
__device__ __forceinline__ int chunks_in(int depth, int kt) {
  constexpr int KC = Bf16<E>::kChunk;
  return min(kBK / KC, (depth - kt * kBK + KC - 1) / KC);
}

// ... then mma_3xtf32's round-to-nearest adds, chunk by chunk in k order
template <class G, int KC = 8>
__device__ __forceinline__ void add_chunks(float (&acc)[G::MI][G::NI][4],
                                           const ChunkSums<G, KC>& cs) {
#pragma unroll
  for (int kk = 0; kk < kBK / KC; ++kk)
#pragma unroll
    for (int mi = 0; mi < G::MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < G::NI; ++ni)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[mi][ni][q] = __fadd_rn(acc[mi][ni][q], cs.p[kk][mi][ni][q]);
}

// k-tiles 0 .. n_kt-1 through the ring: load(kt, slot) issues k-tile kt's
// copies into ring slot `slot`; prep(slot, kt) runs the elementwise pass of
// a landed slot in place; mma(slot, kt, cs) issues a slot's MMAs into cs,
// added to acc after the next pass so that the pass runs in the MMAs'
// shadow. mma(kt) and prep(kt+1) run between the same two barriers while
// the copies of kt+2 and kt+3 are in flight. Ends with every copy landed
// and the shared memory free for the epilogue.
template <class G, int KC, class Load, class Prep, class Mma>
__device__ __forceinline__ void run_pipeline(int n_kt, Load load, Prep prep,
                                             Mma mma,
                                             float (&acc)[G::MI][G::NI][4]) {
  // slot kt is read by mma(kt) and slot kt + 1 by prep(kt + 1): the rest
  // are ahead
  constexpr int kAhead = kStages - 1;
#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (s < n_kt) load(s, s);
    cp_async_commit();
  }
  cp_async_wait<kAhead - 1>();
  __syncthreads();  // k-tile 0 and the staged vectors are visible
  prep(0, 0);
  ChunkSums<G, KC> cs;
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<kAhead - 2>();  // this thread's copies of kt + 1
    // everyone's copies of kt + 1 and prep(kt) are visible; mma(kt - 1) is
    // done, so its slot is free for the next copies
    __syncthreads();
    const int next = kt + kAhead;
    if (next < n_kt) load(next, next % kStages);
    cp_async_commit();
    mma(kt % kStages, kt, cs);
    if (kt + 1 < n_kt) prep((kt + 1) % kStages, kt + 1);
    add_chunks<G, KC>(acc, cs);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// The warp's accumulators into a staged tile Cs[m][n] (row stride ld,
// float2 stores at banks 8g + 2t for ld = 8 mod 32)
template <class G>
__device__ __forceinline__ void stage_acc(float* Cs, int ld,
                                          const float (&acc)[G::MI][G::NI][4],
                                          int wm, int wn, int g, int t) {
#pragma unroll
  for (int mi = 0; mi < G::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < G::NI; ++ni) {
      const int r = wm + mi * 16 + g, c = wn + ni * 8 + 2 * t;
      *reinterpret_cast<float2*>(Cs + r * ld + c) =
          make_float2(acc[mi][ni][0], acc[mi][ni][1]);
      *reinterpret_cast<float2*>(Cs + (r + 8) * ld + c) =
          make_float2(acc[mi][ni][2], acc[mi][ni][3]);
    }
}

// ... transposed: Ct[n][m] (banks 8t + g for ld = 4 mod 32)
template <class G>
__device__ __forceinline__ void stage_acc_t(float* Ct, int ld,
                                            const float (&acc)[G::MI][G::NI][4],
                                            int wm, int wn, int g, int t) {
#pragma unroll
  for (int mi = 0; mi < G::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < G::NI; ++ni) {
      const int r = wm + mi * 16 + g, c = wn + ni * 8 + 2 * t;
      Ct[c * ld + r] = acc[mi][ni][0];
      Ct[(c + 1) * ld + r] = acc[mi][ni][1];
      Ct[c * ld + r + 8] = acc[mi][ni][2];
      Ct[(c + 1) * ld + r + 8] = acc[mi][ni][3];
    }
}

// Column sums of the staged BM x BN tiles S0 and S1 (row stride LD) into
// this row tile's partials, rows in order; then the ticket: returns true
// in the last row tile of the strip to finish.
template <int BM, int BN, int LD, int T>
__device__ bool tile_partials(const float* S0, const float* S1,
                              float* __restrict__ partial,
                              unsigned* __restrict__ ticket, int row_tile,
                              int n_row_tiles, int col0, int width) {
  static_assert(2 * BN <= T, "a thread per column sum");
  __shared__ bool last;
  const int tid = threadIdx.x;
  if (tid < 2 * BN) {
    const int n = tid % BN, which = tid / BN;
    const float* S = which ? S1 : S0;
    float s = 0.0f;
    for (int m = 0; m < BM; ++m) s = __fadd_rn(s, S[m * LD + n]);
    if (col0 + n < width)
      partial[((size_t)row_tile * 2 + which) * width + col0 + n] = s;
  }
  __threadfence();  // the partials reach device memory before the ticket
  __syncthreads();
  if (tid == 0)
    last = atomicAdd(ticket, 1u) == (unsigned)(n_row_tiles - 1);
  __syncthreads();
  return last;
}

// In the last row tile: the strip's two column sums, over row tiles in
// order, for one column.
__device__ __forceinline__ float2 strip_sums(const float* __restrict__ partial,
                                             int n_row_tiles, int col,
                                             int width) {
  float s1 = 0.0f, s2 = 0.0f;
#pragma unroll 4
  for (int t = 0; t < n_row_tiles; ++t) {
    s1 = __fadd_rn(s1, __ldcg(&partial[((size_t)t * 2) * width + col]));
    s2 = __fadd_rn(s2, __ldcg(&partial[((size_t)t * 2 + 1) * width + col]));
  }
  return make_float2(s1, s2);
}

// ---------------------------------------------------------------- K5f
// E: the element type of x, w and r (float, or bf16_t in the bf16 variant)
template <class E>
struct FwdArgs {
  const E *x, *w;
  const float *b, *gamma, *beta, *in_stats;
  Dropout d;
  E* r;
  float* partial;
  unsigned* tickets;
  float* stats;  // (5, F); (2, F) sums in the sums-only end
  int N, K, F;
  int sums_only;
  float eps;
};

// config c's arrays: its row tiles' partials and its column strips'
// tickets follow the configs before it
template <class E>
__device__ __forceinline__ FwdArgs<E> config_fwd(FwdArgs<E> p, int c,
                                                 int row_tiles,
                                                 int col_strips) {
  const size_t K = p.K, F = p.F, nk = (size_t)p.N * K;
  p.x += c * nk;
  p.w += c * K * F;
  p.b += c * F;
  p.gamma += c * F;
  p.beta += c * F;
  if (p.in_stats) p.in_stats += c * 5 * K;
  p.d = config_dropout(p.d, c, nk);
  p.r += c * (size_t)p.N * F;
  p.partial += c * (size_t)row_tiles * 2 * F;
  p.tickets += (size_t)c * col_strips;
  p.stats += c * (p.sums_only ? 2 : 5) * F;
  return p;
}

// WROW: w is a row-major (K, F); else the transpose of a Linear weight
// (F, K), contiguous along k. A slot holds the f32 tiles of h and W, then
// in bf16 the raw tiles of x and W that their copies fill.
template <class G, bool WROW, class E>
struct FwdLayout {
  using A = Operand<G::BM, false>;  // h as (n, k)
  using B = Operand<G::BN, WROW>;   // W as (f, k) or (k, f)
  using RA = Raw<A>;
  using RB = Raw<B>;
  static constexpr bool kBf16 = Bf16<E>::value;
  // x (h in place in f32), W; in bf16 then raw x, raw W
  static constexpr int kStage =
      A::kTile + B::kTile + (kBf16 ? RA::kWords + RB::kWords : 0);
  static constexpr int kCs = G::BN + 8;  // staged output row stride
  // the ring, then a_in and c_in (K floats each)
  static constexpr int kFloats = kStages * kStage;
  static_assert(2 * G::BM * kCs <= kFloats, "the staged outputs fit");
  static size_t bytes(int K) {
    return sizeof(float) * ((size_t)kFloats + 2 * (size_t)K);
  }
  // where a slot's copies of x and W land, and their row strides
  static constexpr int kLdX = kBf16 ? RA::kLd : A::kLd;
  static constexpr int kLdW = kBf16 ? RB::kLd : B::kLd;
  __device__ static __forceinline__ E* x_copy(float* s) {
    return reinterpret_cast<E*>(kBf16 ? s + A::kTile + B::kTile : s);
  }
  __device__ static __forceinline__ E* w_copy(float* s) {
    return kBf16 ? x_copy(s) + RA::kElems
                 : reinterpret_cast<E*>(s + A::kTile);
  }
};

template <class G, bool WROW, class E>
__global__ void __launch_bounds__(G::kThreads)
    dense_block_fwd_kernel(const FwdArgs<E> args) {
  const FwdArgs<E> p = config_fwd(args, blockIdx.z, gridDim.x, gridDim.y);
  using L = FwdLayout<G, WROW, E>;
  using A = typename L::A;
  using B = typename L::B;
  constexpr int T = G::kThreads;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* vec = smem + L::kFloats;  // a_in, c_in
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp % G::WARPS_M) * (G::BM / G::WARPS_M);
  const int wn = (warp / G::WARPS_M) * (G::BN / G::WARPS_N);
  const int row0 = blockIdx.x * G::BM, col0 = blockIdx.y * G::BN;
  const int N = p.N, K = p.K, F = p.F;
  const bool affine = p.in_stats != nullptr;
  const Drop drop = read_drop(p.d);
  if (affine)
    for (int i = tid; i < K; i += T) {
      vec[i] = p.in_stats[3 * K + i];
      vec[K + i] = p.in_stats[4 * K + i];
    }

  auto load = [&](int kt, int slot) {
    float* s = ring + slot * L::kStage;
    const int k0 = kt * kBK;
    load_tile<A::kRows, A::kCols, L::kLdX, T>(L::x_copy(s), p.x, K, row0, N,
                                              k0, K);
    if constexpr (WROW)  // w[k * F + f]
      load_tile<B::kRows, B::kCols, L::kLdW, T>(L::w_copy(s), p.w, F, k0, K,
                                                col0, F);
    else  // w[f * K + k]
      load_tile<B::kRows, B::kCols, L::kLdW, T>(L::w_copy(s), p.w, K, col0,
                                                F, k0, K);
  };
  auto prep = [&](int slot, int kt) {
    float* s = ring + slot * L::kStage;
    const int k0 = kt * kBK;
    auto op = [&](int i, int j, float4 v) {
      return block_input4(v, row0 + i, k0 + j, N, K, affine ? vec : nullptr,
                          vec + K, 0, drop);
    };
    if constexpr (L::kBf16) {
      prep_tile_from<A::kRows, A::kCols, A::kLd, L::kLdX, T>(s, L::x_copy(s),
                                                              op);
      prep_tile_from<B::kRows, B::kCols, B::kLd, L::kLdW, T>(
          s + A::kTile, L::w_copy(s), Widen());
    } else {
      prep_tile<A::kRows, A::kCols, A::kLd, T>(s, op);
    }
  };
  constexpr int KC = Bf16<E>::kChunk;
  float acc[G::MI][G::NI][4] = {};
  auto mma = [&](int slot, int kt, ChunkSums<G, KC>& cs) {
    const float* a = ring + slot * L::kStage;
    mma_ktile_of<E, G, A, B>(a, a + A::kTile, chunks_in<E>(K, kt), cs, wm,
                             wn, g, t);
  };
  run_pipeline<G, KC>((K + kBK - 1) / kBK, load, prep, mma, acc);

  // epilogue: bias, ReLU (in bf16 then rounded), 16-byte stores of r (8 in
  // bf16); the tile's stored v and v^2 staged for the column sums (0 past
  // the edges)
  float* Cs = smem;
  float* Cs2 = smem + G::BM * L::kCs;
  stage_acc<G>(Cs, L::kCs, acc, wm, wn, g, t);
  __syncthreads();
  constexpr int kPieces = G::BM * G::BN / 4;
#pragma unroll
  for (int q = 0; q < (kPieces + T - 1) / T; ++q) {
    const int i = tid + q * T;
    if (kPieces % T == 0 || i < kPieces) {
      const int m = i / (G::BN / 4), c = (i % (G::BN / 4)) * 4;
      const int gm = row0 + m, gn = col0 + c;
      float4* at = reinterpret_cast<float4*>(Cs + m * L::kCs + c);
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (gm < N && gn < F) {
        const float4 a = *at;
        const float4 bias = *reinterpret_cast<const float4*>(p.b + gn);
        v = make_float4(fmaxf(__fadd_rn(a.x, bias.x), 0.0f),
                        fmaxf(__fadd_rn(a.y, bias.y), 0.0f),
                        fmaxf(__fadd_rn(a.z, bias.z), 0.0f),
                        fmaxf(__fadd_rn(a.w, bias.w), 0.0f));
        if constexpr (L::kBf16) v = round4_bf16(v);
        store4(p.r + (size_t)gm * F + gn, v);
      }
      *at = v;
      *reinterpret_cast<float4*>(Cs2 + m * L::kCs + c) =
          make_float4(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y),
                      __fmul_rn(v.z, v.z), __fmul_rn(v.w, v.w));
    }
  }
  __syncthreads();
  if (!tile_partials<G::BM, G::BN, L::kCs, T>(Cs, Cs2, p.partial,
                                              &p.tickets[blockIdx.y],
                                              blockIdx.x, gridDim.x, col0, F))
    return;
  const int gn = col0 + tid;
  if (tid < G::BN && gn < F && p.sums_only) {
    // a dp rank's launch: the strip's sums, finished once they are summed
    // over the ranks (ops/train_fused.py::finish_stats)
    const float2 s = strip_sums(p.partial, gridDim.x, gn, F);
    p.stats[gn] = s.x;
    p.stats[F + gn] = s.y;
  } else if (tid < G::BN && gn < F) {
    const float2 s = strip_sums(p.partial, gridDim.x, gn, F);
    const float nf = (float)N;
    const float mean = __fdiv_rn(s.x, nf);
    const float var =
        fmaxf(0.0f, __fsub_rn(__fdiv_rn(s.y, nf), __fmul_rn(mean, mean)));
    const float rstd = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, p.eps)));
    const float a = __fmul_rn(p.gamma[gn], rstd);
    p.stats[gn] = mean;
    p.stats[F + gn] = var;
    p.stats[2 * F + gn] = rstd;
    p.stats[3 * F + gn] = a;
    p.stats[4 * F + gn] = __fsub_rn(p.beta[gn], __fmul_rn(mean, a));
  }
  if (tid == 0) p.tickets[blockIdx.y] = 0u;  // ready for the next launch
}

// ---------------------------------------------------------------- K5b
// E: the element type of dz, r, x, w and dx; dW, db and the sums are f32
template <class E>
struct BwdArgs {
  const E *dz, *r, *x, *w;
  const float *stats, *sums, *in_stats;
  Dropout d;
  E* dx;
  float *dw, *db, *out_sums, *partial;
  unsigned* tickets;
  int N, K, F;
  int n_total;  // the rows the sums were taken over (N, or a dp batch's)
  int n_dgrad;  // CTAs of the dgrad role, first in the grid
};

// config c's arrays (GD the dgrad tiling, which sizes the partials and the
// tickets of the lower block's sums)
template <class GD, class E>
__device__ __forceinline__ BwdArgs<E> config_bwd(BwdArgs<E> p, int c) {
  const size_t N = p.N, K = p.K, F = p.F;
  p.dz += c * N * F;
  p.r += c * N * F;
  p.x += c * N * K;
  p.w += c * K * F;
  p.stats += c * 5 * F;
  p.sums += c * 2 * F;
  if (p.in_stats) p.in_stats += c * 5 * K;
  p.d = config_dropout(p.d, c, N * K);
  p.dx += c * N * K;
  p.dw += c * K * F;
  p.db += c * F;
  if (p.out_sums) {
    p.out_sums += c * 2 * K;
    p.partial += c * (size_t)((p.N + GD::BM - 1) / GD::BM) * 2 * K;
  }
  p.tickets += (size_t)c * ((p.K + GD::BN - 1) / GD::BN);
  return p;
}

// f32: dz (dy in place), r, W. bf16: the f32 tiles of dy and W, then the
// raw tiles of dz, r and W.
template <class G, bool WROW, class E>
struct DgradLayout {
  using A = Operand<G::BM, false>;  // dy as (n, f)
  using B = Operand<G::BN, !WROW>;  // W as (k, f) or (f, k)
  using RA = Raw<A>;
  using RB = Raw<B>;
  static constexpr bool kBf16 = Bf16<E>::value;
  static constexpr int kW = kBf16 ? A::kTile : 2 * A::kTile;  // W's f32 tile
  static constexpr int kStage =
      kW + B::kTile + (kBf16 ? 2 * RA::kWords + RB::kWords : 0);
  static constexpr int kCs = G::BN + 8;
  // the ring, then dy's 5 column vectors (F each)
  static constexpr int kFloats = kStages * kStage;
  static_assert(2 * G::BM * kCs <= kFloats, "the staged outputs fit");
  static size_t bytes(int F) {
    return sizeof(float) * ((size_t)kFloats + 5 * (size_t)F);
  }
  static constexpr int kLdA = kBf16 ? RA::kLd : A::kLd;  // dz's and r's copies
  static constexpr int kLdW = kBf16 ? RB::kLd : B::kLd;
  __device__ static __forceinline__ E* dz_copy(float* s) {
    return reinterpret_cast<E*>(kBf16 ? s + kW + B::kTile : s);
  }
  __device__ static __forceinline__ E* r_copy(float* s) {
    return kBf16 ? dz_copy(s) + RA::kElems
                 : reinterpret_cast<E*>(s + A::kTile);
  }
  __device__ static __forceinline__ E* w_copy(float* s) {
    return kBf16 ? r_copy(s) + RA::kElems : reinterpret_cast<E*>(s + kW);
  }
};

// f32: x (h in place), dz (dy in place), r. bf16: the f32 tiles of h and
// dy, then the raw tiles of x, dz and r.
template <class G, bool WROW, class E>
struct WgradLayout {
  using A = Operand<G::BM, true>;  // h as (n, k)
  using B = Operand<G::BN, true>;  // dy as (n, f)
  using RA = Raw<A>;
  using RB = Raw<B>;
  static constexpr bool kBf16 = Bf16<E>::value;
  static constexpr int kStage =
      A::kTile + (kBf16 ? B::kTile + RA::kWords + 2 * RB::kWords
                        : 2 * B::kTile);
  static_assert(G::kThreads % (G::BN / 4) == 0,
                "each thread sums db over one column quad");
  static constexpr int kGroups = G::kThreads / (G::BN / 4);  // per column
  // staged dW: [k][f] for a row-major W, [f][k] for a Linear weight
  static constexpr int kCs = WROW ? G::BN + 8 : G::BM + 4;
  static constexpr int kFloats = kStages * kStage;
  // then dy's 5 column vectors (BN each), a_in and c_in (BM each)
  static constexpr int kVec = 5 * G::BN + 2 * G::BM;
  static_assert((WROW ? G::BM : G::BN) * kCs + kGroups * G::BN <= kFloats,
                "the staged dW and db partials fit");
  static size_t bytes() { return sizeof(float) * (size_t)(kFloats + kVec); }
  static constexpr int kLdX = kBf16 ? RA::kLd : A::kLd;
  static constexpr int kLdB = kBf16 ? RB::kLd : B::kLd;  // dz's and r's
  __device__ static __forceinline__ E* x_copy(float* s) {
    return reinterpret_cast<E*>(kBf16 ? s + A::kTile + B::kTile : s);
  }
  __device__ static __forceinline__ E* dz_copy(float* s) {
    return kBf16 ? x_copy(s) + RA::kElems
                 : reinterpret_cast<E*>(s + A::kTile);
  }
  __device__ static __forceinline__ E* r_copy(float* s) {
    return kBf16 ? dz_copy(s) + RB::kElems
                 : reinterpret_cast<E*>(s + A::kTile + B::kTile);
  }
};

// dgrad: the dx tile at (rows n, columns k), contraction over f
template <class G, bool WROW, class E>
__device__ __forceinline__ void dgrad_tile(const BwdArgs<E>& p, int bid) {
  using L = DgradLayout<G, WROW, E>;
  using A = typename L::A;
  using B = typename L::B;
  constexpr int T = G::kThreads;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* vec = smem + L::kFloats;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp % G::WARPS_M) * (G::BM / G::WARPS_M);
  const int wn = (warp / G::WARPS_M) * (G::BN / G::WARPS_N);
  const int N = p.N, K = p.K, F = p.F;
  const int n_row_tiles = (N + G::BM - 1) / G::BM;
  const int rt = bid % n_row_tiles, ct = bid / n_row_tiles;
  const int row0 = rt * G::BM, col0 = ct * G::BN;
  const Drop drop = read_drop(p.d);
  const float inv_n = __fdiv_rn(1.0f, (float)p.n_total);
  for (int i = tid; i < F; i += T)
    stage_dy_vectors(vec, F, i, i, p.stats, p.sums, F, inv_n);

  auto load = [&](int kt, int slot) {
    float* s = ring + slot * L::kStage;
    const int f0 = kt * kBK;
    load_tile<A::kRows, A::kCols, L::kLdA, T>(L::dz_copy(s), p.dz, F, row0,
                                              N, f0, F);
    load_tile<A::kRows, A::kCols, L::kLdA, T>(L::r_copy(s), p.r, F, row0, N,
                                              f0, F);
    if constexpr (WROW)  // w[k * F + f]
      load_tile<B::kRows, B::kCols, L::kLdW, T>(L::w_copy(s), p.w, F, col0,
                                                K, f0, F);
    else  // w[f * K + k]
      load_tile<B::kRows, B::kCols, L::kLdW, T>(L::w_copy(s), p.w, K, f0, F,
                                                col0, K);
  };
  auto prep = [&](int slot, int kt) {
    float* s = ring + slot * L::kStage;
    const E* rs = L::r_copy(s);
    const int f0 = kt * kBK;
    auto op = [&](int i, int j, float4 dz) {
      const float4 rv = load4(rs + i * L::kLdA + j);
      return dy4(dz, rv, row0 + i, f0 + j, N, F, vec, F, 0);
    };
    if constexpr (L::kBf16) {
      prep_tile_from<A::kRows, A::kCols, A::kLd, L::kLdA, T>(s, L::dz_copy(s),
                                                              op);
      prep_tile_from<B::kRows, B::kCols, B::kLd, L::kLdW, T>(
          s + L::kW, L::w_copy(s), Widen());
    } else {
      prep_tile<A::kRows, A::kCols, A::kLd, T>(s, op);
    }
  };
  constexpr int KC = Bf16<E>::kChunk;
  float acc[G::MI][G::NI][4] = {};
  auto mma = [&](int slot, int kt, ChunkSums<G, KC>& cs) {
    const float* a = ring + slot * L::kStage;
    mma_ktile_of<E, G, A, B>(a, a + L::kW, chunks_in<E>(F, kt), cs, wm, wn, g,
                             t);
  };
  run_pipeline<G, KC>((F + kBK - 1) / kBK, load, prep, mma, acc);

  // epilogue: dropout with the redrawn bits, 16-byte stores of dx (8-byte,
  // rounded, in bf16); the unrounded dx and dx xhat_in staged for the lower
  // block's two sums (0 past the edges)
  float* Cs = smem;
  float* Cx = smem + G::BM * L::kCs;
  stage_acc<G>(Cs, L::kCs, acc, wm, wn, g, t);
  __syncthreads();
  const bool sums_out = p.out_sums != nullptr;
  constexpr int kPieces = G::BM * G::BN / 4;
#pragma unroll
  for (int q = 0; q < (kPieces + T - 1) / T; ++q) {
    const int i = tid + q * T;
    if (kPieces % T == 0 || i < kPieces) {
      const int m = i / (G::BN / 4), c = (i % (G::BN / 4)) * 4;
      const int gm = row0 + m, gk = col0 + c;
      float4* at = reinterpret_cast<float4*>(Cs + m * L::kCs + c);
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f), vx = v;
      if (gm < N && gk < K) {
        const size_t e = (size_t)gm * K + gk;
        v = drop4(*at, drop, gm, gk, K);
        store4(p.dx + e, v);
        if (sums_out) {
          const float4 xv = ldg4(p.x + e);
          const float4 mu =
              __ldg(reinterpret_cast<const float4*>(p.in_stats + gk));
          const float4 rs =
              __ldg(reinterpret_cast<const float4*>(p.in_stats + 2 * K + gk));
          vx = make_float4(
              __fmul_rn(v.x, __fmul_rn(__fsub_rn(xv.x, mu.x), rs.x)),
              __fmul_rn(v.y, __fmul_rn(__fsub_rn(xv.y, mu.y), rs.y)),
              __fmul_rn(v.z, __fmul_rn(__fsub_rn(xv.z, mu.z), rs.z)),
              __fmul_rn(v.w, __fmul_rn(__fsub_rn(xv.w, mu.w), rs.w)));
        }
      }
      *at = v;
      *reinterpret_cast<float4*>(Cx + m * L::kCs + c) = vx;
    }
  }
  if (!sums_out) return;
  __syncthreads();
  if (!tile_partials<G::BM, G::BN, L::kCs, T>(Cs, Cx, p.partial,
                                              &p.tickets[ct], rt,
                                              n_row_tiles, col0, K))
    return;
  const int gk = col0 + tid;
  if (tid < G::BN && gk < K) {
    const float2 s = strip_sums(p.partial, n_row_tiles, gk, K);
    p.out_sums[gk] = s.x;
    p.out_sums[K + gk] = s.y;
  }
  if (tid == 0) p.tickets[ct] = 0u;
}

// wgrad: the dW tile at (rows k, columns f), contraction over the N rows;
// the tiles of the first k strip also sum db
template <class G, bool WROW, class E>
__device__ __forceinline__ void wgrad_tile(const BwdArgs<E>& p, int wid) {
  using L = WgradLayout<G, WROW, E>;
  using A = typename L::A;
  using B = typename L::B;
  constexpr int T = G::kThreads;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* vec = smem + L::kFloats;    // dy's vectors of columns f0..
  float* avec = vec + 5 * G::BN;     // a_in, c_in of columns k0..
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp % G::WARPS_M) * (G::BM / G::WARPS_M);
  const int wn = (warp / G::WARPS_M) * (G::BN / G::WARPS_N);
  const int N = p.N, K = p.K, F = p.F;
  const int n_k_tiles = (K + G::BM - 1) / G::BM;
  const int kt0 = wid % n_k_tiles, ft = wid / n_k_tiles;
  const int k0 = kt0 * G::BM, f0 = ft * G::BN;
  const bool affine = p.in_stats != nullptr;
  const Drop drop = read_drop(p.d);
  const float inv_n = __fdiv_rn(1.0f, (float)p.n_total);
  for (int i = tid; i < G::BN; i += T)
    if (f0 + i < F)
      stage_dy_vectors(vec, G::BN, i, f0 + i, p.stats, p.sums, F, inv_n);
  if (affine)
    for (int i = tid; i < G::BM; i += T)
      if (k0 + i < K) {
        avec[i] = p.in_stats[3 * K + k0 + i];
        avec[G::BM + i] = p.in_stats[4 * K + k0 + i];
      }

  auto load = [&](int kt, int slot) {
    float* s = ring + slot * L::kStage;
    const int n0 = kt * kBK;
    load_tile<A::kRows, A::kCols, L::kLdX, T>(L::x_copy(s), p.x, K, n0, N, k0,
                                              K);
    load_tile<B::kRows, B::kCols, L::kLdB, T>(L::dz_copy(s), p.dz, F, n0, N,
                                              f0, F);
    load_tile<B::kRows, B::kCols, L::kLdB, T>(L::r_copy(s), p.r, F, n0, N, f0,
                                              F);
  };
  // this thread's share of db: one column quad, its rows in order (the
  // unrounded dy in bf16 too)
  float4 db4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  auto prep = [&](int slot, int kt) {
    float* s = ring + slot * L::kStage;
    const E* rs = L::r_copy(s);
    const int n0 = kt * kBK;
    auto h_op = [&](int i, int j, float4 v) {
      return block_input4(v, n0 + i, k0 + j, N, K, affine ? avec : nullptr,
                          avec + G::BM, k0, drop);
    };
    auto dy_op = [&](int i, int j, float4 dz) {
      const float4 rv = load4(rs + i * L::kLdB + j);
      const float4 y = dy4(dz, rv, n0 + i, f0 + j, N, F, vec, G::BN, f0);
      db4 = make_float4(__fadd_rn(db4.x, y.x), __fadd_rn(db4.y, y.y),
                        __fadd_rn(db4.z, y.z), __fadd_rn(db4.w, y.w));
      return y;
    };
    if constexpr (L::kBf16) {
      prep_tile_from<A::kRows, A::kCols, A::kLd, L::kLdX, T>(s, L::x_copy(s),
                                                              h_op);
      prep_tile_from<B::kRows, B::kCols, B::kLd, L::kLdB, T>(
          s + A::kTile, L::dz_copy(s), dy_op);
    } else {
      prep_tile<A::kRows, A::kCols, A::kLd, T>(s, h_op);
      prep_tile<B::kRows, B::kCols, B::kLd, T>(s + A::kTile, dy_op);
    }
  };
  constexpr int KC = Bf16<E>::kChunk;
  float acc[G::MI][G::NI][4] = {};
  auto mma = [&](int slot, int kt, ChunkSums<G, KC>& cs) {
    const float* a = ring + slot * L::kStage;
    mma_ktile_of<E, G, A, B>(a, a + A::kTile, chunks_in<E>(N, kt), cs, wm, wn,
                             g, t);
  };
  run_pipeline<G, KC>((N + kBK - 1) / kBK, load, prep, mma, acc);

  // epilogue: dW staged along its contiguous dimension, 16-byte stores;
  // db from the column's thread partials in a fixed order
  float* Cs = smem;
  float* dbp = smem + (WROW ? G::BM : G::BN) * L::kCs;  // kGroups x BN
  if constexpr (WROW)
    stage_acc<G>(Cs, L::kCs, acc, wm, wn, g, t);
  else
    stage_acc_t<G>(Cs, L::kCs, acc, wm, wn, g, t);
  *reinterpret_cast<float4*>(dbp + (tid / (G::BN / 4)) * G::BN +
                             (tid % (G::BN / 4)) * 4) = db4;
  __syncthreads();
  constexpr int kRows = WROW ? G::BM : G::BN, kCols = WROW ? G::BN : G::BM;
  constexpr int kPieces = kRows * kCols / 4;
#pragma unroll
  for (int q = 0; q < (kPieces + T - 1) / T; ++q) {
    const int i = tid + q * T;
    if (kPieces % T == 0 || i < kPieces) {
      const int m = i / (kCols / 4), c = (i % (kCols / 4)) * 4;
      const float4 v = *reinterpret_cast<const float4*>(Cs + m * L::kCs + c);
      if constexpr (WROW) {  // dw[k * F + f]
        if (k0 + m < K && f0 + c < F)
          *reinterpret_cast<float4*>(p.dw + (size_t)(k0 + m) * F + f0 + c) =
              v;
      } else {  // dw[f * K + k]
        if (f0 + m < F && k0 + c < K)
          *reinterpret_cast<float4*>(p.dw + (size_t)(f0 + m) * K + k0 + c) =
              v;
      }
    }
  }
  if (kt0 == 0 && tid < G::BN && f0 + tid < F) {
    float s = 0.0f;
    for (int grp = 0; grp < L::kGroups; ++grp)
      s = __fadd_rn(s, dbp[grp * G::BN + tid]);
    p.db[f0 + tid] = s;
  }
}

template <class GD, class GW, bool WROW, class E>
__global__ void __launch_bounds__(GD::kThreads)
    dense_block_bwd_kernel(const BwdArgs<E> args) {
  static_assert(GD::kThreads == GW::kThreads, "one block size per launch");
  const BwdArgs<E> p = config_bwd<GD>(args, blockIdx.y);
  if ((int)blockIdx.x < p.n_dgrad)
    dgrad_tile<GD, WROW, E>(p, blockIdx.x);
  else
    wgrad_tile<GW, WROW, E>(p, blockIdx.x - p.n_dgrad);
}

// ------------------------------------------------ the chain's tail, K5m
// One thread per (row, 4-column group), kRowThreads groups per CTA; the
// CTAs of a row are consecutive in a 1-D grid.
constexpr int kRowThreads = 128;

__device__ __forceinline__ int row_ctas(int F) {
  return ((F + 3) / 4 + kRowThreads - 1) / kRowThreads;
}

// h = dropout(a x + c) of the top block's output (a, c its stats rows 3
// and 4), the mask drawn in registers: one 16-byte load and store and one
// Philox call per 4 columns, F % 4 == 0. The row's loads are issued before
// the seed words and keep are read, so that one round trip to memory
// serves both (read_drop's first use of keep would otherwise hold them).
// E: the element type of x and h (bf16: x widened, h rounded once when
// stored, 8-byte loads and stores).
template <class E>
__global__ void __launch_bounds__(kRowThreads)
    chain_tail_fwd_kernel(const E* __restrict__ x,
                          const float* __restrict__ stats, const Dropout dc,
                          E* __restrict__ h, int N, int F) {
  const size_t cfg = blockIdx.y, nf = (size_t)N * F;  // its config's arrays
  x += cfg * nf;
  h += cfg * nf;
  stats += cfg * 5 * F;
  const Dropout d = config_dropout(dc, (int)cfg, nf);
  const int per_row = row_ctas(F);
  const int n = blockIdx.x / per_row;
  const int k = ((blockIdx.x % per_row) * kRowThreads + threadIdx.x) * 4;
  if (k >= F) return;
  const int e = n * F + k;
  const float4 v = ldg4(x + e);
  const float4 a = __ldg(reinterpret_cast<const float4*>(stats + 3 * F + k));
  const float4 c = __ldg(reinterpret_cast<const float4*>(stats + 4 * F + k));
  const Drop drop = read_drop(d);
  store4(h + e, drop4(affine4(v, a, c), drop, n, k, F));
}

// dz = dropout^T(dh) with the same bits, and the top BatchNorm's two
// backward sums (sum dz, sum dz xhat), xhat = (r - mean) rstd. One CTA per
// strip of 8 columns (2 quads); thread (slot, quad) walks rows slot, slot
// + 256, ... in f64. The CTA's 256 partials per sum are then added in a
// fixed order in two stages (32 of 8 slots each, then those 32) and
// rounded to f32 once. No atomics: a rerun gives the same bits.
constexpr int kTailThreads = 512, kTailCols = 8;
constexpr int kTailQuads = kTailCols / 4;
constexpr int kTailSlots = kTailThreads / kTailQuads;  // row slots
constexpr int kTailGroups = kTailThreads / (8 * kTailQuads);  // stage one
static_assert(kTailSlots % kTailGroups == 0,
              "stage one adds kTailSlots / kTailGroups slots a thread");

// E: the element type of dh, r and dz (bf16: dh and r widened, the sums
// from the unrounded dz, which is rounded once when stored).
template <class E>
__global__ void __launch_bounds__(kTailThreads)
    chain_tail_bwd_kernel(const E* __restrict__ dh, const E* __restrict__ r,
                          const float* __restrict__ stats, const Dropout dc,
                          E* __restrict__ dz, float* __restrict__ sums,
                          int N, int F) {
  const size_t cfg = blockIdx.y, nf = (size_t)N * F;  // its config's arrays
  dh += cfg * nf;
  r += cfg * nf;
  dz += cfg * nf;
  stats += cfg * 5 * F;
  sums += cfg * 2 * F;
  const Dropout d = config_dropout(dc, (int)cfg, nf);
  // [sum][slot * kTailQuads + quad], then [group][sum * kTailQuads + quad]
  __shared__ double part[8][kTailThreads];
  __shared__ double group_part[kTailGroups][8 * kTailQuads];
  const int tid = threadIdx.x;
  const int quad = tid % kTailQuads, slot = tid / kTailQuads;
  const int k0 = blockIdx.x * kTailCols, k = k0 + quad * 4;
  double acc[8] = {};  // sum dz, then sum dz xhat, of columns k .. k+3
  if (k < F) {
    const float4 mean = __ldg(reinterpret_cast<const float4*>(stats + k));
    const float4 rstd =
        __ldg(reinterpret_cast<const float4*>(stats + 2 * F + k));
    const Drop drop = read_drop(d);  // once: it holds the first use of keep
    const float ms[4] = {mean.x, mean.y, mean.z, mean.w};
    const float ds[4] = {rstd.x, rstd.y, rstd.z, rstd.w};
    for (int n = slot; n < N; n += kTailSlots) {
      const int e = n * F + k;
      const float4 g = drop4(ldg4(dh + e), drop, n, k, F);
      const float4 rv = ldg4(r + e);
      store4(dz + e, g);
      const float gs[4] = {g.x, g.y, g.z, g.w};
      const float rs[4] = {rv.x, rv.y, rv.z, rv.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float xn = __fmul_rn(__fsub_rn(rs[j], ms[j]), ds[j]);
        acc[j] += (double)gs[j];
        acc[4 + j] += (double)__fmul_rn(gs[j], xn);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) part[j][tid] = acc[j];
  __syncthreads();
  {  // stage one: thread (sum j, lane) adds slots g, g + kTailGroups, ...
    constexpr int kLanes = kTailGroups * kTailQuads;
    const int j = tid / kLanes, lane = tid % kLanes;
    double s = 0.0;
#pragma unroll
    for (int m = 0; m < kTailSlots / kTailGroups; ++m)
      s += part[j][lane + m * kLanes];
    group_part[lane / kTailQuads][j * kTailQuads + lane % kTailQuads] = s;
  }
  __syncthreads();
  if (tid < 8 * kTailQuads) {  // stage two: the groups in order
    const int j = tid / kTailQuads, col = k0 + (tid % kTailQuads) * 4 + j % 4;
    double s = 0.0;
#pragma unroll
    for (int g = 0; g < kTailGroups; ++g) s += group_part[g][tid];
    if (col < F) sums[(j / 4) * F + col] = (float)s;
  }
}

// K5m: block `block`'s {0,1} mask, for replay (mask_mode "input", tests and
// checks); VEC: F % 4 == 0 and 16-byte stores, else scalar stores
template <bool VEC>
__global__ void __launch_bounds__(kRowThreads)
    dropout_masks_kernel(const int* __restrict__ seed,
                         const float* __restrict__ keep,
                         float* __restrict__ out, int F, int block,
                         int row_base) {
  const int per_row = row_ctas(F);
  const int n = blockIdx.x / per_row;
  const int g = (blockIdx.x % per_row) * kRowThreads + threadIdx.x;
  if (g * 4 >= F) return;
  const unsigned thr = keep_threshold(*keep);
  const uint4 bits = mask_bits(
      make_uint2((unsigned)seed[0], (unsigned)seed[1]), block, row_base + n,
      g);
  float m[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) m[j] = word(bits, j) <= thr ? 1.0f : 0.0f;
  float* at = out + n * F + g * 4;
  if constexpr (VEC) {
    *reinterpret_cast<float4*>(at) = make_float4(m[0], m[1], m[2], m[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (g * 4 + j < F) at[j] = m[j];
  }
}

// The kernels' Philox4x32-10 beside the CUDA toolkit's, on the same
// counters and keys: a check of the generator, on no path of the step.
__global__ void philox_check_kernel(const unsigned* __restrict__ ctr,
                                    const unsigned* __restrict__ key,
                                    unsigned* __restrict__ ours,
                                    unsigned* __restrict__ theirs, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint4 c = make_uint4(ctr[4 * i], ctr[4 * i + 1], ctr[4 * i + 2],
                             ctr[4 * i + 3]);
  const uint2 k = make_uint2(key[2 * i], key[2 * i + 1]);
  const uint4 a = philox4x32_10(c, k);
  const uint4 b = curand_Philox4x32_10(c, k);
  ours[4 * i] = a.x;
  ours[4 * i + 1] = a.y;
  ours[4 * i + 2] = a.z;
  ours[4 * i + 3] = a.w;
  theirs[4 * i] = b.x;
  theirs[4 * i + 1] = b.y;
  theirs[4 * i + 2] = b.z;
  theirs[4 * i + 3] = b.w;
}

// ------------------------------------------------------------ launching
bool bad_dropout(const int* seed, const float* keep, const float* mask) {
  return keep != nullptr && seed == nullptr && mask == nullptr;
}

bool misaligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) != 0;
}

// 1 for a row-major (K, F) w, 0 for the transpose of a row-major (F, K),
// -1 for anything else
int weight_layout(int K, int F, int wsk, int wsn) {
  if (wsk == F && wsn == 1) return 1;
  if (wsk == 1 && wsn == K) return 0;
  return -1;
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

// Dynamic shared memory above 32 KB is opted into once per kernel: the
// default 48 KB limit counts the static shared memory (tile_partials' flag)
// too, so exactly 48 KB of dynamic shared memory is refused without it.
cudaError_t allow_smem(const void* kernel, size_t bytes) {
  constexpr int kMax = 32;
  static const void* kernels[kMax];
  static size_t allowed[kMax];
  static int n = 0;
  if (bytes <= 32 * 1024) return cudaSuccess;
  int i = 0;
  while (i < n && kernels[i] != kernel) ++i;
  if (i < n && allowed[i] >= bytes) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  if (i == n && n < kMax) kernels[n++] = kernel;
  if (i < n) allowed[i] = bytes;
  return cudaSuccess;
}

template <class G, bool WROW, class E>
int launch_fwd(const FwdArgs<E>& a, int C, cudaStream_t stream) {
  const size_t smem = FwdLayout<G, WROW, E>::bytes(a.K);
  const auto kernel = dense_block_fwd_kernel<G, WROW, E>;
  cudaError_t err = allow_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(cdiv(a.N, G::BM), cdiv(a.F, G::BN), C);
  kernel<<<grid, G::kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <class GD, class GW, bool WROW, class E>
int launch_bwd(BwdArgs<E> a, int C, cudaStream_t stream) {
  a.n_dgrad = cdiv(a.N, GD::BM) * cdiv(a.K, GD::BN);
  const int n_wgrad = cdiv(a.K, GW::BM) * cdiv(a.F, GW::BN);
  const size_t smem_d = DgradLayout<GD, WROW, E>::bytes(a.F);
  const size_t smem_w = WgradLayout<GW, WROW, E>::bytes();
  const size_t smem = smem_d > smem_w ? smem_d : smem_w;
  const auto kernel = dense_block_bwd_kernel<GD, GW, WROW, E>;
  cudaError_t err = allow_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(a.n_dgrad + n_wgrad, C), GD::kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// Rows of an (N, F) array the kernels index in 32 bits: N * F < 2^31.
bool too_large(int N, int F) { return (long long)N * F > INT_MAX; }

// configs: the grid's z (K5f) or y dimension
bool bad_configs(int C) { return C < 1 || C > 65535; }

// One thread per (row, 4-column group): the CTAs of the N rows.
int row_grid(int N, int F) { return N * cdiv(cdiv(F, 4), kRowThreads); }

// the widths a copy of E takes: multiples of 4 f32 or 8 bf16 values
template <class E>
bool ragged(int width) {
  return width % (16 / (int)sizeof(E)) != 0;
}

template <class E>
int fwd_entry(const E* x, const E* w, const float* b, const float* gamma,
              const float* beta, const float* in_stats, const int* seed,
              const float* keep, const float* mask, E* r, float* partial,
              unsigned* tickets, float* stats, int C, int N, int K, int F,
              int wsk, int wsn, int drop_block, int tiling, int row_base,
              int sums_only, float eps, void* stream) {
  const int wrow = weight_layout(K, F, wsk, wsn);
  if (bad_configs(C) || N < 1 || K < 1 || F < 1 || ragged<E>(K) ||
      ragged<E>(F) || wrow < 0 || row_base < 0 ||
      bad_dropout(seed, keep, mask) || misaligned(x) || misaligned(w) ||
      misaligned(b) || misaligned(in_stats) || misaligned(mask) ||
      misaligned(r))
    return (int)cudaErrorInvalidValue;
  const FwdArgs<E> a{x, w, b, gamma, beta, in_stats,
                     Dropout{seed, keep, mask, drop_block, row_base},
                     r, partial, tickets, stats, N, K, F, sums_only, eps};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (tiling * 2 + wrow) {
    case 0: return launch_fwd<FwdTile0, false>(a, C, s);
    case 1: return launch_fwd<FwdTile0, true>(a, C, s);
    case 2: return launch_fwd<FwdTile1, false>(a, C, s);
    case 3: return launch_fwd<FwdTile1, true>(a, C, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <class E>
int bwd_entry(const E* dz, const E* r, const E* x, const E* w,
              const float* stats, const float* sums, const float* in_stats,
              const int* seed, const float* keep, const float* mask, E* dx,
              float* dw, float* db, float* out_sums, float* partial,
              unsigned* tickets, int C, int N, int K, int F, int wsk,
              int wsn, int drop_block, int tiling, int row_base, int n_total,
              void* stream) {
  const int wrow = weight_layout(K, F, wsk, wsn);
  if (bad_configs(C) || N < 1 || K < 1 || F < 1 || ragged<E>(K) ||
      ragged<E>(F) || wrow < 0 || row_base < 0 ||
      bad_dropout(seed, keep, mask) ||
      n_total < 0 || (in_stats == nullptr) != (out_sums == nullptr) ||
      misaligned(dz) || misaligned(r) || misaligned(x) || misaligned(w) ||
      misaligned(in_stats) ||
      misaligned(mask) || misaligned(dx) || misaligned(dw))
    return (int)cudaErrorInvalidValue;
  const BwdArgs<E> a{dz, r, x, w, stats, sums, in_stats,
                     Dropout{seed, keep, mask, drop_block, row_base},
                     dx, dw, db, out_sums, partial, tickets, N, K, F,
                     n_total ? n_total : N, 0};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (tiling * 2 + wrow) {
    case 0: return launch_bwd<DgradTile0, WgradTile0, false>(a, C, s);
    case 1: return launch_bwd<DgradTile0, WgradTile0, true>(a, C, s);
    case 2: return launch_bwd<DgradTile1, WgradTile1, false>(a, C, s);
    case 3: return launch_bwd<DgradTile1, WgradTile1, true>(a, C, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <class E>
int tail_fwd_entry(const E* x, const float* stats, const int* seed,
                   const float* keep, const float* mask, E* h, int C, int N,
                   int F, int drop_block, int row_base, void* stream) {
  if (bad_configs(C) || N < 1 || F < 1 || F % 4 || too_large(N, F) ||
      row_base < 0 || bad_dropout(seed, keep, mask) || misaligned(x) ||
      misaligned(stats) || misaligned(mask) || misaligned(h))
    return (int)cudaErrorInvalidValue;
  chain_tail_fwd_kernel<E><<<dim3(row_grid(N, F), C), kRowThreads, 0,
                             (cudaStream_t)stream>>>(
      x, stats, Dropout{seed, keep, mask, drop_block, row_base}, h, N, F);
  return (int)cudaGetLastError();
}

template <class E>
int tail_bwd_entry(const E* dh, const E* r, const float* stats,
                   const int* seed, const float* keep, const float* mask,
                   E* dz, float* sums, int C, int N, int F, int drop_block,
                   int row_base, void* stream) {
  if (bad_configs(C) || N < 1 || F < 1 || F % 4 || too_large(N, F) ||
      row_base < 0 || bad_dropout(seed, keep, mask) || misaligned(dh) ||
      misaligned(r) || misaligned(stats) || misaligned(mask) ||
      misaligned(dz))
    return (int)cudaErrorInvalidValue;
  chain_tail_bwd_kernel<E><<<dim3(cdiv(F, kTailCols), C), kTailThreads, 0,
                             (cudaStream_t)stream>>>(
      dh, r, stats, Dropout{seed, keep, mask, drop_block, row_base}, dz, sums,
      N, F);
  return (int)cudaGetLastError();
}

}  // namespace

// C configs' arrays one after another (the config axis above; C = 1 is one
// config). `row_base`: the global row of row 0 in every Philox counter (0
// unless the rows are a dp rank's part of a batch). `sums_only`: K5f writes
// (sum r, sum r^2) into `stats` as (2, F) a config and finishes nothing.
// `n_total` (K5b): the rows of the batch the sums were taken over, 0 for N.
// `tiling` 0 or 1 picks FwdTile0 or FwdTile1. The _bf16 launchers
// take x, w and r (K5b: dz, r, x, w and dx; the tails: x and h, dh, r and
// dz) as bf16 bits, K and F multiples of 8; everything else as the f32
// ones.
extern "C" int dense_block_fwd_launch(
    const float* x, const float* w, const float* b, const float* gamma,
    const float* beta, const float* in_stats, const int* seed,
    const float* keep, const float* mask, float* r, float* partial,
    unsigned* tickets, float* stats, int C, int N, int K, int F, int wsk,
    int wsn, int drop_block, int tiling, int row_base, int sums_only,
    float eps, void* stream) {
  return fwd_entry(x, w, b, gamma, beta, in_stats, seed, keep, mask, r,
                   partial, tickets, stats, C, N, K, F, wsk, wsn, drop_block,
                   tiling, row_base, sums_only, eps, stream);
}

extern "C" int dense_block_fwd_bf16_launch(
    const bf16_t* x, const bf16_t* w, const float* b, const float* gamma,
    const float* beta, const float* in_stats, const int* seed,
    const float* keep, const float* mask, bf16_t* r, float* partial,
    unsigned* tickets, float* stats, int C, int N, int K, int F, int wsk,
    int wsn, int drop_block, int tiling, int row_base, int sums_only,
    float eps, void* stream) {
  return fwd_entry(x, w, b, gamma, beta, in_stats, seed, keep, mask, r,
                   partial, tickets, stats, C, N, K, F, wsk, wsn, drop_block,
                   tiling, row_base, sums_only, eps, stream);
}

// `tiling` 0 or 1 picks DgradTile0 + WgradTile0 or DgradTile1 + WgradTile1.
extern "C" int dense_block_bwd_launch(
    const float* dz, const float* r, const float* x, const float* w,
    const float* stats, const float* sums, const float* in_stats,
    const int* seed, const float* keep, const float* mask, float* dx,
    float* dw, float* db, float* out_sums, float* partial, unsigned* tickets,
    int C, int N, int K, int F, int wsk, int wsn, int drop_block, int tiling,
    int row_base, int n_total, void* stream) {
  return bwd_entry(dz, r, x, w, stats, sums, in_stats, seed, keep, mask, dx,
                   dw, db, out_sums, partial, tickets, C, N, K, F, wsk, wsn,
                   drop_block, tiling, row_base, n_total, stream);
}

extern "C" int dense_block_bwd_bf16_launch(
    const bf16_t* dz, const bf16_t* r, const bf16_t* x, const bf16_t* w,
    const float* stats, const float* sums, const float* in_stats,
    const int* seed, const float* keep, const float* mask, bf16_t* dx,
    float* dw, float* db, float* out_sums, float* partial, unsigned* tickets,
    int C, int N, int K, int F, int wsk, int wsn, int drop_block, int tiling,
    int row_base, int n_total, void* stream) {
  return bwd_entry(dz, r, x, w, stats, sums, in_stats, seed, keep, mask, dx,
                   dw, db, out_sums, partial, tickets, C, N, K, F, wsk, wsn,
                   drop_block, tiling, row_base, n_total, stream);
}

// h = dropout(a x + c) of the top block: x (N, F), stats (5, F), the
// dropout of block `drop_block`'s output (seed and keep, or mask and keep).
extern "C" int chain_tail_fwd_launch(const float* x, const float* stats,
                                     const int* seed, const float* keep,
                                     const float* mask, float* h, int C,
                                     int N, int F, int drop_block,
                                     int row_base, void* stream) {
  return tail_fwd_entry(x, stats, seed, keep, mask, h, C, N, F, drop_block,
                        row_base, stream);
}

extern "C" int chain_tail_fwd_bf16_launch(const bf16_t* x,
                                          const float* stats, const int* seed,
                                          const float* keep,
                                          const float* mask, bf16_t* h,
                                          int C, int N, int F, int drop_block,
                                          int row_base, void* stream) {
  return tail_fwd_entry(x, stats, seed, keep, mask, h, C, N, F, drop_block,
                        row_base, stream);
}

// dz (N, F) and sums (2, F) from dh (N, F), the top block's r (N, F) and
// stats (5, F), with the forward's dropout.
extern "C" int chain_tail_bwd_launch(const float* dh, const float* r,
                                     const float* stats, const int* seed,
                                     const float* keep, const float* mask,
                                     float* dz, float* sums, int C, int N,
                                     int F, int drop_block, int row_base,
                                     void* stream) {
  return tail_bwd_entry(dh, r, stats, seed, keep, mask, dz, sums, C, N, F,
                        drop_block, row_base, stream);
}

extern "C" int chain_tail_bwd_bf16_launch(const bf16_t* dh, const bf16_t* r,
                                          const float* stats, const int* seed,
                                          const float* keep,
                                          const float* mask, bf16_t* dz,
                                          float* sums, int C, int N, int F,
                                          int drop_block, int row_base,
                                          void* stream) {
  return tail_bwd_entry(dh, r, stats, seed, keep, mask, dz, sums, C, N, F,
                        drop_block, row_base, stream);
}

extern "C" int dropout_masks_launch(const int* seed, const float* keep,
                                    float* out, int N, int F, int block,
                                    int row_base, void* stream) {
  if (N < 1 || F < 1 || too_large(N, F) || row_base < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (F % 4 == 0 && !misaligned(out))
    dropout_masks_kernel<true><<<row_grid(N, F), kRowThreads, 0, s>>>(
        seed, keep, out, F, block, row_base);
  else
    dropout_masks_kernel<false><<<row_grid(N, F), kRowThreads, 0, s>>>(
        seed, keep, out, F, block, row_base);
  return (int)cudaGetLastError();
}

extern "C" int philox_check_launch(const unsigned* ctr, const unsigned* key,
                                   unsigned* ours, unsigned* theirs, int n,
                                   void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  philox_check_kernel<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      ctr, key, ours, theirs, n);
  return (int)cudaGetLastError();
}
