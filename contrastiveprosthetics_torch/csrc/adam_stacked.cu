// adam_stacked: the crossval sweep's Adam update of C stacked configs, one
// pass over every parameter of a tower.
//
// Replaces: no TPU kernel. The JAX package vmaps optax.scale_by_adam
// (train/engine.py:257) over the sweep's configs and XLA fuses the update
// into its step. The port ran it as about 15 elementwise launches over the
// flat (C, N) moments and a torch.cat of the gradients; those tensor ops
// stay as the plain version (ops/kernels.py::adam_stacked_reference).
//
// What it computes, for each element (c, j) of each leaf (parameter) i, in
// optax's order and in the precision torch's CUDA ops take each step:
//   m  = b1 mu + (1-b1) g            (a bf16 mu: b1 mu rounded to bf16,
//                                     b1 the bf16 constant, the sum f32)
//   nu = b2 nu + (1-b2) g g
//   p -= ((m * inv_bc1) / (sqrt(nu * inv_bc2) + eps)) * lr[c]
//   mu = m                           (a bf16 mu: rounded to nearest even)
// where inv_bc = 1 / (1 - b^t) is taken on the host, as torch takes
// `x / python_scalar` on CUDA: a product with the reciprocal of the Python
// float, taken in float64 and rounded to the parameters' precision. Every operation is one correctly rounded intrinsic,
// so nvcc contracts nothing into an FMA and the result is torch's, bit for
// bit. Row c of mu and nu holds config c's moments of every leaf, leaf i
// from column off_i.
//
// What bounds it on an H100: bytes. Each element reads p, g, mu and nu once
// and writes p, mu and nu once: 28 bytes with an f32 mu, 24 with a bf16
// one, against about 15 operations (a division and a root among them). At
// the sweep's 150 configs x 2,023,520 elements (both towers) that is 8.5
// GB, 2.5 ms at 3.35 TB/s.
//
// Design: one launch a tower. The leaf table (parameter and gradient
// pointers, elements a config, column offset) is a kernel parameter, read
// in place (__grid_constant__): it is built on the host each step, since
// the gradients are fresh tensors, and needs no copy to the device. Each
// leaf's C x n_i elements, flattened as its (C, n_i) tensors lie, are cut
// into chunks of 2,048; a grid of 4 blocks an SM walks the chunks of all
// leaves in order (leaf after leaf), so large and small leaves share the
// card. In a chunk each thread takes two runs of 4 neighbouring elements,
// all loads issued before any arithmetic, as 16-byte loads and stores where
// the leaf allows (n_i, off_i and N multiples of 4, every pointer aligned;
// a run then lies in one row), and single elements where it does not (a
// ragged leaf, a float64 state).
//
// Instances: (parameter, first moment) = (f32, f32), (f32, bf16: raw bits)
// and (float64, float64), the last for the float64 checks of the stacked
// step. Layouts: each parameter and gradient (C, ...) contiguous; mu and
// nu (C, N); lr (C,) in the parameters' dtype.
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;  // ops/kernels.py::ADAM_BLOCKS_PER_SM
constexpr int kVec = 4;          // elements a run
constexpr int kRuns = 2;         // runs a thread a chunk
constexpr int kChunk = kThreads * kVec * kRuns;  // 2,048 elements
constexpr int kMaxLeaves = 64;   // ops/kernels.py::ADAM_MAX_LEAVES

struct Leaf {
  void* p;          // (C, n) parameter
  const void* g;    // (C, n) gradient
  long long off;    // column of element (c, 0) in row c of mu and nu
  unsigned n;       // elements a config
  int vec;          // 4-element runs with 16-byte loads
};

struct Table {
  Leaf leaf[kMaxLeaves];
  int chunk_start[kMaxLeaves + 1];  // leaf i: chunks [start[i], start[i+1])
  int n_leaves;
};

template <class T>
struct Coef {
  T b1, omb1, b2, omb2, inv_bc1, inv_bc2, eps;
};

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }

__device__ __forceinline__ float bf16_value(uint16_t h) {
  return __uint_as_float(static_cast<unsigned>(h) << 16);
}

// f32 -> bf16 bits, round to nearest even, as torch converts (NaN quiet)
__device__ __forceinline__ uint16_t bf16_bits(float x) {
  const unsigned u = __float_as_uint(x);
  if ((u & 0x7FFFFFFFu) > 0x7F800000u) return 0x7FC0u;
  return static_cast<uint16_t>((u + 0x7FFFu + ((u >> 16) & 1u)) >> 16);
}

// b1 mu and the stored moment, for a moment kept as the parameters' dtype
// or (M = uint16_t) as bf16 bits
template <class T, class M>
struct Moment {
  static __device__ __forceinline__ T decay(M mu, T b1) { return mul_rn(mu, b1); }
  static __device__ __forceinline__ M store(T m) { return m; }
};
template <>
struct Moment<float, uint16_t> {
  static __device__ __forceinline__ float decay(uint16_t mu, float b1) {
    return bf16_value(bf16_bits(__fmul_rn(bf16_value(mu), b1)));
  }
  static __device__ __forceinline__ uint16_t store(float m) { return bf16_bits(m); }
};

template <class T, class M>
__device__ __forceinline__ void adam_element(T& p, T g, M& mu, T& nu, T lr,
                                             const Coef<T>& k) {
  const T m = add_rn(Moment<T, M>::decay(mu, k.b1), mul_rn(g, k.omb1));
  nu = add_rn(mul_rn(nu, k.b2), mul_rn(mul_rn(g, g), k.omb2));
  const T den = add_rn(sqrt_rn(mul_rn(nu, k.inv_bc2)), k.eps);
  p = sub_rn(p, mul_rn(div_rn(mul_rn(m, k.inv_bc1), den), lr));
  mu = Moment<T, M>::store(m);
}

__device__ __forceinline__ void load4(const float* a, long long i, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(a + i);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void store4(float* a, long long i, const float (&v)[4]) {
  *reinterpret_cast<float4*>(a + i) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void load4(const uint16_t* a, long long i,
                                      uint16_t (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(a + i);
  v[0] = t.x & 0xFFFFu; v[1] = t.x >> 16; v[2] = t.y & 0xFFFFu; v[3] = t.y >> 16;
}
__device__ __forceinline__ void store4(uint16_t* a, long long i,
                                       const uint16_t (&v)[4]) {
  *reinterpret_cast<uint2*>(a + i) =
      make_uint2(v[0] | (static_cast<unsigned>(v[1]) << 16),
                 v[2] | (static_cast<unsigned>(v[3]) << 16));
}

template <class T, class M>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
adam_stacked_kernel(const __grid_constant__ Table t, M* __restrict__ mu,
                    T* __restrict__ nu, const T* __restrict__ lr, int C,
                    long long N, Coef<T> k) {
  const int total = t.chunk_start[t.n_leaves];
  int i = 0;
  for (int ch = blockIdx.x; ch < total; ch += gridDim.x) {
    while (ch >= t.chunk_start[i + 1]) ++i;
    const Leaf& leaf = t.leaf[i];
    T* p = static_cast<T*>(leaf.p);
    const T* g = static_cast<const T*>(leaf.g);
    const unsigned n = leaf.n;
    const unsigned size = n * static_cast<unsigned>(C);  // < 2^31: launcher
    const unsigned base = static_cast<unsigned>(ch - t.chunk_start[i]) * kChunk;
    if constexpr (std::is_same<T, float>::value) {
      if (leaf.vec) {
        T pv[kRuns][kVec], gv[kRuns][kVec], nv[kRuns][kVec], lv[kRuns];
        M mv[kRuns][kVec];
        unsigned e[kRuns];
        long long col[kRuns];
#pragma unroll
        for (int r = 0; r < kRuns; ++r) {
          e[r] = base + (r * kThreads + threadIdx.x) * kVec;
          if (e[r] < size) {  // size is a multiple of 4: the whole run
            const unsigned c = e[r] / n;
            col[r] = static_cast<long long>(c) * N + leaf.off + (e[r] - c * n);
            load4(p, e[r], pv[r]);
            load4(g, e[r], gv[r]);
            load4(mu, col[r], mv[r]);
            load4(nu, col[r], nv[r]);
            lv[r] = lr[c];
          }
        }
#pragma unroll
        for (int r = 0; r < kRuns; ++r) {
          if (e[r] < size) {
#pragma unroll
            for (int q = 0; q < kVec; ++q)
              adam_element(pv[r][q], gv[r][q], mv[r][q], nv[r][q], lv[r], k);
            store4(p, e[r], pv[r]);
            store4(mu, col[r], mv[r]);
            store4(nu, col[r], nv[r]);
          }
        }
        continue;
      }
    }
#pragma unroll 4
    for (int r = 0; r < kChunk / kThreads; ++r) {
      const unsigned e = base + r * kThreads + threadIdx.x;
      if (e >= size) break;
      const unsigned c = e / n;
      const long long col = static_cast<long long>(c) * N + leaf.off + (e - c * n);
      T pe = p[e], ne = nu[col];
      M me = mu[col];
      adam_element(pe, g[e], me, ne, lr[c], k);
      p[e] = pe;
      mu[col] = me;
      nu[col] = ne;
    }
  }
}

template <class T, class M>
int launch(const Table& t, void* mu, void* nu, const void* lr, int C,
           long long N, double b1, double omb1, double b2, double omb2,
           double bc1, double bc2, double eps, int grid, void* stream) {
  Coef<T> k;
  k.b1 = static_cast<T>(b1);
  k.omb1 = static_cast<T>(omb1);
  k.b2 = static_cast<T>(b2);
  k.omb2 = static_cast<T>(omb2);
  // torch's x / s on CUDA: x * (1 / s), the reciprocal taken in float64
  k.inv_bc1 = static_cast<T>(1.0 / bc1);
  k.inv_bc2 = static_cast<T>(1.0 / bc2);
  k.eps = static_cast<T>(eps);
  adam_stacked_kernel<T, M><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      t, static_cast<M*>(mu), static_cast<T*>(nu), static_cast<const T*>(lr),
      C, N, k);
  return (int)cudaGetLastError();
}

bool misaligned(const void* a, unsigned bytes) {
  return reinterpret_cast<uintptr_t>(a) % bytes != 0;
}

}  // namespace

// One update of n_leaves leaves (at most 64) in place. kind: 0 f32
// parameters and mu, 1 f32 parameters and a bf16 mu, 2 float64. b1 is the
// factor of mu (for a bf16 mu the bf16 constant's value); omb1 = 1 - b1 and
// omb2 = 1 - b2 as the caller's float64 numbers; bc1, bc2 the bias
// corrections; grid the most blocks to run (the card's SMs x 4).
extern "C" int adam_stacked_launch(void* const* p, const void* const* g,
                                   const long long* off, const int* n,
                                   const int* vec, int n_leaves, void* mu,
                                   void* nu, const void* lr, int C,
                                   long long N, int kind, double b1,
                                   double omb1, double b2, double omb2,
                                   double bc1, double bc2, double eps,
                                   int grid, void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves || C < 1 || N < 1 || grid < 1 ||
      kind < 0 || kind > 2)
    return (int)cudaErrorInvalidValue;
  Table t;
  t.n_leaves = n_leaves;
  t.chunk_start[0] = 0;
  long long chunks = 0;
  for (int i = 0; i < n_leaves; ++i) {
    const long long size = static_cast<long long>(n[i]) * C;
    if (n[i] < 1 || size >= (1LL << 31) || off[i] < 0 || off[i] + n[i] > N ||
        (vec[i] && (kind == 2 || n[i] % kVec || off[i] % kVec || N % kVec ||
                    misaligned(p[i], 16) || misaligned(g[i], 16) ||
                    misaligned(mu, kind == 1 ? 8 : 16) ||
                    misaligned(nu, 16))))
      return (int)cudaErrorInvalidValue;
    t.leaf[i] = Leaf{p[i], g[i], off[i], static_cast<unsigned>(n[i]), vec[i]};
    chunks += (size + kChunk - 1) / kChunk;
    if (chunks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    t.chunk_start[i + 1] = static_cast<int>(chunks);
  }
  grid = static_cast<int>(chunks < grid ? chunks : grid);
  switch (kind) {
    case 0:
      return launch<float, float>(t, mu, nu, lr, C, N, b1, omb1, b2, omb2,
                                  bc1, bc2, eps, grid, stream);
    case 1:
      return launch<float, uint16_t>(t, mu, nu, lr, C, N, b1, omb1, b2, omb2,
                                     bc1, bc2, eps, grid, stream);
    default:
      return launch<double, double>(t, mu, nu, lr, C, N, b1, omb1, b2, omb2,
                                    bc1, bc2, eps, grid, stream);
  }
}
