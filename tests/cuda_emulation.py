"""Run the port's CUDA C++ kernels on the CPU, for tests of their indexing,
pipelines and epilogues where no card is present.

A kernel source from ``contrastiveprosthetics_torch/csrc`` is compiled by
the host's C++ compiler against a small emulation of what it uses: one
cluster at a time (a plain launch's CTAs are clusters of one), a
``std::thread`` per CUDA thread, ``__syncthreads`` as a block
barrier, ``mma.sync`` m16n8k8 as a warp-collective exchange of fragments
(each output's eight products summed in float64), ``__shfl_xor_sync``,
``__shfl_down_sync`` and ``__shfl_up_sync`` (with its width) as
warp-collective exchanges of 32-bit values (the whole warp takes part, as
the full mask says), ``__syncwarp`` as a warp
barrier, thread-block clusters as their CTAs run at once with a barrier
across them and each other's shared memory mapped (``cooperative_groups``
``this_cluster``, launched by ``cudaLaunchKernelEx``), ``mma.sync``
m16n8k16 with bf16 operands the same way (each output's sixteen exact
products summed in float64) and the f32 -> bf16 conversion
(``cvt.rn.bf16x2.f32``) as round to nearest even on the bit pattern,
programmatic dependent launch as plain ordering (a launch runs to its end
before the next starts, so ``griddepcontrol`` is dropped), ``cp.async`` as a
synchronous 16-byte copy (zeros past the edges), atomics (on 32-bit ints,
global or shared) as host atomics, a ``__grid_constant__`` parameter as a
by-value argument. A kernel's static ``__shared__`` arrays
become function statics, which the CTAs share one after another.
Shared memory starts as NaN, so a read of what no thread wrote shows. The
launchers keep their C interface, so a test calls them through ctypes on
CPU tensors. The emulation checks what the kernels compute and where, not
how fast or how the hardware rounds inside an MMA: the card's own checks
are ``test_torch_port_cuda.py`` and ``chip_smoke.py``.
"""
from __future__ import annotations

import ctypes
import hashlib
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

from contrastiveprosthetics_torch.ops import _build

RUNTIME = r"""
#pragma once
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <climits>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __restrict__
#define __align__(n) __attribute__((aligned(n)))
#define __launch_bounds__(...)
#define __grid_constant__
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 gridDim, blockDim;
struct alignas(8) float2 { float x, y; };
struct alignas(16) float4 { float x, y, z, w; };
struct uint2 { unsigned x, y; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return {a, b, c, d};
}
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fdiv_rn(float a, float b) { volatile float r = a / b; return r; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
inline float __frcp_rn(float a) { volatile float r = 1.0f / a; return r; }
inline double __dadd_rn(double a, double b) { volatile double r = a + b; return r; }
inline double __dsub_rn(double a, double b) { volatile double r = a - b; return r; }
inline double __dmul_rn(double a, double b) { volatile double r = a * b; return r; }
inline double __ddiv_rn(double a, double b) { volatile double r = a / b; return r; }
inline double __dsqrt_rn(double a) { return std::sqrt(a); }
inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, 4); return f; }
inline unsigned __float_as_uint(float f) { unsigned u; std::memcpy(&u, &f, 4); return u; }
inline unsigned __umulhi(unsigned a, unsigned b) {
  return (unsigned)(((uint64_t)a * b) >> 32);
}
inline float4 __ldg(const float4* p) { return *p; }
inline float __ldcg(const float* p) { return *(volatile const float*)p; }
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline long long clock64() { return 0; }
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
using std::fmaxf;
using std::fminf;
using std::max;
using std::min;
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline cudaError_t cudaGetLastError() { return 0; }
inline cudaError_t cudaFuncSetAttribute(const void*, int, int) { return 0; }
inline uint4 curand_Philox4x32_10(uint4 c, uint2) { return c; }

struct Warp {
  std::barrier<>* bar;
  float a[32][4], b[32][2], c[32][4];
  uint32_t x[32];
};
// what each emulated thread knows of its CTA and cluster
struct EmuCluster { std::barrier<>* bar; std::vector<float*> smem; };
inline thread_local std::barrier<>* g_block;
inline thread_local std::vector<Warp>* g_warps;
inline thread_local float* emu_smem;
inline thread_local EmuCluster* g_cluster;
inline thread_local unsigned g_rank;
inline void __syncthreads() { g_block->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  (*g_warps)[threadIdx.x >> 5].bar->arrive_and_wait();
}

// lane `lane` gets the value of lane src(lane); every lane of the warp calls
template <class T, class Src>
inline T emu_shfl(unsigned mask, T v, Src src) {
  static_assert(sizeof(T) == 4, "32-bit values only");
  if (mask != 0xffffffffu) std::abort();
  const int lane = threadIdx.x & 31;
  Warp& w = (*g_warps)[threadIdx.x >> 5];
  std::memcpy(&w.x[lane], &v, 4);
  w.bar->arrive_and_wait();
  T out;
  std::memcpy(&out, &w.x[src(lane)], 4);
  w.bar->arrive_and_wait();
  return out;
}
template <class T>
inline T __shfl_xor_sync(unsigned mask, T v, int x) {
  return emu_shfl(mask, v, [x](int l) { return l ^ x; });
}
template <class T>
inline T __shfl_down_sync(unsigned mask, T v, unsigned x) {
  return emu_shfl(mask, v, [x](int l) { return l + (int)x < 32 ? l + (int)x : l; });
}
template <class T>
inline T __shfl_up_sync(unsigned mask, T v, unsigned x, int width = 32) {
  return emu_shfl(mask, v, [x, width](int l) {
    return l % width >= (int)x ? l - (int)x : l;
  });
}

namespace cooperative_groups {
struct cluster_group {
  void sync() const { g_cluster->bar->arrive_and_wait(); }
  unsigned block_rank() const { return g_rank; }
  unsigned num_blocks() const { return (unsigned)g_cluster->smem.size(); }
  template <class T>
  T* map_shared_rank(T* p, unsigned rank) const {  // the same offset there
    return reinterpret_cast<T*>(g_cluster->smem[rank] + (
        reinterpret_cast<float*>(p) - emu_smem));
  }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups

// The grid cluster by cluster, in order; the CTAs of a cluster run at once,
// each with its own shared memory (NaN at the start), block barrier and
// warps, and one barrier across them.
template <class Kernel, class... Args>
void emu_run(Kernel kernel, dim3 grid, int threads, size_t smem,
             unsigned cluster, Args... args) {
  gridDim = grid;
  blockDim = dim3(threads);
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx0 = 0; bx0 < grid.x; bx0 += cluster) {
        std::barrier<> cluster_bar(threads * cluster);
        EmuCluster cl{&cluster_bar, {}};
        std::vector<std::vector<float>> mem(cluster,
                                            std::vector<float>(smem / 4 + 4, NAN));
        std::vector<std::unique_ptr<std::barrier<>>> blocks, bars;
        std::vector<std::vector<Warp>> warps(cluster,
                                             std::vector<Warp>((threads + 31) / 32));
        for (unsigned r = 0; r < cluster; ++r) {
          cl.smem.push_back(mem[r].data());
          blocks.emplace_back(new std::barrier<>(threads));
          for (auto& w : warps[r]) {
            bars.emplace_back(new std::barrier<>(32));
            w.bar = bars.back().get();
          }
        }
        std::vector<std::thread> ts;
        for (unsigned r = 0; r < cluster; ++r)
          for (int t = 0; t < threads; ++t)
            ts.emplace_back([&, r, t] {
              threadIdx = dim3(t);
              blockIdx = dim3(bx0 + r, by, bz);
              g_block = blocks[r].get();
              g_warps = &warps[r];
              emu_smem = mem[r].data();
              g_cluster = &cl;
              g_rank = r;
              kernel(args...);
            });
        for (auto& th : ts) th.join();
      }
}

template <class Kernel, class... Args>
void emu_launch(Kernel kernel, dim3 grid, int threads, size_t smem,
                cudaStream_t, Args... args) {
  emu_run(kernel, grid, threads, smem, 1, args...);
}

enum cudaLaunchAttributeID {
  cudaLaunchAttributeProgrammaticStreamSerialization = 3,
  cudaLaunchAttributeClusterDimension = 4
};
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  struct {
    struct { unsigned x, y, z; } clusterDim;
    int programmaticStreamSerializationAllowed;
  } val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
template <class... Params, class... Args>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* config,
                               void (*kernel)(Params...), Args... args) {
  unsigned cluster = 1;
  for (unsigned i = 0; i < config->numAttrs; ++i)
    if (config->attrs[i].id == cudaLaunchAttributeClusterDimension)
      cluster = config->attrs[i].val.clusterDim.x;
  if (config->gridDim.x % cluster != 0) return cudaErrorInvalidValue;
  emu_run(kernel, config->gridDim, (int)config->blockDim.x,
          config->dynamicSmemBytes, cluster, static_cast<Params>(args)...);
  return cudaSuccess;
}

// mma.sync.m16n8k8 .row.col on the warp's fragments (PTX ISA layouts)
inline void emu_mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                    uint32_t b1) {
  const int lane = threadIdx.x & 31;
  Warp& w = (*g_warps)[threadIdx.x >> 5];
  for (int q = 0; q < 4; ++q) {
    w.a[lane][q] = __uint_as_float(a[q]);
    w.c[lane][q] = d[q];
  }
  w.b[lane][0] = __uint_as_float(b0);
  w.b[lane][1] = __uint_as_float(b1);
  w.bar->arrive_and_wait();
  const int g = lane >> 2, t = lane & 3;
  float out[4];
  for (int q = 0; q < 4; ++q) {
    const int row = g + 8 * (q >= 2), col = 2 * t + (q & 1);
    double s = w.c[lane][q];
    for (int k = 0; k < 8; ++k)
      s += (double)w.a[(row % 8) * 4 + k % 4][(row >= 8) + 2 * (k >= 4)] *
           (double)w.b[col * 4 + k % 4][k >= 4];
    out[q] = (float)s;
  }
  w.bar->arrive_and_wait();
  for (int q = 0; q < 4; ++q) d[q] = out[q];
}

"""

TF32_MMA = r"""
#pragma once
#include <stdint.h>
namespace {
inline uint32_t tf32_rna(float x) {
  uint32_t u = __float_as_uint(x);
  if ((u & 0x7F800000u) != 0x7F800000u) u = (u + 0x1000u) & 0xFFFFE000u;
  return u;
}
inline void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(__fsub_rn(x, __uint_as_float(big)));
}
inline void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                     uint32_t b1) {
  emu_mma(d, a, b0, b1);
}
inline void mma_3xtf32(float (&d)[4], const uint32_t (&a_big)[4],
                       const uint32_t (&a_small)[4], uint32_t b_big0,
                       uint32_t b_big1, uint32_t b_small0, uint32_t b_small1) {
  float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_tf32(p, a_small, b_big0, b_big1);
  mma_tf32(p, a_big, b_small0, b_small1);
  mma_tf32(p, a_big, b_big0, b_big1);
  for (int i = 0; i < 4; ++i) d[i] = __fadd_rn(d[i], p[i]);
}
inline void cp_async16(void* smem, const void* gmem, bool valid) {
  if (valid) std::memcpy(smem, gmem, 16); else std::memset(smem, 0, 16);
}
inline void cp_async_commit() {}
template <int N> inline void cp_async_wait() {}
inline float select_f32(bool p, float a, float b) { return p ? a : b; }
inline float in_register(float v) { return v; }
}  // namespace
"""

BF16_MMA = r"""
#pragma once
#include <stdint.h>
namespace {
// f32 -> bf16, round to nearest even on the bit pattern (NaN kept quiet)
inline uint32_t bf16_rn(float x) {
  const uint32_t u = __float_as_uint(x);
  if ((u & 0x7FFFFFFFu) > 0x7F800000u) return (u >> 16) | 0x40u;
  return (u + 0x7FFFu + ((u >> 16) & 1u)) >> 16;
}
inline uint32_t pack_bf16x2(float lo, float hi) {
  return bf16_rn(lo) | (bf16_rn(hi) << 16);
}
inline float bf16_to_f32(uint32_t u) { return __uint_as_float(u << 16); }
inline float round_bf16(float x) { return bf16_to_f32(bf16_rn(x)); }
// mma.sync.m16n8k16 .row.col .bf16 on the warp's fragments (PTX ISA
// layouts): each output's sixteen products summed in float64 onto d
inline void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                     uint32_t b1) {
  const int lane = threadIdx.x & 31;
  Warp& w = (*g_warps)[threadIdx.x >> 5];
  for (int q = 0; q < 4; ++q) {
    w.a[lane][q] = __uint_as_float(a[q]);
    w.c[lane][q] = d[q];
  }
  w.b[lane][0] = __uint_as_float(b0);
  w.b[lane][1] = __uint_as_float(b1);
  w.bar->arrive_and_wait();
  const int g = lane >> 2, t = lane & 3;
  auto half = [](float word, int k) {  // element k & 1 of a bf16x2 word
    return (double)bf16_to_f32((__float_as_uint(word) >> (16 * (k & 1))) &
                               0xFFFFu);
  };
  float out[4];
  for (int q = 0; q < 4; ++q) {
    const int row = g + 8 * (q >= 2), col = 2 * t + (q & 1);
    double s = w.c[lane][q];
    for (int k = 0; k < 16; ++k) {
      // A: register (row >= 8) + 2 (k >= 8) of lane (row % 8) * 4 + k % 8 / 2
      const float aw =
          w.a[(row % 8) * 4 + (k % 8) / 2][(row >= 8) + 2 * (k >= 8)];
      // B: register (k >= 8) of lane col * 4 + k % 8 / 2
      const float bw = w.b[col * 4 + (k % 8) / 2][k >= 8];
      s += half(aw, k) * half(bw, k);
    }
    out[q] = (float)s;
  }
  w.bar->arrive_and_wait();
  for (int q = 0; q < 4; ++q) d[q] = out[q];
}
}  // namespace
"""


def _translate(src: str) -> str:
    """The CUDA source as host C++: the emulation in place of the CUDA
    headers, dynamic shared memory as the block's buffer, a launch as a
    call."""
    src = src.replace("#include <cuda_runtime.h>", '#include "emu_runtime.h"')
    src = src.replace("#include <curand_philox4x32_x.h>", "")
    src = src.replace("#include <cooperative_groups.h>", "")
    src = src.replace('#include "tf32_mma.cuh"', '#include "emu_tf32_mma.h"')
    src = src.replace('#include "bf16_mma.cuh"', '#include "emu_bf16_mma.h"')
    src = re.sub(r'asm volatile\("griddepcontrol\.\w+;\\n" ::: "memory"\);',
                 "", src)
    src = re.sub(r"extern __shared__ __align__\(16\) float (\w+)\[\];",
                 r"float* \1 = emu_smem;", src)
    launch = r"(\w+(?:<[^<>;]*>)?)\s*<<<([^;]*?)>>>\s*\("
    src = re.sub(launch + r"\s*\)", r"emu_launch(\1, \2)", src, flags=re.S)
    return re.sub(launch, r"emu_launch(\1, \2, ", src, flags=re.S)


def compiler() -> str | None:
    return shutil.which("g++") or shutil.which("c++")


def build(name: str, out_dir: Path) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` for the CPU emulation and load it."""
    src = _translate((_build.SRC_DIR / f"{name}.cu").read_text())
    digest = hashlib.sha256((src + RUNTIME + TF32_MMA + BF16_MMA).encode()
                            ).hexdigest()
    lib = out_dir / f"lib{name}_emulated-{digest[:16]}.so"
    if not lib.exists():
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
            (Path(tmp) / "emu_runtime.h").write_text(RUNTIME)
            (Path(tmp) / "emu_tf32_mma.h").write_text(TF32_MMA)
            (Path(tmp) / "emu_bf16_mma.h").write_text(BF16_MMA)
            cpp = Path(tmp) / f"{name}.cpp"
            cpp.write_text(src)
            so = Path(tmp) / lib.name
            subprocess.run([compiler(), "-std=c++20", "-O1",
                            "-ffp-contract=off", "-pthread", "-shared",
                            "-fPIC", "-w", "-I", tmp, "-o", str(so),
                            str(cpp)], check=True, capture_output=True)
            so.replace(lib)
    return ctypes.CDLL(str(lib))
