"""Run the port's CUDA C++ kernels on the CPU, for tests of their indexing,
pipelines and epilogues where no card is present.

A kernel source from ``contrastiveprosthetics_torch/csrc`` is compiled by
the host's C++ compiler against a small emulation of what it uses: one CTA
at a time, a ``std::thread`` per CUDA thread, ``__syncthreads`` as a block
barrier, ``mma.sync`` m16n8k8 as a warp-collective exchange of fragments
(each output's eight products summed in float64), ``cp.async`` as a
synchronous 16-byte copy (zeros past the edges), atomics as host atomics.
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
#define __align__(n)
#define __launch_bounds__(...)
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx;
inline dim3 blockIdx, gridDim, blockDim;
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

inline std::barrier<>* g_block;
struct Warp { std::barrier<>* bar; float a[32][4], b[32][2], c[32][4]; };
inline std::vector<Warp>* g_warps;
inline float* emu_smem;
inline void __syncthreads() { g_block->arrive_and_wait(); }

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

template <class Kernel, class... Args>
void emu_launch(Kernel kernel, dim3 grid, int threads, size_t smem,
                cudaStream_t, Args... args) {
  std::vector<float> mem(smem / 4 + 4);
  emu_smem = mem.data();
  gridDim = grid;
  blockDim = dim3(threads);
  std::barrier<> block(threads);
  g_block = &block;
  std::vector<Warp> warps((threads + 31) / 32);
  std::vector<std::unique_ptr<std::barrier<>>> bars;
  for (auto& w : warps) {
    bars.emplace_back(new std::barrier<>(32));
    w.bar = bars.back().get();
  }
  g_warps = &warps;
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      blockIdx = dim3(bx, by);
      std::fill(mem.begin(), mem.end(), NAN);
      std::vector<std::thread> ts;
      for (int t = 0; t < threads; ++t)
        ts.emplace_back([&, t] { threadIdx = dim3(t); kernel(args...); });
      for (auto& th : ts) th.join();
    }
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
inline void cp_async16(void* smem, const void* gmem, bool valid) {
  if (valid) std::memcpy(smem, gmem, 16); else std::memset(smem, 0, 16);
}
inline void cp_async_commit() {}
template <int N> inline void cp_async_wait() {}
}  // namespace
"""


def _translate(src: str) -> str:
    """The CUDA source as host C++: the emulation in place of the CUDA
    headers, dynamic shared memory as the block's buffer, a launch as a
    call."""
    src = src.replace("#include <cuda_runtime.h>", '#include "emu_runtime.h"')
    src = src.replace("#include <curand_philox4x32_x.h>", "")
    src = src.replace('#include "tf32_mma.cuh"', '#include "emu_tf32_mma.h"')
    src = re.sub(r"extern __shared__ __align__\(16\) float (\w+)\[\];",
                 r"float* \1 = emu_smem;", src)
    return re.sub(r"(\w+(?:<[^<>;]*>)?)\s*<<<(.*?)>>>\s*\(",
                  r"emu_launch(\1, \2, ", src, flags=re.S)


def compiler() -> str | None:
    return shutil.which("g++") or shutil.which("c++")


def build(name: str, out_dir: Path) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` for the CPU emulation and load it."""
    src = _translate((_build.SRC_DIR / f"{name}.cu").read_text())
    digest = hashlib.sha256((src + RUNTIME + TF32_MMA).encode()).hexdigest()
    lib = out_dir / f"lib{name}_emulated-{digest[:16]}.so"
    if not lib.exists():
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
            (Path(tmp) / "emu_runtime.h").write_text(RUNTIME)
            (Path(tmp) / "emu_tf32_mma.h").write_text(TF32_MMA)
            cpp = Path(tmp) / f"{name}.cpp"
            cpp.write_text(src)
            so = Path(tmp) / lib.name
            subprocess.run([compiler(), "-std=c++20", "-O1",
                            "-ffp-contract=off", "-pthread", "-shared",
                            "-fPIC", "-w", "-I", tmp, "-o", str(so),
                            str(cpp)], check=True, capture_output=True)
            so.replace(lib)
    return ctypes.CDLL(str(lib))
