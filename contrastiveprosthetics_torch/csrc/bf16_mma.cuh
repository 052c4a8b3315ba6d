// bf16_mma.cuh: the bf16 tensor-core arithmetic of encoder_chain.cu's bf16
// variant. bf16 values travel as their 16 bits (uint16_t in memory, two to
// a 32-bit register, the lower index in the low half); conversions from
// f32 round to nearest even, as XLA's convert does.
#pragma once

#include <stdint.h>

namespace {

// {lo, hi} rounded to bf16, lo in the low half of the word
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// the bf16 in the low 16 bits of u, as f32 (exact)
__device__ __forceinline__ float bf16_to_f32(uint32_t u) {
  return __uint_as_float(u << 16);
}

// x rounded to the nearest bf16, as f32
__device__ __forceinline__ float round_bf16(float x) {
  return bf16_to_f32(pack_bf16x2(x, 0.0f) & 0xFFFFu);
}

// d += A (m16 x k16, row) * B (k16 x n8, col), bf16 operands, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace
