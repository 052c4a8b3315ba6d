// tf32_mma.cuh: the 3xTF32 tensor-core arithmetic that encoder_chain.cu and
// train_fused.cu share, the cp.async copies they, dsp_frames.cu and
// iir_rms.cu use, and two register helpers of iir_rms.cu.
//
// Each operand splits as x = big + small, big = cvt.rna.tf32(x), small =
// cvt.rna.tf32(x - big). A k8 chunk sums small*big, big*small and big*big,
// in that order, in the tensor core from zero (mma.sync m16n8k8 .tf32), and
// the chunk's sum is added to the f32 accumulator with one round-to-nearest
// add: the tensor core's own f32 accumulation does not round to nearest.
// The kernels round to TF32 with their own instructions, so
// torch.backends.cuda.matmul.allow_tf32 has no effect on them.
#pragma once

#include <stdint.h>

namespace {

// ----------------------------------------------------------- 3xTF32 MMA
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(__fsub_rn(x, __uint_as_float(big)));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One k8 chunk, in the order both tilings share: the three products from
// zero in the tensor core, then one round-to-nearest add per element.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4],
                                           uint32_t b_big0, uint32_t b_big1,
                                           uint32_t b_small0,
                                           uint32_t b_small1) {
  float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_tf32(p, a_small, b_big0, b_big1);
  mma_tf32(p, a_big, b_small0, b_small1);
  mma_tf32(p, a_big, b_big0, b_big1);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] = __fadd_rn(d[i], p[i]);
}

// ------------------------------------------------------------ cp.async
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------------------ registers
// p ? a : b as one selp into a register of its own. Written as ?:, the
// compiler may instead overwrite b's register under a predicate, and that
// write then waits for whatever wrote b (a warp shuffle, in iir_rms.cu).
__device__ __forceinline__ float select_f32(bool p, float a, float b) {
  float r;
  asm("{\n .reg .pred q;\n setp.ne.b32 q, %3, 0;\n selp.f32 %0, %1, %2, q;\n}"
      : "=f"(r)
      : "f"(a), "f"(b), "r"((int)p));
  return r;
}

// v in a register the compiler cannot re-derive: a kernel parameter used
// in an unrolled loop is otherwise reloaded from the constant bank.
__device__ __forceinline__ float in_register(float v) {
  asm("" : "+f"(v));
  return v;
}

}  // namespace
