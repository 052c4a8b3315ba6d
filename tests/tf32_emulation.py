"""The port's 3xTF32 tensor-core arithmetic (``csrc/tf32_mma.cuh``)
emulated with numpy, for the CPU tests of ``encoder_chain`` and the K5
kernels.

Every operand splits as ``x = big + small``, ``big =
cvt.rna.tf32.f32(x)``, ``small = cvt.rna.tf32.f32(x - big)``, and every
k8 chunk sums ``small*big``, ``big*small`` and ``big*big`` in the tensor
core and adds that sum to an f32 accumulator, rounded to nearest. Here each
chunk's products are summed exactly in float64 and rounded to f32, then
added to the f32 accumulator, chunk by chunk in k order.
"""
from __future__ import annotations

import numpy as np


def tf32_rna(x) -> np.ndarray:
    """``cvt.rna.tf32.f32``: keep 10 mantissa bits, round to nearest with
    ties away from zero, on the f32 bit pattern (the 13 low bits become
    zero; a carry may move into the exponent, up to infinity)."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    finite = (u & 0x7F800000) != 0x7F800000
    r = np.where(finite, (u + np.uint32(0x1000)) & np.uint32(0xFFFFE000), u)
    return r.astype(np.uint32).view(np.float32)


def split_tf32(x):
    big = tf32_rna(x)
    return big, tf32_rna(np.asarray(x, np.float32) - big)


def gemm_tf32(h: np.ndarray, w: np.ndarray, passes: int) -> np.ndarray:
    """h (M, K) @ w (K, N) as the kernels sum it: per k8 chunk, in order,
    the chunk's TF32 products (exact in float64) rounded to f32 and added
    to an f32 accumulator. ``passes`` 3 is 3xTF32, 1 one TF32 product. A
    ragged last chunk is the zero-filled one the kernels see."""
    hb, hs = split_tf32(h)
    wb, ws = split_tf32(w)
    terms = [(hs, wb), (hb, ws), (hb, wb)] if passes == 3 else [(hb, wb)]
    acc = np.zeros((h.shape[0], w.shape[1]), np.float32)
    for k0 in range(0, h.shape[1], 8):
        part = sum(a[:, k0:k0 + 8].astype(np.float64)
                   @ b[k0:k0 + 8].astype(np.float64) for a, b in terms)
        acc = acc + part.astype(np.float32)  # f32 + f32, rounded to nearest
    return acc
