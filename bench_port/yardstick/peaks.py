"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
no sparsity), at its full 700 W power limit.

f32 work is held against the fastest f32-accurate rate the card has: the
TF32 tensor cores at three products a multiply-add (the 3xTF32 split that
``encoder_chain`` and K5 run), 495 / 3 = 165 TFLOP/s. bf16 work is held
against the bf16 tensor cores at one product a multiply-add.
"""
from __future__ import annotations

TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
F32_SIMT_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

PEAK_FLOPS = {"float32": TF32_FLOPS / 3, "bfloat16": BF16_FLOPS}
ELEMENT_BYTES = {"float32": 4, "bfloat16": 2}


def least_seconds(flops: float, n_bytes: float, dtype: str
                  ) -> tuple[float, str]:
    """The least time the card could take: the larger of the operations
    over the dtype's peak and the bytes over the memory bandwidth, and
    which of the two it is."""
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = n_bytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
