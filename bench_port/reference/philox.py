"""Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as
1, 2, 3", SC 2011; Random123's constants) on int64 tensors that hold
32-bit words, and the dropout bits the fused training chain draws with it:
key = the step's two seed words of a config, counter = (column // 4, row,
block, 0), one call for four neighbouring columns; an element is kept when
its bits are at or below ``keep * 2**32``.
"""
from __future__ import annotations

import torch

U32 = 0xFFFFFFFF
M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
KEEP_CLIP = 1.0 - 2.0 ** -24  # the largest f32 below 1


def _mulhilo(m: int, c: torch.Tensor):
    """(hi, lo) words of m * c, every partial product below 2**49."""
    p1 = c * (m & 0xFFFF)
    p2 = c * (m >> 16)
    low = ((p2 & 0xFFFF) << 16) + p1
    return (p2 >> 16) + (low >> 32), low & U32


def philox4x32_10(counter, key):
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for rnd in range(10):
        if rnd:
            k0, k1 = (k0 + W0) & U32, (k1 + W1) & U32
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep_threshold(keep: torch.Tensor) -> torch.Tensor:
    """int64 thresholds: every element kept at keep 1."""
    keep = keep.float()
    t = (keep.clamp(0.0, KEEP_CLIP) * 4294967296.0).to(torch.int64)
    return torch.where(keep >= 1.0, torch.full_like(t, U32), t)


def mask_bits(seeds: torch.Tensor, rows: int, width: int, block: int
              ) -> torch.Tensor:
    """(C, rows, width) int64 random words of block ``block`` for the (C,
    2) int32 seed words."""
    dev = seeds.device
    words = seeds.to(torch.int64) & U32
    groups = -(-width // 4)
    c0 = torch.arange(groups, device=dev, dtype=torch.int64)[None, :]
    c1 = torch.arange(rows, device=dev, dtype=torch.int64)[:, None]
    c2 = torch.full((1, 1), block, device=dev, dtype=torch.int64)
    out = philox4x32_10((c0, c1, c2, torch.zeros_like(c2)),
                        (words[:, 0, None, None], words[:, 1, None, None]))
    bits = torch.stack(torch.broadcast_tensors(*out), dim=-1)
    return bits.reshape(seeds.shape[0], rows, 4 * groups)[..., :width]
