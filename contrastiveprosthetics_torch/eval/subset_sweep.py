"""The prediction-set-size sweep, the system's headline analysis (the JAX
package's ``eval/subset_sweep.py``; reference README.md:15,
``results.png``, ``data/{mean,min,max,std}_grasp.xlsx``).

For each set size s in 1..n-1, 144 trials; a trial draws s distinct
non-rest classes, the candidates are those and rest (class 0), and every
frame-level score row whose true class is a candidate is classified by the
first-index argmax over the candidates alone. A trial's accuracy is the
share of those rows classified right. Row 0 of each output is a 0.0
placeholder. (The JAX module's docstring gives the reasons for these
semantics.)

The JAX package evaluates all 5,760 (size, trial) masks against every row
at once. At the test split's 922,500 rows x 41 classes that would not fit
on any card, so the port counts exactly, without forming the masked
scores: for each row it keeps, as bits of an int64, the classes that beat
the true class when both are candidates (a higher score, or an equal one
at a lower index, as the first-index argmax breaks ties; NaN beats all),
and the classes that would beat it when they are left out (they then
score the float32 minimum, which beats only a true score below it or equal
to it at a higher index). A row is right under a mask iff its true class
is a candidate, no candidate beats it and no left-out class does. Rows with
the same (true class, bits) are counted once with their multiplicity, then
the masks are taken in chunks. The counts are integers, so the f32
accuracy ``correct / max(in, 1)`` and the numpy reductions after it give
the JAX function's bits on the same scores and seed.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

NEG = torch.finfo(torch.float32).min  # a left-out class's score in JAX
_WORD = 63  # class bits per int64 word: a word's bits sum without overflow
# masks x distinct rows taken at once: 2^25 int64s, 268 MB of scratch
CHUNK_ELEMENTS = 1 << 25


class SweepResult(NamedTuple):
    mean: np.ndarray  # (n_classes,) rows: 0 placeholder, sizes 1..n-1
    min: np.ndarray
    max: np.ndarray
    std: np.ndarray
    raw: np.ndarray   # (n_sizes, trials) per-trial accuracies, float32


def _subset_masks(rng: np.random.Generator, n_classes: int,
                  trials: int) -> np.ndarray:
    """(n_sizes, trials, n_classes) bool candidate masks; rest (class 0)
    always on; sizes 1..n_classes-1 over the non-rest classes."""
    n_grasps = n_classes - 1
    masks = np.zeros((n_grasps, trials, n_classes), dtype=bool)
    for si, size in enumerate(range(1, n_grasps + 1)):
        for t in range(trials):
            chosen = rng.choice(np.arange(1, n_classes), size=size,
                                replace=False)
            masks[si, t, chosen] = True
            masks[si, t, 0] = True
    return masks


def _pack(bits: torch.Tensor) -> torch.Tensor:
    """(..., n) bool -> (..., ceil(n / 63)) int64: class c at bit c % 63
    of word c // 63."""
    n = bits.shape[-1]
    words = -(-n // _WORD)
    padded = torch.nn.functional.pad(bits, (0, words * _WORD - n))
    shifts = torch.arange(_WORD, device=bits.device)
    return (padded.reshape(*bits.shape[:-1], words, _WORD).long()
            << shifts).sum(-1)


def _row_keys(flat: torch.Tensor):
    """Per score row of ``flat`` (rows, n), whose true class is ``row %
    n``: the true class, the packed classes that beat it as candidates and
    the packed classes that beat it when left out."""
    rows, n = flat.shape
    cls = torch.arange(n, device=flat.device)
    true = torch.arange(rows, device=flat.device) % n
    x_t = flat.gather(1, true[:, None])
    lower = cls[None, :] < true[:, None]
    nan_c, nan_t = flat.isnan(), x_t.isnan()
    beats = torch.where(nan_t, lower & nan_c,
                        nan_c | (flat > x_t) | ((flat == x_t) & lower))
    left_out = (~nan_t & ((x_t < NEG) | ((x_t == NEG) & lower))
                & (cls[None, :] != true[:, None]))
    return true, _pack(beats), _pack(left_out)


def sweep_counts(flat: torch.Tensor, masks: torch.Tensor):
    """For each candidate mask of ``masks`` (M, n) bool: the rows of
    ``flat`` (rows, n) classified right and the rows whose true class is a
    candidate, as two (M,) int64 tensors on ``flat``'s device."""
    n = flat.shape[1]
    true, beats, left_out = _row_keys(flat)
    words = beats.shape[1]
    keys, mult = torch.unique(torch.cat([true[:, None], beats, left_out], 1),
                              dim=0, return_counts=True)
    k_true = keys[:, 0]
    k_beats, k_out = keys[:, 1:1 + words], keys[:, 1 + words:]
    check_out = bool(k_out.any())
    m_bits, out_bits = _pack(masks), _pack(~masks)
    rows_in = (masks.long() * torch.bincount(true, minlength=n)).sum(1)
    step = max(1, CHUNK_ELEMENTS // (len(keys) * words))
    correct = []
    for s in range(0, masks.shape[0], step):
        hit = masks[s:s + step][:, k_true]
        hit &= ((k_beats[None] & m_bits[s:s + step, None]) == 0).all(-1)
        if check_out:
            hit &= ((k_out[None] & out_bits[s:s + step, None]) == 0).all(-1)
        correct.append(torch.where(hit, mult, 0).sum(1))
    return torch.cat(correct), rows_in


def subset_size_sweep(logits, trials: int = 144,
                      seed: int = 0) -> SweepResult:
    """``logits``: (n_rows, n_classes, n_classes) frame-level similarity
    matrices (the ``logs.npy`` layout: rows = eval items x vote frames,
    each holding one score row per true class), a tensor (the sweep runs
    on its device) or a numpy array (on the CPU)."""
    logits = torch.as_tensor(logits)
    n_classes = logits.shape[-1]
    flat = logits.reshape(-1, n_classes).float()
    masks = _subset_masks(np.random.default_rng(seed), n_classes, trials)
    correct, rows_in = sweep_counts(
        flat, torch.as_tensor(masks.reshape(-1, n_classes),
                              device=flat.device))
    raw = (correct.cpu().numpy().astype(np.float32)
           / np.maximum(rows_in.cpu().numpy(), 1).astype(np.float32))
    raw = raw.reshape(masks.shape[:2])

    def pad(v):
        return np.concatenate([[0.0], v])

    return SweepResult(mean=pad(raw.mean(axis=1)), min=pad(raw.min(axis=1)),
                       max=pad(raw.max(axis=1)), std=pad(raw.std(axis=1)),
                       raw=raw)
