"""Welford running statistics over per-window means.

The port's own copy of the JAX package's ``ops/stats.py`` (reference
``code/utils.py:79-130``), numpy end to end, so for the same windows its
mean and std equal the JAX package's bit for bit. The reference streams
per-window *means* through Welford's algorithm and normalizes the whole
tensor with the resulting mean and std:

  * ``RunningStats``: the streaming API (push / mean_std / normalize) the
    ingest uses;
  * ``welford_over_means``: the one-shot equivalent (mean and ddof-1
    variance of the stacked window means).

Quirk (kept with ``complete=True``): the reference's ``mean()`` collapses
to a scalar but ``std()`` stays per channel (``utils.py:112-117`` computes
``var.mean()`` into a dead local), so the shipped ``emg_mean.npy`` has
shape ``()`` while ``emg_std.npy`` has ``(12,)``.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np


class RunningStats:
    """Streaming Welford over per-window means (reference utils.py:79-130)."""

    def __init__(self, save_prefix: Optional[str] = None,
                 complete: bool = False):
        self.counter = 0
        self.complete = complete
        self.save_prefix = save_prefix
        self._mean = None
        self._m2 = None

    def push(self, window: np.ndarray) -> None:
        """``window``: (time, channels), reduced over time before streaming
        (reference utils.py:89)."""
        x = np.asarray(window).mean(axis=0)
        self.counter += 1
        if self.counter == 1:
            self._mean = x.astype(np.float64).copy()
            self._m2 = np.zeros_like(self._mean)
        else:
            delta = x - self._mean
            self._mean = self._mean + delta / self.counter
            self._m2 = self._m2 + delta * (x - self._mean)

    def mean(self) -> np.ndarray:
        m = self._mean
        if self.complete:
            m = m.mean()  # scalar-mean quirk (utils.py:100-102)
        return np.asarray(m)

    def variance(self) -> np.ndarray:
        return self._m2 / (self.counter - 1)

    def std(self) -> np.ndarray:
        # per channel even when complete=True (utils.py:112-117 quirk)
        return np.sqrt(self.variance())

    def mean_std(self) -> tuple[np.ndarray, np.ndarray]:
        return self.mean(), self.std()

    def normalize(self, x: np.ndarray) -> np.ndarray:
        return (x - self.mean()) / self.std()

    def save(self) -> None:
        if self.save_prefix is None:
            raise ValueError("no save_prefix configured")
        os.makedirs(os.path.dirname(self.save_prefix) or ".", exist_ok=True)
        np.save(self.save_prefix + "mean.npy", self.mean())
        np.save(self.save_prefix + "std.npy", self.std())


def welford_over_means(
    windows: np.ndarray, complete: bool = False
) -> tuple[np.ndarray, np.ndarray]:
    """``windows`` (N, time, channels) -> (mean, std) over the N per-window
    time-means, variance with ddof=1."""
    means = np.asarray(windows, dtype=np.float64).mean(axis=1)
    mu = means.mean(axis=0)
    std = means.std(axis=0, ddof=1)
    if complete:
        mu = mu.mean()
    return mu, std
