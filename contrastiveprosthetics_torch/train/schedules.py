"""Per-epoch learning-rate factors (reference ``train.py:75-80``; the JAX
package's ``train/schedules.py``), precomputed on the host.

``compat_shared_steplr``: the reference binds both StepLR handles to the
glove optimizer (train.py:79-80), so the EMG lr never decays in crossval.
By default both decay.
"""
from __future__ import annotations

import numpy as np


def cosine_factors(epochs: int, t_max: int | None = None) -> np.ndarray:
    """torch CosineAnnealingLR(T_max, eta_min=0): (1 + cos(pi e / T)) / 2,
    e counting completed epochs."""
    t = t_max or max(epochs, 1)
    e = np.arange(max(epochs, 1))
    return (1.0 + np.cos(np.pi * e / t)) / 2.0


def step_factors(epochs: int, step_size: int = 5,
                 gamma: float = 0.2) -> np.ndarray:
    """torch StepLR: gamma ** (e // step_size)."""
    e = np.arange(max(epochs, 1))
    return gamma ** (e // step_size)


def schedule_factors(epochs: int, annealing: bool,
                     compat_shared_steplr: bool = False
                     ) -> tuple[np.ndarray, np.ndarray]:
    """(emg_factors, glove_factors) per epoch."""
    if annealing:
        f = cosine_factors(epochs)
        return f, f
    g = step_factors(epochs)
    e = np.ones_like(g) if compat_shared_steplr else g
    return e, g
