"""Synthetic, already-ingested Ninapro-layout data.

The port's copy of the JAX package's ``make_processed_dataset`` and its two
helpers (``data/synthetic.py:35-49,144-189``). It is numpy end to end, so
for the same arguments its arrays equal the JAX package's byte for byte.
The signal is class-conditional (a per-stimulus channel-amplitude profile
shared across subjects, times a per-subject gain, plus noise), so a model
trained on it learns. The ``.mat`` writers wait for the ingest slice.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from contrastiveprosthetics_torch.config import Config


def _stim_profiles(cfg: Config, seed: int = 0) -> np.ndarray:
    """(max_tasks, emg_dim) per-class channel amplitudes; rest is lowest."""
    rng = np.random.default_rng(seed)
    prof = 0.5 + rng.uniform(0.0, 1.5, size=(cfg.max_tasks, cfg.emg_dim))
    prof[0] = 0.2
    return prof


def _glove_prototypes(cfg: Config, seed: int = 1) -> np.ndarray:
    """(max_tasks, 22) per-class glove-angle prototypes (raw 22 sensors)."""
    rng = np.random.default_rng(seed)
    proto = rng.uniform(0.0, 60.0, size=(cfg.max_tasks, 22))
    proto[0] = 5.0
    return proto


def make_processed_dataset(
    cfg: Config,
    people_positions: Sequence[int] | None = None,
    glove_people: int = 39,
    seed: int = 0,
    separability: float = 6.0,
):
    """Fabricate a normalized dataset in the store's layout.

    Returns ``(emg, people_positions, glove)``: ``emg`` (max_tasks,
    n_people, max_reps, final_window_size, emg_dim) f32, tasks-first, whose
    person rows are the given canonical positions (all 46 by default);
    ``glove`` (max_tasks, glove_people * glove_window_size, glove_dim) f32.
    ``separability`` scales the class signal against the noise.
    """
    if people_positions is None:
        people_positions = list(range(cfg.max_people))
    rng = np.random.default_rng(seed)
    profiles = _stim_profiles(cfg)[:, : cfg.emg_dim]
    n_people = len(people_positions)
    shape = (cfg.max_tasks, n_people, cfg.max_reps, cfg.final_window_size,
             cfg.emg_dim)
    noise = rng.standard_normal(shape)
    cls = profiles[:, None, None, None, :] * separability
    person_gain = 1.0 + 0.1 * rng.standard_normal((1, n_people, 1, 1, 1))
    emg = (cls * person_gain + noise).astype(np.float32)
    # normalize like the ingest would (global, over train windows)
    emg = (emg - emg.mean()) / emg.std(axis=(0, 1, 2, 3), keepdims=True)

    protos = _glove_prototypes(cfg)
    keep = np.delete(np.arange(22), list(cfg.glove_drop_sensors))
    g_protos = protos[:, keep]
    d_g = glove_people * cfg.glove_window_size
    glove = g_protos[:, None, :] + rng.standard_normal(
        (cfg.max_tasks, d_g, cfg.glove_dim))
    glove = (glove - glove.mean((0, 1))) / glove.std((0, 1))
    return (emg.astype(np.float32), list(people_positions),
            glove.astype(np.float32))
