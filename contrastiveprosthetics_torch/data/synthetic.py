"""Synthetic Ninapro-layout data: raw ``.mat`` trees and already-ingested
tensors.

The port's copy of the JAX package's ``data/synthetic.py``. It is numpy
end to end, so for the same arguments its arrays and files equal the JAX
package's byte for byte. The real DB2/DB3 corpus (~10 GB) needs a
download; these fixtures take its on-disk layout (reference
``load.py:78-83``, ``utils.py:197-202``):

  root/db{2,3}/s{p}/S{p}_E{1,2}_A1.mat  keys: emg (T, 12), restimulus
                                        (T, 1), rerepetition (T, 1)
  root/s_{p}_angles/S{p}_E{1,2}_A1.mat  keys: angles (T, 22), restimulus,
                                        rerepetition

E1 carries stimuli 0..17, E2 18..40 (the reference routes a stimulus to
its file by ``searchsorted(TASK_DIST.cumsum(), stim)``, ``load.py:87``).
The signal is class-conditional (a per-stimulus channel-amplitude profile
shared across subjects, times a per-subject gain, plus noise), so a model
trained on it learns. ``make_processed_dataset`` fabricates the ingested,
normalized tensor directly.
"""
from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import scipy.io as sio

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


def _segment(
    rng: np.random.Generator,
    profile: np.ndarray,
    person_gain: float,
    n_samples: int,
) -> np.ndarray:
    """One (stim, rep) raw-EMG segment: amplitude-modulated broadband noise
    at EMG scale (~1e-4 V, like real Ninapro recordings)."""
    noise = rng.standard_normal((n_samples, profile.shape[0]))
    return (noise * profile[None, :] * person_gain * 1e-4).astype(np.float64)


def write_emg_mat_files(
    root: str,
    cfg: Config,
    people_positions: Sequence[int],
    seed: int = 0,
    samples_per_rep: int | None = None,
) -> None:
    """Write db2/db3 ``.mat`` files for the given canonical-person
    *positions* (rows of the canonical ordering ``cfg.people()``)."""
    n = samples_per_rep or (cfg.ingest_segment_len + 10)
    profiles = _stim_profiles(cfg)
    people = cfg.people()
    for pos in people_positions:
        person = int(people[pos])
        rng = np.random.default_rng(seed + 1000 + person)
        gain = 0.8 + 0.4 * rng.random()
        dbnum = "3" if person >= cfg.max_people_d2 else "2"
        subject = person % cfg.max_people_d2 if dbnum == "3" else person
        p_dir = str(subject + 1)
        for ex, stims in (("1", range(0, 18)), ("2", range(18, 41))):
            chunks, stim_col, rep_col = [], [], []
            for stim in stims:
                for rep in range(1, cfg.max_reps + 1):
                    seg = _segment(rng, profiles[stim], gain, n)
                    chunks.append(seg)
                    stim_col.append(np.full((n, 1), stim, dtype=np.int32))
                    rep_col.append(np.full((n, 1), rep, dtype=np.int32))
            d = os.path.join(root, f"db{dbnum}", f"s{p_dir}")
            os.makedirs(d, exist_ok=True)
            sio.savemat(
                os.path.join(d, f"S{p_dir}_E{ex}_A1.mat"),
                {
                    "emg": np.concatenate(chunks, axis=0),
                    "restimulus": np.concatenate(stim_col, axis=0),
                    "rerepetition": np.concatenate(rep_col, axis=0),
                },
            )


def write_glove_mat_files(
    root: str,
    cfg: Config,
    people: Sequence[int] | None = None,
    seed: int = 0,
    frames_per_rep: int = 30,
) -> None:
    """Write the glove-angle corpus (reference ``utils.py:197-215``) for raw
    subject numbers (default: the canonical 28..66)."""
    if people is None:
        people = range(cfg.glove_people_start, cfg.glove_people_stop)
    protos = _glove_prototypes(cfg)
    for person in people:
        rng = np.random.default_rng(seed + 5000 + person)
        p_dir = str(person + 1)
        for ex, stims in (("1", range(0, 18)), ("2", range(18, 41))):
            chunks, stim_col, rep_col = [], [], []
            for stim in stims:
                for rep in range(1, cfg.max_reps + 1):
                    ang = protos[stim][None, :] + rng.standard_normal(
                        (frames_per_rep, 22)
                    )
                    chunks.append(ang)
                    stim_col.append(
                        np.full((frames_per_rep, 1), stim, dtype=np.int32)
                    )
                    rep_col.append(
                        np.full((frames_per_rep, 1), rep, dtype=np.int32)
                    )
            d = os.path.join(root, f"s_{p_dir}_angles")
            os.makedirs(d, exist_ok=True)
            sio.savemat(
                os.path.join(d, f"S{p_dir}_E{ex}_A1.mat"),
                {
                    "angles": np.concatenate(chunks, axis=0),
                    "restimulus": np.concatenate(stim_col, axis=0),
                    "rerepetition": np.concatenate(rep_col, axis=0),
                },
            )


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
