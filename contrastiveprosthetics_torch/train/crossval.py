"""Random-search cross-validation: the host-side helpers (the JAX
package's ``train/crossval.py:38-72,256-265``; reference
``train.py:140-198``).

The sampler draws from numpy (seed 42 by default), so both packages get
the same configs. The keys and values ``.npy`` files keep the reference's
layout. The sweep itself (``cross_validate``) is not ported yet.
"""
from __future__ import annotations

import os

import numpy as np

from contrastiveprosthetics_torch.train.engine import Hyper


def sample_hyperparams(n: int, seed: int = 42) -> Hyper:
    """The reference's distributions (train.py:175-192): log-uniform lr in
    [1e-6, 1e-1] and reg in [1e-9, 1e-1]; dropout U(.4, .6) for EMG,
    U(0, .9) for glove. Returns a Hyper of (n,) f32 arrays."""
    rng = np.random.default_rng(seed)
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return Hyper(
        lr_emg=f32(10 ** rng.uniform(-6, -1, n)),
        reg_emg=f32(10 ** rng.uniform(-9, -1, n)),
        dp_emg=f32(rng.uniform(0.4, 0.6, n)),
        lr_glove=f32(10 ** rng.uniform(-6, -1, n)),
        reg_glove=f32(10 ** rng.uniform(-9, -1, n)),
        dp_glove=f32(rng.uniform(0.0, 0.9, n)),
    )


def keys_array(hypers: Hyper, d_e: int) -> np.ndarray:
    """(n, 7) in the reference's column order: (d_e, lr_emg, reg_emg,
    dp_emg, lr_glove, reg_glove, dp_glove)."""
    cols = [np.asarray(c, np.float64).reshape(-1) for c in hypers]
    return np.stack([np.full(len(cols[0]), d_e, np.float64), *cols], axis=1)


def hyper_from_key(key_row: np.ndarray) -> tuple[int, Hyper]:
    """Inverse of :func:`keys_array` for one row (train.py:201-211)."""
    d_e, *values = [float(x) for x in key_row]
    return int(d_e), Hyper.single(*values)


def load_crossval(save_dir: str, id_: str = "") -> tuple[np.ndarray, np.ndarray]:
    """The ``--crossval_load`` cache (train.py:162-166)."""
    values = np.load(os.path.join(save_dir, f"cross_val_values{id_}.npy"))
    keys = np.load(os.path.join(save_dir, f"cross_val_keys{id_}.npy"))
    return values, keys


def best_config(values: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """nanargmax of the val accuracy (train.py:196-198)."""
    return keys[int(np.nanargmax(values[:, 1]))]
