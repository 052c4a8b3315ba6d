"""Random-search cross-validation (the JAX package's
``train/crossval.py``; reference ``train.py:140-198``).

The reference trains its 150 random configs one after another. Here a
chunk of configs trains as one stacked model (``models/stacked.py``,
``Trainer.sweep_chunk``): every step is one stacked step for all the
chunk's configs, so the host's kernel launches are paid once per chunk,
not once per config. ``chunk`` bounds the card's memory.

The sampler draws from numpy (seed 42 by default), so both packages get
the same configs. The keys and values ``.npy`` files keep the reference's
layout.

The chunks run through ``parallel/spmd.py::make_sharded_crossval_run``,
with or without a mesh. ``cross_validate(mesh=)`` shards the configs over
the mesh's dp ranks: each rank trains whole chunks, round robin, with
the generators it gives them unsharded, so the sharded sweep equals the
unsharded one at the same chunk width, bit for bit.
"""
from __future__ import annotations

import os

import numpy as np

from contrastiveprosthetics_torch.parallel.spmd import (
    make_sharded_crossval_run,
)
from contrastiveprosthetics_torch.train.engine import Hyper, Trainer
from contrastiveprosthetics_torch.train.schedules import schedule_factors

# Configs trained at once by default: the best width of the chunk-width
# scan of chip_smoke.py (phase 9) on an H100, written down in PERF.md.
DEFAULT_SWEEP_CHUNK = 150


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


def resolve_chunk(n: int, n_dp: int = 1) -> int:
    """The default sweep-chunk width: ``DEFAULT_SWEEP_CHUNK`` configs,
    capped at the number of configs and, over ``n_dp`` ranks, at an even
    share of them, so that every rank gets a chunk."""
    return min(n, DEFAULT_SWEEP_CHUNK, -(-n // n_dp))


def config_seed(seed: int, index: int, stream: int = 0) -> int:
    """A 32-bit seed for stream ``stream`` of config (or chunk start)
    ``index`` of the sweep seeded ``seed``."""
    return int(np.random.SeedSequence([seed, index, stream]).generate_state(
        1)[0])


def cross_validate(trainer: Trainer, hypers: Hyper, epochs: int, seed: int,
                   chunk: int | None = None, save_dir: str | None = None,
                   verbose: bool = True, id_: str = "",
                   mesh=None) -> np.ndarray:
    """Train every config of ``hypers`` (the sampler's (n,) arrays) for
    ``epochs`` epochs without annealing, in chunks of ``chunk`` configs,
    and return the (n, 2) f64 values (val loss, voted val accuracy) per
    config. A last chunk with fewer configs runs as a smaller stacked
    model. Config i's init and index matrices come from a generator seeded
    from (``seed``, i), so they do not depend on the chunk width; each
    chunk's dropout masks come from a generator seeded from (``seed``, its
    first config). ``save_dir``: write ``cross_val_values{id_}.npy`` and
    ``cross_val_keys{id_}.npy`` there (train.py:157-166).

    ``mesh``: a ``parallel/mesh.py::Mesh`` whose dp ranks share the
    chunks (see the module docstring); every rank of it calls this and
    gets every config's values; the mesh's first rank alone prints and
    writes the files."""
    n = len(np.asarray(hypers.lr_emg))
    if n < 1:
        raise ValueError(
            "cross_validate needs at least one config (the CLI maps "
            "--crossval_size 0 to the canonical hyperparameters instead)")
    n_dp = 1 if mesh is None else mesh.n_dp
    chunk = resolve_chunk(n, n_dp) if chunk is None else chunk
    if chunk < 1:
        raise ValueError(f"the sweep's chunk must be at least 1 config, "
                         f"got {chunk}")
    emg_f, glove_f = schedule_factors(
        epochs, annealing=False,
        compat_shared_steplr=trainer.cfg.compat_shared_steplr)
    run_fn, place = make_sharded_crossval_run(trainer, mesh)
    # one read of the device's values, after every chunk
    values = run_fn(place(hypers, seed, chunk), n, emg_f, glove_f
                    ).cpu().numpy().astype(np.float64)
    if mesh is not None and (mesh.dp_rank or mesh.mp_rank):
        return values
    if verbose:
        print(f"crossval [{n}/{n}]: best acc {np.nanmax(values[:, 1]):.4f}")
    if save_dir is not None:
        os.makedirs(save_dir, exist_ok=True)
        np.save(os.path.join(save_dir, f"cross_val_values{id_}.npy"), values)
        np.save(os.path.join(save_dir, f"cross_val_keys{id_}.npy"),
                keys_array(hypers, trainer.d_e))
    return values


def chunk_inputs(trainer: Trainer, hypers: Hyper, seed: int,
                 rows: slice):
    """The chunk of configs ``rows``: its (C,) hyperparameters, one
    generator a config seeded from (``seed``, config) and the dropout
    generator seeded from (``seed``, its first config)."""
    h = Hyper(*[np.asarray(x)[rows] for x in hypers])
    generators = [trainer.generator(config_seed(seed, i))
                  for i in range(rows.start, rows.stop)]
    return h, generators, trainer.generator(config_seed(seed, rows.start,
                                                         stream=1))
