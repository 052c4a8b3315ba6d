"""Training over a mesh (the JAX package's ``parallel/spmd.py``), on
``torch.distributed``: each function returns ``(fn, place)``, as JAX's do.

* :func:`make_sharded_train_step`: one dp x mp sharded optimization
  step. ``place_state`` shards a state (``parallel/mesh.py::shard_state``)
  and ``step_fn`` runs ``Trainer._sgd_step`` under the mesh: the batch
  split over dp (gradients summed over dp), the wide dense kernels
  Megatron-sharded over mp.
* :func:`make_sharded_crossval_epoch`, :func:`make_sharded_crossval_eval`
  and :func:`make_sharded_crossval_run`: the sweep's config axis sharded
  over dp. Where JAX splits each chunk's configs over devices, each rank
  here trains whole chunks, round robin, each as one stacked model (on
  the fused chain and the fused encoder where the trainer asks, at that
  chunk's config axis), with exactly the generators the unsharded sweep
  gives that chunk (``train/crossval.py``): a chunk's dropout generator is
  seeded from its first config, so splitting a chunk would change its
  masks. Nothing is communicated until the values are gathered. With no
  mesh the same functions run the unsharded sweep, every chunk on this
  rank.

Every rank of the mesh calls each function with the same arguments.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from contrastiveprosthetics_torch.parallel.collectives import all_reduce_sum
from contrastiveprosthetics_torch.parallel.mesh import Mesh, shard_state


def make_sharded_train_step(trainer, mesh: Mesh):
    """Returns ``(step_fn, place_state)``: ``step_fn(state, emg_b, hyper,
    lr_emg, lr_glove, generator, glove_b=None) -> (loss, accuracy)`` on a
    state from ``place_state(state)``, given the global batch on every
    rank."""

    def place_state(state):
        return shard_state(state, mesh, trainer.hidden)

    def step_fn(state, emg_b, hyper, lr_emg, lr_glove, generator,
                glove_b=None):
        return trainer._sgd_step(state, emg_b, hyper, lr_emg, lr_glove,
                                 generator, glove_b=glove_b, mesh=mesh)

    return step_fn, place_state


class SweepChunk(NamedTuple):
    """One chunk of the sweep as a rank trains it."""

    rows: slice       # its configs' rows in the sweep
    hyper: tuple      # engine.Hyper of (C,) f32 tensors on the device
    generators: list  # one a config: init, then the index matrices
    generator: torch.Generator  # the chunk's dropout masks
    state: object     # the stacked TrainState


def _placer(trainer, mesh: Mesh | None):
    """``place(hypers, seed, chunk)``: this rank's chunks of the sweep of
    ``hypers`` (the sampler's (n,) arrays) in chunks of ``chunk``
    configs, round robin over dp (every chunk with no mesh), each
    initialised as the iteration reaches it, once the chunk before it is
    released: one chunk's state on the device at a time."""
    from contrastiveprosthetics_torch.train.crossval import chunk_inputs

    if mesh is not None and not mesh.active:
        raise ValueError("this rank is outside the mesh")
    dp_rank, n_dp = (0, 1) if mesh is None else (mesh.dp_rank, mesh.n_dp)

    def place(hypers, seed: int, chunk: int):
        n = len(np.asarray(hypers.lr_emg))
        for start in range(0, n, chunk)[dp_rank::n_dp]:
            rows = slice(start, min(start + chunk, n))
            h, generators, generator = chunk_inputs(trainer, hypers, seed,
                                                    rows)
            state, h = trainer.sweep_start(h, generators, generator)
            yield SweepChunk(rows, h, generators, generator, state)
            del state, h

    return place


def make_sharded_crossval_epoch(trainer, mesh: Mesh | None):
    """Returns ``(epoch_fn, place)``: ``epoch_fn(chunk, lr_emg_factor,
    lr_glove_factor) -> (C, steps)`` losses and accuracies of one epoch of
    a chunk from ``place`` (``_placer``), on this rank."""

    def epoch_fn(chunk: SweepChunk, f_e: float, f_g: float):
        return trainer.sweep_epoch(chunk.state, chunk.hyper, chunk.generators,
                                   f_e, f_g, chunk.generator)

    return epoch_fn, _placer(trainer, mesh)


def make_sharded_crossval_eval(trainer, mesh: Mesh | None):
    """Returns ``(eval_fn, place)``: ``eval_fn(chunk) -> (C,)`` val losses
    and voted accuracies of a chunk from ``place``, on this rank."""

    def eval_fn(chunk: SweepChunk):
        return trainer.sweep_validate(chunk.state, chunk.generators)

    return eval_fn, _placer(trainer, mesh)


def make_sharded_crossval_run(trainer, mesh: Mesh | None):
    """Returns ``(run_fn, place)``: ``run_fn(chunks, n, emg_factors,
    glove_factors) -> (n, 2)`` (val loss, voted val accuracy; f32, f64 in
    a float64 trainer) of every config on every rank, for ``chunks =
    place(hypers, seed, chunk)``: each chunk trained one epoch per
    schedule factor and validated, then each config's row, written by the
    one rank that trained it into a zeroed buffer, gathered by one
    all-reduce (bit for bit). With no mesh
    (``train/crossval.py``'s unsharded sweep) this rank trains every
    chunk and nothing is communicated."""
    epoch_fn, place = make_sharded_crossval_epoch(trainer, mesh)
    eval_fn, _ = make_sharded_crossval_eval(trainer, mesh)

    def run_fn(chunks, n: int, emg_factors, glove_factors):
        values = torch.zeros((n, 2), device=trainer.device,
                             dtype=torch.promote_types(trainer.dtype,
                                                       torch.float32))
        for chunk in chunks:
            for f_e, f_g in zip(emg_factors, glove_factors):
                epoch_fn(chunk, f_e, f_g)
            values[chunk.rows] = torch.stack(eval_fn(chunk), 1)
            del chunk  # its state, before the next chunk's is built
        return values if mesh is None else all_reduce_sum(values,
                                                          mesh.dp_group)

    return run_fn, place
