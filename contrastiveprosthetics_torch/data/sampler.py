"""Per-task sampling as index math on the device (reference
``TaskWrapper``, ``utils.py:21-76``; the JAX package's
``data/sampler.py``).

Each epoch draws, for every task, a random permutation of that task's D
windows (``rand().argsort() + task_offset``, ``utils.py:34-36``); item
``i`` of a batch then takes one window of *every* task, labelled
``arange(n_tasks)``. Every draw takes an explicit ``torch.Generator`` on
the device the indices are made on. The index tensors are int64.
"""
from __future__ import annotations

import torch


def task_permutations(generator: torch.Generator, n_tasks: int,
                      D: int) -> torch.Tensor:
    """(n_tasks, D) on the generator's device: row ``t`` is a permutation
    of ``[tD, (t+1)D)``."""
    device = generator.device
    perms = torch.rand((n_tasks, D), generator=generator,
                       device=device).argsort(dim=1)
    return perms + torch.arange(n_tasks, device=device)[:, None] * D


def identity_permutations(n_tasks: int, D: int, device=None) -> torch.Tensor:
    """(n_tasks, D): row ``t`` is ``[tD, (t+1)D)`` in order."""
    return torch.arange(n_tasks * D, device=device).reshape(n_tasks, D)


def epoch_batches(generator: torch.Generator, D: int,
                  batch_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(batches, tail)`` item indices for one epoch: DataLoader
    ``shuffle=True, drop_last=False`` (``train.py:86``). ``batches`` is
    (n_batches, bs), ``tail`` the (D % bs,) remainder, which trains as a
    smaller batch. ``batch_size`` is clamped to D."""
    bs = min(batch_size, D)
    order = torch.randperm(D, generator=generator, device=generator.device)
    n = D // bs
    return order[: n * bs].reshape(n, bs), order[n * bs:]


def epoch_batches_padded(generator: torch.Generator, D: int,
                         batch_size: int):
    """Like :func:`epoch_batches` but every item is covered once: the last
    batch is padded by wrapping the permutation. Returns ``(batches,
    weights, inverse)``: (n_batches, bs) item ids, (n_batches, bs) f32
    weights (0 for pad duplicates), and the (D,) inverse permutation from
    item id to its first position in ``batches.reshape(-1)``."""
    order = torch.randperm(D, generator=generator, device=generator.device)
    return pad_batches(order, min(batch_size, D))


def pad_batches(order: torch.Tensor, batch_size: int):
    """``(batches, weights, inverse)`` of :func:`epoch_batches_padded` for
    a given item ``order``."""
    D = order.shape[0]
    n = -(-D // batch_size)
    pad = n * batch_size - D
    padded = torch.cat([order, order[:pad]])
    weights = torch.cat([torch.ones(D, device=order.device),
                         torch.zeros(pad, device=order.device)])
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(D, device=order.device)
    return (padded.reshape(n, batch_size), weights.reshape(n, batch_size),
            inverse)


def gather_train_batch(emg_flat, emg_rand, items) -> torch.Tensor:
    """(bs, n_tasks, emg_dim): one window per task per item
    (``utils.py:51-64``, ``load.py:256-259``)."""
    return emg_flat[emg_rand[:, items].T]


def gather_eval_batch(emg_groups, emg_rand, items) -> torch.Tensor:
    """(bs, n_tasks, output_dim, emg_dim): one vote group per task per
    item (``load.py:264-266``)."""
    return emg_groups[emg_rand[:, items].T]


def gather_glove_batch(glove_flat, glove_rand, items,
                       D_glove: int) -> torch.Tensor:
    """(bs, n_tasks, glove_dim): one glove row per task per item, items
    wrapping modulo the glove corpus size ``D_glove`` (``utils.py:53``;
    ``glove_rand`` is (n_tasks, D_glove))."""
    return glove_flat[glove_rand[:, items % D_glove].T]


# ---------------------------------------------------------- config axis
# The crossval sweep trains C configs at once; each config draws its own
# index matrices from its own generator, so a config's draws do not depend
# on which configs share its chunk. Row c of every result is config c's.
def stacked_task_permutations(generators, n_tasks: int,
                              D: int) -> torch.Tensor:
    """(C, n_tasks, D): :func:`task_permutations` of each generator."""
    return torch.stack([task_permutations(g, n_tasks, D) for g in generators])


def stacked_epoch_batches(generators, D: int, batch_size: int):
    """``(batches, tail)``, (C, n_batches, bs) and (C, D % bs):
    :func:`epoch_batches` of each generator."""
    batches, tails = zip(*[epoch_batches(g, D, batch_size)
                           for g in generators])
    return torch.stack(batches), torch.stack(tails)


def stacked_epoch_batches_padded(generators, D: int, batch_size: int):
    """``(batches, weights, inverse)``, (C, n_batches, bs) twice and (C,
    D): :func:`epoch_batches_padded` of each generator."""
    return tuple(torch.stack(parts) for parts in zip(
        *[epoch_batches_padded(g, D, batch_size) for g in generators]))


def _stacked_rows(emg_rand, items) -> torch.Tensor:
    """(C, bs, n_tasks) rows: ``emg_rand[c][:, items[c]].T`` per config."""
    n_tasks = emg_rand.shape[1]
    return emg_rand.gather(2, items[:, None, :].expand(-1, n_tasks, -1)
                           ).transpose(1, 2)


def stacked_gather_train_batch(emg_flat, emg_rand, items) -> torch.Tensor:
    """(C, bs, n_tasks, emg_dim) from ``emg_rand`` (C, n_tasks, D) and
    ``items`` (C, bs): :func:`gather_train_batch` per config."""
    return emg_flat[_stacked_rows(emg_rand, items)]


def stacked_gather_eval_batch(emg_groups, emg_rand, items) -> torch.Tensor:
    """(C, bs, n_tasks, output_dim, emg_dim): :func:`gather_eval_batch`
    per config."""
    return emg_groups[_stacked_rows(emg_rand, items)]


def stacked_gather_glove_batch(glove_flat, glove_rand, items,
                               D_glove: int) -> torch.Tensor:
    """(C, bs, n_tasks, glove_dim) from ``glove_rand`` (C, n_tasks,
    D_glove) and ``items`` (C, bs): :func:`gather_glove_batch` per
    config."""
    return glove_flat[_stacked_rows(glove_rand, items % D_glove)]
