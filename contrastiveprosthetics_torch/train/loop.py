"""The training loop and the test pass (reference ``train_loop``/``test``,
``train.py:27-138``; the JAX package's ``train/loop.py``).

Checkpoint rule: by default the checkpoint is saved when the val loss is
<= the *min* so far; ``compat_checkpoint_on_max`` reproduces the
reference's ``<= max(val_losses)`` (train.py:122-126), which saves on
nearly every epoch.

Randomness: ``seed`` seeds two generators on the trainer's device, one for
the init and the epochs, one for validation, so the weights a seed trains
do not depend on whether every epoch is validated.

Precision: the trainer's ``compute_dtype`` (``cptorch-train --bf16``) sets
the dtype of the model it initialises; an ``init_state`` keeps its own
model's, and the checkpoint is the f32 reference state_dict in either.
"""
from __future__ import annotations

import dataclasses

from contrastiveprosthetics_torch.train.checkpoint import save_checkpoint
from contrastiveprosthetics_torch.train.engine import (
    EvalResult,
    Hyper,
    Trainer,
    TrainState,
)
from contrastiveprosthetics_torch.train.schedules import schedule_factors


@dataclasses.dataclass
class LoopResult:
    val_loss: float
    val_acc: float
    train_losses: list
    train_accs: list
    state: TrainState


def train_loop(trainer: Trainer, hyper: Hyper, epochs: int, seed: int,
               annealing: bool = False, checkpoint: bool = False,
               checkpoint_path: str | None = None,
               init_state: TrainState | None = None,
               verbose: bool = True) -> LoopResult:
    """Train ``epochs`` epochs; validate every epoch when verbose or
    checkpointing, else after the last (train.py:92-136)."""
    gen = trainer.generator(seed)
    val_gen = trainer.generator(seed + 1)
    state = init_state if init_state is not None else trainer.init_state(gen)
    emg_f, glove_f = schedule_factors(epochs, annealing,
                                      trainer.cfg.compat_shared_steplr)
    threshold = max if trainer.cfg.compat_checkpoint_on_max else min
    val_losses, train_losses, train_accs = [], [], []
    loss_val = acc_val = float("nan")
    for e in range(epochs):
        state, loss_t, acc_t = trainer.train_epoch(
            state, gen, hyper, float(emg_f[e]), float(glove_f[e]))
        train_losses.append(float(loss_t))  # the epoch's one host sync
        train_accs.append(float(acc_t))
        if verbose or checkpoint or e == epochs - 1:
            res = trainer.evaluate(state, val_gen, hyper, split="val")
            loss_val, acc_val = float(res.loss), float(res.accuracy)
            val_losses.append(loss_val)
            if verbose:
                print(f"Epoch {e}. Train loss: {train_losses[-1]:.4f}\t"
                      f"Val loss: {loss_val:.4f}\tVal acc: {acc_val:.6f}\t"
                      f"Train acc: {train_accs[-1]:.4f}")
        if (checkpoint and checkpoint_path and val_losses
                and loss_val <= threshold(val_losses)):
            save_checkpoint(checkpoint_path, state)
    return LoopResult(val_loss=loss_val, val_acc=acc_val,
                      train_losses=train_losses, train_accs=train_accs,
                      state=state)


def run_test(trainer: Trainer, state: TrainState, hyper: Hyper,
             generator) -> EvalResult:
    """The test pass (train.py:27-44): batches of ``8 * batch_size``."""
    return trainer.evaluate(state, generator, hyper, split="test")
