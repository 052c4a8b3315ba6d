"""Checkpoints (reference ``torch.save(model.state_dict())``,
``train.py:122-126``; reload at ``train.py:216``).

``contrastive.pt`` is exactly the reference ``Model.state_dict()`` (on the
CPU), so ``cptorch-serve --checkpoint`` and ``model_from_state_dict`` load
it with ``strict=True``. Both Adam chains go to a sibling file
(``contrastive.adam.pt``), so ``--load_model`` resumes the optimizers too:
like the JAX package's checkpoint, a superset of the reference's.
"""
from __future__ import annotations

import os

import torch

from contrastiveprosthetics_torch.models.convert import (
    load_reference_checkpoint,
    model_from_state_dict,
)
from contrastiveprosthetics_torch.train.engine import AdamState, TrainState


def adam_path(path: str) -> str:
    """The Adam sibling of checkpoint ``path``."""
    return os.path.splitext(path)[0] + ".adam.pt"


def save_checkpoint(path: str, state: TrainState) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({k: v.detach().cpu()
                for k, v in state.model.state_dict().items()}, path)
    torch.save({name: {"count": opt.count,
                       "mu": [t.cpu() for t in opt.mu],
                       "nu": [t.cpu() for t in opt.nu]}
                for name, opt in (("emg_net", state.opt_emg),
                                  ("glove_net", state.opt_glove))},
               adam_path(path))


def load_checkpoint(path: str, device,
                    dtype: torch.dtype = torch.float32) -> TrainState:
    """The model of ``path`` on ``device``, its EMG tower computing in
    ``dtype`` (a checkpoint carries none), with the Adam chains of its
    sibling file where there is one (fresh chains otherwise, as after a
    reference checkpoint)."""
    model = model_from_state_dict(load_reference_checkpoint(path),
                                  dtype=dtype).to(device)
    state = TrainState.fresh(model)
    if os.path.exists(adam_path(path)):
        saved = torch.load(adam_path(path), map_location=device,
                           weights_only=True)
        state.opt_emg = AdamState(**saved["emg_net"])
        state.opt_glove = AdamState(**saved["glove_net"])
    return state
