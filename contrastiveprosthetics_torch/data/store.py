"""Device-resident tensor store and split views.

Counterpart of the JAX package's ``data/store.py``: the whole normalized
EMG tensor (about 54 MB f32 for 46 people) lives on the store's device,
and every batch later is a gather driven by index tensors. The layout is
tasks-first, as the reference transposes it at load (``load.py:71``):
``emg[task, person_row, rep, frame, channel]``.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Sequence

import numpy as np
import torch

from contrastiveprosthetics_torch.config import Config


@dataclasses.dataclass(frozen=True)
class SplitView:
    """One split's gathered tensors (reference ``DB23.load_valid``,
    ``load.py:233-251``).

    ``emg_flat`` (n_tasks*P*R*output_dim, emg_dim) is indexed by the train
    sampler; ``emg_groups`` (n_tasks*P*R*100/output_dim, output_dim,
    emg_dim) by eval (vote groups); ``glove_flat`` (n_tasks*D_glove,
    glove_dim)."""

    split: str
    n_tasks: int
    n_people: int
    n_reps: int
    output_dim: int
    D: int
    D_glove: int
    emg_flat: torch.Tensor
    emg_groups: torch.Tensor
    glove_flat: torch.Tensor
    train: bool

    def check_indexing(self) -> None:
        """The reference's inline indexing self-check (``load.py:242-249``):
        item 1 of task 2 sits at flat index ``2*D + 1``."""
        emg_dim = self.emg_flat.shape[-1]
        if self.train:
            a = self.emg_flat[self.D * 2 + 1]
            b = self.emg_flat.reshape(self.n_tasks, -1, emg_dim)[2][1]
        else:
            a = self.emg_groups[self.D * 2 + 1]
            b = self.emg_groups.reshape(self.n_tasks, -1, self.output_dim,
                                        emg_dim)[2][1]
        if not torch.equal(a, b):
            raise AssertionError("split view indexing self-check failed")


class DeviceStore:
    """The full normalized dataset on ``device``, and its split views.

    ``people_positions`` names the canonical person rows present in
    ``emg_tasks_first``, so partial ingests work."""

    def __init__(self, cfg: Config, emg_tasks_first, people_positions:
                 Sequence[int], glove=None, device=None):
        self.cfg = cfg
        self.device = torch.device(device or "cpu")
        self.emg = torch.as_tensor(np.asarray(emg_tasks_first, np.float32),
                                   device=self.device)
        self.people_positions = np.asarray(list(people_positions), np.int64)
        self._row_of = {int(p): i for i, p in enumerate(self.people_positions)}
        if glove is None:
            # contrastive training never reads glove values (the class
            # encoder takes one-hot labels): a 1-frame placeholder corpus
            glove = np.zeros((cfg.max_tasks, 1, cfg.glove_dim), np.float32)
        self.glove = torch.as_tensor(np.asarray(glove, np.float32),
                                     device=self.device)

    @classmethod
    def load(cls, cfg: Config, data_dir: str, device=None) -> "DeviceStore":
        """``emg.npz`` (person-first, as ingested) and ``glove.npz``,
        transposed to the tasks-first layout."""
        with np.load(os.path.join(data_dir, "emg.npz")) as z:
            emg = np.transpose(z["emg"], (1, 0, 2, 3, 4))
            positions = z["people_positions"]
        glove_path = os.path.join(data_dir, "glove.npz")
        glove = None
        if os.path.exists(glove_path):
            with np.load(glove_path) as z:
                glove = z["glove"]
        return cls(cfg, emg, positions, glove, device=device)

    def _people_rows(self, db2: bool) -> np.ndarray:
        wanted = self.cfg.people_mask(db2=db2)
        rows = [self._row_of[int(p)] for p in wanted if int(p) in self._row_of]
        if not rows:
            raise ValueError(
                "none of the requested people are present in this store "
                f"(wanted positions {wanted.tolist()}, have "
                f"{self.people_positions.tolist()})")
        return np.asarray(rows, dtype=np.int64)

    def view(self, split: str, db2: bool = False) -> SplitView:
        """A split view: one gather over (task, person, rep)."""
        cfg = self.cfg
        train = split == "train"
        idx = dict(dtype=torch.int64, device=self.device)
        tasks = torch.as_tensor(cfg.tasks_mask(), **idx)
        people = torch.as_tensor(self._people_rows(db2), **idx)
        reps = torch.as_tensor(cfg.rep_mask(split, db2=db2), **idx)
        tensor = self.emg[tasks[:, None, None], people[None, :, None],
                          reps[None, None, :]]  # (n_tasks, P, R, 100, 12)
        n_tasks, P, R = tensor.shape[:3]
        output_dim = (cfg.final_window_size if train or not cfg.vote
                      else cfg.prediction_window_size)
        if train:
            D = P * R * cfg.final_window_size
        else:
            D = P * R * (cfg.amt_prediction_windows if cfg.vote else 1)
        return SplitView(
            split=split, n_tasks=int(n_tasks), n_people=int(P),
            n_reps=int(R), output_dim=int(output_dim), D=int(D),
            D_glove=int(self.glove.shape[1]),
            emg_flat=tensor.reshape(-1, cfg.emg_dim),
            emg_groups=tensor.reshape(-1, output_dim, cfg.emg_dim),
            glove_flat=self.glove[tasks].reshape(-1, cfg.glove_dim),
            train=train)
