"""The port's constants and data splits.

The port's own copy of the JAX package's ``config.py`` (reference
``code/constants.py``); a test holds every value equal to the JAX
package's, under the default and the compat config.

The canonical seed-0 orderings of subjects and tasks (reference
``constants.py:18-21,37-41``) are literals, so the splits do not depend on
any RNG library.

Compat flags (each reproduces a reference quirk; default = fixed):
  * ``compat_uint8_time_mask``: the reference's uint8 downsample index
    wraps mod 256 (``load.py:115``).
  * ``compat_shared_steplr``: both StepLR schedulers bound to the glove
    optimizer, so the EMG lr never decays in crossval (``train.py:79-80``).
  * ``compat_complete_stats``: scalar mean with per-channel std
    (``utils.py:100-124``).
  * ``compat_full_voting_bound``: the current code's 249 voting columns
    (``models.py:153``) instead of the shipped artifact's 24.
  * ``compat_checkpoint_on_max``: checkpoint when the val loss is <= the
    *max* so far (``train.py:122-126``) instead of the min.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

# the reference's x2^10 EMG prescale before filtering (load.py:87)
INGEST_PRESCALE = 2.0**10

# Canonical seed-0 orderings: np.random.seed(0); permutation(40);
# permutation(6); shuffle(arange(1,18)); shuffle(arange(18,41)).
D2_IDXS: Tuple[int, ...] = (
    22, 20, 25, 4, 10, 15, 28, 11, 18, 29, 27, 35, 37, 2, 39, 30, 34, 16,
    36, 8, 13, 5, 17, 14, 33, 7, 32, 1, 26, 12, 31, 24, 6, 23, 21, 19, 9,
    38, 3, 0,
)
D3_IDXS: Tuple[int, ...] = (3, 1, 4, 5, 2, 0)
TASKS_A: Tuple[int, ...] = (
    4, 12, 15, 11, 17, 8, 10, 2, 14, 9, 7, 13, 6, 5, 16, 1, 3,
)
TASKS_B: Tuple[int, ...] = (
    40, 33, 34, 31, 30, 39, 26, 36, 28, 22, 38, 23, 37, 18, 35, 20, 32, 29,
    24, 21, 27, 25, 19,
)

# DB3 subjects used (constants.py:6); remapped to 40..45 (constants.py:11)
PEOPLE_D3_RAW: Tuple[int, ...] = (2, 3, 4, 5, 8, 9)


@dataclasses.dataclass(frozen=True)
class Config:
    max_people_d2: int = 40
    max_people_d3: int = 6
    n_tasks_e1: int = 17            # exercise E1 stimuli
    n_tasks_e2: int = 23            # exercise E2 stimuli
    reps: Tuple[int, ...] = (1, 3, 4, 6, 2, 5)  # 1-based rep labels
    hz: int = 2000                  # raw EMG sample rate
    downsample: int = 100           # frames/sec after downsampling
    rms_window: int = 11            # RMS window, in raw samples
    total_window_size: int = 2000   # 1 s of raw signal
    vote: bool = True
    prediction_window_ms: int = 250
    hz_glove: int = 25
    glove_people_start: int = 28
    glove_people_stop: int = 67
    glove_drop_sensors: Tuple[int, ...] = (5, 10)
    glove_dim: int = 20
    emg_dim: int = 12
    data_dir: str = "data"
    seed: int = 42
    compat_uint8_time_mask: bool = False
    compat_shared_steplr: bool = False
    compat_complete_stats: bool = False
    compat_full_voting_bound: bool = False
    compat_checkpoint_on_max: bool = False

    @property
    def max_people(self) -> int:
        return self.max_people_d2 + self.max_people_d3

    @property
    def max_tasks(self) -> int:
        """17 + 23 stimuli + rest (class 0) = 41 classes."""
        return self.n_tasks_e1 + self.n_tasks_e2 + 1

    @property
    def task_dist(self) -> np.ndarray:
        return np.array([self.n_tasks_e1, self.n_tasks_e2])

    @property
    def max_reps(self) -> int:
        return len(self.reps)

    @property
    def reps_train(self) -> Tuple[int, ...]:
        return self.reps[:-2]

    @property
    def reps_test(self) -> Tuple[int, ...]:
        return self.reps[-2:]

    @property
    def rep_train_idx(self) -> np.ndarray:
        return (np.asarray(self.reps_train) - 1)[:-1]   # [0, 2, 3]

    @property
    def rep_val_idx(self) -> np.ndarray:
        return (np.asarray(self.reps_train) - 1)[-1:]   # [5]

    @property
    def rep_test_idx(self) -> np.ndarray:
        return np.asarray(self.reps_test) - 1           # [1, 4]

    @property
    def factor(self) -> int:
        """Raw samples per 10 ms control tick (20)."""
        return self.hz // self.downsample

    @property
    def window_edge(self) -> int:
        return (self.rms_window - 1) // 2

    @property
    def final_window_size(self) -> int:
        """Frames per 1 s window (100)."""
        return self.total_window_size // self.factor

    @property
    def prediction_window_size(self) -> int:
        """Vote window in frames: 250 ms at 100 Hz = 25."""
        return self.prediction_window_ms * self.downsample // 1000

    @property
    def amt_prediction_windows(self) -> int:
        return self.final_window_size // self.prediction_window_size

    @property
    def n_voting_cols(self) -> int:
        """24 prefix columns (the shipped voting.npy); 249 under
        ``compat_full_voting_bound``."""
        if self.compat_full_voting_bound:
            return self.prediction_window_ms - 1
        return self.prediction_window_size - 1

    @property
    def glove_factor(self) -> int:
        return self.hz // self.hz_glove

    @property
    def glove_window_size(self) -> int:
        return self.total_window_size // self.glove_factor

    @property
    def ingest_segment_len(self) -> int:
        return self.total_window_size + 2 * self.window_edge

    # ---------------------------------------------------------------- splits
    def people_d2(self) -> np.ndarray:
        return np.asarray(D2_IDXS)

    def people_d3(self) -> np.ndarray:
        remapped = np.asarray(PEOPLE_D3_RAW) + self.max_people_d2 - 1
        return remapped[np.asarray(D3_IDXS)]

    def people(self) -> np.ndarray:
        """Canonical person ordering: rows of the ingested EMG tensor."""
        return np.concatenate([self.people_d2(), self.people_d3()])

    def tasks(self) -> np.ndarray:
        return np.concatenate([np.asarray(TASKS_A), np.asarray(TASKS_B)])

    def tasks_mask(self) -> np.ndarray:
        """Shuffled tasks + rest: the row order of every view
        (load.py:157-163)."""
        return np.concatenate([self.tasks(), [0]]).astype(np.int64)

    def people_mask(self, db2: bool = False) -> np.ndarray:
        """DB3 (amputees) by default, DB2 with ``db2=True``
        (load.py:179-183); values index the EMG tensor's person axis."""
        if db2:
            return np.asarray(D2_IDXS, dtype=np.int64)
        return np.asarray(D3_IDXS, dtype=np.int64) + self.max_people_d2

    def rep_mask(self, split: str, db2: bool = False) -> np.ndarray:
        """Rep indices of a split (load.py:190-203)."""
        if split == "train":
            if db2:
                return np.concatenate([self.rep_train_idx, self.rep_test_idx])
            return self.rep_train_idx
        if split == "val":
            return self.rep_val_idx
        if split == "test":
            return self.rep_val_idx if db2 else self.rep_test_idx
        raise ValueError(f"unknown split {split!r}")

    def time_mask(self) -> np.ndarray:
        """Downsample index into the RMS'd window (load.py:115)."""
        if self.compat_uint8_time_mask:
            return np.arange(0, self.total_window_size, self.factor,
                             dtype=np.uint8).astype(np.int64)
        return np.arange(0, self.total_window_size, self.factor,
                         dtype=np.int64)

    def train_person_set(self) -> np.ndarray:
        return self.people()


DEFAULT_CONFIG = Config()


def compat_config(cfg: Config = DEFAULT_CONFIG) -> Config:
    """``cfg`` with every reference quirk switched on."""
    return dataclasses.replace(
        cfg,
        compat_uint8_time_mask=True,
        compat_shared_steplr=True,
        compat_complete_stats=True,
        compat_full_voting_bound=True,
        compat_checkpoint_on_max=True,
    )
