"""The serving path's constants.

The port's own copy of the values it needs from the JAX package's
``config.py`` (reference ``code/constants.py:60-96``); a test holds them
equal to the JAX package's ``DEFAULT_CONFIG``.
"""
from __future__ import annotations

import dataclasses

# the reference's x2^10 EMG prescale before filtering (load.py:87)
INGEST_PRESCALE = 2.0**10


@dataclasses.dataclass(frozen=True)
class Config:
    hz: int = 2000                  # raw EMG sample rate
    downsample: int = 100           # frames/sec after downsampling
    rms_window: int = 11            # RMS window, in raw samples
    prediction_window_ms: int = 250
    emg_dim: int = 12
    glove_dim: int = 20
    n_tasks_e1: int = 17
    n_tasks_e2: int = 23

    @property
    def factor(self) -> int:
        """Raw samples per 10 ms control tick (20)."""
        return self.hz // self.downsample

    @property
    def prediction_window_size(self) -> int:
        """Vote window in frames: 250 ms at 100 Hz = 25."""
        return self.prediction_window_ms * self.downsample // 1000

    @property
    def max_tasks(self) -> int:
        """17 + 23 stimuli + rest (class 0) = 41 classes."""
        return self.n_tasks_e1 + self.n_tasks_e2 + 1


DEFAULT_CONFIG = Config()
