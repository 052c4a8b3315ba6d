"""Signal-processing primitives for calibration and serving.

Counterpart of the JAX package's ``ops/signal.py:48-146``: the order-4
Butterworth band-pass in second-order sections (designed by scipy, the
reference's own oracle, ``utils.py:134-147``), its causal application in
transposed direct form II, and the valid-mode window-11 moving RMS
(``utils.py:151-156``).
"""
from __future__ import annotations

import numpy as np
import torch
from scipy import signal as _scipy_signal


def butter_bandpass_sos(
    low_hz: float, high_hz: float, fs: float, order: int = 4
) -> np.ndarray:
    """Butterworth band-pass as (n_sec, 6) float64 second-order sections."""
    nyq = fs / 2.0
    sos = _scipy_signal.butter(
        order, [low_hz / nyq, high_hz / nyq], btype="bandpass", output="sos"
    )
    return np.asarray(sos, dtype=np.float64)


def sosfilt(sos: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Biquad-cascade IIR along axis 0 of ``x`` from zero initial state.

    Same operation order as the JAX ``sosfilt`` scan body (and the serve
    tick, ``serve/stream.py:228-238``), vectorised over the trailing axes.
    The recursion is sequential in time, so this is a Python loop over the
    T samples.
    """
    n_sec = sos.shape[0]
    coef = [[sos[k, i] for i in range(6)] for k in range(n_sec)]
    z = [[torch.zeros_like(x[0]), torch.zeros_like(x[0])] for _ in range(n_sec)]
    out = torch.empty_like(x)
    for t in range(x.shape[0]):
        y = x[t]
        for k in range(n_sec):
            b0, b1, b2, _, a1, a2 = coef[k]
            yk = b0 * y + z[k][0]
            z[k] = [b1 * y - a1 * yk + z[k][1], b2 * y - a2 * yk]
            y = yk
        out[t] = y
    return out


def moving_rms(x: torch.Tensor, window: int = 11) -> torch.Tensor:
    """Window-``window`` moving RMS along axis 0, valid mode:
    (T, ...) -> (T - window + 1, ...). A cumulative-sum difference, clamped
    at 0 because f32 cancellation can leave tiny negatives."""
    csum = torch.cumsum(x * x, dim=0)
    csum = torch.cat([torch.zeros_like(csum[:1]), csum], dim=0)
    sums = torch.clamp(csum[window:] - csum[:-window], min=0.0)
    return torch.sqrt(sums / window)
