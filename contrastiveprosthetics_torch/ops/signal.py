"""Signal-processing primitives for ingest, calibration and serving.

Counterpart of the JAX package's ``ops/signal.py``: the order-4 Butterworth
band-pass (designed by scipy, the reference's own oracle,
``utils.py:134-147``) in (b, a) form and in second-order sections, its
causal application in transposed direct form II (``sosfilt``; ``lfilter``
for the (b, a) form, kept for API parity and on no path), and the
ingest's per-segment pipeline, batched: :func:`preprocess_segments`
(prescale -> band-pass -> window-11 RMS, ``utils.py:151-156`` -> downsample),
which runs the ``iir_rms_frames`` kernel on CUDA tensors
(``ops/kernels.py``).
"""
from __future__ import annotations

import numpy as np
import torch
from scipy import signal as _scipy_signal

from contrastiveprosthetics_torch.ops import kernels


def butter_bandpass(
    low_hz: float, high_hz: float, fs: float, order: int = 4
) -> tuple[np.ndarray, np.ndarray]:
    """Butterworth band-pass as float64 (b, a), a0 normalized to 1
    (reference ``utils.py:134-147``: order 4, 20-450 Hz at 2 kHz)."""
    nyq = fs / 2.0
    b, a = _scipy_signal.butter(
        order, [low_hz / nyq, high_hz / nyq], btype="bandpass"
    )
    return np.asarray(b, dtype=np.float64), np.asarray(a, dtype=np.float64)


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


def lfilter(b, a, x: torch.Tensor) -> torch.Tensor:
    """Causal IIR in (b, a) form along axis 0 of ``x``, transposed direct
    form II from zero state, in ``x``'s dtype (the JAX ``lfilter``'s
    operation order): y[n] = b0 x[n] + z0; z_i = b_(i+1) x[n] - a_(i+1) y[n]
    + z_(i+1). A Python loop over the T samples, vectorised over the
    trailing axes; on no path (the ingest filters in sections)."""
    b = torch.as_tensor(b, dtype=x.dtype, device=x.device)
    a = torch.as_tensor(a, dtype=x.dtype, device=x.device)
    b, a = b / a[0], a / a[0]
    order = b.shape[0] - 1
    taps = (order,) + (1,) * (x.dim() - 1)
    b_taps, a_taps = b[1:].reshape(taps), a[1:].reshape(taps)
    z = x.new_zeros((order,) + tuple(x.shape[1:]))
    out = torch.empty_like(x)
    for t in range(x.shape[0]):
        y = b[0] * x[t] + z[0]
        z_new = b_taps * x[t] - a_taps * y
        z_new[:-1] += z[1:]
        z = z_new
        out[t] = y
    return out


def time_mask_stride(time_mask) -> int | None:
    """The stride ``s`` when ``time_mask`` is ``0, s, 2s, ...`` (the default
    ``Config.time_mask()``), else None (the compat uint8 mask wraps and
    repeats)."""
    idx = np.asarray(time_mask, dtype=np.int64)
    if idx.size == 0 or idx[0] != 0:
        return None
    if idx.size == 1:
        return 1
    step = int(idx[1])
    ok = step > 0 and np.array_equal(idx, np.arange(idx.size) * step)
    return step if ok else None


def preprocess_segments(x: torch.Tensor, sos: torch.Tensor, time_mask,
                        rows: torch.Tensor | None = None) -> torch.Tensor:
    """The JAX ``preprocess_segment`` batched over segments (what the JAX
    ingest vmaps): raw ``x`` (B, T, D) f32, or with ``rows`` (B, T) int32
    the segments' rows of a recording ``x`` (N, D) -> x ``INGEST_PRESCALE``
    -> SOS band-pass from zero state -> window-11 RMS (trimmed to full
    windows) -> the frames at ``time_mask`` -> (B, len(time_mask), D).

    One ``iir_rms_frames`` call computes the frames that start at multiples
    of a stride: for a plain-stride mask (the default) at that stride and
    no more frames than the mask takes; for any other mask (the compat
    uint8 one) at stride 1 up to its largest index, then a gather. On CPU
    tensors the kernel's plain version runs."""
    idx = np.asarray(time_mask, dtype=np.int64)
    stride = time_mask_stride(idx)
    if stride is not None:
        return kernels.iir_rms_frames(x, sos, stride, idx.size, rows=rows)
    frames = kernels.iir_rms_frames(x, sos, 1, int(idx.max()) + 1, rows=rows)
    return frames.index_select(1, torch.as_tensor(idx, device=x.device))
