"""PyTorch port: the ``iir_rms_frames`` CUDA source (``csrc/iir_rms.cu``),
the ingest's and the calibration's band-pass and RMS, run on the CPU
through ``tests/cuda_emulation.py`` against its plain version
(``ops/kernels.py``); and, marked ``cuda``, the kernel on the card.

The kernel repeats its plain version's arithmetic step by step (each IIR
section on its own lane, skewed two steps behind the one before it and fed
by a warp shuffle; the window sum; each operation rounded in the same
order, the root correctly rounded), so it is held bit for bit, as the card
holds it (``chip_smoke.py``). Shapes cross what the kernel tiles: CTAs of
two segments (24 chains of 4 lanes), an odd segment count (a CTA with one
segment), 80-step ring chunks with a ragged last one, the skew's 6-step
prologue against T = W, and the frame counts of ingest (stride 20, 100
frames of 2,010 samples), calibration (stride 20, 200 frames of 4,000)
and the compat mask (stride 1, 253 frames) on the kernel's two paths
(stride 20, and any other stride). With a row table the segments' samples
are rows of a recording: two files concatenated, a segment split into two
runs, a short one edge-padded, rows out of time order. The file imports
neither JAX nor the JAX package; on a GPU machine its ``cuda`` tests run
with

    python -m pytest tests/test_torch_port_ingest_emulated.py -m cuda --noconftest -q
"""
from __future__ import annotations

import ctypes

import numpy as np
import pytest
import torch

import cuda_emulation
from contrastiveprosthetics_torch.config import DEFAULT_CONFIG as CFG
from contrastiveprosthetics_torch.config import INGEST_PRESCALE
from contrastiveprosthetics_torch.ops import kernels as K
from contrastiveprosthetics_torch.ops.signal import (
    butter_bandpass_sos,
    preprocess_segments,
)

torch.set_num_threads(1)

P, I, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
D, W, N_SEC = 12, 11, 4

# (B, T, stride, n_frames): one subject's 246 segments; a calibration
# recording (50 ring chunks); the compat mask's stride 1 up to index 252;
# 37 segments (an odd count: the last CTA holds one); T = W and T = W +
# stride - 1 (one frame each, the skew's prologue longer than a window);
# stride 1 over 16 samples; fewer frames than the samples hold, at a
# stride of the any-stride path
SHAPES = [(246, 2010, 20, None), (1, 4000, 20, None), (5, 2010, 1, 253),
          (37, 2010, 20, None), (11, 11, 20, None), (11, 30, 20, None),
          (5, 16, 1, None), (3, 500, 7, 40)]


# (case, B, T, stride, n_frames) of the row-table cases (``_table``)
TABLES = [("two_files", 5, 400, 20, None), ("split_run", 3, 400, 20, None),
          ("short", 3, 400, 20, None), ("shuffled", 4, 300, 20, None),
          ("shuffled", 3, 300, 1, 120), ("one_window", 3, 11, 20, None),
          ("too_short", 3, 3, 20, None)]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if cuda_emulation.compiler() is None:
        pytest.skip("needs a host C++ compiler to emulate the kernel")
    out = cuda_emulation.build("iir_rms", tmp_path_factory.mktemp("emu"))
    out.iir_rms_frames_launch.argtypes = [P] * 4 + [I] * 8 + [F32, P]
    return out


def _ptr(t):
    return P(t.data_ptr() if t is not None else None)


def _sos(device="cpu"):
    return torch.tensor(butter_bandpass_sos(20, 450, CFG.hz),
                        dtype=torch.float32, device=device)


def _case(B, T, seed):
    """Raw EMG-scale segments, a per-channel gain, and a spike: the filter
    rings and the windows span several decades."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, D)) * rng.uniform(0.2, 3.0, (B, 1, D))
    x[:, T // 3] *= 50.0
    return torch.from_numpy((x * 1e-4).astype(np.float32))


def _table(case, B, T, seed):
    """A recording (N, D) and a (B, T) int32 row table into it, as the
    ingest builds them: ``two_files`` takes segments from both halves of
    two recordings laid end to end; ``split_run`` a segment whose samples
    are two runs with other labels between; ``short`` a segment of 37
    samples, its last row repeated; ``shuffled`` rows in no time order
    (repeats allowed); ``one_window`` and ``too_short`` T = W and T = 3."""
    rng = np.random.default_rng(seed)
    N = 1500
    x = rng.standard_normal((N, D)) * rng.uniform(0.2, 3.0, D)
    x[N // 3] *= 50.0
    starts = rng.integers(0, N - T, B)
    rows = starts[:, None] + np.arange(T)
    if case == "two_files":  # files of 700 and 800 rows
        rows[: B // 2] = rng.integers(0, 700 - T, B // 2)[:, None] + \
            np.arange(T)
        rows[B // 2:] = 700 + rng.integers(0, 800 - T, B - B // 2)[:, None] \
            + np.arange(T)
    elif case == "split_run":
        rows[1] = np.r_[100:100 + T // 3, 900:900 + T - T // 3]
    elif case == "short":
        rows[2] = np.minimum(np.arange(T), 36) + 1200
    elif case == "shuffled":
        rows = rng.integers(0, N, (B, T))
    return (torch.from_numpy((x * 1e-4).astype(np.float32)),
            torch.from_numpy(rows.astype(np.int32)))


def emu_iir_rms(lib, x, sos, stride, n_frames, rows=None, n_sec=N_SEC,
                rmsw=W, d=D, n=None):
    """The launcher on CPU tensors (``x`` (B, T, D), or a recording (N, D)
    with ``rows`` (B, T)), the output filled with NaN first: what it does
    not write shows. Returns (rc, frames)."""
    B, T = (x if rows is None else rows).shape[:2]
    if n is None:
        n = B * T if rows is None else x.shape[0]
    frames = torch.full((B, n_frames, D), float("nan"))
    rc = lib.iir_rms_frames_launch(_ptr(x), _ptr(rows), _ptr(sos),
                                   _ptr(frames), n, B, T, d, n_sec, rmsw,
                                   stride, n_frames, INGEST_PRESCALE, None)
    return rc, frames


@pytest.mark.parametrize("B,T,stride,n_frames", SHAPES)
def test_emulated_iir_rms_matches_plain_bit_for_bit(lib, B, T, stride,
                                                    n_frames):
    x, sos = _case(B, T, seed=B * T + stride), _sos()
    n = K.iir_rms_n_frames(T, stride, W, n_frames)
    rc, got = emu_iir_rms(lib, x, sos, stride, n)
    assert rc == 0
    want = K.iir_rms_frames_reference(x, sos, stride, n_frames)
    assert got.shape == want.shape == (B, n, D)
    assert torch.equal(got, want)


@pytest.mark.parametrize("case,B,T,stride,n_frames", TABLES)
def test_emulated_iir_rms_through_a_row_table_bit_for_bit(lib, case, B, T,
                                                         stride, n_frames):
    """With a row table the kernel reads each segment's samples from the
    recording: the plain version on ``x[rows]``, bit for bit."""
    x, rows = _table(case, B, T, seed=B * T + stride)
    sos = _sos()
    n = K.iir_rms_n_frames(T, stride, W, n_frames)
    rc, got = emu_iir_rms(lib, x, sos, stride, n, rows=rows)
    assert rc == 0
    want = K.iir_rms_frames_reference(x, sos, stride, n_frames, rows=rows)
    assert got.shape == want.shape == (B, n, D)
    assert torch.equal(got, want)
    assert torch.equal(want, K.iir_rms_frames_reference(
        x[rows.long()], sos, stride, n_frames))


def test_emulated_iir_rms_reads_no_row_outside_the_recording(lib):
    """A row outside [0, N) reads zeros, never memory past ``x``: the
    wrapper refuses such a table before any launch, and the kernel does not
    trust it either."""
    x, rows = _table("shuffled", 2, 60, seed=7)
    rows[0, 20], rows[1, 5] = x.shape[0], -3
    rc, got = emu_iir_rms(lib, x, _sos(), 20, 3, rows=rows)
    assert rc == 0
    zero = torch.cat([x, x.new_zeros((1, D))])
    safe = torch.where((rows >= 0) & (rows < x.shape[0]), rows, x.shape[0])
    assert torch.equal(got, K.iir_rms_frames_reference(zero, _sos(), 20, 3,
                                                       rows=safe))


def test_emulated_iir_rms_frames_are_the_trimmed_moving_rms(lib):
    """At stride 1 every frame is the valid-mode moving RMS of the filtered
    signal: against the float64 moving RMS of the same f32 ``sosfilt``
    output, within the f32 rounding of 11 squares and their sum (an f32
    cumulative-sum moving RMS is 2e-4 off here, after the spike)."""
    from contrastiveprosthetics_torch.ops.signal import sosfilt

    x, sos = _case(2, 300, seed=3), _sos()
    rc, got = emu_iir_rms(lib, x, sos, 1, 290)
    assert rc == 0
    y = sosfilt(sos, (x * INGEST_PRESCALE).transpose(0, 1)).double()
    sq = y * y
    want = torch.sqrt(sum(sq[k:k + 290] for k in range(W)) / W)
    torch.testing.assert_close(got.double(), want.transpose(0, 1),
                               rtol=2e-6, atol=0)


def test_emulated_launcher_refuses_what_it_is_not_built_for(lib):
    """(n_sec, rms_window, D) = (4, 11, 12) only, a stride of 1 or more,
    no frame whose window runs past T, without a table a recording of B x
    T rows, and 16-byte aligned input and frames. Refused calls return an
    error and write nothing."""
    x, sos = _case(2, 60, seed=5), _sos()
    for kw in (dict(n_sec=3), dict(rmsw=9), dict(d=8), dict(n=119)):
        rc, frames = emu_iir_rms(lib, x, sos, 20, 2, **kw)
        assert rc != 0 and torch.isnan(frames).all()
    for stride, n in ((0, 2), (20, 4), (1, 51)):
        rc, frames = emu_iir_rms(lib, x, sos, stride, n)
        assert rc != 0 and torch.isnan(frames).all()
    rc = lib.iir_rms_frames_launch(_ptr(x), None, _ptr(sos), _ptr(x), 120, 2,
                                   60, D, N_SEC, W, 20, -1, INGEST_PRESCALE,
                                   None)
    assert rc != 0
    flat = torch.full((2 * 60 * D + 1,), float("nan"))
    flat[1:] = x.reshape(-1)
    rc = lib.iir_rms_frames_launch(P(flat.data_ptr() + 4), None, _ptr(sos),
                                   _ptr(flat), 120, 2, 60, D, N_SEC, W, 20,
                                   2, INGEST_PRESCALE, None)
    assert rc != 0 and torch.isnan(flat[0])
    # the last whole window: (n - 1) * stride + W == T
    rc, frames = emu_iir_rms(lib, x, sos, 1, 50)
    assert rc == 0 and not torch.isnan(frames).any()


def test_frame_count_and_refusals_on_the_cpu_path():
    """The wrapper's frame count and its checks, which run before any
    launch; on CPU tensors it is the plain version."""
    assert K.iir_rms_n_frames(2010, 20, W) == 100
    assert K.iir_rms_n_frames(4000, 20, W) == 200
    assert K.iir_rms_n_frames(30, 20, W) == 1
    assert K.iir_rms_n_frames(10, 20, W) == 0
    assert K.iir_rms_n_frames(2010, 1, W, 253) == 253
    with pytest.raises(ValueError, match="whole windows"):
        K.iir_rms_n_frames(2010, 20, W, 101)
    with pytest.raises(ValueError, match="stride"):
        K.iir_rms_n_frames(2010, 0, W)
    x = _case(2, 40, seed=6)
    before = dict(K.launch_counts)
    out = K.iir_rms_frames(x, _sos(), 20)
    assert out.shape == (2, 2, D) and K.launch_counts == before
    torch.testing.assert_close(out, K.iir_rms_frames_reference(x, _sos(), 20),
                               rtol=0, atol=0)
    assert K.iir_rms_frames(x[:, :5], _sos(), 20).shape == (2, 0, D)


def test_row_table_refusals_before_any_launch():
    """The wrapper checks a row table before it runs anything: (B, T)
    int32 on ``x``'s device, ``x`` a recording (N, D), every row in [0,
    N)."""
    x, rows = _table("two_files", 4, 40, seed=3)
    out = K.iir_rms_frames(x, _sos(), 20, rows=rows)
    assert out.shape == (4, 2, D)
    for bad, match in ((rows.long(), "int32"), (rows[0], "int32"),
                       (torch.full_like(rows, x.shape[0]), "indices"),
                       (rows - 10 ** 6, "indices")):
        with pytest.raises(ValueError, match=match):
            K.iir_rms_frames(x, _sos(), 20, rows=bad)
    with pytest.raises(ValueError, match="want \\(N, D\\)"):
        K.iir_rms_frames(x[None], _sos(), 20, rows=rows)
    with pytest.raises(ValueError, match="indices"):
        preprocess_segments(x, _sos(), CFG.time_mask()[:2],
                            rows=rows + x.shape[0])


# ------------------------------------------------------------- on the card
@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,stride,n_frames", SHAPES)
def test_iir_rms_kernel_matches_plain(cuda, B, T, stride, n_frames):
    x, sos = _case(B, T, seed=B + T).to(cuda), _sos(cuda)
    before = K.launch_counts["iir_rms_frames"]
    got = K.iir_rms_frames(x, sos, stride, n_frames)
    want = K.iir_rms_frames_reference(x, sos, stride, n_frames)
    torch.cuda.synchronize()
    assert K.launch_counts["iir_rms_frames"] == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case,B,T,stride,n_frames", TABLES)
def test_iir_rms_kernel_through_a_row_table(cuda, case, B, T, stride,
                                            n_frames):
    x, rows = _table(case, B, T, seed=B + T)
    x, rows, sos = x.to(cuda), rows.to(cuda), _sos(cuda)
    before = K.launch_counts["iir_rms_frames"]
    got = K.iir_rms_frames(x, sos, stride, n_frames, rows=rows)
    want = K.iir_rms_frames_reference(x, sos, stride, n_frames, rows=rows)
    torch.cuda.synchronize()
    assert K.launch_counts["iir_rms_frames"] == before + (got.numel() > 0)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_iir_rms_kernel_refuses_other_shapes_before_launch(cuda):
    x, sos = _case(2, 60, seed=1).to(cuda), _sos(cuda)
    before = K.launch_counts["iir_rms_frames"]
    for args in ((x[..., :8], sos, 20), (x, sos[:3], 20),
                 (x.double(), sos.double(), 20), (x, sos, 20, 4),
                 (x, sos, 0), (x[0], sos, 20)):
        with pytest.raises(ValueError):
            K.iir_rms_frames(*args)
    x, rows = _table("shuffled", 2, 60, seed=2)
    x, rows = x.to(cuda), rows.to(cuda)
    for bad in (rows.long(), rows + x.shape[0], rows - x.shape[0],
                rows.cpu()):
        with pytest.raises(ValueError):
            K.iir_rms_frames(x, sos, 20, rows=bad)
    assert K.launch_counts["iir_rms_frames"] == before


@pytest.mark.cuda
def test_preprocess_segments_on_the_card_launches_once(cuda):
    """Both time masks: one launch each, frames equal to the CPU run."""
    from contrastiveprosthetics_torch.config import compat_config

    x = _case(6, 2010, seed=2)
    for cfg in (CFG, compat_config(CFG)):
        before = K.launch_counts["iir_rms_frames"]
        got = preprocess_segments(x.to(cuda), _sos(cuda), cfg.time_mask())
        assert K.launch_counts["iir_rms_frames"] == before + 1
        want = preprocess_segments(x, _sos(), cfg.time_mask())
        assert torch.equal(got.cpu(), want)
