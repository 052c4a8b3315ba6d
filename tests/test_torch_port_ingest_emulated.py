"""PyTorch port: the ``iir_rms_frames`` CUDA source (``csrc/iir_rms.cu``),
the ingest's and the calibration's band-pass and RMS, run on the CPU
through ``tests/cuda_emulation.py`` against its plain version
(``ops/kernels.py``); and, marked ``cuda``, the kernel on the card.

The kernel repeats its plain version's arithmetic step by step (the IIR
sections and the window sum, each operation rounded in the same order, the
root correctly rounded), so it is held bit for bit, as the card holds it
(``chip_smoke.py``). Shapes cross what the kernel tiles: 128-chain CTAs
(a chain is one (segment, channel)), a ragged last CTA, its 8-sample load
chunks with a ragged last one, and the frame counts of ingest (stride 20,
100 frames of 2,010 samples), calibration (stride 20, 200 frames of
4,000) and the compat mask (stride 1, 253 frames). The file imports
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
# recording; the compat mask's stride 1 up to index 252; 37 segments (444
# chains: three full CTAs and a ragged one); T = W and T = W + stride - 1
# (one frame each); a window end on a chunk boundary (t_end = 16); fewer
# frames than the samples hold
SHAPES = [(246, 2010, 20, None), (1, 4000, 20, None), (5, 2010, 1, 253),
          (37, 2010, 20, None), (11, 11, 20, None), (11, 30, 20, None),
          (5, 16, 1, None), (3, 500, 7, 40)]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if cuda_emulation.compiler() is None:
        pytest.skip("needs a host C++ compiler to emulate the kernel")
    out = cuda_emulation.build("iir_rms", tmp_path_factory.mktemp("emu"))
    out.iir_rms_frames_launch.argtypes = [P] * 3 + [I] * 7 + [F32, P]
    return out


def _ptr(t):
    return P(t.data_ptr())


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


def emu_iir_rms(lib, x, sos, stride, n_frames, n_sec=N_SEC, rmsw=W, d=D):
    """The launcher on CPU tensors, the output filled with NaN first: what
    it does not write shows. Returns (rc, frames)."""
    B, T = x.shape[:2]
    frames = torch.full((B, n_frames, D), float("nan"))
    rc = lib.iir_rms_frames_launch(_ptr(x), _ptr(sos), _ptr(frames), B, T, d,
                                   n_sec, rmsw, stride, n_frames,
                                   INGEST_PRESCALE, None)
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
    and no frame whose window runs past T. Refused calls return an error
    and write nothing."""
    x, sos = _case(2, 60, seed=5), _sos()
    for kw in (dict(n_sec=3), dict(rmsw=9), dict(d=8)):
        rc, frames = emu_iir_rms(lib, x, sos, 20, 2, **kw)
        assert rc != 0 and torch.isnan(frames).all()
    for stride, n in ((0, 2), (20, 4), (1, 51)):
        rc, frames = emu_iir_rms(lib, x, sos, stride, n)
        assert rc != 0 and torch.isnan(frames).all()
    rc = lib.iir_rms_frames_launch(_ptr(x), _ptr(sos), _ptr(x), 2, 60, D,
                                   N_SEC, W, 20, -1, INGEST_PRESCALE, None)
    assert rc != 0
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
def test_iir_rms_kernel_refuses_other_shapes_before_launch(cuda):
    x, sos = _case(2, 60, seed=1).to(cuda), _sos(cuda)
    before = K.launch_counts["iir_rms_frames"]
    for args in ((x[..., :8], sos, 20), (x, sos[:3], 20),
                 (x.double(), sos.double(), 20), (x, sos, 20, 4),
                 (x, sos, 0), (x[0], sos, 20)):
        with pytest.raises(ValueError):
            K.iir_rms_frames(*args)
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
