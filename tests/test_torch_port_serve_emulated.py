"""PyTorch port: the serve tick chain's ``dsp_frames`` and ``vote_scan``
CUDA sources (``csrc/dsp_frames.cu``, ``csrc/vote_scan.cu``) run on the CPU
through ``tests/cuda_emulation.py``, against their plain versions
(``ops/kernels.py``) and, inside the chain, against the JAX package's fused
tick chain.

Both kernels repeat their plain version's arithmetic step by step (the IIR
and RMS with each operation rounded in the same order; the vote in
integers), so they are held bit for bit, as the card holds them
(``chip_smoke.py``). Shapes cross what the kernels tile: ``dsp_frames``'
10-session CTAs and its ring of tick chunks (8 ticks at one session, 3 at
three, 1 from ten on), ``vote_scan``'s 32-session groups and its 8-tick
chunks with their halo of the W-1 ticks before them.
"""
from __future__ import annotations

import ctypes
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda_emulation
from contrastiveprosthetics_torch.config import INGEST_PRESCALE
from contrastiveprosthetics_torch.ops import kernels as K
from contrastiveprosthetics_tpu.ops import pallas_ops
from test_torch_port_kernels import (  # noqa: F401  (pair is a fixture)
    _folded_torch,
    _sos,
    _warm_carry,
    assert_state_close,
    pair,
)

torch.set_num_threads(1)

P, I, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
C, D, W, FACTOR, N_SEC, R = 41, 12, 25, 20, 4, 10


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    if cuda_emulation.compiler() is None:
        pytest.skip("needs a host C++ compiler to emulate the kernels")
    out = tmp_path_factory.mktemp("emu")
    dsp = cuda_emulation.build("dsp_frames", out)
    dsp.dsp_frames_launch.argtypes = [P] * 9 + [I] * 6 + [F32, P]
    vote = cuda_emulation.build("vote_scan", out)
    vote.vote_scan_launch.argtypes = [P] * 9 + [I] * 4 + [P]
    return dsp, vote


def _ptr(t):
    return P(t.data_ptr() if t is not None else None)


def emu_dsp_frames(lib, iir_state, tail, blocks, sos, mean, std):
    """The kernel's launcher on CPU tensors, outputs filled with NaN first:
    what it does not write shows."""
    Kt, S = blocks.shape[:2]
    frames = torch.full((Kt, S, D), float("nan"))
    iir_out = torch.full_like(iir_state, float("nan"))
    tail_out = torch.full_like(tail, float("nan"))
    rc = lib.dsp_frames_launch(
        _ptr(blocks), _ptr(iir_state), _ptr(tail), _ptr(sos), _ptr(mean),
        _ptr(std), _ptr(frames), _ptr(iir_out), _ptr(tail_out), Kt, S,
        FACTOR, D, sos.shape[0], tail.shape[1] + 1, INGEST_PRESCALE, None)
    assert rc == 0
    return frames, iir_out, tail_out


def emu_vote_scan(lib, scores, masks, votes, n_seen, masked=False):
    Kt, S, n_cls = scores.shape
    preds = torch.full((Kt, S), -7, dtype=torch.int32)
    vote_out = torch.full_like(preds, -7)
    votes_out = torch.full_like(votes, -7)
    nseen_out = torch.full_like(n_seen, -7)
    masked_out = torch.full((Kt, S, n_cls), float("nan")) if masked else None
    rc = lib.vote_scan_launch(
        _ptr(scores), _ptr(masks), _ptr(votes), _ptr(n_seen), _ptr(preds),
        _ptr(vote_out), _ptr(votes_out), _ptr(nseen_out), _ptr(masked_out),
        Kt, S, n_cls, votes.shape[1], None)
    assert rc == 0
    out = (preds, vote_out, votes_out, nseen_out)
    return out + (masked_out,) if masked else out


def _dsp_case(S, Kt, seed):
    """A live carry (IIR registers, RMS tail), raw blocks and a per-channel
    normalisation, from a numpy seed."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32))

    return (t(rng.standard_normal((S, N_SEC, 2, D)) * 100),
            t(rng.standard_normal((S, R, D)) * 300),
            t(rng.standard_normal((Kt, S, FACTOR, D)) * 2),
            t(_sos()), t(rng.normal(0, 0.5, D)), t(rng.uniform(0.5, 2.0, D)))


def _vote_case(S, Kt, seed, shift=0, C=C):
    """Scores on a coarse grid (many tied maxima, zeros of both signs), one
    mask kind per session in turn (all classes, one class, 60 % of them), a
    carried window of any class ids and n_seen_0 in turn 0, 11 and W (so the
    window's stale ids lie outside the valid suffix)."""
    rng = np.random.default_rng(seed)
    scores = rng.integers(-2, 3, (Kt, S, C)).astype(np.float32) / 2
    scores[rng.random((Kt, S, C)) < 0.2] *= -1  # -0.0 beside 0.0
    masks = np.zeros((S, C), bool)
    for s in range(S):
        kind = (s + shift) % 3
        if kind == 0:
            masks[s] = True
        elif kind == 1:
            masks[s, rng.integers(C)] = True
        else:
            masks[s] = rng.random(C) < 0.6
    votes = rng.integers(0, C, (S, W)).astype(np.int32)
    n_seen = np.array([(0, 11, W)[(s + shift) % 3] for s in range(S)],
                      np.int32)
    return (torch.from_numpy(scores), torch.from_numpy(masks),
            torch.from_numpy(votes), torch.from_numpy(n_seen))


@pytest.mark.parametrize("S", [1, 3, 37])
@pytest.mark.parametrize("Kt", [1, 7, 60])
def test_emulated_dsp_frames_matches_plain_bit_for_bit(libs, S, Kt):
    """Frames, IIR state and RMS tail equal the plain version's bits: one
    session (8-tick chunks, a ring that wraps at 60 ticks), three (3-tick
    chunks, a ragged last one at 7), 37 (three full CTAs and a ragged one)."""
    args = _dsp_case(S, Kt, seed=100 * S + Kt)
    got = emu_dsp_frames(libs[0], *args)
    want = K.dsp_frames_reference(*args)
    for name, g, w in zip(("frames", "iir_state", "tail"), got, want):
        assert torch.equal(g, w), name


def test_emulated_dsp_frames_with_no_ticks_passes_the_carry_through(libs):
    args = _dsp_case(3, 0, seed=9)
    frames, iir, tail = emu_dsp_frames(libs[0], *args)
    assert frames.shape == (0, 3, D)
    assert torch.equal(iir, args[0]) and torch.equal(tail, args[1])


@pytest.mark.parametrize("S,Kt,shift", [
    (1, 1, 0), (1, 1, 1), (1, 1, 2), (1, 7, 1), (1, 60, 0), (1, 60, 2),
    (3, 1, 0), (3, 7, 0), (3, 60, 1), (37, 1, 0), (37, 7, 2), (37, 60, 0)])
@pytest.mark.parametrize("masked", [False, True])
def test_emulated_vote_scan_matches_plain(libs, S, Kt, shift, masked):
    """Preds, votes, the outgoing window (stale ids included) and n_seen
    equal the plain version's, and the masked scores are
    ``torch.where(mask, scores, finfo.min)`` bit for bit: one session's
    vote warm-up from n_seen 0, 11 and W, chunks of 8 ticks with their
    halo, sessions ragged against the 32-session group. 41 classes run the
    48-class instance; 100 (one case each way) the 128-class one."""
    n_cls = 100 if (S, Kt, shift) == (3, 7, 0) else C
    args = _vote_case(S, Kt, seed=1000 * S + 10 * Kt + shift, shift=shift,
                      C=n_cls)
    got = emu_vote_scan(libs[1], *args, masked=masked)
    want = K.vote_scan_reference(*args, masked=masked)
    assert len(got) == len(want) == 4 + masked
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    if masked:  # the bits: -0.0 stays -0.0, masked classes finfo.min
        assert torch.equal(got[4].view(torch.int32), want[4].view(torch.int32))


def test_emulated_vote_scan_ties_go_to_the_smallest_class(libs):
    """The plain version's hand-made case (``test_torch_port_kernels.py``)
    at the kernel's widths: a score tie, a masked maximum and a vote tie."""
    scores = torch.full((2, 2, C), -1.0)
    scores[0, 0, :4] = torch.tensor([0.5, 0.9, 0.9, 0.1])
    scores[0, 1, :4] = torch.tensor([0.9, 0.1, 0.2, 0.3])
    scores[1, 0, :4] = torch.tensor([0.0, 0.0, 0.0, 0.7])
    scores[1, 1, :4] = torch.tensor([0.9, 0.1, 0.2, 0.3])
    masks = torch.zeros((2, C), dtype=torch.bool)
    masks[0, :4] = True
    masks[1, 1:4] = True
    votes = torch.full((2, W), 2, dtype=torch.int32)
    n_seen = torch.tensor([0, W], dtype=torch.int32)
    got = emu_vote_scan(libs[1], scores, masks, votes, n_seen)
    for g, w in zip(got, K.vote_scan_reference(scores, masks, votes, n_seen)):
        assert torch.equal(g, w)
    preds, vote, window, seen = got
    assert preds.tolist() == [[1, 3], [3, 3]]
    assert vote.tolist() == [[1, 2], [1, 2]]
    assert window[0, -3:].tolist() == [2, 1, 3]
    assert seen.tolist() == [2, W]


def test_emulated_launchers_refuse_what_they_are_not_built_for(libs):
    """``dsp_frames`` takes the config's (n_sec, factor, rms_window, D) =
    (4, 20, 11, 12) and 16-byte aligned blocks only; ``vote_scan`` W up to
    64 and C up to 128. Refused calls return an error and write nothing."""
    dsp, vote = libs
    iir, tail, blocks, sos, mean, std = _dsp_case(2, 3, seed=4)
    frames = torch.full((3, 2, D), float("nan"))
    flat = torch.zeros(blocks.numel() + 1)
    for n_sec, factor, rmsw, d, ptr in (
            (3, 20, 11, 12, blocks), (4, 10, 11, 12, blocks),
            (4, 20, 9, 12, blocks), (4, 20, 11, 8, blocks),
            (4, 20, 11, 12, flat[1:])):
        assert dsp.dsp_frames_launch(
            _ptr(ptr), _ptr(iir), _ptr(tail), _ptr(sos), _ptr(mean),
            _ptr(std), _ptr(frames), _ptr(iir), _ptr(tail), 3, 2, factor, d,
            n_sec, rmsw, INGEST_PRESCALE, None) != 0
    assert torch.isnan(frames).all()
    scores, masks, votes, n_seen = _vote_case(2, 3, seed=4)
    preds = torch.full((3, 2), -7, dtype=torch.int32)
    for c, w in ((C, 65), (129, W), (0, W), (C, 0)):
        assert vote.vote_scan_launch(
            _ptr(scores), _ptr(masks), _ptr(votes), _ptr(n_seen),
            _ptr(preds), _ptr(preds), _ptr(votes), _ptr(n_seen), None, 3, 2,
            c, w, None) != 0
    assert (preds == -7).all()


def test_emulated_tick_chain_matches_jax_fused_tick_chain(libs, pair):
    """The emulated kernels around the plain encoder against the JAX
    package's ``fused_tick_chain`` (interpret mode), on the inputs of
    ``test_fused_tick_chain_reference_matches_pallas`` (9 ticks of one warm
    session: two vote chunks, the second with its halo): preds, votes,
    window and n_seen exact, the IIR state and tail within
    ``assert_state_close`` (XLA:CPU and PyTorch round the f32 IIR apart)."""
    model, v, class_emb, _ = pair
    rng = np.random.default_rng(5)
    folded = pallas_ops.fold_encoder_params(v["params"], v["batch_stats"],
                                            jnp.asarray(class_emb))
    iir, tail, votes, n_seen = (x[0] for x in _warm_carry(rng, 1))
    blocks = (rng.standard_normal((9, FACTOR, D)) * 2).astype(np.float32)
    mask = np.zeros(C, bool)
    mask[[0, 7, 23, 30, 31]] = True
    mean = rng.normal(0, 0.5, D).astype(np.float32)
    std = rng.uniform(0.5, 2.0, D).astype(np.float32)
    args = (iir, tail, votes, np.int32(n_seen), blocks, mask, _sos(), mean,
            std)
    (j_iir, j_tail, j_votes, j_n), j_p, j_v = pallas_ops.fused_tick_chain(
        *(jnp.asarray(a) for a in args), folded, interpret=True)
    chain = functools.partial(
        K._chain, functools.partial(emu_dsp_frames, libs[0]),
        K.fused_encoder_logits_reference,
        functools.partial(emu_vote_scan, libs[1]))
    (t_iir, t_tail, t_votes, t_n), t_p, t_v = K._single(
        chain, *(torch.from_numpy(np.array(a)) for a in args),
        _folded_torch(folded))
    np.testing.assert_array_equal(t_p.numpy(), np.asarray(j_p))
    np.testing.assert_array_equal(t_v.numpy(), np.asarray(j_v))
    assert_state_close(t_iir, j_iir)
    assert_state_close(t_tail, j_tail)
    np.testing.assert_array_equal(t_votes.numpy(), np.asarray(j_votes))
    assert int(t_n) == int(j_n)
    assert set(t_p.tolist()) <= {0, 7, 23, 30, 31}
