"""PyTorch port: the serve-path folds and kernels
(``contrastiveprosthetics_torch.ops.kernels``).

On the CPU each kernel's plain version is held against the JAX package's
Pallas kernel run in interpret mode, on the same inputs made with numpy:
scores at rtol 2e-4, atol 2e-5 (the tolerance of ``test_serve.py``'s fused
tick tests); preds and votes exactly; IIR state and RMS tail at rtol 1e-5
and an absolute tolerance of 1e-5 of the largest value. The last is f32
rounding in the recursion, not a fault: the values reach ~1e3-1e4 after the
2^10 prescale, XLA:CPU and PyTorch round the same recursion differently, and
both lie ~3e-6 of the largest value from a float64 oracle.

The CUDA kernels themselves are held against these plain versions on the
card by ``test_torch_port_cuda.py`` and ``chip_smoke.py``.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrastiveprosthetics_torch.ops import kernels as K
from contrastiveprosthetics_tpu.models.clip import ContrastiveModel
from contrastiveprosthetics_tpu.ops import pallas_ops
from contrastiveprosthetics_tpu.ops.signal import butter_bandpass_sos
from test_torch_port_models import jax_variables, port_model

torch.set_num_threads(1)

SCORE_TOL = dict(rtol=2e-4, atol=2e-5)
C, D, W, FACTOR = 41, 12, 25, 20


@pytest.fixture(scope="module")
def pair():
    model, v = jax_variables()
    class_emb = np.asarray(model.apply(
        v, None, False, method=ContrastiveModel.encode_classes))
    return model, v, class_emb, port_model(v)


def _t(x):
    return torch.from_numpy(np.array(x))


def _folded_torch(folded_jax):
    """The JAX fold's tuple as the port's tensors (1-D biases)."""
    return tuple(_t(a).reshape(-1) if i % 2 and i < len(folded_jax) - 1
                 else _t(a) for i, a in enumerate(folded_jax))


def _assert_fold_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w).reshape(g.shape),
                                   rtol=1e-5, atol=1e-5)


def assert_state_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def _sos():
    return butter_bandpass_sos(20, 450, 2000).astype(np.float32)


def _warm_carry(rng, S):
    """A carry mid-stream: live IIR registers and tail, a half-full vote
    window (n_seen < W exercises the warm-up suffix)."""
    return (rng.standard_normal((S, 4, 2, D)).astype(np.float32) * 100,
            rng.standard_normal((S, 10, D)).astype(np.float32) * 300,
            rng.integers(0, C, (S, W)).astype(np.int32),
            rng.integers(0, W, S).astype(np.int32))


def test_fold_encoder_params_matches_jax(pair):
    model, v, class_emb, port = pair
    want = pallas_ops.fold_encoder_params(v["params"], v["batch_stats"],
                                          jnp.asarray(class_emb))
    with torch.no_grad():
        got = K.fold_encoder_params(port.emg_net, port.encode_classes())
    _assert_fold_equal(got, want)


def test_fold_encoder_params_shared_matches_jax(pair):
    model, v, class_emb, port = pair
    want = pallas_ops.fold_encoder_params_shared(v["params"],
                                                 jnp.asarray(class_emb))
    with torch.no_grad():
        got = K.fold_encoder_params_shared(port.emg_net,
                                           port.encode_classes())
    _assert_fold_equal(got, want)


def test_session_bn_affines_matches_jax(pair):
    model, v, class_emb, port = pair
    rng = np.random.default_rng(3)
    S = 3
    stacked, stats = {}, []
    for i, bn in enumerate(port.emg_net.norms()):
        w = bn.num_features
        mean = rng.normal(0, 0.3, (S, w)).astype(np.float32)
        var = rng.uniform(0.3, 3.0, (S, w)).astype(np.float32)
        stacked[f"BatchNorm_{i}"] = {"BatchNorm_0": {"mean": mean,
                                                     "var": var}}
        stats.append((_t(mean), _t(var)))
    want = pallas_ops.session_bn_affines(v["params"], {"emg_net": stacked})
    got = K.session_bn_affines(port.emg_net, stats)
    _assert_fold_equal(got, want)


@pytest.mark.parametrize("rows", [1, 37])
def test_encoder_logits_reference_matches_pallas(pair, rows):
    model, v, class_emb, _ = pair
    folded = pallas_ops.fold_encoder_params(v["params"], v["batch_stats"],
                                            jnp.asarray(class_emb))
    frames = np.random.default_rng(rows).standard_normal((rows, D)).astype(
        np.float32)
    want = pallas_ops.fused_encoder_logits(jnp.asarray(frames), folded,
                                           interpret=True)
    got = K.fused_encoder_logits_reference(_t(frames), _folded_torch(folded))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCORE_TOL)
    # the CPU wrapper is the plain version
    assert torch.equal(K.fused_encoder_logits(_t(frames),
                                              _folded_torch(folded)), got)


def test_fused_tick_chain_reference_matches_pallas(pair):
    """Single session, warm carry, subset mask: tick for tick."""
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
    (t_iir, t_tail, t_votes, t_n), t_p, t_v = K.fused_tick_chain_reference(
        *(_t(a) for a in args), _folded_torch(folded))
    np.testing.assert_array_equal(t_p.numpy(), np.asarray(j_p))
    np.testing.assert_array_equal(t_v.numpy(), np.asarray(j_v))
    assert_state_close(t_iir, j_iir)
    assert_state_close(t_tail, j_tail)
    np.testing.assert_array_equal(t_votes.numpy(), np.asarray(j_votes))
    assert int(t_n) == int(j_n)
    assert set(t_p.tolist()) <= {0, 7, 23, 30, 31}


def test_fused_tick_chain_batched_reference_matches_pallas(pair):
    """S=3 sessions, per-session affines and masks, warm carries."""
    model, v, class_emb, port = pair
    rng = np.random.default_rng(6)
    S, n_ticks = 3, 7
    shared = pallas_ops.fold_encoder_params_shared(v["params"],
                                                   jnp.asarray(class_emb))
    stacked, stats = {}, []
    for i, bn in enumerate(port.emg_net.norms()):
        mean = rng.normal(0, 0.3, (S, bn.num_features)).astype(np.float32)
        var = rng.uniform(0.3, 3.0, (S, bn.num_features)).astype(np.float32)
        stacked[f"BatchNorm_{i}"] = {"BatchNorm_0": {"mean": mean,
                                                     "var": var}}
        stats.append((_t(mean), _t(var)))
    affines = pallas_ops.session_bn_affines(v["params"], {"emg_net": stacked})
    iir, tail, votes, n_seen = _warm_carry(rng, S)
    blocks = (rng.standard_normal((n_ticks, S, FACTOR, D)) * 2).astype(
        np.float32)
    masks = np.ones((S, C), bool)
    masks[1, 12:] = False
    masks[2, ::2] = False
    args = (iir, tail, votes, n_seen, blocks, masks, _sos(),
            np.zeros(D, np.float32), np.ones(D, np.float32))
    (j_iir, j_tail, j_votes, j_n), j_p, j_v = (
        pallas_ops.fused_tick_chain_batched(
            *(jnp.asarray(a) for a in args), shared, affines,
            interpret=True))
    (t_iir, t_tail, t_votes, t_n), t_p, t_v = (
        K.fused_tick_chain_batched_reference(
            *(_t(a) for a in args), _folded_torch(shared),
            tuple(_t(a) for a in affines)))
    np.testing.assert_array_equal(t_p.numpy(), np.asarray(j_p))
    np.testing.assert_array_equal(t_v.numpy(), np.asarray(j_v))
    assert_state_close(t_iir, j_iir)
    assert_state_close(t_tail, j_tail)
    # the TPU kernel carries the window as one-hot rows, so the slots before
    # the valid suffix come back as 0; they never count, so compare the rest
    valid = np.arange(W)[None, :] >= W - np.asarray(j_n)[:, None]
    np.testing.assert_array_equal(np.where(valid, t_votes.numpy(), 0),
                                  np.asarray(j_votes))
    np.testing.assert_array_equal(t_n.numpy(), np.asarray(j_n))


def test_vote_scan_reference_ties_and_masks():
    """First-max on ties, masked classes never win, warm-up counts only
    the valid suffix."""
    scores = torch.zeros((2, 2, 4))
    scores[0, 0] = torch.tensor([0.5, 0.9, 0.9, 0.1])   # tie 1/2 -> 1
    scores[0, 1] = torch.tensor([0.9, 0.1, 0.2, 0.3])   # 0 masked -> 3
    scores[1, 0] = torch.tensor([0.0, 0.0, 0.0, 0.7])   # -> 3
    scores[1, 1] = torch.tensor([0.9, 0.1, 0.2, 0.3])
    masks = torch.tensor([[True] * 4, [False, True, True, True]])
    votes = torch.tensor([[2, 2, 2], [0, 0, 0]], dtype=torch.int32)
    n_seen = torch.tensor([0, 3], dtype=torch.int32)
    preds, vote, window, seen = K.vote_scan_reference(scores, masks, votes,
                                                      n_seen)
    assert preds.tolist() == [[1, 3], [3, 3]]
    # session 0: the stale 2s are outside the valid suffix, and its second
    # tick ties 1/3 -> 1; session 1's class 0 is masked out of the vote
    assert vote.tolist() == [[1, 3], [1, 3]]
    assert window.tolist() == [[2, 1, 3], [0, 3, 3]]
    assert seen.tolist() == [2, 3]
