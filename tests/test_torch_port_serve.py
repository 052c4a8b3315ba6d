"""PyTorch port: the streaming serve engines against the JAX package's
(``contrastiveprosthetics_torch.serve.stream``), tick for tick on the CPU.

Same weights (converted with ``from_flax_variables``), same numpy-made
recordings, calibrations and masks in both packages. Preds and votes must
be equal; scores agree at rtol 2e-4, atol 2e-5 (``test_serve.py``'s fused
tick tolerance); carries as in ``test_torch_port_kernels.py``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from contrastiveprosthetics_torch.config import DEFAULT_CONFIG as CFG
from contrastiveprosthetics_torch.ops import kernels as K
from contrastiveprosthetics_torch.serve.stream import (
    BatchedStreamingEngine,
    StreamingEngine,
)
from contrastiveprosthetics_tpu.config import DEFAULT_CONFIG as JAX_CFG
from contrastiveprosthetics_tpu.serve import stream as jax_stream
from test_torch_port_kernels import assert_state_close
from test_torch_port_models import jax_variables, port_model

torch.set_num_threads(1)

C = CFG.max_tasks
ZERO, ONE = np.zeros(12, np.float32), np.ones(12, np.float32)


def _engines(fused=False, seed=11, **kw):
    model, v = jax_variables(seed=seed, **kw)
    mean = np.random.default_rng(seed).normal(0, 0.2, 12).astype(np.float32)
    std = np.random.default_rng(seed).uniform(0.5, 2, 12).astype(np.float32)
    jax_eng = jax_stream.StreamingEngine(JAX_CFG, model, v, mean, std,
                                         use_fused_encoder=fused)
    return jax_eng, StreamingEngine(CFG, port_model(v), mean, std)


@pytest.mark.parametrize("fused", [False, True])
def test_streaming_engine_matches_jax(fused, rng):
    """(f) Calibration, subset mask, vote warm-up, and a carry threaded
    across two ``steps`` calls; the JAX engine runs its XLA tick or its
    fused Pallas chain (interpret mode)."""
    jax_eng, eng = _engines(fused)
    calib = (rng.standard_normal((2000, 12)) * 3 + 1).astype(np.float32)
    jax_eng.calibrate(calib)
    eng.calibrate(calib)
    mask = np.zeros(C, bool)
    mask[[0, 7, 23, 30]] = True
    blocks = (rng.standard_normal((12, CFG.factor, 12)) * 2).astype(np.float32)
    c_j, c_t = jax_eng.init_carry(), eng.init_carry()
    for chunk in (blocks[:5], blocks[5:]):
        c_j, p_j, v_j = jax_eng.steps(c_j, chunk, mask)
        c_t, p_t, v_t = eng.steps(c_t, chunk, mask)
        np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))
        np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    assert_state_close(c_t.iir_state, c_j.iir_state)
    assert_state_close(c_t.tail, c_j.tail)
    np.testing.assert_array_equal(c_t.votes.numpy(), np.asarray(c_j.votes))
    assert int(c_t.n_seen) == int(c_j.n_seen)
    assert set(p_t.tolist()) <= {0, 7, 23, 30}


def test_step_loop_matches_steps_and_jax_scores(rng):
    """Per-tick ``step`` equals ``steps`` tick for tick, and its masked
    scores match the JAX engine's."""
    jax_eng, eng = _engines()
    mask = np.ones(C, bool)
    mask[::3] = False
    raw = rng.standard_normal((8 * CFG.factor, 12)).astype(np.float32)
    c_j, c_t = jax_eng.init_carry(), eng.init_carry()
    preds, votes = [], []
    for i in range(8):
        block = raw[i * CFG.factor:(i + 1) * CFG.factor]
        c_j, p_j, v_j, s_j = jax_eng.step(c_j, block, mask)
        c_t, p_t, v_t, s_t = eng.step(c_t, block, mask)
        assert (int(p_t), int(v_t)) == (int(p_j), int(v_j))
        np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j),
                                   rtol=2e-4, atol=2e-5)
        preds.append(int(p_t))
        votes.append(int(v_t))
    _, p, v = eng.steps(eng.init_carry(), raw.reshape(8, CFG.factor, 12),
                        mask)
    assert p.tolist() == preds and v.tolist() == votes


def test_batched_engine_matches_jax(rng):
    """(f) S=3, K=12: per-session calibration, per-session masks, vote
    warm-up, a carry threaded across two calls; then one per-tick
    ``step`` continues the same carries."""
    S, n_ticks = 3, 12
    model, v = jax_variables(seed=13)
    jax_eng = jax_stream.BatchedStreamingEngine(
        JAX_CFG, model, v, ZERO, ONE, n_sessions=S, use_fused_encoder=False)
    eng = BatchedStreamingEngine(CFG, port_model(v), ZERO, ONE, S)
    calib = (rng.standard_normal((2000, 12)) * 4 + 2).astype(np.float32)
    jax_eng.calibrate_session(1, calib)
    eng.calibrate_session(1, calib)
    masks = np.ones((S, C), bool)
    masks[2, 15:] = False
    blocks = (rng.standard_normal((n_ticks, S, CFG.factor, 12)) * 2).astype(
        np.float32)
    c_j, c_t = jax_eng.init_carries(), eng.init_carries()
    for chunk in (blocks[:5], blocks[5:]):
        c_j, p_j, v_j = jax_eng.steps(c_j, chunk, masks)
        c_t, p_t, v_t = eng.steps(c_t, chunk, masks)
        np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))
        np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    assert_state_close(c_t.iir_state, c_j.iir_state)
    assert_state_close(c_t.tail, c_j.tail)
    np.testing.assert_array_equal(c_t.votes.numpy(), np.asarray(c_j.votes))
    np.testing.assert_array_equal(c_t.n_seen.numpy(), np.asarray(c_j.n_seen))
    assert set(p_t[:, 2].tolist()) <= set(range(15))

    block = blocks[0]
    c_j, p_j, v_j, s_j = jax_eng.step(c_j, block, masks)
    c_t, p_t, v_t, s_t = eng.step(c_t, block, masks)
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=2e-4,
                               atol=2e-5)


def test_batched_calibration_is_per_session(rng):
    """calibrate_session(i) changes session i's scores and only its; the
    affines refresh lazily on the next tick."""
    model, v = jax_variables(seed=13)
    eng = BatchedStreamingEngine(CFG, port_model(v), ZERO, ONE, 2)
    block = np.stack([rng.standard_normal((CFG.factor, 12))] * 2).astype(
        np.float32)
    _, _, _, before = eng.step(eng.init_carries(), block)
    torch.testing.assert_close(before[0], before[1])
    eng.calibrate_session(1, (rng.standard_normal((3000, 12)) * 5 + 2
                              ).astype(np.float32))
    assert eng._affines_dirty
    _, _, _, after = eng.step(eng.init_carries(), block)
    assert not eng._affines_dirty
    torch.testing.assert_close(after[0], before[0])
    assert (after[1] - before[1]).abs().max() > 1e-4


def test_streaming_engine_rejects_adabn_and_keeps_callers_model():
    _, v = jax_variables(adabn=True)
    with pytest.raises(ValueError, match="adabn"):
        StreamingEngine(CFG, port_model(v, adabn=True), ZERO, ONE)
    _, v = jax_variables()
    model = port_model(v)
    before = model.emg_net.norms()[0].running_mean.clone()
    eng = StreamingEngine(CFG, model, ZERO, ONE)
    eng.calibrate(np.random.default_rng(0).standard_normal((1000, 12)).astype(
        np.float32) + 3)
    assert torch.equal(model.emg_net.norms()[0].running_mean, before)
    assert not torch.equal(eng.model.emg_net.norms()[0].running_mean, before)


def test_full_width_step_matches_jax_xla_engine(rng):
    """(g) Reference width (7 x 512), 10 per-tick steps against the JAX
    package's XLA engine."""
    jax_eng, eng = _engines(fused=False, n_linear=7, hidden=512)
    raw = rng.standard_normal((10 * CFG.factor, 12)).astype(np.float32)
    c_j, c_t = jax_eng.init_carry(), eng.init_carry()
    K.reset_launch_counts()
    for i in range(10):
        block = raw[i * CFG.factor:(i + 1) * CFG.factor]
        c_j, p_j, v_j, s_j = jax_eng.step(c_j, block)
        c_t, p_t, v_t, s_t = eng.step(c_t, block)
        assert (int(p_t), int(v_t)) == (int(p_j), int(v_j))
        np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j),
                                   rtol=2e-4, atol=2e-5)
    # CPU tensors take the plain versions: no kernel was launched
    assert not any(K.launch_counts.values())
