"""PyTorch port: bfloat16 serving against the JAX package's, on the CPU.

The JAX package serves a ``ContrastiveModel(dtype=jnp.bfloat16)``: its
folds cast each weight matrix and ``Gt`` to bf16 after folding in f32
(``pallas_ops.py:318-322``), every dot rounds its activations to bf16 and
sums in f32 (``_dot_f32``, ``:400-404``), and the tower it calibrates runs
flax's bf16 layers. The port does the same (``models/layers.py``'s
``low_precision``, ``ops/kernels.py``'s ``dtype=`` folds and ``_dot``).
Inputs are made with numpy from a seed at a small width (``n_linear 2,
hidden 64``, as ``test_serve.py:387-390``); each comparison states its
tolerance and what was measured.
"""
from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrastiveprosthetics_torch.config import DEFAULT_CONFIG as CFG
from contrastiveprosthetics_torch.models.clip import ContrastiveModel as TorchModel
from contrastiveprosthetics_torch.models.convert import (
    from_flax_variables,
    model_from_state_dict,
)
from contrastiveprosthetics_torch.ops import kernels as K
from contrastiveprosthetics_torch.serve.stream import (
    BatchedStreamingEngine,
    StreamingEngine,
    recalibrate_batch_stats,
)
from contrastiveprosthetics_tpu.config import DEFAULT_CONFIG as JAX_CFG
from contrastiveprosthetics_tpu.models.clip import ContrastiveModel
from contrastiveprosthetics_tpu.ops import pallas_ops
from contrastiveprosthetics_tpu.serve import stream as jax_stream
from test_torch_port_kernels import assert_state_close
from test_torch_port_models import jax_variables

torch.set_num_threads(1)

BF16 = torch.bfloat16
C = CFG.max_tasks


def bf16_pair(seed=11, **kw):
    """The JAX bf16 model with its (f32) variables and the port's bf16
    model from the same variables."""
    _, v = jax_variables(seed=seed, **kw)
    jax_model = ContrastiveModel(d_e=16, adabn=False, n_classes=C,
                                 n_linear=kw.get("n_linear", 2),
                                 hidden=kw.get("hidden", 64),
                                 dtype=jnp.bfloat16)
    sd = from_flax_variables(v["params"], v["batch_stats"])
    return jax_model, v, model_from_state_dict(sd, dtype=BF16).eval()


def as_f32(a) -> np.ndarray:
    """A JAX array (bf16 or f32) as f32 numpy values (exact)."""
    return np.asarray(jnp.asarray(a, jnp.float32))


def torch_chain(folded_jax):
    """A JAX fold as the port's tensors: bf16 weights and Gt, 1-D f32
    biases (the values unchanged)."""
    out = []
    for i, a in enumerate(folded_jax):
        t = torch.from_numpy(as_f32(a))
        if a.dtype == jnp.bfloat16:
            t = t.to(BF16)
        out.append(t.reshape(-1) if i % 2 and i < len(folded_jax) - 1 else t)
    return tuple(out)


def bf16_ulps(got: torch.Tensor, want: np.ndarray) -> np.ndarray:
    """|got - want| in bf16 ulps of the larger magnitude."""
    g = got.float().numpy()
    big = np.maximum(np.abs(g), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.where(big > 0, big, 1.0))) - 7)
    return np.abs(g - want) / ulp


@pytest.fixture(scope="module")
def pair():
    jax_model, v, port = bf16_pair()
    class_emb = np.asarray(jax_model.apply(
        v, None, False, method=ContrastiveModel.encode_classes))
    return jax_model, v, class_emb, port


# ----------------------------------------------------------------- folds
@pytest.mark.parametrize("shared", [False, True])
def test_bf16_folds_match_jax(pair, shared):
    """Weights and Gt bf16, biases f32; each weight within one bf16 ulp of
    JAX's (both fold in f32 and round once; an f32 ulp between the two
    folds' sums can round the other way at a bf16 tie), and few apart
    (measured: 0 of 653,968 entries)."""
    _, v, class_emb, port = pair
    emb = torch.from_numpy(class_emb.copy())
    if shared:
        want = pallas_ops.fold_encoder_params_shared(
            v["params"], jnp.asarray(class_emb), dtype=jnp.bfloat16)
        got = K.fold_encoder_params_shared(port.emg_net, emb, dtype=BF16)
    else:
        want = pallas_ops.fold_encoder_params(
            v["params"], v["batch_stats"], jnp.asarray(class_emb),
            dtype=jnp.bfloat16)
        got = K.fold_encoder_params(port.emg_net, emb, dtype=BF16)
    assert len(got) == len(want)
    differing = total = 0
    for i, (g, w) in enumerate(zip(got, want)):
        w = as_f32(w).reshape(g.shape)
        if i % 2 and i < len(got) - 1:  # a bias
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5)
            continue
        assert g.dtype == BF16 and g.is_contiguous()
        assert (bf16_ulps(g, w) <= 1.0).all()
        differing += int((g.float().numpy() != w).sum())
        total += w.size
    assert differing <= 1e-3 * total


def test_bf16_session_affines_stay_f32(pair):
    _, _, _, port = pair
    stats = [(bn.running_mean.expand(3, -1), bn.running_var.expand(3, -1))
             for bn in port.emg_net.norms()]
    assert all(t.dtype == torch.float32
               for t in K.session_bn_affines(port.emg_net, stats))


# ----------------------------------------------------------- plain chain
@pytest.mark.parametrize("rows", [1, 37])
def test_plain_bf16_chain_matches_jax_on_the_same_fold(pair, rows):
    """The port's plain bf16 chain on JAX's bf16 fold against JAX's
    ``fused_encoder_logits_reference`` and the Pallas kernel in interpret
    mode. Both round the activations to bf16 at each dot; their f32 sums
    (768 products in the conv layer) run in other orders, so a bf16
    rounding can flip: held at atol 1e-2 (measured 3e-8: none flipped
    here), inside JAX's own rtol 0.1, atol 0.05 of the f32 fold."""
    jax_model, v, class_emb, _ = pair
    folded = pallas_ops.fold_encoder_params(
        v["params"], v["batch_stats"], jnp.asarray(class_emb),
        dtype=jnp.bfloat16)
    frames = (np.random.default_rng(rows).standard_normal((rows, 12)) * 2
              ).astype(np.float32)
    got = K.fused_encoder_logits_reference(torch.from_numpy(frames),
                                           torch_chain(folded)).numpy()
    want = np.asarray(pallas_ops.fused_encoder_logits_reference(
        jnp.asarray(frames), folded))
    kernel = np.asarray(pallas_ops.fused_encoder_logits(
        jnp.asarray(frames), folded, True))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-2)
    np.testing.assert_allclose(got, kernel, rtol=0, atol=1e-2)
    f32 = pallas_ops.fold_encoder_params(v["params"], v["batch_stats"],
                                         jnp.asarray(class_emb))
    np.testing.assert_allclose(got, np.asarray(
        pallas_ops.fused_encoder_logits_reference(jnp.asarray(frames), f32)),
        rtol=0.1, atol=0.05)


# ------------------------------------------------------------ the tower
def test_bf16_tower_eval_and_calibration_match_jax(pair):
    """``encode_emg`` in eval mode and the statistics of a calibration
    (40 passes) against JAX's bf16 ``encode_emg`` and
    ``recalibrate_batch_stats``. The same roundings in the same places,
    but f32 sums (768 products in the second conv) in other orders, which
    can round an activation to the other bf16 neighbour: embeddings at
    atol 1e-2 (measured 1.5e-3), statistics at rtol 5e-3, atol 1e-5
    (measured 4.9e-4 relative, in the deepest BatchNorm's variance)."""
    jax_model, v, _, port = pair
    frames = (np.random.default_rng(4).standard_normal((300, 12)) * 2 + 0.5
              ).astype(np.float32)
    want = np.asarray(jax_model.apply(v, jnp.asarray(frames),
                                      method=ContrastiveModel.encode_emg))
    with torch.no_grad():
        got = port.encode_emg(torch.from_numpy(frames))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-2)

    jax_stats = jax_stream.recalibrate_batch_stats(jax_model, v,
                                                   jnp.asarray(frames))
    new = recalibrate_batch_stats(port, torch.from_numpy(frames))
    names = sorted(jax_stats["emg_net"], key=lambda n: int(n.split("_")[1]))
    assert len(names) == len(new)
    for name, (mean, var) in zip(names, new):
        bn = jax_stats["emg_net"][name]["BatchNorm_0"]
        assert mean.dtype == var.dtype == torch.float32
        np.testing.assert_allclose(mean.numpy(), np.asarray(bn["mean"]),
                                   rtol=5e-3, atol=1e-5)
        np.testing.assert_allclose(var.numpy(), np.asarray(bn["var"]),
                                   rtol=5e-3, atol=1e-5)


def test_bf16_tower_keeps_f32_parameters_and_class_tower(pair):
    _, _, _, port = pair
    assert port.dtype == port.emg_net.dtype == BF16
    assert all(p.dtype == torch.float32 for p in port.parameters())
    assert all(b.dtype in (torch.float32, torch.int64)
               for b in port.buffers())
    with torch.no_grad():
        assert port.encode_classes().dtype == torch.float32
    with pytest.raises(ValueError, match="compute dtype"):
        TorchModel(dtype=torch.float16)


# --------------------------------------------------------------- engines
def near_ties(scores: np.ndarray, eps: float) -> np.ndarray:
    """Where the top two masked scores lie within ``eps``."""
    top2 = np.sort(scores, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0] < eps


def assert_agree_away_from_ties(p_t, v_t, p_j, v_j, tied):
    """Preds equal where no engine is near a tie; votes equal up to the
    first tick (per session) where a pred could differ."""
    p_t, v_t, p_j, v_j = (np.asarray(x) for x in (p_t, v_t, p_j, v_j))
    np.testing.assert_array_equal(p_t[~tied], p_j[~tied])
    clean = np.cumsum(p_t != p_j, axis=0) == 0
    np.testing.assert_array_equal(v_t[clean], v_j[clean])


@pytest.mark.parametrize("fused", [False, True])
def test_bf16_streaming_engine_matches_jax(fused):
    """Calibration, a subset mask, the vote warm-up and a carry threaded
    across two ``steps`` calls, against the JAX bf16 engine's XLA tick (the
    flax bf16 tower: scores within 8.7e-3 of the port's, measured) or its
    fused Pallas chain (the same fold, within 5.8e-3: the calibrated
    statistics differ in their last f32 bits, which can move a folded
    weight by one bf16 ulp). Preds agree wherever both engines' top two
    masked scores are 0.05 apart, votes until a pred could differ (at this
    seed two of the 12 ticks are that close, and all preds agree)."""
    rng = np.random.default_rng(21)
    jax_model, v, port = bf16_pair(seed=11)
    mean = np.random.default_rng(11).normal(0, 0.2, 12).astype(np.float32)
    std = np.random.default_rng(11).uniform(0.5, 2, 12).astype(np.float32)
    jax_eng = jax_stream.StreamingEngine(JAX_CFG, jax_model, v, mean, std,
                                         use_fused_encoder=fused)
    eng = StreamingEngine(CFG, port, mean, std)
    assert all(t.dtype == (BF16 if i % 2 == 0 or i == len(eng.folded_chain)
                           - 1 else torch.float32)
               for i, t in enumerate(eng.folded_chain))
    calib = (rng.standard_normal((2000, 12)) * 3 + 1).astype(np.float32)
    jax_eng.calibrate(calib)
    eng.calibrate(calib)
    mask = np.zeros(C, bool)
    mask[[0, 7, 23, 30]] = True
    blocks = (rng.standard_normal((12, CFG.factor, 12)) * 2).astype(
        np.float32)
    c_j, c_t = jax_eng.init_carry(), eng.init_carry()
    p_j, v_j, p_t, v_t = [], [], [], []
    for chunk in (blocks[:5], blocks[5:]):
        c_j, pj, vj = jax_eng.steps(c_j, chunk, mask)
        c_t, pt, vt = eng.steps(c_t, chunk, mask)
        p_j += list(np.asarray(pj))
        v_j += list(np.asarray(vj))
        p_t += pt.tolist()
        v_t += vt.tolist()
    # the per-tick scores of both, for the near-tie test
    s_j, s_t = [], []
    cj, ct = jax_eng.init_carry(), eng.init_carry()
    for k in range(12):
        cj, _, _, sj = jax_eng.step(cj, blocks[k], mask)
        ct, pk, vk, st = eng.step(ct, blocks[k], mask)
        assert (int(pk), int(vk)) == (p_t[k], v_t[k])  # step == steps
        s_j.append(np.asarray(sj)[mask])
        s_t.append(st.numpy()[mask])
    tied = near_ties(np.array(s_j), 0.05) | near_ties(np.array(s_t), 0.05)
    assert_agree_away_from_ties(p_t, v_t, p_j, v_j, tied)
    assert set(p_t) <= {0, 7, 23, 30}
    assert_state_close(c_t.iir_state, c_j.iir_state)
    assert_state_close(c_t.tail, c_j.tail)
    assert int(c_t.n_seen) == int(c_j.n_seen)


def test_bf16_batched_engine_matches_jax():
    """``test_serve.py:380``'s setup (S=2, bf16, n_linear 2, hidden 64,
    per-session subsets) with session 1 calibrated, against the JAX fused
    batched chain (interpret mode) over a carry threaded across two
    ``steps`` calls: preds and votes inside each subset, and equal to
    JAX's wherever the port's top two masked scores are 1e-2 apart (the
    two compute the same bf16 fold chain; at this seed one of the 12
    (tick, session) pairs is that close, and all preds agree)."""
    S = 2
    rng = np.random.default_rng(5)
    jax_model, v, port = bf16_pair(seed=5)
    zero, one = np.zeros(12, np.float32), np.ones(12, np.float32)
    jax_eng = jax_stream.BatchedStreamingEngine(
        JAX_CFG, jax_model, v, emg_mean=zero, emg_std=one, n_sessions=S,
        use_fused_encoder=True)
    eng = BatchedStreamingEngine(CFG, port, zero, one, S)
    assert eng.shared_chain[0].dtype == BF16
    calib = (rng.standard_normal((2000, 12)) * 4 + 2).astype(np.float32)
    jax_eng.calibrate_session(1, calib)
    eng.calibrate_session(1, calib)
    masks = np.zeros((S, C), bool)
    masks[0, [3, 11]] = True
    masks[1, [7, 20, 33]] = True
    blocks = (rng.standard_normal((6, S, CFG.factor, 12)) * 2.0).astype(
        np.float32)
    c_j, c_t = jax_eng.init_carries(), eng.init_carries()
    p_j, v_j, p_t, v_t = [], [], [], []
    for chunk in (blocks[:2], blocks[2:]):
        c_j, pj, vj = jax_eng.steps(c_j, chunk, masks)
        c_t, pt, vt = eng.steps(c_t, chunk, masks)
        p_j.append(np.asarray(pj))
        v_j.append(np.asarray(vj))
        p_t.append(pt.numpy())
        v_t.append(vt.numpy())
    p_j, v_j, p_t, v_t = (np.concatenate(x) for x in (p_j, v_j, p_t, v_t))
    assert set(p_t[:, 0]) | set(v_t[:, 0]) <= {3, 11}
    assert set(p_t[:, 1]) | set(v_t[:, 1]) <= {7, 20, 33}
    ct, scores = eng.init_carries(), []
    for k in range(6):
        ct, _, _, s = eng.step(ct, blocks[k], masks)
        scores.append(np.where(masks, s.numpy(), -np.inf))
    tied = near_ties(np.array(scores), 1e-2)
    assert_agree_away_from_ties(p_t, v_t, p_j, v_j, tied)
    assert_state_close(c_t.iir_state, c_j.iir_state)
    np.testing.assert_array_equal(c_t.n_seen.numpy(), np.asarray(c_j.n_seen))


def test_bf16_serve_path_launches_nothing_on_the_cpu():
    """On CPU tensors the bf16 engines run the plain versions: no kernel
    launch is counted, neither variant."""
    _, _, port = bf16_pair(seed=3)
    eng = StreamingEngine(CFG, port, np.zeros(12, np.float32),
                          np.ones(12, np.float32))
    K.reset_launch_counts()
    block = np.random.default_rng(0).standard_normal(
        (CFG.factor, 12)).astype(np.float32)
    eng.step(eng.init_carry(), block)
    assert not any(K.launch_counts.values())


# ----------------------------------------------------- the f32 default
def _module_loop(emg_net, frames):
    """The EMG tower's modules run one after another: its forward before
    a compute dtype existed."""
    x = frames.reshape(-1, 1, 1, 12)
    for m in (*emg_net.conv_emg, *emg_net.linear, *emg_net.last):
        x = m(x) if not hasattr(m, "running_mean") else m(x, None)
    return x


def test_f32_default_keeps_its_bits():
    """The default compute dtype is f32, and the f32 forward is the
    modules run one after another, bit for bit, in train mode (batch
    statistics) as in eval mode, and in float64 (a float64 model stays
    float64, as the float64 checks of the train step need); the f32 folds
    are f32 throughout and equal to a fold that names its dtype."""
    model = TorchModel(n_linear=2, hidden=64,
                       generator=torch.Generator().manual_seed(4)).eval()
    assert model.dtype == model.emg_net.dtype == torch.float32
    frames = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (50, 12)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(model.emg_net(frames),
                           _module_loop(model.emg_net, frames))
        for m in model.emg_net.norms():
            m.train()  # batch statistics; the running ones move alike
        one, two = copy.deepcopy(model.emg_net), copy.deepcopy(model.emg_net)
        assert torch.equal(one(frames), _module_loop(two, frames))
        for m in model.emg_net.norms():
            m.eval()
        wide = copy.deepcopy(model).double()
        got64 = wide.emg_net(frames.double())
        assert got64.dtype == torch.float64
        assert torch.equal(got64, _module_loop(wide.emg_net,
                                               frames.double()))
        emb = model.encode_classes()
        default = K.fold_encoder_params(model.emg_net, emb)
        named = K.fold_encoder_params(model.emg_net, emb,
                                      dtype=torch.float32)
    assert all(t.dtype == torch.float32 for t in default)
    assert all(torch.equal(a, b) for a, b in zip(default, named))
    eng = StreamingEngine(CFG, model, np.zeros(12, np.float32),
                          np.ones(12, np.float32))
    assert all(t.dtype == torch.float32 for t in eng.folded_chain)


def test_bf16_model_trains_and_evaluates():
    """A bf16 model in a ``TrainState`` (bf16 training): a ``Trainer(
    compute_dtype="bfloat16")`` step, eager and on the fused chain, and an
    evaluation, the fused encoder's included, run on it; the parameters,
    gradients and Adam moments stay f32 and the loss is finite."""
    from contrastiveprosthetics_torch.data.store import DeviceStore
    from contrastiveprosthetics_torch.data.synthetic import (
        make_processed_dataset,
    )
    from contrastiveprosthetics_torch.train.engine import Hyper, Trainer

    store = DeviceStore(CFG, *make_processed_dataset(
        CFG, people_positions=[40], seed=3))
    for fused in (False, True):
        tr = Trainer(CFG, store, adabn=False, n_linear=2, hidden=64,
                     compute_dtype="bfloat16", use_fused_train=fused,
                     use_fused_encoder=True)
        state = tr.init_state(tr.generator(0))
        assert state.model.dtype == BF16
        v = tr.view_train
        emg_b = v.emg_flat[:8 * v.n_tasks].reshape(8, v.n_tasks, -1)
        loss, _ = tr._sgd_step(state, emg_b, Hyper.single(1e-3, 0, 0.5, 1e-3,
                                                          0, 0.3),
                               1e-3, 1e-3, tr.generator(1))
        assert bool(torch.isfinite(loss))
        assert all(p.dtype == torch.float32
                   for p in state.model.parameters())
        assert all(m.dtype == torch.float32 for m in state.opt_emg.mu)
        res = tr.evaluate(state, tr.generator(2), None, "val")
        assert bool(torch.isfinite(res.loss))


def test_bf16_state_dict_is_f32_and_loads_in_any_dtype():
    """Checkpoints carry no dtype: a bf16 model's state_dict is the f32
    reference layout, and it loads into either compute dtype."""
    _, _, port = bf16_pair(seed=6)
    sd = port.state_dict()
    assert all(t.dtype in (torch.float32, torch.int64) for t in sd.values())
    for dtype in (torch.float32, BF16):
        again = model_from_state_dict(sd, dtype=dtype)
        assert again.dtype == dtype
        assert all(torch.equal(again.state_dict()[k], v)
                   for k, v in sd.items())


def test_jax_bf16_model_dtype_follows_into_its_engine_folds():
    """The JAX engine folds in its model's dtype (``serve/stream.py:203``),
    as the port's does: the reference the tests above hold the port to."""
    jax_model, v, port = bf16_pair(seed=9)
    eng = jax_stream.StreamingEngine(JAX_CFG, jax_model, v,
                                     np.zeros(12, np.float32),
                                     np.ones(12, np.float32),
                                     use_fused_encoder=True)
    assert eng._folded[0].dtype == jnp.bfloat16
    port_eng = StreamingEngine(CFG, port, np.zeros(12, np.float32),
                               np.ones(12, np.float32))
    assert port_eng.folded_chain[0].dtype == BF16
    assert jax.tree_util.tree_leaves(v["params"])[0].dtype == jnp.float32
