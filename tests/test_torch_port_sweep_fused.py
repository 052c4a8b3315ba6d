"""PyTorch port: the crossval sweep on the fused training chain and on the
fused encoder (the config axis of K5f, K5b, the tail pair and
``encoder_chain``), against the JAX package and the port's own paths.

On the CPU the config-axis wrappers run their plain versions; the JAX
chain and encoder run their Pallas kernels in interpret mode under
``jax.vmap``, as the JAX sweep runs them (``train/engine.py:586-590``).
Small width (n_linear 2-3, hidden 64, C = 2-3), a one-person synthetic
store; explicit masks where the two frameworks' random bits would differ.
Each test states its tolerance.
"""
from __future__ import annotations

import copy
import functools
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrastiveprosthetics_torch.cli import train as cli_train
from contrastiveprosthetics_torch.config import DEFAULT_CONFIG as CFG
from contrastiveprosthetics_torch.data import sampler
from contrastiveprosthetics_torch.data.store import DeviceStore
from contrastiveprosthetics_torch.data.synthetic import make_processed_dataset
from contrastiveprosthetics_torch.models.stacked import StackedContrastiveModel
from contrastiveprosthetics_torch.ops import kernels as K
from contrastiveprosthetics_torch.ops import train_fused as TF
from contrastiveprosthetics_torch.train import engine as port_engine
from contrastiveprosthetics_torch.train.engine import Hyper, Trainer, TrainState
from contrastiveprosthetics_tpu.config import DEFAULT_CONFIG as JCFG
from contrastiveprosthetics_tpu.data.store import DeviceStore as JaxStore
from contrastiveprosthetics_tpu.ops import pallas_ops as jax_ops
from contrastiveprosthetics_tpu.ops import train_fused as jax_tf
from contrastiveprosthetics_tpu.train import engine as jax_engine
from test_torch_port_crossval import (
    HYPERS,
    VAL_LOSS_RTOL,
    assert_first_step_matches,
    first_moments,
    jax_hyper,
    jax_val_indices,
    port_hyper,
    stacked_state,
)
from test_torch_port_train import t
from test_torch_port_train_fused import assert_grads_close

torch.set_num_threads(1)

SMALL = dict(n_linear=2, hidden=64)
BF16 = torch.bfloat16
VALUE_TOL = dict(rtol=2e-5, atol=2e-5)  # test_train_fused.py:76-79


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def data():
    return make_processed_dataset(CFG, people_positions=[40], seed=3)


@pytest.fixture(scope="module")
def store(data):
    return DeviceStore(CFG, *data)


def trainer(store, **kw) -> Trainer:
    kw = {"adabn": False, "batch_size": 8, **SMALL, **kw}
    return Trainer(CFG, store, **kw)


# ------------------------------------------------ the config-axis chain
def stacked_chain(C=2, L=3, D0=64, F=64, N=40, seed=0, bf16=False):
    """C configs' chain inputs (numpy): x0 (C, N, D0), per block W (C,
    D_in, F), b, gamma, beta (C, F); a rate per config and one {0,1} mask
    per dropped block (C, N, F); a cotangent for h."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    ws = [f32(rng.uniform(-1, 1, (C, D0 if i == 0 else F, F))
              / np.sqrt(D0)) for i in range(L)]
    bs = [f32(rng.normal(0, 0.1, (C, F))) for _ in range(L)]
    gs = [f32(rng.uniform(0.8, 1.2, (C, F))) for _ in range(L)]
    betas = [f32(rng.normal(0, 0.1, (C, F))) for _ in range(L)]
    x0 = f32(rng.standard_normal((C, N, D0)))
    if bf16:  # values a bf16 input holds
        x0 = torch.from_numpy(x0).to(BF16).float().numpy()
    rates = f32(np.linspace(0.2, 0.4, C))
    masks = [f32(rng.random((C, N, F)) < 1 - rates[:, None, None])
             for _ in range(min(4, L))]
    cot = f32(rng.standard_normal((C, N, F)))
    return x0, ws, bs, gs, betas, rates, masks, cot


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_config_axis_chain_matches_jax_vmap(bf16):
    """The port's chain on (C, ...) inputs (the plain K5f/K5b and tail at
    their config axis, one call for both configs) against ``jax.vmap(
    jax.value_and_grad(...))`` of the JAX ``fused_dense_chain`` in
    interpret mode, ``mask_mode="input"``, each config its own masks and
    rate: C=2, 40 rows, 3 blocks of 64. f32: h at rtol/atol 2e-5, the
    statistics at atol 1e-5, every gradient at rtol 2e-4, atol 2e-5 x max
    (``test_torch_port_train_fused.py``'s). bf16 (JAX op by op, as
    ``test_torch_port_train_bf16.py``): h at JAX's atol 0.05, the
    statistics at 1e-2, every gradient in the relative 2-norm at 2e-3."""
    x0, ws, bs, gs, betas, rates, masks, cot = stacked_chain(bf16=bf16)
    L = len(ws)
    cdtype = jnp.bfloat16 if bf16 else jnp.float32

    def jax_loss(x, w, b, g, be, rate, mk, ct):
        h, m, v = jax_tf.fused_dense_chain(
            x, w, b, g, be, jax.random.PRNGKey(0), rate, mask_mode="input",
            ext_masks=mk, compute_dtype=cdtype, interpret=True)
        return jnp.sum(h.astype(jnp.float32) * ct), (h, m, v)

    grad = jax.vmap(jax.value_and_grad(jax_loss, argnums=(0, 1, 2, 3, 4),
                                       has_aux=True))
    jargs = (jnp.asarray(x0, cdtype),
             *(tuple(map(jnp.asarray, p)) for p in (ws, bs, gs, betas)),
             jnp.asarray(rates), tuple(map(jnp.asarray, masks)),
             jnp.asarray(cot))
    if bf16:
        with jax.disable_jit():
            (_, (hj, mj, vj)), jg = grad(*jargs)
    else:
        (_, (hj, mj, vj)), jg = jax.jit(grad)(*jargs)

    x = t(x0).to(BF16 if bf16 else torch.float32).requires_grad_()
    params = [[t(a).requires_grad_() for a in p] for p in (ws, bs, gs, betas)]
    h, m, v = TF.fused_dense_chain(x, *params, None, t(rates),
                                   mask_mode="input",
                                   ext_masks=[t(mk) for mk in masks])
    assert m.shape == v.shape == (2, L, 64)
    (h.float() * t(cot)).sum().backward()
    got = [x.grad] + [p.grad for group in params for p in group]
    want = [jg[0]] + [a for group in jg[1:] for a in group]
    hf = h.detach().float().numpy()
    if bf16:
        np.testing.assert_allclose(hf, np.asarray(hj, np.float32),
                                   rtol=0.05, atol=0.05)
        for a, b in ((m, mj), (v, vj)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-2,
                                       atol=1e-2)
        for i, (a, b) in enumerate(zip(got, want, strict=True)):
            assert rel_l2(a.float().numpy(), np.asarray(b, np.float32)) \
                <= 2e-3, i
    else:
        np.testing.assert_allclose(hf, np.asarray(hj), **VALUE_TOL)
        for a, b in ((m, mj), (v, vj)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
        assert_grads_close([g.numpy() for g in got], want, 2e-4, 2e-5)


def _block_case(C, N, K, F, seed):
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    x = f32(np.maximum(rng.standard_normal((C, N, K)), 0))
    w = f32(rng.uniform(-1, 1, (C, F, K)) / np.sqrt(K)).transpose(1, 2)
    b, gamma, beta = (f32(rng.normal(0, 0.1, (C, F))) for _ in range(3))
    mean, var = f32(rng.uniform(0.2, 0.6, (C, K))), f32(rng.uniform(
        0.2, 0.5, (C, K)))
    rstd = torch.rsqrt(var + 1e-5)
    a = f32(rng.uniform(0.8, 1.2, (C, K))) * rstd
    in_stats = torch.stack([mean, var, rstd, a, 0.1 - mean * a], 1)
    dz = f32(rng.standard_normal((C, N, F)) * 0.01)
    seed_words = torch.tensor(rng.integers(-2**31, 2**31, (C, 2)),
                              dtype=torch.int32)
    keep = f32(np.linspace(0.5, 0.8, C))
    return x, w, b, gamma, beta, in_stats, dz, seed_words, keep


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_config_axis_plain_versions_are_each_configs_own(bf16):
    """Each config-axis plain version (K5f, K5b, the tail pair, the masks)
    on 3 configs, each its own seed words and keep, against the
    single-config plain version on each config: the masks bit for bit, the
    rest at rtol 1e-6, atol 1e-7 x max (batched and single products may
    sum in other orders)."""
    C, N, Kw, F = 3, 33, 48, 40
    x, w, b, gamma, beta, in_stats, dz, seeds, keep = _block_case(
        C, N, Kw, F, 1)
    if bf16:
        x, w, dz = x.to(BF16), w.to(BF16), dz.to(BF16)
    drop = dict(seed=seeds, keep=keep, drop_block=2)
    r, stats = TF.dense_block_fwd(x, w, b, gamma, beta, in_stats, **drop)
    sums = torch.stack([stats[:, 0] * 0.3, stats[:, 2] * 0.1], 1)
    dx, dw, db, out_sums = TF.dense_block_bwd(dz, r, x, w, stats, sums,
                                              in_stats, **drop)
    tail_drop = dict(drop, drop_block=3)
    h = TF.chain_tail_fwd(r, stats, **tail_drop)
    dzt, tsums = TF.chain_tail_bwd(r, r, stats, **tail_drop)
    masks = TF.dropout_masks_reference(seeds, keep, N, Kw, 2)

    def close(got, want):
        got, want = got.float(), want.float()
        atol = 1e-7 * max(float(want.abs().max()), 1e-3)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=atol)

    for c in range(C):
        one = dict(seed=seeds[c], keep=keep[c:c + 1], drop_block=2)
        assert torch.equal(masks[c], TF.dropout_masks_reference(
            seeds[c], keep[c:c + 1], N, Kw, 2))
        r1, st1 = TF.dense_block_fwd(x[c], w[c], b[c], gamma[c], beta[c],
                                     in_stats[c], **one)
        close(r[c], r1)
        close(stats[c], st1)
        for got, want in zip((dx[c], dw[c], db[c], out_sums[c]),
                             TF.dense_block_bwd(dz[c], r[c], x[c], w[c],
                                                stats[c], sums[c],
                                                in_stats[c], **one)):
            close(got, want)
        one["drop_block"] = 3
        assert torch.equal(h[c], TF.chain_tail_fwd(r[c], stats[c], **one))
        dz1, s1 = TF.chain_tail_bwd(r[c], r[c], stats[c], **one)
        assert torch.equal(dzt[c], dz1)
        close(tsums[c], s1)


# ------------------------------------------------- the stacked fused step
def step_batch(tr, gens, col=0):
    v = tr.view_train
    emg_rand, glove_rand = tr._stacked_permutations(gens, v)
    batches, _ = sampler.stacked_epoch_batches(gens, v.D, tr.batch_size)
    emg_b = sampler.stacked_gather_train_batch(v.emg_flat, emg_rand,
                                               batches[:, col])
    glove_b = (sampler.stacked_gather_glove_batch(
        v.glove_flat, glove_rand, batches[:, col], v.D_glove)
        if tr.reads_glove else None)
    return emg_b, glove_b


def test_stacked_fused_step_is_a_loop_of_single_fused_steps(store):
    """A fused stacked step of 3 configs (each its own lr, reg, dropout
    rate and masks, fed explicitly) against each config's single fused
    step on its own weights, batch and masks: losses (rtol 1e-5),
    accuracies, and after Adam every parameter, first moment and running
    statistic as ``test_stacked_step_is_a_loop_of_single_steps`` holds the
    eager pair."""
    tr = trainer(store, use_fused_train=True)
    gens = [tr.generator(20 + c) for c in range(3)]
    state = tr.init_sweep_state(gens)
    singles = [TrainState.fresh(state.model.unstack(c)) for c in range(3)]
    hy = HYPERS.copy()
    hy[:, 2] = (0.5, 0.4, 0.6)
    emg_b, _ = step_batch(tr, gens)
    rows = emg_b.shape[1] * emg_b.shape[2]
    rng = np.random.default_rng(4)
    masks = [t((rng.random((3, rows, 64)) < 1 - hy[:, 2, None, None])
               .astype(np.float32)) for _ in range(2)]
    h = port_hyper(hy)
    loss, acc = tr._sgd_step(state, emg_b, h, h.lr_emg, h.lr_glove, None,
                             ext_masks=masks)
    want = [tr._sgd_step(s, emg_b[c], Hyper.single(*hy[c]), float(hy[c, 0]),
                         float(hy[c, 3]), None,
                         ext_masks=[m[c] for m in masks])
            for c, s in enumerate(singles)]
    np.testing.assert_allclose(loss.numpy(), [float(w[0]) for w in want],
                               rtol=1e-5)
    np.testing.assert_allclose(acc.numpy(), [float(w[1]) for w in want],
                               atol=1e-6)
    sds = [s.model.state_dict() for s in singles]
    mus = [first_moments(s) for s in singles]
    assert_first_step_matches(
        state, {k: torch.stack([sd[k] for sd in sds]) for k in sds[0]},
        {k: torch.stack([m[k] for m in mus]) for k in mus[0]}, h.lr_emg,
        h.lr_glove)


F64_RTOL = 1e-9  # stacked against single steps in float64, as PR 9's


@pytest.mark.parametrize("mode", [dict(), dict(adabn=True),
                                  dict(glove_encoding=True)],
                         ids=["onehot", "adabn", "glove_encoding"])
def test_stacked_fused_step_matches_the_stacked_eager_step_in_float64(
        store, mode):
    """The fused and the eager stacked step of 3 configs in float64 at
    dropout 0 (the fused chain's plain versions in float64, its first
    dense block on the channel-major flatten, the eager tower's on the
    position-major one with the weight permuted): losses, every gradient
    and the running statistics within 1e-9."""
    out = []
    for fused in (False, True):
        tr = trainer(store, use_fused_train=fused, **mode)
        gens = [tr.generator(30 + c) for c in range(3)]
        state = tr.init_sweep_state(gens)
        state = TrainState.fresh(copy.deepcopy(state.model).double())
        emg_b, glove_b = step_batch(tr, gens)
        h = Hyper(*[torch.as_tensor(HYPERS[:, j], dtype=torch.float64)
                    for j in range(6)])
        loss, _, grads = tr.loss_and_grads(
            state, emg_b.double(), h, None,
            glove_b=None if glove_b is None else glove_b.double())
        out.append((loss, grads, state.model.state_dict()))
    (l0, g0, sd0), (l1, g1, sd1) = out
    np.testing.assert_allclose(l1.numpy(), l0.numpy(), rtol=F64_RTOL)
    for tower in ("emg_net", "glove_net"):
        for i, (a, b) in enumerate(zip(g1[tower], g0[tower], strict=True)):
            scale = max(float(b.abs().max()), 1e-12)
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=F64_RTOL,
                                       atol=F64_RTOL * scale,
                                       err_msg=f"{tower} {i}")
    for name, value in sd1.items():
        np.testing.assert_allclose(value.double().numpy(),
                                   sd0[name].double().numpy(),
                                   rtol=F64_RTOL, atol=1e-12, err_msg=name)


def test_stacked_fused_step_draws_one_seed_pair_a_config(store):
    """With a generator the stacked fused step draws (C, 2) seed words;
    a config's masks are those its words replay (``dropout_masks``) in
    the plain chain, and a rate of 0 keeps everything."""
    tr = trainer(store, use_fused_train=True)
    gens = [tr.generator(40 + c) for c in range(2)]
    state = tr.init_sweep_state(gens)
    emg_b, _ = step_batch(tr, gens)
    seeds = []
    real = TF.fused_dense_chain

    def spy(x0, ws, bs, gammas, betas, seed_words, rate, **kw):
        seeds.append((seed_words, rate))
        return real(x0, ws, bs, gammas, betas, seed_words, rate, **kw)

    hy = HYPERS[:2].copy()
    hy[:, 2] = (0.0, 0.5)
    h = port_hyper(hy)
    try:
        TF.fused_dense_chain = spy
        tr.loss_and_grads(state, emg_b, h, tr.generator(7))
    finally:
        TF.fused_dense_chain = real
    (words, rate), = seeds
    assert words.shape == (2, 2) and words.dtype == torch.int32
    assert torch.equal(rate, h.dp_emg)
    rows = emg_b.shape[1] * emg_b.shape[2]
    m = TF.dropout_masks_reference(words, 1.0 - rate, rows, 64, 1)
    assert bool((m[0] == 1).all())
    assert 0.4 < float(m[1].mean()) < 0.6


def test_fused_sweep_matches_the_eager_sweep_at_dropout_0(store):
    """``sweep_chunk`` of 3 configs for one epoch at bs 128, dropout 0,
    on the fused chain and on the eager tower: the val losses at the
    sweep's VAL_LOSS_RTOL (the two paths' f32 orders, carried by Adam) and
    the voted accuracies within one vote of 4 x 41."""
    h = Hyper(*[HYPERS[:, j] for j in range(6)])
    out = {}
    for fused in (False, True):
        tr = trainer(store, batch_size=128, use_fused_train=fused)
        out[fused] = tr.sweep_chunk(h, [tr.generator(50 + c)
                                        for c in range(3)], [1.0], [1.0],
                                    None)
    np.testing.assert_allclose(out[True][0].numpy(), out[False][0].numpy(),
                               rtol=VAL_LOSS_RTOL)
    np.testing.assert_allclose(out[True][1].numpy(), out[False][1].numpy(),
                               atol=1 / (4 * 41) + 1e-6)


# -------------------------------------------- the fused encoder, stacked
def stacked_model(store, seed=60, C=3, **kw):
    """A stacked model of C configs with running statistics away from the
    identity, so the fold's BatchNorm affines are not."""
    tr = trainer(store, **kw)
    model = tr.init_sweep_state([tr.generator(seed + c)
                                 for c in range(C)]).model
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for bn in model.emg_net.norms():
            bn.running_mean.copy_(t(rng.normal(0, 0.2, bn.running_mean.shape)
                                    .astype(np.float32)))
            bn.running_var.copy_(t(rng.uniform(0.5, 2.0, bn.running_var.shape)
                                   .astype(np.float32)))
    return model.eval()


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
def test_stacked_fold_is_each_configs_fold(store, dtype):
    """The fold of a stacked model (one call for the chunk) is each
    config's ``fold_encoder_params`` stacked, bit for bit."""
    model = stacked_model(store)
    folded = K.fold_encoder_params(model.emg_net, model.encode_classes(),
                                   dtype=dtype)
    assert folded[0].shape[0] == 3 and folded[0].dtype == dtype
    for c in range(3):
        one = model.unstack(c).eval()
        want = K.fold_encoder_params(one.emg_net, one.encode_classes(),
                                     dtype=dtype)
        for a, b in zip(folded, want, strict=True):
            assert torch.equal(a[c], b)


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
def test_config_axis_encoder_chain_matches_jax_vmap(store, dtype):
    """The config-axis ``encoder_chain`` plain version (a stacked fold of
    3 configs, 200 rows each) against ``jax.vmap`` of the JAX
    ``fused_encoder_logits(..., interpret=True)`` over the same
    per-config folds: f32 at rtol 2e-4, atol 2e-5 (the kernel's
    tolerance), bf16 at JAX's atol 0.05 (``test_pallas.py:226``); and
    config c of the call against the plain chain on config c's fold
    alone, at the same tolerances."""
    model = stacked_model(store)
    folded = K.fold_encoder_params(model.emg_net, model.encode_classes(),
                                   dtype=dtype)
    rng = np.random.default_rng(2)
    frames = t(rng.standard_normal((3, 200, 12)).astype(np.float32))
    got = K.fused_encoder_logits(frames, folded)
    assert got.shape == (3, 200, 41) and got.dtype == torch.float32
    jdt = jnp.bfloat16 if dtype == BF16 else jnp.float32
    jfold = [jnp.asarray(a.float().numpy()).astype(
        jnp.float32 if a.dtype == torch.float32 else jdt) for a in folded]
    want = jax.jit(jax.vmap(functools.partial(
        jax_ops.fused_encoder_logits, interpret=True)))(
        jnp.asarray(frames.numpy()), jfold)
    tol = (dict(rtol=0, atol=0.05) if dtype == BF16
           else dict(rtol=2e-4, atol=2e-5))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    for c in range(3):
        one = K.fused_encoder_logits(frames[c], [a[c] for a in folded])
        np.testing.assert_allclose(got[c].numpy(), one.numpy(), **tol)


def val_indices(jtr):
    keys = jax.random.split(jax.random.PRNGKey(12), 3)
    emg_rand, batches, weights, inverse = jax_val_indices(jtr, keys, 4)
    return (t(emg_rand, torch.long), t(batches, torch.long), t(weights),
            t(inverse, torch.long))


def test_sweep_val_on_the_fused_encoder_matches_jax_and_the_unfused_val(
        data):
    """The sweep's validation of 3 configs with ``use_fused_encoder``
    (one fold of the chunk, one config-axis chain call a batch) against
    ``jax.vmap`` of the JAX ``_evaluate_scalars`` with its fused encoder
    in interpret mode, from the same weights and index matrices, and
    against the port's unfused sweep val: the losses at rtol 1e-5, the
    voted accuracies equal."""
    emg, pos, glove = data
    jtr = jax_engine.Trainer(JCFG, JaxStore(JCFG, emg, pos, glove),
                             adabn=False, batch_size=4,
                             use_fused_encoder=True, **SMALL)
    jstates = jax.vmap(jtr.init_state)(jax.random.split(
        jax.random.PRNGKey(8), 3))
    # running statistics away from the identity, so the fold is exercised
    rng = np.random.default_rng(8)
    jstates = jstates._replace(batch_stats=jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.uniform(0.5, 1.5, x.shape), x.dtype),
        jstates.batch_stats))
    state = stacked_state(jstates, adabn=False)
    store = DeviceStore(CFG, emg, pos, glove)
    idx = val_indices(jtr)
    got = {}
    for fused in (False, True):
        tr = trainer(store, batch_size=4, use_fused_encoder=fused)
        calls = []
        real = port_engine.fused_encoder_logits

        def spy(frames, folded, *a):
            calls.append(tuple(frames.shape))
            return real(frames, folded, *a)

        port_engine.fused_encoder_logits = spy
        try:
            got[fused] = tr.sweep_evaluate_from_indices(
                state, tr.view_val, *idx)
        finally:
            port_engine.fused_encoder_logits = real
        n_batches = idx[1].shape[1]
        assert calls == ([(3, 4 * 41 * 25, 12)] * n_batches if fused else [])
    jh = jax_hyper()
    keys = jax.random.split(jax.random.PRNGKey(12), 3)
    vl, va = jax.jit(jax.vmap(lambda s, k, hh: jtr._evaluate_scalars(
        s, k, hh, jtr.view_val, 4)))(jstates, keys, jh)
    for loss, acc in (got[True], got[False]):
        np.testing.assert_allclose(loss.numpy(), np.asarray(vl), rtol=1e-5)
        np.testing.assert_array_equal(acc.numpy(), np.asarray(va))


def test_sweep_chunk_on_both_fused_paths_runs_and_holds_its_shapes(store):
    """``sweep_chunk`` with ``use_fused_train`` and ``use_fused_encoder``,
    dropout on: (C,) finite val losses and accuracies in [0, 1]."""
    tr = trainer(store, batch_size=64, use_fused_train=True,
                 use_fused_encoder=True)
    hy = HYPERS.copy()
    hy[:, 2] = (0.5, 0.4, 0.6)
    loss, acc = tr.sweep_chunk(Hyper(*[hy[:, j] for j in range(6)]),
                               [tr.generator(c) for c in range(3)], [1.0],
                               [1.0], tr.generator(9))
    assert loss.shape == acc.shape == (3,)
    assert bool(torch.isfinite(loss).all())
    assert bool(((acc >= 0) & (acc <= 1)).all())


# ----------------------------------------------------------------- the CLI
@pytest.fixture()
def small_cli(monkeypatch, tmp_path, data):
    """``cptorch-train`` on the one-person store at small width, the
    stacked fused paths watched: which of them a run took."""
    seen = {"chain": 0, "encoder": 0}
    real_embed, real_logits = (port_engine.fused_emg_embed,
                               port_engine.fused_encoder_logits)

    def embed(emg_net, frames, *a, **kw):
        seen["chain"] += frames.dim() == 3
        return real_embed(emg_net, frames, *a, **kw)

    def logits(frames, folded, *a):
        seen["encoder"] += frames.dim() == 3
        return real_logits(frames, folded, *a)

    monkeypatch.setattr(port_engine, "fused_emg_embed", embed)
    monkeypatch.setattr(port_engine, "fused_encoder_logits", logits)
    monkeypatch.setattr(cli_train, "build_store",
                        lambda args, cfg, device: DeviceStore(cfg, *data,
                                                              device=device))
    monkeypatch.setattr(port_engine, "Trainer",
                        functools.partial(Trainer, **SMALL))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    argv = ["--synthetic", "--crossval_size", "3", "--final_epochs", "1",
            "--batch_size", "32", "--platform", "cpu", "--data_dir",
            str(tmp_path), "--checkpoint_dir", str(tmp_path)]
    return argv, seen


@pytest.mark.parametrize("argv,chain,encoder", [
    (["--no_adabn", "--fused_train", "on"], True, False),
    (["--no_adabn", "--glove_encoding", "--fused_train", "on"], True, False),
    (["--no_adabn", "--bf16", "--fused_train", "on"], True, False),
    (["--no_adabn", "--fused_encoder"], False, True),
    (["--no_adabn", "--fused_train", "on", "--fused_encoder"], True, True),
    (["--no_adabn", "--bf16", "--fused_train", "on", "--fused_encoder"],
     True, True),
    (["--fused_train", "on"], True, False),
], ids=["fused_train", "glove_encoding", "bf16", "fused_encoder", "both",
        "both-bf16", "adabn"])
def test_cli_sweep_runs_on_the_fused_paths(small_cli, tmp_path, argv, chain,
                                           encoder):
    """``cptorch-train --crossval_size 3`` with ``--fused_train on`` and/or
    ``--fused_encoder`` runs the sweep (the stacked chain's and the
    stacked encoder's calls seen where asked), writes its files and exits
    0."""
    base, seen = small_cli
    assert cli_train.main([*base, *argv]) == 0
    values = np.load(tmp_path / "cross_val_values.npy")
    assert values.shape == (3, 2) and np.isfinite(values).all()
    assert (seen["chain"] > 0) == chain
    assert (seen["encoder"] > 0) == encoder


def test_stacked_model_encode_classes_is_each_configs(store):
    """``StackedContrastiveModel.encode_classes`` (one-hot) is each
    config's ``encode_classes()``, bit for bit."""
    tr = trainer(store)
    model = tr.init_sweep_state([tr.generator(c)
                                 for c in range(2)]).model.eval()
    assert isinstance(model, StackedContrastiveModel)
    got = model.encode_classes()
    for c in range(2):
        assert torch.equal(got[c], model.unstack(c).eval().encode_classes())
