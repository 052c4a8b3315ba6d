"""PyTorch port: bfloat16 training (``Trainer(compute_dtype="bfloat16")``,
``cptorch-train --bf16``) against the JAX package's, on the CPU.

The JAX package trains a bf16 EMG tower with f32 parameters, statistics,
gradients and optimizer state: flax's bf16 Conv and Dense layers on the
eager path, the fused chain's bf16 kernels (``ops/train_fused.py``,
``compute_dtype=bfloat16``) on the fused one, and bf16 folds for the fused
encoder's evaluation. The port rounds at the same places
(``models/layers.py::low_precision``, ``ops/train_fused.py``).

XLA's compiled programs may skip an f32 -> bf16 -> f32 round trip (its
excess-precision simplification), so where a comparison is meant to hold
the rounding points exactly the JAX side runs op by op
(``jax.disable_jit``). Inputs are made with numpy from a seed, at small
widths. Each test states its tolerance and what was measured.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from contrastiveprosthetics_torch.cli import results as cli_results
from contrastiveprosthetics_torch.cli import train as cli_train
from contrastiveprosthetics_torch.config import DEFAULT_CONFIG as CFG
from contrastiveprosthetics_torch.data.store import DeviceStore
from contrastiveprosthetics_torch.data.synthetic import make_processed_dataset
from contrastiveprosthetics_torch.models.convert import (
    from_flax_variables,
    load_reference_checkpoint,
    model_from_state_dict,
)
from contrastiveprosthetics_torch.models.layers import low_precision
from contrastiveprosthetics_torch.models.stacked import (
    StackedContrastiveModel,
)
from contrastiveprosthetics_torch.ops import kernels as K
from contrastiveprosthetics_torch.ops import train_fused as TF
from contrastiveprosthetics_torch.train import crossval as port_crossval
from contrastiveprosthetics_torch.train import engine as port_engine
from contrastiveprosthetics_torch.train.engine import (
    Hyper,
    Trainer,
    TrainState,
    adam_init,
    adam_step_,
    stacked_adam_init,
)
from contrastiveprosthetics_tpu.config import DEFAULT_CONFIG as JCFG
from contrastiveprosthetics_tpu.data import sampler as jax_sampler
from contrastiveprosthetics_tpu.data.store import DeviceStore as JaxStore
from contrastiveprosthetics_tpu.models.clip import l2_penalty as jax_l2_penalty
from contrastiveprosthetics_tpu.ops import train_fused as jax_tf
from contrastiveprosthetics_tpu.train import engine as jax_engine
from test_torch_port_models import jax_variables
from test_torch_port_train import named_grads, t

torch.set_num_threads(1)

BF16 = torch.bfloat16
SMALL = dict(n_linear=2, hidden=64)


def as_f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32))


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def bf16_state(jstate, adabn=False) -> TrainState:
    """The port's bf16 TrainState holding a JAX state's (f32) weights and
    statistics, with fresh Adam chains."""
    tree = jax.tree_util.tree_map(np.asarray, (jstate.params,
                                               jstate.batch_stats))
    return TrainState.fresh(model_from_state_dict(
        from_flax_variables(*tree, adabn=adabn), dtype=BF16))


@pytest.fixture(scope="module")
def data():
    return make_processed_dataset(CFG, people_positions=[40, 41], seed=3)


def bf16_trainers(data, batch_size=8, **kw):
    emg, pos, glove = data
    port = Trainer(CFG, DeviceStore(CFG, emg, pos, glove), adabn=False,
                   batch_size=batch_size, compute_dtype="bfloat16",
                   **SMALL, **kw)
    jtr = jax_engine.Trainer(JCFG, JaxStore(JCFG, emg, pos, glove),
                             adabn=False, batch_size=batch_size,
                             compute_dtype="bfloat16", **SMALL, **kw)
    return port, jtr


# ------------------------------------------------------------- the chain
def chain_case(L=3, D0=128, F=128, N=64, seed=0, keep=0.75):
    """test_train_fused.py:131's sizes: numpy weights, a bf16 input, one
    {0,1} mask per dropped block and a cotangent for h."""
    rng = np.random.default_rng(seed)
    ws = [(rng.uniform(-1, 1, (D0 if i == 0 else F, F)) / np.sqrt(D0))
          .astype(np.float32) for i in range(L)]
    bs = [rng.normal(0, 0.1, F).astype(np.float32) for _ in range(L)]
    gs = [rng.uniform(0.8, 1.2, F).astype(np.float32) for _ in range(L)]
    betas = [rng.normal(0, 0.1, F).astype(np.float32) for _ in range(L)]
    x0 = as_f32(jnp.asarray(rng.standard_normal((N, D0)), jnp.bfloat16))
    masks = [(rng.random((N, F)) < keep).astype(np.float32)
             for _ in range(min(4, L))]
    cot = rng.standard_normal((N, F)).astype(np.float32)
    return x0, ws, bs, gs, betas, masks, cot


@pytest.mark.parametrize("path", ["reference", "fused"])
def test_bf16_chain_matches_jax(path):
    """The port's ``dense_chain_reference`` and ``fused_dense_chain`` in
    bf16 against JAX's (``dense_chain_reference`` and ``fused_dense_chain
    (compute_dtype=bfloat16, mask_mode="input", interpret=True)``), L=3,
    D0=F=128, N=64, dropout 0.25 with given masks. h_L bf16 at JAX's own
    atol 0.05 (measured: bit for bit), means and variances at its 1e-2
    (measured 5e-7); every gradient (x0, W, b, gamma, beta) in the
    relative 2-norm at 2e-3. Measured: the reference's bit for bit but
    one (1.3e-6), the fused chain's within 5.2e-4 (dx0 and dW rounded to
    bf16 where the two frameworks' f32 sums, in other orders, straddle a
    bf16 tie)."""
    x0, ws, bs, gs, betas, masks, cot = chain_case()
    L = len(ws)
    jm = tuple(jnp.asarray(m) for m in masks)

    def jax_loss(x, w, b, g, be):
        if path == "fused":
            h, m, v = jax_tf.fused_dense_chain(
                x, w, b, g, be, jax.random.PRNGKey(0), jnp.float32(0.25),
                mask_mode="input", ext_masks=jm, compute_dtype=jnp.bfloat16,
                interpret=True)
        else:
            h, m, v = jax_tf.dense_chain_reference(
                x, w, b, g, be, jm, jnp.float32(0.75), dropout_from=0,
                compute_dtype=jnp.bfloat16)
        return jnp.sum(h.astype(jnp.float32) * cot), (h, m, v)

    jargs = (jnp.asarray(x0, jnp.bfloat16),
             *(tuple(map(jnp.asarray, p)) for p in (ws, bs, gs, betas)))
    with jax.disable_jit():
        (_, (hj, mj, vj)), jg = jax.value_and_grad(
            jax_loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(*jargs)

    x = t(x0).to(BF16).requires_grad_()
    params = [[t(a).requires_grad_() for a in p] for p in (ws, bs, gs, betas)]
    tm = [t(m) for m in masks]
    if path == "fused":
        h, m, v = TF.fused_dense_chain(x, *params, None, 0.25,
                                       mask_mode="input", ext_masks=tm)
    else:
        h, m, v = TF.dense_chain_reference(x, *params, tm,
                                           torch.full((1,), 0.75),
                                           dropout_from=0, compute_dtype=BF16)
    assert h.dtype == BF16 and m.dtype == v.dtype == torch.float32
    np.testing.assert_allclose(h.detach().float().numpy(), as_f32(hj),
                               rtol=0.05, atol=0.05)
    np.testing.assert_allclose(m.detach().numpy(), np.asarray(mj),
                               rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(v.detach().numpy(), np.asarray(vj),
                               rtol=1e-2, atol=1e-2)
    (h.float() * t(cot)).sum().backward()
    got = [x.grad] + [p.grad for group in params for p in group]
    want = [jg[0]] + [a for group in jg[1:] for a in group]
    assert len(got) == 1 + 4 * L
    assert got[0].dtype == BF16
    assert all(g.dtype == torch.float32 for g in got[1:])
    for i, (a, b) in enumerate(zip(got, want)):
        assert rel_l2(a.float().numpy(), as_f32(b)) <= 2e-3, i


def _block(N=96, K=64, F=48, seed=3, dropped=True):
    """A dense block's bf16 operands, f32 vectors and the previous block's
    statistics, as ``dense_block_*_reference`` take them."""
    rng = np.random.default_rng(seed)
    x = t(np.maximum(rng.standard_normal((N, K)), 0)
          .astype(np.float32)).to(BF16)
    w = t((rng.uniform(-1, 1, (K, F)) / np.sqrt(K)).astype(np.float32)
          ).to(BF16)
    b = t(rng.normal(0, 0.1, F).astype(np.float32))
    gamma = t(rng.uniform(0.8, 1.2, F).astype(np.float32))
    beta = t(rng.normal(0, 0.1, F).astype(np.float32))
    mean = t(rng.uniform(0.2, 0.6, K).astype(np.float32))
    var = t(rng.uniform(0.2, 0.5, K).astype(np.float32))
    rstd = torch.rsqrt(var + 1e-5)
    a = t(rng.uniform(0.8, 1.2, K).astype(np.float32)) * rstd
    in_stats = torch.stack([mean, var, rstd, a, 0.1 - mean * a])
    dz = t((rng.standard_normal((N, F)) * 0.01).astype(np.float32)).to(BF16)
    keep = torch.full((1,), 0.5)
    mask = t((rng.random((N, K)) < 0.5).astype(np.float32))
    drop = dict(keep=keep, mask=mask) if dropped else {}
    return x, w, b, gamma, beta, in_stats, dz, drop


def _f64_input(x, in_stats, drop):
    """h = dropout(a x + c) in f32 (float64 of it), as the kernels take it
    before rounding."""
    z = x.float() * in_stats[3] + in_stats[4]
    if drop:
        z = torch.where(drop["mask"] > 0, z / drop["keep"], 0.0)
    return z


def test_bf16_block_forward_rounding_points():
    """K5f in bf16 (``train_fused.py:203-236``): h is rounded to bf16
    after the affine and dropout in f32, r = relu(h W + b) with f32 sums is
    stored in bf16, and the statistics are those of the stored r. Each held
    against float64 of the same roundings; the statistics of the unrounded
    r differ from them by far more than the tolerance, so a kernel summing
    before its rounding fails here."""
    x, w, b, gamma, beta, in_stats, _, drop = _block()
    r, stats = TF.dense_block_fwd_reference(x, w, b, gamma, beta, in_stats,
                                            **drop)
    assert r.dtype == BF16 and stats.dtype == torch.float32
    h = _f64_input(x, in_stats, drop).to(BF16).double()
    y = torch.relu(h @ w.double() + b.double())
    assert (r.double() - y).abs().max() <= 2 ** -8 * y.abs().max()
    rd = r.double()
    mean, sq = rd.mean(0), (rd * rd).mean(0)
    err = (stats[0].double() - mean).abs().max()
    assert err <= 1e-6 * mean.abs().max()
    assert (stats[1].double() - (sq - mean * mean)).abs().max() <= 1e-5
    assert (y.mean(0) - mean).abs().max() > 50 * err
    # h rounded before the product: the same GEMM on the f32 h differs
    y32 = torch.relu(_f64_input(x, in_stats, drop).double() @ w.double()
                     + b.double())
    assert (y32 - y).abs().max() > 2 ** -8 * y.abs().max() / 4


def test_bf16_block_backward_rounding_points():
    """K5b in bf16 (``train_fused.py:266-324``): dy in f32 from the f32 of
    bf16 dz and r; db sums the unrounded dy (``:304``); both GEMMs read
    dyc = bf16(dy) (``:294``); dW = h^T dyc is f32 and not rounded
    (``:306,653``); dh = dyc W^T with the dropout in f32, dx = bf16(dh)
    (``:317``); the lower block's sums come from the unrounded f32 dh and
    the f32 of x (``:319-324``). Each against float64 of those values, at
    a tolerance 50 times below what the wrong rounding point would give."""
    x, w, b, gamma, beta, in_stats, dz, drop = _block()
    r, stats = TF.dense_block_fwd_reference(x, w, b, gamma, beta, in_stats,
                                            **drop)
    rf = r.float()
    xn = (rf - stats[0]) * stats[2]
    sums = torch.stack([dz.float().sum(0), (dz.float() * xn).sum(0)])
    dx, dw, db, out_sums = TF.dense_block_bwd_reference(
        dz, r, x, w, stats, sums, in_stats, **drop)
    assert dx.dtype == BF16
    assert dw.dtype == db.dtype == out_sums.dtype == torch.float32
    n = dz.shape[0]
    dy = torch.where(rf > 0, stats[3] * (dz.float() - sums[0] / n
                                         - xn * (sums[1] / n)), 0.0).double()
    dyc = dy.float().to(BF16).double()
    # db from the unrounded dy
    err = (db.double() - dy.sum(0)).abs().max()
    assert err <= 1e-6 * dy.sum(0).abs().max()
    assert (dyc.sum(0) - dy.sum(0)).abs().max() > 50 * err
    # dW in f32 from the rounded operands, not rounded itself
    h = _f64_input(x, in_stats, drop).to(BF16).double()
    want = h.T @ dyc
    err = (dw.double() - want).abs().max()
    assert err <= 1e-6 * want.abs().max()
    assert (dw.to(BF16).double() - want).abs().max() > 50 * err
    # dx = bf16(dh), the sums from the unrounded dh
    dh = dyc @ w.double().T
    dh = torch.where(drop["mask"] > 0, dh / 0.5, 0.0)
    assert (dx.double() - dh).abs().max() <= 2 ** -8 * dh.abs().max()
    xn_in = (x.double() - in_stats[0].double()) * in_stats[2].double()
    s_want = torch.stack([dh.sum(0), (dh * xn_in).sum(0)])
    err = (out_sums.double() - s_want).abs().max()
    assert err <= 1e-5 * s_want.abs().max()
    s_rounded = torch.stack([dx.double().sum(0), (dx.double() * xn_in)
                             .sum(0)])
    assert (s_rounded - s_want).abs().max() > 50 * err


def test_bf16_tail_rounding_points():
    """The tail (``train_fused.py:594-601,626-638``): h_L = bf16(dropout(
    f32(r) a + c)); dz_L = dropout(f32(dh_L)), the two sums of the
    unrounded dz_L against f32(r)'s xhat, then dz = bf16(dz_L)."""
    x, _, _, _, _, in_stats, _, drop = _block(N=80, K=64)
    keep = drop["keep"]
    h = TF.chain_tail_fwd_reference(x, in_stats, **drop)
    assert h.dtype == BF16
    assert torch.equal(h, _f64_input(x, in_stats, drop).to(BF16))
    rng = np.random.default_rng(9)
    dh = t((rng.standard_normal(x.shape) * 0.01).astype(np.float32)).to(BF16)
    dz, sums = TF.chain_tail_bwd_reference(dh, x, in_stats, **drop)
    g = torch.where(drop["mask"] > 0, dh.float() / keep, 0.0)
    assert dz.dtype == BF16 and torch.equal(dz, g.to(BF16))
    xn = ((x.float() - in_stats[0]) * in_stats[2]).double()
    want = torch.stack([g.double().sum(0), (g.double() * xn).sum(0)])
    err = (sums.double() - want).abs().max()
    assert err <= 1e-6 * want.abs().max()
    # with keep 0.5 the dropout's division is exact, so round dh instead
    assert not torch.equal(h.float(), _f64_input(x, in_stats, drop))


# ---------------------------------------------------- the whole encoder
@pytest.mark.parametrize("adabn", [False, True])
def test_bf16_fused_emg_embed_matches_jax(adabn):
    """The bf16 EMG encoder on the fused chain at rate 0 (n_linear 4,
    hidden 128, 82 rows): the port's ``fused_emg_embed`` against JAX's
    (``compute_dtype=bfloat16``, interpret mode, run op by op).
    Embeddings, rounded to bf16 by the head, at JAX's own bf16 atol 0.05
    (a bf16 flip in an f32 sum of another order, carried through four
    blocks; measured 0.0156, 4 ulps, in 5 of 1,312); the running
    statistics a plain-BatchNorm step leaves at atol 1e-4 (measured
    3e-6). The gradients' bf16 flips compound through the backward, so
    they are held against the spread of JAX's own two bf16 paths: each
    EMG gradient tensor, f32, no farther from JAX's fused one than JAX's
    eager flax tower's is (measured: 0.051 against 0.111 for the whole
    gradient, every tensor closer)."""
    model, v = jax_variables(n_linear=4, hidden=128, adabn=adabn)
    model = model.clone(dtype=jnp.bfloat16)
    frames = np.random.default_rng(2).standard_normal((82, 12)).astype(
        np.float32)
    bstats = v.get("batch_stats", {})

    def jax_fused(p):
        return jax_tf.fused_emg_embed(
            p["emg_net"], jnp.asarray(frames), jnp.float32(0.0),
            jax.random.key(3), compute_dtype=jnp.bfloat16,
            batch_stats=bstats.get("emg_net"), adabn=adabn, interpret=True)

    def flax_eager(p):
        return model.apply(
            {"params": p, "batch_stats": bstats}, jnp.asarray(frames), 0.0,
            True, rngs={"dropout": jax.random.key(3)},
            mutable=["batch_stats"],
            method=lambda m, f, r, tr: m.emg_net(f, r, tr))[0]

    with jax.disable_jit():
        e_jax, s_jax = jax_fused(v["params"])
        g_jax = jax.grad(lambda p: jnp.sum(jnp.sin(jax_fused(p)[0])))(
            v["params"])
        g_flax = jax.grad(lambda p: jnp.sum(jnp.sin(flax_eager(p))))(
            v["params"])
    sd = from_flax_variables(v["params"], bstats, adabn=adabn)
    emg_net = model_from_state_dict(sd, dtype=BF16).train().emg_net
    e, stats = TF.fused_emg_embed(emg_net, t(frames), 0.0,
                                  torch.zeros(2, dtype=torch.int32))
    assert e.dtype == torch.float32
    np.testing.assert_allclose(e.detach().numpy(), np.asarray(e_jax),
                               rtol=0, atol=0.05)
    if adabn:
        assert stats is None
    else:
        for i, (mean, var) in enumerate(stats):
            r = s_jax[f"BatchNorm_{i}"]["BatchNorm_0"]
            np.testing.assert_allclose(mean.numpy(), np.asarray(r["mean"]),
                                       atol=1e-4)
            np.testing.assert_allclose(var.numpy(), np.asarray(r["var"]),
                                       atol=1e-4)
    names = [n for n, _ in emg_net.named_parameters()]
    grads = torch.autograd.grad(torch.sin(e).sum(), list(emg_net.parameters()))

    def as_state_dict(g):
        params = dict(jax.tree_util.tree_map(np.asarray, g))
        params["glove_net"] = jax.tree_util.tree_map(
            np.asarray, v["params"]["glove_net"])
        sd = from_flax_variables(params, bstats, adabn=adabn)
        return [sd["emg_net." + n].numpy() for n in names]

    want, spread = as_state_dict(g_jax), as_state_dict(g_flax)
    for name, g, w, f in zip(names, grads, want, spread):
        assert g.dtype == torch.float32
        assert rel_l2(g.numpy(), w) <= max(rel_l2(f, w), 1e-3), name
    flat = [np.concatenate([a.ravel() for a in x])
            for x in ([g.numpy() for g in grads], want, spread)]
    assert rel_l2(flat[0], flat[1]) <= 0.6 * rel_l2(flat[2], flat[1])


# ---------------------------------------------------------- train steps
@pytest.mark.parametrize("path", ["eager", "fused", "prediction"])
def test_bf16_train_step_matches_jax(data, path):
    """One ``Trainer(compute_dtype="bfloat16")`` step at dropout 0, eager,
    on the fused chain and in the softmax baseline (its prediction head
    bf16 too, JAX ``emg_net.py:61-66``), against ``jax.grad`` of the JAX
    bf16 trainer's
    loss (run op by op), from the same weights (``models/convert.py``).
    The loss at rtol 1e-5 (measured 6e-7); parameters and gradients f32;
    the running statistics at atol 1e-4 (measured 1.9e-5). The gradients'
    bf16 roundings compound through the backward, so each tensor is held
    in the relative 2-norm at 0.15 and the whole EMG gradient at 0.05:
    measured at most 0.022 (eager) and 0.12 (fused, the first conv's bias,
    a sum of 3,936 rounded cotangents that nearly cancel), where the same
    noise puts JAX's own bf16 gradients 0.12 from its f32 ones."""
    kw = {"eager": {}, "fused": dict(use_fused_train=True),
          "prediction": dict(prediction=True)}[path]
    port, jtr = bf16_trainers(data, **kw)
    jstate = jtr.init_state(jax.random.PRNGKey(6))
    state = bf16_state(jstate)
    hyper = (1e-3, 1e-2, 0.0, 1e-3, 3e-2, 0.0)
    jh, h = jax_engine.Hyper.single(*hyper), Hyper.single(*hyper)
    v = jtr.view_train
    k_perm, k_order = jax.random.split(jax.random.PRNGKey(7))
    emg_rand = jax_sampler.task_permutations(k_perm, v.n_tasks, v.D)
    items = jax.random.permutation(k_order, v.D)[:8]
    emg_b = jax_sampler.gather_train_batch(v.emg_flat, emg_rand, items)
    glove_b = jnp.zeros((8, v.n_tasks, JCFG.glove_dim))

    def total(p):
        loss, aux = jtr._loss_and_metrics(p, jstate.batch_stats, emg_b,
                                          glove_b, jh, jax.random.PRNGKey(0),
                                          True)
        return (loss + jh.reg_emg * jax_l2_penalty(p["emg_net"])
                + jh.reg_glove * jax_l2_penalty(p["glove_net"])), (loss, aux)

    with jax.disable_jit():
        (_, (loss_j, (_, new_bs, _))), jgrads = jax.value_and_grad(
            total, has_aux=True)(jstate.params)
    loss, _, grads = port.loss_and_grads(state, t(emg_b), h, None)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    want = from_flax_variables(
        jax.tree_util.tree_map(np.asarray, jgrads),
        jax.tree_util.tree_map(np.asarray, jstate.batch_stats))
    got = named_grads(state, grads)
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    for name, gr in got.items():
        assert gr.dtype == torch.float32
        assert rel_l2(gr.numpy(), want[name].numpy()) <= 0.15, name
    emg = [n for n in got if n.startswith("emg_net.")]
    assert rel_l2(np.concatenate([got[n].numpy().ravel() for n in emg]),
                  np.concatenate([want[n].numpy().ravel() for n in emg])
                  ) <= 0.05
    stats = from_flax_variables(
        jax.tree_util.tree_map(np.asarray, jstate.params),
        jax.tree_util.tree_map(np.asarray, new_bs))
    for name, value in state.model.state_dict().items():
        if "running" in name:
            assert value.dtype == torch.float32
            np.testing.assert_allclose(value.numpy(), stats[name].numpy(),
                                       atol=1e-4, err_msg=name)


def test_train_step_refuses_a_model_of_another_dtype(data):
    """A step runs in the dtype of the model it is given, so a Trainer
    refuses a state whose model is not in its ``compute_dtype``: an f32
    model given to a bf16 Trainer, and a bf16 one given to an f32 Trainer,
    raise before any gradient is taken; the matching pair steps."""
    bf16, _ = bf16_trainers(data)
    f32 = Trainer(CFG, bf16.store, adabn=False, batch_size=8, **SMALL)
    v = bf16.view_train
    emg_b = v.emg_flat[:8 * v.n_tasks].reshape(8, v.n_tasks, -1)
    hyper = Hyper.single(1e-3, 0.0, 0.0, 1e-3, 0.0, 0.0)
    for trainer, other in ((bf16, f32), (f32, bf16)):
        state = other.init_state(other.generator(0))
        with pytest.raises(ValueError, match="compute_dtype"):
            trainer.loss_and_grads(state, emg_b, hyper, None)
        loss, _, _ = trainer.loss_and_grads(
            trainer.init_state(trainer.generator(0)), emg_b, hyper, None)
        assert bool(torch.isfinite(loss))


@pytest.mark.parametrize("stacked", [False, True], ids=["single", "stacked"])
def test_adam_bf16_mu_matches_optax(stacked):
    """``adam_mu_dtype="bfloat16"``: three steps against
    ``optax.scale_by_adam(mu_dtype=jnp.bfloat16)`` run op by op, fed the
    same gradients: the stored mu bf16 and bit for bit, nu f32 at rtol
    1e-6 and the parameters at rtol 5e-6, atol 1e-8 (measured 2.8e-6, and
    5.6e-9 near 0: optax takes its bias corrections as jnp powers, a few
    f32 ulps from numpy's), the
    update taken from the unrounded f32 mu. The stacked chains (a (C, N) flat buffer) give the
    same per config."""
    rng = np.random.default_rng(5)
    shapes = [(64, 12), (64,), (16, 64)]
    C = 2 if stacked else None
    lead = (C,) if stacked else ()
    params = [rng.standard_normal(lead + s).astype(np.float32)
              for s in shapes]
    steps = [[(rng.standard_normal(lead + s) * 10.0 ** -k).astype(np.float32)
              for s in shapes] for k in (1, 3, 2)]
    lr = np.float32(1e-3) * np.float32(0.75)
    opt = optax.scale_by_adam(mu_dtype=jnp.bfloat16)
    jp = [jnp.asarray(p) for p in params]
    tp = [t(p) for p in params]
    if stacked:
        state = stacked_adam_init(tp, torch.bfloat16)
        lr_t = torch.full((C,), float(lr))
    else:
        state = adam_init(tp, torch.bfloat16)
        lr_t = float(lr)
    with jax.disable_jit():
        jstate = opt.init(jp)
        for grads in steps:
            updates, jstate = opt.update([jnp.asarray(x) for x in grads],
                                         jstate, jp)
            jp = [p - lr * u for p, u in zip(jp, updates)]
            adam_step_(tp, [t(x) for x in grads], state, lr_t)
    assert state.count == int(jstate.count) == 3
    for a, b in zip(state.mu, jstate.mu):
        assert a.dtype == BF16 and b.dtype == jnp.bfloat16
        np.testing.assert_array_equal(a.float().numpy(), as_f32(b))
    for ours, theirs, rtol in ((tp, jp, 5e-6), (state.nu, jstate.nu, 1e-6)):
        for a, b in zip(ours, theirs):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol,
                                       atol=1e-8)


def test_adam_bf16_mu_rides_the_trainer_and_its_checkpoint(data, tmp_path):
    """``Trainer(adam_mu_dtype="bfloat16")`` starts its chains with a bf16
    mu (the stacked sweep's too), steps, and the checkpoint's Adam file
    brings the bf16 mu back."""
    from contrastiveprosthetics_torch.train.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )

    port, _ = bf16_trainers(data, adam_mu_dtype="bfloat16")
    state = port.init_state(port.generator(0))
    sweep = port.init_sweep_state([port.generator(1), port.generator(2)])
    for s in (state, sweep):
        assert all(m.dtype == BF16 for m in s.opt_emg.mu + s.opt_glove.mu)
        assert all(n.dtype == torch.float32 for n in s.opt_emg.nu)
    v = port.view_train
    emg_b = v.emg_flat[:8 * v.n_tasks].reshape(8, v.n_tasks, -1)
    port._sgd_step(state, emg_b, Hyper.single(1e-3, 0, 0, 1e-3, 0, 0),
                   1e-3, 1e-3, None)
    assert any(bool(m.abs().sum()) for m in state.opt_emg.mu)
    path = str(tmp_path / "contrastive.pt")
    save_checkpoint(path, state)
    again = load_checkpoint(path, "cpu", dtype=BF16)
    assert again.model.dtype == BF16
    for a, b in zip(again.opt_emg.mu, state.opt_emg.mu):
        assert a.dtype == BF16 and torch.equal(a, b)
    with pytest.raises(ValueError, match="adam_mu_dtype"):
        bf16_trainers(data, adam_mu_dtype="float16")


# ----------------------------------------------------------- the sweep
def test_bf16_stacked_layers_round_once():
    """The stacked dense and conv layers in bf16 against one config's
    ``low_precision``: the product (the conv's three taps) summed in f32
    from rounded operands, rounded once, then the bias added in bf16.
    Within one bf16 ulp (f32 sums in other orders) and almost all equal;
    rounding each tap, or adding the bias inside the f32 sum, moves far
    more elements."""
    rng = np.random.default_rng(0)
    models = []
    for s in (1, 2):
        v = jax_variables(seed=s)[1]
        models.append(model_from_state_dict(
            from_flax_variables(v["params"], v["batch_stats"]), dtype=BF16))
    stacked = StackedContrastiveModel.from_models(models)
    assert stacked.dtype == stacked.emg_net.dtype == BF16
    x = t(rng.standard_normal((2, 60, 12, 64)).astype(np.float32)).to(BF16)
    conv = stacked.emg_net.conv_emg[3]
    with torch.no_grad():
        out = conv(x)
        assert out.dtype == BF16
        for c, m in enumerate(models):
            single = low_precision(m.emg_net.conv_emg[3],
                                   x[c].permute(0, 2, 1).unsqueeze(2), BF16)
            want = single.squeeze(2).permute(0, 2, 1).float()
            got = out[c].float()
            ulp = torch.exp2(torch.floor(torch.log2(
                torch.maximum(got.abs(), want.abs()).clamp_min(1e-30))) - 7)
            assert bool(((got - want).abs() <= ulp).all())
            assert float((got != want).float().mean()) < 0.01
            # rounding tap by tap, as baddbmm in bf16 would
            taps = conv.weight[c, :, :, 1].to(BF16).float()
            line = torch.nn.functional.pad(x[c].float(), (0, 0, 1, 1))
            acc = conv.bias[c].to(BF16)
            for k in range(3):
                acc = (acc.float() + line[:, k:k + 12] @ taps[..., k].T
                       ).to(BF16)
            assert float((acc.float() != want).float().mean()) > 0.05
        lin = stacked.emg_net.linear[4]
        h = t(rng.standard_normal((2, 50, 64)).astype(np.float32))
        y = lin(h)
        for c, m in enumerate(models):
            want = low_precision(m.emg_net.linear[4], h[c], BF16)
            assert torch.equal(y[c], want)


def test_bf16_stacked_step_matches_single_steps(data):
    """A stacked bf16 step of 2 configs (dropout 0) against each config's
    single bf16 step: losses at rtol 1e-4 (measured 2e-7), gradients per
    tensor in the relative 2-norm at 0.05 (measured at most 8e-3: bf16
    flips where the batched and single f32 sums, in other orders, straddle
    a tie), the running statistics at atol 1e-4."""
    port, _ = bf16_trainers(data)
    gens = [port.generator(s) for s in (4, 5)]
    sweep = port.init_sweep_state(gens)
    singles = [TrainState.fresh(sweep.model.unstack(c)) for c in range(2)]
    assert all(s.model.dtype == BF16 for s in singles)
    v = port.view_train
    emg_b = torch.stack([v.emg_flat[i * 8 * v.n_tasks:(i + 1) * 8 * v.n_tasks]
                         .reshape(8, v.n_tasks, -1) for i in range(2)])
    hyper = [(1e-3, 1e-2, 0.0, 1e-3, 3e-2, 0.0),
             (2e-3, 1e-3, 0.0, 5e-4, 1e-2, 0.0)]
    hs = Hyper(*[torch.tensor([h[i] for h in hyper]) for i in range(6)])
    loss, _, grads = port.loss_and_grads(sweep, emg_b, hs, None)
    for c, s in enumerate(singles):
        loss_c, _, grads_c = port.loss_and_grads(s, emg_b[c],
                                                 Hyper.single(*hyper[c]),
                                                 None)
        np.testing.assert_allclose(float(loss[c]), float(loss_c), rtol=1e-4)
        for tower in ("emg_net", "glove_net"):
            for a, b in zip(grads[tower], grads_c[tower]):
                assert rel_l2(a[c].numpy(), b.numpy()) <= 0.05
        sd = sweep.model.unstack(c).state_dict()
        for name, value in s.model.state_dict().items():
            if "running" in name:
                np.testing.assert_allclose(sd[name].numpy(), value.numpy(),
                                           atol=1e-4, err_msg=name)


def test_bf16_sweep_chunk_runs_and_keeps_f32_state(data):
    """``cross_validate`` of 3 configs x 1 epoch on a bf16 trainer: finite
    (val loss, val accuracy) per config, the f32 parameters untouched by
    the compute dtype."""
    port, _ = bf16_trainers(data, batch_size=100)
    hypers = port_crossval.sample_hyperparams(3, seed=0)
    values = port_crossval.cross_validate(port, hypers, epochs=1, seed=0)
    assert values.shape == (3, 2) and np.isfinite(values).all()


# ------------------------------------------------------------ evaluation
@pytest.mark.parametrize("fused", [False, True],
                         ids=["plain", "fused_encoder"])
def test_bf16_evaluate_matches_jax(data, fused):
    """The voted test pass of a bf16 model (D=16 in batches of 5, the last
    padded) from the JAX evaluation's index matrices, against the JAX bf16
    trainer's ``evaluate``, unfused and with the fused encoder (bf16 folds:
    ``encoder_chain``'s bf16 variant's plain version here, JAX's Pallas
    kernel in interpret mode). Logits at atol 2e-2 (bf16 flips in f32 sums
    of other orders, and XLA's skipped roundings; measured 3.9e-3 plain,
    7.8e-3 fused), the loss at rtol 1e-3; the votes equal on items whose
    JAX logits hold no near-tie (a gap under 2e-2)."""
    port, jtr = bf16_trainers(data, use_fused_encoder=fused)
    jstate = jtr.init_state(jax.random.PRNGKey(30))
    state = bf16_state(jstate)
    jh = jax_engine.Hyper.single(1e-3, 1e-6, 0.0, 1e-3, 1e-6, 0.0)
    key = jax.random.PRNGKey(31)
    want = jtr.evaluate(jstate, key, jh, split="test", batch_size=5)
    v = jtr.view_test
    k_perm, _, k_order = jax.random.split(key, 3)
    emg_rand = jax_sampler.task_permutations(k_perm, v.n_tasks, v.D)
    batches, weights, inverse = jax_sampler.epoch_batches_padded(k_order,
                                                                 v.D, 5)
    K.reset_launch_counts()
    got = port.evaluate_from_indices(
        state, port.view_test, t(emg_rand, torch.long),
        t(batches, torch.long), t(weights), t(inverse, torch.long))
    assert not any(K.launch_counts.values())  # the CPU runs plain versions
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits),
                               rtol=0, atol=2e-2)
    np.testing.assert_allclose(float(got.loss), float(want.loss), rtol=1e-3)
    top2 = np.sort(np.asarray(want.logits), axis=-1)[..., -2:]
    tied = (top2[..., 1] - top2[..., 0] < 2e-2).reshape(v.D, -1).any(-1)
    np.testing.assert_array_equal(got.y_pred.numpy()[~tied],
                                  np.asarray(want.y_pred)[~tied])
    np.testing.assert_array_equal(got.curve.numpy()[~tied],
                                  np.asarray(want.curve)[~tied])


def test_bf16_per_subject_evaluation_runs_the_bf16_tower(data):
    """``evaluate_per_subject`` of a bf16 state: the tower computes in
    bf16 (its logits differ from the f32 tower's on the same weights by
    bf16 roundings, not by zero), finite, one row per item."""
    port, jtr = bf16_trainers(data)
    jstate = jtr.init_state(jax.random.PRNGKey(30))
    state = bf16_state(jstate)
    res = port.evaluate_per_subject(state)
    f32 = TrainState.fresh(model_from_state_dict(state.model.state_dict()))
    ref = port.evaluate_per_subject(f32)
    diff = (res.logits - ref.logits).abs().max()
    assert bool(torch.isfinite(res.logits).all()) and 0 < diff < 5e-2
    assert res.curve.shape == ref.curve.shape


# ------------------------------------------------------------------ CLIs
@pytest.fixture()
def small_cli(monkeypatch, tmp_path):
    """The CLIs on a one-person store at small width, with a cached
    crossval whose best row is the canonical config at dropout 0."""
    def one_person(args, cfg, device):
        emg, pos, glove = make_processed_dataset(cfg, people_positions=[40])
        return DeviceStore(cfg, emg, pos, glove, device=device)

    monkeypatch.setattr(cli_train, "build_store", one_person)
    monkeypatch.setattr(cli_results, "build_store", one_person)
    monkeypatch.setattr(port_engine, "Trainer",
                        functools.partial(Trainer, **SMALL))
    keys = port_crossval.keys_array(port_crossval.sample_hyperparams(2), 16)
    keys[1, 1:] = (1e-3, 1e-6, 0.0, 1e-3, 1e-6, 0.0)
    np.save(tmp_path / "cross_val_keys.npy", keys)
    np.save(tmp_path / "cross_val_values.npy", np.array([[3.0, 0.1],
                                                        [2.0, 0.9]]))
    return ["--synthetic", "--crossval_load", "--batch_size", "4",
            "--no_adabn", "--platform", "cpu", "--data_dir", str(tmp_path),
            "--checkpoint_dir", str(tmp_path)]


def test_cli_train_bf16_and_results_on_cpu(small_cli, tmp_path, capsys,
                                           monkeypatch):
    """``cptorch-train --bf16 --test --results_dir A`` trains and tests the
    bf16 tower (its Trainer built with ``compute_dtype="bfloat16"``) and
    writes the f32 reference checkpoint; ``cptorch-results --bf16``
    evaluates that checkpoint in f32, as ``cptpu-results`` does, and gives
    the numbers it gives without the flag, bit for bit."""
    built = []
    monkeypatch.setattr(port_engine, "Trainer", lambda *a, **kw: built.append(
        kw) or Trainer(*a, **SMALL, **kw))
    a, b, c = (str(tmp_path / name) for name in "ABC")
    assert cli_train.main([*small_cli, "--bf16", "--final_epochs", "1",
                           "--test", "--results_dir", a]) == 0
    assert built[-1]["compute_dtype"] == "bfloat16"
    out = capsys.readouterr().out
    assert "Epoch 0." in out and f"artifacts exported to {a}" in out
    sd = load_reference_checkpoint(str(tmp_path / "contrastive.pt"))
    assert all(v.dtype in (torch.float32, torch.int64) for v in sd.values())
    assert cli_results.main([*small_cli, "--bf16", "--results_dir", b]) == 0
    assert "compute_dtype" not in built[-1]
    bf16_out = capsys.readouterr().out
    assert cli_results.main([*small_cli, "--results_dir", c]) == 0
    f32_out = capsys.readouterr().out
    line = [ln for ln in bf16_out.splitlines() if ln.startswith("(")]
    assert line and line == [ln for ln in f32_out.splitlines()
                             if ln.startswith("(")]
    for stem in ("logs", "y_pred", "voting", "confusion_matrix"):
        np.testing.assert_array_equal(np.load(f"{b}/{stem}.npy"),
                                      np.load(f"{c}/{stem}.npy"))
