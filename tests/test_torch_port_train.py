"""PyTorch port: the training slice against the JAX package (the K1 loss's
plain version, the trainable model, the train step, Adam, an epoch, the
voted evaluation, the loop, checkpoints and ``cptorch-train``).

Inputs come from numpy seeds or from the JAX package (initial weights,
index matrices) and are handed to both sides. Small width is
``n_linear=2, hidden=64``; dropout is 0 wherever the two frameworks'
random streams would differ.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from contrastiveprosthetics_torch.cli import train as cli_train
from contrastiveprosthetics_torch.config import DEFAULT_CONFIG as CFG
from contrastiveprosthetics_torch.data.store import DeviceStore
from contrastiveprosthetics_torch.data.synthetic import make_processed_dataset
from contrastiveprosthetics_torch.eval import voting as port_voting
from contrastiveprosthetics_torch.models.clip import l2_penalty
from contrastiveprosthetics_torch.models.convert import (
    from_flax_variables,
    load_reference_checkpoint,
    model_from_state_dict,
)
from contrastiveprosthetics_torch.models.layers import RateDropout
from contrastiveprosthetics_torch.ops import kernels as K
from contrastiveprosthetics_torch.train import crossval as port_crossval
from contrastiveprosthetics_torch.train import engine as port_engine
from contrastiveprosthetics_torch.train import loop as port_loop
from contrastiveprosthetics_torch.train import loss as port_loss
from contrastiveprosthetics_torch.train import schedules as port_schedules
from contrastiveprosthetics_torch.train.checkpoint import (
    adam_path,
    load_checkpoint,
    save_checkpoint,
)
from contrastiveprosthetics_torch.train.engine import (
    EvalResult,
    Hyper,
    Trainer,
    TrainState,
    adam_init,
    adam_step_,
)
from contrastiveprosthetics_tpu.config import DEFAULT_CONFIG as JCFG
from contrastiveprosthetics_tpu.data import sampler as jax_sampler
from contrastiveprosthetics_tpu.data.store import DeviceStore as JaxStore
from contrastiveprosthetics_tpu.eval import voting as jax_voting
from contrastiveprosthetics_tpu.models.clip import ContrastiveModel
from contrastiveprosthetics_tpu.models.clip import l2_penalty as jax_l2_penalty
from contrastiveprosthetics_tpu.ops import pallas_ops
from contrastiveprosthetics_tpu.train import crossval as jax_crossval
from contrastiveprosthetics_tpu.train import engine as jax_engine
from contrastiveprosthetics_tpu.train import loss as jax_loss
from contrastiveprosthetics_tpu.train import schedules as jax_schedules
from test_torch_port_models import jax_variables, port_model

torch.set_num_threads(1)

SMALL = dict(n_linear=2, hidden=64)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)  # the JAX package's VJP test
# Train-mode and AdaBN logits: each package lies about 1e-6 (absolute)
# from a float64 evaluation of the same model (batch statistics of a few
# hundred to two thousand rows, then the unit-norm cosine), so their
# difference reaches about 1.6e-6 near zero.
LOGIT_TOL = dict(rtol=1e-5, atol=2e-6)


def t(x, dtype=None) -> torch.Tensor:
    """A JAX or numpy array as a torch tensor (a copy)."""
    out = torch.from_numpy(np.array(x))
    return out if dtype is None else out.to(dtype)


@pytest.fixture(scope="module")
def data():
    return make_processed_dataset(CFG, people_positions=[40, 41], seed=3)


def trainers(data, adabn=False, batch_size=8):
    emg, pos, glove = data
    port = Trainer(CFG, DeviceStore(CFG, emg, pos, glove), adabn=adabn,
                   batch_size=batch_size, **SMALL)
    jtr = jax_engine.Trainer(JCFG, JaxStore(JCFG, emg, pos, glove),
                             adabn=adabn, batch_size=batch_size, **SMALL)
    return port, jtr


def port_state(jstate, adabn) -> TrainState:
    """The port's TrainState holding a JAX state's weights and statistics
    (fresh Adam chains)."""
    tree = jax.tree_util.tree_map(np.asarray, (jstate.params,
                                               jstate.batch_stats))
    sd = from_flax_variables(*tree, adabn=adabn)
    return TrainState.fresh(model_from_state_dict(sd))


def named_grads(state, grads) -> dict:
    out = {}
    for (name, tower), tower_grads in zip(state.model.towers().items(),
                                          (grads["emg_net"],
                                           grads["glove_net"])):
        prefix = "emg_net." if name == "emg_net" else "glove_net.easy."
        for (pname, _), gr in zip(tower.named_parameters(), tower_grads):
            out[prefix + pname] = gr
    return out


def normalized(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


# ------------------------------------------------------------ K1 and loss
def test_k1_plain_version_matches_jax_interpret_mode():
    """The plain K1 forward and backward against the Pallas kernels run in
    interpret mode, at N=12 (not a multiple of the TPU's 8-item block)."""
    rng = np.random.default_rng(1234)
    e, g = normalized(rng, (12, 41, 16)), normalized(rng, (12, 41, 16))
    je, jg = jnp.asarray(e), jnp.asarray(g)
    loss_j, correct_j = pallas_ops.fused_contrastive_loss(je, jg, True)
    de_j, dg_j = jax.grad(
        lambda a, b: pallas_ops.fused_contrastive_loss(a, b, True)[0] * 1.5,
        argnums=(0, 1))(je, jg)
    te, tg = t(e).requires_grad_(), t(g).requires_grad_()
    loss, correct = K.fused_contrastive_loss(te, tg)
    de, dg = torch.autograd.grad(loss * 1.5, (te, tg))
    np.testing.assert_allclose(float(loss.detach()), float(loss_j),
                               rtol=1e-5)
    assert float(correct) == float(correct_j)
    np.testing.assert_allclose(de.numpy(), np.asarray(de_j), **GRAD_TOL)
    np.testing.assert_allclose(dg.numpy(), np.asarray(dg_j), **GRAD_TOL)
    with torch.no_grad():
        de_w, dg_w = K.contrastive_loss_bwd_reference(t(e), t(g),
                                                      torch.tensor(1.5))
    np.testing.assert_allclose(de_w.numpy(), np.asarray(de_j), **GRAD_TOL)
    np.testing.assert_allclose(dg_w.numpy(), np.asarray(dg_j), **GRAD_TOL)


def test_k1_config_axis_matches_jax_vmap_interpret_mode():
    """The 4-d plain K1 (C=3 configs of N=8 items, the sweep's layout)
    against ``jax.vmap`` of the Pallas loss in interpret mode, as the JAX
    sweep runs it (``train/engine.py:591``); each config has its own
    upstream scalar, and rows 3 of config 1 tie at their maximum."""
    rng = np.random.default_rng(77)
    e, g = normalized(rng, (3, 8, 41, 16)), normalized(rng, (3, 8, 41, 16))
    g[1, :, 3] = e[1, :, 3] = g[1, :, 1]  # first maximum at column 1
    up = np.array([0.5, 1.5, 1.0], np.float32)
    je, jg = jnp.asarray(e), jnp.asarray(g)
    loss_j, correct_j = jax.vmap(
        lambda a, b: pallas_ops.fused_contrastive_loss(a, b, True))(je, jg)
    de_j, dg_j = jax.vmap(jax.grad(
        lambda a, b, s: pallas_ops.fused_contrastive_loss(a, b, True)[0] * s,
        argnums=(0, 1)))(je, jg, jnp.asarray(up))
    te, tg = t(e).requires_grad_(), t(g).requires_grad_()
    loss, correct = K.fused_contrastive_loss(te, tg)
    assert loss.shape == correct.shape == (3,)
    de, dg = torch.autograd.grad((loss * t(up)).sum(), (te, tg))
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(loss_j),
                               rtol=1e-5)
    np.testing.assert_array_equal(correct.numpy(), np.asarray(correct_j))
    with torch.no_grad():
        de_w, dg_w = K.contrastive_loss_bwd_reference(t(e), t(g), t(up))
    for got in (de, de_w):
        np.testing.assert_allclose(got.numpy(), np.asarray(de_j), **GRAD_TOL)
    for got in (dg, dg_w):
        np.testing.assert_allclose(got.numpy(), np.asarray(dg_j), **GRAD_TOL)


def test_losses_and_train_accuracy_match_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((5, 41, 41)).astype(np.float32)
    logits[0, 3, :5] = logits[0, 3, 3]  # a tie: the first max wins
    tl, jl = t(logits), jnp.asarray(logits)
    for ours, theirs in (
            (port_loss.symmetric_contrastive_loss,
             jax_loss.symmetric_contrastive_loss),
            (port_loss.symmetric_contrastive_loss_per_item,
             jax_loss.symmetric_contrastive_loss_per_item)):
        np.testing.assert_allclose(ours(tl).numpy(), np.asarray(theirs(jl)),
                                   rtol=1e-6)
    assert float(port_loss.contrastive_train_accuracy(tl)) == float(
        jax_loss.contrastive_train_accuracy(jl))
    loss, correct = K.fused_contrastive_reference(
        t(normalized(rng, (4, 41, 16))), t(normalized(rng, (4, 41, 16))))
    assert loss.shape == correct.shape == ()


@pytest.mark.parametrize("n_prefix", [24, 249])
def test_vote_from_logits_matches_jax(n_prefix):
    """Votes from integer-valued logits, so ties are everywhere: the cumsum
    vote must break them to the smallest class exactly as the JAX one."""
    rng = np.random.default_rng(3)
    W, B, T = 25, 6, 41
    logits = np.round(rng.standard_normal((B * W, T, T)) * 1.5).astype(
        np.float32)
    got = port_voting.vote_from_logits(t(logits), W, n_prefix)
    want = jax_voting.vote_from_logits(jnp.asarray(logits), W, n_prefix)
    for name in ("curve", "y_pred", "y_true"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    # a mean of the same curve, summed in another order
    np.testing.assert_allclose(float(got.accuracy), float(want.accuracy),
                               rtol=1e-6)
    np.testing.assert_array_equal(
        port_voting.confusion_matrix(got.y_true, got.y_pred, T).numpy(),
        np.asarray(jax_voting.confusion_matrix(want.y_true, want.y_pred, T)))


# ------------------------------------------------------------------ model
@pytest.mark.parametrize("adabn", [False, True])
def test_logits_and_running_stats_match_flax(adabn):
    """Vote-mode (eval) then train-mode logits at dropout 0, and the
    running statistics a plain-BN train forward leaves behind."""
    model, v = jax_variables(adabn=adabn)
    port = port_model(v, adabn=adabn)
    rng = np.random.default_rng(4)
    vote = rng.standard_normal((2, 41, 25, 12)).astype(np.float32)
    emg = rng.standard_normal((3, 41, 12)).astype(np.float32)
    key = {"dropout": jax.random.PRNGKey(0)}
    want, _ = model.apply(v, jnp.asarray(vote), jnp.zeros((2, 41, 20)), 0.0,
                          0.0, False, mutable=["batch_stats"])
    with torch.no_grad():
        got = port(t(vote))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    want, upd = model.apply(v, jnp.asarray(emg), jnp.zeros((3, 41, 20)), 0.0,
                            0.0, True, rngs=key, mutable=["batch_stats"])
    port.train()
    with torch.no_grad():
        got = port(t(emg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    (e_j, g_j), _ = model.apply(v, jnp.asarray(emg), jnp.zeros((3, 41, 20)),
                                0.0, 0.0, True, rngs=key,
                                mutable=["batch_stats"],
                                method=ContrastiveModel.embed)
    with torch.no_grad():
        e, g = port.embed(t(emg))
    np.testing.assert_allclose(e.numpy(), np.asarray(e_j), **LOGIT_TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j), **LOGIT_TOL)
    if adabn:
        return
    # ``port`` has moved its statistics twice (logits, embed): compare one
    # train forward of a fresh copy with flax's update
    stats = upd["batch_stats"]["emg_net"]
    fresh = port_model(v, adabn=False).train()
    with torch.no_grad():
        fresh(t(emg))
    for i, bn in enumerate(fresh.emg_net.norms()):
        ref = stats[f"BatchNorm_{i}"]["BatchNorm_0"]
        np.testing.assert_allclose(bn.running_mean.numpy(),
                                   np.asarray(ref["mean"]), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   np.asarray(ref["var"]), rtol=1e-5,
                                   atol=1e-6)


def test_l2_penalty_matches_jax_and_leaves_out_dead_parameters():
    _, v = jax_variables()
    port = port_model(v)
    with torch.no_grad():  # dead parameters: any value changes nothing
        port.glove_net.last[0].weight.fill_(3.0)
        port.logit_scale.fill_(2.0)
    towers = port.towers()
    for name in ("emg_net", "glove_net"):
        np.testing.assert_allclose(
            float(l2_penalty(towers[name]).detach()),
            float(jax_l2_penalty(v["params"][name])), rtol=1e-6)
    trained = {id(p) for tw in towers.values() for p in tw.parameters()}
    untrained = {n for n, p in port.named_parameters() if id(p) not in trained}
    assert untrained == {"glove_net.last.0.weight", "logit_scale"}


def test_rate_dropout_is_inverted_and_seeded():
    drop = RateDropout().train()
    x = torch.ones(400, 64)
    assert drop(x, 0.0, None) is x
    y = drop(x, 0.25, torch.Generator().manual_seed(0))
    assert set(torch.unique(y).tolist()) == {0.0, float(torch.tensor(4 / 3))}
    assert 0.7 < float((y > 0).float().mean()) < 0.8
    assert torch.equal(y, drop(x, 0.25, torch.Generator().manual_seed(0)))
    assert drop.eval()(x, 0.25, None) is x
    with pytest.raises(ValueError, match="explicit torch.Generator"):
        drop.train()(x, 0.25, None)


# ------------------------------------------------------------ train step
@pytest.mark.parametrize("adabn", [False, True])
def test_sgd_step_gradients_match_jax(data, adabn):
    """One step at dropout 0: the loss, every gradient (against
    ``jax.grad`` of the JAX step's loss, L2 included) and the running
    statistics the step leaves."""
    port, jtr = trainers(data, adabn=adabn)
    jstate = jtr.init_state(jax.random.PRNGKey(6))
    state = port_state(jstate, adabn)
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

    (_, (loss_j, (acc_j, new_bs, _))), jgrads = jax.value_and_grad(
        total, has_aux=True)(jstate.params)
    loss, acc, grads = port.loss_and_grads(state, t(emg_b), h, None)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    assert float(acc) == pytest.approx(float(acc_j), abs=1e-6)
    want = from_flax_variables(
        jax.tree_util.tree_map(np.asarray, jgrads),
        jax.tree_util.tree_map(np.asarray, jstate.batch_stats), adabn=adabn)
    got = named_grads(state, grads)
    assert set(got) == {n for n, _ in state.model.named_parameters()} - {
        "glove_net.last.0.weight", "logit_scale"}
    for name, gr in got.items():
        np.testing.assert_allclose(gr.numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-7, err_msg=name)
    if not adabn:
        stats = from_flax_variables(
            jax.tree_util.tree_map(np.asarray, jstate.params),
            jax.tree_util.tree_map(np.asarray, new_bs))
        for name, value in state.model.state_dict().items():
            if "running" in name:
                np.testing.assert_allclose(value.numpy(),
                                           stats[name].numpy(), rtol=1e-5,
                                           atol=1e-6, err_msg=name)


def test_adam_update_matches_optax():
    """Fed identical gradients, three Adam steps and ``p -= lr * u`` equal
    optax's ``scale_by_adam`` to f32 roundoff."""
    rng = np.random.default_rng(5)
    shapes = [(64, 12), (64,), (16, 64)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    steps = [[(rng.standard_normal(s) * 10.0 ** -k).astype(np.float32)
              for s in shapes] for k in (1, 3, 2)]
    lr = jnp.float32(1e-3) * jnp.float32(0.75)
    opt = optax.scale_by_adam()
    jp = [jnp.asarray(p) for p in params]
    jstate = opt.init(jp)
    tp = [t(p) for p in params]
    state = adam_init(tp)
    for grads in steps:
        updates, jstate = opt.update([jnp.asarray(x) for x in grads], jstate,
                                     jp)
        jp = [p - lr * u for p, u in zip(jp, updates)]
        adam_step_(tp, [t(x) for x in grads], state,
                   float(np.float32(1e-3) * np.float32(0.75)))
    assert state.count == int(jstate.count) == 3
    for ours, theirs in ((tp, jp), (state.mu, jstate.mu),
                         (state.nu, jstate.nu)):
        for a, b in zip(ours, theirs):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-12)


def test_one_epoch_matches_jax_step_by_step(data):
    """An epoch at bs 32 over D=600 (18 full batches and a tail of 24)
    from the JAX epoch's own index matrices (``engine.py:440-443``): the
    per-step losses follow the JAX steps'."""
    port, jtr = trainers(data, batch_size=32)
    jstate = jtr.init_state(jax.random.PRNGKey(10))
    state = port_state(jstate, adabn=False)
    hyper = (1e-3, 1e-6, 0.0, 1e-3, 1e-6, 0.0)
    jh, h = jax_engine.Hyper.single(*hyper), Hyper.single(*hyper)
    v = jtr.view_train
    k_perm, k_glove, k_order, k_drop = jax.random.split(
        jax.random.PRNGKey(11), 4)
    emg_rand = jax_sampler.task_permutations(k_perm, v.n_tasks, v.D)
    glove_rand = jax_sampler.task_permutations(k_glove, v.n_tasks, v.D_glove)
    batches, tail = jax_sampler.epoch_batches(k_order, v.D, 32)
    assert batches.shape == (18, 32) and tail.shape == (24,)
    step = jax.jit(jtr._sgd_step)
    want = []
    for i, items in enumerate([*batches, tail]):
        emg_b = jax_sampler.gather_train_batch(v.emg_flat, emg_rand, items)
        glove_b = jax_sampler.gather_glove_batch(v.glove_flat, glove_rand,
                                                 items, v.D_glove)
        jstate, loss, _ = step(jstate, emg_b, glove_b, jh, jh.lr_emg,
                               jh.lr_glove, jax.random.fold_in(k_drop, i))
        want.append(float(loss))
    losses, accs = port.train_epoch_from_indices(
        state, t(emg_rand, torch.long), t(batches, torch.long),
        t(tail, torch.long), h, 1.0, 1.0, None)
    assert losses.shape == accs.shape == (19,)
    np.testing.assert_allclose(losses.numpy(), want, rtol=1e-3)
    assert state.opt_emg.count == state.opt_glove.count == 19


@pytest.mark.parametrize("adabn", [False, True])
def test_evaluate_matches_jax(data, adabn):
    """The test split (D=16) in batches of 5, so the last batch is padded,
    from the JAX key's matrices (``engine.py:637-640``). ``curve`` and
    ``y_pred`` agree except on items whose JAX logits hold a near-tie."""
    port, jtr = trainers(data, adabn=adabn)
    jstate = jtr.init_state(jax.random.PRNGKey(30))
    state = port_state(jstate, adabn)
    jh = jax_engine.Hyper.single(1e-3, 1e-6, 0.0, 1e-3, 1e-6, 0.0)
    key = jax.random.PRNGKey(31)
    want = jtr.evaluate(jstate, key, jh, split="test", batch_size=5)
    v = jtr.view_test
    k_perm, _, k_order = jax.random.split(key, 3)
    emg_rand = jax_sampler.task_permutations(k_perm, v.n_tasks, v.D)
    batches, weights, inverse = jax_sampler.epoch_batches_padded(k_order,
                                                                 v.D, 5)
    got = port.evaluate_from_indices(
        state, port.view_test, t(emg_rand, torch.long),
        t(batches, torch.long), t(weights), t(inverse, torch.long))
    assert isinstance(got, EvalResult)
    np.testing.assert_allclose(float(got.loss), float(want.loss), rtol=1e-5)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits),
                               rtol=1e-4, atol=1e-5)
    top2 = np.sort(np.asarray(want.logits), axis=-1)[..., -2:]
    tied = (top2[..., 1] - top2[..., 0] < 1e-5).reshape(v.D, -1).any(-1)
    print(f"items with a near-tie in the JAX logits: {int(tied.sum())}")
    np.testing.assert_array_equal(got.curve.numpy()[~tied],
                                  np.asarray(want.curve)[~tied])
    np.testing.assert_array_equal(got.y_pred.numpy()[~tied],
                                  np.asarray(want.y_pred)[~tied])
    np.testing.assert_array_equal(got.y_true.numpy(), np.asarray(want.y_true))


def test_evaluate_items_do_not_depend_on_batch_size(data):
    port, _ = trainers(data)
    state = port.init_state(port.generator(3))
    a = port.evaluate(state, port.generator(4), None, "test", batch_size=4)
    b = port.evaluate(state, port.generator(4), None, "test", batch_size=7)
    torch.testing.assert_close(a.logits, b.logits, rtol=0, atol=1e-5)
    assert torch.equal(a.y_pred, b.y_pred)
    torch.testing.assert_close(a.loss, b.loss, rtol=1e-6, atol=0)


# ----------------------------------------------------------- loop and CLI
@pytest.mark.parametrize("compat", [False, True])
def test_checkpoint_rule(data, monkeypatch, tmp_path, compat):
    """Default: save on val-loss improvement (<= min); compat: the
    reference's <= max rule (train.py:122-126)."""
    emg, pos, glove = data
    cfg = dataclasses.replace(CFG, compat_checkpoint_on_max=compat)
    trainer = Trainer(cfg, DeviceStore(cfg, emg, pos, glove), adabn=False,
                      batch_size=300, **SMALL)
    scripted = iter([1.0, 2.0, 0.5])
    zero = torch.zeros(())
    monkeypatch.setattr(trainer, "evaluate", lambda *a, **k: EvalResult(
        torch.tensor(next(scripted)), zero, zero, zero, zero, zero))
    saves = []
    monkeypatch.setattr(port_loop, "save_checkpoint",
                        lambda path, state: saves.append(path))
    port_loop.train_loop(trainer, Hyper.single(1e-3, 0, 0, 1e-3, 0, 0), 3,
                         seed=0, checkpoint=True,
                         checkpoint_path=str(tmp_path / "c.pt"),
                         verbose=False)
    assert len(saves) == (3 if compat else 2)


def test_train_loop_weights_do_not_depend_on_verbose(data, capsys):
    port, _ = trainers(data, batch_size=100)
    h = Hyper.single(1e-3, 1e-6, 0.5, 1e-3, 1e-6, 0.3)
    quiet = port_loop.train_loop(port, h, 2, seed=5, annealing=True,
                                 verbose=False)
    loud = port_loop.train_loop(port, h, 2, seed=5, annealing=True,
                                verbose=True)
    assert "Epoch 1." in capsys.readouterr().out
    assert quiet.train_losses == loud.train_losses
    # the last validation draws another item order: the same items, summed
    # in another order
    assert quiet.val_loss == pytest.approx(loud.val_loss, rel=1e-6)
    for a, b in zip(quiet.state.model.state_dict().values(),
                    loud.state.model.state_dict().values()):
        assert torch.equal(a, b)


def test_train_epochs_is_a_loop_of_train_epoch(data):
    port, _ = trainers(data, batch_size=300)
    h = Hyper.single(1e-3, 1e-6, 0.5, 1e-3, 1e-6, 0.3)
    factors = [1.0, 0.5]
    a = port.init_state(port.generator(0))
    a, losses, accs = port.train_epochs(a, port.generator(1), h, factors,
                                        factors)
    b = port.init_state(port.generator(0))
    gen = port.generator(1)
    want = [float(port.train_epoch(b, gen, h, f, f)[1]) for f in factors]
    assert losses.tolist() == want and accs.shape == (2,)
    for x, y in zip(a.model.state_dict().values(),
                    b.model.state_dict().values()):
        assert torch.equal(x, y)


def test_checkpoint_roundtrip_resumes_adam(data, tmp_path):
    port, _ = trainers(data, batch_size=300)
    state = port.init_state(port.generator(0))
    h = Hyper.single(1e-3, 1e-6, 0.0, 1e-3, 1e-6, 0.0)
    port.train_epoch(state, port.generator(1), h)
    path = str(tmp_path / "ckpt" / "contrastive.pt")
    save_checkpoint(path, state)
    back = load_checkpoint(path, "cpu")
    for (k, a), b in zip(state.model.state_dict().items(),
                         back.model.state_dict().values()):
        assert torch.equal(a, b), k
    for ours, theirs in ((state.opt_emg, back.opt_emg),
                         (state.opt_glove, back.opt_glove)):
        assert ours.count == theirs.count == 2
        for a, b in zip(ours.mu + ours.nu, theirs.mu + theirs.nu):
            assert torch.equal(a, b)
    assert adam_path(path).endswith("contrastive.adam.pt")
    model_from_state_dict(load_reference_checkpoint(path))  # strict


@pytest.mark.parametrize("epochs,annealing,compat", [
    (8, True, False), (12, False, False), (12, False, True), (1, True, True)])
def test_schedules_match_jax(epochs, annealing, compat):
    for a, b in zip(port_schedules.schedule_factors(epochs, annealing, compat),
                    jax_schedules.schedule_factors(epochs, annealing, compat)):
        np.testing.assert_array_equal(a, b)


def test_crossval_helpers_match_jax(tmp_path):
    ours = port_crossval.sample_hyperparams(7)
    theirs = jax_crossval.sample_hyperparams(7)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, np.asarray(b))
    keys = port_crossval.keys_array(ours, 16)
    np.testing.assert_array_equal(keys, jax_crossval.keys_array(theirs, 16))
    for row in keys:
        d_e, h = port_crossval.hyper_from_key(row)
        j_d_e, jh = jax_crossval.hyper_from_key(row)
        assert d_e == j_d_e and h == tuple(float(x) for x in jh)
    values = np.random.default_rng(0).random((7, 2))
    values[2, 1] = np.nan
    np.save(tmp_path / "cross_val_values_x.npy", values)
    np.save(tmp_path / "cross_val_keys_x.npy", keys)
    got = port_crossval.load_crossval(str(tmp_path), "_x")
    for a, b in zip(got, jax_crossval.load_crossval(str(tmp_path), "_x")):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port_crossval.best_config(*got),
                                  jax_crossval.best_config(*got))


@pytest.mark.parametrize("crossval", ["canonical", "cached"])
def test_cli_train_on_cpu_writes_a_reference_checkpoint(tmp_path, monkeypatch,
                                                        capsys, crossval):
    """``cptorch-train --platform cpu`` at full width on a one-person
    synthetic store, with the canonical hyperparameters or a cached sweep,
    writes a ``contrastive.pt`` that loads strictly."""
    def one_person(args, cfg, device):
        emg, pos, glove = make_processed_dataset(cfg, people_positions=[40])
        return DeviceStore(cfg, emg, pos, glove, device=device)

    monkeypatch.setattr(cli_train, "build_store", one_person)
    if crossval == "cached":
        keys = port_crossval.keys_array(port_crossval.sample_hyperparams(3),
                                        16)
        keys[1, 1:] = (2e-3, 1e-6, 0.5, 2e-3, 1e-6, 0.3)
        np.save(tmp_path / "cross_val_keys.npy", keys)
        np.save(tmp_path / "cross_val_values.npy",
                np.array([[3.0, 0.1], [2.0, 0.9], [2.5, np.nan]]))
        hyper_args = ["--crossval_load", "--crossval_size", "150"]
    else:
        hyper_args = ["--crossval_size", "0"]
    rc = cli_train.main([
        "--synthetic", *hyper_args, "--final_epochs", "1",
        "--batch_size", "150", "--test", "--no_adabn", "--platform", "cpu",
        "--data_dir", str(tmp_path), "--checkpoint_dir", str(tmp_path)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Epoch 0." in out and "loss,\t\t\tcorrect" in out
    best = "2.0e-03" if crossval == "cached" else "1.0e-03"
    assert f"Best combination: [1.6e+01 {best}" in out
    model = model_from_state_dict(
        load_reference_checkpoint(str(tmp_path / "contrastive.pt")))
    assert not model.adabn
    assert len([m for m in model.emg_net.linear
                if isinstance(m, torch.nn.Linear)]) == 7


def two_cuda_devices(monkeypatch) -> None:
    """A machine with two visible CUDA devices, as far as the CLIs' checks
    before any CUDA call can tell."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)


def refuse_stores(args, cfg, device):
    raise AssertionError("a store was built")


@pytest.mark.parametrize("argv", [
    ["--crossval_size", "3", "--fused_train", "on"],
    ["--crossval_size", "3", "--spmd_crossval"],
    ["--glove_encoding", "--crossval_size", "3", "--fused_train", "on"],
    ["--bf16", "--crossval_size", "3", "--fused_train", "on"]])
def test_cli_unported_requests_name_the_roadmap(tmp_path, monkeypatch, argv):
    """Each exits NOT_PORTED before a store is built; ``--spmd_crossval``
    only where the JAX CLI would shard, more than one device visible (on
    one device or the CPU it runs unsharded:
    ``test_cli_spmd_crossval_runs_unsharded_on_one_device``)."""
    platform = "cpu"
    if "--spmd_crossval" in argv:
        two_cuda_devices(monkeypatch)
        platform = "cuda"
    monkeypatch.setattr(cli_train, "build_store", refuse_stores)
    with pytest.raises(SystemExit, match="ROADMAP.md, queue 1 item"):
        cli_train.main([*argv, "--platform", platform, "--data_dir",
                        str(tmp_path)])


@pytest.fixture()
def small_train_cli(monkeypatch, tmp_path):
    """``cptorch-train`` on a one-person store at small width."""
    def one_person(args, cfg, device):
        emg, pos, glove = make_processed_dataset(cfg, people_positions=[40])
        return DeviceStore(cfg, emg, pos, glove, device=device)

    monkeypatch.setattr(cli_train, "build_store", one_person)
    monkeypatch.setattr(port_engine, "Trainer",
                        functools.partial(Trainer, **SMALL))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return ["--synthetic", "--final_epochs", "1", "--batch_size", "8",
            "--no_adabn", "--platform", "cpu", "--data_dir", str(tmp_path),
            "--checkpoint_dir", str(tmp_path)]


def test_cli_profile_writes_a_chrome_trace(tmp_path, small_train_cli,
                                           capsys):
    """``--profile`` traces the whole run (CPU activities on the CPU) and
    writes a Chrome trace under ``$TMPDIR/cptorch_trace`` that parses as
    JSON and holds the run's operators, the store's set-up among them."""
    assert cli_train.main([*small_train_cli, "--crossval_size", "0",
                           "--test", "--profile"]) == 0
    out = capsys.readouterr().out
    where = str(tmp_path / "cptorch_trace")
    assert f"profile trace written to {where}" in out
    traces = list((tmp_path / "cptorch_trace").glob("*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::addmm" in names and len(events) > 1000
    assert out.index("Loading dataset") < out.index("profile trace written")


def test_cli_spmd_crossval_runs_unsharded_on_one_device(small_train_cli,
                                                        capsys):
    """With one device (here the CPU) ``--spmd_crossval`` runs the sweep
    unsharded and says so, as the JAX CLI shards only over more than one
    device (its ``cli/train.py:195``)."""
    assert cli_train.main([*small_train_cli, "--crossval_size", "2",
                           "--spmd_crossval"]) == 0
    out = capsys.readouterr().out
    assert ("--spmd_crossval: 1 cpu device visible, the sweep's configs "
            "unsharded") in out
    assert "crossval: 2 configs in" in out


def test_cli_load_model_names_cptorch_import_for_a_jax_checkpoint(tmp_path):
    """A ``--checkpoint_dir`` with only ``contrastive.msgpack`` (a
    ``cptpu-train`` checkpoint): ``--load_model`` exits naming
    ``cptorch-import``, before a store is built."""
    (tmp_path / "contrastive.msgpack").write_bytes(b"\x80")
    with pytest.raises(SystemExit, match="cptorch-import"):
        cli_train.main(["--load_model", "--crossval_size", "0",
                        "--platform", "cpu", "--checkpoint_dir",
                        str(tmp_path), "--data_dir", str(tmp_path)])


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "--bf16"])
def test_cli_bf16_flag_sets_the_compute_dtype(monkeypatch, bf16):
    """``--bf16`` builds the Trainer with ``compute_dtype="bfloat16"``, as
    the JAX CLI's ``:154`` does, and without it float32; the store and the
    run after that are ``test_torch_port_train_bf16.py``'s."""
    built = {}

    def stop(args, cfg, store, **options):
        built.update(options)
        raise SystemExit(0)

    monkeypatch.setattr(cli_train, "build_store", lambda *a: None)
    monkeypatch.setattr(cli_train, "make_trainer", stop)
    with pytest.raises(SystemExit):
        cli_train.main(["--platform", "cpu", "--crossval_size", "0"]
                       + (["--bf16"] if bf16 else []))
    assert built["compute_dtype"] == ("bfloat16" if bf16 else "float32")


@pytest.mark.parametrize("impl", ["threefry2x32", "rbg", "unsafe_rbg"])
def test_cli_prng_impl_other_than_auto_exits_with_its_reason(tmp_path, impl):
    with pytest.raises(SystemExit, match="torch's Philox"):
        cli_train.main(["--prng_impl", impl, "--platform", "cpu",
                        "--data_dir", str(tmp_path)])


class _StoreReached(Exception):
    pass


@pytest.mark.parametrize("argv", [
    ["--pallas_loss"], ["--prng_impl", "auto"],
    ["--pallas_loss", "--prng_impl", "auto"]])
def test_cli_pallas_loss_and_auto_prng_are_no_ops(tmp_path, monkeypatch,
                                                  argv):
    """``--pallas_loss`` and ``--prng_impl auto`` parse and change nothing:
    the run goes on to build its store, as it does without them."""
    def reached(args, cfg, device):
        assert args.fused_train == "auto" and not args.bf16
        raise _StoreReached

    monkeypatch.setattr(cli_train, "build_store", reached)
    with pytest.raises(_StoreReached):
        cli_train.main([*argv, "--synthetic", "--platform", "cpu",
                        "--data_dir", str(tmp_path), "--checkpoint_dir",
                        str(tmp_path)])


@pytest.mark.parametrize("hyper_args", [
    ["--crossval_size", "3", "--crossval_epochs", "1"],
    ["--crossval_load", "--crossval_size", "3"]])
def test_cli_train_on_cpu_runs_the_sweep(tmp_path, monkeypatch, capsys,
                                         hyper_args):
    """``cptorch-train --platform cpu`` with a 3-config sweep (and, given
    ``--crossval_load`` with no cache, falling back to it) at full width on
    a one-person store: both ``.npy`` files in the reference layout, the
    best combination's keys row, then the final train."""
    def one_person(args, cfg, device):
        emg, pos, glove = make_processed_dataset(cfg, people_positions=[40])
        return DeviceStore(cfg, emg, pos, glove, device=device)

    monkeypatch.setattr(cli_train, "build_store", one_person)
    rc = cli_train.main([
        "--synthetic", *hyper_args, "--final_epochs", "1",
        "--batch_size", "150", "--no_adabn", "--platform", "cpu",
        "--data_dir", str(tmp_path), "--checkpoint_dir", str(tmp_path)])
    assert rc == 0
    out = capsys.readouterr().out
    assert ("no cached crossval found" in out) == ("--crossval_load"
                                                  in hyper_args)
    assert "crossval [3/3]: best acc" in out and "crossval: 3 configs" in out
    values = np.load(tmp_path / "cross_val_values.npy")
    keys = np.load(tmp_path / "cross_val_keys.npy")
    assert values.shape == (3, 2) and values.dtype == np.float64
    np.testing.assert_array_equal(keys, port_crossval.keys_array(
        port_crossval.sample_hyperparams(3, seed=42), 16))
    best = port_crossval.best_config(values, keys)
    assert f"Best combination: {best}" in out
    assert "Epoch 0." in out


def test_cli_default_platform_needs_a_gpu(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.delenv("CPTORCH_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_train.main(["--synthetic", "--crossval_size", "0"])
