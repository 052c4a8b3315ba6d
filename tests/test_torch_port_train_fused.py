"""PyTorch port: the fused training chain (``ops/train_fused.py``) and
``Trainer(use_fused_train=True)`` against the JAX package's
``ops/train_fused.py`` and its fused trainer.

On the CPU the port's chain runs the plain versions of K5f, K5b and K5m
inside its ``torch.autograd.Function``; the JAX chain runs its Pallas
kernels in interpret mode, with explicit masks (``mask_mode="input"``)
where the two frameworks' random bits would differ. Inputs are made with
numpy from a seed. Tolerances are the JAX package's own
(``tests/test_train_fused.py``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrastiveprosthetics_torch.cli import train as cli_train
from contrastiveprosthetics_torch.config import DEFAULT_CONFIG as CFG
from contrastiveprosthetics_torch.data.store import DeviceStore
from contrastiveprosthetics_torch.data.synthetic import make_processed_dataset
from contrastiveprosthetics_torch.models.convert import (
    from_flax_variables,
    load_reference_checkpoint,
    model_from_state_dict,
)
from contrastiveprosthetics_torch.ops import train_fused as TF
from contrastiveprosthetics_torch.train.engine import Hyper, Trainer
from contrastiveprosthetics_tpu.data import sampler as jax_sampler
from contrastiveprosthetics_tpu.models.clip import l2_penalty as jax_l2_penalty
from contrastiveprosthetics_tpu.ops import train_fused as jax_tf
from contrastiveprosthetics_tpu.train import engine as jax_engine
from test_torch_port_models import jax_variables, port_model
from test_torch_port_train import named_grads, port_state, t, trainers

torch.set_num_threads(1)

VALUE_TOL = dict(rtol=2e-5, atol=2e-5)  # test_train_fused.py:76-79


def assert_grads_close(got, want, rtol, scale_atol, names=None):
    """Each gradient at ``rtol`` and ``scale_atol`` times its largest
    magnitude (test_train_fused.py:84-88)."""
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = np.asarray(a), np.asarray(b)
        scale = max(float(np.abs(b).max()), 1e-3)
        np.testing.assert_allclose(a, b, rtol=rtol, atol=scale_atol * scale,
                                   err_msg=names[i] if names else str(i))


def chain_inputs(L, D0, F, N, seed=0, keep=0.75):
    """Numpy chain parameters and input, and one {0,1} mask per dropped
    block (the last ``min(4, L)`` blocks' outputs)."""
    rng = np.random.default_rng(seed)
    ws = [(rng.standard_normal((D0 if i == 0 else F, F)) * 0.1).astype(
        np.float32) for i in range(L)]
    bs = [(rng.standard_normal(F) * 0.1).astype(np.float32) for _ in range(L)]
    gs = [np.full(F, 1.0 + 0.1 * i, np.float32) for i in range(L)]
    betas = [np.full(F, 0.05 * i, np.float32) for i in range(L)]
    x0 = rng.standard_normal((N, D0)).astype(np.float32)
    masks = [(rng.random((N, F)) < keep).astype(np.float32)
             for _ in range(min(4, L))]
    return [x0, *ws, *bs, *gs, *betas], masks


def split(args, L):
    return args[0], args[1:1 + L], args[1 + L:1 + 2 * L], \
        args[1 + 2 * L:1 + 3 * L], args[1 + 3 * L:]


def torch_leaves(args):
    return [t(a).requires_grad_() for a in args]


# -------------------------------------------------------------------- (a)
@pytest.mark.parametrize("L,D0,F,N", [(4, 128, 96, 40), (3, 64, 128, 33)])
def test_dense_chain_reference_matches_jax(L, D0, F, N):
    """(a) The port's autograd chain against the JAX oracle: values, the
    batch statistics, and the gradients of a loss touching every output."""
    args, masks = chain_inputs(L, D0, F, N)
    dropout_from = max(0, L - 4)

    def jax_ref(a):
        x0, ws, bs, gs, be = split(a, L)
        return jax_tf.dense_chain_reference(
            x0, ws, bs, gs, be, [jnp.asarray(m) for m in masks],
            jnp.float32(0.75), dropout_from=dropout_from)

    ja = [jnp.asarray(a) for a in args]
    hj, mj, vj = jax_ref(ja)
    gj = jax.grad(lambda a: jnp.sum(jnp.sin(jax_ref(a)[0])))(ja)
    ta = torch_leaves(args)
    x0, ws, bs, gs, be = split(ta, L)
    h, m, v = TF.dense_chain_reference(x0, ws, bs, gs, be,
                                       [t(mk) for mk in masks],
                                       torch.tensor(0.75),
                                       dropout_from=dropout_from)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(hj),
                               **VALUE_TOL)
    np.testing.assert_allclose(m.detach().numpy(), np.asarray(mj), atol=1e-5)
    np.testing.assert_allclose(v.detach().numpy(), np.asarray(vj), atol=1e-5)
    gt = torch.autograd.grad(torch.sin(h).sum(), ta)
    assert_grads_close([g.numpy() for g in gt], gj, 2e-4, 2e-5)


# -------------------------------------------------------------------- (b)
@pytest.mark.parametrize("L,D0,F,N", [(4, 96, 64, 33), (6, 128, 64, 48)])
def test_fused_chain_matches_jax_interpret_input_mode(L, D0, F, N):
    """(b) The port's fused chain (plain K5f/K5b inside its autograd
    Function) against the JAX chain's Pallas kernels in interpret mode, fed
    the same masks: values, statistics and every gradient, with dropout
    from block 0 (L=4) and from L-4 (L=6)."""
    args, masks = chain_inputs(L, D0, F, N, seed=L)
    jm = tuple(jnp.asarray(m) for m in masks)
    rate = 0.25

    def jax_fused(a):
        x0, ws, bs, gs, be = split(a, L)
        return jax_tf.fused_dense_chain(
            x0, ws, bs, gs, be, jax.random.key(0), jnp.float32(rate),
            mask_mode="input", ext_masks=jm, interpret=True)

    ja = [jnp.asarray(a) for a in args]
    hj, mj, vj = jax.jit(jax_fused)(ja)
    gj = jax.jit(jax.grad(lambda a: jnp.sum(jnp.sin(jax_fused(a)[0]))))(ja)
    ta = torch_leaves(args)
    x0, ws, bs, gs, be = split(ta, L)
    h, m, v = TF.fused_dense_chain(x0, ws, bs, gs, be, None, rate,
                                   mask_mode="input",
                                   ext_masks=[t(mk) for mk in masks])
    assert not m.requires_grad and not v.requires_grad
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(hj),
                               **VALUE_TOL)
    np.testing.assert_allclose(m.numpy(), np.asarray(mj), atol=1e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(vj), atol=1e-5)
    gt = torch.autograd.grad(torch.sin(h).sum(), ta)
    assert_grads_close([g.numpy() for g in gt], gj, 2e-4, 2e-5)


def test_fused_chain_matches_its_own_reference_in_prng_mode():
    """The drawn masks are the ones ``dropout_masks`` replays at the dropped
    block's index: the prng-mode chain equals the autograd reference fed
    those masks, values and gradients, and the two modes agree bit for
    bit."""
    L, N, F = 5, 37, 64
    args, _ = chain_inputs(L, 80, F, N, seed=3)
    seed = torch.tensor([11, -5], dtype=torch.int32)
    keep = torch.tensor([0.6])
    masks = [TF.dropout_masks(seed, keep, N, F, b) for b in range(1, L)]
    ta = torch_leaves(args)
    h, _, _ = TF.fused_dense_chain(*split(ta, L), seed, 0.4)
    hi, _, _ = TF.fused_dense_chain(*split(ta, L), None, 0.4,
                                    mask_mode="input", ext_masks=masks)
    hr, _, _ = TF.dense_chain_reference(*split(ta, L), masks, keep,
                                        dropout_from=1)
    assert torch.equal(h, hi)
    np.testing.assert_allclose(h.detach().numpy(), hr.detach().numpy(),
                               **VALUE_TOL)
    g = torch.autograd.grad(torch.sin(h).sum(), ta)
    gr = torch.autograd.grad(torch.sin(hr).sum(), ta)
    assert_grads_close([x.numpy() for x in g], [x.numpy() for x in gr],
                       2e-4, 2e-5)


def test_fused_chain_rejects_other_dtypes_and_mask_counts():
    args, masks = chain_inputs(2, 32, 16, 8)
    x0, ws, bs, gs, be = split([t(a) for a in args], 2)
    with pytest.raises(ValueError, match="float16: the kernels take"):
        TF.fused_dense_chain(x0.to(torch.float16), ws, bs, gs, be, None,
                             0.0, mask_mode="input", ext_masks=masks)
    with pytest.raises(ValueError, match="1 masks for 2 dropped blocks"):
        TF.fused_dense_chain(x0, ws, bs, gs, be, None, 0.0,
                             mask_mode="input", ext_masks=[t(masks[0])])
    with pytest.raises(ValueError, match="seed words"):
        TF.fused_dense_chain(x0, ws, bs, gs, be, None, 0.0)


# -------------------------------------------------------------------- (c)
@pytest.mark.parametrize("keep", [0.0, 0.5, 0.7, 1.0])
def test_keep_threshold_matches_jax(keep):
    """(c) The integer keep threshold, exact at keep 1."""
    want = int(jax_tf._keep_threshold(jnp.float32(keep)))
    assert int(TF.keep_threshold(torch.tensor(keep))) == want
    assert int(TF.keep_threshold(keep)) == want


# -------------------------------------------------------------------- (d)
@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(counter, key, want):
    """(d) Random123's published known-answer vectors for
    Philox4x32-10."""
    out = TF.philox4x32_10([torch.tensor(c) for c in counter],
                           [torch.tensor(k) for k in key])
    assert tuple(int(w) for w in out) == want


def test_dropout_masks_statistics_and_coordinates():
    """(d) Masks have the keep rate's mean, are all ones at rate 0, depend
    on (seed, block, row, column) only, not on the mask's extent, and
    differ between blocks and seeds."""
    seed = torch.tensor([2024, -31], dtype=torch.int32)
    keep = torch.tensor([0.7])
    m = TF.dropout_masks(seed, keep, 300, 130, 4)
    assert m.dtype == torch.float32 and set(m.unique().tolist()) == {0.0, 1.0}
    assert abs(float(m.mean()) - 0.7) < 0.01
    assert torch.equal(TF.dropout_masks(seed, keep, 41, 67, 4), m[:41, :67])
    assert not torch.equal(TF.dropout_masks(seed, keep, 300, 130, 5), m)
    other = torch.tensor([2025, -31], dtype=torch.int32)
    assert not torch.equal(TF.dropout_masks(other, keep, 300, 130, 4), m)
    ones = TF.dropout_masks(seed, torch.tensor([1.0]), 300, 130, 4)
    assert bool((ones == 1).all())


# -------------------------------------------------------------------- (e)
@pytest.mark.parametrize("adabn", [True, False])
def test_fused_emg_embed_matches_jax_and_flax(adabn):
    """(e) The whole EMG encoder at rate 0 (n_linear 4, hidden 128): the
    port's fused forward against the JAX package's in interpret mode and
    the flax EMGNet; the running statistics a plain-BatchNorm step leaves;
    the gradients of every EMG parameter."""
    model, v = jax_variables(n_linear=4, hidden=128, adabn=adabn)
    frames = np.random.default_rng(2).standard_normal((82, 12)).astype(
        np.float32)
    bstats = v.get("batch_stats", {})
    dkey = jax.random.key(3)

    def flax_fwd(p):
        out, upd = model.apply(
            {"params": p, "batch_stats": bstats}, jnp.asarray(frames), 0.0,
            True, rngs={"dropout": dkey}, mutable=["batch_stats"],
            method=lambda m, f, r, tr: m.emg_net(f, r, tr))
        return out, upd.get("batch_stats", {}).get("emg_net")

    def jax_fused(p):
        return jax_tf.fused_emg_embed(
            p["emg_net"], jnp.asarray(frames), jnp.float32(0.0), dkey,
            batch_stats=bstats.get("emg_net"), adabn=adabn, interpret=True)

    e_flax, s_flax = jax.jit(flax_fwd)(v["params"])
    e_jax, s_jax = jax.jit(jax_fused)(v["params"])
    g_jax = jax.jit(jax.grad(lambda p: jnp.sum(jnp.sin(jax_fused(p)[0]))))(
        v["params"])

    port = port_model(v, adabn=adabn).train()
    emg_net = port.emg_net
    e, stats = TF.fused_emg_embed(emg_net, t(frames), 0.0,
                                  torch.zeros(2, dtype=torch.int32))
    for want in (e_jax, e_flax):
        np.testing.assert_allclose(e.detach().numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-5)
    if adabn:
        assert stats is None
    else:
        for i, (mean, var) in enumerate(stats):
            for ref in (s_jax, s_flax):
                r = ref[f"BatchNorm_{i}"]["BatchNorm_0"]
                np.testing.assert_allclose(mean.numpy(), np.asarray(r["mean"]),
                                           atol=1e-6)
                np.testing.assert_allclose(var.numpy(), np.asarray(r["var"]),
                                           atol=1e-6)
    names = [n for n, _ in emg_net.named_parameters()]
    grads = torch.autograd.grad(torch.sin(e).sum(), list(emg_net.parameters()))
    params = dict(jax.tree_util.tree_map(np.asarray, g_jax))
    params["glove_net"] = jax.tree_util.tree_map(np.asarray,
                                                 v["params"]["glove_net"])
    want = from_flax_variables(params, bstats, adabn=adabn)
    assert_grads_close([g.numpy() for g in grads],
                       [want["emg_net." + n].numpy() for n in names],
                       1e-3, 1e-4, names)


def test_fused_emg_embed_with_masks_matches_jax_input_mode():
    """The explicit-mask seam at rate 0.3: the port's encoder against the
    JAX package's ``mask_mode="input"`` with the same masks."""
    model, v = jax_variables(n_linear=3, hidden=64)
    rng = np.random.default_rng(4)
    frames = rng.standard_normal((60, 12)).astype(np.float32)
    masks = [(rng.random((60, 64)) < 0.7).astype(np.float32)
             for _ in range(3)]
    e_jax, _ = jax_tf.fused_emg_embed(
        v["params"]["emg_net"], jnp.asarray(frames), jnp.float32(0.3),
        jax.random.key(0), mask_mode="input",
        ext_masks=tuple(jnp.asarray(m) for m in masks),
        batch_stats=v["batch_stats"]["emg_net"], adabn=False, interpret=True)
    port = port_model(v).train()
    e, _ = TF.fused_emg_embed(port.emg_net, t(frames), 0.3, None,
                              mask_mode="input",
                              ext_masks=[t(m) for m in masks])
    np.testing.assert_allclose(e.detach().numpy(), np.asarray(e_jax),
                               rtol=1e-4, atol=1e-5)


# -------------------------------------------------------------------- (f)
@pytest.fixture(scope="module")
def data():
    return make_processed_dataset(CFG, people_positions=[40, 41], seed=3)


def test_fused_epoch_matches_jax_fused_trainer_and_eager(data):
    """(f) One epoch of ``Trainer(use_fused_train=True)`` at dropout 0 (3
    steps of 200 items over D=600, n_linear 2, hidden 64), fed the JAX
    epoch's index matrices, against the JAX fused trainer's steps and
    against the port's own eager path: losses, parameters and running
    statistics (test_train_fused.py:244-262)."""
    hyper = (1e-3, 1e-6, 0.0, 1e-3, 1e-6, 0.0)
    jh, h = jax_engine.Hyper.single(*hyper), Hyper.single(*hyper)
    port, jtr = trainers(data, batch_size=200)
    jtr.use_fused_train = True
    jstate = jtr.init_state(jax.random.PRNGKey(20))
    states = {f: port_state(jstate, adabn=False) for f in (True, False)}
    v = jtr.view_train
    k_perm, k_order, k_drop = jax.random.split(jax.random.PRNGKey(21), 3)
    emg_rand = jax_sampler.task_permutations(k_perm, v.n_tasks, v.D)
    batches, tail = jax_sampler.epoch_batches(k_order, v.D, 200)
    assert batches.shape == (3, 200) and tail.shape == (0,)
    step = jax.jit(jtr._sgd_step)
    glove_b = jnp.zeros((200, v.n_tasks, CFG.glove_dim))
    want = []
    for i, items in enumerate(batches):
        emg_b = jax_sampler.gather_train_batch(v.emg_flat, emg_rand, items)
        jstate, loss, _ = step(jstate, emg_b, glove_b, jh, jh.lr_emg,
                               jh.lr_glove, jax.random.fold_in(k_drop, i))
        want.append(float(loss))
    losses = {}
    for fused, state in states.items():
        trainer = Trainer(CFG, port.store, adabn=False, batch_size=200,
                          n_linear=2, hidden=64, use_fused_train=fused)
        losses[fused], _ = trainer.train_epoch_from_indices(
            state, t(emg_rand, torch.long), t(batches, torch.long),
            t(tail, torch.long), h, 1.0, 1.0, None)
    np.testing.assert_allclose(losses[True].numpy(), want, rtol=2e-4)
    np.testing.assert_allclose(losses[True].numpy(), losses[False].numpy(),
                               rtol=2e-4)
    ref = from_flax_variables(
        jax.tree_util.tree_map(np.asarray, jstate.params),
        jax.tree_util.tree_map(np.asarray, jstate.batch_stats))
    fused_sd = states[True].model.state_dict()
    for other in (ref, states[False].model.state_dict()):
        for name, value in fused_sd.items():
            if "running" in name:
                np.testing.assert_allclose(value.numpy(), other[name].numpy(),
                                           rtol=1e-4, atol=1e-5, err_msg=name)
            elif value.is_floating_point() and value.dim() > 0:
                scale = max(float(other[name].abs().max()), 1e-3)
                np.testing.assert_allclose(value.numpy(), other[name].numpy(),
                                           rtol=2e-3, atol=2e-4 * scale,
                                           err_msg=name)


def test_fused_step_with_masks_matches_jax_step(data):
    """The trainer's explicit-mask seam at dropout 0.3: the JAX fused step
    in interpret mode draws its in-kernel masks as all-keep and the last
    block's as a real Bernoulli; ``extract_prng_masks`` replays them and
    the port's step, fed them, gives the JAX loss and gradients."""
    port, jtr = trainers(data)
    jtr.use_fused_train = True
    port = Trainer(CFG, port.store, adabn=False, batch_size=8, n_linear=2,
                   hidden=64, use_fused_train=True)
    jstate = jtr.init_state(jax.random.PRNGKey(6))
    state = port_state(jstate, adabn=False)
    hyper = (1e-3, 1e-2, 0.3, 1e-3, 3e-2, 0.0)
    jh, h = jax_engine.Hyper.single(*hyper), Hyper.single(*hyper)
    v = jtr.view_train
    k_perm, k_order = jax.random.split(jax.random.PRNGKey(7))
    emg_rand = jax_sampler.task_permutations(k_perm, v.n_tasks, v.D)
    items = jax.random.permutation(k_order, v.D)[:8]
    emg_b = jax_sampler.gather_train_batch(v.emg_flat, emg_rand, items)
    glove_b = jnp.zeros((8, v.n_tasks, CFG.glove_dim))
    dkey = jax.random.PRNGKey(0)

    def total(p):
        loss, aux = jtr._loss_and_metrics(p, jstate.batch_stats, emg_b,
                                          glove_b, jh, dkey, True)
        return (loss + jh.reg_emg * jax_l2_penalty(p["emg_net"])
                + jh.reg_glove * jax_l2_penalty(p["glove_net"])), loss

    (_, loss_j), jgrads = jax.value_and_grad(total, has_aux=True)(
        jstate.params)
    k_emg = jax.random.split(dkey)[0]
    masks = jax_tf.extract_prng_masks(8 * v.n_tasks, [64, 64], k_emg, 0.3,
                                      n_linear=2, interpret=True)
    assert 0.55 < float(masks[-1].mean()) < 0.85  # a real draw
    loss, _, grads = port.loss_and_grads(state, t(emg_b), h, None,
                                         ext_masks=[t(m) for m in masks])
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    want = from_flax_variables(
        jax.tree_util.tree_map(np.asarray, jgrads),
        jax.tree_util.tree_map(np.asarray, jstate.batch_stats))
    got = named_grads(state, grads)
    assert_grads_close([g.numpy() for g in got.values()],
                       [want[n].numpy() for n in got], 1e-3, 1e-4,
                       list(got))


def test_fused_step_needs_a_generator_for_dropout(data):
    port, _ = trainers(data)
    port = Trainer(CFG, port.store, adabn=False, batch_size=8, n_linear=2,
                   hidden=64, use_fused_train=True)
    state = port.init_state(port.generator(0))
    v = port.view_train
    emg_b = v.emg_flat[:8 * v.n_tasks].reshape(8, v.n_tasks, -1)
    with pytest.raises(ValueError, match="explicit torch.Generator"):
        port.loss_and_grads(state, emg_b, Hyper.single(1e-3, 0, 0.5, 1e-3, 0,
                                                       0), None)
    loss, _, _ = port.loss_and_grads(
        state, emg_b, Hyper.single(1e-3, 0, 0.5, 1e-3, 0, 0),
        port.generator(1))
    assert bool(torch.isfinite(loss))


# -------------------------------------------------------------------- (g)
def test_cli_fused_train_on_cpu_writes_a_reference_checkpoint(tmp_path,
                                                              monkeypatch,
                                                              capsys):
    """(g) ``cptorch-train --synthetic --fused_train on --platform cpu`` at
    full width on a one-person store writes a ``contrastive.pt`` that
    loads strictly."""
    def one_person(args, cfg, device):
        emg, pos, glove = make_processed_dataset(cfg, people_positions=[40])
        return DeviceStore(cfg, emg, pos, glove, device=device)

    made = []
    monkeypatch.setattr(cli_train, "build_store", one_person)
    init = Trainer.__post_init__

    def record(self):
        init(self)
        made.append(self.use_fused_train)

    monkeypatch.setattr(Trainer, "__post_init__", record)
    rc = cli_train.main([
        "--synthetic", "--crossval_size", "0", "--final_epochs", "1",
        "--batch_size", "150", "--test", "--no_adabn", "--fused_train", "on",
        "--platform", "cpu", "--data_dir", str(tmp_path),
        "--checkpoint_dir", str(tmp_path)])
    assert rc == 0 and made == [True]
    assert "Epoch 0." in capsys.readouterr().out
    model = model_from_state_dict(
        load_reference_checkpoint(str(tmp_path / "contrastive.pt")))
    assert not model.adabn
