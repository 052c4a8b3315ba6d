"""PyTorch port: the crossval sweep against the JAX package (the stacked
model and step, ``Trainer.sweep_*``, ``cross_validate`` and its files).

Small width (``n_linear=2, hidden=64``) on a one-person synthetic store
(train D=300, val D=4). The two frameworks' random streams never match,
so every comparison with JAX runs at dropout 0 on the JAX package's own
initial weights and index matrices.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrastiveprosthetics_torch.config import DEFAULT_CONFIG as CFG
from contrastiveprosthetics_torch.data import sampler
from contrastiveprosthetics_torch.data.store import DeviceStore
from contrastiveprosthetics_torch.data.synthetic import make_processed_dataset
from contrastiveprosthetics_torch.models.convert import (
    from_flax_variables,
    model_from_state_dict,
)
from contrastiveprosthetics_torch.models.stacked import (
    StackedContrastiveModel,
    StackedDropout,
)
from contrastiveprosthetics_torch.train import crossval as port_crossval
from contrastiveprosthetics_torch.train.engine import Hyper, Trainer, TrainState
from contrastiveprosthetics_tpu.config import DEFAULT_CONFIG as JCFG
from contrastiveprosthetics_tpu.data import sampler as jax_sampler
from contrastiveprosthetics_tpu.data.store import DeviceStore as JaxStore
from contrastiveprosthetics_tpu.train import crossval as jax_crossval
from contrastiveprosthetics_tpu.train import engine as jax_engine

torch.set_num_threads(1)

SMALL = dict(n_linear=2, hidden=64)
# test_sgd_step_gradients_match_jax's gradient tolerance, and
# test_adam_update_matches_optax's for what Adam computes from equal input
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7
ADAM_RTOL = 1e-6
STATS_TOL = dict(rtol=1e-5, atol=1e-6)  # running statistics, as there
# three configs at dropout 0: (lr_emg, reg_emg, dp_emg, lr_glove,
# reg_glove, dp_glove), each lr and reg its own
HYPERS = np.array([[1e-3, 1e-2, 0, 3e-3, 1e-3, 0],
                   [3e-3, 1e-5, 0, 1e-4, 1e-1, 0],
                   [1e-4, 1e-1, 0, 1e-3, 1e-6, 0]], np.float32)


def t(x, dtype=None) -> torch.Tensor:
    out = torch.from_numpy(np.array(x))
    return out if dtype is None else out.to(dtype)


def port_hyper(h=HYPERS) -> Hyper:
    """(C,) f32 tensors, one per field."""
    return Hyper(*[t(h[:, j]) for j in range(6)])


def jax_hyper(h=HYPERS) -> jax_engine.Hyper:
    return jax_engine.Hyper(*[jnp.asarray(h[:, j]) for j in range(6)])


@pytest.fixture(scope="module")
def data():
    return make_processed_dataset(CFG, people_positions=[40], seed=3)


def trainers(data, adabn=False, batch_size=8):
    emg, pos, glove = data
    port = Trainer(CFG, DeviceStore(CFG, emg, pos, glove), adabn=adabn,
                   batch_size=batch_size, **SMALL)
    jtr = jax_engine.Trainer(JCFG, JaxStore(JCFG, emg, pos, glove),
                             adabn=adabn, batch_size=batch_size, **SMALL)
    return port, jtr


def config(tree, c):
    return jax.tree_util.tree_map(lambda x: np.asarray(x[c]), tree)


def stacked_state(jstates, adabn) -> TrainState:
    """The port's stacked state holding a vmapped JAX state's configs
    (fresh Adam chains)."""
    C = np.shape(jax.tree_util.tree_leaves(jstates.params)[0])[0]
    models = [model_from_state_dict(from_flax_variables(
        config(jstates.params, c), config(jstates.batch_stats, c),
        adabn=adabn)) for c in range(C)]
    return TrainState.fresh(StackedContrastiveModel.from_models(models))


def stacked_jax_state_dict(jstates, adabn) -> dict:
    C = np.shape(jax.tree_util.tree_leaves(jstates.params)[0])[0]
    sds = [from_flax_variables(config(jstates.params, c),
                               config(jstates.batch_stats, c), adabn=adabn)
           for c in range(C)]
    return {k: torch.stack([sd[k] for sd in sds]) for k in sds[0]}


def trained_names(state) -> dict:
    """name -> (tower, index) of every trained parameter."""
    out = {}
    for tower, prefix in (("emg_net", "emg_net."),
                          ("glove_net", "glove_net.easy.")):
        for i, (name, _) in enumerate(
                state.model.towers()[tower].named_parameters()):
            out[prefix + name] = (tower, i)
    return out


def first_moments(state) -> dict:
    opt = {"emg_net": state.opt_emg, "glove_net": state.opt_glove}
    return {n: opt[tw].mu[i] for n, (tw, i) in trained_names(state).items()}


def jax_first_moments(jstates, adabn) -> dict:
    mu = {"emg_net": jstates.opt_emg.mu, "glove_net": jstates.opt_glove.mu}
    return stacked_jax_state_dict(jstates._replace(params=mu), adabn)


def adam_step_tolerance(g, lr) -> torch.Tensor:
    """How far one Adam step from the same parameters may move a parameter
    away from the one a gradient ``g`` gives when the gradient itself is
    off by up to the gradient tolerance: lr times the change of the first
    update u = g / (|g| + eps) over g +- (atol + rtol |g|). Near g = 0
    (the biases ahead of a BatchNorm, whose gradient is rounding noise)
    this is up to 2 lr; elsewhere it is below f32 rounding."""
    g = g.double()
    dg = GRAD_ATOL + GRAD_RTOL * g.abs()
    u = lambda x: x / (x.abs() + 1e-8)  # noqa: E731
    du = torch.maximum((u(g + dg) - u(g)).abs(), (u(g - dg) - u(g)).abs())
    return lr.double().view(-1, *[1] * (g.dim() - 1)) * du


def assert_first_step_matches(state, want_sd, want_mu, lr_emg, lr_glove):
    """After one Adam step from equal parameters: every trained parameter
    (with :func:`adam_step_tolerance`, and the Adam test's rtol relative to
    the operands of p - lr u), the first moments (the gradients times 1 -
    b1, at the gradient tolerance) and every buffer."""
    names = trained_names(state)
    mu = first_moments(state)
    for name, value in state.model.state_dict().items():
        want = want_sd[name]
        if name not in names:
            if "running" in name:
                np.testing.assert_allclose(value.numpy(), want.numpy(),
                                           **STATS_TOL, err_msg=name)
            else:
                assert torch.equal(value, want), name
            continue
        np.testing.assert_allclose(mu[name].numpy(), want_mu[name].numpy(),
                                   rtol=GRAD_RTOL, atol=0.1 * GRAD_ATOL,
                                   err_msg=name)
        lr = lr_emg if name.startswith("emg_net") else lr_glove
        tol = adam_step_tolerance(want_mu[name] / 0.1, lr)
        # f32 rounds p - lr u relative to its operands, |p| and lr |u| <= lr
        scale = want.double().abs() + lr.double().view(
            -1, *[1] * (want.dim() - 1))
        err = (value.double() - want.double()).abs()
        bad = err > tol + ADAM_RTOL * scale
        assert not bool(bad.any()), (name, float(err.max()))


def jax_batches(jtr, keys, batch_size):
    """Per-config (emg_rand, batches, tail) from each key, as the JAX
    ``_train_epoch`` draws them (``engine.py:440-443``), stacked."""
    v = jtr.view_train
    parts = [jax.random.split(k, 4) for k in keys]
    emg_rand = jnp.stack([jax_sampler.task_permutations(p[0], v.n_tasks, v.D)
                          for p in parts])
    bt = [jax_sampler.epoch_batches(p[2], v.D, batch_size) for p in parts]
    return (emg_rand, jnp.stack([b for b, _ in bt]),
            jnp.stack([tl for _, tl in bt]))


def jax_val_indices(jtr, keys, batch_size):
    """Per-config (emg_rand, batches, weights, inverse), as the JAX
    ``_evaluate`` draws them (``engine.py:637-640``), stacked."""
    v = jtr.view_val
    out = [], [], [], []
    for k in keys:
        k_perm, _, k_order = jax.random.split(k, 3)
        out[0].append(jax_sampler.task_permutations(k_perm, v.n_tasks, v.D))
        for lst, x in zip(out[1:], jax_sampler.epoch_batches_padded(
                k_order, v.D, batch_size)):
            lst.append(x)
    return [jnp.stack(x) for x in out]


def to_long(*xs):
    return [t(x, torch.long) for x in xs]


# --------------------------------------------------------- stacked step
@pytest.mark.parametrize("adabn", [False, True])
def test_stacked_step_matches_jax_vmap(data, adabn):
    """One stacked step of 3 configs (each its own lr, reg and batch)
    against ``jax.vmap`` of the JAX ``_sgd_step`` from the same weights:
    loss, accuracy, every parameter after Adam, the first moments and the
    running statistics."""
    port, jtr = trainers(data, adabn=adabn)
    jstates = jax.vmap(jtr.init_state)(jax.random.split(
        jax.random.PRNGKey(6), 3))
    state = stacked_state(jstates, adabn)
    emg_rand, batches, _ = jax_batches(
        jtr, jax.random.split(jax.random.PRNGKey(7), 3), 8)
    items = batches[:, 0]
    v = jtr.view_train
    emg_b = jax.vmap(jax_sampler.gather_train_batch, (None, 0, 0))(
        v.emg_flat, emg_rand, items)
    glove_b = jnp.zeros(emg_b.shape[:3] + (JCFG.glove_dim,))
    jh = jax_hyper()
    new, loss_j, acc_j = jax.vmap(jtr._sgd_step)(
        jstates, emg_b, glove_b, jh, jh.lr_emg, jh.lr_glove,
        jax.random.split(jax.random.PRNGKey(0), 3))
    h = port_hyper()
    got_b = sampler.stacked_gather_train_batch(
        port.view_train.emg_flat, *to_long(emg_rand, items))
    assert torch.equal(got_b, t(emg_b))
    loss, acc = port._sgd_step(state, got_b, h, h.lr_emg, h.lr_glove, None)
    assert loss.shape == acc.shape == (3,)
    np.testing.assert_allclose(loss.numpy(), np.asarray(loss_j), rtol=1e-5)
    np.testing.assert_allclose(acc.numpy(), np.asarray(acc_j), atol=1e-6)
    assert state.opt_emg.count == state.opt_glove.count == 1
    assert_first_step_matches(state, stacked_jax_state_dict(new, adabn),
                              jax_first_moments(new, adabn), h.lr_emg,
                              h.lr_glove)


def test_stacked_step_is_a_loop_of_single_steps(data):
    """The stacked step against each config's own ``_sgd_step`` from the
    unstacked weights and the same batch: the first step as against JAX,
    then two more steps' losses and accuracies."""
    port, _ = trainers(data)
    gens = [port.generator(i) for i in range(3)]
    state = port.init_sweep_state(gens)
    singles = [TrainState.fresh(state.model.unstack(c)) for c in range(3)]
    v = port.view_train
    emg_rand = sampler.stacked_task_permutations(gens, v.n_tasks, v.D)
    batches, _ = sampler.stacked_epoch_batches(gens, v.D, 8)
    h = port_hyper()
    for i in range(3):
        emg_b = sampler.stacked_gather_train_batch(v.emg_flat, emg_rand,
                                                   batches[:, i])
        loss, acc = port._sgd_step(state, emg_b, h, h.lr_emg, h.lr_glove,
                                   None)
        want = [port._sgd_step(s, emg_b[c], Hyper.single(*HYPERS[c]),
                               float(HYPERS[c, 0]), float(HYPERS[c, 3]),
                               None) for c, s in enumerate(singles)]
        np.testing.assert_allclose(loss.numpy(), [float(w[0]) for w in want],
                                   rtol=1e-5)
        np.testing.assert_allclose(acc.numpy(), [float(w[1]) for w in want],
                                   atol=1e-6)
        if i == 0:
            sds = [s.model.state_dict() for s in singles]
            mus = [first_moments(s) for s in singles]
            assert_first_step_matches(
                state, {k: torch.stack([sd[k] for sd in sds]) for k in sds[0]},
                {k: torch.stack([m[k] for m in mus]) for k in mus[0]},
                h.lr_emg, h.lr_glove)


def test_a_nan_config_leaves_the_others_bit_equal(data):
    """Config 1 diverged (NaN weights): configs 0 and 2 step, drop (the
    same chunk generator) and evaluate exactly as without it."""
    port, _ = trainers(data, batch_size=32)
    hy = HYPERS.copy()
    hy[:, 2] = (0.5, 0.4, 0.6)  # dropout on
    h = port_hyper(hy)
    runs = []
    for poison in (False, True):
        gens = [port.generator(i) for i in range(3)]
        state = port.init_sweep_state(gens)
        if poison:
            with torch.no_grad():
                state.model.emg_net.linear[0].weight[1, 0, 0] = float("nan")
        v = port.view_train
        emg_rand = sampler.stacked_task_permutations(gens, v.n_tasks, v.D)
        batches, tail = sampler.stacked_epoch_batches(gens, v.D, 32)
        losses, accs = port.sweep_epoch_from_indices(
            state, emg_rand, batches[:, :2], tail, h, 1.0, 1.0,
            port.generator(99))
        vv = port.view_val
        val = port.sweep_evaluate_from_indices(
            state, vv, sampler.stacked_task_permutations(gens, vv.n_tasks,
                                                         vv.D),
            *sampler.stacked_epoch_batches_padded(gens, vv.D, 32))
        runs.append((losses, accs, *val, state))
    clean, poisoned = runs
    assert bool(torch.isnan(poisoned[0][1]).all())
    assert bool(torch.isnan(poisoned[2][1]))
    keep = [0, 2]
    for a, b in zip(clean[:4], poisoned[:4]):
        assert torch.equal(a[keep], b[keep])
    sa, sb = clean[4], poisoned[4]
    for a, b in zip(sa.model.state_dict().values(),
                    sb.model.state_dict().values()):
        assert torch.equal(a[keep], b[keep])
    for a, b in zip(sa.opt_emg.mu + sa.opt_emg.nu + sa.opt_glove.nu,
                    sb.opt_emg.mu + sb.opt_emg.nu + sb.opt_glove.nu):
        assert torch.equal(a[keep], b[keep])


def test_stacked_dropout_keeps_each_configs_share_and_scale():
    """Rates (0, 0.4, 0.9): rate 0 is the identity bit for bit; the others
    keep about 1 - rate of the values, each scaled by exactly
    1 / (1 - rate) in f32, and the rest are 0."""
    drop = StackedDropout().train()
    rng = np.random.default_rng(0)
    x = t(rng.standard_normal((3, 500, 64)).astype(np.float32))
    rate = torch.tensor([0.0, 0.4, 0.9])
    y = drop(x, rate, torch.Generator().manual_seed(1))
    assert torch.equal(y[0], x[0])
    for c in (1, 2):
        keep = 1.0 - rate[c]
        kept = y[c] != 0
        share = float(kept.float().mean())
        assert abs(share - float(keep)) < 0.01, (c, share)
        assert torch.equal(y[c][kept], x[c][kept] / keep)
    assert drop(x, rate, None) is x
    assert drop.eval()(x, rate, torch.Generator()) is x


# --------------------------------------------------------------- sweep
def jax_sweep_keys(key, epochs, C):
    """The keys ``_sweep_chunk_at`` derives for chunk 0
    (``engine.py:580-590``): init, per epoch, val."""
    k_chunk = jax.random.fold_in(key, 0)
    init = jax.random.split(jax.random.fold_in(k_chunk, 0), C)
    epoch = [jax.random.split(jax.random.fold_in(k_chunk, 100 + e), C)
             for e in range(epochs)]
    val = jax.random.split(jax.random.fold_in(k_chunk, 999), C)
    return init, epoch, val


def port_sweep_on_jax_indices(port, jtr, key, epochs, batch_size):
    """The port's stacked sweep of chunk 0, fed the JAX sweep's initial
    weights and index matrices. Returns (val loss, val acc, the JAX
    initial states, the per-epoch index matrices)."""
    init, epoch, val = jax_sweep_keys(key, epochs, 3)
    jstates = jax.jit(jax.vmap(jtr.init_state))(init)
    state = stacked_state(jstates, adabn=False)
    h = port_hyper()
    indices = []
    for ks in epoch:
        idx = jax_batches(jtr, ks, batch_size)
        indices.append(idx)
        port.sweep_epoch_from_indices(state, *to_long(*idx), h, 1.0, 1.0,
                                      None)
    emg_rand, batches, weights, inverse = jax_val_indices(jtr, val,
                                                          batch_size)
    loss, acc = port.sweep_evaluate_from_indices(
        state, port.view_val, t(emg_rand, torch.long),
        t(batches, torch.long), t(weights), t(inverse, torch.long))
    return loss, acc, jstates, indices, val


# val loss after the sweep's epochs: the two packages' f32 steps part by
# rounding that Adam then carries (test_one_epoch_matches_jax_step_by_step
# holds an epoch's losses to 1e-3)
VAL_LOSS_RTOL = 1e-3


def test_sweep_matches_jax_sweep_chunk_at(data):
    """One epoch of a 3-config chunk (bs 300 = D: one step per epoch)
    against the JAX sweep's own program, ``Trainer.sweep_chunk_at``, at
    dropout 0. (XLA:CPU compiles its two-epoch program, a scan, in 2-4
    minutes, too long for this suite; the next test runs two epochs.)"""
    port, jtr = trainers(data, batch_size=300)
    key = jax.random.PRNGKey(5)
    jh = jax_engine.Hyper(*[x[None] for x in jax_hyper()])
    ones = jnp.ones((1,), jnp.float32)
    vl, va = jtr.sweep_chunk_at(jh, jnp.int32(0), key, ones, ones, 300, 3)
    loss, acc, *_ = port_sweep_on_jax_indices(port, jtr, key, 1, 300)
    np.testing.assert_allclose(loss.numpy(), np.asarray(vl),
                               rtol=VAL_LOSS_RTOL)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(va))


def test_two_epoch_sweep_matches_jax(data):
    """Two epochs of a 3-config chunk at bs 128 (2 steps and a 44-item
    tail per epoch) against the JAX sweep's step and evaluation,
    ``jax.vmap`` of ``_sgd_step`` and ``_evaluate_scalars`` (what
    ``_sweep_run`` scans), from the keys ``_sweep_chunk_at`` derives, at
    dropout 0: val loss and voted val accuracy per config."""
    port, jtr = trainers(data, batch_size=128)
    key = jax.random.PRNGKey(5)
    loss, acc, jstates, indices, val = port_sweep_on_jax_indices(
        port, jtr, key, 2, 128)
    jh = jax_hyper()
    step = jax.jit(jax.vmap(jtr._sgd_step))
    v = jtr.view_train
    gather = jax.vmap(jax_sampler.gather_train_batch, (None, 0, 0))
    for emg_rand, batches, tail in indices:
        for items in [*jnp.moveaxis(batches, 1, 0), tail]:
            emg_b = gather(v.emg_flat, emg_rand, items)
            glove_b = jnp.zeros(emg_b.shape[:3] + (JCFG.glove_dim,))
            jstates, _, _ = step(jstates, emg_b, glove_b, jh, jh.lr_emg,
                                 jh.lr_glove, val)
    vl, va = jax.jit(jax.vmap(lambda s, k, hh: jtr._evaluate_scalars(
        s, k, hh, jtr.view_val, 128)))(jstates, val, jh)
    assert indices[0][2].shape == (3, 300 % 128)
    np.testing.assert_allclose(loss.numpy(), np.asarray(vl),
                               rtol=VAL_LOSS_RTOL)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(va))


def test_cross_validate_does_not_depend_on_the_chunk_width(data, tmp_path):
    """At dropout 0 (the masks are the only draw that depends on the
    chunk), chunks of 1, 2 (a ragged last chunk of 1) and 3 configs give
    each config the same values: its init and index matrices come from
    its own generator. Not bit for bit: the batched GEMMs' batch counts
    change with the chunk width, and with them the library's blocking and
    so the order of a config's sums, which an epoch at the sampled lrs (up
    to 0.076 here) carries into the val loss as the two packages' orders
    do (``VAL_LOSS_RTOL``); the voted accuracy may move by one vote, one
    (item, task) of the 4 x 41."""
    port, _ = trainers(data, batch_size=128)
    hypers = port_crossval.sample_hyperparams(3, seed=4)
    hypers = hypers._replace(dp_emg=np.zeros(3, np.float32),
                             dp_glove=np.zeros(3, np.float32))
    runs = [port_crossval.cross_validate(port, hypers, 1, seed=9, chunk=c,
                                         verbose=False)
            for c in (1, 2, 3)]
    one_vote = 1 / (port.view_val.D * port.view_val.n_tasks)
    for values in runs[1:]:
        np.testing.assert_allclose(values[:, 0], runs[0][:, 0],
                                   rtol=VAL_LOSS_RTOL)
        assert np.abs(values[:, 1] - runs[0][:, 1]).max() <= one_vote + 1e-7
    assert runs[0].dtype == np.float64 and runs[0].shape == (3, 2)


def test_cross_validate_files_and_reload(data, tmp_path, capsys):
    """``cross_validate`` writes the reference layout: the keys file is
    byte-equal to ``np.save`` of the JAX ``keys_array`` of the same
    sample; the values reload, and ``best_config`` skips a NaN row as the
    JAX one does. At n < 1, or a chunk below 1, it raises."""
    port, _ = trainers(data, batch_size=300)
    hypers = port_crossval.sample_hyperparams(3, seed=7)
    values = port_crossval.cross_validate(port, hypers, 1, seed=1,
                                          save_dir=str(tmp_path), id_="_x")
    assert "crossval [3/3]: best acc" in capsys.readouterr().out
    np.save(tmp_path / "jax_keys.npy", jax_crossval.keys_array(
        jax_crossval.sample_hyperparams(3, seed=7), 16))
    assert ((tmp_path / "cross_val_keys_x.npy").read_bytes()
            == (tmp_path / "jax_keys.npy").read_bytes())
    got_v, got_k = port_crossval.load_crossval(str(tmp_path), "_x")
    np.testing.assert_array_equal(got_v, values)
    assert np.isfinite(values).all()
    got_v[int(np.nanargmax(got_v[:, 1])), 1] = np.nan
    np.save(tmp_path / "cross_val_values_x.npy", got_v)
    back = port_crossval.load_crossval(str(tmp_path), "_x")
    np.testing.assert_array_equal(port_crossval.best_config(*back),
                                  jax_crossval.best_config(*back))
    with pytest.raises(ValueError, match="at least one config"):
        port_crossval.cross_validate(port, port_crossval.sample_hyperparams(
            0), 1, seed=1)
    with pytest.raises(ValueError, match="chunk must be at least 1"):
        port_crossval.cross_validate(port, hypers, 1, seed=1, chunk=0)


def test_resolve_chunk():
    assert port_crossval.resolve_chunk(150) == min(
        150, port_crossval.DEFAULT_SWEEP_CHUNK)
    assert port_crossval.resolve_chunk(1) == 1
