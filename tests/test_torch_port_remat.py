"""PyTorch port: ``Trainer(remat=True)``, the forward recomputed in the
backward (the JAX package's ``Trainer(remat=True)``, ``jax.checkpoint``
over the loss, ``train/engine.py:168,396-410``).

Remat changes where the activations come from, not what a step computes:
against ``remat=False`` every result is held bit for bit (parameters,
running statistics, both Adam chains, losses, accuracies and the
generator the dropout masks came from), eager and fused, f32 and bf16,
single and stacked, in each mode. Against the JAX package's remat trainer
a step is held at the tolerances its non-remat step is held to
(``test_torch_port_train.py``, ``test_torch_port_train_fused.py``,
``test_torch_port_crossval.py``). Small width (n_linear 2, hidden 64), a
one-person synthetic store.
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
from contrastiveprosthetics_torch.models.convert import from_flax_variables
from contrastiveprosthetics_torch.ops import kernels as K
from contrastiveprosthetics_torch.ops import train_fused as TF
from contrastiveprosthetics_torch.train.engine import Hyper, Trainer
from contrastiveprosthetics_tpu.config import DEFAULT_CONFIG as JCFG
from contrastiveprosthetics_tpu.data import sampler as jax_sampler
from contrastiveprosthetics_tpu.data.store import DeviceStore as JaxStore
from contrastiveprosthetics_tpu.train import engine as jax_engine
from test_torch_port_crossval import (
    HYPERS,
    assert_first_step_matches,
    first_moments,
    jax_batches,
    jax_first_moments,
    jax_hyper,
    port_hyper,
    stacked_jax_state_dict,
    stacked_state,
    to_long,
)
from test_torch_port_train import port_state, t
from test_torch_port_train_fused import assert_grads_close

torch.set_num_threads(1)

SMALL = dict(n_linear=2, hidden=64)
DROP = (1e-3, 1e-3, 0.5, 1e-3, 1e-3, 0.3)  # dropout on in both towers
# each trainer's switches: the paths and modes a step runs
CASES = {
    "eager": {},
    "fused": dict(use_fused_train=True),
    "eager-bf16": dict(compute_dtype="bfloat16"),
    "fused-bf16": dict(use_fused_train=True, compute_dtype="bfloat16",
                       adam_mu_dtype="bfloat16"),
    "fused-adabn": dict(use_fused_train=True, adabn=True),
    "fused-glove-encoding": dict(use_fused_train=True, glove_encoding=True),
    "prediction-glove": dict(prediction=True, glove=True),
}


@pytest.fixture(scope="module")
def data():
    return make_processed_dataset(CFG, people_positions=[40], seed=3)


@pytest.fixture(scope="module")
def store(data):
    return DeviceStore(CFG, *data)


def trainer(store, remat, **kw) -> Trainer:
    kw = {"adabn": False, **kw}
    return Trainer(CFG, store, batch_size=32, remat=remat, **SMALL, **kw)


def run(store, remat, stacked, **kw):
    """Three steps of one config (an epoch's first three batches) or of a
    3-config chunk, dropout on, masks from one generator. Returns the
    state, the losses and accuracies, and that generator."""
    tr = trainer(store, remat, **kw)
    gen = tr.generator(5)
    v = tr.view_train
    if stacked:
        gens = [tr.generator(10 + c) for c in range(3)]
        state = tr.init_sweep_state(gens)
        emg_rand, glove_rand = tr._stacked_permutations(gens, v)
        batches, tail = sampler.stacked_epoch_batches(gens, v.D, 32)
        hy = HYPERS.copy()
        hy[:, 2], hy[:, 5] = (0.5, 0.4, 0.6), (0.3, 0.0, 0.9)
        losses, accs = tr.sweep_epoch_from_indices(
            state, emg_rand, batches[:, :3], tail[:, :0], port_hyper(hy),
            1.0, 1.0, gen, glove_rand)
    else:
        state = tr.init_state(tr.generator(1))
        emg_rand, glove_rand = tr._permutations(gen, v)
        batches, tail = sampler.epoch_batches(gen, v.D, 32)
        losses, accs = tr.train_epoch_from_indices(
            state, emg_rand, batches[:3], tail[:0], Hyper.single(*DROP), 1.0,
            1.0, gen, glove_rand=glove_rand)
    return state, losses, accs, gen


def adam_tensors(state):
    return [x for opt in (state.opt_emg, state.opt_glove)
            for x in (*opt.mu, *opt.nu)]


@pytest.mark.parametrize("stacked", [False, True], ids=["single", "stacked"])
@pytest.mark.parametrize("case", list(CASES))
def test_remat_is_bit_equal_to_the_stored_forward(store, case, stacked):
    """Three steps with dropout on, remat off and on: every parameter and
    running statistic, both Adam chains (the step counts too), the losses
    and accuracies, and the generator's state after them, bit for bit."""
    (s0, l0, a0, g0), (s1, l1, a1, g1) = (
        run(store, remat, stacked, **CASES[case]) for remat in (False, True))
    assert torch.equal(l0, l1) and torch.equal(a0, a1)
    sd0, sd1 = s0.model.state_dict(), s1.model.state_dict()
    assert sd0.keys() == sd1.keys()
    for name in sd0:
        assert torch.equal(sd0[name], sd1[name]), name
    assert s0.opt_emg.count == s1.opt_emg.count == 3
    for x0, x1 in zip(adam_tensors(s0), adam_tensors(s1), strict=True):
        assert torch.equal(x0, x1)
    assert torch.equal(g0.get_state(), g1.get_state())
    # the steps did move the statistics (once each: bit-equal above)
    if not CASES[case].get("adabn") and not CASES[case].get("prediction"):
        fresh = trainer(store, False, **CASES[case]).init_state(
            torch.Generator().manual_seed(1)).model.state_dict()
        name = "emg_net.linear.2.running_mean"
        assert not torch.equal(sd1[name][0] if stacked else sd1[name],
                               fresh[name])


def test_remat_recomputes_the_forward_in_the_backward(store, monkeypatch):
    """Per fused step the forward's plain kernels (K5f per block, the tail
    forward, K1's forward) run twice with remat, once without; the
    backward's (K5b per block, the tail backward) once either way."""
    calls = dict.fromkeys(("fwd", "bwd", "tail_fwd", "tail_bwd", "k1"), 0)

    def counting(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    for name, mod, attr in (
            ("fwd", TF, "dense_block_fwd_reference"),
            ("bwd", TF, "dense_block_bwd_reference"),
            ("tail_fwd", TF, "chain_tail_fwd_reference"),
            ("tail_bwd", TF, "chain_tail_bwd_reference"),
            ("k1", K, "fused_contrastive_reference")):
        monkeypatch.setattr(mod, attr, counting(name, getattr(mod, attr)))
    got = {}
    for remat in (False, True):
        calls.update(dict.fromkeys(calls, 0))
        tr = trainer(store, remat, use_fused_train=True)
        state = tr.init_state(tr.generator(1))
        v = tr.view_train
        emg_b = v.emg_flat[:8 * v.n_tasks].reshape(8, v.n_tasks, -1)
        tr._sgd_step(state, emg_b, Hyper.single(*DROP), 1e-3, 1e-3,
                     tr.generator(2))
        got[remat] = dict(calls)
    L = SMALL["n_linear"]
    assert got[False] == dict(fwd=L, bwd=L, tail_fwd=1, tail_bwd=1, k1=1)
    assert got[True] == dict(fwd=2 * L, bwd=L, tail_fwd=2, tail_bwd=1, k1=2)


# ----------------------------------------------------- against JAX's remat
def jax_trainers(data, fused, adabn=False, batch_size=8):
    """The port's remat trainer and the JAX package's. JAX's remat over
    its fused chain in Pallas interpret mode (the CPU's) stops at
    ``jax.checkpoint``'s partial evaluation ("Effects not supported in
    partial-eval of checkpoint/remat": the interpreter's ordered IO
    effect), so the fused port step is held against JAX's fused step
    without remat, which ``jax.checkpoint`` leaves the same function."""
    port = Trainer(CFG, DeviceStore(CFG, *data), adabn=adabn,
                   batch_size=batch_size, remat=True, use_fused_train=fused,
                   **SMALL)
    jtr = jax_engine.Trainer(JCFG, JaxStore(JCFG, *data), adabn=adabn,
                             batch_size=batch_size, remat=not fused,
                             use_fused_train=fused, **SMALL)
    return port, jtr


def jax_state_dict(tree, batch_stats, adabn):
    return from_flax_variables(jax.tree_util.tree_map(np.asarray, tree),
                               jax.tree_util.tree_map(np.asarray,
                                                      batch_stats),
                               adabn=adabn)


@pytest.mark.parametrize("fused", [False, True], ids=["eager", "fused"])
def test_remat_step_matches_jax_remat_step(data, fused):
    """One step of ``Trainer(remat=True)`` at dropout 0 against the JAX
    ``Trainer(remat=True)._sgd_step`` (fused: without remat, see
    :func:`jax_trainers`) from the same weights: the loss
    (rtol 1e-5), the gradients read off Adam's first moments (mu = (1 -
    b1) g after one step; the eager step's rtol 1e-4, atol 1e-7 of
    ``test_sgd_step_gradients_match_jax``, the fused step's rtol 1e-3,
    atol 1e-4 x max of ``test_fused_step_with_masks_matches_jax_step``)
    and the running statistics (rtol 1e-5, atol 1e-6)."""
    port, jtr = jax_trainers(data, fused)
    jstate = jtr.init_state(jax.random.PRNGKey(6))
    state = port_state(jstate, adabn=False)
    hyper = (1e-3, 1e-2, 0.0, 1e-3, 3e-2, 0.0)
    jh, h = jax_engine.Hyper.single(*hyper), Hyper.single(*hyper)
    v = jtr.view_train
    k_perm, k_order = jax.random.split(jax.random.PRNGKey(7))
    emg_rand = jax_sampler.task_permutations(k_perm, v.n_tasks, v.D)
    items = jax.random.permutation(k_order, v.D)[:8]
    emg_b = jax_sampler.gather_train_batch(v.emg_flat, emg_rand, items)
    glove_b = jnp.zeros((8, v.n_tasks, JCFG.glove_dim))
    new, loss_j, acc_j = jtr._sgd_step(jstate, emg_b, glove_b, jh,
                                       jh.lr_emg, jh.lr_glove,
                                       jax.random.PRNGKey(0))
    loss, acc = port._sgd_step(state, t(emg_b), h, h.lr_emg, h.lr_glove,
                               None)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    assert float(acc) == pytest.approx(float(acc_j), abs=1e-6)
    want = jax_state_dict({"emg_net": new.opt_emg.mu,
                           "glove_net": new.opt_glove.mu}, new.batch_stats,
                          adabn=False)
    got = first_moments(state)
    if fused:
        assert_grads_close([g.numpy() for g in got.values()],
                           [want[n].numpy() for n in got], 1e-3, 1e-4,
                           list(got))
    else:
        for name, mu in got.items():
            np.testing.assert_allclose(mu.numpy(), want[name].numpy(),
                                       rtol=1e-4, atol=1e-8, err_msg=name)
    stats = jax_state_dict(new.params, new.batch_stats, adabn=False)
    for name, value in state.model.state_dict().items():
        if "running" in name:
            np.testing.assert_allclose(value.numpy(), stats[name].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=name)


def test_remat_stacked_step_matches_jax_vmap_of_remat_steps(data):
    """A stacked step of 3 configs with ``remat=True`` against ``jax.vmap``
    of the JAX ``Trainer(remat=True)._sgd_step``, at dropout 0: loss,
    accuracy, every parameter after Adam, the first moments and the
    running statistics, as ``test_stacked_step_matches_jax_vmap`` holds
    the stacked step without remat."""
    port, jtr = jax_trainers(data, fused=False)
    jstates = jax.vmap(jtr.init_state)(jax.random.split(
        jax.random.PRNGKey(6), 3))
    state = stacked_state(jstates, adabn=False)
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
    loss, acc = port._sgd_step(state, got_b, h, h.lr_emg, h.lr_glove, None)
    np.testing.assert_allclose(loss.numpy(), np.asarray(loss_j), rtol=1e-5)
    np.testing.assert_allclose(acc.numpy(), np.asarray(acc_j), atol=1e-6)
    assert_first_step_matches(state, stacked_jax_state_dict(new, False),
                              jax_first_moments(new, False), h.lr_emg,
                              h.lr_glove)
