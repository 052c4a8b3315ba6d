"""PyTorch port: the softmax baseline and the glove modes (``--prediction``,
``--prediction --glove``, ``--glove_encoding``) against the JAX package:
each mode's forward, the prediction losses, one train step, the
evaluation, the stacked step, checkpoints, the reference layout of the
baseline and the CLIs.

Small width: ``n_linear=2``, ``hidden=32`` and 8 conv features (the JAX
EMG encoder takes its conv width from a subclass here, as its
``ContrastiveModel`` exposes none), on a one-person synthetic store
(train D=300, test D=8). Inputs are made with numpy from a seed or by the
JAX package (initial weights, index matrices) and handed to both sides;
the two frameworks' random streams never match, so every comparison runs
at dropout 0.
"""
from __future__ import annotations

import copy
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrastiveprosthetics_torch.cli import results as cli_results
from contrastiveprosthetics_torch.cli import train as cli_train
from contrastiveprosthetics_torch.config import DEFAULT_CONFIG as CFG
from contrastiveprosthetics_torch.data import sampler
from contrastiveprosthetics_torch.data.store import DeviceStore
from contrastiveprosthetics_torch.data.synthetic import make_processed_dataset
from contrastiveprosthetics_torch.models.clip import ContrastiveModel as PortModel
from contrastiveprosthetics_torch.models.convert import (
    architecture,
    from_flax_variables,
    load_reference_checkpoint,
    model_from_state_dict,
)
from contrastiveprosthetics_torch.results.export import export_results
from contrastiveprosthetics_torch.train import loss as port_loss
from contrastiveprosthetics_torch.train.checkpoint import (
    adam_path,
    load_checkpoint,
    save_checkpoint,
)
from contrastiveprosthetics_torch.train.engine import Hyper, Trainer, TrainState
from contrastiveprosthetics_tpu.config import DEFAULT_CONFIG as JCFG
from contrastiveprosthetics_tpu.data import sampler as jax_sampler
from contrastiveprosthetics_tpu.data.store import DeviceStore as JaxStore
from contrastiveprosthetics_tpu.models import clip as jax_clip
from contrastiveprosthetics_tpu.models import emg_net as jax_emg_net
from contrastiveprosthetics_tpu.models.clip import l2_penalty as jax_l2_penalty
from contrastiveprosthetics_tpu.results.export import (
    export_results as jax_export_results,
)
from contrastiveprosthetics_tpu.train import engine as jax_engine
from contrastiveprosthetics_tpu.train import loss as jax_loss
from contrastiveprosthetics_tpu.train.torch_export import export_state_dict

torch.set_num_threads(1)

WIDTHS = dict(n_linear=2, hidden=32, conv_features=8)
MODES = {"prediction": dict(prediction=True),
         "glove_prediction": dict(prediction=True, glove=True),
         "glove_encoding": dict(glove_encoding=True)}
# Train-mode and AdaBN outputs: each package lies about 1e-6 (absolute)
# from a float64 evaluation of the same model, so their difference
# reaches about 2e-6 near zero (test_torch_port_train.py's LOGIT_TOL)
OUT_TOL = dict(rtol=1e-5, atol=2e-6)
STATS_TOL = dict(rtol=1e-5, atol=1e-6)   # running statistics, as there
GRAD_TOL = dict(rtol=1e-4, atol=1e-7)    # the contrastive step's, as there
# weights after one Adam step from gradients equal to GRAD_TOL: Adam's
# update divides the gradient by its own magnitude, so a relative gradient
# error of 1e-4 moves the update of an entry by up to that share of lr
WEIGHT_TOL = dict(rtol=1e-5, atol=1e-6)
F64_RTOL = 1e-9  # stacked against single steps in float64 (chip_smoke's)
HYPER = (1e-3, 1e-2, 0.0, 2e-3, 3e-2, 0.0)  # dropout 0, each lr/reg its own
STACK_HYPERS = np.array([[1e-3, 1e-2, 0, 3e-3, 1e-3, 0],
                         [3e-3, 1e-5, 0, 1e-4, 1e-1, 0],
                         [1e-4, 1e-1, 0, 1e-3, 1e-6, 0]])


class _EMGNet8(jax_emg_net.EMGNet):
    conv_features: int = 8


@pytest.fixture(autouse=True)
def jax_conv_width(monkeypatch):
    """The JAX encoder at WIDTHS' conv width for this file's tests."""
    monkeypatch.setattr(jax_clip, "EMGNet", _EMGNet8)


def t(x, dtype=None) -> torch.Tensor:
    out = torch.from_numpy(np.array(x))
    return out if dtype is None else out.to(dtype)


def tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


@pytest.fixture(scope="module")
def data():
    return make_processed_dataset(CFG, people_positions=[40], seed=3)


def trainers(data, mode, adabn=False, batch_size=8):
    emg, pos, glove = data
    port = Trainer(CFG, DeviceStore(CFG, emg, pos, glove), adabn=adabn,
                   batch_size=batch_size, **WIDTHS, **MODES[mode])
    jtr = jax_engine.Trainer(JCFG, JaxStore(JCFG, emg, pos, glove),
                             adabn=adabn, batch_size=batch_size,
                             n_linear=WIDTHS["n_linear"],
                             hidden=WIDTHS["hidden"], **MODES[mode])
    return port, jtr


def port_model_of(params, batch_stats, adabn) -> PortModel:
    return model_from_state_dict(from_flax_variables(
        tree(params), tree(batch_stats), adabn=adabn, **WIDTHS))


def jax_batch(jtr, key, bs=8):
    """A train batch from the JAX key's index matrices, and the matrices."""
    v = jtr.view_train
    k_perm, k_glove, k_order = jax.random.split(key, 3)
    emg_rand = jax_sampler.task_permutations(k_perm, v.n_tasks, v.D)
    glove_rand = jax_sampler.task_permutations(k_glove, v.n_tasks, v.D_glove)
    items = jax.random.permutation(k_order, v.D)[:bs]
    return (jax_sampler.gather_train_batch(v.emg_flat, emg_rand, items),
            jax_sampler.gather_glove_batch(v.glove_flat, glove_rand, items,
                                           v.D_glove),
            (emg_rand, glove_rand, items))


def named_grads(model, grads) -> dict:
    """The gradients of ``model.towers()`` by state_dict name."""
    prefix = {id(m): name for name, m in model.named_modules()}
    out = {}
    for name, tower in model.towers().items():
        for (pname, _), g in zip(tower.named_parameters(), grads[name]):
            out[f"{prefix[id(tower)]}.{pname}"] = g
    return out


# ------------------------------------------------------------ (a) forward
@pytest.mark.parametrize("adabn", [False, True])
@pytest.mark.parametrize("mode", list(MODES))
def test_forward_matches_flax(mode, adabn):
    """Each mode's forward against ``ContrastiveModel.apply`` with the
    weights carried across: in train mode (dropout 0; the running
    statistics after) and in eval on the vote input (glove prediction has
    no vote window)."""
    model = jax_clip.ContrastiveModel(d_e=16, adabn=adabn, n_classes=41,
                                      n_linear=2, hidden=32, **MODES[mode])
    key = jax.random.PRNGKey(5)
    variables = tree(model.init({"params": key, "dropout": key},
                                jnp.zeros((2, 41, 12)), jnp.zeros((2, 41, 20)),
                                0.0, 0.0, True))
    rng = np.random.default_rng(6)
    emg = rng.standard_normal((3, 41, 12)).astype(np.float32)
    vote = rng.standard_normal((3, 41, 25, 12)).astype(np.float32)
    glove = rng.standard_normal((3, 41, 20)).astype(np.float32)
    port = port_model_of(variables["params"], variables["batch_stats"], adabn)
    assert (port.prediction, port.glove, port.glove_encoding) == (
        model.prediction, model.glove and model.prediction,
        model.glove_encoding)

    want, upd = model.apply(variables, emg, glove, 0.0, 0.0, True,
                            rngs={"dropout": key}, mutable=["batch_stats"])
    got = port.train()(t(emg), glove=t(glove))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **OUT_TOL)
    if not adabn:
        stats = from_flax_variables(tree(variables["params"]),
                                    tree(upd["batch_stats"]), **WIDTHS)
        for name, value in port.state_dict().items():
            if "running" in name:  # the idle tower's at its init in both
                np.testing.assert_allclose(value.numpy(), stats[name].numpy(),
                                           **STATS_TOL, err_msg=name)
    variables["batch_stats"] = tree(upd["batch_stats"])
    want = model.apply(variables, vote, glove, 0.0, 0.0, False,
                       mutable=["batch_stats"])[0]
    with torch.no_grad():
        got = port.eval()(t(vote), glove=t(glove))
    assert got.shape == want.shape == (
        (123, 41) if mode == "glove_prediction" else
        (123, 25, 41) if mode == "prediction" else (75, 41, 41))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)


# ---------------------------------------------- (b) the prediction losses
@pytest.mark.parametrize("tie", [False, True])
def test_prediction_losses_match_jax(tie):
    """The four prediction functions against ``train/loss.py``. With
    ``tie`` every row's W=4 frames vote 2:2 between two classes, so the
    vote goes to the smaller (counts then argmax, not ``torch.mode``)."""
    rng = np.random.default_rng(8)
    rows, W, C = 12, 4, 41
    scores = rng.uniform(-1, 1, (rows, W, C)).astype(np.float32)
    labels = rng.integers(0, C, rows)
    if tie:
        a, b = rng.integers(0, C, rows), rng.integers(0, C, rows)
        b = np.where(a == b, (b + 7) % C, b)
        for r in range(rows):
            for w in range(W):
                scores[r, w, (a[r], b[r])[w % 2]] = 2.0
        labels = np.minimum(a, b)
        labels[::3] = np.maximum(a, b)[::3]
    flat = scores.reshape(-1, C)
    flat_labels = np.repeat(labels, W)
    ts, tl, tf, tfl = t(scores), t(labels), t(flat), t(flat_labels)
    np.testing.assert_allclose(
        float(port_loss.prediction_loss(tf, tfl)),
        float(jax_loss.prediction_loss(flat, flat_labels)), rtol=1e-6)
    np.testing.assert_allclose(
        port_loss.prediction_loss_per_item(tf, tfl, rows).numpy(),
        np.asarray(jax_loss.prediction_loss_per_item(flat, flat_labels,
                                                     rows)), rtol=1e-6)
    assert float(port_loss.prediction_accuracy(tf, tfl)) == pytest.approx(
        float(jax_loss.prediction_accuracy(flat, flat_labels)), abs=1e-7)
    got = float(port_loss.prediction_vote_accuracy(ts, tl))
    assert got == pytest.approx(
        float(jax_loss.prediction_vote_accuracy(scores, labels)), abs=1e-7)
    if tie:
        assert port_loss.majority_vote(ts).tolist() == np.minimum(a,
                                                                  b).tolist()
        assert got == pytest.approx(1 - len(labels[::3]) / rows)


def test_glove_gathers_match_jax(data):
    """``gather_glove_batch`` (items modulo D_glove) is the JAX one, and
    its stacked form is it per config."""
    _, jtr = trainers(data, "glove_encoding")
    v = jtr.view_train
    rng = np.random.default_rng(4)
    rand = np.stack([jax_sampler.task_permutations(
        jax.random.PRNGKey(c), v.n_tasks, v.D_glove) for c in range(3)])
    items = rng.integers(0, v.D, (3, 8))
    items[:, 0] = v.D_glove + 3  # wraps
    flat = t(v.glove_flat)
    for c in range(3):
        want = jax_sampler.gather_glove_batch(v.glove_flat, rand[c], items[c],
                                              v.D_glove)
        got = sampler.gather_glove_batch(flat, t(rand[c], torch.long),
                                         t(items[c]), v.D_glove)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        stacked = sampler.stacked_gather_glove_batch(
            flat, t(rand, torch.long), t(items), v.D_glove)
        np.testing.assert_array_equal(stacked[c].numpy(), got.numpy())


# ----------------------------------------------------- (c) one train step
@pytest.mark.parametrize("adabn", [False, True])
@pytest.mark.parametrize("mode", list(MODES))
def test_sgd_step_matches_jax(data, mode, adabn):
    """One step at dropout 0 from the JAX state and the JAX key's EMG and
    glove batches: the loss and accuracy, every gradient of the trained
    tower against ``jax.grad`` of the JAX step's total (L2 included), and
    after ``_sgd_step`` both Adam updates' weights and the running
    statistics. The idle tower of the baseline holds no parameters, gets
    no penalty and stays as it was."""
    port, jtr = trainers(data, mode, adabn)
    jstate = jtr.init_state(jax.random.PRNGKey(6))
    state = TrainState.fresh(port_model_of(jstate.params, jstate.batch_stats,
                                           adabn))
    idle_before = copy.deepcopy(state.model.state_dict())
    jh, h = jax_engine.Hyper.single(*HYPER), Hyper.single(*HYPER)
    emg_b, glove_b, _ = jax_batch(jtr, jax.random.PRNGKey(7))

    def total(p):
        loss, aux = jtr._loss_and_metrics(p, jstate.batch_stats, emg_b,
                                          glove_b, jh, jax.random.PRNGKey(0),
                                          True)
        return (loss + jh.reg_emg * jax_l2_penalty(p.get("emg_net", {}))
                + jh.reg_glove * jax_l2_penalty(p.get("glove_net", {}))), (
            loss, aux)

    (_, (loss_j, (acc_j, _, _))), jgrads = jax.value_and_grad(
        total, has_aux=True)(jstate.params)
    glove_in = t(glove_b) if port.reads_glove else None
    loss, acc, grads = port.loss_and_grads(state, t(emg_b), h, None,
                                           glove_b=glove_in)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    assert float(acc) == pytest.approx(float(acc_j), abs=1e-6)
    want = from_flax_variables(tree(jgrads), tree(jstate.batch_stats),
                               adabn=adabn, **WIDTHS)
    got = named_grads(state.model, grads)
    trained = "glove_net." if mode == "glove_prediction" else (
        "emg_net." if mode == "prediction" else "")
    assert got and all(name.startswith(trained) for name in got)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), **GRAD_TOL,
                                   err_msg=name)

    jnew, jloss, _ = jax.jit(jtr._sgd_step)(jstate, emg_b, glove_b, jh,
                                            jh.lr_emg, jh.lr_glove,
                                            jax.random.PRNGKey(0))
    state = TrainState.fresh(port_model_of(jstate.params, jstate.batch_stats,
                                           adabn))
    loss, _ = port._sgd_step(state, t(emg_b), h, h.lr_emg, h.lr_glove, None,
                             glove_b=glove_in)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert state.opt_emg.count == state.opt_glove.count == 1
    after = from_flax_variables(tree(jnew.params), tree(jnew.batch_stats),
                                adabn=adabn, **WIDTHS)
    idle = "emg_net." if mode == "glove_prediction" else (
        "glove_net." if mode == "prediction" else None)
    for name, value in state.model.state_dict().items():
        if name == "logit_scale" or "num_batches" in name:
            continue
        if idle and name.startswith(idle):
            assert torch.equal(value, idle_before[name]), name
            continue
        tol = STATS_TOL if "running" in name else WEIGHT_TOL
        np.testing.assert_allclose(value.numpy(), after[name].numpy(), **tol,
                                   err_msg=name)


# ---------------------------------------------------------- (d) evaluation
def jax_eval_indices(jtr, key, view, bs):
    k_perm, k_glove, k_order = jax.random.split(key, 3)
    emg_rand = jax_sampler.task_permutations(k_perm, view.n_tasks, view.D)
    glove_rand = jax_sampler.task_permutations(k_glove, view.n_tasks,
                                               view.D_glove)
    batches, weights, inverse = jax_sampler.epoch_batches_padded(k_order,
                                                                 view.D, bs)
    return emg_rand, glove_rand, batches, weights, inverse


def jax_near_ties(jtr, jstate, view, indices, eps=1e-5) -> np.ndarray:
    """(D,) items with a row whose top two JAX scores (or logits) lie
    within ``eps``, batch by batch as ``_evaluate`` scores them."""
    emg_rand, glove_rand, batches, _, inverse = indices
    tied = []
    for items in batches:
        out = jtr.model.apply(
            {"params": jstate.params, "batch_stats": jstate.batch_stats},
            jax_sampler.gather_eval_batch(view.emg_groups, emg_rand, items),
            jax_sampler.gather_glove_batch(view.glove_flat, glove_rand, items,
                                           view.D_glove),
            0.0, 0.0, False, mutable=["batch_stats"])[0]
        top2 = np.sort(np.asarray(out), axis=-1)[..., -2:]
        # every layout leads with the item: (item, task[, frame]) score
        # rows, (item, frame, task) logit rows
        near = top2[..., 1] - top2[..., 0] < eps
        tied.append(near.reshape(len(items), -1).any(-1))
    return np.concatenate(tied)[np.asarray(inverse)]


def port_eval(port, state, view, indices):
    emg_rand, glove_rand, batches, weights, inverse = indices
    return port.evaluate_from_indices(
        state, view, t(emg_rand, torch.long), t(batches, torch.long),
        t(weights), t(inverse, torch.long),
        t(glove_rand, torch.long) if port.reads_glove else None)


@pytest.mark.parametrize("adabn", [False, True])
@pytest.mark.parametrize("mode", list(MODES))
def test_evaluate_matches_jax(data, mode, adabn):
    """The test split (D=8) in batches of 3 (the last padded) from the JAX
    key's EMG and glove matrices: loss, curve, y_pred, y_true and the
    logits (zeros in the baseline) against ``_evaluate``. Votes may
    differ only on rows whose JAX scores hold a near-tie."""
    port, jtr = trainers(data, mode, adabn)
    jstate = jtr.init_state(jax.random.PRNGKey(30))
    state = TrainState.fresh(port_model_of(jstate.params, jstate.batch_stats,
                                           adabn))
    jh = jax_engine.Hyper.single(*HYPER)
    key = jax.random.PRNGKey(31)
    want = jtr.evaluate(jstate, key, jh, split="test", batch_size=3)
    got = port_eval(port, state, port.view_test,
                    jax_eval_indices(jtr, key, jtr.view_test, 3))
    D, T = jtr.view_test.D, jtr.view_test.n_tasks
    np.testing.assert_allclose(float(got.loss), float(want.loss), rtol=1e-5)
    assert got.logits.shape == want.logits.shape == (D * 25, T, T)
    np.testing.assert_array_equal(got.y_true.numpy(), np.asarray(want.y_true))
    if mode == "glove_encoding":
        np.testing.assert_allclose(got.logits.numpy(),
                                   np.asarray(want.logits), rtol=1e-4,
                                   atol=1e-5)
    else:
        assert not got.logits.any() and not np.asarray(want.logits).any()
    tied = jax_near_ties(jtr, jstate, jtr.view_test,
                         jax_eval_indices(jtr, key, jtr.view_test, 3))
    print(f"items with a near-tie in the JAX scores: {int(tied.sum())}")
    np.testing.assert_array_equal(got.curve.numpy()[~tied],
                                  np.asarray(want.curve)[~tied])
    np.testing.assert_array_equal(got.y_pred.numpy()[~tied],
                                  np.asarray(want.y_pred)[~tied])
    if mode != "glove_encoding":
        assert np.all(got.curve.numpy() == got.curve.numpy()[:, :1])


def test_prediction_export_matches_jax(data, tmp_path):
    """``export_results`` of the baseline's test pass writes what the JAX
    package's writes from its own: zero logits, votes, curves and the
    set-size sweep over the zeros, file for file."""
    port, jtr = trainers(data, "prediction")
    jstate = jtr.init_state(jax.random.PRNGKey(40))
    state = TrainState.fresh(port_model_of(jstate.params, jstate.batch_stats,
                                           False))
    key = jax.random.PRNGKey(41)
    want = jtr.evaluate(jstate, key, jax_engine.Hyper.single(*HYPER),
                        split="test", batch_size=8)
    got = port_eval(port, state, port.view_test,
                    jax_eval_indices(jtr, key, jtr.view_test, 8))
    np.testing.assert_array_equal(got.y_pred.numpy(), np.asarray(want.y_pred))
    jax_export_results(want, str(tmp_path / "jax"), plot=False)
    export_results(got, str(tmp_path / "port"), plot=False)
    for stem in ("logs", "y_pred", "y_true", "voting", "confusion_matrix",
                 "mean_grasp", "min_grasp", "max_grasp", "std_grasp"):
        a = np.load(tmp_path / "port" / f"{stem}.npy")
        b = np.load(tmp_path / "jax" / f"{stem}.npy")
        assert a.shape == b.shape, stem
        np.testing.assert_array_equal(a, b, err_msg=stem)


# ------------------------------------------------------ (e) stacked step
@pytest.mark.parametrize("mode,adabn", [("prediction", False),
                                        ("glove_prediction", False),
                                        ("glove_encoding", False),
                                        ("glove_encoding", True)])
def test_stacked_step_matches_single_steps_in_float64(data, mode, adabn):
    """A stacked step of 3 configs (each its own lr and reg, dropout 0, its
    own EMG and glove batch) against the 3 single steps in float64: the
    losses, every gradient and, after both Adam chains, every parameter
    and statistic, within chip_smoke.py's 1e-9."""
    port, _ = trainers(data, mode, adabn)
    gens = [port.generator(10 + c) for c in range(3)]
    state = port.init_sweep_state(gens)
    base = copy.deepcopy(state.model).double()
    v = port.view_train
    emg_rand, glove_rand = port._stacked_permutations(gens, v)
    batches, _ = sampler.stacked_epoch_batches(gens, v.D, 8)
    emg_b = sampler.stacked_gather_train_batch(v.emg_flat, emg_rand,
                                               batches[:, 0]).double()
    glove_b = (sampler.stacked_gather_glove_batch(
        v.glove_flat, glove_rand, batches[:, 0], v.D_glove).double()
        if port.reads_glove else None)
    h = Hyper(*[torch.as_tensor(STACK_HYPERS[:, j]) for j in range(6)])
    stacked = TrainState.fresh(copy.deepcopy(base))
    loss, _, grads = port.loss_and_grads(stacked, emg_b, h, None,
                                         glove_b=glove_b)
    stepped = TrainState.fresh(copy.deepcopy(base))
    port._sgd_step(stepped, emg_b, h, h.lr_emg, h.lr_glove, None,
                   glove_b=glove_b)
    for c in range(3):
        single = TrainState.fresh(base.unstack(c).double())
        hc = Hyper(*[float(x) for x in STACK_HYPERS[c]])
        gb = None if glove_b is None else glove_b[c]
        loss_c, _, grads_c = port.loss_and_grads(single, emg_b[c], hc, None,
                                                 glove_b=gb)
        np.testing.assert_allclose(float(loss[c]), float(loss_c),
                                   rtol=1e-12)
        for tower in grads_c:
            assert len(grads[tower]) == len(grads_c[tower])
            for a, b in zip(grads[tower], grads_c[tower]):
                err = float((a[c] - b).norm() / b.norm().clamp_min(1e-300))
                assert err <= F64_RTOL, (tower, err)
        single = TrainState.fresh(base.unstack(c).double())
        port._sgd_step(single, emg_b[c], hc, hc.lr_emg, hc.lr_glove, None,
                       glove_b=gb)
        for (name, a), b in zip(stepped.model.state_dict().items(),
                                single.model.state_dict().values()):
            if a.is_floating_point():
                err = float((a[c] - b).norm() / b.norm().clamp_min(1e-300))
                assert err <= F64_RTOL, (name, err)


# ------------------------------------------------------ (f) checkpoints
@pytest.mark.parametrize("adabn", [False, True])
@pytest.mark.parametrize("mode", list(MODES))
def test_checkpoint_roundtrip_and_architecture(data, tmp_path, mode, adabn):
    """A trained state of each mode saves and reloads strictly, Adam
    chains included, and ``architecture`` reads its mode from its keys."""
    port, _ = trainers(data, mode, adabn, batch_size=32)
    gen = port.generator(3)
    state = port.init_state(gen)
    port.train_epoch(state, gen, Hyper.single(1e-3, 1e-6, 0.5, 1e-3, 1e-6,
                                              0.3))
    path = str(tmp_path / "contrastive.pt")
    save_checkpoint(path, state)
    sd = load_reference_checkpoint(path)
    arch = architecture(sd)
    assert {k: arch[k] for k in ("prediction", "glove", "glove_encoding",
                                 "adabn")} == dict(
        prediction=port.prediction, glove=port.prediction and port.glove,
        glove_encoding=port.glove_encoding, adabn=adabn)
    back = load_checkpoint(path, "cpu")
    assert set(back.model.state_dict()) == set(state.model.state_dict())
    for name, value in state.model.state_dict().items():
        assert torch.equal(back.model.state_dict()[name], value), name
    for ours, theirs in ((back.opt_emg, state.opt_emg),
                         (back.opt_glove, state.opt_glove)):
        assert ours.count == theirs.count == 10
        assert len(ours.mu) == len(theirs.mu)
        for a, b in zip(ours.mu + ours.nu, theirs.mu + theirs.nu):
            assert torch.equal(a, b)
    assert (not state.opt_emg.mu) == (mode == "glove_prediction")
    assert (not state.opt_glove.mu) == (mode == "prediction")
    assert torch.load(adam_path(path), weights_only=True)


# ------------------------------------------- (g) the reference layout
@pytest.mark.parametrize("adabn", [False, True])
def test_jax_prediction_export_loads_into_the_port(data, adabn):
    """A JAX baseline state written in the reference layout by the JAX
    ``torch_export.export_state_dict`` (its glove tower synthesized) loads
    strictly into the port, which gives the JAX scores."""
    _, jtr = trainers(data, "prediction", adabn)
    jstate = jtr.init_state(jax.random.PRNGKey(50))
    sd, meta = export_state_dict(tree(jstate.params),
                                 tree(jstate.batch_stats), adabn=adabn,
                                 prediction=True)
    assert meta["prediction"] and "glove_net.last.4.weight" in sd
    port = model_from_state_dict({k: torch.from_numpy(np.array(v))
                                  for k, v in sd.items()}).eval()
    assert port.prediction and not port.glove
    emg_b, glove_b, _ = jax_batch(jtr, jax.random.PRNGKey(51))
    want = jtr.model.apply(
        {"params": jstate.params, "batch_stats": jstate.batch_stats},
        emg_b, glove_b, 0.0, 0.0, False, mutable=["batch_stats"])[0]
    with torch.no_grad():
        got = port(t(emg_b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)
    ours = from_flax_variables(tree(jstate.params), tree(jstate.batch_stats),
                               adabn=adabn, **WIDTHS)
    assert set(ours) == set(sd)


# ------------------------------------------------------------------ CLIs
def _one_person(args, cfg, device):
    emg, pos, glove = make_processed_dataset(cfg, people_positions=[40])
    return DeviceStore(cfg, emg, pos, glove, device=device)


@pytest.mark.parametrize("flags", [
    ["--prediction"], ["--prediction", "--glove"],
    ["--glove_encoding", "--per_subject_eval"], ["--glove"],
    ["--glove_encoding", "--crossval_size", "2"]])
def test_cli_modes_train_test_and_results(tmp_path, monkeypatch, capsys,
                                          flags):
    """``cptorch-train --platform cpu --synthetic --final_epochs 1 --test
    --results_dir A`` in each mode (the canonical hyperparameters, or a
    2-config sweep) at full width on a one-person store: the checkpoint
    loads strictly in its mode, and ``cptorch-results`` with the same
    flags writes the same artifacts into B. ``--glove`` alone trains the
    one-hot contrastive model, as in the JAX CLI."""
    monkeypatch.setattr(cli_train, "build_store", _one_person)
    monkeypatch.setattr(cli_results, "build_store", _one_person)
    a, b = str(tmp_path / "A"), str(tmp_path / "B")
    common = ["--synthetic", "--batch_size", "150", "--no_adabn",
              "--platform", "cpu", "--data_dir", str(tmp_path),
              "--checkpoint_dir", str(tmp_path), *flags]
    if "--crossval_size" not in flags:
        common += ["--crossval_size", "0"]
    assert cli_train.main([*common, "--final_epochs", "1", "--test",
                           "--results_dir", a]) == 0
    out = capsys.readouterr().out
    assert "Epoch 0." in out and f"artifacts exported to {a}" in out
    model = model_from_state_dict(load_reference_checkpoint(
        str(tmp_path / "contrastive.pt")))
    prediction = "--prediction" in flags
    assert (model.prediction, model.glove, model.glove_encoding) == (
        prediction, prediction and "--glove" in flags,
        "--glove_encoding" in flags)
    if "--crossval_size" in flags:
        assert np.load(tmp_path / "cross_val_values.npy").shape == (2, 2)
    else:  # results needs a crossval cache, as cptpu-results does
        keys = np.array([[16, 1e-3, 1e-6, 0.5, 1e-3, 1e-6, 0.3]])
        np.save(tmp_path / "cross_val_keys.npy", keys)
        np.save(tmp_path / "cross_val_values.npy", np.zeros((1, 2)))
    assert cli_results.main([*common, "--results_dir", b]) == 0
    for stem in ("logs", "y_pred", "y_true", "voting", "mean_grasp"):
        np.testing.assert_array_equal(np.load(f"{a}/{stem}.npy"),
                                      np.load(f"{b}/{stem}.npy"),
                                      err_msg=stem)
    logs = np.load(f"{a}/logs.npy")
    assert logs.shape == (8 * 25, 41, 41) and (logs.any() != prediction)
    if "--per_subject_eval" in flags:
        assert np.load(f"{a}/per_subject_acc.npy").shape == (1,)


@pytest.mark.parametrize("flags", [
    ["--prediction", "--fused_train", "on"],
    ["--prediction", "--glove", "--fused_encoder"],
    ["--glove_encoding", "--fused_encoder"],
    ["--prediction", "--fused_train", "on", "--crossval_size", "2"]])
def test_cli_ineligible_fused_requests_warn_and_run_unfused(
        tmp_path, monkeypatch, flags):
    """A fused path requested in a mode it cannot take warns and the run
    goes on unfused (``engine.py:229-240,643-657``), the sweep included."""
    monkeypatch.setattr(cli_train, "build_store", _one_person)
    argv = ["--synthetic", "--batch_size", "150", "--no_adabn",
            "--platform", "cpu", "--data_dir", str(tmp_path),
            "--checkpoint_dir", str(tmp_path), "--final_epochs", "1",
            "--test", "--no_verbose", *flags]
    if "--crossval_size" not in flags:
        argv += ["--crossval_size", "0"]
    with pytest.warns(UserWarning, match="requested but"):
        assert cli_train.main(argv) == 0


def test_cli_mode_flags_must_match_the_checkpoint(tmp_path, monkeypatch):
    """``cptorch-results --prediction`` on a contrastive checkpoint names
    the flags the checkpoint was trained with; ``--per_subject_eval`` with
    ``--prediction`` exits before any store is built."""
    monkeypatch.setattr(cli_results, "build_store", _one_person)
    save_checkpoint(str(tmp_path / "contrastive.pt"),
                    TrainState.fresh(PortModel(**WIDTHS)))
    np.save(tmp_path / "cross_val_keys.npy",
            np.array([[16, 1e-3, 1e-6, 0.5, 1e-3, 1e-6, 0.3]]))
    np.save(tmp_path / "cross_val_values.npy", np.zeros((1, 2)))
    common = ["--synthetic", "--platform", "cpu", "--no_adabn",
              "--data_dir", str(tmp_path), "--checkpoint_dir", str(tmp_path)]
    with pytest.raises(SystemExit, match="holds a model of the flags none"):
        cli_results.main([*common, "--prediction"])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(SystemExit, match="--per_subject_eval"):
            cli_train.main([*common, "--prediction", "--per_subject_eval"])


@pytest.mark.parametrize("mode", ["prediction", "glove_encoding"])
def test_cli_serve_rejects_a_non_contrastive_checkpoint(tmp_path, mode):
    """The serve path scores EMG against one-hot class embeddings, as the
    JAX one does: a baseline or glove-encoding checkpoint exits with its
    reason instead of serving wrong scores."""
    from contrastiveprosthetics_torch.cli import serve as cli_serve

    path = str(tmp_path / "contrastive.pt")
    save_checkpoint(path, TrainState.fresh(PortModel(**WIDTHS,
                                                     **MODES[mode])))
    with pytest.raises(SystemExit, match="one-hot class embeddings"):
        cli_serve.main(["--checkpoint", path, "--demo", "--platform", "cpu",
                        "--quiet", "--data_dir", str(tmp_path)])
