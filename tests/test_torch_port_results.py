"""PyTorch port: the evaluation and results slice against the JAX package
(the set-size sweep, the xlsx files, the fused-encoder evaluation, the
per-subject evaluation, the artifact export, the parity check and the
``cptorch-train``/``cptorch-results``/``cptorch-parity`` round trip).

Inputs come from numpy seeds or from the JAX package (weights, index
matrices) and are handed to both sides. Small width is ``n_linear=2,
hidden=64``; the stores hold two synthetic people (one for the CLIs).
"""
from __future__ import annotations

import functools
import os
import shutil
import tempfile
import warnings

import jax
import numpy as np
import pytest
import torch

from contrastiveprosthetics_torch.cli import parity as cli_parity
from contrastiveprosthetics_torch.cli import results as cli_results
from contrastiveprosthetics_torch.cli import train as cli_train
from contrastiveprosthetics_torch.config import DEFAULT_CONFIG as CFG
from contrastiveprosthetics_torch.data.sampler import (
    gather_eval_batch,
    identity_permutations,
)
from contrastiveprosthetics_torch.data.store import DeviceStore
from contrastiveprosthetics_torch.data.synthetic import make_processed_dataset
from contrastiveprosthetics_torch.eval import subset_sweep as port_sweep
from contrastiveprosthetics_torch.ops import kernels as K
from contrastiveprosthetics_torch.results import export as port_export
from contrastiveprosthetics_torch.results import parity as port_parity
from contrastiveprosthetics_torch.train import crossval as port_crossval
from contrastiveprosthetics_torch.train import engine as port_engine
from contrastiveprosthetics_torch.train.engine import EvalResult, Hyper, Trainer
from contrastiveprosthetics_torch.utils import xlsx as port_xlsx
from contrastiveprosthetics_tpu.cli import parity as jax_cli_parity
from contrastiveprosthetics_tpu.config import DEFAULT_CONFIG as JCFG
from contrastiveprosthetics_tpu.data import sampler as jax_sampler
from contrastiveprosthetics_tpu.data.store import DeviceStore as JaxStore
from contrastiveprosthetics_tpu.eval import subset_sweep as jax_sweep
from contrastiveprosthetics_tpu.results import export as jax_export
from contrastiveprosthetics_tpu.results import parity as jax_parity
from contrastiveprosthetics_tpu.train import engine as jax_engine
from contrastiveprosthetics_tpu.utils import xlsx as jax_xlsx
from test_torch_port_train import LOGIT_TOL, SMALL, port_state, t

torch.set_num_threads(1)

ARTIFACTS = ("logs", "y_pred", "y_true", "voting", "confusion_matrix",
             "mean_grasp", "min_grasp", "max_grasp", "std_grasp")
SHEETS = ("voting", "voting_avg", "voting_std", "confusion_matrix",
          "mean_grasp", "min_grasp", "max_grasp", "std_grasp")
# a near-tie: the top two JAX scores of a row closer than this may order
# the other way in the port (the eval's logit tolerance, LOGIT_TOL)
NEAR_TIE = 1e-5
# Per-subject AdaBN logits: each subject's 8 items x 41 tasks x 25 frames
# (8,200 rows) are normalised by their own batch statistics, larger
# reductions than LOGIT_TOL's; each package then lies up to about 2e-6
# from a float64 evaluation (port 1.6e-6, JAX 2.0e-6 on this test's
# data), so the two differ by up to about twice that.
PER_SUBJECT_TOL = dict(rtol=1e-5, atol=4e-6)


@pytest.fixture(scope="module")
def data():
    return make_processed_dataset(CFG, people_positions=[40, 41], seed=3)


def trainers(data, adabn=False, fused=None, batch_size=5):
    emg, pos, glove = data
    port = Trainer(CFG, DeviceStore(CFG, emg, pos, glove), adabn=adabn,
                   batch_size=batch_size, use_fused_encoder=fused, **SMALL)
    jtr = jax_engine.Trainer(JCFG, JaxStore(JCFG, emg, pos, glove),
                             adabn=adabn, batch_size=batch_size,
                             use_fused_encoder=fused, **SMALL)
    return port, jtr


def jax_state(jtr, adabn, seed=30):
    """A JAX state; under plain BatchNorm with running statistics drawn
    from a numpy generator, so the fold's BN affines are not the
    identity."""
    jstate = jtr.init_state(jax.random.PRNGKey(seed))
    if adabn:
        return jstate
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map(np.asarray, jstate.batch_stats)
    for bn in stats["emg_net"].values():
        w = bn["BatchNorm_0"]["mean"].shape[0]
        bn["BatchNorm_0"]["mean"] = rng.normal(0, 0.2, w).astype(np.float32)
        bn["BatchNorm_0"]["var"] = rng.uniform(0.5, 2, w).astype(np.float32)
    return jstate._replace(batch_stats=stats)


def jax_indices(jtr, key, batch_size=5):
    """The JAX test evaluation's index matrices (``engine.py:637-640``)."""
    v = jtr.view_test
    k_perm, _, k_order = jax.random.split(key, 3)
    emg_rand = jax_sampler.task_permutations(k_perm, v.n_tasks, v.D)
    batches, weights, inverse = jax_sampler.epoch_batches_padded(
        k_order, v.D, batch_size)
    return (t(emg_rand, torch.long), t(batches, torch.long), t(weights),
            t(inverse, torch.long))


def near_tie_items(logits, D):
    top2 = np.sort(np.asarray(logits), axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0] < NEAR_TIE).reshape(D, -1).any(-1)


def assert_eval_close(got, want, D, tol=LOGIT_TOL):
    """Loss and logits at the eval's tolerance; curves and votes equal
    except on items whose reference logits hold a near-tie."""
    np.testing.assert_allclose(float(got.loss), float(want.loss), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(got.logits), np.asarray(want.logits),
                               **tol)
    tied = near_tie_items(want.logits, D)
    for name in ("curve", "y_pred"):
        np.testing.assert_array_equal(np.asarray(getattr(got, name))[~tied],
                                      np.asarray(getattr(want, name))[~tied],
                                      err_msg=name)
    np.testing.assert_array_equal(np.asarray(got.y_true),
                                  np.asarray(want.y_true))


def seeded_logits(seed, rows=40):
    """(rows, 41, 41) scores rounded to halves, so ties are everywhere,
    with the true class favoured."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, 41, 41)).astype(np.float32)
    x[:, np.arange(41), np.arange(41)] += 1.0
    return np.round(x * 2) / 2


# ------------------------------------------------------------ the sweep
@pytest.mark.parametrize("seed,trials", [(0, 144), (3, 7), (11, 1)])
def test_subset_masks_match_jax(seed, trials):
    got = port_sweep._subset_masks(np.random.default_rng(seed), 41, trials)
    want = jax_sweep._subset_masks(np.random.default_rng(seed), 41, trials)
    assert got.shape == (40, trials, 41)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed,trials", [(0, 144), (1, 16), (2, 5), (5, 3)])
def test_subset_size_sweep_is_bit_equal_to_jax(seed, trials):
    """Every field, dtype and bit of the JAX sweep, on scores full of
    ties; seed 5 adds NaNs, -inf and the float32 minimum (a left-out
    class's score) on and off the true class."""
    logits = seeded_logits(seed)
    if seed == 5:
        low = np.finfo(np.float32).min
        logits[0, 3, 5] = logits[1, 7, 7] = np.nan
        logits[2, 4, :] = logits[4, 2, 2] = -np.inf
        logits[3, 9, 9] = logits[3, 9, 1] = low
        logits[5, 6, :3] = np.nan
    want = jax_sweep.subset_size_sweep(logits, trials=trials, seed=seed)
    for got in (port_sweep.subset_size_sweep(logits, trials, seed),
                port_sweep.subset_size_sweep(torch.from_numpy(logits), trials,
                                             seed)):
        for name in want._fields:
            a, b = getattr(got, name), np.asarray(getattr(want, name))
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_sweep_counts_do_not_depend_on_the_chunk(monkeypatch):
    """The masks taken 3 at a time (a ragged last chunk) count what one
    chunk of all of them counts."""
    flat = torch.from_numpy(seeded_logits(7, rows=6)).reshape(-1, 41)
    masks = torch.from_numpy(
        port_sweep._subset_masks(np.random.default_rng(0), 41, 4)
        .reshape(-1, 41))
    whole = port_sweep.sweep_counts(flat, masks)
    true, beats, left_out = port_sweep._row_keys(flat)
    n_keys = len(torch.unique(torch.cat([true[:, None], beats, left_out], 1),
                              dim=0))
    assert masks.shape[0] % 3 and beats.shape[1] == 1
    monkeypatch.setattr(port_sweep, "CHUNK_ELEMENTS", 3 * n_keys)
    chunked = port_sweep.sweep_counts(flat, masks)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


# ---------------------------------------------------------------- xlsx
@pytest.mark.parametrize("shape", [(41,), (7, 3), (2, 30)])
def test_xlsx_sheets_read_back_equal_across_packages(tmp_path, shape):
    """A sheet written by either package reads back the same through
    either reader (contents, not bytes: zip entries carry a time)."""
    data = np.random.default_rng(len(shape)).standard_normal(shape)
    data.flat[0] = 0.1  # a value that repr must round-trip
    paths = {}
    for name, mod in (("port", port_xlsx), ("jax", jax_xlsx)):
        paths[name] = str(tmp_path / f"{name}.xlsx")
        mod.write_xlsx(paths[name], data)
    want = data.reshape(data.shape[0], -1)
    for path in paths.values():
        for reader in (port_xlsx.read_xlsx, jax_xlsx.read_xlsx):
            np.testing.assert_array_equal(reader(path), want)


# ---------------------------------------------------- fused-encoder eval
def test_fused_encoder_eval_matches_jax_interpret_mode(data):
    """The port's fused evaluation (the plain chain on the CPU) against
    the JAX ``_evaluate`` with ``use_fused_encoder=True`` (the Pallas
    kernel in interpret mode), from the JAX key's index matrices: test
    split D=16 in batches of 5, the last padded."""
    port, jtr = trainers(data, fused=True)
    jstate = jax_state(jtr, adabn=False)
    key = jax.random.PRNGKey(31)
    jh = jax_engine.Hyper.single(1e-3, 1e-6, 0.0, 1e-3, 1e-6, 0.0)
    want = jtr.evaluate(jstate, key, jh, split="test", batch_size=5)
    got = port.evaluate_from_indices(port_state(jstate, False),
                                     port.view_test, *jax_indices(jtr, key))
    assert isinstance(got, EvalResult)
    assert_eval_close(got, want, port.view_test.D)


def test_fused_encoder_eval_matches_the_unfused_eval(data):
    """The fused and the unfused evaluation of one state from one index
    draw: the same items, the same scores to the eval's tolerance."""
    port, jtr = trainers(data, fused=True)
    state = port_state(jax_state(jtr, adabn=False), False)
    plain = Trainer(CFG, port.store, adabn=False, batch_size=5, **SMALL)
    got = port.evaluate(state, port.generator(3), None, "test")
    want = plain.evaluate(state, plain.generator(3), None, "test")
    assert got.logits.shape == (16 * 25, 41, 41)
    assert_eval_close(got, want, port.view_test.D)


def test_fused_encoder_on_an_ineligible_config_warns_as_jax(data):
    """An explicit request under AdaBN warns with the JAX text (the
    path's name aside) and runs the unfused evaluation."""
    port, jtr = trainers(data, adabn=True, fused=True)
    jstate = jax_state(jtr, adabn=True)
    key = jax.random.PRNGKey(31)
    jh = jax_engine.Hyper.single(1e-3, 1e-6, 0.0, 1e-3, 1e-6, 0.0)
    with pytest.warns(UserWarning) as jax_warned:
        jtr.evaluate(jstate, key, jh, split="test", batch_size=5)
    state = port_state(jstate, True)
    with pytest.warns(UserWarning) as port_warned:
        got = port.evaluate_from_indices(state, port.view_test,
                                         *jax_indices(jtr, key))
    (theirs,) = [str(w.message) for w in jax_warned
                 if "use_fused_encoder" in str(w.message)]
    (ours,) = [str(w.message) for w in port_warned]
    assert ours == theirs.replace("the XLA path", "the unfused path")
    plain = Trainer(CFG, port.store, adabn=True, batch_size=5, **SMALL)
    want = plain.evaluate_from_indices(state, plain.view_test,
                                       *jax_indices(jtr, key))
    assert torch.equal(got.logits, want.logits)


def test_the_sweep_with_the_fused_encoder_on_adabn_warns_and_runs_unfused(
        data):
    """AdaBN is ineligible for the fused encoder: the sweep's validation
    warns and runs unfused (the eligible sweep runs the kernels:
    ``test_torch_port_sweep_fused.py``)."""
    hyper = Hyper(*[np.full(2, v, np.float32) for v in
                    (1e-3, 1e-6, 0.0, 1e-3, 1e-6, 0.0)])
    adabn, _ = trainers(data, adabn=True, fused=True)
    with pytest.warns(UserWarning, match="ineligible"):
        loss, acc = adabn.sweep_chunk(
            hyper, [adabn.generator(i) for i in range(2)], [], [], None)
    assert loss.shape == acc.shape == (2,)


# ---------------------------------------------------- per-subject eval
@pytest.mark.parametrize("adabn", [False, True])
def test_evaluate_per_subject_matches_jax(data, adabn):
    """One batch per subject (2 subjects of 8 test items), identity
    gathers: under AdaBN each subject's own batch statistics."""
    port, jtr = trainers(data, adabn=adabn)
    jstate = jax_state(jtr, adabn)
    jh = jax_engine.Hyper.single(1e-3, 1e-6, 0.0, 1e-3, 1e-6, 0.0)
    want = jtr.evaluate_per_subject(jstate, jax.random.PRNGKey(0), jh)
    state = port_state(jstate, adabn)
    got = port.evaluate_per_subject(state, None)
    assert got.curve.shape == (16, CFG.n_voting_cols)
    assert_eval_close(got, want, port.view_test.D, PER_SUBJECT_TOL)
    np.testing.assert_allclose(float(got.accuracy), float(want.accuracy),
                               atol=1 / 16)
    # the port's subjects, one float64 batch each
    v = port.view_test
    model = state.model.double().eval()
    ids = identity_permutations(v.n_tasks, v.D)
    with torch.no_grad():
        want64 = torch.cat([model(gather_eval_batch(v.emg_groups.double(),
                                                    ids, items))
                            for items in torch.arange(v.D).reshape(2, -1)])
    np.testing.assert_allclose(got.logits.numpy(), want64.numpy(),
                               **LOGIT_TOL)


# -------------------------------------------------------------- export
def test_export_matches_jax_on_the_same_result(data, tmp_path, capsys):
    """One evaluation result exported by both packages: every ``.npy``
    equal (the sweep's bit for bit), with the same dtype and shape, and
    every sheet reads back equal; the per-subject files too."""
    _, jtr = trainers(data)
    jstate = jax_state(jtr, adabn=False)
    jh = jax_engine.Hyper.single(1e-3, 1e-6, 0.0, 1e-3, 1e-6, 0.0)
    jres = jtr.evaluate(jstate, jax.random.PRNGKey(31), jh, split="test",
                        batch_size=5)
    pres = EvalResult(*[t(x) for x in jres])
    dirs = {name: str(tmp_path / name) for name in ("port", "jax")}
    summary = port_export.export_results(pres, dirs["port"])
    jax_export.export_results(jres, dirs["jax"])
    people = np.array([41, 40])
    port_export.export_per_subject(pres, dirs["port"], people)
    jax_export.export_per_subject(jres, dirs["jax"], people)
    for stem in ARTIFACTS + ("per_subject_acc",):
        a, b = (np.load(os.path.join(d, f"{stem}.npy")) for d in
                (dirs["port"], dirs["jax"]))
        assert a.dtype == b.dtype and a.shape == b.shape, stem
        np.testing.assert_array_equal(a, b, err_msg=stem)
    for stem in SHEETS + ("per_subject_acc",):
        a, b = (port_xlsx.read_xlsx(os.path.join(d, f"{stem}.xlsx"))
                for d in (dirs["port"], dirs["jax"]))
        np.testing.assert_array_equal(a, b, err_msg=stem)
    assert np.load(os.path.join(dirs["port"], "logs.npy")).shape == (
        16 * 25, 41, 41)
    assert summary["sweep_mean"][0] == 0.0
    assert os.path.exists(os.path.join(dirs["port"], "results.png")) == (
        os.path.exists(os.path.join(dirs["jax"], "results.png")))


# -------------------------------------------------------------- parity
def artifact_dir(path) -> str:
    """The minimal artifact set of ``tests/test_parity_cli.py``."""
    os.makedirs(path)
    rng = np.random.default_rng(0)
    groups, classes = 48, 41
    y_true = np.tile(np.arange(classes), groups)
    y_pred = y_true.copy()
    wrong = rng.choice(y_true.size, size=int(y_true.size * 0.66),
                       replace=False)
    y_pred[wrong] = rng.integers(0, classes, size=wrong.size)
    np.save(os.path.join(path, "y_true.npy"), y_true)
    np.save(os.path.join(path, "y_pred.npy"), y_pred)
    acc = (y_pred == y_true).mean()
    voting = rng.uniform(acc - 0.02, acc + 0.02, size=(groups, 24))
    voting[:, -1] = (y_pred == y_true).reshape(groups, classes).mean(1)
    np.save(os.path.join(path, "voting.npy"), voting)
    cm = np.zeros((classes, classes), dtype=np.int64)
    np.add.at(cm, (y_true, y_pred), 1)
    np.save(os.path.join(path, "confusion_matrix.npy"), cm)
    curve = np.concatenate([[0.0], np.linspace(0.8, acc, classes - 1)])
    for stem in ("mean_grasp", "min_grasp", "max_grasp"):
        jax_xlsx.write_xlsx(os.path.join(path, f"{stem}.xlsx"), curve)
    jax_xlsx.write_xlsx(os.path.join(path, "std_grasp.xlsx"),
                        np.full(classes, 0.02))
    return path


def perturb(case, ref, path) -> None:
    shutil.copytree(ref, path)
    if case == "perturbed":
        yp = np.load(os.path.join(path, "y_pred.npy"))
        flip = np.random.default_rng(1).choice(yp.size, size=yp.size // 2,
                                               replace=False)
        yp[flip] = (yp[flip] + 7) % 41
        np.save(os.path.join(path, "y_pred.npy"), yp)
    elif case == "missing":
        os.unlink(os.path.join(path, "voting.npy"))
    elif case == "shape":
        np.save(os.path.join(path, "voting.npy"), np.zeros((48, 249)))
    elif case == "near":
        v = np.load(os.path.join(path, "voting.npy"))
        np.save(os.path.join(path, "voting.npy"), v + 0.03)


@pytest.mark.parametrize("case", ["self", "perturbed", "missing", "shape",
                                  "near"])
def test_compare_results_gives_the_jax_verdicts(tmp_path, case, capsys):
    """The port's ``compare_results`` and CLI against the JAX package's on
    the cases of ``tests/test_parity_cli.py``: the same rows, verdict and
    exit code."""
    ref = artifact_dir(str(tmp_path / "ref"))
    run = str(tmp_path / "run")
    perturb(case, ref, run)
    got = port_parity.compare_results(run, ref)
    want = jax_parity.compare_results(run, ref)
    assert [vars(r) for r in got.rows] == [vars(r) for r in want.rows]
    assert got.table() == want.table()
    assert got.ok == (case in ("self", "near"))
    argv = [run, "--ref", ref, "--tol_curve", "0.04"]
    assert cli_parity.main(argv) == jax_cli_parity.main(argv)
    assert cli_parity.main(argv[:3]) == (0 if got.ok else 1)


def test_parity_cli_takes_the_jax_flags():
    ours = {a.dest: a.default for a in cli_parity.build_parser()._actions}
    theirs = {a.dest: a.default
              for a in jax_cli_parity.build_parser()._actions}
    assert ours.keys() == theirs.keys()
    assert {k: v for k, v in ours.items() if k != "ref"} == {
        k: v for k, v in theirs.items() if k != "ref"}


# ----------------------------------------------------------------- CLIs
def one_person(args, cfg, device):
    emg, pos, glove = make_processed_dataset(cfg, people_positions=[40])
    return DeviceStore(cfg, emg, pos, glove, device=device)


@pytest.fixture()
def small_cli(monkeypatch, tmp_path):
    """The CLIs on a one-person store at small width, with a cached
    crossval whose best row is the canonical config at dropout 0."""
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
            "--no_adabn", "--per_subject_eval", "--platform", "cpu",
            "--data_dir", str(tmp_path), "--checkpoint_dir", str(tmp_path)]


def test_cli_round_trip_on_cpu(small_cli, tmp_path, capsys):
    """``cptorch-train --test --results_dir A`` and ``cptorch-results``
    from its checkpoint into B (both with ``--fused_encoder``) give the
    same artifacts bit for bit; ``cptorch-results`` without it into C
    passes ``cptorch-parity C --ref A``; a perturbed copy fails it."""
    a, b, c = (str(tmp_path / name) for name in "ABC")
    fused = ["--fused_encoder"]
    assert cli_train.main([*small_cli, *fused, "--final_epochs", "1",
                           "--test", "--results_dir", a]) == 0
    out = capsys.readouterr().out
    assert f"artifacts exported to {a}" in out
    assert "subject 40:" in out and "(pooled:" in out
    assert cli_results.main([*small_cli, *fused, "--results_dir", b]) == 0
    assert "subject 40:" in capsys.readouterr().out
    for stem in ARTIFACTS + ("per_subject_acc",):
        np.testing.assert_array_equal(np.load(f"{a}/{stem}.npy"),
                                      np.load(f"{b}/{stem}.npy"),
                                      err_msg=stem)
    assert np.load(f"{a}/logs.npy").shape == (8 * 25, 41, 41)
    assert np.load(f"{a}/per_subject_acc.npy").shape == (1,)
    assert cli_results.main([*small_cli, "--results_dir", c]) == 0
    assert cli_parity.main([c, "--ref", a]) == 0
    assert "FAIL" not in capsys.readouterr().out
    perturb("perturbed", c, str(tmp_path / "D"))
    assert cli_parity.main([str(tmp_path / "D"), "--ref", a]) == 1


def test_cli_results_rejects_unported_modes(tmp_path):
    """The modes (item 7) run (``test_torch_port_modes.py``), ``--bf16``
    is accepted (``test_torch_port_train_bf16.py``), and ``--profile``
    and ``--prng_impl`` are too (``test_cli_results_ignores_profile_and_
    prng_impl``): the one request still refused is the one the JAX CLI
    refuses, per-subject scores of the softmax baseline, before a device
    is chosen."""
    with pytest.raises(SystemExit, match="--per_subject_eval scores "
                                         "contrastive logits"):
        cli_results.main(["--prediction", "--per_subject_eval", "--bf16",
                          "--profile", "--prng_impl", "rbg",
                          "--data_dir", str(tmp_path)])


@pytest.mark.parametrize("flags", [["--profile"], ["--prng_impl", "auto"],
                                   ["--prng_impl", "threefry2x32"],
                                   ["--prng_impl", "rbg"],
                                   ["--prng_impl", "unsafe_rbg"]],
                         ids=lambda f: "".join(f))
def test_cli_results_ignores_profile_and_prng_impl(tmp_path, small_cli,
                                                   monkeypatch, flags):
    """``cptpu-results`` reads neither ``--profile`` nor ``--prng_impl``
    (its ``cli/results.py:15-17,63``): ``cptorch-results`` runs with each
    and writes the artifacts it writes without them, bit for bit, and no
    trace."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    a, b = str(tmp_path / "A"), str(tmp_path / "B")
    assert cli_train.main([*small_cli, "--final_epochs", "1"]) == 0
    assert cli_results.main([*small_cli, "--results_dir", a]) == 0
    assert cli_results.main([*small_cli, *flags, "--results_dir", b]) == 0
    for stem in ARTIFACTS:
        np.testing.assert_array_equal(np.load(f"{a}/{stem}.npy"),
                                      np.load(f"{b}/{stem}.npy"),
                                      err_msg=stem)
    assert not os.path.exists(os.path.join(tmp_path, "cptorch_trace"))


def test_encoder_chain_counts_no_launch_on_the_cpu(data):
    """On CPU tensors the fused evaluation runs the plain chain and the
    wrapper counts no kernel launch."""
    port, jtr = trainers(data, fused=True)
    state = port_state(jax_state(jtr, adabn=False), False)
    K.reset_launch_counts()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        port.evaluate(state, port.generator(0), None, "val")
    assert K.launch_counts["encoder_chain"] == 0
