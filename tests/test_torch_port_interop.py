"""PyTorch port: checkpoints of the JAX package (``cptorch-import``,
``cptorch-export``, ``train/jax_interop.py``, ``cptorch-serve
--checkpoint *.msgpack``).

Each case makes a JAX ``TrainState`` from a seed at the small widths of
``test_torch_port_modes.py`` (``n_linear=2``, ``hidden=32``, 8 conv
features), every leaf drawn (the parameters moved off their init, the
running statistics, both Adam chains' moments and counts), and saves it
with ``flax.serialization.to_bytes``. Through ``cptorch-import`` the
port's eval logits match the JAX model's at the port's established
tolerance, and each Adam moment is its JAX leaf under exactly the
permutation that takes the JAX parameter to the port's (found from the
parameters' values, not from the converter). ``cptorch-export`` of that
state restores with the JAX ``from_bytes(template_state(...))`` with
every leaf bit-equal to the original, and a port state goes to JAX and
back bit for bit, in every mode the port trains and with a bf16 ``mu``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from contrastiveprosthetics_torch.cli import export_ckpt as cli_export
from contrastiveprosthetics_torch.cli import import_ckpt as cli_import
from contrastiveprosthetics_torch.cli import results as cli_results
from contrastiveprosthetics_torch.cli import serve as cli_serve
from contrastiveprosthetics_torch.config import DEFAULT_CONFIG as CFG
from contrastiveprosthetics_torch.data.synthetic import make_processed_dataset
from contrastiveprosthetics_torch.models.clip import ContrastiveModel as PortModel
from contrastiveprosthetics_torch.train.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from contrastiveprosthetics_torch.train.engine import TrainState
from contrastiveprosthetics_torch.train.jax_interop import (
    tower_parameter_names,
)
from contrastiveprosthetics_tpu.config import DEFAULT_CONFIG as JCFG
from contrastiveprosthetics_tpu.data.store import DeviceStore as JaxStore
from contrastiveprosthetics_tpu.models import clip as jax_clip
from contrastiveprosthetics_tpu.models import emg_net as jax_emg_net
from contrastiveprosthetics_tpu.train import engine as jax_engine
from contrastiveprosthetics_tpu.train.checkpoint import template_state

torch.set_num_threads(1)

WIDTHS = dict(n_linear=2, hidden=32, conv_features=8)
# the port's eval logits against the JAX model's (test_torch_port_modes.py)
OUT_TOL = dict(rtol=1e-5, atol=2e-6)
# mode flags, plain BatchNorm (adabn False) or AdaBN, and a bf16 mu
CASES = {
    "contrastive-adabn": (dict(), True, False),
    "contrastive-plain": (dict(), False, False),
    "prediction": (dict(prediction=True), False, False),
    "prediction-glove": (dict(prediction=True, glove=True), False, False),
    "glove_encoding": (dict(glove_encoding=True), True, False),
    "contrastive-plain-bf16-mu": (dict(), False, True),
}


class _EMGNet8(jax_emg_net.EMGNet):
    conv_features: int = 8


@pytest.fixture(autouse=True)
def jax_conv_width(monkeypatch):
    monkeypatch.setattr(jax_clip, "EMGNet", _EMGNet8)


@pytest.fixture(scope="module")
def data():
    return make_processed_dataset(CFG, people_positions=[40], seed=3)


def jax_trainer(data, mode, adabn, bf16_mu=False):
    emg, pos, glove = data
    return jax_engine.Trainer(
        JCFG, JaxStore(JCFG, emg, pos, glove), adabn=adabn, batch_size=8,
        n_linear=WIDTHS["n_linear"], hidden=WIDTHS["hidden"],
        adam_mu_dtype="bfloat16" if bf16_mu else "float32", **mode)


def seeded_jax_state(jtr, seed: int):
    """``init_state`` of ``seed`` with every leaf redrawn from a numpy
    generator of the same seed: parameters moved off their init (so no
    two values of a leaf are equal), running statistics, moments in the
    ``mu`` dtype the trainer gives (bf16 or f32), counts."""
    state = jtr.init_state(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def noisy(x):
        x = np.asarray(x)
        return (x + rng.normal(0, 0.05, x.shape)).astype(x.dtype)

    def stats(tree):
        return {k: stats(v) if isinstance(v, dict) else (
            rng.normal(0, 0.2, np.shape(v)) if k == "mean"
            else rng.uniform(0.5, 2.0, np.shape(v))).astype(np.float32)
            for k, v in tree.items()}

    def moments(opt):
        mu = jax.tree_util.tree_map(lambda x: jnp.asarray(
            rng.normal(0, 1e-3, np.shape(x)), x.dtype), opt.mu)
        nu = jax.tree_util.tree_map(lambda x: np.asarray(
            rng.uniform(0, 1e-5, np.shape(x)), np.float32), opt.nu)
        return opt._replace(count=jnp.asarray(rng.integers(1, 5000),
                                              jnp.int32), mu=mu, nu=nu)

    return state._replace(
        params=jax.tree_util.tree_map(noisy, state.params),
        batch_stats=stats(jax.tree_util.tree_map(np.asarray,
                                                 state.batch_stats)),
        opt_emg=moments(state.opt_emg), opt_glove=moments(state.opt_glove))


def leaves(tree) -> dict:
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def as_numpy(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def permutation(port: np.ndarray, jax_leaf: np.ndarray):
    """The flat index map ``pi`` with ``port.ravel() == jax_leaf.ravel()
    [pi]``, found from the values, and the mask of the port's positions
    whose value occurs once (where ``pi`` is certain); None when the two
    hold different values."""
    a, b = port.ravel(), jax_leaf.ravel()
    if a.size != b.size:
        return None
    order_a, order_b = np.argsort(a, kind="stable"), np.argsort(b,
                                                                kind="stable")
    if not np.array_equal(a[order_a], b[order_b]):
        return None
    pi = np.empty_like(order_a)
    pi[order_a] = order_b
    values, counts = np.unique(a, return_counts=True)
    once = np.isin(a, values[counts == 1])
    assert once.mean() > 0.99
    return pi, once


def import_args(src, out, adabn) -> list[str]:
    return [str(src), "--out", str(out), "--platform", "cpu",
            *([] if adabn else ["--no_adabn"])]


@pytest.mark.parametrize("case", list(CASES))
def test_jax_checkpoint_through_the_port_and_back(data, tmp_path, capsys,
                                                  case):
    mode, adabn, bf16_mu = CASES[case]
    jtr = jax_trainer(data, mode, adabn, bf16_mu)
    jstate = seeded_jax_state(jtr, seed=11)
    src = tmp_path / "contrastive.msgpack"
    src.write_bytes(serialization.to_bytes(jstate))
    pt = tmp_path / "port" / "contrastive.pt"
    assert cli_import.main(import_args(src, pt, adabn)) == 0
    out = capsys.readouterr().out
    assert f"imported {src} -> {pt}" in out
    assert f"bn={'adabn' if adabn else 'plain-bn'}" in out
    state = load_checkpoint(str(pt), torch.device("cpu"))
    model = state.model
    assert (model.prediction, model.glove, model.glove_encoding) == (
        mode.get("prediction", False), mode.get("glove", False),
        mode.get("glove_encoding", False))

    # the eval logits (vote input) against the JAX model's
    rng = np.random.default_rng(5)
    vote = rng.standard_normal((3, 41, 25, 12)).astype(np.float32)
    glove = rng.standard_normal((3, 41, 20)).astype(np.float32)
    want = jtr.model.apply(
        {"params": jstate.params, "batch_stats": jstate.batch_stats},
        vote, glove, 0.0, 0.0, False, mutable=["batch_stats"])[0]
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(vote),
                           glove=torch.from_numpy(glove))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)

    # each moment is its JAX leaf under its parameter's permutation
    names = tower_parameter_names(model)
    sd = model.state_dict()
    for tower, opt, jopt in (("emg_net", state.opt_emg, jstate.opt_emg),
                             ("glove_net", state.opt_glove,
                              jstate.opt_glove)):
        assert opt.count == int(jopt.count)
        jparams = leaves(jstate.params[tower])
        jmu, jnu = leaves(jopt.mu), leaves(jopt.nu)
        assert len(names[tower]) == len(jparams) == len(opt.mu)
        for name, mu, nu in zip(names[tower], opt.mu, opt.nu):
            found = [(path, hit) for path, leaf in jparams.items()
                     if (hit := permutation(sd[name].numpy(), leaf))
                     is not None]
            assert len(found) == 1, name
            path, (pi, once) = found[0]
            assert mu.dtype == (torch.bfloat16 if bf16_mu else torch.float32)
            assert nu.dtype == torch.float32
            np.testing.assert_array_equal(
                as_numpy(mu).ravel()[once],
                jmu[path].astype(np.float32).ravel()[pi][once],
                err_msg=f"mu {name}")
            np.testing.assert_array_equal(
                nu.numpy().ravel()[once], jnu[path].ravel()[pi][once],
                err_msg=f"nu {name}")

    # the port's export restores in JAX, every leaf the original's
    back = tmp_path / "back.msgpack"
    assert cli_export.main([str(pt), "--out", str(back), "--platform",
                            "cpu"]) == 0
    assert f"exported {pt} -> {back}" in capsys.readouterr().out
    restored = serialization.from_bytes(template_state(jtr.model, JCFG),
                                        back.read_bytes())
    original, again = leaves(jstate), leaves(restored)
    assert set(original) == set(again)
    for path, leaf in original.items():
        assert leaf.dtype == again[path].dtype, path
        assert leaf.shape == again[path].shape, path
        np.testing.assert_array_equal(np.atleast_1d(leaf).view(np.uint8),
                                      np.atleast_1d(again[path]).view(
                                          np.uint8), err_msg=path)


def seeded_port_state(mode: dict, adabn: bool, bf16_mu: bool, seed: int
                      ) -> TrainState:
    """A port state as a port run leaves it: a model of torch's init from
    ``seed`` (the glove baseline's idle EMG tower at the CLI's widths, as
    the JAX tree carries none), the running statistics of the towers that
    run (a dead module's are never updated), moments and counts drawn
    from a numpy generator."""
    widths = {} if mode.get("glove") else WIDTHS
    model = PortModel(adabn=adabn, **widths, **mode,
                      generator=torch.Generator().manual_seed(seed))
    state = TrainState.fresh(model, torch.bfloat16 if bf16_mu else None)
    rng = np.random.default_rng(seed)
    dead = {id(b) for m in model.dead_modules() for b in m.buffers()}
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if id(buf) in dead:
                continue
            if "running_mean" in name:
                buf.copy_(torch.from_numpy(rng.normal(0, 0.2, buf.shape)))
            elif "running_var" in name:
                buf.copy_(torch.from_numpy(rng.uniform(0.5, 2, buf.shape)))
        for opt in (state.opt_emg, state.opt_glove):
            opt.count = int(rng.integers(1, 5000))
            for mu, nu in zip(opt.mu, opt.nu):
                mu.copy_(torch.from_numpy(rng.normal(0, 1e-3, mu.shape)))
                nu.copy_(torch.from_numpy(rng.uniform(0, 1e-5, nu.shape)))
    return state


@pytest.mark.parametrize("case", list(CASES))
def test_port_checkpoint_through_jax_and_back(tmp_path, case):
    """``cptorch-export`` then ``cptorch-import`` gives back the port's
    pair: every state_dict entry (the dead ones included), both Adam
    chains' moments with their dtypes, and the counts, bit for bit."""
    mode, adabn, bf16_mu = CASES[case]
    state = seeded_port_state(mode, adabn, bf16_mu, seed=21)
    pt, pt2 = tmp_path / "a" / "contrastive.pt", tmp_path / "b" / "c.pt"
    save_checkpoint(str(pt), state)
    msg = tmp_path / "x.msgpack"
    assert cli_export.main([str(pt), "--out", str(msg), "--platform",
                            "cpu"]) == 0
    assert cli_import.main(import_args(msg, pt2, adabn)) == 0
    again = load_checkpoint(str(pt2), torch.device("cpu"))
    a, b = state.model.state_dict(), again.model.state_dict()
    assert set(a) == set(b)
    for name in a:
        assert a[name].dtype == b[name].dtype, name
        assert torch.equal(a[name], b[name]), name
    for opt, opt2 in ((state.opt_emg, again.opt_emg),
                      (state.opt_glove, again.opt_glove)):
        assert opt.count == opt2.count
        assert len(opt.mu) == len(opt2.mu) and len(opt.nu) == len(opt2.nu)
        for x, y in zip(opt.mu + opt.nu, opt2.mu + opt2.nu):
            assert x.dtype == y.dtype and torch.equal(x, y)


def test_export_without_an_adam_sibling_writes_fresh_chains(tmp_path,
                                                            capsys):
    """A weights-only ``.pt`` (a reference checkpoint) exports with fresh
    Adam chains, and the summary says so."""
    state = seeded_port_state({}, False, False, seed=3)
    pt = tmp_path / "ref.pt"
    torch.save(state.model.state_dict(), pt)
    assert cli_export.main([str(pt), "--platform", "cpu"]) == 0
    assert "Adam chains are fresh" in capsys.readouterr().out
    assert (tmp_path / "ref.msgpack").exists()


def malformed(kind: str, data, tmp_path) -> str:
    path = tmp_path / f"{kind}.msgpack"
    if kind == "torch_pt":
        path = tmp_path / "contrastive.pt"
        torch.save(seeded_port_state({}, False, False, 1).model.state_dict(),
                   path)
        return str(path)
    jtr = jax_trainer(data, {}, False)
    state = seeded_jax_state(jtr, seed=2)
    blob = serialization.to_bytes(state)
    if kind == "truncated":
        blob = blob[: len(blob) // 2]
    elif kind == "no_mode":  # a dense layer without its BatchNorm
        state.params["emg_net"].pop("BatchNorm_3")
        state.opt_emg.mu.pop("BatchNorm_3")
        state.opt_emg.nu.pop("BatchNorm_3")
        blob = serialization.to_bytes(state)
    elif kind == "not_a_train_state":
        blob = serialization.to_bytes({"params": state.params})
    path.write_bytes(blob)
    return str(path)


@pytest.mark.parametrize("kind", ["torch_pt", "truncated", "no_mode",
                                  "not_a_train_state"])
def test_import_of_a_malformed_input_exits_2(data, tmp_path, capsys, kind):
    src = malformed(kind, data, tmp_path)
    assert cli_import.main([src, "--out", str(tmp_path / "o.pt"),
                            "--platform", "cpu", "--no_adabn"]) == 2
    assert f"cptorch-import: cannot read {src}" in capsys.readouterr().err
    assert not (tmp_path / "o.pt").exists()


def test_export_of_a_malformed_input_exits_2(tmp_path, capsys):
    src = tmp_path / "contrastive.pt"
    src.write_bytes(b"not a checkpoint")
    assert cli_export.main([str(src), "--platform", "cpu"]) == 2
    assert "cptorch-export: cannot express" in capsys.readouterr().err


def test_results_on_a_jax_checkpoint_names_cptorch_import(data, tmp_path):
    """``cptorch-results`` over a ``--checkpoint_dir`` holding only
    ``contrastive.msgpack`` exits naming ``cptorch-import`` (in place of
    torch's FileNotFoundError), before a device is chosen."""
    jtr = jax_trainer(data, {}, False)
    (tmp_path / "contrastive.msgpack").write_bytes(
        serialization.to_bytes(seeded_jax_state(jtr, seed=4)))
    with pytest.raises(SystemExit, match="cptorch-import"):
        cli_results.main(["--synthetic", "--checkpoint_dir", str(tmp_path),
                          "--data_dir", str(tmp_path), "--no_adabn"])


@pytest.mark.parametrize("extra", [[], ["--replay"],
                                   ["--sessions", "3", "--replay"]],
                         ids=["step", "replay", "batched"])
def test_serve_from_a_msgpack_equals_serve_from_its_import(data, tmp_path,
                                                          extra):
    """``cptorch-serve --checkpoint X.msgpack`` (the JAX quick start's
    ``cptpu-serve`` line) serves the preds and votes of the same command
    on the ``.pt`` that ``cptorch-import --no_adabn`` makes of it."""
    jtr = jax_trainer(data, {}, False)
    src = tmp_path / "contrastive.msgpack"
    src.write_bytes(serialization.to_bytes(seeded_jax_state(jtr, seed=8)))
    pt = tmp_path / "contrastive.pt"
    assert cli_import.main(import_args(src, pt, adabn=False)) == 0
    outs = []
    for ckpt in (src, pt):
        out = tmp_path / f"{ckpt.suffix[1:]}.npz"
        assert cli_serve.main(["--checkpoint", str(ckpt), "--demo",
                               "--seconds", "0.3", "--platform", "cpu",
                               "--quiet", "--out", str(out), *extra]) == 0
        outs.append(np.load(out))
    for key in ("preds", "votes"):
        np.testing.assert_array_equal(outs[0][key], outs[1][key])
