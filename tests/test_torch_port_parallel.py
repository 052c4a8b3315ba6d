"""PyTorch port: the parallel layer (``parallel/mesh.py``,
``parallel/spmd.py``, ``parallel/collectives.py``) against the JAX
package and against the unsharded port, in a gloo group of 4 CPU
processes (``gloo_group.py``; the ranks' side is ``parallel_ranks.py``).

One group serves the whole file: a module fixture starts it once with
every job's inputs, and each test reads its job's results. Small width:
``n_linear`` 2 or 3, hidden 64. Tolerances:

* placements: equal to JAX's ``state_shardings(make_mesh(4, 2), ...)``
  for every trained parameter, mode by mode (``tree_map`` over shapes:
  no compile);
* the dp=2 x mp=2 step against JAX's unsharded ``jax.jit(_sgd_step)``,
  at JAX's own bounds (``tests/test_parallel.py:98-117``): the loss
  within rtol 1e-4; more than 98 % of each parameter within rtol 5e-3,
  atol 1e-5, and all within 2.5 lr; the fused chain's dp=2 x mp=2 and
  dp=4 steps at the same bounds against JAX's unsharded fused step (its
  Pallas kernels in interpret mode);
* sharded against unsharded port steps in float64 at dropout 0.5: within
  1e-9 (the largest difference over each tensor's largest magnitude),
  eager and on the fused chain (a ragged dp=3 mesh among them);
* the sharded remat step, eager and fused: bit-equal to the sharded step
  without remat in the same group;
* bf16 eager and fused sharded steps against the port's and JAX's
  unsharded bf16 steps at the bf16 steps' tolerances
  (``test_torch_port_train_bf16.py``): the loss within 1e-2, each
  gradient within 0.15 of the reference's 2-norm and the whole EMG
  gradient within 0.05 (JAX's own two bf16 paths lie 0.11-0.12 apart);
* the config-sharded sweep: bit-equal to the unsharded sweep at the
  same chunk width;
* session-sharded serving: preds and votes equal, scores within rtol
  1e-5, atol 1e-6;
* the CLIs under a 2-rank group: the files the unsharded commands write.
"""
from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch

import parallel_ranks as pr
from contrastiveprosthetics_torch.cli import serve as cli_serve
from contrastiveprosthetics_torch.cli import train as cli_train
from contrastiveprosthetics_torch.data.store import DeviceStore
from contrastiveprosthetics_torch.models.convert import from_flax_variables
from contrastiveprosthetics_torch.parallel.mesh import state_placements
from contrastiveprosthetics_torch.train import engine as port_engine
from contrastiveprosthetics_torch.train.checkpoint import load_checkpoint
from contrastiveprosthetics_torch.train.engine import Trainer
from contrastiveprosthetics_tpu.config import DEFAULT_CONFIG as JCFG
from contrastiveprosthetics_tpu.data import sampler as jax_sampler
from contrastiveprosthetics_tpu.data.store import DeviceStore as JaxStore
from contrastiveprosthetics_tpu.models.clip import l2_penalty as jax_l2_penalty
from contrastiveprosthetics_tpu.parallel.mesh import make_mesh as jax_mesh
from contrastiveprosthetics_tpu.parallel.mesh import state_shardings
from contrastiveprosthetics_tpu.train import engine as jax_engine
from gloo_group import run_group

torch.set_num_threads(1)

JAX_MODES = {**pr.MODES, "glove_prediction": dict(prediction=True,
                                                  glove=True)}
HYPER = (1e-3, 1e-2, 0.0, 1e-3, 3e-2, 0.0)  # dropout 0, one lr
LR = 1e-3
# (mode, adabn, n_linear) of the steps against JAX
JAX_STEPS = [("onehot", False, 2), ("glove_encoding", False, 2),
             ("prediction", False, 3), ("onehot", True, 3)]
# (mode, n_linear) of the fused steps against JAX's, each on (2, 2) and
# (4, 1)
JAX_FUSED_STEPS = [("onehot", 2), ("glove_encoding", 3)]
FUSED_MESHES = [(2, 2), (4, 1)]
# (mesh, mode, adabn, n_linear) of the float64 steps against the port's
F64_STEPS = [((2, 2), "onehot", False, 2), ((2, 2), "onehot", True, 3),
             ((4, 1), "glove_encoding", False, 3),
             ((1, 4), "prediction", False, 3),
             ((2, 2), "glove_encoding", True, 2),
             ((2, 1), "prediction", True, 2)]
# ... and on the fused chain, the unsharded step fused too
F64_FUSED_STEPS = [((2, 2), "onehot", False, 3),
                   ((4, 1), "glove_encoding", False, 2),
                   ((1, 4), "onehot", True, 3),
                   ((3, 1), "onehot", False, 2)]
BF16_MESHES = [(2, 2), (1, 4)]
BF16_LOSS_ATOL, BF16_GRAD_REL, BF16_EMG_REL = 1e-2, 0.15, 0.05
SWEEP_CONFIGS, SWEEP_CHUNK = 6, 2  # 3 chunks: over 2 or 4 ranks, uneven
SESSIONS, TICKS, SUBSET = 8, 6, (3, 7, 12)


def jax_trainer(data, mode, adabn, n_linear, **kw):
    return jax_engine.Trainer(JCFG, JaxStore(JCFG, *data), adabn=adabn,
                              batch_size=8, n_linear=n_linear,
                              hidden=pr.HIDDEN, **JAX_MODES[mode], **kw)


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


def jax_batch(jtr, key):
    v = jtr.view_train
    k_perm, k_glove, k_order = jax.random.split(key, 3)
    items = jax.random.permutation(k_order, v.D)[:8]
    return (jax_sampler.gather_train_batch(
                v.emg_flat, jax_sampler.task_permutations(k_perm, v.n_tasks,
                                                          v.D), items),
            jax_sampler.gather_glove_batch(
                v.glove_flat, jax_sampler.task_permutations(
                    k_glove, v.n_tasks, v.D_glove), items, v.D_glove))


@pytest.fixture(scope="module")
def data():
    return pr.processed_data()


@pytest.fixture(scope="module")
def jax_steps(data):
    """Each JAX_STEPS case, then each JAX_FUSED_STEPS case (a fused
    trainer): the JAX state's weights as the port's state dict, the batch,
    and JAX's unsharded step from them."""
    out = []
    cases = [(mode, adabn, n_linear, False)
             for mode, adabn, n_linear in JAX_STEPS]
    cases += [(mode, False, n_linear, True)
              for mode, n_linear in JAX_FUSED_STEPS]
    for mode, adabn, n_linear, fused in cases:
        jtr = jax_trainer(data, mode, adabn, n_linear,
                          use_fused_train=fused)
        jstate = jtr.init_state(jax.random.PRNGKey(6))
        emg_b, glove_b = jax_batch(jtr, jax.random.PRNGKey(7))
        jh = jax_engine.Hyper.single(*HYPER)
        jnew, jloss, _ = jax.jit(jtr._sgd_step)(
            jstate, emg_b, glove_b, jh, jh.lr_emg, jh.lr_glove,
            jax.random.PRNGKey(0))
        widths = dict(n_linear=n_linear, hidden=pr.HIDDEN)
        sd = from_flax_variables(tree(jstate.params),
                                 tree(jstate.batch_stats), adabn=adabn,
                                 **widths)
        want = from_flax_variables(tree(jnew.params), tree(jnew.batch_stats),
                                   adabn=adabn, **widths)
        out.append(dict(
            inputs=dict(mesh_shape=(2, 2), mode=mode, adabn=adabn,
                        n_linear=n_linear,
                        sd={k: v.numpy() for k, v in sd.items()},
                        emg_b=np.asarray(emg_b),
                        glove_b=np.asarray(glove_b), hyper=HYPER,
                        fused=fused),
            loss=float(jloss), want={k: v.numpy() for k, v in want.items()}))
    return out


@pytest.fixture(scope="module")
def jax_bf16(data):
    """The JAX bf16 trainer's unsharded step at dropout 0, eager and fused
    (run op by op, as ``test_torch_port_train_bf16.py`` does): its
    weights as the port's state dict, the batch, the loss and the
    gradients by state-dict name."""
    out = {}
    for path in ("eager", "fused"):
        jtr = jax_trainer(data, "onehot", False, 2,
                          compute_dtype="bfloat16",
                          use_fused_train=path == "fused")
        jstate = jtr.init_state(jax.random.PRNGKey(8))
        emg_b, glove_b = jax_batch(jtr, jax.random.PRNGKey(9))
        jh = jax_engine.Hyper.single(*HYPER)

        def total(p, jtr=jtr, jstate=jstate, emg_b=emg_b, glove_b=glove_b,
                  jh=jh):
            loss, _ = jtr._loss_and_metrics(p, jstate.batch_stats, emg_b,
                                            glove_b, jh,
                                            jax.random.PRNGKey(0), True)
            return (loss + jh.reg_emg * jax_l2_penalty(p["emg_net"])
                    + jh.reg_glove * jax_l2_penalty(p["glove_net"])), loss

        with jax.disable_jit():
            (_, loss), grads = jax.value_and_grad(total, has_aux=True)(
                jstate.params)
        widths = dict(n_linear=2, hidden=pr.HIDDEN)
        sd = from_flax_variables(tree(jstate.params),
                                 tree(jstate.batch_stats), **widths)
        want = from_flax_variables(tree(grads), tree(jstate.batch_stats),
                                   **widths)
        out[path] = dict(
            inputs=dict(fused=path == "fused",
                        sd={k: v.numpy() for k, v in sd.items()},
                        emg_b=np.asarray(emg_b), hyper=HYPER),
            loss=float(loss), grads={k: v.numpy() for k, v in want.items()
                                     if "running" not in k
                                     and "num_batches" not in k})
    return out


@pytest.fixture(scope="module")
def group(jax_steps, jax_bf16, tmp_path_factory):
    """Every job, run once by the 4-rank group: rank 0's results, and
    the directory the CLIs wrote into."""
    out_dir = str(tmp_path_factory.mktemp("spmd_cli"))
    plan = [(f"jax{i}", "step_vs_jax", case["inputs"])
            for i, case in enumerate(jax_steps[:len(JAX_STEPS)])]
    plan += [(f"jax_fused{i}_{m[0]}x{m[1]}", "step_vs_jax",
              dict(case["inputs"], mesh_shape=m))
             for i, case in enumerate(jax_steps[len(JAX_STEPS):])
             for m in FUSED_MESHES]
    plan += [(f"f64_{i}", "f64_vs_unsharded",
              dict(mesh_shape=m, mode=mode, adabn=adabn, n_linear=nl,
                   seed=i))
             for i, (m, mode, adabn, nl) in enumerate(F64_STEPS)]
    plan += [(f"f64_fused{i}", "f64_vs_unsharded",
              dict(mesh_shape=m, mode=mode, adabn=adabn, n_linear=nl,
                   seed=10 + i, fused=True))
             for i, (m, mode, adabn, nl) in enumerate(F64_FUSED_STEPS)]
    plan += [(f"remat_{path}", "remat_vs_stored",
              dict(mesh_shape=(2, 2), fused=path == "fused"))
             for path in ("eager", "fused")]
    plan += [(f"bf16_{path}_{m[0]}x{m[1]}", "bf16_vs_unsharded",
              dict(jax_bf16[path]["inputs"], mesh_shape=m))
             for path in ("eager", "fused") for m in BF16_MESHES]
    plan += [(f"round_trip_{mode}", "shard_round_trip",
              dict(mode=mode, n_linear=3))
             for mode in ("onehot", "prediction")]
    plan += [("stacked", "stacked_refused", {})]
    plan += [(f"sweep{n}", "sweep", dict(n_dp=n, n_configs=SWEEP_CONFIGS,
                                         chunk=SWEEP_CHUNK, seed=11))
             for n in (2, 4)]
    plan += [("serve", "serve", dict(n_sessions=SESSIONS, ticks=TICKS,
                                     subset=SUBSET))]
    return run_group(pr.run_plan, 4, plan, out_dir)[0], out_dir


# ------------------------------------------------------------- placements
def _jax_codes(spec) -> int:
    """0 replicated, 1 column-parallel, 2 row-parallel (a kernel's)."""
    return {(): 0, (None, "mp"): 1, ("mp", None): 2}[tuple(spec)]


def _port_code(placements) -> int:
    mp = placements[1]
    return 0 if not mp.is_shard() else (1 if mp.dim == 0 else 2)


@pytest.mark.parametrize("n_linear,hidden", [(2, 64), (3, 64), (7, 512)])
@pytest.mark.parametrize("adabn", [False, True])
@pytest.mark.parametrize("mode", list(JAX_MODES))
def test_placements_are_jax_state_shardings(data, mode, adabn, n_linear,
                                            hidden):
    """The port's placement of every trained parameter is JAX's
    ``state_shardings(make_mesh(4, 2), state, hidden)`` spec of the same
    leaf, on torch's layout (a kernel's column-parallel spec shards dim 0
    of the weight); at 7 layers the hidden kernels alternate
    column/row-parallel, as ``test_tp_alternates_hidden_kernels`` pins."""
    jtr = jax_engine.Trainer(JCFG, JaxStore(JCFG, *data), adabn=adabn,
                             batch_size=8, n_linear=n_linear, hidden=hidden,
                             **JAX_MODES[mode])
    shapes = jax.eval_shape(jtr.init_state, jax.random.PRNGKey(0))
    specs = state_shardings(jax_mesh(4, 2), shapes, hidden=hidden)
    codes = jax.tree_util.tree_map(
        lambda s, leaf: np.full(leaf.shape, _jax_codes(s.spec), np.float32),
        specs.params, shapes.params)
    stats = jax.tree_util.tree_map(lambda x: np.zeros(x.shape, x.dtype),
                                   shapes.batch_stats)
    want = from_flax_variables(codes, stats, adabn=adabn, n_linear=n_linear,
                               hidden=hidden)
    port = Trainer(pr.CFG, pr._store(), adabn=adabn, n_linear=n_linear,
                   hidden=hidden, **JAX_MODES[mode])
    state = port.init_state(port.generator(0))
    got = state_placements(state, hidden)
    assert got
    for name, placements in got.items():
        code = want[name].unique()
        assert code.numel() == 1, name
        assert _port_code(placements) == int(code), name
    if n_linear == 7 and mode != "glove_prediction":
        dense = [f"emg_net.{n}.weight" for n, m in
                 state.model.emg_net.named_modules()
                 if isinstance(m, torch.nn.Linear)]
        assert [_port_code(got[n]) for n in dense[:7]] == [1, 2] * 3 + [1]


# ------------------------------------------------------------------ steps
@pytest.mark.parametrize("case", range(len(JAX_STEPS)),
                         ids=["-".join(map(str, c)) for c in JAX_STEPS])
def test_dp_mp_step_matches_jax(group, jax_steps, case):
    """The dp=2 x mp=2 step (4 ranks, the wide kernels sharded: each rank
    holds half of every sharded weight) from the JAX state's weights and
    batch, gathered, against JAX's unsharded step at JAX's bounds; the
    running statistics at the same bounds."""
    res, want = group[0][f"jax{case}"], jax_steps[case]
    np.testing.assert_allclose(res["loss"], want["loss"], rtol=1e-4)
    sd = want["inputs"]["sd"]
    halved = [n for n, shape in res["local_shapes"].items()
              if shape != sd[n].shape]
    assert halved and all(
        np.prod(res["local_shapes"][n]) * 2 == sd[n].size for n in halved)
    for name, b in want["want"].items():
        if "num_batches" in name or name not in res["state"]:
            continue
        a = res["state"][name]
        close = np.isclose(a, b, rtol=5e-3, atol=1e-5)
        assert close.mean() > 0.98, f"{name}: only {close.mean():.3f} close"
        np.testing.assert_allclose(a, b, atol=2.5 * LR, err_msg=name)


@pytest.mark.parametrize("mesh", FUSED_MESHES, ids=["2x2", "4x1"])
@pytest.mark.parametrize("case", range(len(JAX_FUSED_STEPS)),
                         ids=["-".join(map(str, c)) for c in JAX_FUSED_STEPS])
def test_fused_sharded_step_matches_jax_fused_step(group, jax_steps, case,
                                                   mesh):
    """The fused chain's sharded step (dp=2 x mp=2: the chain and the head
    on weights gathered whole over mp, each K5f's sums summed over dp and
    finished between launches; dp=4: 2 items a rank) from the JAX state's
    weights and batch, gathered, against JAX's unsharded fused step (its
    Pallas kernels in interpret mode) at JAX's bounds, at dropout 0."""
    res = group[0][f"jax_fused{case}_{mesh[0]}x{mesh[1]}"]
    want = jax_steps[len(JAX_STEPS) + case]
    np.testing.assert_allclose(res["loss"], want["loss"], rtol=1e-4)
    for name, b in want["want"].items():
        if "num_batches" in name or name not in res["state"]:
            continue
        a = res["state"][name]
        close = np.isclose(a, b, rtol=5e-3, atol=1e-5)
        assert close.mean() > 0.98, f"{name}: only {close.mean():.3f} close"
        np.testing.assert_allclose(a, b, atol=2.5 * LR, err_msg=name)


@pytest.mark.parametrize("case", range(len(F64_STEPS)),
                         ids=["-".join(map(str, c)) for c in F64_STEPS])
def test_sharded_step_is_the_unsharded_step_in_float64(group, case):
    """Two sharded float64 steps at dropout 0.5 (every rank draws the
    global batch's masks and keeps its rows and features) against two
    unsharded port steps: the losses, accuracies, parameters, running
    statistics and Adam moments within 1e-9; the same rows right."""
    res = group[0][f"f64_{case}"]
    assert res["max_rel"] <= 1e-9
    assert all(a == b for a, b in res["hits"])


@pytest.mark.parametrize("case", range(len(F64_FUSED_STEPS)),
                         ids=["-".join(map(str, c)) for c in F64_FUSED_STEPS])
def test_fused_sharded_step_is_the_unsharded_fused_step_in_float64(group,
                                                                   case):
    """Two sharded float64 steps on the fused chain at dropout 0.5 (each
    rank's Philox draws at its global rows) against two unsharded fused
    steps, as the eager ones are held, on dp=2 x mp=2, dp=4, mp=4 and
    the ragged dp=3 (3, 3 and 2 items; rank 3 idle): within 1e-9, the
    BatchNorm affines' gradients included (summed once over dp)."""
    res = group[0][f"f64_fused{case}"]
    assert res["max_rel"] <= 1e-9
    assert all(a == b for a, b in res["hits"])


@pytest.mark.parametrize("path", ["eager", "fused"])
def test_sharded_remat_step_is_bit_equal(group, path):
    """Two sharded remat steps on dp=2 x mp=2 at dropout 0.5 (the
    recompute repeats the forward's collectives inside the backward)
    against two sharded steps without remat in the same group: losses,
    accuracies, the gathered state, both Adam chains and the generator
    bit for bit."""
    assert group[0][f"remat_{path}"]["bit_equal"]


@pytest.mark.parametrize("mesh", BF16_MESHES, ids=["2x2", "1x4"])
@pytest.mark.parametrize("path", ["eager", "fused"])
def test_bf16_sharded_step_matches_the_unsharded_bf16_steps(group, jax_bf16,
                                                            path, mesh):
    """One sharded bf16 step at dropout 0 (eager: the tensor-parallel
    layers' roundings; fused: the bf16 chain on whole weights), its
    gradients gathered, against the port's unsharded bf16 step and JAX's
    (op by op): the loss within 1e-2, each gradient within 0.15 of the
    reference's 2-norm, the EMG tower's whole within 0.05."""
    res = group[0][f"bf16_{path}_{mesh[0]}x{mesh[1]}"]
    for loss, grads in ((res["plain_loss"], res["plain_grads"]),
                        (jax_bf16[path]["loss"], jax_bf16[path]["grads"])):
        assert abs(res["loss"] - loss) <= BF16_LOSS_ATOL
        for name, got in res["grads"].items():  # the trained parameters
            assert rel_l2(got, grads[name]) <= BF16_GRAD_REL, name
        emg = [n for n in res["grads"] if n.startswith("emg_net.")]
        assert rel_l2(np.concatenate([res["grads"][n].ravel() for n in emg]),
                      np.concatenate([grads[n].ravel() for n in emg])
                      ) <= BF16_EMG_REL


@pytest.mark.parametrize("mode", ["onehot", "prediction"])
def test_gather_of_shard_is_the_state_and_make_mesh_refuses(group, mode):
    """``gather_state(shard_state(s))`` is ``s`` bit for bit (weights,
    statistics, both Adam chains after a step), with no mesh left in the
    model; ``make_mesh(3, 2)`` on 4 ranks raises JAX's ValueError."""
    res = group[0][f"round_trip_{mode}"]
    assert res["round_trip"]
    assert res["refused"] == "need 6 devices, have 4"


def test_stacked_state_under_a_mesh_is_refused(group):
    """A stacked (sweep) state's sharded step raises: the step takes one
    model's state, as JAX's ``make_sharded_train_step`` does, and the
    sweep shards whole chunks instead."""
    assert "one model's state" in group[0]["stacked"]


# ------------------------------------------------------------------ sweep
@pytest.mark.parametrize("n_dp", [2, 4])
def test_config_sharded_sweep_is_bit_equal(group, n_dp):
    """``cross_validate(mesh=)`` of 6 configs in chunks of 2 over 2 and 4
    ranks (3 chunks: uneven, one rank idle) equals the unsharded sweep at
    the same chunk bit for bit, dropout included."""
    res = group[0][f"sweep{n_dp}"]
    assert res["got"].shape == (SWEEP_CONFIGS, 2)
    np.testing.assert_array_equal(res["got"], res["want"])


# ---------------------------------------------------------------- serving
@pytest.mark.parametrize("path", ["step", "steps"])
def test_session_sharded_serving_matches(group, path):
    """``BatchedStreamingEngine(mesh=)`` over 2 ranks (sessions 0-3 and
    4-7, session 1 restricted to a subset, sessions 3 and 6 calibrated by
    their ranks) against the unsharded engine: preds and votes equal,
    scores within rtol 1e-5, atol 1e-6."""
    got, want = group[0]["serve"]["sharded"], group[0]["serve"]["plain"]
    keys = ("preds", "votes") if path == "step" else ("steps_preds",
                                                      "steps_votes")
    for key in keys:
        np.testing.assert_array_equal(got[key], want[key])
    if path == "step":
        np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-5,
                                   atol=1e-6)
        assert set(np.unique(got["preds"][:, 1])) <= set(SUBSET)


def test_session_count_must_divide_by_dp(group):
    assert "divide" in group[0]["serve"]["refused"]


# ------------------------------------------------------------------- CLIs
@pytest.fixture()
def small_cli(monkeypatch):
    """``cptorch-train`` on the one-person store at small width, as the
    ranks run it (``parallel_ranks._small_cli``)."""
    monkeypatch.setattr(cli_train, "build_store", lambda args, cfg, device:
                        DeviceStore(cfg, *pr.processed_data(), device=device))
    monkeypatch.setattr(port_engine, "Trainer",
                        functools.partial(Trainer, n_linear=2,
                                          hidden=pr.HIDDEN))


def test_cli_spmd_crossval_writes_what_unsharded_writes(group, small_cli,
                                                        tmp_path):
    """``cptorch-train --spmd_crossval`` in each rank of a 2-rank group
    (the configs sharded, rank 0 alone training on and writing) writes
    the sweep's caches and the checkpoint of the unsharded command."""
    out = group[1]
    assert group[0]["clis"]["rc"] == (0, 0)
    assert cli_train.main(pr.cli_train_args(str(tmp_path))) == 0
    for name in ("cross_val_values.npy", "cross_val_keys.npy"):
        np.testing.assert_array_equal(np.load(f"{out}/{name}"),
                                      np.load(tmp_path / name))
    got = load_checkpoint(f"{out}/contrastive.pt", torch.device("cpu"))
    want = load_checkpoint(str(tmp_path / "contrastive.pt"),
                           torch.device("cpu"))
    for (k, a), b in zip(got.model.state_dict().items(),
                         want.model.state_dict().values()):
        assert torch.equal(a, b), k


def test_cli_spmd_serve_writes_what_unsharded_writes(group, tmp_path):
    """``cptorch-serve --spmd --replay --sessions 8`` in each rank of a
    2-rank group writes the preds and votes of the unsharded command."""
    out = tmp_path / "plain.npz"
    assert cli_serve.main(pr.cli_serve_args(str(out))) == 0
    with np.load(f"{group[1]}/serve.npz") as got, np.load(out) as want:
        assert got["preds"].shape == (SESSIONS, 25)
        for key in ("preds", "votes"):
            np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("cli,argv", [
    (cli_train, ["--crossval_size", "3", "--spmd_crossval"]),
    (cli_serve, ["--demo", "--sessions", "4", "--spmd"])],
    ids=["train", "serve"])
def test_cli_spmd_starts_a_rank_per_visible_device(monkeypatch, cli, argv):
    """With no process group and two CUDA devices visible, ``--spmd_crossval``
    and ``--spmd`` (4 sessions) start one NCCL rank per device
    (``spawn_ranks``) with the command's own arguments, before any CUDA
    work or store."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    calls = []

    def spawn(entry, argv, n):
        calls.append((entry, argv, n))
        return 0

    monkeypatch.setattr(cli, "spawn_ranks", spawn)
    monkeypatch.setattr(cli_train, "build_store", None)
    assert cli.main([*argv, "--platform", "cuda"]) == 0
    assert calls == [(cli.main, [*argv, "--platform", "cuda"], 2)]
