"""The ranks' side of ``tests/test_torch_port_parallel.py``: what each
process of the gloo group runs (``gloo_group.run_group``). No JAX here:
the inputs come in as numpy arrays and the results go back as numpy
arrays and Python values, which the test holds against the JAX package
and the unsharded port.

``run_plan(rank, world, plan, tmp)`` runs every job of ``plan`` (a list
of ``(name, kwargs)``) in order on every rank of the 4-rank group, then
regroups ranks 0 and 1 as a 2-rank group for the CLIs, and returns a
dict of each job's result.
"""
from __future__ import annotations

import functools
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from contrastiveprosthetics_torch.cli import serve as cli_serve
from contrastiveprosthetics_torch.cli import train as cli_train
from contrastiveprosthetics_torch.config import DEFAULT_CONFIG as CFG
from contrastiveprosthetics_torch.data.store import DeviceStore
from contrastiveprosthetics_torch.data.synthetic import make_processed_dataset
from contrastiveprosthetics_torch.models.clip import ContrastiveModel
from contrastiveprosthetics_torch.models.convert import model_from_state_dict
from contrastiveprosthetics_torch.parallel.mesh import (
    gather_grads,
    gather_state,
    make_mesh,
    shard_state,
)
from contrastiveprosthetics_torch.parallel.spmd import make_sharded_train_step
from contrastiveprosthetics_torch.serve.stream import BatchedStreamingEngine
from contrastiveprosthetics_torch.train import crossval
from contrastiveprosthetics_torch.train import engine as port_engine
from contrastiveprosthetics_torch.train.engine import Hyper, Trainer, TrainState

HIDDEN = 64
MODES = {"onehot": {}, "glove_encoding": dict(glove_encoding=True),
         "prediction": dict(prediction=True)}
DROPOUT = (1e-3, 1e-2, 0.5, 2e-3, 3e-2, 0.3)  # both towers drop


def processed_data():
    return make_processed_dataset(CFG, people_positions=[40], seed=3)


@functools.cache
def _store():
    return DeviceStore(CFG, *processed_data())


def trainer(mode="onehot", adabn=False, n_linear=2, batch_size=8, **kw):
    return Trainer(CFG, _store(), adabn=adabn, batch_size=batch_size,
                   n_linear=n_linear, hidden=HIDDEN, **MODES[mode], **kw)


def numpy_dict(model) -> dict:
    return {k: v.detach().numpy().copy() for k, v in
            model.state_dict().items()}


def _moments(state) -> list:
    return [m.detach().numpy().copy() for opt in (state.opt_emg,
                                                  state.opt_glove)
            for m in (*opt.mu, *opt.nu)]


# ---------------------------------------------------------------- jobs
def step_vs_jax(rank, mesh_shape, mode, adabn, n_linear, sd, emg_b, glove_b,
                hyper, fused=False):
    """One sharded f32 step at dropout 0 from the state dict ``sd`` (the
    JAX state's weights), eager or on the fused chain: the loss, the
    accuracy and the gathered state."""
    mesh = make_mesh(*mesh_shape)
    tr = trainer(mode, adabn, n_linear, use_fused_train=fused)
    state = TrainState.fresh(model_from_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}))
    step, place = make_sharded_train_step(tr, mesh)
    sharded = place(state)
    h = Hyper.single(*hyper)
    loss, acc = step(sharded, torch.from_numpy(emg_b), h, h.lr_emg,
                     h.lr_glove, None,
                     torch.from_numpy(glove_b) if tr.reads_glove else None)
    local = {n: tuple(p.shape) for n, p in
             sharded.model.named_parameters()}
    return dict(loss=float(loss), acc=float(acc), local_shapes=local,
                state=numpy_dict(gather_state(sharded, mesh).model))


def _f64_case(mode, adabn, n_linear, seed, **kw):
    tr = trainer(mode, adabn, n_linear, **kw)
    model = tr.init_state(tr.generator(seed)).model.double()
    rng = np.random.default_rng(seed)
    B, T = 8, CFG.max_tasks
    emg = torch.from_numpy(rng.standard_normal((B, T, CFG.emg_dim)))
    glove = torch.from_numpy(rng.standard_normal((B, T, CFG.glove_dim)))
    return tr, model, emg, glove if tr.reads_glove else None


def f64_vs_unsharded(rank, mesh_shape, mode, adabn, n_linear, seed,
                     steps=2, fused=False):
    """``steps`` sharded float64 steps at dropout 0.5 (0.3 in the glove
    MLP) against the unsharded steps from the same weights, batches and
    generator seed, eager or both on the fused chain: the largest
    relative difference of the losses, and of every parameter, statistic
    and Adam moment to its tensor's largest magnitude (the moments of
    near-zero gradients hold roundoff only), and each step's count of
    rows right, both ways."""
    mesh = make_mesh(*mesh_shape)
    if not mesh.active:
        return None
    tr, model, emg, glove = _f64_case(mode, adabn, n_linear, seed,
                                      use_fused_train=fused)
    h = Hyper.single(*DROPOUT)
    plain = TrainState.fresh(model)
    step, place = make_sharded_train_step(tr, mesh)
    sharded = place(TrainState.fresh(model))
    g_plain, g_sharded = tr.generator(seed + 1), tr.generator(seed + 1)
    diffs = []

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))

    hits = []  # the accuracy's counts (the unsharded one rounds to f32)
    for _ in range(steps):
        lp, ap = tr._sgd_step(plain, emg, h, 1e-3, 2e-3, g_plain,
                              glove_b=glove)
        ls, as_ = step(sharded, emg, h, 1e-3, 2e-3, g_sharded, glove)
        diffs.append(rel(ls, lp))
        hits.append((round(float(as_) * emg.shape[0] * emg.shape[1]),
                     round(float(ap) * emg.shape[0] * emg.shape[1])))
    whole = gather_state(sharded, mesh)
    got, want = numpy_dict(whole.model), numpy_dict(plain.model)
    diffs += [rel(got[k], want[k]) for k in want if "num_batches" not in k]
    diffs += [rel(a, b) for a, b in zip(_moments(whole), _moments(plain))]
    return dict(max_rel=max(diffs), hits=hits)


def shard_round_trip(rank, mode, n_linear):
    """``gather_state(shard_state(s)) == s`` bit for bit on a (2, 2) mesh,
    moments included (one unsharded step first fills them); and
    ``make_mesh``'s refusal of a mesh larger than the group."""
    try:
        make_mesh(3, 2)
        refused = None
    except ValueError as e:
        refused = str(e)
    mesh = make_mesh(2, 2)
    tr = trainer(mode, False, n_linear)
    state = tr.init_state(tr.generator(5))
    rng = np.random.default_rng(5)
    emg = torch.from_numpy(rng.standard_normal(
        (8, CFG.max_tasks, CFG.emg_dim)).astype(np.float32))
    h = Hyper.single(1e-3, 1e-2, 0.0, 2e-3, 3e-2, 0.0)
    tr._sgd_step(state, emg, h, 1e-3, 2e-3, None)
    back = gather_state(shard_state(state, mesh, HIDDEN), mesh)
    same = all(torch.equal(a, b) for a, b in zip(
        state.model.state_dict().values(), back.model.state_dict().values()))
    same &= all(np.array_equal(a, b) for a, b in zip(_moments(state),
                                                     _moments(back)))
    same &= back.model.emg_net.mesh is None and not any(
        "shard" in m.__dict__ for m in back.model.modules())
    return dict(refused=refused, round_trip=bool(same))


def remat_vs_stored(rank, mesh_shape, fused, steps=2):
    """``steps`` sharded f32 steps at dropout 0.5 with ``remat`` and
    without, eager or fused, from the same weights, batches and generator
    seed: whether the losses, accuracies, gathered states (both Adam
    chains) and the generators' states are bit-equal."""
    mesh = make_mesh(*mesh_shape)
    rng = np.random.default_rng(9)
    emg = torch.from_numpy(rng.standard_normal(
        (8, CFG.max_tasks, CFG.emg_dim)).astype(np.float32))
    h = Hyper.single(*DROPOUT)
    runs = []
    for remat in (False, True):
        tr = trainer(n_linear=3, use_fused_train=fused, remat=remat)
        step, place = make_sharded_train_step(tr, mesh)
        state = place(tr.init_state(tr.generator(4)))
        gen = tr.generator(5)
        out = [step(state, emg, h, 1e-3, 2e-3, gen) for _ in range(steps)]
        runs.append((out, gather_state(state, mesh), gen.get_state()))
    (o0, s0, g0), (o1, s1, g1) = runs
    same = all(torch.equal(a, b) for x, y in zip(o0, o1)
               for a, b in zip(x, y))
    same &= all(torch.equal(a, b) for a, b in zip(
        s0.model.state_dict().values(), s1.model.state_dict().values()))
    same &= all(np.array_equal(a, b) for a, b in zip(_moments(s0),
                                                     _moments(s1)))
    return dict(bit_equal=bool(same and torch.equal(g0, g1)))


def bf16_vs_unsharded(rank, mesh_shape, fused, sd, emg_b, hyper):
    """The loss and the gradients of one sharded bf16 step at dropout 0
    (``loss_and_grads`` under the mesh, the sharded weights' gradients
    gathered), eager or fused, from the state dict ``sd`` (the JAX bf16
    state's weights); on rank 0 also the unsharded port step's."""
    mesh = make_mesh(*mesh_shape)
    tr = trainer(use_fused_train=fused, compute_dtype="bfloat16")
    h = Hyper.single(*hyper)
    emg = torch.from_numpy(emg_b)

    def state():
        return TrainState.fresh(model_from_state_dict(
            {k: torch.from_numpy(v) for k, v in sd.items()},
            dtype=torch.bfloat16))

    sharded = shard_state(state(), mesh, HIDDEN)
    loss, _, grads = tr.loss_and_grads(sharded, emg, h, None, mesh=mesh)
    out = dict(loss=float(loss), grads={
        k: g.numpy().copy() for k, g in
        gather_grads(sharded.model, grads).items()})
    if rank == 0:
        plain = state()
        loss, _, grads = tr.loss_and_grads(plain, emg, h, None)
        out.update(plain_loss=float(loss), plain_grads={
            k: g.numpy().copy() for k, g in
            gather_grads(plain.model, grads).items()})
    return out


def stacked_refused(rank):
    """A stacked (sweep) state's sharded step raises, naming the sweep's
    own sharding."""
    mesh = make_mesh(4, 1)
    tr = trainer()
    step, _ = make_sharded_train_step(tr, mesh)
    state = tr.init_sweep_state([tr.generator(c) for c in range(2)])
    emg = torch.zeros((2, 8, CFG.max_tasks, CFG.emg_dim))
    try:
        step(state, emg, Hyper.single(1e-3, 0, 0, 1e-3, 0, 0), 1e-3, 1e-3,
             None)
    except ValueError as e:
        return str(e)
    return None


def sweep(rank, n_dp, n_configs, chunk, seed):
    """``cross_validate(mesh=)`` over ``n_dp`` ranks and, on rank 0, the
    unsharded sweep at the same chunk (both with dropout)."""
    mesh = make_mesh(n_dp, 1)
    if not mesh.active:
        return None
    tr = trainer(batch_size=150, conv_features=8)
    hypers = crossval.sample_hyperparams(n_configs, seed=seed)
    got = crossval.cross_validate(tr, hypers, epochs=1, seed=seed,
                                  chunk=chunk, verbose=False, mesh=mesh)
    want = None
    if rank == 0:
        want = crossval.cross_validate(tr, hypers, epochs=1, seed=seed,
                                       chunk=chunk, verbose=False)
    return dict(got=got, want=want)


def serve(rank, n_sessions, ticks, subset):
    """The batched engine sharded over 2 ranks against the unsharded one
    (rank 0): ``step`` tick by tick and ``steps`` in one call, session 1
    restricted to ``subset``; and the refusal of a session count that
    does not divide by dp."""
    mesh = make_mesh(2, 1)
    if not mesh.active:
        return None
    model = ContrastiveModel(generator=torch.Generator().manual_seed(1))
    rng = np.random.default_rng(2)
    mean = rng.normal(0, 0.5, CFG.emg_dim).astype(np.float32)
    std = rng.uniform(0.5, 2.0, CFG.emg_dim).astype(np.float32)
    raw = (rng.standard_normal((ticks, n_sessions, CFG.factor, CFG.emg_dim))
           * 200).astype(np.float32)
    calib = (rng.standard_normal((n_sessions, 4000, CFG.emg_dim))
             * 200).astype(np.float32)
    masks = np.ones((n_sessions, CFG.max_tasks), bool)
    masks[1] = False
    masks[1, list(subset)] = True
    out = {}
    try:
        BatchedStreamingEngine(CFG, model, mean, std, n_sessions - 1,
                               mesh=mesh)
        out["refused"] = None
    except ValueError as e:
        out["refused"] = str(e)
    engines = {"sharded": BatchedStreamingEngine(CFG, model, mean, std,
                                                 n_sessions, mesh=mesh)}
    if rank == 0:
        engines["plain"] = BatchedStreamingEngine(CFG, model, mean, std,
                                                  n_sessions)
    for name, eng in engines.items():
        eng.calibrate_session(3, calib[3])  # on rank 0's half
        eng.calibrate_session(6, calib[6])  # on rank 1's half
        carries = eng.init_carries()
        preds, votes, scores = [], [], []
        for k in range(ticks):
            carries, p, v, s = eng.step(carries, raw[k], masks)
            preds.append(p.numpy())
            votes.append(v.numpy())
            scores.append(s.numpy())
        _, ps, vs = eng.steps(eng.init_carries(), raw, masks)
        out[name] = dict(preds=np.stack(preds), votes=np.stack(votes),
                         scores=np.stack(scores), steps_preds=ps.numpy(),
                         steps_votes=vs.numpy())
    return out


JOBS = {f.__name__: f for f in (step_vs_jax, f64_vs_unsharded,
                                shard_round_trip, remat_vs_stored,
                                bf16_vs_unsharded, stacked_refused, sweep,
                                serve)}


# ---------------------------------------------------------------- CLIs
def _small_cli():
    """``cptorch-train`` on the one-person store at small width."""
    def one_person(args, cfg, device):
        return DeviceStore(cfg, *processed_data(), device=device)

    cli_train.build_store = one_person
    port_engine.Trainer = functools.partial(Trainer, n_linear=2,
                                            hidden=HIDDEN)


def cli_train_args(out_dir: str) -> list:
    return ["--synthetic", "--final_epochs", "1", "--batch_size", "8",
            "--no_adabn", "--platform", "cpu", "--crossval_size", "4",
            "--crossval_chunk", "2", "--data_dir", out_dir,
            "--checkpoint_dir", out_dir]


def cli_serve_args(out: str) -> list:
    return ["--demo", "--platform", "cpu", "--seconds", "0.25", "--quiet",
            "--sessions", "8", "--replay", "--out", out]


def clis(rank, path, out_dir):
    """``--spmd_crossval`` and ``--spmd --replay`` in each rank of a
    2-rank group (ranks 0 and 1 of the plan's group, regrouped)."""
    dist.destroy_process_group()
    if rank > 1:
        return None
    dist.init_process_group("gloo", init_method=f"file://{path}", rank=rank,
                            world_size=2)
    _small_cli()
    rc_train = cli_train.main([*cli_train_args(out_dir), "--spmd_crossval"])
    rc_serve = cli_serve.main([*cli_serve_args(
        os.path.join(out_dir, "serve.npz")), "--spmd"])
    return dict(rc=(rc_train, rc_serve))


def run_plan(rank, world, plan, out_dir):
    results, seconds = {}, {}
    for key, name, kwargs in plan:
        t0 = time.perf_counter()
        results[key] = JOBS[name](rank, **kwargs)
        seconds[key] = time.perf_counter() - t0
    t0 = time.perf_counter()
    results["clis"] = clis(rank, os.path.join(out_dir, "rdv2"), out_dir)
    seconds["clis"] = time.perf_counter() - t0
    results["seconds"] = seconds
    return results
