"""Training CLI (``cptorch-train``), the port of ``cptpu-train``.

Keeps the reference's flags (``train.py:251-268``; the ``--no_*`` flags
are ``store_false``: passing one switches the feature off) and adds
``--data_dir``, ``--checkpoint_dir``, ``--results_dir`` (the artifact
set, ``results/export.py``), ``--synthetic`` (fabricated, class-separable
data), ``--crossval_chunk`` (configs trained at once), ``--seed``,
``--crossval_id``, ``--compat``, ``--fused_encoder``, ``--fused_train``,
``--spmd_crossval``, ``--per_subject_eval``, ``--pallas_loss``,
``--prng_impl``, ``--bf16``, ``--profile`` and ``--glove_encoding`` (the
JAX CLI's flags) and ``--platform`` (cuda by default). ``--pallas_loss``
is a no-op: on CUDA the K1 kernels are the loss's only path.

Modes (``train/engine.py``): ``--prediction`` trains the softmax
baseline, with ``--glove`` from the glove angles; ``--glove_encoding``
trains the contrastive model with class embeddings from the glove
angles; ``--glove`` alone changes nothing, as in the JAX CLI. The
baseline runs on neither fused path: ``--fused_train on`` and
``--fused_encoder`` warn there and run unfused, as ``--fused_encoder``
does under glove encoding.

Flow (``train.py:168-249``): load the store -> hyperparameters
(``--crossval_load``: the cached sweep, or the sweep when there is no
cache; ``--crossval_size 0``: the canonical ones; else the random-search
sweep, ``train/crossval.py``) -> the nanargmax-val-acc config -> final
annealed train, checkpointing on val loss -> reload the best checkpoint
-> ``--test`` (then ``--results_dir``'s artifacts and
``--per_subject_eval``, contrastive modes only). ``--bf16`` trains and
evaluates the EMG tower in bfloat16 (``Trainer(compute_dtype=
"bfloat16")``, as the JAX CLI's ``:154``), the sweep and the final run
alike; the checkpoint stays the f32 reference state_dict and is reloaded
in bf16. ``--profile`` traces the whole run with ``torch.profiler``
(CPU and CUDA activities on the card, the CPU alone on the CPU) and
writes a Chrome trace under ``$TMPDIR/cptorch_trace`` (``/tmp`` by
default), as the JAX CLI traces to ``/tmp/cptpu_trace``; it prints the
mean device time a step of each ``cptorch.train.*`` span (the step and
its forward, backward and Adam) once for the sweep's stacked steps and
once for the final train's.
``--fused_train on`` and ``--fused_encoder`` hold for the sweep too: its
stacked steps run the fused chain at its config axis and its validation
the fused encoder, one ``encoder_chain`` call a batch for the chunk.
``--spmd_crossval`` shards the sweep's configs over ranks
(``train/crossval.py``, ``cross_validate(mesh=)``), as the JAX CLI does
over more than one device: over the ranks of an initialized default
process group (torchrun, or a caller's group), else with more than one
CUDA device visible over one NCCL rank per device, which the CLI starts
itself; with one device it runs unsharded and says so. Under a group,
rank 0 alone runs the final train and writes the caches, the checkpoint
and the artifacts. A ``--prng_impl`` other than ``auto`` exits with its
reason.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys
import tempfile
import time

import numpy as np
import torch.distributed as dist

from contrastiveprosthetics_torch.device import add_platform_flag, select_device
from contrastiveprosthetics_torch.utils import spans


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Training on ninapro dataset")
    p.add_argument("--crossval_size", type=int, default=10)
    p.add_argument("--crossval_epochs", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--final_epochs", type=int, default=10)
    p.add_argument("--glove", action="store_true")
    p.add_argument("--db2", action="store_true")
    p.add_argument("--load_model", action="store_true")
    p.add_argument("--crossval_load", action="store_true")
    p.add_argument("--prediction", action="store_true")
    p.add_argument("--no_adabn", action="store_false")
    p.add_argument("--no_checkpoint", action="store_false")
    p.add_argument("--no_verbose", action="store_false")
    p.add_argument("--test", action="store_true")
    p.add_argument("--data_dir", type=str, default="data")
    p.add_argument("--checkpoint_dir", type=str, default="checkpoints")
    p.add_argument("--results_dir", type=str, default=None,
                   help="export the full artifact set after --test")
    p.add_argument("--synthetic", action="store_true",
                   help="train on fabricated class-separable data")
    p.add_argument("--crossval_chunk", type=int, default=None,
                   help="configs trained at once as one stacked model "
                        "(default: train/crossval.py::DEFAULT_SWEEP_CHUNK)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--crossval_id", type=str, default="",
                   help="suffix of cross_val_{keys,values}<id>.npy")
    p.add_argument("--compat", action="store_true",
                   help="reproduce every reference quirk (config.py)")
    p.add_argument("--fused_encoder", action="store_true",
                   help="plain-BN contrastive evaluation runs the whole "
                        "encoder and the class head as one encoder_chain "
                        "call per batch (ops/kernels.py), folded once per "
                        "evaluation")
    p.add_argument("--fused_train", type=str, default="auto",
                   choices=("auto", "on", "off"),
                   help="the fused training chain for the EMG dense stack "
                        "(ops/train_fused.py: BatchNorm statistics ride the "
                        "GEMM kernels, dropout masks drawn in the kernels). "
                        "auto = the Trainer's default (off)")
    p.add_argument("--spmd_crossval", action="store_true",
                   help="shard the sweep's configs over several devices")
    p.add_argument("--per_subject_eval", action="store_true",
                   help="after --test, also evaluate each subject in its own "
                        "batch (per-subject AdaBN statistics, the "
                        "reference's stated intent, models.py:245) and "
                        "report and export per-subject accuracy")
    p.add_argument("--glove_encoding", action="store_true",
                   help="encode real glove angles as class embeddings")
    p.add_argument("--pallas_loss", action="store_true",
                   help="the fused contrastive loss kernels: a no-op here, "
                        "since on CUDA they are the loss's only path")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 encoder compute (mixed precision)")
    p.add_argument("--profile", action="store_true",
                   help="trace the training run")
    p.add_argument("--prng_impl", type=str, default="auto",
                   choices=("auto", "threefry2x32", "rbg", "unsafe_rbg"),
                   help="the JAX CLI's PRNG choice; only auto runs here "
                        "(torch's Philox)")
    add_platform_flag(p)
    return p


def build_store(args, cfg, device):
    from contrastiveprosthetics_torch.data.store import DeviceStore
    from contrastiveprosthetics_torch.data.synthetic import (
        make_processed_dataset,
    )

    if args.synthetic:
        emg, pos, glove = make_processed_dataset(cfg)
        return DeviceStore(cfg, emg, pos, glove, device=device)
    return DeviceStore.load(cfg, args.data_dir, device=device)


def reject_conflicts(args) -> None:
    """The flag pair that no CLI of either package runs."""
    if args.per_subject_eval and args.prediction:
        raise SystemExit("--per_subject_eval scores contrastive logits, "
                         "which --prediction does not make (as in the JAX "
                         "CLI): drop one of the two")


@contextlib.contextmanager
def launcher_group(device, asked: bool):
    """Where a flag ``asked`` for sharding, under a launcher such as
    torchrun (``WORLD_SIZE`` above 1 in the environment) with no group
    yet: the launcher's group for the run, NCCL on CUDA (the rank's
    ``LOCAL_RANK`` device), gloo on the CPU. Otherwise no group: each
    process runs the whole command."""
    if (not asked or dist.is_initialized()
            or int(os.environ.get("WORLD_SIZE", "1")) < 2):
        yield
        return
    import torch

    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method="env://")
    try:
        yield
    finally:
        dist.destroy_process_group()


def spmd_ranks(flag: str, what: str, device, sessions: int | None = None
               ) -> int:
    """How many ranks ``--spmd_crossval`` and ``--spmd`` shard over, as
    the JAX CLIs shard only over more than one device (of ``sessions``
    dividing by the count, for ``--spmd``): the initialized default
    group's ranks, else the visible CUDA devices. 1: unsharded, which it
    says."""
    import torch

    if dist.is_initialized():
        n, where = dist.get_world_size(), "rank"
    else:
        n = torch.cuda.device_count() if device.type == "cuda" else 1
        where = f"{device.type} device"
    if n > 1 and (sessions is None or sessions % n == 0):
        return n
    print(f"{flag}: {n} {where}{'s' if n > 1 else ''} visible, {what} "
          "unsharded")
    return 1


def rank0() -> bool:
    """Whether this process writes the outputs: rank 0 of a group, or no
    group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def spawn_ranks(entry, argv, n: int) -> int:
    """``entry(argv)`` in ``n`` processes, one NCCL rank per CUDA device,
    joined by a ``file://`` rendezvous in a temporary directory. The
    kernels are built first, so that the ranks load them and never race
    on the build directory."""
    import torch.multiprocessing as mp

    from contrastiveprosthetics_torch.ops import _build

    _build.build()
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank, args=(entry, argv, n, os.path.join(tmp, "rdv")),
                 nprocs=n)
    return 0


def _rank(rank: int, entry, argv, n: int, path: str) -> None:
    import torch

    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"file://{path}", rank=rank,
                            world_size=n)
    try:
        entry(argv)
    finally:
        dist.destroy_process_group()


def trace_dir() -> str:
    """Where ``--profile`` writes its Chrome trace."""
    return os.path.join(tempfile.gettempdir(), "cptorch_trace")


@contextlib.contextmanager
def profiled(on: bool, device):
    """``--profile``: the enclosed run under ``torch.profiler``, its
    Chrome trace written to :func:`trace_dir` when the run ends, then the
    final train's :func:`step_spans`."""
    if not on:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    spans.clear()
    with profile(activities=activities) as prof:
        yield
    out = trace_dir()
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, f"cptorch_train_{time.strftime('%Y%m%d_%H%M%S')}"
                             f"_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    print(f"profile trace written to {out}")
    print(f"  {path}")
    step_spans("final train")


def step_spans(phase: str) -> None:
    """Under ``--profile``, each train step span's mean device time a step
    of ``phase`` (``utils/spans.py``: its newest ``KEEP`` steps), one line
    a span, then forget them; nothing where no span was kept."""
    for name in spans.names("cptorch.train."):
        ms = spans.device_ms(name)
        print(f"  {phase} {name}: " + (f"{ms:.3f} ms a step on the device"
                                       if ms is not None else
                                       "device time not measured (no CUDA)"))
    spans.clear()


def checkpoint_file(checkpoint_dir: str) -> str:
    """``contrastive.pt`` in ``checkpoint_dir``. Where only a JAX
    checkpoint (``contrastive.msgpack``) is there, exits naming
    ``cptorch-import``, which converts it."""
    path = os.path.join(checkpoint_dir, "contrastive.pt")
    jax_path = os.path.join(checkpoint_dir, "contrastive.msgpack")
    if not os.path.exists(path) and os.path.exists(jax_path):
        raise SystemExit(
            f"{checkpoint_dir} holds contrastive.msgpack, a checkpoint of "
            "the JAX package, and no contrastive.pt: convert it with "
            f"cptorch-import {jax_path} (add --no_adabn for a model trained "
            "with --no_adabn)")
    return path


def make_trainer(args, cfg, store, **options):
    """The ``Trainer`` of the flags: the store, db2, AdaBN, batch size and
    mode, and what ``options`` asks for (the fused paths, the compute
    dtype)."""
    from contrastiveprosthetics_torch.train.engine import Trainer

    return Trainer(cfg, store, db2=args.db2, adabn=args.no_adabn,
                   prediction=args.prediction, glove=args.glove,
                   glove_encoding=args.glove_encoding,
                   batch_size=args.batch_size, **options)


def load_state(trainer, path: str, device):
    """The checkpoint at ``path`` on ``device``, in the trainer's compute
    dtype, which must be of the trainer's mode."""
    from contrastiveprosthetics_torch.train.checkpoint import load_checkpoint

    state = load_checkpoint(path, device, dtype=trainer.dtype)
    model = state.model
    want = (trainer.prediction, trainer.prediction and trainer.glove,
            trainer.glove_encoding and not trainer.prediction)
    have = (model.prediction, model.glove, model.glove_encoding)
    if have != want:
        names = ("--prediction", "--glove", "--glove_encoding")
        flags = " ".join(n for n, on in zip(names, have) if on) or "none"
        raise SystemExit(f"{path} holds a model of the flags {flags}; pass "
                         "the flags it was trained with")
    return state


def report_per_subject(trainer, state, hyper, out_dir=None, pooled=None):
    """``--per_subject_eval``: each subject's test items as one batch;
    prints the accuracies and, given ``out_dir``, exports them. Returns
    the (n_people,) accuracies."""
    from contrastiveprosthetics_torch.results.export import export_per_subject

    ps = trainer.evaluate_per_subject(state, hyper, split="test")
    people = trainer.store.people_ids(db2=trainer.db2)
    acc = ps.curve[:, -1].cpu().numpy().reshape(len(people), -1).mean(axis=1)
    print("per-subject test accuracy (own-batch AdaBN statistics):")
    for pid, a in zip(people, acc):
        print(f"  subject {int(pid)}: {a:.4f}")
    print(f"  mean: {acc.mean():.4f}"
          + ("" if pooled is None else f"  (pooled: {pooled:.4f})"))
    if out_dir:
        export_per_subject(ps, out_dir, people)
    return acc


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    reject_conflicts(args)
    if args.prng_impl != "auto":
        raise SystemExit(
            f"--prng_impl {args.prng_impl} names a JAX random-number "
            "generator; the port draws every random stream (init, "
            "shuffles, dropout) from torch's Philox generators, so no JAX "
            "stream can be reproduced: drop the flag or pass auto")
    crossval_load = args.crossval_load
    if crossval_load and not os.path.exists(os.path.join(
            args.data_dir, f"cross_val_values{args.crossval_id}.npy")):
        # go.sh passes --crossval_load unconditionally: on a clean machine
        # the sweep runs instead (the reference would crash here)
        print("no cached crossval found — running the sweep")
        crossval_load = False
    sweep = not crossval_load and args.crossval_size >= 1
    if args.load_model:
        checkpoint_file(args.checkpoint_dir)
    device = select_device(args.platform)
    with launcher_group(device, asked=args.spmd_crossval and sweep):
        return sharded_main(args, argv, device, crossval_load, sweep)


def sharded_main(args, argv, device, crossval_load: bool, sweep: bool
                 ) -> int:
    """``--spmd_crossval``'s ranks (see :func:`spmd_ranks`), then the
    run."""
    mesh = None
    if args.spmd_crossval and sweep:
        n = spmd_ranks("--spmd_crossval", "the sweep's configs", device)
        if n > 1 and not dist.is_initialized():
            return spawn_ranks(main, argv, n)
        if n > 1:
            from contrastiveprosthetics_torch.parallel.mesh import make_mesh

            mesh = make_mesh(n_dp=n)
            if rank0():
                print(f"crossval sharded over {mesh} "
                      f"({dist.get_backend()})")
    with profiled(args.profile, device):
        return run(args, device, crossval_load, sweep, mesh)


def run(args, device, crossval_load: bool, sweep: bool, mesh=None) -> int:
    """The run after the flags' checks: store, hyperparameters, the final
    train and the test. ``mesh``: the sweep's, shared by every rank; the
    ranks other than 0 stop after the sweep."""
    from contrastiveprosthetics_torch.config import DEFAULT_CONFIG, compat_config
    from contrastiveprosthetics_torch.train.crossval import (
        best_config,
        cross_validate,
        hyper_from_key,
        keys_array,
        load_crossval,
        sample_hyperparams,
    )
    from contrastiveprosthetics_torch.train.engine import Hyper
    from contrastiveprosthetics_torch.train.loop import run_test, train_loop

    cfg = compat_config(DEFAULT_CONFIG) if args.compat else DEFAULT_CONFIG
    print("Loading dataset")
    store = build_store(args, cfg, device)
    trainer = make_trainer(
        args, cfg, store,
        use_fused_train={"auto": None, "on": True,
                         "off": False}[args.fused_train],
        use_fused_encoder=True if args.fused_encoder else None,
        compute_dtype="bfloat16" if args.bf16 else "float32")
    print("Dataset loaded")

    if crossval_load:
        values, keys = load_crossval(args.data_dir, id_=args.crossval_id)
    elif not sweep:
        print("crossval skipped (--crossval_size 0): canonical "
              "hyperparameters")
        canonical = Hyper(*[[v] for v in (1e-3, 1e-6, 0.5, 1e-3, 1e-6, 0.3)])
        keys = keys_array(canonical, trainer.d_e)
        values = np.zeros((1, 2))
    else:
        hypers = sample_hyperparams(args.crossval_size, seed=args.seed)
        t0 = time.time()
        values = cross_validate(trainer, hypers, epochs=args.crossval_epochs,
                                seed=args.seed, chunk=args.crossval_chunk,
                                save_dir=args.data_dir, id_=args.crossval_id,
                                verbose=rank0(), mesh=mesh)
        if not rank0():
            return 0
        print(f"crossval: {args.crossval_size} configs in "
              f"{time.time() - t0:.1f}s")
        step_spans("crossval sweep")
        keys = keys_array(hypers, trainer.d_e)
    if not rank0():
        return 0
    best_key = best_config(values, keys)
    print(f"Best combination: {best_key}")
    _, hyper = hyper_from_key(best_key)
    if args.load_model:
        tenth = lambda lr: float(np.float32(lr) / np.float32(10))  # noqa: E731
        hyper = hyper._replace(lr_emg=tenth(hyper.lr_emg),
                               lr_glove=tenth(hyper.lr_glove))

    ckpt_path = os.path.join(args.checkpoint_dir, "contrastive.pt")
    init_state = None
    if args.load_model and os.path.exists(ckpt_path):
        print("Loading model")
        init_state = load_state(trainer, ckpt_path, device)
    res = train_loop(trainer, hyper, epochs=args.final_epochs,
                     seed=args.seed, annealing=True,
                     checkpoint=args.no_checkpoint, checkpoint_path=ckpt_path,
                     init_state=init_state, verbose=args.no_verbose)
    print("Final validation model statistics")
    print(f"val loss {res.val_loss:.4f}  val acc {res.val_acc:.6f}")

    state = res.state
    if args.no_checkpoint and os.path.exists(ckpt_path):
        state = load_state(trainer, ckpt_path, device)
    if args.test:
        t = run_test(trainer, state, hyper, trainer.generator(args.seed + 5))
        print("loss,\t\t\tcorrect")
        print((float(t.loss), float(t.accuracy)))
        if args.results_dir:
            from contrastiveprosthetics_torch.results.export import (
                export_results,
            )

            export_results(t, args.results_dir, n_classes=cfg.max_tasks)
            print(f"artifacts exported to {args.results_dir}")
        if args.per_subject_eval:
            report_per_subject(trainer, state, hyper, args.results_dir,
                               pooled=float(t.accuracy))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
