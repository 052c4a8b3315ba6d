"""Training CLI (``cptorch-train``), the port of ``cptpu-train``.

Keeps the reference's flags (``train.py:251-268``; the ``--no_*`` flags
are ``store_false``: passing one switches the feature off) and adds
``--data_dir``, ``--checkpoint_dir``, ``--results_dir`` (the artifact
set, ``results/export.py``), ``--synthetic`` (fabricated, class-separable
data), ``--crossval_chunk`` (configs trained at once), ``--seed``,
``--crossval_id``, ``--compat``, ``--fused_encoder``, ``--fused_train``,
``--spmd_crossval`` and ``--per_subject_eval`` (the JAX CLI's flags) and
``--platform`` (cuda by default).

Flow (``train.py:168-249``): load the store -> hyperparameters
(``--crossval_load``: the cached sweep, or the sweep when there is no
cache; ``--crossval_size 0``: the canonical ones; else the random-search
sweep, ``train/crossval.py``) -> the nanargmax-val-acc config -> final
annealed train, checkpointing on val loss -> reload the best checkpoint
-> ``--test`` (then ``--results_dir``'s artifacts and
``--per_subject_eval``). ``--prediction``, ``--glove``,
``--spmd_crossval``, and the sweep on the fused chain or with the fused
encoder's validation, are not ported yet and raise.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np

from contrastiveprosthetics_torch.device import add_platform_flag, select_device

NOT_PORTED = ("{what} is not ported to the PyTorch package yet "
              "(ROADMAP.md, queue 1 item {item}); {hint}")


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


def reject_unported_modes(args) -> None:
    if args.prediction or args.glove:
        raise SystemExit(NOT_PORTED.format(
            what="--prediction/--glove training", item=7,
            hint="only contrastive training with the one-hot class encoder "
                 "runs"))


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
    args = build_parser().parse_args(argv)
    reject_unported_modes(args)
    if args.spmd_crossval:
        raise SystemExit(NOT_PORTED.format(
            what="--spmd_crossval (the sweep's configs sharded over several "
                 "devices)", item=8,
            hint="drop the flag: the sweep trains its configs as one stacked "
                 "model on one device"))
    crossval_load = args.crossval_load
    if crossval_load and not os.path.exists(os.path.join(
            args.data_dir, f"cross_val_values{args.crossval_id}.npy")):
        # go.sh passes --crossval_load unconditionally: on a clean machine
        # the sweep runs instead (the reference would crash here)
        print("no cached crossval found — running the sweep")
        crossval_load = False
    sweep = not crossval_load and args.crossval_size >= 1
    if sweep and args.fused_train == "on":
        raise SystemExit(NOT_PORTED.format(
            what="the crossval sweep on the fused training chain", item=11,
            hint="the fused chain's kernels take no config axis yet; pass "
                 "--fused_train auto or off for the sweep"))
    if sweep and args.fused_encoder and not args.no_adabn:
        raise SystemExit(NOT_PORTED.format(
            what="the crossval sweep's validation on the fused encoder "
                 "(--fused_encoder)", item=12,
            hint="encoder_chain takes no config axis yet; drop "
                 "--fused_encoder for the sweep, or pass --crossval_load "
                 "with a cached sweep or --crossval_size 0"))
    device = select_device(args.platform)

    from contrastiveprosthetics_torch.config import DEFAULT_CONFIG, compat_config
    from contrastiveprosthetics_torch.train.checkpoint import load_checkpoint
    from contrastiveprosthetics_torch.train.crossval import (
        best_config,
        cross_validate,
        hyper_from_key,
        keys_array,
        load_crossval,
        sample_hyperparams,
    )
    from contrastiveprosthetics_torch.train.engine import Hyper, Trainer
    from contrastiveprosthetics_torch.train.loop import run_test, train_loop

    cfg = compat_config(DEFAULT_CONFIG) if args.compat else DEFAULT_CONFIG
    print("Loading dataset")
    store = build_store(args, cfg, device)
    trainer = Trainer(cfg, store, db2=args.db2, adabn=args.no_adabn,
                      batch_size=args.batch_size,
                      use_fused_train={"auto": None, "on": True,
                                       "off": False}[args.fused_train],
                      use_fused_encoder=True if args.fused_encoder else None)
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
                                save_dir=args.data_dir, id_=args.crossval_id)
        print(f"crossval: {args.crossval_size} configs in "
              f"{time.time() - t0:.1f}s")
        keys = keys_array(hypers, trainer.d_e)
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
        init_state = load_checkpoint(ckpt_path, device)
    res = train_loop(trainer, hyper, epochs=args.final_epochs,
                     seed=args.seed, annealing=True,
                     checkpoint=args.no_checkpoint, checkpoint_path=ckpt_path,
                     init_state=init_state, verbose=args.no_verbose)
    print("Final validation model statistics")
    print(f"val loss {res.val_loss:.4f}  val acc {res.val_acc:.6f}")

    state = res.state
    if args.no_checkpoint and os.path.exists(ckpt_path):
        state = load_checkpoint(ckpt_path, device)
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
