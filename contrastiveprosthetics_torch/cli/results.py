"""Results CLI (``cptorch-results``), the port of ``cptpu-results``
(reference ``results.py``, the train CLI's flags, ``results.py:126-143``):
rebuild the best config of the cached crossval, load the checkpoint, run
the test pass from the same generator seed ``cptorch-train --test`` uses,
and export the full artifact set, the set-size sweep and ``results.png``
included (``results/export.py``). ``--per_subject_eval`` adds the
per-subject accuracies. ``--prediction``, ``--glove`` and
``--glove_encoding`` name the checkpoint's mode, as for ``cptorch-train``.
``--bf16``, ``--profile`` and any ``--prng_impl`` are accepted and change
nothing, as ``cptpu-results`` reads none of them (its ``cli/results.py:
15-17,42-63``): the checkpoint is evaluated in float32 and untraced, and
the test pass draws from torch's generators. A ``--checkpoint_dir`` that
holds only the JAX package's ``contrastive.msgpack`` exits naming
``cptorch-import``.
"""
from __future__ import annotations

from contrastiveprosthetics_torch.cli.train import (
    build_parser,
    build_store,
    checkpoint_file,
    load_state,
    make_trainer,
    reject_conflicts,
    report_per_subject,
)
from contrastiveprosthetics_torch.device import select_device


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    reject_conflicts(args)
    ckpt_path = checkpoint_file(args.checkpoint_dir)
    device = select_device(args.platform)

    from contrastiveprosthetics_torch.config import DEFAULT_CONFIG, compat_config
    from contrastiveprosthetics_torch.results.export import export_results
    from contrastiveprosthetics_torch.train.crossval import (
        best_config,
        hyper_from_key,
        load_crossval,
    )
    from contrastiveprosthetics_torch.train.loop import run_test

    cfg = compat_config(DEFAULT_CONFIG) if args.compat else DEFAULT_CONFIG
    print("Loading dataset")
    store = build_store(args, cfg, device)
    trainer = make_trainer(
        args, cfg, store,
        use_fused_encoder=True if args.fused_encoder else None)
    print("Dataset loaded")

    values, keys = load_crossval(args.data_dir, id_=args.crossval_id)
    _, hyper = hyper_from_key(best_config(values, keys))
    state = load_state(trainer, ckpt_path, device)

    t = run_test(trainer, state, hyper, trainer.generator(args.seed + 5))
    out_dir = args.results_dir or args.data_dir
    summary = export_results(t, out_dir, n_classes=cfg.max_tasks)
    print("loss,\t\t\tcorrect")
    print((float(t.loss), float(t.accuracy)))
    print(f"artifacts exported to {out_dir}")
    print("voting curve (first→last):", summary["voting_curve"][0], "→",
          summary["voting_curve"][-1])
    if args.per_subject_eval:
        report_per_subject(trainer, state, hyper, out_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
