"""Whole-run parity of the PyTorch port against the JAX package, on the CPU.

``scripts/synth_parity.py`` holds the JAX package against the reference's
own training; this holds the port against the JAX package the same way.
One synthetic processed dataset is made with numpy from a seed (the
port's ``make_processed_dataset``) and given to both packages' stores.
For each of N seeds each package trains (``Trainer`` + ``train_loop``,
annealed, the canonical hyperparameters), tests (``run_test``) and
sweeps set sizes (``subset_size_sweep``, inside ``summarize``). The two
frameworks' random streams never match, so the two are judged by
``synth_parity.py::summarize``, imported unchanged: the cross-package gap
of voted accuracy, of the 24-column voting curve and of the set-size
curve must each sit inside the seed spread, floored by the test set's
binomial noise.

It is a tool beside the port, not part of it, so it imports both
packages; both run on the CPU. The geometry is
``tests/test_synth_parity.py``'s: two people, single-batch epochs (which
avoid XLA:CPU's slow scans over many batches), 10 of them: ten Adam
steps take both packages far above chance, where four left the voted
accuracy near it. Prints one JSON line; exits 0 when the criterion
holds::

    python scripts/port_synth_parity.py --people 2 --epochs 10 --seeds 2
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
SCRIPTS = REPO / "scripts"

# tests/test_synth_parity.py's geometry: plain BatchNorm (as go.sh),
# single-batch epochs at 2 people (600 items), both towers' lr 1e-2 (few
# optimizer steps), class signal 4.0, 32 set-size trials a size
BATCH_SIZE, LR, SEPARABILITY, TRIALS, EPOCHS = 600, 1e-2, 4.0, 32, 10


def run_jax_side(data, cfg, hyper: dict, epochs: int, seeds):
    """``synth_parity.run_our_side`` (the JAX package's train, test and
    logits per seed, in its record layout), with ``train_loop`` epoch by
    epoch (``verbose``, its prints sent to stderr): the same random
    stream as its one-program scan over epochs, which XLA:CPU runs about
    20x slower."""
    import contextlib

    import jax

    from contrastiveprosthetics_tpu.data.store import DeviceStore
    from contrastiveprosthetics_tpu.train.engine import Hyper, Trainer
    from contrastiveprosthetics_tpu.train.loop import run_test, train_loop

    trainer = Trainer(cfg, DeviceStore(cfg, *data), adabn=False,
                      batch_size=BATCH_SIZE)
    h = Hyper.single(**{k: v for k, v in hyper.items() if k != "d_e"})
    results = []
    for seed in seeds:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            res = train_loop(trainer, h, epochs=int(epochs),
                             key=jax.random.PRNGKey(seed), annealing=True,
                             verbose=True)
        t = run_test(trainer, res.state, h, jax.random.PRNGKey(seed + 1000))
        results.append({
            "seed": int(seed),
            "acc": float(t.accuracy),
            "curve": np.asarray(t.curve, np.float64),
            "logits": np.asarray(t.logits, np.float32),
            "seconds": round(time.perf_counter() - t0, 1),
        })
        print(f"[jax seed {seed}] voted acc {float(t.accuracy):.4f} "
              f"({results[-1]['seconds']} s)", file=sys.stderr)
    return results, trainer


def run_port_side(data, cfg, hyper: dict, epochs: int, seeds) -> list[dict]:
    """The port's train, test and logits per seed, on the CPU, in the
    record layout of ``synth_parity.run_our_side``."""
    import torch

    from contrastiveprosthetics_torch.data.store import DeviceStore
    from contrastiveprosthetics_torch.train.engine import Hyper, Trainer
    from contrastiveprosthetics_torch.train.loop import run_test, train_loop

    trainer = Trainer(cfg, DeviceStore(cfg, *data, device=torch.device("cpu")),
                      adabn=False, batch_size=BATCH_SIZE)
    h = Hyper.single(hyper["lr_emg"], hyper["reg_emg"], hyper["dp_emg"],
                     hyper["lr_glove"], hyper["reg_glove"], hyper["dp_glove"])
    results = []
    for seed in seeds:
        t0 = time.perf_counter()
        res = train_loop(trainer, h, epochs=int(epochs), seed=seed,
                         annealing=True, verbose=False)
        t = run_test(trainer, res.state, h, trainer.generator(seed + 1000))
        results.append({
            "seed": int(seed),
            "acc": float(t.accuracy),
            "curve": t.curve.cpu().numpy().astype(np.float64),
            "logits": t.logits.cpu().numpy().astype(np.float32),
            "seconds": round(time.perf_counter() - t0, 1),
        })
        print(f"[port seed {seed}] voted acc {float(t.accuracy):.4f} "
              f"({results[-1]['seconds']} s)", file=sys.stderr)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--people", type=int, default=2,
                    help="db3 subjects to fabricate")
    ap.add_argument("--epochs", type=int, default=EPOCHS,
                    help="final-train epochs, one optimizer step each")
    ap.add_argument("--seeds", type=int, default=2,
                    help="seeds a package")
    ap.add_argument("--out", default=None,
                    help="also write the full summary here (JSON)")
    args = ap.parse_args(argv)

    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(SCRIPTS))
    import jax

    jax.config.update("jax_platforms", "cpu")
    from synth_parity import summarize

    from contrastiveprosthetics_torch.config import DEFAULT_CONFIG as port_cfg
    from contrastiveprosthetics_torch.data.synthetic import (
        make_processed_dataset,
    )
    from contrastiveprosthetics_tpu.config import DEFAULT_CONFIG as jax_cfg

    data = make_processed_dataset(
        port_cfg, people_positions=list(range(40, 40 + args.people)),
        separability=SEPARABILITY, seed=0)
    hyper = {"d_e": 16, "lr_emg": LR, "reg_emg": 1e-6, "dp_emg": 0.5,
             "lr_glove": LR, "reg_glove": 1e-6, "dp_glove": 0.3}
    seeds = list(range(args.seeds))

    t0 = time.perf_counter()
    jax_runs, jax_trainer = run_jax_side(data, jax_cfg, hyper, args.epochs,
                                         seeds)
    jax_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    port_runs = run_port_side(data, port_cfg, hyper, args.epochs, seeds)
    port_s = time.perf_counter() - t0

    view = jax_trainer.view_test
    summary = summarize(jax_runs, port_runs, trials=TRIALS,
                        n_preds=view.D * view.n_tasks)
    summary["jax"] = summary.pop("reference")
    summary["port"] = summary.pop("ours")
    summary["config"] = {
        "people": args.people, "epochs": args.epochs, "seeds": args.seeds,
        "batch_size": BATCH_SIZE, "separability": SEPARABILITY,
        "trials": TRIALS, "adabn": False, "hyper": hyper,
        "D_test": int(view.D), "seconds": {"jax": round(jax_s, 1),
                                           "port": round(port_s, 1)}}
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(summary, indent=1)
                                          + "\n")
    print(json.dumps({
        "acc_jax": summary["jax"]["acc_mean"],
        "acc_port": summary["port"]["acc_mean"],
        "acc_gap": summary["acc_gap"], "acc_tol": summary["acc_tol"],
        "curve_gap": summary["curve_gap"], "curve_tol": summary["curve_tol"],
        "grasp_gap": summary["grasp_gap"], "grasp_tol": summary["grasp_tol"],
        "seconds": summary["config"]["seconds"], "ok": summary["ok"]}))
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
