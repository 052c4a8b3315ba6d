"""``cptorch-parity``: the one-command artifact parity check, the port of
``cptpu-parity``.

Compares a results directory (what ``cptorch-train --test --results_dir``
or ``cptorch-results`` export) against a reference artifact directory (the
reference's shipped ``data/``, a JAX package run, or another run), prints
a PASS/FAIL table with explicit tolerances (``results/parity.py``), and
exits 1 on a failure, 0 otherwise.
"""
from __future__ import annotations

import argparse
import sys

from contrastiveprosthetics_torch.results.parity import (
    Tolerances,
    compare_results,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cptorch-parity", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("results_dir",
                   help="directory of artifacts to check (y_pred.npy, "
                        "voting.npy, confusion_matrix.npy, *_grasp.*)")
    p.add_argument("--ref", required=True,
                   help="reference artifact directory")
    t = Tolerances()
    p.add_argument("--tol_acc", type=float, default=t.tol_acc,
                   help="|Δ| bound for aggregate accuracies "
                        f"(default {t.tol_acc})")
    p.add_argument("--tol_curve", type=float, default=t.tol_curve,
                   help="max |Δ| bound for voting / grasp curves "
                        f"(default {t.tol_curve})")
    p.add_argument("--tol_class", type=float, default=t.tol_class,
                   help="max |Δ| bound for per-class accuracy "
                        f"(48-sample rows are noisy; default {t.tol_class})")
    p.add_argument("--tol_std", type=float, default=t.tol_std,
                   help="max |Δ| bound for the std_grasp spread curve "
                        f"(default {t.tol_std})")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    rep = compare_results(
        args.results_dir, args.ref,
        Tolerances(args.tol_acc, args.tol_curve, args.tol_class,
                   args.tol_std))
    print(rep.table())
    return 0 if rep.ok else 1


if __name__ == "__main__":
    sys.exit(main())
