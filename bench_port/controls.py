"""The readings that the limits of ``bench_port/limits/`` are set from.

    python -m bench_port.controls --workload <name> --seconds <s> \
        --seeds <n> [<n> ...] [--fault <kind>]

runs the cell once a seed in one process, as ``bench_port.run`` does, and
prints a JSON line a seed with the program's numbers (``checks``) and the
control's (``controls``): the plain reference put in the program's place
and computed in the precision below the configuration's (f32: TF32
products; bf16: float8 e4m3 products), compared by the same rule. With
``--fault`` the port runs with that fault planted (``faults.py``). The
benchmark's own runs never compute the control.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys

from bench_port import faults, harness, run

CONTROL = {"float32": "tf32", "bfloat16": "fp8"}


def readings(workload: str, seed: int, seconds: float, overrides: dict
             ) -> dict:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", workload, "--seed", str(seed),
                       "--seconds", str(seconds), "--trace", "0"],
                      overrides=overrides)
    lines = out.getvalue().strip().splitlines()
    if rc != 0 or len(lines) < 2:
        return {"seed": seed, "rc": rc}
    notes, result = json.loads(lines[-2])["notes"], json.loads(lines[-1])
    return {"seed": seed, "correct": result["correct"],
            "checks": {k: v["value"] for k, v in result["checks"].items()},
            "controls": notes.get("controls", {}),
            "later_loss_gap": notes.get("later_loss_gap")}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", default=None)
    p.add_argument("--no_control", action="store_true")
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)
    overrides = {} if args.no_control else {
        "controls": [CONTROL[cell.config["dtype"]]]}
    plant = (faults.planted(cell.traffic["driver"], args.fault)
             if args.fault else contextlib.nullcontext())
    with plant:
        for seed in args.seeds:
            line = readings(args.workload, seed, args.seconds, overrides)
            line["fault"] = args.fault
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
