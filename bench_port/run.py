"""Run one cell of the port's benchmark once.

    python -m bench_port.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. It finds the cell in ``BENCHMARK.json``, its
configuration, traffic mix, metric readers and limits under
``bench_port/`` (``harness.py``), sets the cell up from the seed, measures
for ``--seconds`` seconds, checks what the timed path produced against the
plain reference, and prints one JSON line last on standard output: the
cell's end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``. An earlier line gives the card's state before and after the
window and how late the traffic generator ran. The numbers compared, each
beside its limit, are the last lines on standard error and the last key of
the result.

It exits with 2, printing no result, when no CUDA device is visible or
fewer than the cell asks for, or when a module of JAX or of the JAX
package was loaded; and with an import error where the port is missing
from the checkout.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# build and kernel caches at fixed paths inside the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "cuda"}
for _var, _sub in CACHES.items():
    os.environ[_var] = os.path.join(os.getcwd(), "build", "bench_port", _sub)

import torch  # noqa: E402

from bench_port import harness  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def device_info(ctx: harness.Context, out: harness.Outcome) -> dict:
    dev = ctx.device
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": int(ctx.cell.workload["chips"]),
            "memory_peak_bytes": int(out.memory_peak_bytes)}
    if ctx.trace:
        info["busy_s"] = out.busy_s
        info["window_s"] = out.window_s
    return info


def main(argv=None, *, device: str | None = None,
         overrides: dict | None = None) -> int:
    """Run the cell; ``device`` and ``overrides`` are for the tests, which
    run the rest of a run on the CPU at small sizes."""
    args = parse(argv)
    cell = harness.load_cell(args.workload)
    chips = int(cell.workload["chips"])
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"[bench_port] needs {chips} CUDA device(s), torch sees "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = "cuda"
    ctx = harness.Context(cell, args.seed, args.seconds, bool(args.trace),
                          torch.device(device), T_START,
                          dict(overrides or {}))
    out = harness.driver(cell.traffic["driver"]).run(ctx)
    loaded = harness.jax_modules()
    if loaded:
        print(f"[bench_port] JAX modules loaded: {loaded}", file=sys.stderr)
        return 2
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if ctx.trace:
        values = {}
        for m in cell.per_layer:
            v = harness.reader(m["name"])(out.obs)
            if v is not None:
                values[m["name"]] = v
    else:
        values = {m["name"]: out.e2e[m["name"]] for m in cell.end_to_end}
    metrics = {k: {"value": float(v), "unit": units[k]}
               for k, v in values.items()}
    checks = {name: {"value": float(v), "limit": float(lim)}
              for name, v, lim in out.checks}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    print(json.dumps({"notes": out.notes}))
    for name, c in checks.items():
        print(f"[bench_port] check {name} {c['value']!r} limit "
              f"{c['limit']!r} {'ok' if c['value'] <= c['limit'] else 'FAIL'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(harness.result_line(correct, out.attempted, out.failed, metrics,
                              device_info(ctx, out),
                              out.breakdown if ctx.trace else None, checks),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
