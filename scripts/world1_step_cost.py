"""What the sharded train step costs at world 1 on one CUDA device, and
where that cost goes.

    python scripts/world1_step_cost.py [--repo DIR] [--turns 6] [--steps 50]
                                       [--trace-steps 5]

Starts a one-rank NCCL group (``file://`` rendezvous in a temporary
directory) and the full-width trainer on the synthetic dataset (bs 8,
the canonical hyperparameters: dropout 0.5), then:

* times ``Trainer._sgd_step`` unsharded and the step of
  ``parallel/spmd.py::make_sharded_train_step`` on a (1, 1) mesh in
  alternating turns of ``--steps`` steps, by CUDA events (ms a step) and
  by the host's clock;
* traces ``--trace-steps`` steps of each with ``torch.profiler`` and
  prints, a step, the operators whose host time the sharded step adds
  (self time, calls), and the collectives it calls.

``--repo`` imports the package from another checkout (a parent commit
unpacked beside this one), so that two versions are timed by one script.
Prints JSON lines; the first is the card's name and power limit. Needs a
CUDA device.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ap = argparse.ArgumentParser()
ap.add_argument("--repo", default=str(Path(__file__).resolve().parents[1]))
ap.add_argument("--turns", type=int, default=6)
ap.add_argument("--steps", type=int, default=50)
ap.add_argument("--trace-steps", type=int, default=5)
args = ap.parse_args()
sys.path.insert(0, str(Path(args.repo).resolve()))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from contrastiveprosthetics_torch.config import DEFAULT_CONFIG as cfg  # noqa: E402
from contrastiveprosthetics_torch.data.sampler import (  # noqa: E402
    gather_train_batch,
    task_permutations,
)
from contrastiveprosthetics_torch.data.store import DeviceStore  # noqa: E402
from contrastiveprosthetics_torch.data.synthetic import (  # noqa: E402
    make_processed_dataset,
)
from contrastiveprosthetics_torch.ops import _build  # noqa: E402
from contrastiveprosthetics_torch.parallel.mesh import make_mesh  # noqa: E402
from contrastiveprosthetics_torch.parallel.spmd import (  # noqa: E402
    make_sharded_train_step,
)
from contrastiveprosthetics_torch.train.engine import Hyper, Trainer  # noqa: E402

CANONICAL = (1e-3, 1e-6, 0.5, 1e-3, 1e-6, 0.3)  # cli/train.py's defaults
COLLECTIVE = ("allreduce", "all_reduce", "nccl", "record_param_comms")


def per_step(prof, steps: int) -> dict[str, dict]:
    """Each operator's host self time (ms) and calls, a step."""
    out = {}
    for e in prof.key_averages():
        out[e.key] = dict(self_cpu_ms=e.self_cpu_time_total / 1e3 / steps,
                          cpu_ms=e.cpu_time_total / 1e3 / steps,
                          calls=e.count / steps)
    return out


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps({"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), "repo": args.repo}), flush=True)
    _build.build()
    dev = torch.device("cuda")
    store = DeviceStore(cfg, *make_processed_dataset(cfg), device=dev)
    trainer = Trainer(cfg, store, adabn=False, batch_size=8)
    v = trainer.view_train
    gen = trainer.generator(7)
    emg_rand = task_permutations(gen, v.n_tasks, v.D)
    items = torch.randperm(v.D, generator=gen, device=dev)[:8]
    emg_b = gather_train_batch(v.emg_flat, emg_rand, items)
    hyper = Hyper.single(*CANONICAL)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rdv",
                                rank=0, world_size=1)
        try:
            mesh = make_mesh(1, 1)
            step, place = make_sharded_train_step(trainer, mesh)
            states = {"unsharded": trainer.init_state(trainer.generator(0)),
                      "sharded": place(trainer.init_state(
                          trainer.generator(0)))}
            gens = {k: trainer.generator(2) for k in states}
            run = {"unsharded": lambda: trainer._sgd_step(
                       states["unsharded"], emg_b, hyper, 1e-3, 1e-3,
                       gens["unsharded"]),
                   "sharded": lambda: step(states["sharded"], emg_b, hyper,
                                           1e-3, 1e-3, gens["sharded"])}
            for fn in run.values():  # warm-up
                for _ in range(5):
                    fn()
            torch.cuda.synchronize()
            ms = {k: [] for k in run}
            host_ms = {k: [] for k in run}
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            for _ in range(args.turns):
                for name, fn in run.items():
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    start.record()
                    for _ in range(args.steps):
                        fn()
                    end.record()
                    torch.cuda.synchronize()
                    host_ms[name].append((time.perf_counter() - t0) * 1e3
                                         / args.steps)
                    ms[name].append(start.elapsed_time(end) / args.steps)
            med = {k: statistics.median(x) for k, x in ms.items()}
            print(json.dumps(dict(
                turns=args.turns, steps_a_turn=args.steps,
                ms_per_step=ms, host_ms_per_step=host_ms,
                median_ms=med,
                sharded_minus_unsharded_ms=med["sharded"] - med["unsharded"],
                turn_differences_ms=[s - u for s, u in zip(
                    ms["sharded"], ms["unsharded"])])), flush=True)
            traces = {}
            for name, fn in run.items():
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    for _ in range(args.trace_steps):
                        fn()
                    torch.cuda.synchronize()
                traces[name] = per_step(prof, args.trace_steps)
            u, s = traces["unsharded"], traces["sharded"]
            zero = dict(self_cpu_ms=0.0, cpu_ms=0.0, calls=0.0)
            added = sorted(
                ((k, s.get(k, zero)["self_cpu_ms"]
                  - u.get(k, zero)["self_cpu_ms"],
                  s.get(k, zero)["calls"] - u.get(k, zero)["calls"])
                 for k in set(u) | set(s)), key=lambda t: -t[1])
            print(json.dumps(dict(
                traced_steps=args.trace_steps,
                self_cpu_ms_a_step={k: sum(e["self_cpu_ms"]
                                           for e in t.values())
                                    for k, t in traces.items()},
                added_self_cpu_ms_a_step=sum(a for _, a, _ in added),
                top_added=[dict(op=k, self_cpu_ms=a, calls=c)
                           for k, a, c in added[:20]],
                collectives_a_step={k: e["calls"] for k, e in s.items()
                                    if any(c in k.lower()
                                           for c in COLLECTIVE)})),
                  flush=True)
        finally:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
