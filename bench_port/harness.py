"""What every cell shares: finding a cell's files by the names in
``BENCHMARK.json``, the metric readers, the card's state, the check that no
JAX module was loaded, and the result line.

A cell names a configuration (``bench_port/configs/<config>.json``, found
through ``BENCHMARK.json``'s ``configs``) and a traffic mix
(``bench_port/traffic/<traffic>.json``), whose ``driver`` key names the
module of ``bench_port/drivers/`` that runs it. A per-layer metric is
read by ``bench_port/metrics/<metric>.py``'s ``read(obs)``; the limits of
a cell's correctness check are in ``bench_port/limits/<workload>.json``.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BENCHMARK_FILE = "BENCHMARK.json"
# top-level module names the port's run may not load (compared whole)
JAX_NAMES = ("jax", "jaxlib", "flax", "optax", "contrastiveprosthetics_tpu")
SMI_FIELDS = ("name", "clocks.sm", "clocks.mem", "power.draw",
              "power.limit", "temperature.gpu",
              "clocks_throttle_reasons.active")


@dataclasses.dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    limits: dict

    @property
    def name(self) -> str:
        return self.workload["name"]


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell, the run's arguments, the device, and
    ``overrides`` of traffic parameters (the tests' small sizes)."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float
    overrides: dict

    def param(self, key: str):
        return self.overrides.get(key, self.cell.traffic[key])


@dataclasses.dataclass
class Outcome:
    """What a driver returns. ``checks``: (name, value, limit) of each
    number compared, correct where value <= limit. ``obs``: what the
    metric readers read. ``notes``: the earlier line's content."""

    e2e: dict
    obs: dict
    checks: list
    attempted: int
    failed: int
    memory_peak_bytes: int
    busy_s: float | None = None
    window_s: float | None = None
    breakdown: dict | None = None
    notes: dict = dataclasses.field(default_factory=dict)


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str, root: str = ".") -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its
    configuration, traffic mix, metrics and limits."""
    bench = _read_json(os.path.join(root, BENCHMARK_FILE))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in {BENCHMARK_FILE}: "
                         f"{sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _read_json(os.path.join(root, conf["file"]))
    traffic = _read_json(os.path.join(HERE, "traffic", w["traffic"] + ".json"))
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in moved)]
    limits = _read_json(os.path.join(HERE, "limits", workload + ".json"))
    return Cell(w, config, traffic, e2e, per_layer, limits)


class Stages:
    """Seconds of each stage of a run's set-up, from ``t0`` on."""

    def __init__(self, t0: float):
        self.last, self.seconds = t0, {}

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = now - self.last
        self.last = now


def driver(name: str):
    return importlib.import_module(f"bench_port.drivers.{name}")


def reader(metric: str):
    """``read`` of ``bench_port/metrics/<metric>.py``."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "bench_port.metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def jax_modules() -> list[str]:
    """The loaded modules whose top-level name is one of ``JAX_NAMES``."""
    return sorted({n.split(".", 1)[0] for n in list(sys.modules)}
                  & set(JAX_NAMES))


def card_state() -> list[dict]:
    """Each card's clocks, power and temperature by ``nvidia-smi``'s
    read-only query; an ``error`` entry where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=" + ",".join(SMI_FIELDS),
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20)
    except (OSError, subprocess.SubprocessError) as exc:
        return [{"error": str(exc)[:200]}]
    if out.returncode:
        return [{"error": (out.stderr or out.stdout)[:200]}]
    return [dict(zip(SMI_FIELDS, (v.strip() for v in line.split(","))))
            for line in out.stdout.strip().splitlines()]


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, breakdown: dict | None, checks: dict) -> str:
    """The last line of standard output; the compared numbers come last."""
    line = {"correct": bool(correct), "attempted": int(attempted),
            "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    return json.dumps(line)
