"""Every cell's configuration, traffic mix, limits, driver and metric
readers are found by name from ``BENCHMARK.json``."""
import json
import os

import pytest

from bench_port import harness

ROOT = os.path.dirname(harness.HERE)
with open(os.path.join(ROOT, harness.BENCHMARK_FILE)) as _f:
    BENCH = json.load(_f)


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(workload):
    cell = harness.load_cell(workload)
    assert cell.config["name"] == cell.workload["config"]
    assert cell.end_to_end and cell.per_layer and cell.limits
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    harness.driver(cell.traffic["driver"])
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert callable(harness.reader(m["name"]))


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_reader_that_finds_nothing_returns_none(metric):
    empty = {"trace": None, "trace_ticks": 0, "traced_steps": 0,
             "latency_s": [], "host_enqueue_s": [], "steps": 0,
             "window_s": 0.0}
    assert harness.reader(metric)(empty) is None


def test_unknown_workload_refused():
    with pytest.raises(SystemExit):
        harness.load_cell("no_such_cell")
