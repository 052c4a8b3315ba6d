"""The last line of a run: its keys, the metrics of each kind of run, the
compared numbers last."""
import json

import pytest

from bench_port.tests.small import CELLS, run_small

with open("BENCHMARK.json") as _f:
    BENCH = json.load(_f)
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def names(kind, workload):
    return {m["name"] for m in BENCH[kind]
            if workload in m.get("workloads", [workload])}


@pytest.mark.parametrize("workload", sorted(CELLS))
@pytest.mark.parametrize("trace", [0, 1])
def test_last_line(workload, trace):
    rc, line, notes = run_small(workload, trace=trace, seconds=0.3)
    assert rc == 0
    keys = list(line)
    assert keys[:5] == KEYS and keys[-1] == "checks"
    assert line["correct"] is True
    assert line["attempted"] > 0 and line["failed"] == 0
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in line["breakdown"].values())
        # the CPU has no device trace: only the host's metrics are read
        assert set(line["metrics"]) <= names("per_layer", workload)
    else:
        assert set(line["metrics"]) == names("end_to_end", workload)
        assert "breakdown" not in line
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert "card_before" in notes and "setup_s" in notes
