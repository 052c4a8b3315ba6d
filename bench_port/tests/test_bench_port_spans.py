"""The readers of the port's own spans (``cptorch.serve.*``,
``cptorch.train.*``, ``contrastiveprosthetics_torch/utils/spans.py``) on a
synthetic trace and store: each finds its value, reads only the traced
ticks' or steps' spans, and finds nothing without them. On the card
(``-m cuda``) a traced run of each sweep cell prints the three phases of a
step, and they add up to the device's busy time a step within 5 %."""
import json
import subprocess
import sys

import pytest

from bench_port import harness
from bench_port.yardstick.trace import Trace

STEP = "cptorch.serve.step"
# three ticks: an untraced span first, then two traced ones, each holding
# host calls of which the first that puts work on the card is the lead's end
TRACE = Trace(
    device=[("k", 0.0015, 0.003), ("k", 1.0020, 1.004), ("k", 2.0040, 2.006)],
    host=[(STEP, 0.001, 0.0019), ("cudaLaunchKernel", 0.0012, 0.0013),
          (STEP, 1.000, 1.0030), ("aten::empty", 1.0005, 1.0006),
          ("cudaEventRecord", 1.0008, 1.0009),
          ("cudaMemsetAsync", 1.0010, 1.0011),
          ("cudaLaunchKernelExC", 1.0015, 1.0016),
          (STEP, 2.000, 2.0050), ("cudaGetDevice", 2.0001, 2.0002),
          ("cudaLaunchKernelExC", 2.0030, 2.0031),
          ("cudaLaunchKernel", 2.0060, 2.0061)])


@pytest.mark.parametrize("n,want", [(2, 2.0),   # median of 1.0 and 3.0 ms
                                    (3, 1.0)])  # of 0.2, 1.0 and 3.0
def test_tick_lead_reader(n, want):
    read = harness.reader("tick_lead_ms.serve")
    assert read({"trace": TRACE, "trace_ticks": n}) == pytest.approx(want)


@pytest.mark.parametrize("trace", [
    Trace(device=TRACE.device, host=[("bench_port.tick", 0.0, 1.0)]),
    Trace(device=[], host=[(STEP, 0.0, 1.0), ("aten::add", 0.1, 0.2)]),
    None], ids=["no_span", "no_launch", "no_trace"])
def test_tick_lead_reader_finds_nothing(trace):
    read = harness.reader("tick_lead_ms.serve")
    assert read({"trace": trace, "trace_ticks": 2}) is None
    assert read({"trace": TRACE, "trace_ticks": 0}) is None


class FakeEvent:
    def __init__(self, ms):
        self.ms = ms

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.ms - self.ms


@pytest.fixture
def store():
    """The port's store holding an older run's spans, then 2 traced ones,
    per name: the timed train phases with their events, the tick's step
    with its launches."""
    from contrastiveprosthetics_torch.utils import spans

    spans.clear()
    ms = {"cptorch.train.forward": 15.0, "cptorch.train.backward": 30.0,
          "cptorch.train.adam": 12.0}
    for name, t in ms.items():
        for scale in (100.0, 1.0, 1.0):
            spans._store.setdefault(name, []).append(spans._Record(
                (FakeEvent(0.0), FakeEvent(t * scale)), 0))
    for count in (99, 12, 12):
        spans._store.setdefault(STEP, []).append(spans._Record(None, count))
    yield ms
    spans.clear()


@pytest.mark.parametrize("part", ["forward", "backward", "adam"])
def test_device_ms_readers(store, part):
    read = harness.reader(f"{part}_ms_per_step.sweep")
    assert read({"traced_steps": 2}) == store[f"cptorch.train.{part}"]
    assert read({"traced_steps": 0}) is None


def test_launches_reader(store):
    read = harness.reader("launches_per_tick.serve")
    assert read({"trace_ticks": 2}) == 12
    assert read({"trace_ticks": 0}) is None


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["sweep.cp_emgnet_f32.c150",
                                      "sweep_fused.cp_emgnet_f32.c150"])
def test_step_phases_add_up_to_busy_time(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "-m", "bench_port.run", "--workload", workload,
         "--seed", "2147483677", "--seconds", "2", "--trace", "1"],
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    m = {k: v["value"] for k, v in line["metrics"].items()}
    parts = sum(m[f"{p}_ms_per_step.sweep"]
                for p in ("forward", "backward", "adam"))
    traffic = harness.load_cell(workload).traffic
    busy = line["device"]["busy_s"] * 1e3 / traffic["trace_steps"]
    assert abs(parts - busy) <= 0.05 * busy, (parts, busy)
