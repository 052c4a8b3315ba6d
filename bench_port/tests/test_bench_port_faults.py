"""The check catches what it is for. The rest of a run, on the CPU at a
small size, with the timed path broken underneath (``faults.py``), comes
out not correct; and so does the control, the plain reference in the
precision below the configuration's put in the program's place, read by
the same rule against the cell's limits."""
import pytest

from bench_port import faults, harness
from bench_port.controls import CONTROL
from bench_port.tests.small import CELLS, run_small


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_sound_run_is_correct(workload):
    _, line, _ = run_small(workload)
    assert line["correct"] is True


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in sorted(CELLS)
    for f in faults.FAULTS[harness.load_cell(w).traffic["driver"]]])
def test_fault_is_caught(workload, fault):
    driver = harness.load_cell(workload).traffic["driver"]
    with faults.planted(driver, fault):
        _, line, _ = run_small(workload)
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_control_is_not_correct(workload):
    cell = harness.load_cell(workload)
    mode = CONTROL[cell.config["dtype"]]
    extra = dict(controls=[mode])
    if cell.traffic["driver"] == "serve_live":
        extra["check_sessions"] = 64
    _, line, notes = run_small(workload, seconds=1.0, **extra)
    control = notes["controls"][mode]
    if not isinstance(control, dict):
        control = {"pred_gap_max": control}
    failed = [k for k, v in control.items()
              if k in cell.limits and v > cell.limits[k]]
    assert failed, (control, cell.limits)
