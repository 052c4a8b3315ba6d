"""Each cell run briefly on the card, as the benchmark runs it, comes out
correct (``python -m pytest bench_port/tests -m cuda`` on a machine with an
H100; skips without a CUDA device)."""
import json
import subprocess
import sys

import pytest

from bench_port.tests.test_bench_port_loading import BENCH


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "-m", "bench_port.run", "--workload", workload,
         "--seed", "2147483659", "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
