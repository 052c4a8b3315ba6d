"""Small sizes at which the tests run a cell on the CPU."""
import contextlib
import io
import json

from bench_port import run

SERVE = dict(sessions=64, check_sessions=16, norm_sessions=4, ring_ticks=10,
             gesture_ticks=5, trace_ticks=5)
SWEEP = dict(configs=2, block_steps=1, trace_steps=2)
CELLS = {"serve_live.cp_emgnet_f32.s49152": SERVE,
         "serve_live.cp_emgnet_bf16.s131072": SERVE,
         "sweep.cp_emgnet_f32.c150": SWEEP,
         "sweep_fused.cp_emgnet_f32.c150": SWEEP}


def run_small(workload: str, seed: int = 11, seconds: float = 0.5,
              trace: int = 0, **extra):
    """(exit code, the result line, the notes line) of a CPU run."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", workload, "--seed", str(seed),
                       "--seconds", str(seconds), "--trace", str(trace)],
                      device="cpu", overrides={**CELLS[workload], **extra})
    lines = out.getvalue().strip().splitlines()
    return rc, json.loads(lines[-1]), json.loads(lines[-2])["notes"]
