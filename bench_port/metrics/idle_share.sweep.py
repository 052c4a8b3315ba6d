"""The device's idle share over the traced stacked steps (one call of
``trace_steps`` steps, synchronised at its end), from the trace. None
without a device operation in it."""
from bench_port.yardstick import trace as tr


def read(obs):
    trace = obs["trace"]
    if trace is None:
        return None
    lo, hi = obs["trace_span"]
    merged = tr.busy(trace)
    if not merged or hi <= lo:
        return None
    return 100.0 * (1.0 - tr.overlap(merged, lo, hi) / (hi - lo))
