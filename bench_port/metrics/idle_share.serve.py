"""The device's idle share inside the traced ticks' spans, each from the
tick's issue to its results in host memory: the cadence's own idle time
between ticks is left out. None without a device operation in the trace."""
from bench_port.yardstick import trace as tr


def read(obs):
    trace = obs["trace"]
    if trace is None:
        return None
    spans = trace.spans("bench_port.tick")
    merged = tr.busy(trace)
    total = sum(e - s for s, e in spans)
    if not merged or total <= 0:
        return None
    busy = sum(tr.overlap(merged, s, e) for s, e in spans)
    return 100.0 * (1.0 - busy / total)
