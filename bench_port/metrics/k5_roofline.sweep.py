"""K5f and K5b together against their roofline: the least time of a
stacked step's launches of both (a pair for each dense block, its shape
from the configuration, ``yardstick/counts.py``) over their device time a
step in the trace (the union of their intervals). None where the trace
holds none of them: the eager path."""
from bench_port.yardstick import trace as tr


def read(obs):
    trace = obs["trace"]
    if trace is None or not obs["traced_steps"]:
        return None
    t = sum(tr.measure(tr.busy(trace, k))
            for k in ("dense_block_fwd", "dense_block_bwd"))
    if t <= 0:
        return None
    return 100.0 * obs["k5_bound_s"] / (t / obs["traced_steps"])
