"""``encoder_chain``'s share of its roofline in the traced ticks: the least
time of one tick's call (``yardstick/counts.py``: the folded chain's FLOP
over the dtype's peak, or its bytes, the per-session affines among them,
over the memory bandwidth) over the device time of its kernels a tick (the
union of their intervals in the trace). None where the trace holds none
of its kernels."""
from bench_port.yardstick import trace as tr


def read(obs):
    trace = obs["trace"]
    if trace is None or not obs["trace_ticks"]:
        return None
    t = tr.measure(tr.busy(trace, "encoder_chain")) / obs["trace_ticks"]
    return 100.0 * obs["encoder_bound_s"] / t if t > 0 else None
