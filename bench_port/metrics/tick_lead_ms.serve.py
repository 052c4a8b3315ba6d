"""The device's wait for the host at a tick's head: from the start of each
traced tick's ``cptorch.serve.step`` span (the port's own, around
``BatchedStreamingEngine.step``) to the host's first call inside it that
puts work on the card (a kernel launch, a copy or a set, a graph launch),
both on the host's clock of the trace; the median over the traced ticks,
in ms. The card is idle until then, as the tick before waited for its
results; the launch's own latency is left out. None without such a span,
or without such a call inside one (the CPU)."""
import bisect

import numpy as np

STEP = "cptorch.serve.step"
ENQUEUE = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cuMemcpy", "cudaMemset",
           "cuMemset", "cudaGraphLaunch", "cuGraphLaunch")


def read(obs):
    trace, n = obs["trace"], obs["trace_ticks"]
    if trace is None or not n:
        return None
    calls = sorted(s for name, s, _ in trace.host if name.startswith(ENQUEUE))
    leads = []
    for s, e in sorted(trace.spans(STEP))[-n:]:
        i = bisect.bisect_left(calls, s)
        if i < len(calls) and calls[i] < e:
            leads.append(calls[i] - s)
    return float(np.median(leads)) * 1e3 if leads else None
