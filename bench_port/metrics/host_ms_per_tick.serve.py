"""The host's time from a tick's start to ``step`` returning (the
benchmark's own span around ``BatchedStreamingEngine.step``), the median
over the window's ticks, in ms."""
import numpy as np


def read(obs):
    host = obs["host_enqueue_s"]
    return float(np.median(host)) * 1e3 if len(host) else None
