"""The whole tick's share of the card's peak: the model's FLOP for one tick
of every session (one product a multiply-add, ``yardstick/counts.py``)
over the median tick latency of the window, over the dtype's peak."""
import numpy as np


def read(obs):
    lat = obs["latency_s"]
    if not len(lat):
        return None
    return 100.0 * obs["tick_flops"] / float(np.median(lat)) / obs[
        "peak_flops"]
