"""The whole stacked step's share of the card's peak: the model's forward
and backward FLOP for every train window of every config
(``yardstick/counts.py``) over the window's time, over the dtype's
peak."""


def read(obs):
    if not obs["steps"] or obs["window_s"] <= 0:
        return None
    return 100.0 * obs["steps"] * obs["step_flops"] / obs["window_s"] / obs[
        "peak_flops"]
