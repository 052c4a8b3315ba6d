"""The model's weights, made by the benchmark from the seed on the device.

The state_dict is in the reference's layout (``code/models.py``'s
``Model.state_dict()``: ``emg_net.conv_emg.{0,3}`` convolutions with
BatchNorms at ``.2``/``.5``, ``emg_net.linear.{3i(+1)}`` dense blocks with
their BatchNorms two entries on, dropout after the last four blocks, the
head ``emg_net.last.0``, the one-hot class tower ``glove_net.easy.0``, the
dead ``glove_net.last.0`` and ``logit_scale``). Both the port and the
plain references take this dict: the port through ``load_state_dict``,
the references by reading it.

Convolution and dense weights and biases are uniform in +-1/sqrt(fan_in),
torch's default initialisation. ``trained=True`` stands in for a trained
model: BatchNorm scales and shifts drawn around 1 and 0 (their running
statistics are filled in by :func:`bench_port.reference.serve_ref.
calibrated_statistics`); otherwise they are at their initial 1 and 0.
All values come from one ``torch.rand`` call on a generator on ``device``.
"""
from __future__ import annotations

import numpy as np
import torch


def sub_seed(seed: int, *stream) -> int:
    """A 63-bit seed for a named stream of the run seeded ``seed``."""
    words = [int(seed) & 0xFFFFFFFFFFFFFFFF] + [
        int.from_bytes(str(s).encode(), "little") % (1 << 63) for s in stream]
    state = np.random.SeedSequence(words).generate_state(1, np.uint64)
    return int(state[0] >> np.uint64(1))


def dense_keys(m: dict) -> list[tuple[str, str, int]]:
    """(linear prefix, BatchNorm prefix, dropout?) of each dense block."""
    out, idx = [], 0
    for i in range(m["n_linear"]):
        drop = i >= m["n_linear"] - m["dropout_blocks"]
        out.append((f"emg_net.linear.{idx}", f"emg_net.linear.{idx + 2}",
                    drop))
        idx += 3 + int(drop)
    return out


def spec(m: dict) -> list[tuple[str, tuple, str, int]]:
    """(key, shape, kind, fan_in) of every entry, kind one of 'uniform',
    'gamma', 'beta', 'mean', 'var', 'count', 'zero'."""
    F, k, H = m["conv_features"], m["conv_kernel"], m["hidden"]
    out = []

    def norm(prefix, n):
        out.extend([(prefix + ".weight", (n,), "gamma", 0),
                    (prefix + ".bias", (n,), "beta", 0),
                    (prefix + ".running_mean", (n,), "mean", 0),
                    (prefix + ".running_var", (n,), "var", 0),
                    (prefix + ".num_batches_tracked", (), "count", 0)])

    cin = 1
    for conv, bn in (("emg_net.conv_emg.0", "emg_net.conv_emg.2"),
                     ("emg_net.conv_emg.3", "emg_net.conv_emg.5")):
        fan = cin * k * k
        out += [(conv + ".weight", (F, cin, k, k), "uniform", fan),
                (conv + ".bias", (F,), "uniform", fan)]
        norm(bn, F)
        cin = F
    width = F * m["emg_dim"]
    for lin, bn, _ in dense_keys(m):
        out += [(lin + ".weight", (H, width), "uniform", width),
                (lin + ".bias", (H,), "uniform", width)]
        norm(bn, H)
        width = H
    d, n = m["d_e"], m["n_classes"]
    out += [("emg_net.last.0.weight", (d, H), "uniform", H),
            ("glove_net.easy.0.weight", (d, n), "uniform", n),
            ("glove_net.easy.0.bias", (d,), "uniform", n),
            ("glove_net.last.0.weight", (d, 256), "zero", 0),
            ("logit_scale", (), "zero", 0)]
    return out


@torch.no_grad()
def make_weights(m: dict, seed: int, device, configs: int | None = None,
                 trained: bool = False) -> dict[str, torch.Tensor]:
    """The state_dict (f32; with ``configs`` a leading axis of that many
    configs on every entry), drawn from ``seed`` on ``device``."""
    lead = () if configs is None else (configs,)
    entries = spec(m)
    sizes = [int(np.prod(lead + shape)) for _, shape, _, _ in entries]
    gen = torch.Generator(device).manual_seed(sub_seed(seed, "weights"))
    u = torch.rand(sum(sizes), generator=gen, device=device) * 2 - 1
    out = {}
    for (key, shape, kind, fan), part in zip(entries, u.split(sizes)):
        shape = lead + shape
        if kind == "uniform":
            t = part * (1.0 / np.sqrt(fan))
        elif kind == "gamma":
            t = 1.0 + 0.25 * part if trained else torch.ones_like(part)
        elif kind == "beta":
            t = 0.1 * part if trained else torch.zeros_like(part)
        elif kind == "var":
            t = torch.ones_like(part)
        elif kind == "count":
            t = torch.zeros(part.shape, dtype=torch.int64, device=device)
        else:  # mean, zero
            t = torch.zeros_like(part)
        out[key] = t.reshape(shape).contiguous()
    return out
