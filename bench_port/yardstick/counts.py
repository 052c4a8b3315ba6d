"""Operations and bytes of the model and of the kernels the cells drive,
computed from the configuration's sizes alone.

Two multiply-add counts of the EMG tower stand side by side:

* :func:`model_macs_per_row`, what the model itself needs for one frame:
  the two 3x3 convolutions on the 1x12 image (only the kernel's middle row
  meets data, and an edge position has two taps), the dense stack, the
  head and the scores against the class embeddings;
* :func:`folded_chain_macs_per_row`, what ``encoder_chain`` multiplies for
  one row of its folded chain (both convolutions as banded dense matrices,
  zero blocks included), the count ``PERF.md``'s ``bound_ms`` column uses.

The step and tick FLOP use the first; the kernel rooflines the second, as
the kernels compute it.
"""
from __future__ import annotations

from bench_port.yardstick.peaks import ELEMENT_BYTES, least_seconds

F32 = 4


def _conv_taps(P: int, k: int = 3) -> int:
    """Taps of a width-``k`` kernel row that meet data over ``P``
    positions with 'same' padding."""
    half = k // 2
    return sum(min(P - 1, p + half) - max(0, p - half) + 1 for p in range(P))


def layer_macs(m: dict) -> list[int]:
    """Multiply-adds of each layer of the EMG tower and of the scores, for
    one frame, in forward order: conv1, conv2, the dense layers, the head,
    the scores."""
    P, F, H = m["emg_dim"], m["conv_features"], m["hidden"]
    taps = _conv_taps(P, m["conv_kernel"])
    out = [taps * F, taps * F * F, P * F * H]
    out += [H * H] * (m["n_linear"] - 1)
    out += [H * m["d_e"], m["d_e"] * m["n_classes"]]
    return out


def model_macs_per_row(m: dict) -> int:
    return sum(layer_macs(m))


def folded_chain_macs_per_row(m: dict) -> int:
    """The folded chain's weights and its class matrix, per row."""
    P, F, H = m["emg_dim"], m["conv_features"], m["hidden"]
    widths = [P, P * F, P * F] + [H] * m["n_linear"] + [m["d_e"]]
    macs = sum(a * b for a, b in zip(widths[:-1], widths[1:]))
    return macs + m["d_e"] * m["n_classes"]


def hidden_widths(m: dict) -> list[int]:
    """The widths after each hidden layer of the folded chain: the per-
    session affines' widths."""
    P, F, H = m["emg_dim"], m["conv_features"], m["hidden"]
    return [P * F, P * F] + [H] * m["n_linear"]


def encoder_chain_cost(m: dict, rows: int, sessions: int, dtype: str
                       ) -> tuple[float, float]:
    """(FLOP, bytes) of one ``encoder_chain`` call on ``rows`` rows of
    ``sessions`` sessions' affines: each input byte read once (frames,
    weights in the fold's dtype, f32 biases, the per-session affines a and
    c) and each output byte written once (f32 scores)."""
    macs = folded_chain_macs_per_row(m)
    P, n_classes = m["emg_dim"], m["n_classes"]
    widths = hidden_widths(m)
    weights = macs  # every weight and class-matrix element, once
    biases = sum(widths) + m["d_e"]
    affines = sessions * 2 * sum(widths)
    n_bytes = (rows * P * F32 + weights * ELEMENT_BYTES[dtype]
               + (biases + affines) * F32 + rows * n_classes * F32)
    return 2.0 * macs * rows, float(n_bytes)


def encoder_chain_bound_s(m: dict, rows: int, sessions: int, dtype: str
                          ) -> tuple[float, str]:
    return least_seconds(*encoder_chain_cost(m, rows, sessions, dtype), dtype)


def k5_cost(C: int, N: int, K: int, F: int, backward: bool, dtype: str
            ) -> tuple[float, float]:
    """(FLOP, bytes) of one K5f (``backward`` False) or K5b launch over C
    configs of an N-row block K -> F. K5f reads x, W, the bias, gamma,
    beta and the input's five statistics rows, and writes r and five
    statistics rows; K5b reads dz, r, x, W, both blocks' statistics and
    the two column sums, and writes dx, dW, db and two column sums."""
    e = ELEMENT_BYTES[dtype]
    if not backward:
        flops = 2.0 * N * K * F
        n_bytes = (N * K * e + K * F * e + 3 * F * F32 + 5 * K * F32
                   + N * F * e + 5 * F * F32)
    else:
        flops = 4.0 * N * K * F
        n_bytes = (2 * N * F * e + N * K * e + K * F * e
                   + (5 * F + 5 * K + 2 * F) * F32
                   + N * K * e + K * F * F32 + F * F32 + 2 * K * F32)
    return C * flops, C * float(n_bytes)


def k5_step_bound_s(m: dict, C: int, N: int, dtype: str) -> float:
    """The least time of one step's K5f and K5b launches together: a pair
    for each dense block of the chain."""
    P, F, H = m["emg_dim"], m["conv_features"], m["hidden"]
    total = 0.0
    for K in [P * F] + [H] * (m["n_linear"] - 1):
        for backward in (False, True):
            total += least_seconds(*k5_cost(C, N, K, H, backward, dtype),
                                   dtype)[0]
    return total


def train_step_flops(m: dict, C: int, rows: int, items: int) -> float:
    """FLOP of one training step of C configs on ``rows`` frames: the
    forward, and in the backward the weight gradients of every layer and
    the input gradients of every layer but the first, plus the logits of
    the contrastive loss (T x T x d_e an item, forward and both
    gradients)."""
    macs = layer_macs(m)
    tower = macs[:-1]  # the scores are not on the training path
    step = 3 * sum(tower) - tower[0]
    T = m["n_classes"]
    logits = 3 * items * T * T * m["d_e"]
    return 2.0 * C * (rows * step + logits)


def serve_tick_flops(m: dict, sessions: int) -> float:
    """FLOP of one tick of every session: the model's forward and the
    scores, one frame a session."""
    return 2.0 * sessions * model_macs_per_row(m)
