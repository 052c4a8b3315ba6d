"""Plain reference of one serve tick, from raw samples to votes.

Written from the reference's description (``code/constants.py``,
``code/models.py`` and the serve path's documented pipeline), in numpy,
scipy and plain ``torch`` operations, independent of the port: a raw
2 kHz block of ``factor`` samples a channel, scaled by the ingest
prescale, runs through a Butterworth band-pass (second-order sections,
state carried from the first sample, zero initial state); the frame is the
RMS of the last ``rms_window`` filtered samples (zeros before the first),
normalised by the ingest mean and std; the EMG tower (conv -> ReLU -> BN
twice, flatten channel-major, dense -> ReLU -> BN blocks, the head) gives
an embedding, whose cosine against each class's one-hot embedding is the
class score; the prediction is the first maximum over the session's
subset, and the vote the first most frequent prediction of the last
``vote_window`` ticks within the subset. Inference mode: BatchNorm uses
its running statistics and dropout is the identity.

The ``mode`` of :func:`encoder_scores` sets the precision of every
product: ``float64`` is the reference; ``tf32`` and ``fp8`` are the
controls (f32 sums of operands rounded to TF32, or to e4m3 with one scale
a tensor), the steps below f32 and bf16.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy import signal as sp_signal

FP8_MAX = 448.0  # the largest finite float8 e4m3 value


def band_pass_sos(sig: dict) -> np.ndarray:
    nyq = sig["hz"] / 2.0
    lo, hi = sig["band_hz"]
    return sp_signal.butter(sig["butter_order"], [lo / nyq, hi / nyq],
                            btype="bandpass", output="sos")


def frames(raw: np.ndarray, sig: dict, mean, std) -> np.ndarray:
    """(n, ticks * factor, D) raw samples of n sessions from their first
    tick -> (n, ticks, D) normalised frames, float64."""
    n, T, D = raw.shape
    f, W = sig["factor"], sig["rms_window"]
    y = sp_signal.sosfilt(band_pass_sos(sig),
                          raw.astype(np.float64) * sig["ingest_prescale"],
                          axis=1)
    sq = np.concatenate([np.zeros((n, W, D)), y * y], axis=1)
    cs = np.cumsum(sq, axis=1)
    ends = np.arange(1, T // f + 1) * f + W - 1  # the tick's last sample
    total = cs[:, ends] - cs[:, ends - W]
    rms = np.sqrt(np.maximum(total, 0.0) / W)
    return (rms - np.asarray(mean, np.float64)) / np.asarray(std, np.float64)


# ------------------------------------------------------------- precisions
def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32 (10 mantissa bits), to nearest even."""
    bits = t.float().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0x0FFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to float8 e4m3 with one scale for the tensor,
    its largest magnitude mapped to the largest finite e4m3 value."""
    t = t.float()
    amax = float(t.abs().max()) if t.numel() else 0.0
    scale = amax / FP8_MAX if amax > 0 else 1.0
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


ROUND = {"tf32": round_tf32, "fp8": round_fp8}


def dtype_of(mode: str) -> torch.dtype:
    return torch.float64 if mode == "float64" else torch.float32


class _LowDot(torch.autograd.Function):
    """``a @ b`` of operands rounded as ``mode`` says, its gradients from
    rounded operands too."""

    @staticmethod
    def forward(ctx, a, b, mode):
        ctx.save_for_backward(a, b)
        ctx.mode = mode
        r = ROUND[mode]
        return r(a) @ r(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        r = ROUND[ctx.mode]
        return (r(g) @ r(b).transpose(-1, -2), r(a).transpose(-1, -2) @ r(g),
                None)


def dot(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """``a @ b`` (batched over leading axes) with the operands rounded as
    ``mode`` says and the sums in the mode's dtype."""
    if mode == "float64":
        return a.double() @ b.double()
    return _LowDot.apply(a, b, mode)


# ----------------------------------------------------------- the tower
def conv_row(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
             mode: str) -> torch.Tensor:
    """A k x k convolution with 'same' zero padding on (..., N, P, C_in)
    channels-last rows of a 1 x P image, ``weight`` (..., C_out, C_in, k,
    k), ``bias`` (..., C_out): only the kernel's middle row meets the image
    (the others meet the padding rows), so each output position sums its k
    taps along the row. Returns (..., N, P, C_out)."""
    *lead, N, P, cin = x.shape
    k = weight.shape[-1]
    pad = k // 2
    xp = torch.nn.functional.pad(x, (0, 0, pad, pad))
    cols = torch.cat([xp[..., j:j + P, :] for j in range(k)], dim=-1)
    w = weight[..., k // 2, :].movedim(-1, -3).transpose(-1, -2)
    w = w.reshape(*lead, k * cin, -1).to(x.dtype)
    out = dot(cols.reshape(*lead, N * P, -1), w, mode)
    return out.reshape(*lead, N, P, -1) + bias.to(x.dtype)[..., None, None, :]


def batch_norm(x, w: dict, prefix: str, eps: float):
    mean, var = w[prefix + ".running_mean"], w[prefix + ".running_var"]
    gamma, beta = w[prefix + ".weight"], w[prefix + ".bias"]
    dt = x.dtype
    return ((x - mean.to(dt)) / torch.sqrt(var.to(dt) + eps) * gamma.to(dt)
            + beta.to(dt))


def dense_prefixes(m: dict) -> list[tuple[str, str]]:
    out, idx = [], 0
    for i in range(m["n_linear"]):
        out.append((f"emg_net.linear.{idx}", f"emg_net.linear.{idx + 2}"))
        idx += 3 + int(i >= m["n_linear"] - m["dropout_blocks"])
    return out


def embeddings(w: dict, x: torch.Tensor, m: dict, mode: str,
               collect: list | None = None) -> torch.Tensor:
    """(N, D) frames -> (N, d_e) normalised embeddings, in inference mode.
    ``collect`` receives each BatchNorm's input."""
    dt = dtype_of(mode)
    eps = m["bn_eps"]
    h = x.to(dt).unsqueeze(-1)  # (N, P, 1)
    for conv, bn in (("emg_net.conv_emg.0", "emg_net.conv_emg.2"),
                     ("emg_net.conv_emg.3", "emg_net.conv_emg.5")):
        h = torch.relu(conv_row(h, w[conv + ".weight"], w[conv + ".bias"],
                                mode))
        if collect is not None:
            collect.append(h.reshape(-1, h.shape[-1]))
        h = batch_norm(h, w, bn, eps)
    h = h.transpose(1, 2).reshape(h.shape[0], -1)  # channel-major c*P + p
    for lin, bn in dense_prefixes(m):
        h = torch.relu(dot(h, w[lin + ".weight"].to(dt).T, mode)
                       + w[lin + ".bias"].to(dt))
        if collect is not None:
            collect.append(h)
        h = batch_norm(h, w, bn, eps)
    e = dot(h, w["emg_net.last.0.weight"].to(dt).T, mode)
    return e / torch.linalg.vector_norm(e, dim=-1, keepdim=True)


def class_embeddings(w: dict, m: dict, dt) -> torch.Tensor:
    """(n_classes, d_e) normalised one-hot class embeddings."""
    g = w["glove_net.easy.0.weight"].to(dt).T + w["glove_net.easy.0.bias"].to(dt)
    return g / torch.linalg.vector_norm(g, dim=-1, keepdim=True)


def encoder_scores(w: dict, x: torch.Tensor, m: dict, mode: str = "float64",
                   block: int = 16384) -> torch.Tensor:
    """(N, D) frames -> (N, n_classes) class scores, in blocks of rows."""
    g = class_embeddings(w, m, dtype_of(mode))
    return torch.cat([dot(embeddings(w, x[i:i + block], m, mode), g.T, mode)
                      for i in range(0, x.shape[0], block)])


@torch.no_grad()
def calibrated_statistics(w: dict, x: torch.Tensor, m: dict) -> dict:
    """Running statistics that normalise ``x``'s activations: each
    BatchNorm's batch mean and biased variance over ``x`` (float64), taken
    in order with the earlier layers already normalised by theirs."""
    w = dict(w)
    prefixes = ["emg_net.conv_emg.2", "emg_net.conv_emg.5"] + [
        bn for _, bn in dense_prefixes(m)]
    for i, prefix in enumerate(prefixes):
        seen: list = []
        embeddings(w, x, m, "float64", seen)
        h = seen[i]
        w[prefix + ".running_mean"] = h.mean(0).float()
        w[prefix + ".running_var"] = h.var(0, unbiased=False).float()
    return {k: v for k, v in w.items() if k.endswith(("running_mean",
                                                      "running_var"))}


# ------------------------------------------------------------- judging
def gaps(ref: torch.Tensor, picks: torch.Tensor, masks: torch.Tensor
         ) -> torch.Tensor:
    """How far each pick's reference score lies below the best reference
    score of its subset; infinite for a pick outside the subset."""
    best = torch.where(masks, ref, -torch.inf).max(-1).values
    picked = ref.gather(-1, picks.long().unsqueeze(-1)).squeeze(-1)
    inside = masks.gather(-1, picks.long().unsqueeze(-1)).squeeze(-1)
    return torch.where(inside, best - picked, torch.inf)


def first_max_in_subset(scores: torch.Tensor, masks: torch.Tensor
                        ) -> torch.Tensor:
    return torch.where(masks, scores, -torch.inf).argmax(-1)


def majority_votes(preds: np.ndarray, masks: np.ndarray, window: int
                   ) -> np.ndarray:
    """(n, T) predictions from the first tick and (n, C) subsets -> (n, T)
    votes: the first class of the subset with the most predictions among
    the last ``window`` ticks (fewer before the window fills)."""
    n, T = preds.shape
    C = masks.shape[1]
    onehot = np.zeros((n, T + 1, C), np.int64)
    onehot[np.arange(n)[:, None], np.arange(1, T + 1)[None, :], preds] = 1
    cs = np.cumsum(onehot, axis=1)
    t = np.arange(T)
    lo = np.maximum(t + 1 - window, 0)
    counts = cs[:, t + 1] - cs[:, lo]
    counts = np.where(masks[:, None, :], counts, -1)
    return counts.argmax(-1)
