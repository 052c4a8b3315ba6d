"""Plain reference of the sweep's stacked training step.

C configs of the reference's contrastive model (``code/models.py``,
``code/train.py``), each on its own batch, written with plain ``torch``
operations and autograd, independent of the port. One step of a config:
the EMG tower in train mode (conv -> ReLU -> BatchNorm twice on the 1 x P
image, flatten channel-major, dense -> ReLU -> BatchNorm blocks with
inverted dropout after the last ``dropout_blocks``, the head), BatchNorm on
the batch's statistics (biased variance); the one-hot class tower; the
symmetric cross-entropy of each item's T x T cosine logits, averaged over
the items; plus ``reg`` times the sum of the Frobenius norms of each
tower's convolution and dense weights; the gradient of that total; then
Adam (optax's order: b1, b2, eps outside the root, bias corrections)
with the config's learning rate.

Dropout: the masks are the program's, worked out again here from the
state of the generator the benchmark handed the step (``masks_eager``,
``masks_fused``): the program's only random input that the benchmark does
not draw itself.

``mode`` sets the precision of every product, as in ``serve_ref.py``:
``float64`` is the reference, ``tf32`` the control (f32 elsewhere).
"""
from __future__ import annotations

import torch

from bench_port.reference.philox import mask_bits, keep_threshold
from bench_port.reference.serve_ref import conv_row, dot, dtype_of
from bench_port.reference.weights import dense_keys


def _bn_train(h, gamma, beta, dims, eps):
    var, mean = torch.var_mean(h, dim=dims, correction=0, keepdim=True)
    shape = [h.shape[0]] + [1] * (h.dim() - 2) + [h.shape[-1]]
    return (h - mean) / torch.sqrt(var + eps) * gamma.view(shape) \
        + beta.view(shape)


def losses(p: dict, x, masks, keep, m: dict, items: int, mode: str):
    """Per-config contrastive losses (C,), given ``p`` the (C, ...)
    parameters, ``x`` (C, items * T, D) frames in (item, task) order,
    ``masks`` one (C, rows, hidden) keep mask a dropped block and ``keep``
    (C,) (None: no dropout)."""
    eps = m["bn_eps"]
    C, N, _ = x.shape
    h = x.unsqueeze(-1)
    for conv, bn in (("emg_net.conv_emg.0", "emg_net.conv_emg.2"),
                     ("emg_net.conv_emg.3", "emg_net.conv_emg.5")):
        h = torch.relu(conv_row(h, p[conv + ".weight"], p[conv + ".bias"],
                                mode))
        h = _bn_train(h, p[bn + ".weight"], p[bn + ".bias"], (1, 2), eps)
    h = h.transpose(2, 3).reshape(C, N, -1)
    dropped = 0
    for lin, bn, drop in dense_keys(m):
        h = torch.relu(dot(h, p[lin + ".weight"].transpose(1, 2), mode)
                       + p[lin + ".bias"][:, None, :])
        h = _bn_train(h, p[bn + ".weight"], p[bn + ".bias"], (1,), eps)
        if drop and masks is not None:
            k = keep.to(h.dtype).view(-1, 1, 1)
            h = torch.where(masks[dropped], h / k, torch.zeros_like(h))
            dropped += 1
    e = dot(h, p["emg_net.last.0.weight"].transpose(1, 2), mode)
    e = e / torch.linalg.vector_norm(e, dim=-1, keepdim=True)
    g = p["glove_net.easy.0.weight"].transpose(1, 2) \
        + p["glove_net.easy.0.bias"][:, None, :]
    g = g / torch.linalg.vector_norm(g, dim=-1, keepdim=True)  # (C, T, d)
    T = g.shape[1]
    logits = dot(e.reshape(C, items, T, -1),
                g[:, None].transpose(-1, -2).expand(-1, items, -1, -1), mode)
    rows = torch.log_softmax(logits, -1).diagonal(dim1=-2, dim2=-1)
    cols = torch.log_softmax(logits, -2).diagonal(dim1=-2, dim2=-1)
    loss = (-(rows.sum(-1) + cols.sum(-1)) / (2.0 * T)).mean(-1)
    return loss


def penalty(p: dict, keys: list[str]) -> torch.Tensor:
    return sum(torch.linalg.vector_norm(p[k].flatten(1), dim=1) for k in keys)


def weight_keys(m: dict) -> tuple[list[str], list[str]]:
    emg = ["emg_net.conv_emg.0.weight", "emg_net.conv_emg.3.weight"] + [
        lin + ".weight" for lin, _, _ in dense_keys(m)] + [
        "emg_net.last.0.weight"]
    return emg, ["glove_net.easy.0.weight"]


def adam_steps(p0: dict, batches: list, masks: list, keep, hyper: dict,
               m: dict, items: int, adam: dict, mode: str = "float64"):
    """``len(batches)`` steps from ``p0``. Returns the (steps, C) losses,
    each leaf's (C,) gradient norms at the first step and (C,) change
    norms after the last."""
    dt = dtype_of(mode)
    p = {k: v.detach().to(dt).clone().requires_grad_(True)
         for k, v in p0.items()}
    names = list(p)
    emg_w, glove_w = weight_keys(m)
    lr = {k: hyper["lr_glove" if k.startswith("glove_net") else "lr_emg"]
          .to(dt) for k in names}
    reg_e, reg_g = hyper["reg_emg"].to(dt), hyper["reg_glove"].to(dt)
    b1, b2, eps = adam["b1"], adam["b2"], adam["eps"]
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    out_loss, g1 = [], None
    for t, (x, mk) in enumerate(zip(batches, masks), start=1):
        loss = losses(p, x.to(dt), mk, keep, m, items, mode)
        total = (loss + reg_e * penalty(p, emg_w)
                 + reg_g * penalty(p, glove_w)).sum()
        grads = torch.autograd.grad(total, [p[k] for k in names])
        out_loss.append(loss.detach())
        if g1 is None:
            g1 = {k: g.flatten(1).norm(dim=1) for k, g in zip(names, grads)}
        with torch.no_grad():
            for k, g in zip(names, grads):
                mu[k] = b1 * mu[k] + (1 - b1) * g
                nu[k] = b2 * nu[k] + (1 - b2) * g * g
                u = (mu[k] / (1 - b1 ** t)) / (
                    torch.sqrt(nu[k] / (1 - b2 ** t)) + eps)
                shape = (-1,) + (1,) * (u.dim() - 1)
                p[k] -= lr[k].view(shape) * u
    change = {k: (p[k].detach() - p0[k].to(dt)).flatten(1).norm(dim=1)
              for k in names}
    return torch.stack(out_loss), g1, change


def masks_eager(state, device, C, rows, width, keep, steps, n_drop):
    """The eager stacked step's masks: each dropped layer draws ``rand``
    of its activation's shape from the step's generator, in forward
    order, and keeps values below ``keep``."""
    gen = torch.Generator(device)
    gen.set_state(state)
    k = keep.view(-1, 1, 1)
    return [[torch.rand((C, rows, width), generator=gen, device=device) < k
             for _ in range(n_drop)] for _ in range(steps)]


def masks_fused(state, device, C, rows, width, keep, steps, n_drop,
                first_block):
    """The fused chain's masks: one pair of 32-bit seed words a config and
    step drawn from the generator, then Philox4x32-10 bits per element of
    dropped block ``first_block + j``, kept at or below the keep
    threshold."""
    gen = torch.Generator(device)
    gen.set_state(state)
    thr = keep_threshold(keep).view(-1, 1, 1)
    out = []
    for _ in range(steps):
        seeds = torch.randint(-2**31, 2**31, (C, 2), dtype=torch.int32,
                              generator=gen, device=device)
        out.append([mask_bits(seeds, rows, width, first_block + j) <= thr
                    for j in range(n_drop)])
    return out
