"""The symmetric contrastive loss and the train accuracy, vectorized, and
the softmax baseline's cross-entropy, accuracies and majority vote (the
JAX package's ``train/loss.py``).

Every item contributes the mean cross-entropy of its T rows, in both
directions (EMG -> class over rows, class -> EMG over columns), so the
reference's per-item Python loop (models.py:146-147, 198-208) is one
log-softmax over the stacked rows.
"""
from __future__ import annotations

import torch


def symmetric_contrastive_loss_per_item(logits: torch.Tensor) -> torch.Tensor:
    """(N, T, T) similarity logits -> (N,) per-item symmetric CE."""
    diag_e = torch.log_softmax(logits, dim=-1).diagonal(dim1=-2, dim2=-1)
    diag_g = torch.log_softmax(logits, dim=-2).diagonal(dim1=-2, dim2=-1)
    return -(diag_e.mean(dim=-1) + diag_g.mean(dim=-1)) / 2.0


def symmetric_contrastive_loss(logits: torch.Tensor) -> torch.Tensor:
    """(N, T, T) -> the scalar mean of the per-item symmetric CE."""
    return symmetric_contrastive_loss_per_item(logits).mean()


def contrastive_train_accuracy(logits: torch.Tensor) -> torch.Tensor:
    """Share of rows whose first-max column is the diagonal
    (models.py:148-149,165)."""
    T = logits.shape[-1]
    pred = logits.argmax(dim=-1)
    return (pred == torch.arange(T, device=logits.device)).float().mean()


# ------------------------------------------------ the softmax baseline
# ``scores`` are the normalized class scores of the prediction forward
# (``clip.py:124-133``), taken as logits; the class axis is the last. A
# leading config axis (the stacked sweep) passes through.
def _label_logp(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(scores, dim=-1)
    return logp.gather(-1, labels.expand(scores.shape[:-1])[..., None])[..., 0]


def prediction_loss(scores: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """(..., rows, C) scores, (rows,) labels -> (...) mean CE over the rows
    (models.py:175-196)."""
    return -_label_logp(scores, labels).mean(dim=-1)


def prediction_loss_per_item(scores: torch.Tensor, labels: torch.Tensor,
                             n_items: int) -> torch.Tensor:
    """(..., rows, C), rows = n_items * k -> (..., n_items) per-item mean
    CE."""
    ce = -_label_logp(scores, labels)
    return ce.reshape(*ce.shape[:-1], n_items, -1).mean(dim=-1)


def prediction_accuracy(scores: torch.Tensor,
                        labels: torch.Tensor) -> torch.Tensor:
    """(..., rows, C) -> (...) share of rows whose first-max class is the
    label."""
    return (scores.argmax(dim=-1) == labels).float().mean(dim=-1)


def majority_vote(scores: torch.Tensor) -> torch.Tensor:
    """(..., W, C) -> (...) the class most of the W frames' first-max
    classes name, ties to the smallest class: counts, then ``argmax``, as
    the JAX package's ``loss.py:80-89`` (``torch.mode`` breaks ties
    otherwise)."""
    C = scores.shape[-1]
    counts = torch.nn.functional.one_hot(scores.argmax(dim=-1), C).sum(dim=-2)
    return counts.argmax(dim=-1)


def prediction_vote_accuracy(scores: torch.Tensor,
                             labels: torch.Tensor) -> torch.Tensor:
    """(rows, W, C) scores, (rows,) labels -> the share of rows whose
    majority vote over the W frames is the label (models.py:190-192)."""
    return (majority_vote(scores) == labels).float().mean()
