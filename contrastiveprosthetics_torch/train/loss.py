"""The symmetric contrastive loss and the train accuracy, vectorized
(the JAX package's ``train/loss.py:16-64``).

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
