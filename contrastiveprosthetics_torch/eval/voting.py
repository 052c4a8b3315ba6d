"""Majority-vote evaluation, vectorized (the JAX package's
``eval/voting.py``).

The reference walks every item and every voting-prefix length in Python,
calling ``torch.mode`` each time (models.py:146-163). Here a cumulative
sum over one-hot votes gives the prefix-vote counts of every prefix length
at once; ``argmax`` returns the first maximum, so ties go to the smallest
class, as ``torch.mode`` breaks them (models.py:154).

Columns: ``n_prefix`` is 24 by default (prefix lengths 1..24, the shipped
``voting.npy``; ``y_pred`` is the 24-frame vote) and 249 under
``compat_full_voting_bound``, where the columns past the window repeat the
full-window vote, as the reference's ``pred[:win]`` slice clamps.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class VoteResult(NamedTuple):
    curve: torch.Tensor     # (B, n_prefix) accuracy per item per prefix
    y_pred: torch.Tensor    # (B, T) vote at the last prefix
    y_true: torch.Tensor    # (B, T) = arange(T) per item
    accuracy: torch.Tensor  # scalar: mean of curve[:, -1]


def vote_from_logits(logits: torch.Tensor, window: int,
                     n_prefix: int) -> VoteResult:
    """``logits`` (B*window, T, T) in (item, frame) row order."""
    T = logits.shape[-1]
    B = logits.shape[0] // window
    pred = logits.reshape(B, window, T, T).argmax(dim=-1)     # (B, W, T)
    counts = torch.nn.functional.one_hot(pred, T).cumsum(dim=1)
    votes = counts.argmax(dim=-1)                             # ties -> min
    labels = torch.arange(T, device=logits.device)
    correct = votes == labels
    cols = torch.clamp(torch.arange(n_prefix, device=logits.device),
                       max=window - 1)
    curve = correct[:, cols].float().mean(dim=-1)
    y_pred = votes[:, min(n_prefix, window) - 1]
    return VoteResult(curve=curve, y_pred=y_pred,
                      y_true=labels.expand(B, T), accuracy=curve[:, -1].mean())


def confusion_matrix(y_true: torch.Tensor, y_pred: torch.Tensor,
                     n_classes: int) -> torch.Tensor:
    """(n_classes, n_classes) counts, rows = true (results.py:60)."""
    idx = y_true.reshape(-1) * n_classes + y_pred.reshape(-1)
    return torch.bincount(idx, minlength=n_classes * n_classes).reshape(
        n_classes, n_classes)
