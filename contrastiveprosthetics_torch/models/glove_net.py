"""Class encoder (reference ``GLOVENet``, ``code/models.py:352-472``),
contrastive one-hot path only: the class embedding is
``Linear(n_classes -> d_e)`` applied to the one-hot label
(models.py:411-414, 457-458).

``last`` is the reference's dead 256->d_e projection: constructed
(models.py:425-428) but never called in the contrastive forward. It is
kept so that a reference state_dict loads with ``strict=True``.
"""
from __future__ import annotations

import torch
from torch import nn


class GLOVENet(nn.Module):
    def __init__(self, d_e: int = 16, n_classes: int = 41, device=None):
        super().__init__()
        self.n_classes = n_classes
        self.easy = nn.Sequential(nn.Linear(n_classes, d_e, device=device))
        self.last = nn.Sequential(
            nn.Linear(256, d_e, bias=False, device=device))

    def forward(self, labels: torch.Tensor) -> torch.Tensor:
        """(rows,) int class ids -> (rows, d_e) unnormalized embeddings."""
        hot = nn.functional.one_hot(labels, self.n_classes).to(
            self.easy[0].weight.dtype)
        return self.easy(hot)
