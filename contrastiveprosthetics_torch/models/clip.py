"""CLIP-style wrapper (reference ``Model``, ``code/models.py:66-228``): the
serving methods ``encode_emg`` and ``encode_classes`` (the JAX package's
``models/clip.py:65-79``).

``logit_scale`` is the reference's dead temperature (initialised to exactly
0 and its multiplication commented out, models.py:81,129). It is a
parameter only so that reference checkpoints load with ``strict=True``.
"""
from __future__ import annotations

import torch
from torch import nn

from contrastiveprosthetics_torch.models.emg_net import EMGNet
from contrastiveprosthetics_torch.models.glove_net import GLOVENet
from contrastiveprosthetics_torch.models.layers import torch_default_init_


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """Plain ``x / ||x||`` along the last axis with no eps
    (reference models.py:123-125)."""
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


class ContrastiveModel(nn.Module):
    def __init__(self, d_e: int = 16, emg_dim: int = 12, n_classes: int = 41,
                 adabn: bool = False, n_linear: int = 7, hidden: int = 512,
                 conv_features: int = 64,
                 generator: torch.Generator | None = None):
        """Parameters are made on the CPU with torch's default init drawn
        from ``generator`` (a fresh ``torch.Generator`` seeded 0 when None);
        move the model with ``.to(device)``."""
        super().__init__()
        self.adabn = adabn
        self.n_classes = n_classes
        self.emg_net = EMGNet(d_e, emg_dim, adabn, n_linear, hidden,
                              conv_features, device="meta")
        self.glove_net = GLOVENet(d_e, n_classes, device="meta")
        self.logit_scale = nn.Parameter(torch.zeros((), device="meta"))
        self.to_empty(device="cpu")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        torch_default_init_(self, generator)
        with torch.no_grad():
            self.logit_scale.zero_()

    def encode_emg(self, frames: torch.Tensor) -> torch.Tensor:
        """(rows, emg_dim) -> (rows, d_e) normalized embeddings."""
        return l2_normalize(self.emg_net(frames))

    def encode_classes(self) -> torch.Tensor:
        """(n_classes, d_e) normalized one-hot class embeddings."""
        labels = torch.arange(self.n_classes,
                              device=self.logit_scale.device)
        return l2_normalize(self.glove_net(labels))
