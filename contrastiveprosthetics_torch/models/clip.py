"""CLIP-style wrapper (reference ``Model``, ``code/models.py:66-228``): the
serving methods ``encode_emg`` and ``encode_classes``, the training
``embed`` and the (N, T, T) logits forward (the JAX package's
``models/clip.py:65-156``), and ``l2_penalty``.

Two parameters are dead and exist only so that reference checkpoints load
with ``strict=True``: ``logit_scale`` (initialised to exactly 0, its
multiplication commented out, models.py:81,129) and ``glove_net.last``
(constructed, never called, models.py:425-428). The JAX package has
neither, so neither is trained nor penalised: :meth:`towers` names the two
parameter groups that are.
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


def l2_penalty(module: nn.Module) -> torch.Tensor:
    """Sum of the Frobenius *norms* (not squared) of the weights of the
    ``Conv2d``/``Linear`` modules in ``module`` (reference
    ``EMGNet.l2``/``GLOVENet.l2``, models.py:344-349,467-472). Biases and
    BatchNorm parameters are left out; the selection is by module type,
    because the port's BatchNorm weights are named like any other."""
    norms = [torch.linalg.vector_norm(m.weight) for m in module.modules()
             if isinstance(m, (nn.Conv2d, nn.Linear))]
    return torch.stack(norms).sum()


class ContrastiveModel(nn.Module):
    def __init__(self, d_e: int = 16, emg_dim: int = 12, n_classes: int = 41,
                 adabn: bool = False, n_linear: int = 7, hidden: int = 512,
                 conv_features: int = 64,
                 generator: torch.Generator | None = None, device=None):
        """Parameters are made on ``device`` (default the CPU) with
        torch's default init drawn from ``generator``, which must be on the
        same device (a fresh CPU ``torch.Generator`` seeded 0 when None)."""
        super().__init__()
        self.adabn = adabn
        self.n_classes = n_classes
        self.emg_net = EMGNet(d_e, emg_dim, adabn, n_linear, hidden,
                              conv_features, device="meta")
        self.glove_net = GLOVENet(d_e, n_classes, device="meta")
        self.logit_scale = nn.Parameter(torch.zeros((), device="meta"))
        self.to_empty(device=device or "cpu")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        torch_default_init_(self, generator)
        with torch.no_grad():
            self.logit_scale.zero_()

    def towers(self) -> dict[str, nn.Module]:
        """The two trained parameter groups, as the JAX TrainState holds
        them: the EMG encoder and the live one-hot class encoder."""
        return {"emg_net": self.emg_net, "glove_net": self.glove_net.easy}

    def encode_emg(self, frames: torch.Tensor) -> torch.Tensor:
        """(rows, emg_dim) -> (rows, d_e) normalized embeddings."""
        return l2_normalize(self.emg_net(frames))

    def encode_classes(self) -> torch.Tensor:
        """(n_classes, d_e) normalized one-hot class embeddings."""
        labels = torch.arange(self.n_classes,
                              device=self.logit_scale.device)
        return l2_normalize(self.glove_net(labels))

    def _class_rows(self, B: int, T: int) -> torch.Tensor:
        """(B*T, d_e) class embeddings of labels ``arange(T)`` per item
        (reference ``TaskWrapper.__getitem__``, utils.py:54)."""
        labels = torch.arange(T, device=self.logit_scale.device).repeat(B)
        return self.glove_net(labels)

    def embed(self, emg: torch.Tensor, dp_emg: float = 0.0,
              generator: torch.Generator | None = None):
        """(B, T, emg_dim) -> normalized ``(e, g)``, both (B, T, d_e): the
        inputs of the fused contrastive loss (clip.py:81-92)."""
        B, T = emg.shape[:2]
        e = self.emg_net(emg.reshape(-1, emg.shape[-1]), dropout=dp_emg,
                         generator=generator).reshape(B, T, -1)
        g = self._class_rows(B, T).reshape(B, T, -1)
        return l2_normalize(e), l2_normalize(g)

    def forward(self, emg: torch.Tensor, dp_emg: float = 0.0,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Similarity logits. ``emg`` (B, T, emg_dim) gives (B, T, T);
        the vote input (B, T, W, emg_dim) gives (B*W, T, T) in (item,
        frame) row order, with each item's class embeddings broadcast over
        its W frames (models.py:337-341,463-464)."""
        vote = emg.dim() == 4
        B, T = emg.shape[:2]
        W = emg.shape[2] if vote else 1
        e = self.emg_net(emg.reshape(-1, emg.shape[-1]), dropout=dp_emg,
                         generator=generator)
        d = e.shape[-1]
        if vote:
            e = e.reshape(B, T, W, d).transpose(1, 2).reshape(B * W, T, d)
        else:
            e = e.reshape(B, T, d)
        g = self._class_rows(B, T).reshape(B, T, d)
        if vote:
            g = g[:, None].expand(B, W, T, d).reshape(B * W, T, d)
        return torch.bmm(l2_normalize(e), l2_normalize(g).transpose(1, 2))
