"""Class encoder (reference ``GLOVENet``, ``code/models.py:352-472``; the
JAX package's ``models/glove_net.py``), in one of three layouts, ``mode``:

* ``"onehot"``, the contrastive default: the class embedding is
  ``Linear(n_classes -> d_e)`` applied to the one-hot label
  (models.py:411-414, 457-458). ``last`` is the reference's dead 256->d_e
  projection: constructed (models.py:425-428) but never called; it is
  kept so that a reference state_dict loads with ``strict=True``.
* ``"reference"``, the softmax baseline's idle tower (``--prediction``
  without ``--glove``): the reference's key set, ``easy`` =
  Linear(n_classes -> d_e) and ``last`` = Linear(256 -> 128)@0, ReLU@1,
  BN@2, Dropout@3, Linear(128 -> n_classes, no bias)@4 (models.py:411-428),
  as the JAX package's exporter writes it (``train/torch_export.py:
  270-290``). It is never called, trained or penalised.
* ``"mlp"``: a small MLP over the ``glove_dim`` glove angles, under the
  port's own keys ``mlp.{0,2,4}``, which mirror the reference ``last``:
  Linear(glove_dim -> 128)@0, ReLU@1, BN@2, Dropout@3, Linear(128 -> out,
  no bias)@4. ``out`` is n_classes for the glove prediction baseline
  (``--prediction --glove``: the evident intent of the reference's
  dimensionally broken head) and d_e for ``--glove_encoding`` (class
  embeddings from glove angles, the reference's stated future direction,
  README.md:19). Neither has a reference layout.
"""
from __future__ import annotations

import torch
from torch import nn

from contrastiveprosthetics_torch.models.layers import RateDropout, make_norm

MODES = ("onehot", "reference", "mlp")


def tower_mode(prediction: bool, glove: bool, glove_encoding: bool) -> str:
    """The class tower's layout for a model's switches, as the JAX
    ``GLOVENet`` picks its branch (prediction first; ``glove`` alone
    changes nothing)."""
    if prediction:
        return "mlp" if glove else "reference"
    return "mlp" if glove_encoding else "onehot"


class GLOVENet(nn.Module):
    def __init__(self, d_e: int = 16, n_classes: int = 41,
                 mode: str = "onehot", out: int | None = None,
                 glove_dim: int = 20, adabn: bool = False, device=None):
        """``out``: the MLP's output width (``mode="mlp"`` only)."""
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"GLOVENet mode {mode!r}, want one of {MODES}")
        self.mode = mode
        self.n_classes = n_classes
        self.glove_dim = glove_dim
        if mode == "mlp":
            self.mlp = nn.Sequential(
                nn.Linear(glove_dim, 128, device=device), nn.ReLU(),
                make_norm(128, adabn, device), RateDropout(),
                nn.Linear(128, out, bias=False, device=device))
            return
        self.easy = nn.Sequential(nn.Linear(n_classes, d_e, device=device))
        if mode == "onehot":
            self.last = nn.Sequential(
                nn.Linear(256, d_e, bias=False, device=device))
        else:
            self.last = nn.Sequential(
                nn.Linear(256, 128, device=device), nn.ReLU(),
                make_norm(128, adabn, device), RateDropout(),
                nn.Linear(128, n_classes, bias=False, device=device))

    def trained(self) -> nn.Module:
        """The parameters a step trains: ``easy`` (one-hot), ``mlp``, or
        none (the reference layout's idle tower)."""
        if self.mode == "reference":
            return nn.Sequential()
        return self.easy if self.mode == "onehot" else self.mlp

    def forward(self, labels: torch.Tensor | None = None,
                glove: torch.Tensor | None = None, dropout: float = 0.0,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """One-hot: (rows,) int class ids -> (rows, d_e). MLP: (rows,
        glove_dim) glove angles -> (rows, out), the dropout layer dropping
        at rate ``dropout`` in train mode with masks from ``generator``.
        Unnormalized."""
        if self.mode == "onehot":
            hot = nn.functional.one_hot(labels, self.n_classes).to(
                self.easy[0].weight.dtype)
            return self.easy(hot)
        if self.mode != "mlp":
            raise RuntimeError("the reference layout's glove tower is never "
                               "called (the softmax baseline classifies "
                               "from the EMG tower)")
        x = glove.reshape(-1, self.glove_dim)
        for m in self.mlp:
            x = m(x, dropout, generator) if isinstance(m, RateDropout) \
                else m(x)
        return x
