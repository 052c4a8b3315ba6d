"""sEMG encoder (reference ``EMGNet``, ``code/models.py:230-349``).

The 12-channel frame is a 1x12 one-channel image (NCHW here, as in the
reference): Conv(1->64, 3x3, pad 1) -> ReLU -> BN -> Conv(64->64) -> ReLU ->
BN -> flatten (768, channel-major ``c*12+p``) -> ``n_linear`` x [Dense ->
ReLU -> BN (+ Dropout on the last 4 blocks)] -> head. The contrastive
head is Dense(hidden->d_e, no bias) (models.py:312-315); the prediction
head (``prediction=True``, the softmax baseline, models.py:300-309) is
Linear(hidden->128)@0, ReLU@1, BN@2, Linear(128->n_classes, no bias)@3,
with no dropout. The Sequential indices are the reference's, Dropout and
ReLU included, so the state_dict keys are the reference's
(``train/torch_export.py:189-218`` of the JAX package). The dropout rate
is a forward argument (the JAX package's ``RateDropout``), so one module
trains at any rate.

``dtype=torch.bfloat16`` is the JAX package's bf16 compute dtype
(``models/emg_net.py:37-66``): parameters and running statistics stay
f32, each Conv2d and Linear runs through ``layers.low_precision``, the
BatchNorms take bf16 in and give bf16 out, and the output returns to f32.
"""
from __future__ import annotations

import torch
from torch import nn

from contrastiveprosthetics_torch.models.layers import (
    COMPUTE_DTYPES,
    AdaBN,
    BatchNorm,
    RateDropout,
    at_least_f32,
    low_precision,
    make_norm,
)


class EMGNet(nn.Module):
    def __init__(self, d_e: int = 16, emg_dim: int = 12, adabn: bool = False,
                 n_linear: int = 7, hidden: int = 512,
                 conv_features: int = 64, prediction: bool = False,
                 n_classes: int = 41, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute dtype {dtype}: want one of "
                             f"{COMPUTE_DTYPES}")
        self.emg_dim = emg_dim
        self.dtype = dtype
        F = conv_features
        self.conv_emg = nn.Sequential(
            nn.Conv2d(1, F, 3, padding=1, device=device),
            nn.ReLU(),
            make_norm(F, adabn, device),
            nn.Conv2d(F, F, 3, padding=1, device=device),
            nn.ReLU(),
            make_norm(F, adabn, device),
            nn.Flatten(),
        )
        blocks: list[nn.Module] = []
        width = F * emg_dim
        for i in range(n_linear):
            blocks += [nn.Linear(width, hidden, device=device), nn.ReLU(),
                       make_norm(hidden, adabn, device)]
            if i >= n_linear - 4:  # dropout on the last 4 blocks
                blocks.append(RateDropout())
            width = hidden
        self.linear = nn.Sequential(*blocks)
        if prediction:
            self.last = nn.Sequential(
                nn.Linear(hidden, 128, device=device), nn.ReLU(),
                make_norm(128, adabn, device),
                nn.Linear(128, n_classes, bias=False, device=device))
        else:
            self.last = nn.Sequential(
                nn.Linear(hidden, d_e, bias=False, device=device))

    def norms(self) -> list[nn.Module]:
        """The BatchNorm layers in forward order (2 conv + n_linear, and
        the prediction head's)."""
        return [m for m in self.modules() if isinstance(m, BatchNorm)]

    def forward(self, frames: torch.Tensor, collect: list | None = None,
                dropout: float = 0.0,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """(rows, emg_dim) frames -> (rows, d_e) unnormalized embeddings
        (the prediction head: (rows, n_classes) scores), f32 in a bf16
        compute dtype, else in the parameters' dtype. ``collect`` gathers
        each BatchNorm's batch statistics; in train mode the dropout
        layers drop at rate ``dropout`` with masks drawn from
        ``generator``."""
        x = frames.reshape(-1, 1, 1, self.emg_dim)
        low = self.dtype != torch.float32
        for m in (*self.conv_emg, *self.linear, *self.last):
            if isinstance(m, (BatchNorm, AdaBN)):
                x = m(x, collect)
            elif isinstance(m, RateDropout):
                x = m(x, dropout, generator)
            elif low and isinstance(m, (nn.Conv2d, nn.Linear)):
                x = low_precision(m, x, self.dtype)
            else:
                x = m(x)
        return at_least_f32(x)
