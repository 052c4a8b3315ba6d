"""Shared layers (reference ``code/models.py:17-62``).

``BatchNorm`` keeps the reference's state_dict keys (``weight``, ``bias``,
``running_mean``, ``running_var``, ``num_batches_tracked``) but computes as
the JAX package's flax BatchNorm does (``models/layers.py:91-113``):

* inference: ``(x - mean) * (weight * rsqrt(var + eps)) + bias``;
* batch statistics: ``mean = E[x]``, ``var = max(0, E[x^2] - E[x]^2)``,
  the *biased* variance. ``nn.BatchNorm``'s running update uses the
  unbiased one, so the calibration update is written out here
  (:func:`update_running`), not left to torch.

``AdaBN`` (reference ``models.py:17-35``) wraps a stat-less BatchNorm in a
``.bn`` submodule and always normalizes with the current batch.
"""
from __future__ import annotations

import math

import torch
from torch import nn


class BatchNorm(nn.Module):
    """BatchNorm over the channel axis (dim 1) of (N, C) or (N, C, H, W)."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 track_running_stats: bool = True, device=None):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        self.track_running_stats = track_running_stats
        if track_running_stats:
            self.register_buffer(
                "running_mean", torch.zeros(num_features, device=device))
            self.register_buffer(
                "running_var", torch.ones(num_features, device=device))
            self.register_buffer(
                "num_batches_tracked",
                torch.zeros((), dtype=torch.int64, device=device))

    def _shape(self, x: torch.Tensor) -> list[int]:
        return [1, -1] + [1] * (x.dim() - 2)

    def batch_stats(self, x: torch.Tensor):
        """Per-channel (mean, biased var) of ``x``, as flax computes them."""
        dims = [0] + list(range(2, x.dim()))
        mean = x.mean(dim=dims)
        mean2 = (x * x).mean(dim=dims)
        return mean, torch.clamp(mean2 - mean * mean, min=0.0)

    def normalize(self, x, mean, var) -> torch.Tensor:
        shape = self._shape(x)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)

    def forward(self, x: torch.Tensor, collect: list | None = None):
        """Batch statistics in train mode or without running stats,
        running averages otherwise. ``collect``, when given, receives each
        batch's (mean, var) in layer order (the calibration pass)."""
        if self.training or not self.track_running_stats:
            mean, var = self.batch_stats(x)
            if collect is not None:
                collect.append((mean, var))
            return self.normalize(x, mean, var)
        return self.normalize(x, self.running_mean, self.running_var)


class AdaBN(nn.Module):
    """Reference AdaBatchNorm: a ``.bn``-wrapped BatchNorm without running
    statistics (current-batch statistics in every mode)."""

    def __init__(self, num_features: int, device=None):
        super().__init__()
        self.bn = BatchNorm(num_features, track_running_stats=False,
                            device=device)

    def forward(self, x, collect: list | None = None):
        return self.bn(x, collect)


def make_norm(num_features: int, adabn: bool, device=None) -> nn.Module:
    return (AdaBN(num_features, device=device) if adabn
            else BatchNorm(num_features, device=device))


def update_running(old: torch.Tensor, batch: torch.Tensor,
                   momentum: float = 0.9) -> torch.Tensor:
    """flax's running-average update (torch momentum 0.1 = flax 0.9)."""
    return momentum * old + (1.0 - momentum) * batch


@torch.no_grad()
def torch_default_init_(module: nn.Module, generator: torch.Generator) -> None:
    """Torch's default Linear/Conv init, U(+-1/sqrt(fan_in)) for weights and
    biases (kaiming-uniform with a=sqrt(5)), drawn from ``generator``;
    BatchNorm gets weight 1, bias 0 and identity running statistics."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, BatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if m.track_running_stats:
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
                m.num_batches_tracked.zero_()
