"""Shared layers (reference ``code/models.py:17-62``).

``BatchNorm`` keeps the reference's state_dict keys (``weight``, ``bias``,
``running_mean``, ``running_var``, ``num_batches_tracked``) but computes as
the JAX package's flax BatchNorm does (``models/layers.py:91-113``):

* inference: ``(x - mean) * (weight * rsqrt(var + eps)) + bias``;
* batch statistics: the mean and the *biased* variance (flax's
  ``E[x^2] - E[x]^2``, taken here in one Welford pass, see
  :meth:`BatchNorm.batch_stats`). ``nn.BatchNorm``'s running update uses the
  unbiased one, so the update is written out here
  (:func:`update_running`, flax momentum 0.9), not left to torch. A
  train-mode forward of a plain BatchNorm moves its running statistics
  toward the batch's, outside autograd, as a flax train step with
  ``mutable=["batch_stats"]`` does; a calibration pass (``collect``)
  leaves them to its caller.

Inside :func:`deferred_running_stats` a train-mode forward records its
new running statistics instead of writing them, and its caller writes them
once (:func:`write_running`): a rematerialized step's forward runs twice,
and flax's momentum must apply once, as JAX's step returns the statistics
beside its loss (``engine.py:373,389-390``).

``AdaBN`` (reference ``models.py:17-35``) wraps a stat-less BatchNorm in a
``.bn`` submodule and always normalizes with the current batch.

``RateDropout`` takes its rate as a call argument and its keep mask from
the caller's generator (the JAX package's ``models/layers.py:116-127``).

Under a mesh (``parallel/mesh.py``; the JAX package's sharded
``_sgd_step``, where GSPMD computes every statistic of the global batch)
a BatchNorm's batch statistics are those of the global batch: the count
and the sum all-reduced over dp give the mean, then the sum of ``(x -
mean)^2`` all-reduced gives the biased variance, the two passes of
``torch.var_mean``; its running statistics move once, identically on
every rank. On a tensor-parallel layer's sharded features it normalizes
its own features ``cols`` with its slice of the replicated affine. A
dropout layer draws the masks of the global batch from the step's
generator and keeps its own rows (``rows``) and features (``cols``), so a
sharded step drops what the unsharded one drops.

A bfloat16 tower (``EMGNet(dtype=torch.bfloat16)``) rounds where flax's
``dtype=bfloat16`` layers do, with parameters and running statistics in
f32 (the JAX package's ``models/layers.py:47-113``): :func:`low_precision`
runs a Conv2d or Linear, and ``BatchNorm`` takes its statistics and
normalizes in f32 from a bf16 input and returns bf16 (flax 0.12.3's
``_compute_stats`` and ``_normalize``).
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from contrastiveprosthetics_torch.parallel.collectives import (
    all_reduce_sum,
    gather_rows,
    local_slice,
)

COMPUTE_DTYPES = (torch.float32, torch.bfloat16)

# the (buffer, new value) pairs of the innermost deferred_running_stats,
# or None: running statistics are written as they are computed
_deferred: list | None = None


@contextlib.contextmanager
def deferred_running_stats():
    """Within it, a train-mode BatchNorm (single or stacked) and the fused
    chain append ``(buffer, new value)`` pairs of their running statistics
    to the yielded list instead of writing them; the buffers are left as
    they were (a train-mode forward never reads them)."""
    global _deferred
    outer, _deferred = _deferred, []
    try:
        yield _deferred
    finally:
        _deferred = outer


@torch.no_grad()
def set_running(buffers, values) -> None:
    """Write new running statistics into their buffers (one foreach copy),
    or record them inside :func:`deferred_running_stats`."""
    if _deferred is not None:
        _deferred.extend(zip(buffers, values))
    else:
        torch._foreach_copy_(list(buffers), list(values))


@torch.no_grad()
def write_running(pairs) -> None:
    """Write the pairs a :func:`deferred_running_stats` recorded."""
    for buffer, value in pairs:
        buffer.copy_(value)


class BatchNorm(nn.Module):
    """BatchNorm over the channel axis (dim 1) of (N, C) or (N, C, H, W)."""

    # set by parallel.mesh.shard_state: the Mesh (global batch statistics
    # over dp) and the features [lo, hi) of a sharded input
    mesh = None
    cols: tuple[int, int] | None = None

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
        """Per-channel (mean, biased var) of ``x``, a bf16 ``x`` in f32
        (flax promotes to at least f32). flax takes ``E[x^2] - E[x]^2``
        with XLA's pairwise sums; PyTorch's CPU sum over the row axis is
        sequential, so a few thousand rows lose digits that way. One
        Welford pass keeps both within f32 roundoff of the exact
        statistics."""
        dims = [0] + list(range(2, x.dim()))
        xf = at_least_f32(x)
        if self.mesh is None or self.mesh.n_dp == 1:
            var, mean = torch.var_mean(xf, dim=dims, correction=0)
            return mean, var
        group = self.mesh.dp_group
        sums = all_reduce_sum(torch.cat([
            xf.sum(dims), xf.new_full((1,), xf.numel() // xf.shape[1])]),
            group)
        mean = sums[:-1] / sums[-1]
        dev = xf - mean.view(self._shape(x))
        return mean, all_reduce_sum((dev * dev).sum(dims), group) / sums[-1]

    def _local(self, *tensors):
        """``tensors`` (the affine or the running statistics), sliced to
        this rank's features where the input is sharded."""
        if self.cols is None:
            return tensors
        lo, hi = self.cols
        return tuple(local_slice(t, lo, hi, self.mesh.mp_group)
                     for t in tensors)

    def normalize(self, x, mean, var) -> torch.Tensor:
        """In f32 (a bf16 ``x`` promotes), returned in ``x``'s dtype."""
        shape = self._shape(x)
        weight, bias = self._local(self.weight, self.bias)
        mul = torch.rsqrt(var + self.eps) * weight
        return ((x - mean.view(shape)) * mul.view(shape)
                + bias.view(shape)).to(x.dtype)

    def forward(self, x: torch.Tensor, collect: list | None = None):
        """Batch statistics in train mode or without running stats,
        running averages otherwise. ``collect``, when given, receives each
        batch's (mean, var) in layer order (the calibration pass) and the
        running statistics stay as they are; without it a train-mode
        forward updates them."""
        if self.training or not self.track_running_stats:
            mean, var = self.batch_stats(x)
            if collect is not None:
                collect.append((mean, var))
            elif self.training and self.track_running_stats:
                with torch.no_grad():
                    b_mean, b_var = mean, var
                    if self.cols is not None:  # every feature's, over mp
                        b_mean, b_var = gather_rows(
                            torch.stack([mean, var]), self.cols[0],
                            self.num_features, self.mesh.mp_group, 1)
                    set_running(
                        (self.running_mean, self.running_var),
                        (update_running(self.running_mean, b_mean),
                         update_running(self.running_var, b_var)))
            return self.normalize(x, mean, var)
        return self.normalize(x, *self._local(self.running_mean,
                                               self.running_var))


class AdaBN(nn.Module):
    """Reference AdaBatchNorm: a ``.bn``-wrapped BatchNorm without running
    statistics (current-batch statistics in every mode)."""

    def __init__(self, num_features: int, device=None):
        super().__init__()
        self.bn = BatchNorm(num_features, track_running_stats=False,
                            device=device)

    def forward(self, x, collect: list | None = None):
        return self.bn(x, collect)


class RateDropout(nn.Module):
    """Inverted dropout whose rate is a call argument: keep each value
    with probability ``1 - rate`` (mask from ``generator``) and scale the
    kept ones by ``1 / (1 - rate)``. The identity at rate 0 and in eval
    mode."""

    # set under a mesh (parallel/mesh.py): the global batch's item count
    # and this rank's items (n, lo, hi), and the features (F, lo, hi) of a
    # sharded input
    rows: tuple[int, int, int] | None = None
    cols: tuple[int, int, int] | None = None

    def forward(self, x: torch.Tensor, rate: float = 0.0,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if not self.training or rate == 0.0:
            return x
        if generator is None:
            raise ValueError("dropout at a nonzero rate needs an explicit "
                             "torch.Generator for its mask")
        keep = 1.0 - rate
        return torch.where(self._keep(x, keep, generator), x / keep, 0.0)

    def _keep(self, x, keep, generator) -> torch.Tensor:
        """The keep mask of ``x``: drawn at ``x``'s shape, or under a mesh
        at the global batch's (n * rows-per-item, F) and sliced to this
        rank's rows and features."""
        if self.rows is None and self.cols is None:
            return torch.rand(x.shape, generator=generator,
                              device=x.device) < keep
        n, lo, hi = self.rows or (1, 0, 1)
        k = x.shape[0] // (hi - lo)  # rows an item
        F, c0, c1 = self.cols or (x.shape[1], 0, x.shape[1])
        mask = torch.rand((n * k, F), generator=generator,
                          device=x.device) < keep
        return mask[lo * k:hi * k, c0:c1]


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` promoted to f32 if it is of a narrower float type (bf16), else
    as it is (f32 and float64 keep their bits)."""
    return x.float() if torch.finfo(x.dtype).bits < 32 else x


def bf16_values(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (round to nearest even), as f32 values: the
    operands whose products are exact in f32."""
    return t.to(torch.bfloat16).float()


def low_product(x: torch.Tensor, w: torch.Tensor, bias, dtype: torch.dtype,
                product) -> torch.Tensor:
    """``product(x, w)`` at compute dtype ``dtype``, as flax's ``Conv``/
    ``Dense`` with ``dtype=bfloat16`` and f32 parameters compute it: ``x``
    and ``w`` cast to ``dtype``; their product (each product of two bf16
    values is exact in f32, the sums are f32) rounded to ``dtype`` once;
    then ``bias`` (None, or shaped to broadcast) cast to ``dtype`` and
    added in ``dtype``, a second rounding. Returns ``dtype``."""
    y = product(x.to(dtype).float(), w.to(dtype).float()).to(dtype)
    return y if bias is None else y + bias.to(dtype)


def low_precision(layer: nn.Module, x: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """A ``Conv2d`` or ``Linear`` at compute dtype ``dtype``
    (:func:`low_product`). Returns ``dtype``."""
    bias = layer.bias
    if isinstance(layer, nn.Conv2d):
        def product(x, w):
            return F.conv2d(x, w, None, layer.stride, layer.padding)
        bias = None if bias is None else bias.view(1, -1, 1, 1)
    else:
        product = F.linear
    return low_product(x, layer.weight, bias, dtype, product)


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
