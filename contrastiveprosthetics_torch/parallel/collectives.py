"""The collectives that GSPMD inserts into the JAX package's sharded step,
written out: small ``torch.autograd.Function``s over ``torch.distributed``.

* :func:`copy_to` and :func:`reduce_from`, the Megatron pair of a
  tensor-parallel MLP: ``copy_to`` is the identity forward and all-reduces
  its gradient over the mp group (a replicated activation entering
  column-parallel or sliced use); ``reduce_from`` all-reduces a partial
  product over the mp group and passes its gradient through (the
  row-parallel layer's output).
* :func:`all_reduce_sum`, a sum over a group whose gradient is the sum of
  the ranks' gradients: the BatchNorm sums of the global batch over dp.
* :func:`local_slice`, the rows ``[lo, hi)`` of a replicated tensor (a
  column-parallel layer's bias, a BatchNorm's affine on sharded
  features), whose gradient is put in place and summed over the group, so
  the replicated tensor's gradient is whole on every rank.
* :func:`gather_rows`, the non-differentiable gather of row blocks (a
  sharded weight, the served sessions' outputs, the sweep's values): each
  rank writes its block into a zeroed buffer and the buffer is summed.
  Adding zeros is exact, so the gather is bit for bit.
* :func:`gather_whole`, the same gather with a gradient: the whole
  tensor's gradient narrowed to the rank's block, summed over no rank (a
  sharded weight used whole by every rank of the group, which all compute
  the same whole gradient: the fused chain under mp).
* :func:`sum_flat`, the non-differentiable sum of a list of tensors (a
  step's gradients, its loss and correct count) in one all-reduce.

Only ``all_reduce`` and ``broadcast`` are used: they run on NCCL and on
gloo, CUDA tensors included. None of these catches a failed collective.
A group of one rank still calls the collective, which returns its input,
except in :func:`sum_flat`, which returns the tensors themselves there
and so copies no step's gradients.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _summed(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _summed(grad, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _summed(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _summed(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _summed(grad, ctx.group), None


class _GatherWhole(torch.autograd.Function):
    @staticmethod
    def forward(ctx, part, lo, n, group, dim):
        ctx.lo, ctx.size, ctx.dim = lo, part.shape[dim], dim
        return gather_rows(part, lo, n, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return (grad.narrow(ctx.dim, ctx.lo, ctx.size).contiguous(), None,
                None, None, None)


class _LocalSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lo, hi, group):
        ctx.shape, ctx.lo, ctx.hi, ctx.group = x.shape, lo, hi, group
        return x[lo:hi].clone()

    @staticmethod
    def backward(ctx, grad):
        full = grad.new_zeros(ctx.shape)
        full[ctx.lo:ctx.hi] = grad
        return _summed(full, ctx.group), None, None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the gradient all-reduced over ``group``."""
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``; the gradient passed through."""
    return _ReduceFrom.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``, and its gradient summed too."""
    return _AllReduceSum.apply(x, group)


def local_slice(x: torch.Tensor, lo: int, hi: int, group) -> torch.Tensor:
    """Rows ``[lo, hi)`` of the replicated ``x``; the gradient is whole on
    every rank of ``group``."""
    return _LocalSlice.apply(x, lo, hi, group)


def gather_whole(part: torch.Tensor, lo: int, n: int, group,
                 dim: int = 0) -> torch.Tensor:
    """:func:`gather_rows` of ``part``; its gradient is the whole
    gradient's block ``[lo, lo + part.shape[dim])`` on this rank."""
    return _GatherWhole.apply(part, lo, n, group, dim)


@torch.no_grad()
def gather_rows(part: torch.Tensor, lo: int, n: int, group,
                dim: int = 0) -> torch.Tensor:
    """The (n, ...) tensor along ``dim`` whose rows ``[lo, lo +
    part.shape[dim])`` are this rank's ``part``, every rank of ``group``
    giving its own disjoint block: one all-reduce of a zeroed buffer."""
    shape = list(part.shape)
    shape[dim] = n
    out = part.new_zeros(shape)
    out.narrow(dim, lo, part.shape[dim]).copy_(part)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


@torch.no_grad()
def sum_flat(tensors, group) -> list[torch.Tensor]:
    """Each of ``tensors`` summed over ``group``: their concatenation
    all-reduced in place and split back into views. Where the group has
    one rank the sum is each tensor itself, returned as it is."""
    tensors = list(tensors)
    if dist.get_world_size(group) == 1:
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    return [part.view(t.shape) for part, t in zip(
        flat.split([t.numel() for t in tensors]), tensors)]
