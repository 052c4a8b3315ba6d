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

Under an mp mesh (:meth:`EMGNet.shard_dense`, called by
``parallel/mesh.py::shard_state``) the dense stack and the head run in
tensor-parallel form, as GSPMD partitions the JAX package's step by its
rule (``parallel/mesh.py``): each ``nn.Linear`` the rule shards holds its
block of the weight (its bias stays whole). A column-parallel layer gives
this rank's block of the output features; ReLU, BatchNorm (per feature:
local apart from the dp sums) and dropout act on them locally. A
row-parallel layer takes the matching block of the input features (its
own slice of a whole input, with no collective) and its partial product
is summed over mp before its bias, which is added once. The conv stack
stays whole, as JAX's rule leaves it. In bf16 a column-parallel layer is
``low_product`` on its weight block and bias slice; a row-parallel one
keeps its partial product of the bf16-cast operands in f32 (each product
exact), sums it over mp in f32 and rounds it to bf16 once, after the sum,
then adds the bias in bf16: the unsharded layer's rounding points, only
the f32 sum's order differs. The fused chain takes each sharded weight
whole instead (:func:`whole_weight`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as nnf
from torch import nn

from contrastiveprosthetics_torch.models.layers import (
    COMPUTE_DTYPES,
    AdaBN,
    BatchNorm,
    RateDropout,
    at_least_f32,
    low_precision,
    low_product,
    make_norm,
)
from contrastiveprosthetics_torch.parallel.collectives import (
    copy_to,
    gather_rows,
    gather_whole,
    local_slice,
    reduce_from,
)


def whole_weight(m: nn.Module) -> torch.Tensor:
    """``m.weight`` whole: a weight the mp rule sharded
    (:meth:`EMGNet.shard_dense`) gathered over mp, its gradient narrowed
    back to this rank's block (``gather_whole``); any other as it is."""
    shard = m.__dict__.get("shard")
    if shard is None:
        return m.weight
    dim, lo, _, n, mesh = shard
    return gather_whole(m.weight, lo, n, mesh.mp_group, dim)


class EMGNet(nn.Module):
    # the mesh of a tensor-parallel dense stack (shard_dense), or None
    mesh = None

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

    def _dense(self) -> tuple[nn.Module, ...]:
        return (*self.linear, *self.last)

    def shard_dense(self, mesh, hidden: int) -> dict[int, tuple]:
        """Narrow each dense weight the mp rule shards to this rank's
        block and mark the BatchNorms and dropouts that then act on
        sharded features, in place. Returns ``{id(narrowed weight):
        m.shard}``, ``m.shard`` being (dim, lo, hi, whole size, mesh)."""
        from contrastiveprosthetics_torch.parallel.mesh import (
            local_range,
            param_spec,
        )

        cols, index = None, 0  # the features [lo, hi) x holds, or None
        shards = {}
        for m in self._dense():
            if isinstance(m, nn.Linear):
                dim = getattr(param_spec(tuple(m.weight.shape), index,
                                         hidden)[1], "dim", None)
                index += 1
                if dim is None and cols is None:
                    continue
                n = m.weight.shape[dim if dim is not None else 1]
                lo, hi = local_range(n, mesh.n_mp, mesh.mp_rank)
                if dim != 1 and cols is not None:
                    raise ValueError(f"dense layer {index - 1} takes "
                                     "sharded features but is not "
                                     "row-parallel")
                m.shard = (dim, lo, hi, n, mesh)
                m.weight = nn.Parameter(
                    m.weight.detach().narrow(dim, lo, hi - lo).clone())
                shards[id(m.weight)] = m.shard
                cols = (lo, hi, n) if dim == 0 else None
            elif isinstance(m, (BatchNorm, AdaBN)):
                getattr(m, "bn", m).cols = cols and cols[:2]
            elif isinstance(m, RateDropout):
                m.cols = cols and (cols[2], cols[0], cols[1])
        if cols is not None:
            raise ValueError("the head leaves sharded features")
        self.mesh = mesh
        return shards

    def gather_dense(self) -> dict[int, tuple]:
        """The inverse of :meth:`shard_dense`: each sharded weight gathered
        whole over mp (bit for bit) and the marks taken off. Returns
        ``{id(whole weight): its former m.shard}``."""
        out = {}
        for m in self._dense():
            if isinstance(m, nn.Linear) and "shard" in m.__dict__:
                shard = m.__dict__.pop("shard")
                dim, lo, _, n, mesh = shard
                m.weight = nn.Parameter(gather_rows(m.weight.detach(), lo, n,
                                                    mesh.mp_group, dim))
                out[id(m.weight)] = shard
        self.__dict__.pop("mesh", None)
        return out

    def _parallel_linear(self, m: nn.Linear, x: torch.Tensor):
        """A dense layer under mp: column-parallel (this rank's output
        features), row-parallel (summed over mp, then the bias) or whole;
        in a bf16 tower with the unsharded layer's roundings (see the
        module docstring)."""
        low = self.dtype != torch.float32
        shard = m.__dict__.get("shard")
        if shard is None:
            return low_precision(m, x, self.dtype) if low else m(x)
        dim, lo, hi, n, mesh = shard
        group = mesh.mp_group
        if dim == 0:
            bias = None if m.bias is None else local_slice(m.bias, lo, hi,
                                                           group)
            x = copy_to(x, group)
            if low:
                return low_product(x, m.weight, bias, self.dtype, nnf.linear)
            return nnf.linear(x, m.weight, bias)
        if x.shape[-1] == n:  # a whole input: this rank's features of it
            x = copy_to(x, group)[:, lo:hi]
        w = m.weight
        if low:  # the exact products' f32 partial sums, rounded after mp's
            x, w = x.to(self.dtype).float(), w.to(self.dtype).float()
        y = reduce_from(nnf.linear(x, w), group)
        if low:
            y = y.to(self.dtype)
        if m.bias is None:
            return y
        return y + (m.bias.to(self.dtype) if low else m.bias)

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
            elif self.mesh is not None and isinstance(m, nn.Linear):
                x = self._parallel_linear(m, x)
            elif low and isinstance(m, (nn.Conv2d, nn.Linear)):
                x = low_precision(m, x, self.dtype)
            else:
                x = m(x)
        return at_least_f32(x)
