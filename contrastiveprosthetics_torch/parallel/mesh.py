"""Device meshes and the sharding rule (the JAX package's
``parallel/mesh.py``), on ``torch.distributed``.

The JAX package shards inside one process with GSPMD. The port runs one
process per rank in a ``torch.distributed`` group and names each rank's
place in a ``(dp, mp)`` ``DeviceMesh``:

* ``dp``: the batch of one training run split over ranks (the gradients
  summed over dp), the crossval sweep's configs (whole chunks a rank, no
  communication until the values are gathered) or the served sessions;
* ``mp``: the EMG encoder's wide dense kernels sharded Megatron-style,
  consecutive layers column- then row-parallel (``models/emg_net.py``).

Placements are those of ``torch.distributed.tensor`` (one per mesh dim,
dp then mp). The rule is JAX's ``_param_spec`` (``mesh.py:59-83``) on
torch's layout: a flax kernel is (d_in, d_out) and an ``nn.Linear``
weight (out, in), so JAX's column-parallel ``P(None, "mp")`` shards dim
0 of the weight and its row-parallel ``P("mp", None)`` dim 1. Biases,
BatchNorm parameters and statistics, the conv kernels and every other
small leaf are replicated, as JAX's rule leaves them; Adam's moments
follow their parameters (``mesh.py:97-105``). The layer index of JAX's
``TorchDense_<i>`` is the i-th ``nn.Linear`` of its tower in forward
order.

Every rank of the default group calls :func:`make_mesh` (it creates the
mesh's process groups); a rank outside a mesh smaller than the group
gets an inactive :class:`Mesh`.
"""
from __future__ import annotations

import copy
import dataclasses

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from contrastiveprosthetics_torch.models.layers import BatchNorm, RateDropout
from contrastiveprosthetics_torch.parallel.collectives import gather_rows


class Mesh:
    """A ``(dp, mp)`` mesh over ranks ``[0, n_dp * n_mp)`` of the default
    group, and this rank's coordinates and groups in it (None outside
    it)."""

    def __init__(self, device_mesh: DeviceMesh):
        self.device_mesh = device_mesh
        self.n_dp, self.n_mp = device_mesh.mesh.shape
        coord = device_mesh.get_coordinate()
        self.active = coord is not None
        self.dp_rank, self.mp_rank = coord if self.active else (None, None)
        self.dp_group = device_mesh.get_group("dp") if self.active else None
        self.mp_group = device_mesh.get_group("mp") if self.active else None

    def __deepcopy__(self, memo):  # process groups are not copied
        return self

    def __repr__(self) -> str:
        return (f"Mesh(dp={self.n_dp}, mp={self.n_mp}, "
                f"rank=({self.dp_rank}, {self.mp_rank}))")


def make_mesh(n_dp: int | None = None, n_mp: int = 1) -> Mesh:
    """A (dp x mp) mesh over the initialized default group's ranks: all of
    them by default (``n_dp`` = world size // ``n_mp``), else the first
    ``n_dp * n_mp``. Its groups use the default group's backend (NCCL on
    one CUDA device a rank, gloo on the CPU or where a caller asked for
    it)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized torch.distributed "
                           "process group")
    world = dist.get_world_size()
    if n_dp is None:
        n_dp = world // n_mp
    use = n_dp * n_mp
    if use > world:
        raise ValueError(f"need {use} devices, have {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return Mesh(DeviceMesh(device_type, torch.arange(use).reshape(n_dp, n_mp),
                           mesh_dim_names=("dp", "mp")))


# --------------------------------------------------------- placements
def local_range(n: int, parts: int, index: int) -> tuple[int, int]:
    """Part ``index`` of ``n`` rows split into ``parts`` contiguous parts,
    the first ``n % parts`` one row longer (``torch.tensor_split``'s)."""
    base, extra = divmod(n, parts)
    lo = index * base + min(index, extra)
    return lo, lo + base + (index < extra)


def param_spec(shape, layer_index: int, hidden: int) -> tuple:
    """JAX's tensor-parallel rule for one parameter of torch shape
    ``shape``, the ``layer_index``-th ``nn.Linear`` weight of its tower
    where it is one (else pass -1): alternate column/row sharding of the
    (hidden x hidden) kernels by layer index parity, the input projection
    column-parallel, the head row-parallel, the rest replicated."""
    if layer_index < 0 or len(shape) != 2:
        return (Replicate(), Replicate())
    d_out, d_in = shape
    col, row = (Replicate(), Shard(0)), (Replicate(), Shard(1))
    if d_in == hidden and d_out == hidden:
        return row if layer_index % 2 else col
    if d_out == hidden:
        return col
    if d_in == hidden:
        return row
    return (Replicate(), Replicate())


def state_placements(state, hidden: int) -> dict[str, tuple]:
    """The placement of every trained parameter of ``state.model``, by its
    ``state_dict`` name (JAX's ``state_shardings`` of the params): the
    layer index of a ``nn.Linear`` weight is its place among its tower's
    ``nn.Linear`` modules."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    out = {}
    for tower in state.model.towers().values():
        index = {id(m.weight): i for i, m in enumerate(
            m for m in tower.modules() if isinstance(m, nn.Linear))}
        for p in tower.parameters():
            out[names[id(p)]] = param_spec(tuple(p.shape),
                                           index.get(id(p), -1), hidden)
    return out


def _moments(model, state, shards: dict, fn):
    """Both Adam chains of ``state`` over ``model``'s towers, each moment
    of a parameter in ``shards`` (by id) mapped by ``fn(moment, info)``,
    the others copied."""
    opts = []
    for tower, opt in zip(model.towers().values(),
                          (state.opt_emg, state.opt_glove)):
        infos = [shards.get(id(p)) for p in tower.parameters()]
        opts.append(dataclasses.replace(opt, **{
            name: [m.clone() if info is None else fn(m, info)
                   for m, info in zip(getattr(opt, name), infos)]
            for name in ("mu", "nu")}))
    return opts


def shard_state(state, mesh: Mesh, hidden: int):
    """This rank's part of ``state`` (a single model's ``TrainState``) on
    ``mesh``: under mp each sharded weight and its Adam moments narrowed
    to the rank's block (``hidden`` is the dense width the rule reads),
    the EMG encoder's dense stack set to its tensor-parallel form; every
    BatchNorm given the mesh (batch statistics of the global batch over
    dp). The replicated leaves are copies."""
    from contrastiveprosthetics_torch.train.engine import TrainState

    model = copy.deepcopy(state.model)
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.mesh = mesh
    shards = {}
    if mesh.n_mp > 1:
        sharded = sorted(n for n, s in state_placements(state, hidden).items()
                         if isinstance(s[1], Shard))
        if any(not n.startswith("emg_net.") for n in sharded):
            raise ValueError("tensor parallelism covers the EMG encoder's "
                             "dense stack and head; this model's hidden "
                             f"width {hidden} shards {sharded}")
        shards = model.emg_net.shard_dense(mesh, hidden)
    return TrainState(model, *_moments(
        model, state, shards,
        lambda m, info: m.narrow(info[0], info[1], info[2] - info[1])
        .clone()))


def gather_state(state, mesh: Mesh):
    """The whole state from its shards on every rank of the mp group: the
    inverse of :func:`shard_state`, bit for bit, with no mesh left in the
    model (a gathered state goes through ``train/jax_interop.py`` and the
    checkpoints as any other)."""
    from contrastiveprosthetics_torch.train.engine import TrainState

    model = copy.deepcopy(state.model)
    for m in model.modules():
        if isinstance(m, (BatchNorm, RateDropout)):
            for attr in ("mesh", "cols", "rows"):
                m.__dict__.pop(attr, None)
    shards = model.emg_net.gather_dense()
    return TrainState(model, *_moments(
        model, state, shards,
        lambda m, info: gather_rows(m, info[1], info[3], info[4].mp_group,
                                    info[0])))


def gather_grads(model, grads: dict) -> dict[str, torch.Tensor]:
    """A sharded step's gradients (``Trainer.loss_and_grads`` under a mesh:
    one list a tower, over ``model.towers()``'s parameters) by
    ``state_dict`` name, each sharded weight's gathered whole over mp (bit
    for bit), the rest as they are."""
    names = {id(p): n for n, p in model.named_parameters()}
    shards = {id(m.weight): m.__dict__["shard"] for m in model.modules()
              if "shard" in m.__dict__}
    out = {}
    for tower, tower_grads in zip(model.towers().values(),
                                  (grads["emg_net"], grads["glove_net"])):
        for p, g in zip(tower.parameters(), tower_grads):
            shard = shards.get(id(p))
            if shard is not None:
                dim, lo, _, n, mesh = shard
                g = gather_rows(g, lo, n, mesh.mp_group, dim)
            out[names[id(p)]] = g
    return out


def set_batch_rows(model, rows: tuple[int, int, int] | None) -> None:
    """Each dropout layer of ``model`` draws the masks of a batch of
    ``rows[0]`` items and keeps items ``[rows[1], rows[2])``, this rank's
    (None: the batch it is given)."""
    for m in model.modules():
        if isinstance(m, RateDropout):
            m.rows = rows
