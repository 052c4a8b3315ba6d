"""Checkpoints in the JAX package's format: its ``TrainState`` msgpack
(``contrastive.msgpack``, the JAX ``train/checkpoint.py:16-26``) read
into the port's ``TrainState`` and written from it, with the ``msgpack``
package alone.

The format, as ``flax.serialization.to_bytes`` writes a ``TrainState``:
a map with ``params``, ``batch_stats``, ``opt_emg`` and ``opt_glove``;
each optimizer a map with ``count``, ``mu`` and ``nu`` (optax's
``ScaleByAdamState``), ``mu`` and ``nu`` trees of the tower's
parameters; every array a msgpack ExtType 1 whose payload is
``msgpack.packb((shape, dtype name, C-order bytes))`` (``bfloat16`` for
a bf16 ``mu``; ExtType 3, a numpy scalar, is read too). Map keys are
flax module names (``TorchConv_0``, ``BatchNorm_10``), matched by name.

The layouts are ``models/convert.py``'s, both ways: the weights go
through :func:`from_flax_variables` and :func:`to_flax_variables`, and
so do both Adam chains' moments, which take exactly their parameters'
permutations (the conv kernels, the first Dense's position-major rows).
Widths, depth and mode come from the trees; plain BatchNorm against
AdaBN is not in them and is the caller's (``adabn``). Two kinds of entry
exist on one side only: the port's dead modules (one value each,
``ContrastiveModel.dead_modules``, written back as they are) and the
running statistics that a JAX AdaBN model keeps and no layer reads.
:func:`read_msgpack` returns the latter beside the state, and
:func:`write_msgpack` takes them back (flax's init values otherwise), so
a trip from either side through the other is the identity.
"""
from __future__ import annotations

from typing import Any, Mapping

import msgpack
import numpy as np
import torch

from contrastiveprosthetics_torch.models.convert import (
    from_flax_variables,
    model_from_state_dict,
    to_flax_variables,
)
from contrastiveprosthetics_torch.train.engine import AdamState, TrainState

STATE_KEYS = ("params", "batch_stats", "opt_emg", "opt_glove")
ADAM_KEYS = ("count", "mu", "nu")
TOWERS = ("emg_net", "glove_net")
OPT = {"emg_net": "opt_emg", "glove_net": "opt_glove"}
EXT_NDARRAY, EXT_NPSCALAR = 1, 3  # flax's _MsgpackExtType


class InteropError(ValueError):
    """The bytes are not a JAX ``TrainState`` msgpack that a mode of the
    port explains."""


# ------------------------------------------------------------ the codec
def _decode(code: int, data: bytes):
    """One flax array: numpy, or a torch tensor for ``bfloat16``, which
    numpy lacks."""
    if code not in (EXT_NDARRAY, EXT_NPSCALAR):
        raise InteropError(f"msgpack ExtType {code} is not a flax array")
    shape, name, buf = msgpack.unpackb(data, raw=True)
    name = name.decode()
    if name == "bfloat16":
        return torch.frombuffer(bytearray(buf), dtype=torch.bfloat16
                                ).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()


def _encode(leaf) -> msgpack.ExtType:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu().contiguous()
        if leaf.dtype == torch.bfloat16:
            return msgpack.ExtType(EXT_NDARRAY, msgpack.packb(
                (list(leaf.shape), "bfloat16",
                 leaf.view(torch.int16).numpy().tobytes())))
        leaf = leaf.numpy()
    leaf = np.asarray(leaf)  # tobytes("C") copies a strided array
    return msgpack.ExtType(EXT_NDARRAY, msgpack.packb(
        (list(leaf.shape), leaf.dtype.name, leaf.tobytes("C"))))


def unpack_tree(data: bytes) -> Any:
    """flax's ``msgpack_restore``: nested maps of arrays."""
    try:
        return msgpack.unpackb(data, ext_hook=_decode, raw=False)
    except InteropError:
        raise
    except Exception as e:  # msgpack reports a bad file in many types
        raise InteropError(f"not a msgpack file ({type(e).__name__}: "
                           f"{e})") from None


def pack_tree(tree: Any) -> bytes:
    """flax's ``msgpack_serialize`` of nested dicts of arrays."""
    return msgpack.packb(tree, default=_encode, use_bin_type=True)


def _map_leaves(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree, prefix: str = ""):
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _f32(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.float().numpy()
    return np.asarray(leaf, np.float32)


def _signature(tree) -> dict:
    """Each leaf's path -> (shape, dtype name)."""
    return {path: (tuple(np.shape(leaf)), str(leaf.dtype).split(".")[-1])
            for path, leaf in _leaves(tree)}


# ------------------------------------------------------------ the trees
def tower_parameter_names(model) -> dict[str, list[str]]:
    """Each tower's parameter names (state_dict keys), in the order of its
    Adam chain's moments (``model.towers()[tower].parameters()``)."""
    names = {id(p): n for n, p in model.named_parameters()}
    return {tower: [names[id(p)] for p in module.parameters()]
            for tower, module in model.towers().items()}


def tree_from_state(state: TrainState,
                    batch_stats: Mapping | None = None) -> dict:
    """The JAX ``TrainState`` tree of ``state``. ``batch_stats``: the JAX
    running statistics of an AdaBN model, as :func:`state_from_tree` gave
    them (flax's init values otherwise)."""
    sd = state.model.state_dict()
    params, stats = to_flax_variables(sd)
    if batch_stats is not None:
        if _signature(batch_stats) != _signature(stats):
            raise InteropError("the carried AdaBN running statistics are "
                               "not the model's BatchNorm layers")
        stats = batch_stats
    names = tower_parameter_names(state.model)
    opts = dict(zip(TOWERS, (state.opt_emg, state.opt_glove)))
    moments = {}
    for part in ("mu", "nu"):
        replaced = dict(sd)
        dtype = torch.float32
        for tower in TOWERS:
            for name, t in zip(names[tower], getattr(opts[tower], part)):
                replaced[name] = t.float()
                dtype = t.dtype if part == "mu" else dtype
        tree = to_flax_variables(replaced)[0]
        if dtype != torch.float32:
            tree = _map_leaves(lambda a: torch.from_numpy(a).to(dtype), tree)
        moments[part] = tree
    return {"params": params, "batch_stats": stats,
            **{OPT[tower]: {
                "count": np.asarray(opts[tower].count, np.int32),
                "mu": moments["mu"][tower], "nu": moments["nu"][tower]}
               for tower in TOWERS}}


def _check_shape(tree) -> None:
    if not isinstance(tree, Mapping) or set(tree) != set(STATE_KEYS):
        keys = list(tree) if isinstance(tree, Mapping) else type(tree)
        raise InteropError(f"not a TrainState: top-level keys {keys}, want "
                           f"{list(STATE_KEYS)}")
    for tower in TOWERS:
        opt = tree[OPT[tower]]
        if not isinstance(opt, Mapping) or set(opt) != set(ADAM_KEYS):
            raise InteropError(f"{OPT[tower]} is not an Adam state (want "
                               f"keys {list(ADAM_KEYS)})")
    if not isinstance(tree["params"], Mapping) or not all(
            isinstance(tree["params"].get(t, {}), Mapping) for t in TOWERS):
        raise InteropError("params is not a tree of the two towers")


def state_from_tree(tree: Mapping, *, adabn: bool = True, **widths
                    ) -> tuple[TrainState, dict | None]:
    """The port's ``TrainState`` (on the CPU) of a JAX ``TrainState``
    tree, and the JAX running statistics of an AdaBN model (None for
    plain BatchNorm, whose statistics are the model's). ``widths``: the
    ``ContrastiveModel`` widths of a tower the tree lacks (an idle one).
    Raises :class:`InteropError` when no mode of the port explains the
    tree: a trip back must give its structure, shapes and dtypes."""
    _check_shape(tree)
    mu_dtype = None
    for tower in TOWERS:
        for _, leaf in _leaves(tree[OPT[tower]]["mu"]):
            if isinstance(leaf, torch.Tensor):
                mu_dtype = leaf.dtype
    try:
        stats = _map_leaves(_f32, tree["batch_stats"])
        sd = from_flax_variables(_map_leaves(_f32, tree["params"]), stats,
                                 adabn=adabn, **widths)
        model = model_from_state_dict(sd)
        names = tower_parameter_names(model)
        moments = {part: from_flax_variables(
            {t: _map_leaves(_f32, tree[OPT[t]][part]) for t in TOWERS},
            stats, adabn=adabn, **widths) for part in ("mu", "nu")}
        opts = [AdamState(
            int(np.asarray(tree[OPT[t]]["count"])),
            [moments["mu"][n].to(mu_dtype or torch.float32)
             for n in names[t]],
            [moments["nu"][n] for n in names[t]]) for t in TOWERS]
        state = TrainState(model, *opts)
        want = _signature(tree_from_state(state, stats if adabn else None))
        got = _signature(tree)
    except InteropError:
        raise
    except (KeyError, ValueError, TypeError, IndexError, AttributeError,
            RuntimeError) as e:
        raise InteropError(f"no mode of the port explains the tree "
                           f"({type(e).__name__}: {e})") from None
    if want != got:
        diff = sorted(set(want.items()) ^ set(got.items()))[:6]
        raise InteropError("no mode of the port explains the tree: it "
                           f"differs from the inferred mode's at {diff}")
    return state, (stats if adabn else None)


def read_msgpack(path: str, *, adabn: bool = True, **widths
                 ) -> tuple[TrainState, dict | None]:
    """:func:`state_from_tree` of the msgpack at ``path``."""
    with open(path, "rb") as f:
        return state_from_tree(unpack_tree(f.read()), adabn=adabn, **widths)


def write_msgpack(path: str, state: TrainState,
                  batch_stats: Mapping | None = None) -> None:
    """Write ``state`` as a JAX ``TrainState`` msgpack, which the JAX
    package's ``flax.serialization.from_bytes(template_state(...),
    data)`` restores."""
    data = pack_tree(tree_from_state(state, batch_stats))
    with open(path, "wb") as f:
        f.write(data)
