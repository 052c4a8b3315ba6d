"""Weights in and out of the port.

The port's native checkpoint is the reference ``Model.state_dict()`` saved
with ``torch.save`` (a ``.pt``); ``ContrastiveModel`` has exactly its keys,
so such a file loads with ``strict=True``.

:func:`from_flax_variables` turns the JAX package's variable trees (nested
dicts of numpy arrays, as a msgpack restore gives them) into that layout:
the port's own copy of the transforms in the JAX package's
``train/torch_export.py:55-73,178-267``.
"""
from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

from contrastiveprosthetics_torch.models.clip import ContrastiveModel


def _conv_weight(kernel: np.ndarray) -> np.ndarray:
    """flax NHWC (kh, kw, in, out) -> torch (out, in, kh, kw)."""
    return np.transpose(kernel, (3, 2, 0, 1))


def _first_dense_weight(kernel: np.ndarray, conv_features: int) -> np.ndarray:
    """flax (in, out) kernel whose input axis is position-major ``p*C+c``
    -> torch (out, in) weight with the channel-major input axis ``c*W+p``
    of the reference's conv flatten (models.py:263)."""
    in_f, out_f = kernel.shape
    positions = in_f // conv_features
    return (kernel.reshape(positions, conv_features, out_f)
            .transpose(2, 1, 0).reshape(out_f, in_f))


def _numbered(tree: Mapping[str, Any], kind: str, inner: str) -> list[dict]:
    names = sorted((n for n in tree if n.startswith(kind + "_")),
                   key=lambda n: int(n.rsplit("_", 1)[1]))
    return [tree[n][inner] for n in names]


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def from_flax_variables(params: Mapping[str, Any],
                        batch_stats: Mapping[str, Any] | None = None,
                        *, adabn: bool = False) -> dict[str, torch.Tensor]:
    """JAX contrastive-model variables -> reference-layout state_dict.

    The dead entries a real checkpoint carries are synthesized as the JAX
    exporter does: ``glove_net.last.0.weight`` as zeros, ``logit_scale``
    as 0.0, ``num_batches_tracked`` as int64 0.
    """
    emg_p, glove_p = params["emg_net"], params["glove_net"]
    emg_s = (batch_stats or {}).get("emg_net", {})
    convs = _numbered(emg_p, "TorchConv", "Conv_0")
    denses = _numbered(emg_p, "TorchDense", "Dense_0")
    bns = _numbered(emg_p, "BatchNorm", "BatchNorm_0")
    stats = [] if adabn else _numbered(emg_s, "BatchNorm", "BatchNorm_0")
    n_linear = len(denses) - 1
    F = int(np.shape(convs[0]["kernel"])[3])
    if len(bns) != 2 + n_linear or (not adabn and len(stats) != len(bns)):
        raise ValueError("not a contrastive EMGNet variable tree "
                         f"({len(denses)} denses, {len(bns)} BatchNorms, "
                         f"{len(stats)} running statistics)")

    sd: dict[str, torch.Tensor] = {}

    def put_bn(prefix: str, i: int):
        mid = f"{prefix}.bn." if adabn else f"{prefix}."
        sd[mid + "weight"] = _f32(bns[i]["scale"])
        sd[mid + "bias"] = _f32(bns[i]["bias"])
        if not adabn:
            sd[mid + "running_mean"] = _f32(stats[i]["mean"])
            sd[mid + "running_var"] = _f32(stats[i]["var"])
            sd[mid + "num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)

    for j, idx in enumerate((0, 3)):  # Conv@0, ReLU@1, BN@2, Conv@3, ...
        sd[f"emg_net.conv_emg.{idx}.weight"] = torch.from_numpy(
            _conv_weight(np.asarray(convs[j]["kernel"], np.float32)).copy())
        sd[f"emg_net.conv_emg.{idx}.bias"] = _f32(convs[j]["bias"])
        put_bn(f"emg_net.conv_emg.{idx + 2}", j)
    idx = 0
    for i in range(n_linear):  # Linear, ReLU, BN (+ Dropout on the last 4)
        w = np.asarray(denses[i]["kernel"], np.float32)
        w = _first_dense_weight(w, F) if i == 0 else w.T
        sd[f"emg_net.linear.{idx}.weight"] = _f32(w)
        sd[f"emg_net.linear.{idx}.bias"] = _f32(denses[i]["bias"])
        put_bn(f"emg_net.linear.{idx + 2}", 2 + i)
        idx += 3 + (1 if i >= n_linear - 4 else 0)
    head = np.asarray(denses[-1]["kernel"], np.float32)
    sd["emg_net.last.0.weight"] = _f32(head.T)

    easy = _numbered(glove_p, "TorchDense", "Dense_0")[0]
    sd["glove_net.easy.0.weight"] = _f32(np.asarray(easy["kernel"]).T)
    sd["glove_net.easy.0.bias"] = _f32(easy["bias"])
    sd["glove_net.last.0.weight"] = torch.zeros((head.shape[1], 256))
    sd["logit_scale"] = torch.zeros(())
    return sd


def load_reference_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """Read a ``torch.save``-d reference state_dict onto the CPU."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(sd, Mapping) or "emg_net.last.0.weight" not in sd:
        raise ValueError(f"{path}: not a reference Model.state_dict()")
    return dict(sd)


def architecture(sd: Mapping[str, torch.Tensor]) -> dict:
    """The ``ContrastiveModel`` keyword arguments that a reference-layout
    state_dict's keys and shapes imply."""
    lin = [k for k in sd if re.match(r"emg_net\.linear\.\d+\.weight$", k)
           and sd[k].dim() == 2]
    return dict(
        d_e=sd["emg_net.last.0.weight"].shape[0],
        emg_dim=sd["emg_net.linear.0.weight"].shape[1]
        // sd["emg_net.conv_emg.0.weight"].shape[0],
        n_classes=sd["glove_net.easy.0.weight"].shape[1],
        adabn="emg_net.conv_emg.2.bn.weight" in sd,
        n_linear=len(lin),
        hidden=sd["emg_net.linear.0.weight"].shape[0],
        conv_features=sd["emg_net.conv_emg.0.weight"].shape[0],
    )


def model_from_state_dict(sd: Mapping[str, torch.Tensor]) -> ContrastiveModel:
    """A ``ContrastiveModel`` with the architecture the keys imply, loaded
    from ``sd`` with ``strict=True``."""
    model = ContrastiveModel(**architecture(sd))
    model.load_state_dict(sd, strict=True)
    return model
