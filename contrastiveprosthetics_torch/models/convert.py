"""Weights in and out of the port.

The port's native checkpoint is the reference ``Model.state_dict()`` saved
with ``torch.save`` (a ``.pt``); ``ContrastiveModel`` has exactly its keys,
so such a file loads with ``strict=True``. That holds for the contrastive
model and the softmax baseline; the glove-angle class tower
(``--prediction --glove``, ``--glove_encoding``) has no reference layout
and goes under the port's own keys, ``glove_net.mlp`` (``glove_net.py``).

:func:`from_flax_variables` turns the JAX package's variable trees (nested
dicts of numpy arrays, as a msgpack restore gives them) into that layout:
the port's own copy of the transforms in the JAX package's
``train/torch_export.py:55-73,178-267``; :func:`to_flax_variables` the
other way, as its ``train/torch_import.py`` does.
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


def _put_bn(sd: dict, prefix: str, bn: Mapping, stats: Mapping | None,
            adabn: bool) -> None:
    """One flax BatchNorm at ``prefix`` (``.bn.`` inside under AdaBN)."""
    mid = f"{prefix}.bn." if adabn else f"{prefix}."
    sd[mid + "weight"] = _f32(bn["scale"])
    sd[mid + "bias"] = _f32(bn["bias"])
    if not adabn:
        sd[mid + "running_mean"] = _f32(stats["mean"])
        sd[mid + "running_var"] = _f32(stats["var"])
        sd[mid + "num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def _emg_entries(emg_p: Mapping, emg_s: Mapping, adabn: bool,
                 prediction: bool) -> tuple[dict, dict]:
    """The EMG tower's state_dict entries and its architecture."""
    convs = _numbered(emg_p, "TorchConv", "Conv_0")
    denses = _numbered(emg_p, "TorchDense", "Dense_0")
    bns = _numbered(emg_p, "BatchNorm", "BatchNorm_0")
    stats = [None] * len(bns) if adabn else _numbered(emg_s, "BatchNorm",
                                                       "BatchNorm_0")
    head = 2 if prediction else 1
    n_linear = len(denses) - head
    F = int(np.shape(convs[0]["kernel"])[3])
    if len(bns) != 2 + n_linear + head - 1 or len(stats) != len(bns):
        raise ValueError("not a contrastive or prediction EMGNet variable "
                         f"tree ({len(denses)} denses, {len(bns)} "
                         f"BatchNorms, {len(stats)} running statistics)")
    sd: dict[str, torch.Tensor] = {}
    for j, idx in enumerate((0, 3)):  # Conv@0, ReLU@1, BN@2, Conv@3, ...
        sd[f"emg_net.conv_emg.{idx}.weight"] = torch.from_numpy(
            _conv_weight(np.asarray(convs[j]["kernel"], np.float32)).copy())
        sd[f"emg_net.conv_emg.{idx}.bias"] = _f32(convs[j]["bias"])
        _put_bn(sd, f"emg_net.conv_emg.{idx + 2}", bns[j], stats[j], adabn)
    idx = 0
    for i in range(n_linear):  # Linear, ReLU, BN (+ Dropout on the last 4)
        w = np.asarray(denses[i]["kernel"], np.float32)
        w = _first_dense_weight(w, F) if i == 0 else w.T
        sd[f"emg_net.linear.{idx}.weight"] = _f32(w)
        sd[f"emg_net.linear.{idx}.bias"] = _f32(denses[i]["bias"])
        _put_bn(sd, f"emg_net.linear.{idx + 2}", bns[2 + i], stats[2 + i],
                adabn)
        idx += 3 + (1 if i >= n_linear - 4 else 0)
    head_w = np.asarray(denses[-1]["kernel"], np.float32)
    if prediction:  # Linear@0, ReLU@1, BN@2, Linear@3 (models.py:300-309)
        pre = denses[n_linear]
        sd["emg_net.last.0.weight"] = _f32(np.asarray(pre["kernel"]).T)
        sd["emg_net.last.0.bias"] = _f32(pre["bias"])
        _put_bn(sd, "emg_net.last.2", bns[-1], stats[-1], adabn)
        sd["emg_net.last.3.weight"] = _f32(head_w.T)
    else:
        sd["emg_net.last.0.weight"] = _f32(head_w.T)
    arch = dict(n_linear=n_linear, hidden=int(denses[0]["kernel"].shape[1]),
                conv_features=F,
                emg_dim=int(denses[0]["kernel"].shape[0]) // F)
    arch["n_classes" if prediction else "d_e"] = int(head_w.shape[1])
    return sd, arch


def _glove_mlp_entries(glove_p: Mapping, glove_s: Mapping,
                       adabn: bool) -> tuple[dict, int]:
    """The glove-angle MLP's entries (keys ``glove_net.mlp.{0,2,4}``) and
    its output width."""
    first, last = _numbered(glove_p, "TorchDense", "Dense_0")
    stats = None if adabn else _numbered(glove_s, "BatchNorm",
                                         "BatchNorm_0")[0]
    sd = {"glove_net.mlp.0.weight": _f32(np.asarray(first["kernel"]).T),
          "glove_net.mlp.0.bias": _f32(first["bias"]),
          "glove_net.mlp.4.weight": _f32(np.asarray(last["kernel"]).T)}
    _put_bn(sd, "glove_net.mlp.2",
            _numbered(glove_p, "BatchNorm", "BatchNorm_0")[0], stats, adabn)
    return sd, int(np.shape(last["kernel"])[1])


def from_flax_variables(params: Mapping[str, Any],
                        batch_stats: Mapping[str, Any] | None = None,
                        *, adabn: bool = False,
                        **widths) -> dict[str, torch.Tensor]:
    """JAX model variables -> the port's state_dict, in any mode.

    The mode follows from the trees, as the JAX trainer builds them
    (``engine.py:270-288``): a prediction state has no ``glove_net``
    subtree (or an empty one), a glove prediction state no ``emg_net``
    one, and a glove-encoding class tower holds a BatchNorm. A tower the
    tree lacks is the idle one, at the fixed values of
    ``ContrastiveModel.dead_modules`` and the ``ContrastiveModel``
    ``widths`` given (its defaults otherwise; a ``dtype`` there changes
    no entry: the state_dict is f32 in any compute dtype, which
    :func:`model_from_state_dict` takes). The dead entries of the one-hot
    layout are synthesized as the JAX exporter does:
    ``glove_net.last.0.weight`` as zeros, ``logit_scale`` as 0.0,
    ``num_batches_tracked`` as int64 0. :func:`to_flax_variables` is the
    inverse.
    """
    emg_p, glove_p = params.get("emg_net") or {}, params.get("glove_net") or {}
    stats = batch_stats or {}
    emg_s, glove_s = stats.get("emg_net") or {}, stats.get("glove_net") or {}
    glove_bns = _numbered(glove_p, "BatchNorm", "BatchNorm_0")
    prediction = not emg_p or not glove_p
    mode = dict(prediction=prediction, glove=not emg_p,
                glove_encoding=bool(glove_bns) and not prediction)
    sd: dict[str, torch.Tensor] = {}
    arch: dict = dict(widths, adabn=adabn, **mode)
    if emg_p:
        emg_sd, emg_arch = _emg_entries(emg_p, emg_s, adabn, prediction)
        sd.update(emg_sd)
        arch.update(emg_arch)
    if glove_bns:
        glove_sd, out = _glove_mlp_entries(glove_p, glove_s, adabn)
        sd.update(glove_sd)
        arch["n_classes" if prediction else "d_e"] = out
    elif glove_p:
        easy = _numbered(glove_p, "TorchDense", "Dense_0")[0]
        sd["glove_net.easy.0.weight"] = _f32(np.asarray(easy["kernel"]).T)
        sd["glove_net.easy.0.bias"] = _f32(easy["bias"])
        sd["glove_net.last.0.weight"] = torch.zeros(
            (np.shape(easy["kernel"])[1], 256))
        arch["n_classes"] = int(np.shape(easy["kernel"])[0])
    sd["logit_scale"] = torch.zeros(())
    init = ContrastiveModel(**arch).state_dict()
    extra = set(sd) - set(init)
    if extra:
        raise ValueError(f"variable tree entries outside the {mode} "
                         f"layout: {sorted(extra)}")
    return {**init, **sd}


def _flax_conv_kernel(weight: np.ndarray) -> np.ndarray:
    """torch (out, in, kh, kw) -> flax NHWC (kh, kw, in, out)."""
    return np.ascontiguousarray(np.transpose(weight, (2, 3, 1, 0)))


def _flax_first_dense_kernel(weight: np.ndarray,
                             conv_features: int) -> np.ndarray:
    """The inverse of :func:`_first_dense_weight`: channel-major torch
    (out, in) -> position-major flax (in, out)."""
    out_f, in_f = weight.shape
    positions = in_f // conv_features
    return np.ascontiguousarray(
        weight.reshape(out_f, conv_features, positions)
        .transpose(2, 1, 0).reshape(in_f, out_f))


def to_flax_variables(sd: Mapping[str, torch.Tensor]
                      ) -> tuple[dict, dict]:
    """The port's state_dict -> the JAX package's ``(params,
    batch_stats)`` trees (nested dicts of f32 numpy arrays under the flax
    module names), in the mode and widths :func:`architecture` reads from
    the keys: the inverse of :func:`from_flax_variables` on every entry
    the JAX trees hold. An idle tower is an empty ``params`` subtree with
    no ``batch_stats`` one, as the JAX trainer builds it. An AdaBN model
    has no running statistics, and the JAX one keeps statistics that no
    layer reads: they come out at flax's init (mean 0, variance 1)."""
    arch = architecture(sd)
    adabn = arch["adabn"]

    def a(key: str) -> np.ndarray:
        return sd[key].detach().cpu().float().numpy()

    def dense(key: str, bias: bool = True, kernel=None) -> dict:
        out = {"kernel": np.ascontiguousarray(
            a(key + ".weight").T if kernel is None else kernel)}
        if bias:
            out["bias"] = a(key + ".bias")
        return {"Dense_0": out}

    def bn(prefix: str) -> tuple[dict, dict]:
        mid = f"{prefix}.bn." if adabn else f"{prefix}."
        scale = a(mid + "weight")
        stats = ({"mean": np.zeros_like(scale), "var": np.ones_like(scale)}
                 if adabn else {"mean": a(mid + "running_mean"),
                                "var": a(mid + "running_var")})
        return ({"BatchNorm_0": {"scale": scale, "bias": a(mid + "bias")}},
                {"BatchNorm_0": stats})

    params: dict = {"emg_net": {}, "glove_net": {}}
    stats: dict = {}
    if not arch["glove"]:
        p, s = params["emg_net"], stats.setdefault("emg_net", {})
        norms = []
        for j, idx in enumerate((0, 3)):
            key = f"emg_net.conv_emg.{idx}"
            p[f"TorchConv_{j}"] = {"Conv_0": {
                "kernel": _flax_conv_kernel(a(key + ".weight")),
                "bias": a(key + ".bias")}}
            norms.append(f"emg_net.conv_emg.{idx + 2}")
        n, idx = arch["n_linear"], 0
        for i in range(n):
            key = f"emg_net.linear.{idx}"
            p[f"TorchDense_{i}"] = dense(key, kernel=_flax_first_dense_kernel(
                a(key + ".weight"), arch["conv_features"]) if i == 0 else None)
            norms.append(f"emg_net.linear.{idx + 2}")
            idx += 3 + (1 if i >= n - 4 else 0)
        if arch["prediction"]:
            p[f"TorchDense_{n}"] = dense("emg_net.last.0")
            norms.append("emg_net.last.2")
            p[f"TorchDense_{n + 1}"] = dense("emg_net.last.3", bias=False)
        else:
            p[f"TorchDense_{n}"] = dense("emg_net.last.0", bias=False)
        for k, prefix in enumerate(norms):
            p[f"BatchNorm_{k}"], s[f"BatchNorm_{k}"] = bn(prefix)
    if "glove_net.mlp.0.weight" in sd:
        p = params["glove_net"]
        p["TorchDense_0"] = dense("glove_net.mlp.0")
        p["BatchNorm_0"], glove_stats = bn("glove_net.mlp.2")
        p["TorchDense_1"] = dense("glove_net.mlp.4", bias=False)
        stats["glove_net"] = {"BatchNorm_0": glove_stats}
    elif not arch["prediction"]:
        params["glove_net"]["TorchDense_0"] = dense("glove_net.easy.0")
    return params, stats


def load_reference_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """Read a ``torch.save``-d reference state_dict onto the CPU."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(sd, Mapping) or "emg_net.last.0.weight" not in sd:
        raise ValueError(f"{path}: not a reference Model.state_dict()")
    return dict(sd)


def architecture(sd: Mapping[str, torch.Tensor]) -> dict:
    """The ``ContrastiveModel`` keyword arguments that a state_dict's keys
    and shapes imply, its mode included: the prediction head has
    ``emg_net.last.3``, the glove-angle MLP ``glove_net.mlp``. A width no
    key holds (n_classes in glove encoding, d_e in glove prediction) keeps
    the model's default."""
    lin = [k for k in sd if re.match(r"emg_net\.linear\.\d+\.weight$", k)
           and sd[k].dim() == 2]
    prediction = "emg_net.last.3.weight" in sd
    mlp = "glove_net.mlp.0.weight" in sd
    arch = dict(
        emg_dim=sd["emg_net.linear.0.weight"].shape[1]
        // sd["emg_net.conv_emg.0.weight"].shape[0],
        adabn="emg_net.conv_emg.2.bn.weight" in sd,
        n_linear=len(lin),
        hidden=sd["emg_net.linear.0.weight"].shape[0],
        conv_features=sd["emg_net.conv_emg.0.weight"].shape[0],
        prediction=prediction, glove=prediction and mlp,
        glove_encoding=mlp and not prediction)
    if prediction:
        arch["n_classes"] = sd["emg_net.last.3.weight"].shape[0]
    else:
        arch["d_e"] = sd["emg_net.last.0.weight"].shape[0]
    if "glove_net.easy.0.weight" in sd:
        arch["d_e"], arch["n_classes"] = sd["glove_net.easy.0.weight"].shape
    if mlp:
        arch["glove_dim"] = sd["glove_net.mlp.0.weight"].shape[1]
    return arch


def model_from_state_dict(sd: Mapping[str, torch.Tensor],
                          dtype: torch.dtype = torch.float32
                          ) -> ContrastiveModel:
    """A ``ContrastiveModel`` with the architecture the keys imply and the
    EMG tower's compute ``dtype`` (f32 or bf16: a state_dict carries f32
    parameters and no compute dtype), loaded from ``sd`` with
    ``strict=True``."""
    model = ContrastiveModel(**architecture(sd), dtype=dtype)
    model.load_state_dict(sd, strict=True)
    return model
