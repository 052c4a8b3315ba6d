"""PyTorch port: weight conversion, encoders and calibration against the
JAX package (``contrastiveprosthetics_torch.models``, ``serve.stream``).

Inputs are made with numpy from a seed and handed to both packages.
Small width is ``n_linear=2, hidden=64``. The helpers here are shared by
the other ``test_torch_port_*`` files.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrastiveprosthetics_torch.models.clip import ContrastiveModel as TorchModel
from contrastiveprosthetics_torch.models.convert import (
    from_flax_variables,
    load_reference_checkpoint,
    model_from_state_dict,
)
from contrastiveprosthetics_torch.serve.stream import recalibrate_batch_stats
from contrastiveprosthetics_tpu.models.clip import ContrastiveModel
from contrastiveprosthetics_tpu.serve.stream import (
    recalibrate_batch_stats as jax_recalibrate,
)
from contrastiveprosthetics_tpu.train.torch_export import export_state_dict

torch.set_num_threads(1)

N_CLASSES = 41


def jax_variables(n_linear=2, hidden=64, seed=11, adabn=False,
                  random_stats=True):
    """A flax model and its variables; with ``random_stats`` the BN running
    statistics are drawn from a numpy generator instead of (0, 1), so the
    folds and the eval-mode BatchNorm are exercised."""
    model = ContrastiveModel(d_e=16, adabn=adabn, n_classes=N_CLASSES,
                             n_linear=n_linear, hidden=hidden)
    key = jax.random.PRNGKey(seed)
    variables = model.init(
        {"params": key, "dropout": key},
        jnp.zeros((2, N_CLASSES, 12)), jnp.zeros((2, N_CLASSES, 20)),
        0.5, 0.5, True)
    variables = jax.tree_util.tree_map(np.asarray, variables)  # new dicts
    if random_stats and not adabn:
        rng = np.random.default_rng(seed)
        stats = variables["batch_stats"]["emg_net"]
        for name in stats:
            bn = stats[name]["BatchNorm_0"]
            w = bn["mean"].shape[0]
            bn["mean"] = rng.normal(0.0, 0.2, w).astype(np.float32)
            bn["var"] = rng.uniform(0.5, 2.0, w).astype(np.float32)
    return model, variables


def port_model(variables, adabn=False) -> TorchModel:
    sd = from_flax_variables(variables["params"],
                             variables.get("batch_stats"), adabn=adabn)
    return model_from_state_dict(sd).eval()


@pytest.mark.parametrize("adabn", [False, True])
def test_from_flax_variables_matches_export_state_dict(adabn):
    """(c) Same keys, values and dtypes as the JAX package's exporter."""
    _, v = jax_variables(adabn=adabn)
    want, _ = export_state_dict(v["params"], v["batch_stats"], adabn=adabn,
                                prediction=False)
    got = from_flax_variables(v["params"], v["batch_stats"], adabn=adabn)
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key].numpy().dtype == value.dtype, key
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)


def test_reference_checkpoint_roundtrip(tmp_path):
    """A ``torch.save``-d state_dict is the port's native checkpoint: it
    loads strictly into the architecture its keys imply."""
    _, v = jax_variables()
    sd = from_flax_variables(v["params"], v["batch_stats"])
    path = tmp_path / "contrastive.pt"
    torch.save(sd, path)
    model = model_from_state_dict(load_reference_checkpoint(str(path)))
    assert set(model.state_dict()) == set(sd)
    for key, value in model.state_dict().items():
        assert torch.equal(value, sd[key]), key
    assert len([m for m in model.emg_net.linear
                if isinstance(m, torch.nn.Linear)]) == 2


def test_fresh_model_has_reference_keys_and_seeded_init():
    """Torch-default init from an explicit generator: same seed, same
    weights; the key set is the JAX exporter's."""
    a = TorchModel(n_linear=2, hidden=64,
                   generator=torch.Generator().manual_seed(3))
    b = TorchModel(n_linear=2, hidden=64,
                   generator=torch.Generator().manual_seed(3))
    for key, value in a.state_dict().items():
        assert torch.equal(value, b.state_dict()[key]), key
    _, v = jax_variables()
    want, _ = export_state_dict(v["params"], v["batch_stats"], adabn=False,
                                prediction=False)
    assert set(a.state_dict()) == set(want)
    w = a.emg_net.linear[0].weight
    assert w.abs().max() <= 1 / np.sqrt(w.shape[1])


@pytest.mark.parametrize("n_linear,hidden", [(2, 64), (7, 512)])
def test_encode_emg_and_classes_match_flax(n_linear, hidden):
    """(d) Embeddings at rtol 1e-5, atol 1e-6, narrow and full width."""
    model, v = jax_variables(n_linear=n_linear, hidden=hidden)
    port = port_model(v)
    frames = np.random.default_rng(0).standard_normal((32, 12)).astype(
        np.float32)
    want = model.apply(v, jnp.asarray(frames), False,
                       method=ContrastiveModel.encode_emg)
    with torch.no_grad():
        got = port.encode_emg(torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    want = model.apply(v, None, False, method=ContrastiveModel.encode_classes)
    with torch.no_grad():
        got = port.encode_classes()
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


def test_recalibrate_batch_stats_matches_flax():
    """Online AdaBN: 40 flax-style updates with the biased batch variance
    give the JAX package's running statistics."""
    model, v = jax_variables()
    port = port_model(v)
    frames = (np.random.default_rng(1).standard_normal((150, 12)) * 2 + 1
              ).astype(np.float32)
    want = jax_recalibrate(model, v, jnp.asarray(frames))["emg_net"]
    got = recalibrate_batch_stats(port, torch.from_numpy(frames))
    for i, (mean, var) in enumerate(got):
        ref = want[f"BatchNorm_{i}"]["BatchNorm_0"]
        np.testing.assert_allclose(mean.numpy(), np.asarray(ref["mean"]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(var.numpy(), np.asarray(ref["var"]),
                                   rtol=1e-5, atol=1e-6)
    # the model's own statistics are untouched by the function
    bn0 = port.emg_net.norms()[0]
    np.testing.assert_array_equal(
        bn0.running_mean.numpy(),
        v["batch_stats"]["emg_net"]["BatchNorm_0"]["BatchNorm_0"]["mean"])
