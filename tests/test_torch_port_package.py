"""PyTorch port: package boundaries, config copy and the serve CLI
(``contrastiveprosthetics_torch``)."""
from __future__ import annotations

import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import contrastiveprosthetics_torch
from contrastiveprosthetics_torch import config as port_config
from contrastiveprosthetics_torch.cli import serve as port_serve
from contrastiveprosthetics_torch.ops import _build
from contrastiveprosthetics_tpu import config as jax_config

torch.set_num_threads(1)

PKG = pathlib.Path(contrastiveprosthetics_torch.__file__).parent
REPO = PKG.parent


def test_port_imports_no_jax():
    """(a) Importing the port and every submodule loads no jax, flax or
    JAX-package module; no port source names the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import contrastiveprosthetics_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'contrastiveprosthetics_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
    sources = [p for p in PKG.rglob("*") if p.suffix in (".py", ".cu")]
    assert any(p.suffix == ".cu" for p in sources)
    for path in sources:
        assert "contrastiveprosthetics_tpu" not in path.read_text(), path


@pytest.mark.parametrize("compat", [False, True])
def test_config_copy_matches_jax_config(compat):
    """(b) Every field, derived property and split of the port's own
    config equals the JAX package's, default and compat."""
    ours, theirs = port_config.DEFAULT_CONFIG, jax_config.DEFAULT_CONFIG
    if compat:
        ours = port_config.compat_config(ours)
        theirs = jax_config.compat_config(theirs)
    fields = [f.name for f in dataclasses.fields(theirs)]
    assert [f.name for f in dataclasses.fields(ours)] == fields
    properties = [n for n, v in vars(type(theirs)).items()
                  if isinstance(v, property)]
    assert properties == [n for n, v in vars(type(ours)).items()
                          if isinstance(v, property)]
    for name in fields + properties + ["people_d2", "people_d3", "people",
                                       "tasks", "tasks_mask", "time_mask",
                                       "train_person_set"]:
        a, b = getattr(ours, name), getattr(theirs, name)
        if callable(b):
            a, b = a(), b()
        np.testing.assert_array_equal(a, b, err_msg=name)
        assert np.asarray(a).dtype == np.asarray(b).dtype, name
    for db2 in (False, True):
        np.testing.assert_array_equal(ours.people_mask(db2),
                                      theirs.people_mask(db2))
        for split in ("train", "val", "test"):
            np.testing.assert_array_equal(ours.rep_mask(split, db2),
                                          theirs.rep_mask(split, db2))
    for name in ("D2_IDXS", "D3_IDXS", "TASKS_A", "TASKS_B", "PEOPLE_D3_RAW",
                 "INGEST_PRESCALE"):
        assert getattr(port_config, name) == getattr(jax_config, name), name


def test_kernel_sources_are_hashed_per_file():
    """Each kernel builds into its own content-hashed library under the
    git-ignored build directory."""
    paths = {name: _build.library_path(name) for name in _build.KERNELS}
    assert len(set(paths.values())) == len(_build.KERNELS)
    for name, path in paths.items():
        assert (_build.SRC_DIR / f"{name}.cu").exists()
        assert path.parent == REPO / "build" / "kernels"
    assert "build/" in (REPO / ".gitignore").read_text().split()


@pytest.mark.parametrize("extra,shape", [
    ([], (1, 25)),
    (["--sessions", "3", "--replay", "--subset", "3,7,12"], (3, 25)),
])
def test_cli_demo_on_cpu_writes_npz(tmp_path, extra, shape):
    """(h) ``cptorch-serve --demo --platform cpu`` writes its npz."""
    out = tmp_path / "o.npz"
    rc = port_serve.main(["--demo", "--platform", "cpu", "--seconds", "0.25",
                          "--quiet", "--out", str(out), *extra])
    assert rc == 0
    with np.load(out) as z:
        assert z["preds"].shape == z["votes"].shape == shape
        if "--subset" in extra:
            assert set(np.unique(z["votes"])) <= {3, 7, 12}


def test_cli_default_platform_needs_a_gpu(monkeypatch):
    """(h) The default platform is cuda, and without a GPU it raises
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.delenv("CPTORCH_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_serve.main(["--demo", "--seconds", "0.1"])
    monkeypatch.setenv("CPTORCH_PLATFORM", "cpu")
    assert port_serve.main(["--demo", "--seconds", "0.1", "--quiet"]) == 0


@pytest.mark.parametrize("flag,match", [
    ("--spmd", r"queue 1 item 8\)"),
    ("--no_fused_encoder", "one encoder path")])
def test_cli_serve_jax_flags_exit_with_their_reason(monkeypatch, flag,
                                                    match):
    """The JAX serve CLI's flags that the port does not run exit, naming
    the ROADMAP item or the reason, before any CUDA work:
    ``--no_fused_encoder`` always, ``--spmd`` where the JAX CLI would
    shard (two CUDA devices visible, the sessions divisible by two; on
    one device it serves unsharded:
    ``test_cli_serve_spmd_serves_unsharded_on_one_device``)."""
    platform = "cpu"
    if flag == "--spmd":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        platform = "cuda"
    with pytest.raises(SystemExit, match=match):
        port_serve.main(["--demo", "--platform", platform, "--quiet",
                         "--sessions", "4", flag])


@pytest.mark.parametrize("extra,shape", [
    ([], (1, 20)), (["--sessions", "8", "--replay"], (8, 20))])
def test_cli_serve_spmd_serves_unsharded_on_one_device(tmp_path, capsys,
                                                       extra, shape):
    """``--spmd --demo`` on one device (the CPU) serves unsharded, says
    so, and gives the preds and votes of the same command without it."""
    outs = [tmp_path / "plain.npz", tmp_path / "spmd.npz"]
    for out, spmd in zip(outs, ([], ["--spmd"])):
        assert port_serve.main(["--demo", "--platform", "cpu", "--quiet",
                                "--seconds", "0.2", "--out", str(out),
                                *extra, *spmd]) == 0
    assert "--spmd: 1 cpu device visible, the sessions served unsharded" \
        in capsys.readouterr().out
    with np.load(outs[0]) as a, np.load(outs[1]) as b:
        assert a["preds"].shape == shape
        np.testing.assert_array_equal(a["preds"], b["preds"])
        np.testing.assert_array_equal(a["votes"], b["votes"])


@pytest.mark.parametrize("extra,shape", [
    ([], (1, 20)), (["--sessions", "2", "--replay"], (2, 20))])
def test_cli_serve_bf16_serves(tmp_path, extra, shape):
    """``--bf16`` serves per tick and batched in one replay, in bfloat16
    compute (the JAX package's ``test_cli.py:270-282``), with outputs
    inside the subset."""
    out = tmp_path / "bf16.npz"
    assert port_serve.main(["--demo", "--platform", "cpu", "--bf16",
                            "--seconds", "0.2", "--subset", "2,4",
                            "--quiet", "--out", str(out), *extra]) == 0
    with np.load(out) as z:
        assert z["preds"].shape == z["votes"].shape == shape
        assert set(np.unique(z["preds"])) <= {2, 4}
        assert set(np.unique(z["votes"])) <= {2, 4}


def test_cli_serve_fused_encoder_is_a_no_op(tmp_path):
    """``--fused_encoder`` parses and serves the same ticks: every tick
    already runs the encoder chain (its plain version on the CPU)."""
    outs = []
    for extra in ([], ["--fused_encoder"]):
        out = tmp_path / f"o{len(extra)}.npz"
        assert port_serve.main(["--demo", "--platform", "cpu", "--seconds",
                                "0.25", "--quiet", "--replay", "--out",
                                str(out), *extra]) == 0
        with np.load(out) as z:
            outs.append((z["preds"], z["votes"]))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_port_has_the_ingest_modules():
    """The ingest slice's modules and entry point exist (the import check
    above walks them) and the kernel table builds ``iir_rms``."""
    for name in ("ops/stats.py", "ops/signal.py", "data/ingest.py",
                 "data/synthetic.py", "cli/load.py", "csrc/iir_rms.cu"):
        assert (PKG / name).exists(), name
    assert "iir_rms" in _build.KERNELS
    text = (REPO / "pyproject.toml").read_text()
    assert ('cptorch-load = "contrastiveprosthetics_torch.cli.load:main"'
            in text)
    code = ("import sys\n"
            "import contrastiveprosthetics_torch.cli.load\n"
            "import contrastiveprosthetics_torch.data.ingest\n"
            "import contrastiveprosthetics_torch.ops.stats\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in\n"
            "       ('jax', 'jaxlib', 'flax', 'contrastiveprosthetics_tpu',\n"
            "        'matplotlib')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
