"""PyTorch port: the twins of ``scripts/go.sh`` and ``scripts/results.sh``
(``scripts/go_torch.sh``, ``scripts/results_torch.sh``) and the whole-run
parity of the port against the JAX package
(``scripts/port_synth_parity.py``).

The twins run the port's CLI modules with exactly the flags of their JAX
scripts, ``"$@"`` last. On the CPU the go twin trains from the repo's
cached 150-config crossval (copied into a temporary data directory) and
the results twin, over its checkpoint, prints the same test loss and
accuracy, bit for bit.
"""
from __future__ import annotations

import json
import os
import pathlib
import re
import shlex
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
SCRIPTS = REPO / "scripts"
TWINS = {"go.sh": "go_torch.sh", "results.sh": "results_torch.sh"}


def command(script: pathlib.Path) -> tuple[str, list[str]]:
    """The ``python -m MODULE FLAGS...`` line of a twin-style script (its
    continuation lines joined): the module and the arguments."""
    text = script.read_text().replace("\\\n", " ")
    line = next(ln for ln in text.splitlines()
                if ln.strip().startswith("python -m "))
    words = shlex.split(line)
    return words[2], words[3:]


@pytest.mark.parametrize("jax_script", list(TWINS))
def test_twins_pass_the_jax_scripts_flags(jax_script):
    """Each twin runs the port's counterpart of its JAX script's module,
    with the same flags in the same order and ``"$@"`` last, from the
    repo root, stopping at the first failure."""
    jax_module, jax_flags = command(SCRIPTS / jax_script)
    twin = SCRIPTS / TWINS[jax_script]
    module, flags = command(twin)
    assert jax_module.startswith("contrastiveprosthetics_tpu.cli.")
    assert module == jax_module.replace("contrastiveprosthetics_tpu",
                                        "contrastiveprosthetics_torch")
    assert flags == jax_flags and flags[-1] == "$@"
    text = twin.read_text()
    assert 'cd "$(dirname "$0")/.."' in text and "set -e" in text
    assert os.access(twin, os.X_OK)


def run_twin(script: str, args: list[str], tmp_path) -> str:
    """``bash scripts/<script> ARGS`` with ``python`` resolving to this
    interpreter; returns its standard output."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir(exist_ok=True)
    shim = bin_dir / "python"
    shim.write_text(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
    shim.chmod(0o755)
    env = {**os.environ, "PATH": f"{bin_dir}{os.pathsep}{os.environ['PATH']}",
           "OMP_NUM_THREADS": "4"}
    r = subprocess.run(["bash", str(SCRIPTS / script), *args],
                       capture_output=True, text=True, timeout=600, env=env,
                       cwd=str(tmp_path))
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    return r.stdout


def test_go_twin_then_results_twin_print_the_same_test_numbers(tmp_path):
    """``go_torch.sh --synthetic --final_epochs 1`` on the CPU loads the
    cached crossval (the repo's ``data/cross_val_*.npy``, copied) as
    ``go.sh`` does, trains and tests; ``results_torch.sh`` over its
    checkpoint prints the same test loss and accuracy and the same
    artifacts."""
    data = tmp_path / "data"
    data.mkdir()
    for name in ("cross_val_keys.npy", "cross_val_values.npy"):
        shutil.copy(REPO / "data" / name, data / name)
    common = ["--synthetic", "--batch_size", "150", "--platform", "cpu",
              "--data_dir", str(data), "--checkpoint_dir",
              str(tmp_path / "ckpt")]
    go = run_twin("go_torch.sh", [*common, "--final_epochs", "1",
                                  "--results_dir", str(tmp_path / "A")],
                  tmp_path)
    assert "no cached crossval found" not in go
    assert "Best combination:" in go and "Epoch 0." in go
    results = run_twin("results_torch.sh",
                       [*common, "--results_dir", str(tmp_path / "B")],
                       tmp_path)
    numbers = [re.search(r"loss,\t+correct\n(\(.*\))", out).group(1)
               for out in (go, results)]
    assert numbers[0] == numbers[1]
    loss, acc = (float(x) for x in numbers[0].strip("()").split(","))
    assert acc > 0.5 and loss == loss
    for stem in ("logs", "y_pred", "y_true", "voting"):
        np.testing.assert_array_equal(np.load(tmp_path / "A" / f"{stem}.npy"),
                                      np.load(tmp_path / "B" / f"{stem}.npy"),
                                      err_msg=stem)


@pytest.mark.slow
def test_port_synth_parity_reports_ok(tmp_path):
    """Whole-run parity, port against JAX, at ``test_synth_parity.py``'s
    reduced geometry (2 people, 10 single-batch epochs), 2 seeds a
    package, under ``synth_parity.py``'s unchanged seed-spread criterion.
    Both packages must train far above chance (1/41): the voted accuracy
    of either lies at 0.3-0.56 a seed there."""
    out = tmp_path / "port_synth_parity.json"
    r = subprocess.run(
        [sys.executable, str(SCRIPTS / "port_synth_parity.py"),
         "--people", "2", "--epochs", "10", "--seeds", "2",
         "--out", str(out)],
        capture_output=True, text=True, timeout=1800, cwd=str(REPO),
        env={**os.environ, "JAX_PLATFORMS": "cpu",
             "JAX_COMPILATION_CACHE_DIR": str(REPO / ".jax_cache_cpu")})
    assert r.returncode == 0, (r.stdout[-800:], r.stderr[-800:])
    line = json.loads(r.stdout.strip().splitlines()[-1])
    summary = json.loads(out.read_text())
    assert line["ok"] is summary["ok"] is True
    for metric in ("acc", "curve", "grasp"):
        assert summary[f"{metric}_gap"] <= summary[f"{metric}_tol"]
    assert summary["jax"]["acc_mean"] > 0.25
    assert summary["port"]["acc_mean"] > 0.25
