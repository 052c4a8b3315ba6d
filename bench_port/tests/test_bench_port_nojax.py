"""The check that no module of JAX or of the JAX package was loaded
compares whole top-level names, and the harness, its drivers and the
port's modules they import load none."""
import subprocess
import sys
import types

from bench_port import harness


def test_top_level_names_compared_whole(monkeypatch):
    assert harness.jax_modules() == []
    for name in ("jaxtyping", "flaxen", "optax_like",
                 "contrastiveprosthetics_tpu_extra"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.jax_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "contrastiveprosthetics_tpu.serve",
                        types.ModuleType("y"))
    assert harness.jax_modules() == ["contrastiveprosthetics_tpu", "jax"]


def test_harness_and_port_load_no_jax():
    code = (
        "import bench_port.run, bench_port.controls, bench_port.faults\n"
        "import bench_port.drivers.serve_live, bench_port.drivers.sweep\n"
        "import contrastiveprosthetics_torch.serve.stream\n"
        "import contrastiveprosthetics_torch.train.engine\n"
        "import contrastiveprosthetics_torch.data.store\n"
        "import contrastiveprosthetics_torch.models.convert\n"
        "from bench_port import harness\n"
        "print(harness.jax_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"
