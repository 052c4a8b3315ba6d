"""PyTorch port: the spans of ``utils/spans.py`` at the serve tick's and
the train step's layer boundaries.

With no profiler a span is the shared no-op and records nothing; under a
CPU ``torch.profiler`` session a tick and a stacked step emit exactly
their named spans, nested as the modules say, and compute the same bits
as without it. The card's test (``-m cuda``) holds the step's three
children's event times against its busy time in the trace. No JAX here:
the card's run takes this file with ``--noconftest``.
"""
from __future__ import annotations

import ast
import inspect

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from contrastiveprosthetics_torch.config import DEFAULT_CONFIG as CFG
from contrastiveprosthetics_torch.data.store import DeviceStore
from contrastiveprosthetics_torch.models.clip import ContrastiveModel
from contrastiveprosthetics_torch.ops import kernels as K
from contrastiveprosthetics_torch.serve.stream import (
    BatchedStreamingEngine,
    StreamingEngine,
)
from contrastiveprosthetics_torch.train.engine import Hyper, Trainer
from contrastiveprosthetics_torch.utils import spans

SMALL = dict(n_linear=2, hidden=64)
SERVE = ("cptorch.serve.step", "cptorch.serve.prepare",
         "cptorch.serve.dsp_frames", "cptorch.serve.encoder_chain",
         "cptorch.serve.vote_scan")
TRAIN = ("cptorch.train.step", "cptorch.train.forward",
         "cptorch.train.backward", "cptorch.train.adam")


@pytest.fixture(autouse=True)
def _empty_store():
    spans.clear()
    yield
    spans.clear()


def cpu_trace():
    return profile(activities=[ProfilerActivity.CPU])


def intervals(prof, prefix: str) -> dict:
    """name -> [(start, end)] of the trace's host events named
    ``prefix...``, in start order."""
    out: dict = {}
    for ev in sorted(prof.events(), key=lambda e: e.time_range.start):
        if ev.name.startswith(prefix):
            out.setdefault(ev.name, []).append(
                (ev.time_range.start, ev.time_range.end))
    return out


def assert_partition(found: dict, parent: str, children) -> None:
    """Each child once, inside ``parent``, in order and not overlapping."""
    assert sorted(found) == sorted((parent, *children))
    assert all(len(v) == 1 for v in found.values()), found
    (lo, hi), = found[parent]
    edges = [found[c][0] for c in children]
    assert lo <= edges[0][0] and edges[-1][1] <= hi
    for (_, end), (start, _) in zip(edges, edges[1:]):
        assert end <= start


# ------------------------------------------------------------------ serve
def serve_engine(kind: str, device="cpu", widths=SMALL):
    gen = torch.Generator(device).manual_seed(5)
    model = ContrastiveModel(**widths, generator=gen, device=device)
    zeros, ones = np.zeros(12, np.float32), np.ones(12, np.float32)
    if kind == "single":
        eng = StreamingEngine(CFG, model, zeros, ones)
        return eng, eng.init_carry(), (CFG.factor, 12)
    eng = BatchedStreamingEngine(CFG, model, zeros, ones, 3)
    return eng, eng.init_carries(), (3, CFG.factor, 12)


def serve_ticks(eng, carry, shape, n: int, traced: bool):
    rng = np.random.default_rng(7)
    outs = []
    for t in range(n):
        block = torch.as_tensor(rng.standard_normal(shape, np.float32))
        if traced and t == n - 1:
            with cpu_trace() as prof:
                carry, *out = eng.step(carry, block)
        else:
            carry, *out = eng.step(carry, block)
        outs.append(out)
    return carry, outs, (prof if traced else None)


def test_span_off_is_the_shared_noop():
    assert spans.span("cptorch.x") is spans.OFF
    with spans.span("cptorch.x"):
        pass
    assert spans.names() == []
    assert spans.launches("cptorch.x") is None
    assert spans.device_ms("cptorch.x") is None
    eng, carry, shape = serve_engine("batched")
    serve_ticks(eng, carry, shape, 2, traced=False)
    assert spans.names() == []


@pytest.mark.parametrize("kind", ["single", "batched"])
def test_serve_step_spans(kind):
    """A tick emits the five serve spans once: prepare and the three
    phases inside the step, in order; the CPU runs the plain versions, so
    the step launched no kernel; the outputs are the same bits with the
    profiler on and off."""
    eng, carry, shape = serve_engine(kind)
    plain = serve_ticks(eng, carry, shape, 4, traced=False)
    eng, carry, shape = serve_engine(kind)
    carry_t, outs_t, prof = serve_ticks(eng, carry, shape, 4, traced=True)
    assert_partition(intervals(prof, "cptorch."), SERVE[0], SERVE[1:])
    assert spans.names() == sorted(SERVE)
    assert spans.launches("cptorch.serve.step", last=1) == 0
    assert spans.device_ms("cptorch.serve.step") is None  # no CUDA
    for a, b in zip([*plain[0], *sum(plain[1], [])],
                    [*carry_t, *sum(outs_t, [])]):
        assert torch.equal(a, b)


# ------------------------------------------------------------------ train
@pytest.fixture(scope="module")
def store():
    rng = np.random.default_rng(3)
    return DeviceStore(CFG, rng.standard_normal((41, 1, 6, 100, 12)), [40])


def stacked_step(trainer, traced: bool, C: int = 2, steps: int = 2):
    hyper = Hyper(*[np.full(C, v, np.float32)
                    for v in (1e-3, 1e-3, 0.4, 1e-3, 1e-3, 0.2)])
    dgen = trainer.generator(11)
    state, h = trainer.sweep_start(
        hyper, [trainer.generator(c) for c in range(C)], dgen)
    x = torch.randn((C, 8, 41, 12),
                    generator=torch.Generator().manual_seed(1))
    prof = None
    for i in range(steps):
        if traced and i == steps - 1:
            with cpu_trace() as prof:
                loss, acc = trainer._sgd_step(state, x, h, h.lr_emg,
                                              h.lr_glove, dgen)
        else:
            loss, acc = trainer._sgd_step(state, x, h, h.lr_emg, h.lr_glove,
                                          dgen)
    return state, (loss, acc), prof


@pytest.mark.parametrize("kw", [{}, dict(use_fused_train=True),
                                dict(remat=True)],
                         ids=["eager", "fused", "remat"])
def test_stacked_step_spans(store, kw):
    """A stacked step (C=2) emits the four train spans once: forward,
    backward and Adam inside the step, in order, not overlapping (remat's
    recompute inside the backward opens no second forward); the
    parameters, running statistics, both Adam chains and the loss are
    the same bits with the profiler on and off."""
    trainer = Trainer(CFG, store, adabn=False, batch_size=8, **SMALL, **kw)
    plain, out, _ = stacked_step(trainer, traced=False)
    traced, out_t, prof = stacked_step(trainer, traced=True)
    assert_partition(intervals(prof, "cptorch."), TRAIN[0], TRAIN[1:])
    assert spans.names() == sorted(TRAIN)
    assert spans.launches("cptorch.train.step", last=1) == 0
    for a, b in zip(out, out_t):
        assert torch.equal(a, b)
    sd, sd_t = plain.model.state_dict(), traced.model.state_dict()
    assert all(torch.equal(sd[k], sd_t[k]) for k in sd)
    for opt, opt_t in ((plain.opt_emg, traced.opt_emg),
                       (plain.opt_glove, traced.opt_glove)):
        assert opt.count == opt_t.count
        for a, b in zip(opt.mu + opt.nu, opt_t.mu + opt_t.nu):
            assert torch.equal(a, b)


def test_store_keeps_the_newest():
    with cpu_trace():
        for _ in range(spans.KEEP + 3):
            with spans.span("cptorch.x"):
                pass
    assert spans.launches("cptorch.x") == 0
    assert len(spans._newest("cptorch.x", None)) == spans.KEEP
    assert len(spans._newest("cptorch.x", 5)) == 5
    assert spans._newest("cptorch.x", 0) == []


def test_spans_import_nothing_of_the_port():
    """``utils/spans.py`` sits below the modules it marks: the kernels
    hand it their launch counter, it imports none of them."""
    tree = ast.parse(inspect.getsource(spans))
    imported = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names]
    imported += [n.module for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom)]
    assert not [m for m in imported if m.startswith("contrastiveprosthetics")]
    with cpu_trace():
        K.launch_counts["vote_scan"] += 2
        with spans.span("cptorch.x"):
            K.launch_counts["vote_scan"] += 3
    K.reset_launch_counts()
    assert spans.launches("cptorch.x") == 3


# ------------------------------------------------------------------- card
def busy_ms(prof) -> float:
    """The union of the trace's device intervals, in ms (the spans' own
    copies on the device's timeline left out)."""
    from torch.autograd import DeviceType

    hosts = {ev.name for ev in prof.events()
             if ev.device_type != DeviceType.CUDA}
    merged: list = []
    for s, e in sorted((ev.time_range.start, ev.time_range.end)
                       for ev in prof.events()
                       if ev.device_type == DeviceType.CUDA
                       and ev.name not in hosts):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged) / 1e3


@pytest.mark.cuda
def test_step_event_times_sum_to_busy_time():
    """At the sweep's C=150 and full width, device-bound, the forward,
    backward and Adam spans' event times of 10 stacked steps sum to the
    trace's busy time within 5 %, once the steps and the profiler are warm
    (as the benchmark traces after its window), and the Adam span counts
    one ``adam_stacked`` launch a tower; the tick's spans count its
    launches and record no events."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    cuda_store = DeviceStore(CFG, rng.standard_normal((41, 1, 6, 100, 12)),
                             [40], device=dev)
    trainer = Trainer(CFG, cuda_store, adabn=False, batch_size=8)
    C, n = 150, 10
    hyper = Hyper(*[np.full(C, v, np.float32)
                    for v in (1e-3, 1e-3, 0.4, 1e-3, 1e-3, 0.2)])
    dgen = trainer.generator(11)
    state, h = trainer.sweep_start(
        hyper, [trainer.generator(c) for c in range(C)], dgen)
    x = torch.randn((C, 8, 41, 12), device=dev)

    def steps(k):
        for _ in range(k):
            trainer._sgd_step(state, x, h, h.lr_emg, h.lr_glove, dgen)
        torch.cuda.synchronize()

    cuda = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    steps(10)
    with profile(activities=cuda):  # the profiler's first session
        steps(2)
    with profile(activities=cuda) as prof:
        steps(n)
    parts = sum(spans.device_ms(name, last=n) for name in TRAIN[1:]) * n
    busy = busy_ms(prof)
    assert abs(parts - busy) <= 0.05 * busy, (parts, busy)
    # the stacked Adam: one adam_stacked launch a tower (both are live)
    assert spans.launches("cptorch.train.adam", last=n) == 2

    eng, carry, shape = serve_engine("batched", dev, {})
    blocks = torch.randn(shape, device=dev)
    carry, *_ = eng.step(carry, blocks)
    K.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        eng.step(carry, blocks)
    torch.cuda.synchronize()
    counts = {k: v for k, v in K.launch_counts.items() if v}
    assert counts["dsp_frames"] == counts["vote_scan"] == 1, counts
    assert set(counts) == {"dsp_frames", "encoder_chain", "vote_scan"}
    assert spans.launches("cptorch.serve.step", last=1) == sum(
        counts.values())
    # the tick's spans are not timed: no events on the serve path
    assert all(spans.device_ms(name) is None for name in SERVE)
    assert spans.device_ms("cptorch.train.adam", last=1) > 0
