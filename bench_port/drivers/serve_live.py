"""Live batched serving at the prosthesis's cadence, open loop.

Set-up, from the seed: a ring of raw 2 kHz blocks (ring_ticks, S, factor,
D) on the card, each session's channels scaled by an amplitude that
changes every ``gesture_ticks`` ticks; the ingest mean and std, and the
model's BatchNorm running statistics, from the plain reference's frames of
``norm_sessions`` sessions; the weights (``reference/weights.py``); S
fixed subset masks, session s holding ``subset_min + s % (subset_max -
subset_min + 1)`` classes drawn from the seed; the port's
``BatchedStreamingEngine`` (uncalibrated sessions) and ``warmup_ticks``
ticks past the vote window. The seed changes values only: S, every shape,
the ticks due and each session's subset size are the same for every seed.

The window: one ``engine.step`` of all S sessions due every 1/rate_hz
seconds for ``--seconds`` seconds, issued at its due time or, when the
previous tick ran over, at once; a tick is done when its predictions and
votes are in host memory. ``serve_tick_p95_ms`` is the 95th percentile of
done minus due over every tick of the window.

The check, after the window: ``check_sessions`` sessions drawn from the
seed, every tick of theirs from the first: each served prediction's
reference score against the best reference score of its subset
(``pred_gap_max``, the widest gap), and each served vote against the vote
of the served predictions (``vote_mismatches``).
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from bench_port import harness
from bench_port.reference import serve_ref as ref
from bench_port.reference.weights import make_weights, sub_seed
from bench_port.yardstick import counts, trace as tr
from bench_port.yardstick.peaks import PEAK_FLOPS

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TICK_SPAN = "bench_port.tick"
TRACED_SPAN = "bench_port.traced_ticks"


def wait_until(t: float) -> None:
    """Spin until ``t``: a sleeping thread can wake milliseconds late on a
    shared host, which would read as the card's latency."""
    while time.perf_counter() < t:
        pass


def subset_masks(S: int, n_classes: int, lo: int, hi: int, seed: int,
                 device) -> torch.Tensor:
    """(S, n_classes) bool: session s holds ``lo + s % (hi - lo + 1)``
    classes, which ones drawn from the seed."""
    gen = torch.Generator(device).manual_seed(sub_seed(seed, "subsets"))
    rank = torch.rand((S, n_classes), generator=gen,
                      device=device).argsort(1).argsort(1)
    sizes = lo + torch.arange(S, device=device) % (hi - lo + 1)
    return rank < sizes[:, None]


def raw_ring(ctx, S: int, sig: dict) -> torch.Tensor:
    """(ring_ticks, S, factor, D) raw f32 blocks drawn from the seed."""
    dev = ctx.device
    R, g = ctx.param("ring_ticks"), ctx.param("gesture_ticks")
    gen = torch.Generator(dev).manual_seed(sub_seed(ctx.seed, "raw"))
    D = ctx.cell.config["model"]["emg_dim"]
    ring = torch.randn((R, S, sig["factor"], D), generator=gen, device=dev)
    amp = torch.randn((-(-R // g), S, 1, D), generator=gen, device=dev)
    amp = torch.exp(ctx.param("amplitude_sigma") * amp) * ctx.param(
        "raw_scale")
    return ring.mul_(amp.repeat_interleave(g, 0)[:R])


def session_stream(ring: torch.Tensor, sessions, ticks: int) -> np.ndarray:
    """(n, ticks * factor, D) raw samples of ``sessions`` from tick 0."""
    part = ring[:, torch.as_tensor(sessions, device=ring.device)].cpu()
    part = part.numpy()[np.arange(ticks) % ring.shape[0]]
    n = part.shape[1]
    return part.transpose(1, 0, 2, 3).reshape(n, -1, part.shape[-1])


def port_engine(ctx, w: dict, mean, std, S: int):
    from contrastiveprosthetics_torch.config import Config
    from contrastiveprosthetics_torch.models.clip import ContrastiveModel
    from contrastiveprosthetics_torch.models.convert import architecture
    from contrastiveprosthetics_torch.serve.stream import (
        BatchedStreamingEngine,
    )

    pcfg = Config()
    sig = ctx.cell.config["signal"]
    stated = (sig["hz"], sig["factor"], sig["rms_window"],
              sig["vote_window"])
    ported = (pcfg.hz, pcfg.factor, pcfg.rms_window,
              pcfg.prediction_window_size)
    if stated != ported:
        raise SystemExit(f"the configuration's signal {stated} is not the "
                         f"port's {ported}")
    dev = ctx.device
    model = ContrastiveModel(**architecture(w), device=dev,
                             generator=torch.Generator(dev).manual_seed(0),
                             dtype=DTYPES[ctx.cell.config["dtype"]])
    model.load_state_dict(w, strict=True)
    return BatchedStreamingEngine(pcfg, model, mean.astype(np.float32),
                                  std.astype(np.float32), S)


def run(ctx):
    cfg = ctx.cell.config
    m, sig, dtype = cfg["model"], cfg["signal"], cfg["dtype"]
    dev = ctx.device
    cuda = dev.type == "cuda"
    S = ctx.param("sessions")
    R, warm = ctx.param("ring_ticks"), ctx.param("warmup_ticks")
    C, W, D = m["n_classes"], sig["vote_window"], m["emg_dim"]
    torch.set_num_threads(2)

    stages = harness.Stages(ctx.t_start)
    stages.mark("imports")
    ring = raw_ring(ctx, S, sig)
    ns = ctx.param("norm_sessions")
    fr = ref.frames(session_stream(ring, range(ns), R), sig, 0.0, 1.0)
    mean, std = fr.mean((0, 1)), fr.std((0, 1))
    w = make_weights(m, ctx.seed, dev, trained=True)
    x = torch.as_tensor((fr - mean) / std, device=dev).reshape(-1, D)
    w.update(ref.calibrated_statistics(w, x, m))
    stages.mark("traffic_and_weights")
    engine = port_engine(ctx, w, mean, std, S)
    stages.mark("engine")
    masks = subset_masks(S, C, ctx.param("subset_min"),
                         ctx.param("subset_max"), ctx.seed, dev)
    check = np.sort(np.random.default_rng(sub_seed(ctx.seed, "check")).choice(
        S, ctx.param("check_sessions"), replace=False))
    n = int(round(ctx.seconds * ctx.param("rate_hz")))
    period = 1.0 / ctx.param("rate_hz")
    n_trace = ctx.param("trace_ticks") if ctx.trace else 0
    hist_p = np.zeros((len(check), warm + n + n_trace), np.int64)
    hist_v = np.zeros_like(hist_p)
    preds_h = torch.empty(S, dtype=torch.int32, pin_memory=cuda)
    votes_h = torch.empty(S, dtype=torch.int32, pin_memory=cuda)
    p_np, v_np = preds_h.numpy(), votes_h.numpy()
    carries = [engine.init_carries()]
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    def tick(t: int) -> float:
        """Tick ``t`` of every session; returns when its predictions and
        votes are in host memory, with the seconds ``step`` took to
        return."""
        t0 = time.perf_counter()
        carries[0], p, v, _ = engine.step(carries[0], ring[t % R], masks)
        t1 = time.perf_counter()
        preds_h.copy_(p, non_blocking=True)
        votes_h.copy_(v, non_blocking=True)
        sync()
        hist_p[:, t] = p_np[check]
        hist_v[:, t] = v_np[check]
        return t1 - t0

    card_before = harness.card_state() if cuda else []
    gc.collect()
    gc.disable()
    # warm-up: past the vote window, its last ticks at the cadence
    paced = ctx.param("paced_warmup_ticks")
    t0 = time.perf_counter()
    for t in range(warm):
        wait_until(t0 + max(0, t - (warm - paced)) * period)
        tick(t)
    stages.mark("warmup")
    lat, late, host = np.empty(n), np.empty(n), np.empty(n)
    start = time.perf_counter() + period
    setup_s = start - ctx.t_start
    for k in range(n):
        due = start + k * period
        wait_until(due)
        late[k] = time.perf_counter() - due
        host[k] = tick(warm + k)
        lat[k] = time.perf_counter() - due
    window_s = time.perf_counter() - start
    card_after = harness.card_state() if cuda else []
    gc.enable()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    obs = {"model": m, "dtype": dtype, "sessions": S, "latency_s": lat,
           "host_enqueue_s": host, "trace": None, "trace_ticks": n_trace,
           "tick_flops": counts.serve_tick_flops(m, S),
           "peak_flops": PEAK_FLOPS[dtype],
           "encoder_bound_s": counts.encoder_chain_bound_s(m, S, S, dtype)[0]}
    busy_s = window_s_traced = breakdown = None
    if n_trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        with profile(activities=acts) as prof:
            with record_function(TRACED_SPAN):
                t_start = time.perf_counter()
                for k in range(n_trace):
                    wait_until(t_start + k * period)
                    with record_function(TICK_SPAN):
                        tick(warm + n + k)
        trace = tr.collect(prof)
        obs["trace"] = trace
        (lo, hi), = trace.spans(TRACED_SPAN)
        window_s_traced = hi - lo
        busy_s = tr.overlap(tr.busy(trace), lo, hi)
        breakdown = tr.breakdown(trace, lo, hi)

    # the check: free the port's state, then the reference on the sample
    raw = session_stream(ring, check, warm + n)
    mask_s = masks[torch.as_tensor(check, device=dev)].cpu()
    del engine, carries, ring, masks, x
    if cuda:
        torch.cuda.empty_cache()
    fr = ref.frames(raw, sig, mean, std)[:, warm:]
    x = torch.as_tensor(fr, device=dev).reshape(-1, D)
    scores = ref.encoder_scores(w, x, m).cpu().reshape(len(check), n, C)
    picks = torch.as_tensor(hist_p[:, warm:warm + n])
    every = mask_s[:, None, :].expand(-1, n, -1)
    gap = ref.gaps(scores, picks, every)
    votes = ref.majority_votes(hist_p[:, :warm + n], mask_s.numpy(), W)
    mismatches = int((votes[:, warm:] != hist_v[:, warm:warm + n]).sum())
    limits = ctx.cell.limits
    checks = [("pred_gap_max", float(gap.max()), limits["pred_gap_max"]),
              ("vote_mismatches", mismatches, limits["vote_mismatches"])]
    notes = {"card_before": card_before, "card_after": card_after,
             "generator_late_ms": {"p50": float(np.median(late) * 1e3),
                                   "max": float(late.max() * 1e3)},
             "ticks": n, "window_s": window_s,
             "latency_ms": {"p50": float(np.median(lat) * 1e3),
                            "p95": float(np.percentile(lat, 95) * 1e3),
                            "max": float(lat.max() * 1e3)},
             "setup_s": setup_s, "setup_stages": stages.seconds}
    for mode in ctx.overrides.get("controls", ()):
        low = ref.encoder_scores(w, x, m, mode).cpu().reshape(
            len(check), n, C)
        pick = ref.first_max_in_subset(low, every)
        notes.setdefault("controls", {})[mode] = float(
            ref.gaps(scores, pick, every).max())
    return harness.Outcome(
        e2e={"serve_tick_p95_ms": float(np.percentile(lat, 95) * 1e3),
             "setup_s": setup_s},
        obs=obs, checks=checks, attempted=n * S, failed=0,
        memory_peak_bytes=peak, busy_s=busy_s, window_s=window_s_traced,
        breakdown=breakdown, notes=notes)
