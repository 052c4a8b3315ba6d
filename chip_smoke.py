#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port's streaming serve path.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the three CUDA kernels from ``contrastiveprosthetics_torch/csrc``
and drives the port at full model width (d_e=16, 64 conv features, 7 x 512
dense, 41 classes) with weights from a seeded ``torch.Generator`` and raw
recordings made with numpy from a seed:

1. set-up: kernel build (seconds printed), the card's name and power limit;
2. each kernel against its plain PyTorch version on the card, at the
   path's shapes (``encoder_chain`` at 1 and 25 x 32,768 rows,
   ``dsp_frames`` and ``vote_scan`` at 32,768 sessions x 25 ticks), timed
   with CUDA events beside its bound and, for the encoder, the plain
   ``torch.matmul`` chain;
3. single session: calibration (timed; its IIR runs on the host), 50
   per-tick ``step`` calls (p50/p99 tick latency) and a 200-tick ``steps``
   replay, which must agree, then a profiler trace of 20 ``step`` calls:
   device time per step by CUDA function against the wall time;
4. batched: 32,768 sessions (4 calibrated, with subset masks), one vote
   window of 25 ticks through ``BatchedStreamingEngine.steps``, held
   against the plain version;
5. the ``cptorch-serve`` CLI on cuda, per tick and batched replay.

Launch counts are reset just before phases 3 and 4 and read just after
each; every kernel must have launched in both. TF32 is off throughout
(``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` set False), so the plain versions run
in full f32. Any failure raises and the exit code is not 0. The last lines
are the card line from nvidia-smi, one ``{"kernels": [...]}`` JSON line, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet): f32 outside the tensor
# cores and HBM3 bandwidth; a card below its 700 W limit runs slower.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
REPLACES = {
    "dsp_frames": "contrastiveprosthetics_tpu/ops/pallas_ops.py:544 "
                  "(_tick_chain_kernel, DSP part) and :746 "
                  "(_batched_tick_chain_kernel, DSP part)",
    "encoder_chain": "contrastiveprosthetics_tpu/ops/pallas_ops.py:460 "
                     "(_enc_kernel via fused_encoder_logits :475; the chain "
                     "inside :544 and :746)",
    "vote_scan": "contrastiveprosthetics_tpu/ops/pallas_ops.py:544 "
                 "(_tick_chain_kernel, vote part) and :746 "
                 "(_batched_tick_chain_kernel, vote part)",
}
SOURCES = {name: f"contrastiveprosthetics_torch/csrc/{name}.cu"
           for name in REPLACES}
# the CUDA functions each port kernel launches, as named in a profiler trace
DEVICE_FUNCTIONS = {"dsp_frames_kernel": "dsp_frames",
                    "encoder_layer_kernel": "encoder_chain",
                    "encoder_head_kernel": "encoder_chain",
                    "vote_scan_kernel": "vote_scan"}
SESSIONS = 32768  # the session count the JAX README gives one chip
TICKS = 25        # one full vote window


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, flops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def matmul_chain(frames, folded, affines):
    """One plain PyTorch pass of the folded chain with in-place
    epilogues: the library yardstick for ``encoder_chain``."""
    *ws, gt = folded
    h = frames
    for j in range(0, len(ws) - 2, 2):
        h = torch.addmm(ws[j + 1], h, ws[j]).relu_()
        if affines is not None:
            S = affines[j].shape[0]
            h.view(-1, S, h.shape[1]).mul_(affines[j]).add_(affines[j + 1])
    e = torch.addmm(ws[-1], h, ws[-2])
    e = e / torch.linalg.vector_norm(e, dim=-1, keepdim=True)
    return e @ gt


def trace_steps(engine, blocks, mask, n: int) -> dict:
    """Profiler trace of ``n`` synchronised ``engine.step`` calls: device
    time per step, by CUDA function, against the wall time per step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    carry, *_ = engine.step(engine.init_carry(), blocks[0], mask)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            carry, *_ = engine.step(carry, blocks[i], mask)
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    device_ms: dict = {}
    launches: dict = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        name = next((v for k, v in DEVICE_FUNCTIONS.items() if k in e.name),
                    "other (PyTorch ops, copies)")
        device_ms[name] = device_ms.get(name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3 / n
        launches[name] = launches.get(name, 0) + 1
    busy = sum(device_ms.values())
    return dict(steps=n, wall_ms_per_step_traced=wall_ms,
                device_ms_per_step=busy if busy > 0 else None,
                device_ms_by_function=device_ms,
                device_launches_per_step={k: v / n for k, v in launches.items()},
                device_idle_share=1 - busy / wall_ms if busy > 0 else None)


def near_tie(scores: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Where the top two masked scores lie within ``eps``."""
    top2 = scores.topk(2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]) < eps


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from contrastiveprosthetics_torch.cli import serve as cli
    from contrastiveprosthetics_torch.config import DEFAULT_CONFIG as cfg
    from contrastiveprosthetics_torch.models.clip import ContrastiveModel
    from contrastiveprosthetics_torch.ops import _build
    from contrastiveprosthetics_torch.ops import kernels as K
    from contrastiveprosthetics_torch.serve.stream import (
        BatchedStreamingEngine,
        StreamingEngine,
    )

    dev = torch.device("cuda")
    S, T = SESSIONS, TICKS
    C, D, W, F = cfg.max_tasks, cfg.emg_dim, cfg.prediction_window_size, \
        cfg.factor
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    # ---------------------------------------------------------- 1. set-up
    t0 = time.perf_counter()
    build_s = _build.build()
    log(f"[setup] kernels built in {time.perf_counter() - t0:.2f} s "
        f"(per source: {json.dumps({k: round(v, 2) for k, v in build_s.items()})})")
    for name in _build.KERNELS:
        report = _build.library_path(name).with_suffix(".log")
        if report.exists():
            for line in report.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"[ptxas {name}] {line.strip()}")
    log(f"[setup] card: {card}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    rng = np.random.default_rng(0)
    model = ContrastiveModel(generator=torch.Generator().manual_seed(0)).to(dev)
    mean = rng.normal(0.0, 0.1, D).astype(np.float32)
    std = rng.uniform(0.8, 1.2, D).astype(np.float32)
    calib = [rng.standard_normal((2 * cfg.hz, D)).astype(np.float32)
             * (1 + 0.5 * i) + 0.2 * i for i in range(5)]
    recording = rng.standard_normal((2 * cfg.hz, D)).astype(np.float32)
    batch_blocks = rng.standard_normal((T, S, F, D), dtype=np.float32)
    subsets = [[0, 3, 7, 12], list(range(20)), [5, 9, 17, 33, 40],
               list(range(1, C, 2))]
    masks = np.ones((S, C), bool)
    for i, ids in enumerate(subsets):
        masks[i] = False
        masks[i, ids] = True

    single = StreamingEngine(cfg, model, mean, std)
    # calibration: the SOS recursion of preprocess_recording runs on the
    # host, the RMS, normalisation and BatchNorm passes on the card
    t0 = time.perf_counter()
    single.preprocess_recording(calib[4])
    torch.cuda.synchronize()
    preprocess_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    single.calibrate(calib[4])
    torch.cuda.synchronize()
    calibrate_ms = (time.perf_counter() - t0) * 1e3
    batched = BatchedStreamingEngine(cfg, model, mean, std, n_sessions=S)
    t0 = time.perf_counter()
    for i in range(4):
        batched.calibrate_session(i, calib[i])
    batched.session_affines()
    torch.cuda.synchronize()
    calibrate_session_ms = (time.perf_counter() - t0) * 1e3 / 4
    masks_t = torch.as_tensor(masks, device=dev)
    blocks_t = torch.as_tensor(batch_blocks, device=dev)
    log(f"[setup] engines ready: single session calibrated; {S} sessions, "
        "4 calibrated with subset masks")
    log(f"[setup] calibration on a {2 * cfg.hz}-sample recording: "
        f"preprocess_recording {preprocess_ms:.3f} ms (host IIR), calibrate "
        f"{calibrate_ms:.3f} ms, calibrate_session {calibrate_session_ms:.3f} "
        "ms (mean of 4, affines re-derived once)")

    # --------------------- 2. each kernel against its plain version
    entries = {}
    carries = batched.init_carries()
    sos, mu, sd = single._sos, single._mean, single._std
    dsp_args = (carries.iir_state, carries.tail, blocks_t, sos, mu, sd)
    frames, iir_k, tail_k = K.dsp_frames(*dsp_args)
    frames_p, iir_p, tail_p = K.dsp_frames_reference(*dsp_args)
    torch.cuda.synchronize()
    parts = dict(frames=max_abs(frames, frames_p),
                 iir_state=max_abs(iir_k, iir_p), tail=max_abs(tail_k, tail_p))
    err = max(parts.values())
    if err != 0:
        raise AssertionError(f"dsp_frames disagrees with its plain version: "
                             f"{parts}")
    n_sec, R = sos.shape[0], tail_k.shape[1]
    b, by = bound_ms(
        nbytes(blocks_t, frames) + 2 * nbytes(iir_k, tail_k),
        S * D * (T * (F * (1 + 9 * n_sec) + 2 * (R + 1) + 2)))
    entries["dsp_frames"] = dict(
        route="cuda", max_abs_err=err,
        tolerance="exact (same operation order as the plain version, "
                  "each step rounded)",
        ms=time_ms(lambda: K.dsp_frames(*dsp_args), reps=5),
        plain_ms=time_ms(lambda: K.dsp_frames_reference(*dsp_args), reps=1),
        bound_ms=b, bound_by=by, library_ms=None, max_abs_err_parts=parts,
        shape=f"K={T} S={S} factor={F} D={D}")
    log(f"[kernels] dsp_frames ok: max abs err {parts}")

    rows = frames.reshape(T * S, D)
    shared, affines = batched.shared_chain, batched.session_affines()
    scores = K.fused_encoder_logits(rows, shared, affines)
    scores_p = K.fused_encoder_logits_reference(rows, shared, affines)
    torch.cuda.synchronize()
    torch.testing.assert_close(scores, scores_p, rtol=2e-4, atol=2e-5)
    err = max_abs(scores, scores_p)
    macs = sum(w.numel() for w in shared[0:-1:2]) + shared[-1].numel()
    b, by = bound_ms(nbytes(rows, scores, *shared, *affines),
                     2.0 * macs * rows.shape[0])
    enc = dict(
        route="cuda", max_abs_err=err,
        tolerance="rtol 2e-4 atol 2e-5 (f32 sums in another order)",
        ms=time_ms(lambda: K.fused_encoder_logits(rows, shared, affines), 3),
        plain_ms=time_ms(
            lambda: K.fused_encoder_logits_reference(rows, shared, affines),
            2),
        bound_ms=b, bound_by=by,
        library_ms=time_ms(lambda: matmul_chain(rows, shared, affines), 2),
        shape=f"rows={T * S} (tick, session) with per-session affines",
        macs_per_row=macs)
    one = frames[0, :1].contiguous()
    folded = single.folded_chain
    s1 = K.fused_encoder_logits(one, folded)
    s1_p = K.fused_encoder_logits_reference(one, folded)
    torch.cuda.synchronize()
    torch.testing.assert_close(s1, s1_p, rtol=2e-4, atol=2e-5)
    b1, by1 = bound_ms(nbytes(one, s1, *folded), 2.0 * macs)
    enc["rows_1"] = dict(
        max_abs_err=max_abs(s1, s1_p),
        ms=time_ms(lambda: K.fused_encoder_logits(one, folded), 200, 5),
        plain_ms=time_ms(lambda: K.fused_encoder_logits_reference(one, folded),
                         200, 5),
        library_ms=time_ms(lambda: matmul_chain(one, folded, None), 200, 5),
        bound_ms=b1, bound_by=by1)
    entries["encoder_chain"] = enc
    log(f"[kernels] encoder_chain ok: max abs err {err:.3g} at {T * S} rows, "
        f"{enc['rows_1']['max_abs_err']:.3g} at 1 row")

    scores = scores.view(T, S, C)
    vote_args = (scores, masks_t, carries.votes, carries.n_seen)
    got = K.vote_scan(*vote_args)
    want = K.vote_scan_reference(*vote_args)
    torch.cuda.synchronize()
    err = max(max_abs(g, w) for g, w in zip(got, want))
    if err != 0:
        raise AssertionError(f"vote_scan disagrees with its plain version: {err}")
    b, by = bound_ms(
        nbytes(scores, masks_t, got[0], got[1]) + 2 * nbytes(
            carries.votes, carries.n_seen), T * S * (2 * C + 2 * W))
    entries["vote_scan"] = dict(
        route="cuda", max_abs_err=err, tolerance="exact (integers)",
        ms=time_ms(lambda: K.vote_scan(*vote_args), reps=5),
        plain_ms=time_ms(lambda: K.vote_scan_reference(*vote_args), reps=1),
        bound_ms=b, bound_by=by, library_ms=None,
        shape=f"K={T} S={S} C={C} W={W}")
    log("[kernels] vote_scan ok: exact")
    del frames_p, scores_p, want, got

    # ------------------------------------------------- 3. single session
    blocks = recording[: 200 * F].reshape(200, F, D)
    mask1 = np.zeros(C, bool)
    mask1[[2, 5, 11, 19, 23, 31, 40]] = True
    K.reset_launch_counts()
    carry = single.init_carry()
    lat, step_p, step_v = [], [], []
    for i in range(50):
        t0 = time.perf_counter()
        carry, p, v, _ = single.step(carry, blocks[i], mask1)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        step_p.append(int(p))
        step_v.append(int(v))
    _, preds, votes = single.steps(single.init_carry(), blocks, mask1)
    torch.cuda.synchronize()
    single_counts = dict(K.launch_counts)
    if (preds[:50].tolist() != step_p or votes[:50].tolist() != step_v):
        raise AssertionError("step loop and steps disagree")
    if not set(preds.tolist()) <= set(np.flatnonzero(mask1).tolist()):
        raise AssertionError("single-session preds outside the subset")
    lat = np.array(lat[1:])
    steps_ms = time_ms(lambda: single.steps(single.init_carry(), blocks,
                                            mask1), reps=5)
    trace = trace_steps(single, blocks, mask1, 20)
    single_res = dict(step_p50_ms=float(np.percentile(lat, 50)),
                      step_p99_ms=float(np.percentile(lat, 99)),
                      steps_200_ticks_ms=steps_ms, step_trace=trace,
                      preprocess_recording_ms=preprocess_ms,
                      calibrate_ms=calibrate_ms,
                      calibrate_session_ms=calibrate_session_ms)
    log(f"[single] step p50 {single_res['step_p50_ms']:.4f} ms, p99 "
        f"{single_res['step_p99_ms']:.4f} ms (49 ticks after the first); "
        f"steps over 200 ticks {steps_ms:.4f} ms; step loop == steps; "
        f"launches {single_counts}")
    log(f"[single] profiler trace of 20 steps: {json.dumps(trace)}")

    # ------------------------------------------------------- 4. batched
    K.reset_launch_counts()
    out_carry, b_preds, b_votes = batched.steps(batched.init_carries(),
                                                batch_blocks, masks)
    torch.cuda.synchronize()
    batched_counts = dict(K.launch_counts)
    for name in K.launch_counts:
        if not single_counts[name] or not batched_counts[name]:
            raise AssertionError(f"{name} never launched on the main path: "
                                 f"{single_counts} {batched_counts}")
    chain_args = (*batched.init_carries(), blocks_t, masks_t, sos, mu, sd,
                  shared, affines)
    _, k_preds, k_votes, k_scores = K.tick_chain(*chain_args)
    _, p_preds, p_votes, p_scores = K.tick_chain_reference(*chain_args)
    torch.cuda.synchronize()
    if not (torch.equal(k_preds, b_preds) and torch.equal(k_votes, b_votes)):
        raise AssertionError("engine steps and the kernel chain disagree")
    finite = torch.isfinite(p_scores) | ~masks_t
    if not bool(finite.all()):
        raise AssertionError("non-finite scores")
    torch.testing.assert_close(k_scores, p_scores, rtol=2e-4, atol=2e-5)
    diff = k_preds != p_preds
    ties = near_tie(k_scores) | near_tie(p_scores)
    if bool((diff & ~ties).any()):
        raise AssertionError("batched preds disagree away from near-ties")
    clean = ~diff.any(dim=0)  # sessions whose preds all agree
    if not torch.equal(k_votes[:, clean], p_votes[:, clean]):
        raise AssertionError("batched votes disagree")
    for i, ids in enumerate(subsets):
        if not set(b_preds[:, i].tolist()) <= set(ids):
            raise AssertionError(f"session {i} predicted outside its subset")
    if bool(((b_preds < 0) | (b_preds >= C)).any()):
        raise AssertionError("pred out of range")
    batched_ms = time_ms(lambda: batched.steps(batched.init_carries(),
                                               blocks_t, masks_t), reps=3)
    host_ms = time_ms(lambda: batched.steps(batched.init_carries(),
                                            batch_blocks, masks), reps=2)
    batched_res = dict(sessions=S, ticks=T, steps_ms=batched_ms,
                       ms_per_tick=batched_ms / T,
                       steps_ms_numpy_input=host_ms,
                       pred_near_tie_disagreements=int(diff.sum()))
    log(f"[batched] {S} sessions x {T} ticks: {batched_ms:.3f} ms per "
        f"steps call on device-resident blocks, {batched_ms / T:.4f} "
        f"ms/tick; {host_ms:.3f} ms with numpy blocks copied in; "
        f"{int(diff.sum())} near-tie pred differences vs plain; "
        f"launches {batched_counts}")
    del k_scores, p_scores, blocks_t

    # ----------------------------------------------------------- 5. CLI
    for argv in (["--demo", "--sessions", "1", "--quiet"],
                 ["--demo", "--sessions", "64", "--replay", "--quiet"]):
        if cli.main(argv) != 0:
            raise AssertionError(f"cptorch-serve {' '.join(argv)} failed")
    log("[cli] cptorch-serve --demo --sessions 1 and --sessions 64 "
        "--replay ok on cuda")

    for name, entry in entries.items():
        entry.update(name=name, source=SOURCES[name], replaces=REPLACES[name],
                     kernel_ms=entry["ms"],
                     launches=single_counts[name] + batched_counts[name],
                     launches_by_path={"single": single_counts[name],
                                       "batched": batched_counts[name]},
                     peaks={"f32_flops": PEAK_F32_FLOPS,
                            "bytes_per_s": PEAK_BYTES_PER_S})
    print(json.dumps({"single": single_res, "batched": batched_res}))
    print(card)
    print(json.dumps({"kernels": list(entries.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
