#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port: the streaming serve path,
contrastive training, training on the fused chain, the crossval sweep,
and the evaluation and results path.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the five CUDA kernel sources from
``contrastiveprosthetics_torch/csrc`` and drives the port at full model
width (d_e=16, 64 conv features, 7 x 512 dense, 41 classes) with weights
from a seeded ``torch.Generator`` and raw recordings and synthetic data
made with numpy from a seed:

1. set-up: kernel build (seconds printed), the card's name and power limit;
2. each kernel against its plain PyTorch version on the card, at the
   path's shapes (``dsp_frames`` and ``vote_scan`` bit for bit at every
   serve path's shape: the per-tick ``step``, K=1 and S=1; the 200-tick
   ``steps``; the batched 32,768 sessions x 25 ticks; a ragged S=37 with
   n_seen mid-warm-up; ``vote_scan`` with its masked-score output on and
   off; each path timed, wrapper and plain version by CUDA events, device
   time per launch by profiler, beside its bound and each kernel's ptxas
   stack frame; ``encoder_chain`` at 1, 16, 200, its regime threshold -+ 1,
   32,768 and 25 x 32,768 rows, with and without per-session affines,
   every call's first rows bit-identical to the smaller call's and to a
   rerun, and both f32 paths against float64), timed with CUDA events
   beside its bound and, for the encoder, the ``torch.addmm`` chain at 1,
   32,768 and 819,200 rows, and both of its tilings from 16 to 1,024 rows;
3. single session: calibration (timed; its IIR runs on the host), 50
   per-tick ``step`` calls (p50/p99 tick latency) and a 200-tick ``steps``
   replay, which must agree, then profiler traces of 20 ``step`` calls
   and of one ``steps`` call: device time by CUDA function against the
   wall time;
4. batched: 32,768 sessions (4 calibrated, with subset masks), one vote
   window of 25 ticks through ``BatchedStreamingEngine.steps``, held
   against the plain version, timed, and traced (device time by kernel,
   idle share); one live ``BatchedStreamingEngine.step`` of all sessions
   timed;
5. the ``cptorch-serve`` CLI on cuda, per tick and batched replay;
6. the K1 pair (``contrastive_loss_fwd``/``_bwd``) against its plain
   version at T=41, d=16 for one config of the train step's N=8, a ragged
   N=3 and N=1, and for the crossval sweep's 150 configs of N=8; a second
   run must give the same bits, and each config the same bits alone as
   inside the 150; both shapes timed (CUDA events per call, profiler
   device time per launch, an empty kernel launched the same way as the
   floor);
7. training at the canonical geometry: the synthetic store of all 46
   people (DB3 view, D=1,800, bs 8: 225 steps per epoch); one ``_sgd_step``
   with the kernels held against one with the plain loss; ``train_loop``
   for 2 annealed epochs and ``run_test``, both accuracies above 0.5; one
   epoch timed with CUDA events; a profiler trace of 20 steps by kernel
   family; ``cptorch-train --synthetic`` on cuda, its checkpoint loaded
   back strictly;
8. the fused training chain: K5f, K5b (``dense_block_fwd``/``_bwd``, 3xTF32
   on the tensor cores), the chain's tail pair (``chain_tail_fwd``/``_bwd``,
   the top block's affine and dropout with the mask drawn in registers)
   and K5m (``dropout_masks``, the replay, at F=512 and ragged widths)
   against their plain versions at N=328 and a ragged 123 rows, 768 and
   512 inputs, with reruns that must give the same bits, the drawn masks
   against the replayed ones, and the kernels' Philox against cuRAND's
   (the tail: h and dz bit for bit, its sums within one f32 ulp); K5f and
   K5b and their plain versions against float64 on an inner block; device
   time per launch from a profiler trace of 50 bare calls, for both
   tilings of each kernel in the chain's three block forms, beside the
   cuBLAS GEMMs of the same shapes, and of the tail pair beside the tail
   the chain ran before it (``dropout_masks`` and PyTorch's elementwise
   ops) in turns; one ``Trainer(use_fused_train=True)`` step at dropout 0
   against the eager one; ``train_loop`` on the fused chain for 2
   annealed epochs (test accuracy above 0.5, 7 K5f, 7 K5b, one of each
   tail kernel and no ``dropout_masks`` launch per step); eager and fused
   epochs timed in turns with CUDA events; a profiler trace of 20 fused
   steps (launches, the tail's device time, device time and idle share
   per step); ``cptorch-train --fused_train on``;
9. the crossval sweep on phase 7's store (bs 8, plain BatchNorm, full
   width): one stacked step of 3 configs at dropout 0 with the K1 kernels
   against the same step with the plain loss, in float64 against 3
   single-config eager steps in float64 from the unstacked weights, in
   f32 against the f32 single steps' losses, then 5 steps in a row both
   ways, in f32 and in float64;
   ``cross_validate`` of ``scripts/go.sh``'s 150 configs for 1 epoch,
   timed by CUDA events and the host clock (configs/s, windows/s), best
   val accuracy above 0.1, its ``.npy`` files read back; profiler traces
   of 10 stacked steps (the last a tail step) at C=2 and C=150: device
   time by family, idle share, launches per stacked step, which must not
   differ between the two by a launch per step, and one K1f and one K1b
   per stacked step; the
   chunk-width scan (20 stacked steps at 1, 2, 10, 50 and 150 configs);
   ``cptorch-train --crossval_size 3``;
10. evaluation and results on phase 7's trained state (plain BatchNorm,
   bs 8; the DB3 test split's 48 items are one batch of 49,200 encoder
   rows, the val split's 24 three batches of 8,200): the test pass from
   one index draw without and with ``use_fused_encoder`` (logits within
   rtol 2e-4, atol 2e-5, y_true equal, curve and y_pred equal away from
   near-tie items, ``encoder_chain`` launched 10 times a batch in the
   fused pass and never in the other), each timed by CUDA events and
   traced; the fused val pass; ``encoder_chain`` at both batches' rows and
   at a full 64-item test batch (65,600 rows) against its plain version
   and the ``addmm`` chain; ``subset_size_sweep`` on the test logits and
   on 922,500 seeded score rows, timed with peak memory, each bit-equal to
   its run on a CPU copy; ``export_results`` and ``export_per_subject``
   (every artifact with its shape, every sheet read back as its
   ``.npy``); ``evaluate_per_subject`` (finite per-subject accuracies
   whose mean is the pooled one); ``cptorch-train --crossval_load
   --fused_encoder --per_subject_eval --results_dir A`` on phase 9's sweep
   files, ``cptorch-results`` from its checkpoint with the fused encoder
   into B (``logs.npy`` as A's) and without it into C, and
   ``cptorch-parity C --ref A``.

Launch counts are reset just before phases 3, 4, 7's and 8's
``train_loop``, 9's ``cross_validate`` and 10's test and val passes and
read just after each (phase
3's after its ``step`` loop and after its ``steps`` call); every serve
kernel must have launched on each of the three serve paths, each K1
kernel once per train step in 7 and 8 and once per stacked step in 9,
and the chain's kernels as its depth says in 8. TF32
is off throughout
(``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` set False), so the plain versions run
in full f32 (``encoder_chain``, K5f and K5b run 3xTF32 by their own
instructions, whatever the flags). Any failure raises and the exit code
is not 0. The last lines are ``{"single", "batched"}``, ``{"train"}``,
``{"fused_train"}``, ``{"sweep"}`` and ``{"eval"}`` JSON lines, the card
line from nvidia-smi, one
``{"kernels": [...]}`` JSON line, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet): f32 outside the tensor
# cores, dense TF32 on the tensor cores and HBM3 bandwidth; a card below
# its 700 W limit runs slower.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
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
    "contrastive_loss_fwd": "contrastiveprosthetics_tpu/ops/pallas_ops.py:185 "
                            "(_pallas_loss_call; body _loss_kernel :145)",
    "contrastive_loss_bwd": "contrastiveprosthetics_tpu/ops/pallas_ops.py:213 "
                            "(_pallas_bwd_call; body _bwd_kernel :169)",
    "dense_block_fwd": "contrastiveprosthetics_tpu/ops/train_fused.py:362 "
                       "(_fwd_block_call; body _fwd_block_kernel :183)",
    "dense_block_bwd": "contrastiveprosthetics_tpu/ops/train_fused.py:412 "
                       "(_bwd_block_call; body _bwd_block_kernel :239)",
    "chain_tail_fwd": "contrastiveprosthetics_tpu/ops/train_fused.py:777 "
                      "(K5m, extract_prng_masks: the last block's mask) and "
                      ":760-762 (the XLA tail: _chain_fwd :593-600)",
    "chain_tail_bwd": "contrastiveprosthetics_tpu/ops/train_fused.py:777 "
                      "(K5m, the last block's mask redrawn) and :760-762 "
                      "(the XLA tail: _chain_bwd :624-633)",
    "dropout_masks": "contrastiveprosthetics_tpu/ops/train_fused.py:777 "
                     "(extract_prng_masks; body _mask_kernel :771, "
                     "_draw_mask :146)",
}
SERVE_KERNELS = ("dsp_frames", "encoder_chain", "vote_scan")
TRAIN_KERNELS = ("contrastive_loss_fwd", "contrastive_loss_bwd")
FUSED_KERNELS = ("dense_block_fwd", "dense_block_bwd", "chain_tail_fwd",
                 "chain_tail_bwd", "dropout_masks")
TAIL_KERNELS = ("chain_tail_fwd", "chain_tail_bwd")
SOURCES = {name: "contrastiveprosthetics_torch/csrc/" + (
    "contrastive_loss" if name in TRAIN_KERNELS else
    "train_fused" if name in FUSED_KERNELS else name) + ".cu"
    for name in REPLACES}
# the CUDA functions each port kernel launches, as named in a profiler trace
DEVICE_FUNCTIONS = {"dsp_frames_kernel": "dsp_frames",
                    "encoder_layer_large_kernel": "encoder_chain",
                    "encoder_layer_small_kernel": "encoder_chain",
                    "encoder_head_kernel": "encoder_chain",
                    "vote_scan_kernel": "vote_scan",
                    "contrastive_loss_fwd_kernel": "contrastive_loss_fwd",
                    "contrastive_loss_bwd_kernel": "contrastive_loss_bwd",
                    "dense_block_fwd_kernel": "dense_block_fwd",
                    "dense_block_bwd_kernel": "dense_block_bwd",
                    "chain_tail_fwd_kernel": "chain_tail_fwd",
                    "chain_tail_bwd_kernel": "chain_tail_bwd",
                    "dropout_masks_kernel": "dropout_masks"}
# kernel families of a train step, by (lower-case) name fragment, in the
# order they are tried
TRAIN_FAMILIES = (
    ("dense_block_fwd", ("dense_block_fwd",)),
    ("dense_block_bwd", ("dense_block_bwd",)),
    ("chain_tail_fwd", ("chain_tail_fwd",)),
    ("chain_tail_bwd", ("chain_tail_bwd",)),
    ("dropout_masks", ("dropout_masks",)),
    ("contrastive_loss_fwd", ("contrastive_loss_fwd",)),
    ("contrastive_loss_bwd", ("contrastive_loss_bwd",)),
    ("convolutions (cuDNN)", ("conv", "cudnn", "fprop", "dgrad", "wgrad",
                              "winograd", "implicit")),
    ("GEMMs (cuBLAS)", ("gemm", "gemv", "cutlass", "xmma", "sm90_")),
    ("Adam (foreach)", ("multi_tensor", "foreach")),
    ("dropout random numbers", ("distribution", "philox", "rand")),
    ("BatchNorm statistics and reductions", ("welford", "reduce",
                                             "batch_norm")),
    ("copies and fills", ("memcpy", "memset", "copy", "fill")),
)
# the host calls that put work on the card: kernels, copies and fills
LAUNCH_CALLS = frozenset((
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel",
    "cuLaunchKernel", "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemcpy",
    "cudaMemcpy2DAsync", "cudaMemsetAsync", "cudaMemset"))
SESSIONS = 32768  # the session count the JAX README gives one chip
TICKS = 25        # one full vote window
TRAIN_EPOCHS = 2
CANONICAL = (1e-3, 1e-6, 0.5, 1e-3, 1e-6, 0.3)  # cli/train.py:189-190
SWEEP_CONFIGS = 150  # scripts/go.sh's --crossval_size
SWEEP_EPOCHS = 1     # cptorch-train's --crossval_epochs default
SCAN_WIDTHS = (1, 2, 10, 50, 150)
SCAN_STEPS = 20
SWEEP_TRACE_STEPS = 10
SWEEP_TRACE_REPEATS = 3
SWEEP_CHECK_STEPS = 5
# the step check's 3 configs at dropout 0, each its own lr and reg
SWEEP_STEP_HYPERS = ((1e-3, 1e-6, 0.0, 1e-3, 1e-6, 0.0),
                     (3e-4, 1e-3, 0.0, 3e-3, 1e-2, 0.0),
                     (3e-3, 1e-2, 0.0, 1e-4, 1e-4, 0.0))
# 5 f32 steps in a row, stacked against single: the two round in other
# orders, which flips a few ReLUs whose pre-activations lie within rounding
# of 0, and Adam carries that on; held as two f32 orders of training steps
# are held elsewhere (test_one_epoch_matches_jax_step_by_step)
SWEEP_STEPS_RTOL = 1e-3
# the float64 stacked step against the float64 single steps: the same
# arithmetic in another order, where no ReLU decision is that close
SWEEP_F64_RTOL = 1e-9


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


def device_per_call(fn, n: int = 50) -> tuple[float, float]:
    """Device milliseconds and CUDA kernel launches per call of ``fn`` from
    a profiler trace of ``n`` bare calls (the sum of the CUDA kernels'
    intervals over ``n``): the kernels' own time, without the wrapper's
    host work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    # a profiler session now and then records no device events: try again,
    # and fail rather than report 0 (``warm_profiler`` runs first)
    for _ in range(5):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range.end - e.time_range.start for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if sum(spans) > 0:
            return sum(spans) / 1e3 / n, len(spans) / n
    raise RuntimeError("the profiler recorded no device time in 5 traces")


def warm_profiler() -> None:
    """Trace one small operation until a session records a device event:
    in one run on an H100 a process's first CUDA-only sessions recorded
    none, and the first measurement failed all its tries."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(1024, device="cuda")
    for _ in range(20):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            x.add_(1.0)
            torch.cuda.synchronize()
        if any(e.device_type == DeviceType.CUDA for e in prof.events()):
            return
    raise RuntimeError("the profiler recorded no device event in 20 sessions")


def device_ms_per_call(fn, n: int = 50) -> float:
    return device_per_call(fn, n)[0]


def bound_ms(n_bytes: float, flops: float,
             peak: float = PEAK_F32_FLOPS) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.detach().double() - b.detach().double()).abs().max())


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


def device_summary(prof, n: int, wall_ms: float) -> dict:
    """Device time per step from a profiler trace of ``n`` steps: busy as
    the union of the kernels' intervals (with programmatic dependent
    launch a layer starts, fetches its weights and waits inside the layer
    before it), by port kernel and by CUDA function of the port's kernels
    (each summed over its own interval), against the wall time."""
    from torch.autograd import DeviceType

    spans, device_ms, by_function, launches = [], {}, {}, {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        fn = next((k for k in DEVICE_FUNCTIONS if k in e.name), None)
        name = DEVICE_FUNCTIONS[fn] if fn else "other (PyTorch ops, copies)"
        device_ms[name] = device_ms.get(name, 0.0) + (end - start) / 1e3 / n
        launches[name] = launches.get(name, 0) + 1
        if fn:
            by_function[fn] = by_function.get(fn, 0.0) + (end - start) / 1e3 / n
    busy, last = 0.0, None
    for start, end in sorted(spans):
        if last is None or start > last:
            busy += end - start
            last = end
        elif end > last:
            busy += end - last
            last = end
    busy /= 1e3 * n
    return dict(steps=n, wall_ms_per_step_traced=wall_ms,
                device_ms_per_step=busy if busy > 0 else None,
                device_ms_by_function=device_ms,
                device_ms_by_cuda_function=by_function,
                device_launches_per_step={k: v / n for k, v in launches.items()},
                device_idle_share=1 - busy / wall_ms if busy > 0 else None)


def trace_steps(engine, blocks, mask, n: int) -> dict:
    """Profiler trace of ``n`` synchronised ``engine.step`` calls: device
    time per step, by CUDA function, against the wall time per step."""
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
    return device_summary(prof, n, wall_ms)


def trace_call(fn) -> dict:
    """Profiler trace of one synchronised call of ``fn`` (a whole replay):
    device time by kernel and the idle share of the call."""
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return device_summary(prof, 1, wall_ms)


def per_launch(trace: dict, name: str) -> float | None:
    """Device milliseconds per launch of port kernel ``name`` in a trace."""
    n = trace["device_launches_per_step"].get(name)
    return trace["device_ms_by_function"][name] / n if n else None


def near_tie(scores: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Where the top two masked scores lie within ``eps``."""
    top2 = scores.topk(2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]) < eps


def family_of(name: str) -> str:
    low = name.lower()
    for family, parts in TRAIN_FAMILIES:
        if any(part in low for part in parts):
            return family
    return "other elementwise (PyTorch ops)"


def normalized(rng, shape, dev) -> torch.Tensor:
    x = rng.standard_normal(shape).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    return torch.from_numpy(x).to(dev)


def k1_floor_ms(backward: int, C: int, N: int, T: int, d: int) -> float:
    """Device milliseconds per launch of an empty kernel launched with the
    grid, block and shared memory of K1f (``backward`` 0) or K1b (1) at
    this shape: what launch latency alone costs a K1 kernel."""
    import ctypes

    from contrastiveprosthetics_torch.ops import _build

    fn = _build.load("contrastive_loss").contrastive_loss_floor_launch
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def launch():
        rc = fn(backward, C, N, T, d, stream)
        if rc != 0:
            raise RuntimeError(f"empty kernel launch failed: cudaError {rc}")

    return device_ms_per_call(launch)


def check_k1(K, dev) -> dict:
    """Phase 6: the K1 pair against its plain version (forward, autograd
    of the plain forward, and the closed-form plain backward) at T=41,
    d=16 for C=1 config of N=8, 3 and 1 items (the 3-d call) and for the
    sweep's C=150 configs of N=8, with one upstream scalar per config; a
    second run must give the same bits, and each of the 150 configs the
    same bits alone as inside the batch. Returns the two ``kernels``
    entries, timed at the train step's C=1, N=8 and at C=150, N=8: CUDA
    events per wrapper call, profiler device time per launch, the device
    time of an empty kernel launched the same way (``floor_ms``) and the
    bound."""
    T, d = 41, 16
    errs = {"contrastive_loss_fwd": {}, "contrastive_loss_bwd": {}}
    for C, N in ((1, 8), (1, 3), (1, 1), (150, 8)):
        rng = np.random.default_rng(100 + N + C)
        shape = (N, T, d) if C == 1 else (C, N, T, d)
        e = normalized(rng, shape, dev).requires_grad_()
        g = normalized(rng, shape, dev).requires_grad_()
        up = torch.from_numpy(rng.uniform(0.5, 2.0, C).astype(
            np.float32)).to(dev)
        if C == 1:
            up = up[0]  # the 3-d call's 0-d loss takes a 0-d scalar
        loss, correct = K.fused_contrastive_loss(e, g)
        de, dg = torch.autograd.grad((loss * up).sum(), (e, g))
        loss_p, correct_p = K.fused_contrastive_reference(e, g)
        de_p, dg_p = torch.autograd.grad((loss_p * up).sum(), (e, g))
        with torch.no_grad():
            e, g = e.detach(), g.detach()
            de_w, dg_w = K.contrastive_loss_bwd_reference(e, g, up)
            again = K.contrastive_loss_fwd(e, g) + K.contrastive_loss_bwd(
                e, g, up)
            alone = [K.contrastive_loss_fwd(e[c], g[c])
                     + K.contrastive_loss_bwd(e[c], g[c], up[c])
                     for c in range(C)] if C > 1 else []
        torch.cuda.synchronize()
        case = f"C={C} N={N}"
        torch.testing.assert_close(loss, loss_p, rtol=1e-5, atol=0)
        if not torch.equal(correct, correct_p):
            raise AssertionError(f"K1f correct {correct.tolist()} against "
                                 f"{correct_p.tolist()} at {case}")
        for got, want in ((de, de_p), (dg, dg_p), (de, de_w), (dg, dg_w)):
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)
        if not all(torch.equal(a, b) for a, b in
                   zip((loss, correct, de, dg), again)):
            raise AssertionError(f"K1 is not bit-identical on a rerun, {case}")
        for c, outs in enumerate(alone):
            if not all(torch.equal(a, b[c]) for a, b in
                       zip(outs, (loss, correct, de, dg))):
                raise AssertionError(f"K1 config {c} has other bits alone "
                                     f"than inside C={C}")
        errs["contrastive_loss_fwd"][case] = max_abs(loss, loss_p)
        errs["contrastive_loss_bwd"][case] = max(
            max_abs(de, de_p), max_abs(dg, dg_p), max_abs(de, de_w),
            max_abs(dg, dg_w))
    log(f"[kernels] contrastive_loss_fwd/bwd ok at C=1 (N=8, 3, 1) and "
        f"C=150 (N=8): {json.dumps(errs)}; reruns bit-identical; each of "
        "the 150 configs bit-identical alone and inside the batch")

    def timings(C, N) -> dict:
        rng = np.random.default_rng(108 + C)
        shape = (N, T, d) if C == 1 else (C, N, T, d)
        e, g = normalized(rng, shape, dev), normalized(rng, shape, dev)
        up = torch.ones(C, device=dev)
        de, dg = K.contrastive_loss_bwd(e, g, up)
        out = torch.empty(2, C, device=dev)
        # operations: the logits (2 T^2 d), then ~6 per logit for the two
        # softmaxes; the backward recomputes both and adds 2 x 2 T^2 d and
        # ~4 per logit for dlogits
        fwd_b = bound_ms(nbytes(e, g, out), C * N * (2 * T * T * d
                                                     + 6 * T * T))
        bwd_b = bound_ms(nbytes(e, g, up, de, dg),
                         C * N * (6 * T * T * d + 10 * T * T))
        res = {}
        for name, kernel, plain, (b, by), backward in (
                ("contrastive_loss_fwd", lambda: K.contrastive_loss_fwd(e, g),
                 lambda: K.fused_contrastive_reference(e, g), fwd_b, 0),
                ("contrastive_loss_bwd",
                 lambda: K.contrastive_loss_bwd(e, g, up),
                 lambda: K.contrastive_loss_bwd_reference(e, g, up), bwd_b,
                 1)):
            res[name] = dict(
                shape=f"C={C} N={N} T={T} d={d}",
                ms=time_ms(kernel, reps=200, warmup=5),
                plain_ms=time_ms(plain, reps=50, warmup=5),
                device_ms_per_call=device_ms_per_call(kernel),
                floor_ms=k1_floor_ms(backward, C, N, T, d),
                bound_ms=b, bound_by=by)
        return res

    with torch.no_grad():
        step, sweep = timings(1, 8), timings(150, 8)
    no_library = ("no single PyTorch call computes the symmetric "
                  "contrastive loss with its first-max count, or its "
                  "gradient")
    tols = {"contrastive_loss_fwd": "loss rtol 1e-5, correct exact; reruns "
                                    "and each config alone bit-identical",
            "contrastive_loss_bwd": "de, dg rtol 1e-4 atol 1e-6 "
                                    "(test_pallas.py:58-59) against autograd "
                                    "of the plain forward and the closed "
                                    "form; reruns and each config alone "
                                    "bit-identical"}
    entries = {name: dict(route="cuda", max_abs_err=max(errs[name].values()),
                          max_abs_err_parts=errs[name], tolerance=tols[name],
                          library_ms=None, library_note=no_library,
                          **step[name], sweep_shape=sweep[name])
               for name in errs}
    log(f"[kernels] K1 timings (ms; device per launch, empty-kernel floor, "
        f"bound): {json.dumps({'step': step, 'sweep': sweep})}")
    return entries


def trace_families(warm, run, n: int) -> dict:
    """Profiler trace of ``run()``, ``n`` train steps synchronised once at
    the end (as an epoch runs), after ``warm()``: device time per step by
    kernel family and of the 12 longest CUDA functions against the wall
    time per step, and the host's busiest operators. Launches are counted
    twice: as the host's launch calls (CUDA runtime records) and as the
    device's records, of which a trace now and then drops a few (58 of
    6,680 at one C=150 sweep trace on an H100); the difference is
    reported."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    warm()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    device_ms: dict = {}
    launches: dict = {}
    kernels: dict = {}
    host_launches = host_ops = 0
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            host_launches += ev.name in LAUNCH_CALLS
            host_ops += ev.name.startswith("aten::")
            continue
        family = family_of(ev.name)
        ms = (ev.time_range.end - ev.time_range.start) / 1e3 / n
        device_ms[family] = device_ms.get(family, 0.0) + ms
        launches[family] = launches.get(family, 0) + 1
        ms_, count = kernels.get(ev.name[:100], (0.0, 0))
        kernels[ev.name[:100]] = (ms_ + ms, count + 1)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    busy = sum(device_ms.values())
    k1 = sum(device_ms.get(k, 0.0) for k in TRAIN_KERNELS)
    # the host side: self CPU time per step of the busiest operators
    ops = [ev for ev in prof.key_averages() if ev.self_cpu_time_total > 0]
    ops.sort(key=lambda ev: ev.self_cpu_time_total, reverse=True)
    host_ms = {ev.key: ev.self_cpu_time_total / 1e3 / n for ev in ops[:15]}
    host_calls = {ev.key: ev.count / n for ev in ops[:15]}
    return dict(steps=n, wall_ms_per_step_traced=wall_ms,
                host_self_ms_per_step=sum(ev.self_cpu_time_total
                                          for ev in ops) / 1e3 / n,
                host_self_ms_by_op_top15=host_ms,
                host_calls_per_step_top15=host_calls,
                device_ms_per_step=busy if busy > 0 else None,
                device_ms_by_family=device_ms,
                device_launches_per_step={k: c / n for k, c in
                                          launches.items()},
                host_launch_calls_per_step=host_launches / n,
                host_op_calls_per_step=host_ops / n,
                device_records_missing_per_step=(
                    host_launches - sum(launches.values())) / n,
                device_top12_kernels_ms_and_launches_per_step={
                    name: [ms, count / n] for name, (ms, count) in top},
                device_idle_share=1 - busy / wall_ms if busy > 0 else None,
                k1_share_of_device_time=k1 / busy if busy > 0 else None,
                k1_share_of_wall=k1 / wall_ms)


def trace_train_steps(trainer, state, hyper, n: int) -> dict:
    """:func:`trace_families` of ``n`` train steps (one
    ``train_epoch_from_indices`` call)."""
    from contrastiveprosthetics_torch.data.sampler import (
        epoch_batches,
        task_permutations,
    )

    v = trainer.view_train
    gen = trainer.generator(13)
    emg_rand = task_permutations(gen, v.n_tasks, v.D)
    batches, _ = epoch_batches(gen, v.D, trainer.batch_size)
    none = batches.new_empty(0)
    return trace_families(
        lambda: trainer.train_epoch_from_indices(
            state, emg_rand, batches[:2], none, hyper, 1.0, 1.0, gen),
        lambda: trainer.train_epoch_from_indices(
            state, emg_rand, batches[2:2 + n], none, hyper, 1.0, 1.0, gen),
        n)


def train_phase(K, dev) -> tuple[dict, dict, object, object]:
    """Phase 7: training at full width and the canonical geometry. Returns
    the ``train`` results, the K1 launch counts of ``train_loop``, the
    trainer and its trained state."""
    from contrastiveprosthetics_torch.cli import train as cli_train
    from contrastiveprosthetics_torch.config import DEFAULT_CONFIG as cfg
    from contrastiveprosthetics_torch.data.sampler import (
        gather_train_batch,
        task_permutations,
    )
    from contrastiveprosthetics_torch.data.store import DeviceStore
    from contrastiveprosthetics_torch.data.synthetic import (
        make_processed_dataset,
    )
    from contrastiveprosthetics_torch.models.convert import (
        load_reference_checkpoint,
        model_from_state_dict,
    )
    from contrastiveprosthetics_torch.train import engine
    from contrastiveprosthetics_torch.train.loop import run_test, train_loop

    t0 = time.perf_counter()
    emg, pos, glove = make_processed_dataset(cfg)
    store = DeviceStore(cfg, emg, pos, glove, device=dev)
    trainer = engine.Trainer(cfg, store, adabn=False, batch_size=8)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    v = trainer.view_train
    if v.D != 1800:
        raise AssertionError(f"DB3 train view has D={v.D}, want 1800")
    steps_per_epoch = -(-v.D // trainer.batch_size)
    hyper = engine.Hyper.single(*CANONICAL)
    log(f"[train] store of {len(pos)} people on the card "
        f"({nbytes(store.emg) / 1e6:.1f} MB), DB3 train D={v.D}, "
        f"{steps_per_epoch} steps per epoch; set-up {setup_s:.2f} s")

    # one step with the kernels and one with the plain loss, from the same
    # seeded state, batch and dropout masks
    gen = trainer.generator(7)
    emg_rand = task_permutations(gen, v.n_tasks, v.D)
    items = torch.randperm(v.D, generator=gen, device=dev)[:8]
    emg_b = gather_train_batch(v.emg_flat, emg_rand, items)
    steps = {}
    for name, loss_fn in (("kernel", K.fused_contrastive_loss),
                          ("plain", K.fused_contrastive_reference)):
        engine.fused_contrastive_loss = loss_fn
        try:
            state = trainer.init_state(trainer.generator(0))
            steps[name] = trainer.loss_and_grads(state, emg_b, hyper,
                                                 trainer.generator(1))
        finally:
            engine.fused_contrastive_loss = K.fused_contrastive_loss
    torch.cuda.synchronize()
    (loss_k, _, grads_k), (loss_p, _, grads_p) = steps["kernel"], steps["plain"]
    torch.testing.assert_close(loss_k, loss_p, rtol=1e-5, atol=0)
    grad_err = 0.0
    for tower in grads_k:
        for a, b in zip(grads_k[tower], grads_p[tower]):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
            grad_err = max(grad_err, max_abs(a, b))
    log(f"[train] one _sgd_step, kernel against plain loss: loss "
        f"{float(loss_k):.6f} vs {float(loss_p):.6f}, max grad err "
        f"{grad_err:.3g}")

    K.reset_launch_counts()
    t0 = time.perf_counter()
    res = train_loop(trainer, hyper, TRAIN_EPOCHS, seed=0, annealing=True,
                     verbose=False)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    counts = {name: K.launch_counts[name] for name in TRAIN_KERNELS}
    n_steps = TRAIN_EPOCHS * steps_per_epoch
    if any(c != n_steps for c in counts.values()):
        raise AssertionError(f"K1 launches {counts}, want {n_steps} each")
    test = run_test(trainer, res.state, hyper, trainer.generator(5))
    D_test = trainer.view_test.D
    if not (np.isfinite(res.train_losses).all()
            and res.train_losses[-1] < res.train_losses[0]):
        raise AssertionError(f"train losses {res.train_losses}")
    if res.train_accs[-1] <= 0.5 or float(test.accuracy) <= 0.5:
        raise AssertionError(f"train acc {res.train_accs[-1]}, test acc "
                             f"{float(test.accuracy)}: not above 0.5")
    if not (test.curve.shape == (D_test, cfg.n_voting_cols)
            and test.y_pred.shape == (D_test, cfg.max_tasks)
            and test.logits.shape == (D_test * 25, 41, 41)
            and bool(torch.isfinite(test.logits).all())):
        raise AssertionError("test outputs have the wrong shape or are "
                             "not finite")
    log(f"[train] train_loop {TRAIN_EPOCHS} epochs ({n_steps} steps) in "
        f"{loop_s:.2f} s: losses {res.train_losses}, accs "
        f"{res.train_accs}, val loss {res.val_loss:.4f} acc "
        f"{res.val_acc:.4f}; test loss {float(test.loss):.4f} voted acc "
        f"{float(test.accuracy):.4f}; launches {counts}")

    state = res.state
    gen = trainer.generator(11)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    trainer.train_epoch(state, gen, hyper)
    end.record()
    torch.cuda.synchronize()
    epoch_wall_ms = (time.perf_counter() - t0) * 1e3
    epoch_ms = start.elapsed_time(end)
    windows = trainer.batch_size * v.n_tasks * steps_per_epoch
    trace = trace_train_steps(trainer, state, hyper, 20)
    log(f"[train] one epoch: {epoch_ms:.3f} ms by CUDA events "
        f"({epoch_ms / steps_per_epoch:.5f} ms/step, "
        f"{windows / epoch_ms * 1e3:.1f} train windows/s); "
        f"profiler trace of 20 steps: {json.dumps(trace)}")

    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--synthetic", "--crossval_size", "0", "--final_epochs", "1",
                "--batch_size", "8", "--test", "--no_adabn", "--data_dir",
                tmp, "--checkpoint_dir", tmp]
        if cli_train.main(argv) != 0:
            raise AssertionError("cptorch-train failed")
        model = model_from_state_dict(
            load_reference_checkpoint(f"{tmp}/contrastive.pt"))
    if model.adabn:
        raise AssertionError("cptorch-train --no_adabn wrote an AdaBN model")
    log("[cli] cptorch-train --synthetic --crossval_size 0 --final_epochs 1 "
        "--batch_size 8 --test --no_adabn ok on cuda; contrastive.pt loads "
        "strictly")
    train_res = dict(
        geometry=dict(batch_size=8, n_tasks=v.n_tasks, D=v.D,
                      steps_per_epoch=steps_per_epoch,
                      windows_per_step=trainer.batch_size * v.n_tasks),
        setup_s=setup_s, step_check=dict(
            loss_kernel=float(loss_k), loss_plain=float(loss_p),
            max_grad_abs_err=grad_err, tolerance="loss rtol 1e-5, grads "
            "rtol 1e-4 atol 1e-6"),
        train_loop_s=loop_s, train_losses=res.train_losses,
        train_accs=res.train_accs, val_loss=res.val_loss,
        val_acc=res.val_acc, test_loss=float(test.loss),
        test_acc=float(test.accuracy), k1_launches=counts, steps=n_steps,
        epoch_ms=epoch_ms, epoch_wall_ms=epoch_wall_ms,
        ms_per_step=epoch_ms / steps_per_epoch,
        train_windows_per_s=windows / epoch_ms * 1e3, step_trace=trace)
    return train_res, counts, trainer, state


def ptxas_report(name: str) -> dict:
    """Per CUDA function of kernel source ``name``: its stack frame and
    spill bytes and registers, from the build's ``-Xptxas -v`` report."""
    from contrastiveprosthetics_torch.ops import _build

    report = _build.library_path(name).with_suffix(".log")
    out, fn = {}, None
    if not report.exists():
        return out
    for line in report.read_text().splitlines():
        if "Function properties for" in line:
            fn = line.split("Function properties for")[-1].strip()
        elif fn and "stack frame" in line:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            out[fn] = dict(stack_frame_bytes=nums[0],
                           spill_store_bytes=nums[1],
                           spill_load_bytes=nums[2])
        elif fn and "Used" in line and "registers" in line:
            out.setdefault(fn, {})["registers"] = int(
                line.split("Used")[1].split()[0])
    return out


def serve_cases(dev, carries, blocks_t, masks_t, scores_t, sos, mu, sd):
    """Each serve path's inputs of ``dsp_frames`` and ``vote_scan``: the
    per-tick ``step`` (K=1, S=1), the 200-tick ``steps`` replay (K=200,
    S=1) and a ragged S=37 (K=7) with live carries from a seed (n_seen
    mid-warm-up, tied scores on a coarse grid, an all-class and a
    one-class mask), and the batched replay's own blocks, encoder scores,
    masks and carries (K=25, S=32,768)."""
    from contrastiveprosthetics_torch.config import DEFAULT_CONFIG as cfg

    C, D, W, F = cfg.max_tasks, cfg.emg_dim, cfg.prediction_window_size, \
        cfg.factor
    cases = {"batched": dict(
        dsp=(carries.iir_state, carries.tail, blocks_t, sos, mu, sd),
        vote=(scores_t, masks_t, carries.votes, carries.n_seen))}
    for i, (path, Kt, S) in enumerate((("step", 1, 1), ("steps", 200, 1),
                                       ("ragged", 7, 37))):
        rng = np.random.default_rng(40 + i)

        def t(a, dtype=np.float32):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

        masks = rng.random((S, C)) < 0.6
        masks[0] = True
        if S > 1:
            masks[1] = False
            masks[1, 17] = True
        cases[path] = dict(
            dsp=(t(rng.standard_normal((S, sos.shape[0], 2, D)) * 100),
                 t(rng.standard_normal((S, cfg.rms_window - 1, D)) * 300),
                 t(rng.standard_normal((Kt, S, F, D)) * 2), sos, mu, sd),
            vote=(t(rng.integers(-8, 9, (Kt, S, C)) / 8),
                  torch.from_numpy(masks).to(dev),
                  t(rng.integers(0, C, (S, W)), np.int32),
                  t(rng.integers(0, W + 1, S), np.int32)))
    return cases


def check_serve_kernels(K, cases, sm_clock_hz: float) -> dict:
    """Phase 2, ``dsp_frames`` and ``vote_scan`` at every serve path's shape
    (``serve_cases``): each held bit for bit against its plain version,
    ``vote_scan`` with its masked-score output on and off; per path the
    wrapper and the plain version timed with CUDA events, the device time
    per launch from a profiler trace of bare calls, and the bound. For the
    one-session paths, ``dsp_frames`` also gets the serial floor of its IIR:
    4 sections x 9 dependent instructions per sample at the SM's top clock.
    Returns the two ``kernels`` entries, at the batched shape on top."""
    reps = {"step": 200, "steps": 10, "batched": 5, "ragged": 100}
    out = {"dsp_frames": {}, "vote_scan": {}}
    for path, case in cases.items():
        args = case["dsp"]
        got = K.dsp_frames(*args)
        want = K.dsp_frames_reference(*args)
        torch.cuda.synchronize()
        for name, g, w in zip(("frames", "iir_state", "tail"), got, want):
            if not torch.equal(g, w):
                raise AssertionError(f"dsp_frames {name} differs from its "
                                     f"plain version on the {path} path: "
                                     f"{max_abs(g, w)}")
        iir, tail, blocks = args[:3]
        Kt, S, F, D = blocks.shape
        n_sec, R = iir.shape[1], tail.shape[1]
        b, by = bound_ms(nbytes(blocks, got[0], *args[3:])
                         + 2 * nbytes(iir, tail),
                         S * D * Kt * (F * (1 + 9 * n_sec) + 2 * (R + 1) + 2))
        entry = dict(
            shape=f"K={Kt} S={S} factor={F} D={D}", max_abs_err=0.0,
            ms=time_ms(lambda: K.dsp_frames(*args), reps[path], 2),
            plain_ms=time_ms(lambda: K.dsp_frames_reference(*args), 1),
            device_ms_per_call=device_ms_per_call(lambda: K.dsp_frames(*args),
                                                  20),
            bound_ms=b, bound_by=by)
        if S == 1:
            entry["serial_floor_ms"] = Kt * F * n_sec * 9 / sm_clock_hz * 1e3
        out["dsp_frames"][path] = entry
        del got, want

        vargs = case["vote"]
        scores, masks, votes, n_seen = vargs
        Kt, S, C = scores.shape
        W = votes.shape[1]
        for masked in (False, True):
            got = K.vote_scan(*vargs, masked=masked)
            want = K.vote_scan_reference(*vargs, masked=masked)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                if not (g.dtype == w.dtype and torch.equal(g, w)):
                    raise AssertionError(f"vote_scan differs from its plain "
                                         f"version on the {path} path, "
                                         f"masked={masked}")
            if masked and not torch.equal(got[4].view(torch.int32),
                                          want[4].view(torch.int32)):
                raise AssertionError(f"vote_scan's masked scores differ in "
                                     f"their bits on the {path} path")
        for masked in (False, True):
            b, by = bound_ms(
                nbytes(scores, masks, got[0], got[1])
                + 2 * nbytes(votes, n_seen) + masked * nbytes(scores),
                Kt * S * (2 * C + 2 * W))
            out["vote_scan"][path + ("_masked" if masked else "")] = dict(
                shape=f"K={Kt} S={S} C={C} W={W}"
                      + (", masked scores written" if masked else ""),
                max_abs_err=0.0,
                ms=time_ms(lambda: K.vote_scan(*vargs, masked=masked),
                           reps[path], 2),
                plain_ms=time_ms(
                    lambda: K.vote_scan_reference(*vargs, masked=masked), 2),
                device_ms_per_call=device_ms_per_call(
                    lambda: K.vote_scan(*vargs, masked=masked), 20),
                bound_ms=b, bound_by=by)
        del got, want
    log(f"[kernels] dsp_frames and vote_scan bit-identical to their plain "
        f"versions at the step, steps, batched and ragged shapes (vote_scan "
        f"with and without masked scores): {json.dumps(out)}")
    entries = {}
    for name, tol in (("dsp_frames", "exact (same operation order as the "
                                     "plain version, each step rounded)"),
                      ("vote_scan", "exact (integers; masked scores "
                                    "bit for bit)")):
        top = out[name]["batched"]
        entries[name] = dict(
            route="cuda", max_abs_err=0.0, tolerance=tol, ms=top["ms"],
            plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
            bound_by=top["bound_by"], library_ms=None,
            library_note="no single PyTorch call computes it: "
            + ("an IIR cascade with a carried state and a trailing RMS"
               if name == "dsp_frames" else
               "a masked first max with a windowed majority vote"),
            shape=top["shape"], by_path=out[name],
            bound_ms_by_path={p: e["bound_ms"] for p, e in out[name].items()},
            ptxas=ptxas_report(name))
    return entries


def chain_macs(chain) -> int:
    """Multiply-adds per row of a folded chain: its weights and the head."""
    return sum(w.numel() for w in chain[0:-1:2]) + chain[-1].numel()


def encoder_bounds(chain, M: int, tensors) -> dict:
    """``encoder_chain``'s bound at ``M`` rows of ``chain``: the bytes of
    ``tensors`` against the 3xTF32 products (three per multiply-add) at the
    TF32 peak, and the f32 SIMT bound beside it."""
    macs = chain_macs(chain)
    b, by = bound_ms(nbytes(*tensors), 3 * 2.0 * macs * M, PEAK_TF32_FLOPS)
    return dict(bound_ms=b, bound_by=by,
                bound_ms_f32_simt=bound_ms(nbytes(*tensors),
                                           2.0 * macs * M)[0])


def check_encoder(K, rows, single, batched):
    """Phase 2, ``encoder_chain``: at every M of the ladder (1, 16, 200, the
    regime threshold -+ 1, one tick of 32,768 sessions, 25 ticks) on the
    batched engine's shared chain with per-session affines (M <= S: one
    tick of M sessions) and on the single engine's folded chain, held
    against the plain version; each call's first rows bit-identical to the
    smaller call before it, across the regime switch, and a rerun
    bit-identical. Times both tilings over a range of M (the threshold's
    evidence). Returns the 25-tick scores and the ``kernels`` entry."""
    S = batched.n_sessions
    M_all = rows.shape[0]
    thr = K.ENCODER_SMALL_ROWS
    shared, affines = batched.shared_chain, batched.session_affines()
    folded = single.folded_chain
    chains = {"affines": lambda M: (shared, tuple(x[:min(M, S)]
                                                  for x in affines)),
              "folded": lambda M: (folded, None)}
    errs, prev = {}, {}
    for M in sorted({1, 16, 200, thr - 1, thr + 1, S, M_all}):
        for kind, make in chains.items():
            chain, aff = make(M)
            got = K.fused_encoder_logits(rows[:M], chain, aff)
            again = K.fused_encoder_logits(rows[:M], chain, aff)
            want = K.fused_encoder_logits_reference(rows[:M], chain, aff)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)
            if not torch.equal(got, again):
                raise AssertionError(f"encoder_chain rerun differs, M={M}")
            if kind in prev and not torch.equal(got[:len(prev[kind])],
                                                prev[kind]):
                raise AssertionError(
                    f"encoder_chain rows differ between M={len(prev[kind])} "
                    f"and M={M} ({kind})")
            errs[f"M={M} {kind}"] = max_abs(got, want)
            prev[kind] = got
            del again, want
    scores = prev["affines"]
    # both f32 paths against float64 on one tick of S sessions
    aff = chains["affines"](S)[1]
    want64 = K.fused_encoder_logits_reference(
        rows[:S].double(), tuple(t.double() for t in shared),
        tuple(t.double() for t in aff))
    vs_f64 = dict(kernel=max_abs(scores[:S], want64), plain_f32=max_abs(
        K.fused_encoder_logits_reference(rows[:S], shared, aff), want64))
    del want64
    log(f"[kernels] encoder_chain ok at M = 1 .. {M_all} (threshold "
        f"{thr}), affines and folded: max abs err {max(errs.values()):.3g}; "
        "first rows bit-identical across M and the regime switch; reruns "
        f"bit-identical; against float64 at M={S}: {json.dumps(vs_f64)}")

    macs = chain_macs(shared)
    bounds = functools.partial(encoder_bounds, shared)  # same shapes as folded
    enc = dict(
        route="cuda", max_abs_err=max(errs.values()), max_abs_err_parts=errs,
        tolerance="rtol 2e-4 atol 2e-5 against the plain f32 version (3xTF32 "
                  "sums in another order); rows bit-identical across M, "
                  "tilings and reruns",
        ms=time_ms(lambda: K.fused_encoder_logits(rows, shared, affines), 3),
        plain_ms=time_ms(
            lambda: K.fused_encoder_logits_reference(rows, shared, affines),
            2),
        library_ms=time_ms(lambda: matmul_chain(rows, shared, affines), 2),
        **bounds(M_all, (rows, scores, *shared, *affines)),
        shape=f"rows={M_all} (tick, session) with per-session affines",
        max_abs_err_vs_f64_at_one_tick=vs_f64, macs_per_row=macs,
        regime_threshold=thr)
    one = rows[:1]
    s1 = K.fused_encoder_logits(one, folded)
    enc["rows_1"] = dict(
        ms=time_ms(lambda: K.fused_encoder_logits(one, folded), 200, 5),
        plain_ms=time_ms(lambda: K.fused_encoder_logits_reference(one, folded),
                         200, 5),
        library_ms=time_ms(lambda: matmul_chain(one, folded, None), 200, 5),
        **bounds(1, (one, s1, *folded)))
    tick = rows[:S]
    enc[f"rows_{S}"] = dict(
        ms=time_ms(lambda: K.fused_encoder_logits(tick, shared, affines), 10),
        library_ms=time_ms(lambda: matmul_chain(tick, shared, affines), 10),
        **bounds(S, (tick, scores[:S], *shared, *affines)))
    plan = K.encoder_plan(folded)
    enc["tiling_ms_by_rows"] = {
        M: {name: time_ms(lambda: K.encoder_chain(rows[:M], plan, regime),
                          50, 3)
            for name, regime in (("small", 0), ("large", 1))}
        for M in (16, 64, 128, 256, 384, 512, 640, 768, 1024)}
    log(f"[kernels] encoder_chain: {enc['ms']:.3f} ms at {M_all} rows "
        f"(addmm chain {enc['library_ms']:.3f}, bound {enc['bound_ms']:.3f}), "
        f"{enc['rows_1']['ms']:.5f} ms at 1 row (addmm chain "
        f"{enc['rows_1']['library_ms']:.5f}); both tilings by rows: "
        f"{json.dumps(enc['tiling_ms_by_rows'])}")
    return scores, enc


def k5_case(N: int, K_in: int, F: int, seed: int, dev):
    """One dense block's inputs at the chain's widths: a ReLU output as
    input, the previous block's (5, K_in) statistics, Linear-scaled
    weights, the gradient arriving from above and two seed words."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    x = t(np.maximum(rng.standard_normal((N, K_in)), 0.0))
    mean, var = t(rng.uniform(0.2, 0.6, K_in)), t(rng.uniform(0.2, 0.5, K_in))
    rstd = torch.rsqrt(var + 1e-5)
    a = t(rng.uniform(0.8, 1.2, K_in)) * rstd
    in_stats = torch.stack([mean, var, rstd, a,
                            t(rng.normal(0, 0.1, K_in)) - mean * a])
    w = t(rng.uniform(-1, 1, (K_in, F)) / np.sqrt(K_in))
    vecs = (t(rng.normal(0, 0.1, F)), t(rng.uniform(0.8, 1.2, F)),
            t(rng.normal(0, 0.1, F)))
    dz = t(rng.standard_normal((N, F)) * 0.01)
    seed_words = torch.tensor([int(v) for v in rng.integers(-2**31, 2**31, 2)],
                              dtype=torch.int32, device=dev)
    return x, w, vecs, in_stats, dz, seed_words


def close(got, want, rtol: float, scale_atol: float) -> float:
    """assert_close with atol ``scale_atol`` times the largest |want|;
    returns the max abs error."""
    atol = scale_atol * max(float(want.abs().max()), 1e-3)
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
    return max_abs(got, want)


def within_one_ulp(got: torch.Tensor, want: torch.Tensor) -> int:
    """Raises unless each element of ``got`` lies within one f32 ulp of
    ``want``; returns how many are not bit-equal."""
    spacing = torch.nextafter(want.abs(), torch.full_like(
        want, float("inf"))) - want.abs()
    if not bool(((got - want).abs() <= spacing).all()):
        raise AssertionError(f"more than one ulp off: max abs error "
                             f"{max_abs(got, want)}")
    return int((got != want).sum())


def check_tail(TF, dev) -> dict:
    """Phase 8, the chain's tail pair: ``chain_tail_fwd``/``_bwd`` against
    their plain versions at N=328 and a ragged 123 rows (F=512, dropout
    0.5 of block 6, the bits drawn or the replayed mask given): h and dz
    bit for bit, the sums within one f32 ulp, reruns and the replayed
    mask bit-identical. Device time per call from profiler traces, in
    turns, of the pair and of the tail the chain ran before it (the
    ``dropout_masks`` kernel, then the plain tail fed its mask). Returns
    the two ``kernels`` entries, timed at N=328."""
    F, block = 512, 6
    keep = torch.full((1,), 0.5, device=dev)
    errs = {name: {} for name in TAIL_KERNELS}
    not_bit_equal = {}
    for N in (328, 123):
        x, _, _, stats, dh, seed = k5_case(N, F, F, N + 7, dev)
        fed = dict(keep=keep, mask=TF.dropout_masks(seed, keep, N, F, block))
        drawn = dict(seed=seed, keep=keep, drop_block=block)
        outs = {}
        for form, drop in (("drawn", drawn), ("mask", fed)):
            got = (TF.chain_tail_fwd(x, stats, **drop),
                   *TF.chain_tail_bwd(dh, x, stats, **drop))
            again = (TF.chain_tail_fwd(x, stats, **drop),
                     *TF.chain_tail_bwd(dh, x, stats, **drop))
            want = (TF.chain_tail_fwd_reference(x, stats, **drop),
                    *TF.chain_tail_bwd_reference(dh, x, stats, **drop))
            torch.cuda.synchronize()
            case = f"N={N} {form}"
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                raise AssertionError(f"h or dz not bit-equal to the plain "
                                     f"version at {case}")
            not_bit_equal[case] = within_one_ulp(got[2], want[2])
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"tail not bit-identical on a rerun at "
                                     f"{case}")
            errs["chain_tail_fwd"][case] = max_abs(got[0], want[0])
            errs["chain_tail_bwd"][case] = max(max_abs(got[1], want[1]),
                                               max_abs(got[2], want[2]))
            outs[form] = got
        if not all(torch.equal(a, b) for a, b in zip(*outs.values())):
            raise AssertionError(f"drawn and replayed tail masks disagree at "
                                 f"N={N}")
    log(f"[kernels] chain tail ok at N=328 and 123, drawn and replayed "
        f"masks: {json.dumps(errs)}; h and dz bit-equal, sums within one "
        f"f32 ulp, columns not bit-equal {json.dumps(not_bit_equal)}; "
        "reruns and replayed masks bit-identical")

    N = 328
    x, _, _, stats, dh, seed = k5_case(N, F, F, 1, dev)
    drawn = dict(seed=seed, keep=keep, drop_block=block)
    kernels = {
        "chain_tail_fwd": lambda: TF.chain_tail_fwd(x, stats, **drawn),
        "chain_tail_bwd": lambda: TF.chain_tail_bwd(dh, x, stats, **drawn)}
    plain = {
        "chain_tail_fwd": lambda: TF.chain_tail_fwd_reference(x, stats,
                                                              **drawn),
        "chain_tail_bwd": lambda: TF.chain_tail_bwd_reference(dh, x, stats,
                                                              **drawn)}

    def pair():
        return kernels["chain_tail_fwd"](), kernels["chain_tail_bwd"]()

    def before():  # the tail up to this slice: K5m's mask, then PyTorch ops
        fed = dict(keep=keep, mask=TF.dropout_masks(seed, keep, N, F, block))
        return (TF.chain_tail_fwd_reference(x, stats, **fed),
                TF.chain_tail_bwd_reference(dh, x, stats, **fed))

    turns = {"before": [], "pair": []}
    launches = {}
    for name in ("before", "pair", "pair", "before"):
        ms, n = device_per_call(before if name == "before" else pair)
        turns[name].append(ms)
        launches[name] = n
    h = kernels["chain_tail_fwd"]()
    dz, sums = kernels["chain_tail_bwd"]()
    small = nbytes(seed, keep)
    # f32 work per element: the affine and the division; the division,
    # xhat and its product (the f64 adds and Philox's integer work are
    # below the byte time)
    bounds = {"chain_tail_fwd": bound_ms(nbytes(x, h, stats[3:5]) + small,
                                         3.0 * N * F),
              "chain_tail_bwd": bound_ms(nbytes(dh, x, dz, sums, stats[0],
                                                stats[2]) + small,
                                         4.0 * N * F)}
    comparison = dict(
        pair_device_ms_in_turns=turns["pair"],
        before_device_ms_in_turns=turns["before"],
        launches_per_call=launches,
        before_note=("the tail the chain ran before: the dropout_masks "
                     "kernel, then the plain tail fed its mask"))
    log(f"[kernels] chain tail device ms per call in turns (before, pair, "
        f"pair, before): {json.dumps(comparison)}")
    entries = {}
    for name in TAIL_KERNELS:
        bd, by = bounds[name]
        entries[name] = dict(
            route="cuda", max_abs_err=max(errs[name].values()),
            max_abs_err_parts=errs[name],
            tolerance=("h and dz bit for bit; sums within one f32 ulp (f64 "
                       "sums in another order, each rounded once)"),
            ms=time_ms(kernels[name], reps=200, warmup=5),
            plain_ms=time_ms(plain[name], reps=20, warmup=2),
            device_ms=device_ms_per_call(kernels[name]),
            bound_ms=bd, bound_by=by, library_ms=None,
            library_note=("no PyTorch call draws Philox bits at (seed, "
                          "block, row, column)"),
            shape=f"N={N} F={F}, dropout 0.5 of block {block}",
            tail_comparison=comparison)
    entries["chain_tail_bwd"]["sums_not_bit_equal"] = not_bit_equal
    return entries


def check_k5(TF, K, dev) -> dict:
    """Phase 8, kernels: K5f and K5b against their plain versions at N=328
    (bs 8 x 41 tasks) and a ragged N=123, block 0's form (768 inputs, no
    affine, no dropout) and an inner dropped block's (512 inputs, affine,
    drawn dropout at rate 0.5); reruns bit-identical; the drawn masks equal
    to ``dropout_masks``' replay fed back as input masks; K5m exact against
    its plain version, ragged widths included; the Philox against cuRAND's;
    K5f, K5b and their plain versions against float64 on the inner block;
    both tilings timed by device time in the chain's three block forms
    beside cuBLAS; then the tail pair (:func:`check_tail`). Returns the five
    ``kernels`` entries, K5f and K5b timed at N=328 on the inner block, with
    ``bound_ms`` at three TF32 products per multiply-add and the f32 SIMT
    bound beside it."""
    F = 512
    keep = torch.full((1,), 0.5, device=dev)
    errs = {name: {} for name in FUSED_KERNELS if name not in TAIL_KERNELS}
    for N in (328, 123):
        for K_in, inner in ((768, False), (512, True)):
            x, w, (b, gamma, beta), in_stats, dz, seed = k5_case(
                N, K_in, F, N + K_in, dev)
            kw = dict(seed=seed, keep=keep, drop_block=3) if inner else {}
            in_st = in_stats if inner else None
            r, st = TF.dense_block_fwd(x, w, b, gamma, beta, in_st, **kw)
            r_p, st_p = TF.dense_block_fwd_reference(x, w, b, gamma, beta,
                                                     in_st, **kw)
            sums = torch.stack([dz.sum(0),
                                (dz * (r_p - st_p[0]) * st_p[2]).sum(0)])
            got = TF.dense_block_bwd(dz, r_p, x, w, st_p, sums, in_st, **kw)
            want = TF.dense_block_bwd_reference(dz, r_p, x, w, st_p, sums,
                                                in_st, **kw)
            torch.cuda.synchronize()
            case = f"N={N} K={K_in}"
            errs["dense_block_fwd"][case] = max(close(r, r_p, 1e-5, 1e-5),
                                                close(st, st_p, 1e-4, 1e-5))
            errs["dense_block_bwd"][case] = max(
                close(g, v, 1e-4, 1e-5) for g, v in zip(got, want)
                if v is not None)
            again = (TF.dense_block_fwd(x, w, b, gamma, beta, in_st, **kw),
                     TF.dense_block_bwd(dz, r_p, x, w, st_p, sums, in_st,
                                        **kw))
            same = [torch.equal(a, c) for a, c in
                    zip((r, st, *got), (*again[0], *again[1]))
                    if a is not None]
            if inner:  # the drawn masks against the replayed ones
                mask = TF.dropout_masks(seed, keep, N, K_in, 3)
                fed = dict(keep=keep, mask=mask)
                fwd_in = TF.dense_block_fwd(x, w, b, gamma, beta, in_st,
                                            **fed)
                bwd_in = TF.dense_block_bwd(dz, r_p, x, w, st_p, sums, in_st,
                                            **fed)
                same += [torch.equal(a, c) for a, c in
                         zip((r, st, *got), (*fwd_in, *bwd_in))]
            if not all(same):
                raise AssertionError(f"K5 not bit-identical on a rerun or "
                                     f"against replayed masks at {case}")
    seed = torch.tensor([123456789, -98765], dtype=torch.int32, device=dev)
    for N in (328, 123):
        got = TF.dropout_masks(seed, keep, N, F, 6)
        if not torch.equal(got, TF.dropout_masks_reference(seed, keep, N, F,
                                                           6)):
            raise AssertionError(f"dropout_masks disagrees at N={N}")
        errs["dropout_masks"][f"N={N}"] = 0.0
    for width in (130, 37):  # a ragged quad; scalar stores
        if not torch.equal(TF.dropout_masks(seed, keep, 123, width, 6),
                           TF.dropout_masks_reference(seed, keep, 123, width,
                                                      6)):
            raise AssertionError(f"dropout_masks disagrees at F={width}")
        errs["dropout_masks"][f"N=123 F={width}"] = 0.0
    rng = np.random.default_rng(9)
    ctr = torch.from_numpy(rng.integers(-2**31, 2**31, (4096, 4)).astype(
        np.int32)).to(dev)
    key = torch.from_numpy(rng.integers(-2**31, 2**31, (4096, 2)).astype(
        np.int32)).to(dev)
    ours, theirs = TF.philox_check(ctr, key)
    if not torch.equal(ours, theirs):
        raise AssertionError("the kernels' Philox disagrees with cuRAND's")
    log(f"[kernels] K5f/K5b ok at N=328 and 123, K=768 and 512: "
        f"{json.dumps(errs)}; reruns and replayed masks bit-identical; "
        "dropout_masks exact (F=512, 130, 37); Philox equals "
        "curand_Philox4x32_10 on 4096 "
        "counters")

    N, K_in = 328, 512
    x, w, (b, gamma, beta), in_stats, dz, seed = k5_case(N, K_in, F, 1, dev)
    kw = dict(seed=seed, keep=keep, drop_block=3)
    r, st = TF.dense_block_fwd(x, w, b, gamma, beta, in_stats, **kw)
    sums = torch.stack([dz.sum(0), dz.sum(0)])
    dx, dw, db, osums = TF.dense_block_bwd(dz, r, x, w, st, sums, in_stats,
                                           **kw)
    mask = TF.dropout_masks(seed, keep, N, F, 6)
    x0, w0 = k5_case(N, 768, F, 2, dev)[:2]

    # the kernels and the plain f32 versions against float64 on this block
    r_p, st_p = TF.dense_block_fwd_reference(x, w, b, gamma, beta, in_stats,
                                             **kw)
    d64 = [t.double() for t in (x, w, b, gamma, beta, in_stats)]
    r64, st64 = TF.dense_block_fwd_reference(*d64, seed=seed,
                                             keep=keep.double(), drop_block=3)
    got_b = TF.dense_block_bwd(dz, r_p, x, w, st_p, sums, in_stats, **kw)
    plain_b = TF.dense_block_bwd_reference(dz, r_p, x, w, st_p, sums, in_stats,
                                           **kw)
    want_b = TF.dense_block_bwd_reference(
        dz.double(), r_p.double(), d64[0], d64[1], st_p.double(),
        sums.double(), d64[5], seed=seed, keep=keep.double(), drop_block=3)
    torch.cuda.synchronize()
    vs_f64 = {"dense_block_fwd": {}, "dense_block_bwd": {}}
    for name, outs in (("dense_block_fwd", zip(("r", "stats"), (r, st),
                                               (r_p, st_p), (r64, st64))),
                       ("dense_block_bwd", zip(("dx", "dw", "db", "out_sums"),
                                               got_b, plain_b, want_b))):
        for part, g, pl, wnt in outs:
            vs_f64[name][part] = dict(kernel=max_abs(g, wnt),
                                      plain_f32=max_abs(pl, wnt))
    del r64, st64, want_b, d64
    log(f"[kernels] K5 against float64 at N={N} K={K_in} F={F}, affine + "
        f"dropout 0.5: {json.dumps(vs_f64)}")

    # device time per launch of both tilings in the chain's three block
    # forms (block 0: 768 inputs, no affine, no dropout; blocks 1-3:
    # affine; blocks 4-6: affine + dropout), beside the cuBLAS GEMMs
    forms = {"block0 768->512": (x0, w0, None, {}),
             "affine 512->512": (x, w, in_stats, {}),
             "affine+dropout 512->512": (x, w, in_stats, kw)}
    tilings = {}
    for form, (xf, wf, insf, kwf) in forms.items():
        rf, sf = TF.dense_block_fwd(xf, wf, b, gamma, beta, insf, **kwf)
        row = {}
        for t in range(len(TF.FWD_TILES)):
            row[f"fwd tiling {t} {TF.FWD_TILES[t]}"] = device_ms_per_call(
                lambda: TF.dense_block_fwd(xf, wf, b, gamma, beta, insf,
                                           tiling=t, **kwf))
            row[f"bwd tiling {t} dgrad {TF.DGRAD_TILES[t]}"] = (
                device_ms_per_call(lambda: TF.dense_block_bwd(
                    dz, rf, xf, wf, sf, sums, insf, tiling=t, **kwf)))
        row["cuBLAS addmm"] = device_ms_per_call(
            lambda: torch.addmm(b, xf, wf))
        row["cuBLAS dz @ w.T + x.T @ dz"] = device_ms_per_call(
            lambda: (dz @ wf.T, xf.T @ dz))
        tilings[form] = row
    log(f"[kernels] K5 device ms per launch by tiling (defaults: fwd "
        f"{TF.FWD_TILING}, bwd {TF.BWD_TILING}): {json.dumps(tilings)}")

    small = nbytes(b, gamma, beta, in_stats, seed, keep)
    fwd_bytes = nbytes(x, w, r, st) + small
    bwd_bytes = nbytes(dz, r, x, w, st, sums, dx, dw, db, osums) + small
    # 3xTF32: three TF32 products per multiply-add
    fwd_b = bound_ms(fwd_bytes, 3 * 2.0 * N * K_in * F, PEAK_TF32_FLOPS)
    bwd_b = bound_ms(bwd_bytes, 3 * 4.0 * N * K_in * F, PEAK_TF32_FLOPS)
    simt = {"dense_block_fwd": bound_ms(fwd_bytes, 2.0 * N * K_in * F)[0],
            "dense_block_bwd": bound_ms(bwd_bytes, 4.0 * N * K_in * F)[0]}
    mask_b = bound_ms(nbytes(mask, seed, keep), 0.0)
    gemm = "not the same function: the cuBLAS GEMM{} alone, without {}"
    inner = tilings["affine+dropout 512->512"]
    entries = {}
    with torch.no_grad():
        for name, kernel, plain, (bd, by), extra, tol in (
                ("dense_block_fwd",
                 lambda: TF.dense_block_fwd(x, w, b, gamma, beta, in_stats,
                                            **kw),
                 lambda: TF.dense_block_fwd_reference(x, w, b, gamma, beta,
                                                      in_stats, **kw),
                 fwd_b, dict(
                     gemm_only_ms=time_ms(lambda: torch.addmm(b, x, w), 200, 5),
                     gemm_only_device_ms=inner["cuBLAS addmm"],
                     gemm_only_note=gemm.format(
                         "", "the input affine, dropout, ReLU and column "
                         "statistics"),
                     block0_ms=time_ms(lambda: TF.dense_block_fwd(
                         x0, w0, b, gamma, beta), 200, 5),
                     block0_shape=f"N={N} K=768 F={F}, no affine or "
                                  "dropout"),
                 "r rtol 1e-5, stats rtol 1e-4, atol 1e-5 x max|want| (f32 "
                 "sums in another order); reruns and replayed masks "
                 "bit-identical"),
                ("dense_block_bwd",
                 lambda: TF.dense_block_bwd(dz, r, x, w, st, sums, in_stats,
                                            **kw),
                 lambda: TF.dense_block_bwd_reference(dz, r, x, w, st, sums,
                                                      in_stats, **kw),
                 bwd_b, dict(
                     gemm_only_ms=time_ms(lambda: (dz @ w.T, x.T @ dz),
                                          200, 5),
                     gemm_only_device_ms=inner["cuBLAS dz @ w.T + x.T @ dz"],
                     gemm_only_note=gemm.format(
                         "s dy W^T and h^T dy", "the BatchNorm backward, "
                         "the input's affine and dropout, db and the lower "
                         "block's sums")),
                 "rtol 1e-4, atol 1e-5 x max|want|; reruns and replayed "
                 "masks bit-identical"),
                ("dropout_masks",
                 lambda: TF.dropout_masks(seed, keep, N, F, 6),
                 lambda: TF.dropout_masks_reference(seed, keep, N, F, 6),
                 mask_b, dict(device_ms=device_ms_per_call(
                     lambda: TF.dropout_masks(seed, keep, N, F, 6))),
                 "exact")):
            if name in simt:
                extra.update(
                    device_ms=device_ms_per_call(kernel),
                    bound_ms_f32_simt=simt[name],
                    max_abs_err_vs_f64=vs_f64[name],
                    device_ms_by_tiling=tilings,
                    tilings=dict(fwd=TF.FWD_TILES, dgrad=TF.DGRAD_TILES,
                                 default_fwd=TF.FWD_TILING,
                                 default_bwd=TF.BWD_TILING))
            entries[name] = dict(
                route="cuda", max_abs_err=max(errs[name].values()),
                max_abs_err_parts=errs[name], tolerance=tol,
                ms=time_ms(kernel, reps=200, warmup=5),
                plain_ms=time_ms(plain, reps=20, warmup=2),
                bound_ms=bd, bound_by=by, library_ms=None,
                library_note=(
                    "no single PyTorch call computes it: "
                    + ("GEMM + bias + ReLU + column statistics"
                       if name != "dropout_masks" else
                       "Philox bits at (seed, block, row, column)")),
                shape=(f"N={N} K={K_in} F={F}, affine + dropout 0.5 on the "
                       "input" if name != "dropout_masks" else
                       f"N={N} F={F}"), **extra)
    entries.update(check_tail(TF, dev))
    return entries


def fused_train_phase(K, eager) -> tuple[dict, dict]:
    """Phase 8, training on the fused chain at the canonical geometry, on
    phase 7's store. Returns the ``fused_train`` results and the K5 launch
    counts of ``train_loop``."""
    from contrastiveprosthetics_torch.cli import train as cli_train
    from contrastiveprosthetics_torch.data.sampler import (
        gather_train_batch,
        task_permutations,
    )
    from contrastiveprosthetics_torch.models.convert import (
        load_reference_checkpoint,
        model_from_state_dict,
    )
    from contrastiveprosthetics_torch.train import engine
    from contrastiveprosthetics_torch.train.loop import run_test, train_loop

    cfg, dev = eager.cfg, eager.device
    fused = engine.Trainer(cfg, eager.store, adabn=False, batch_size=8,
                           use_fused_train=True)
    v = fused.view_train
    steps_per_epoch = -(-v.D // fused.batch_size)
    n_linear = fused.n_linear

    # one step on each path from the same state and batch, at dropout 0,
    # and the same eager step in float64 on the CPU
    gen = fused.generator(7)
    emg_rand = task_permutations(gen, v.n_tasks, v.D)
    items = torch.randperm(v.D, generator=gen, device=dev)[:8]
    emg_b = gather_train_batch(v.emg_flat, emg_rand, items)
    hyper0 = engine.Hyper.single(1e-3, 1e-6, 0.0, 1e-3, 1e-6, 0.0)
    steps = {}
    for name, trainer in (("fused", fused), ("eager", eager), ("f64", eager)):
        state = trainer.init_state(trainer.generator(0))
        batch = emg_b
        if name == "f64":
            state = engine.TrainState.fresh(state.model.cpu().double())
            batch = emg_b.cpu().double()
        steps[name] = trainer.loss_and_grads(state, batch, hyper0, None)
    torch.cuda.synchronize()

    def rel_l2(a, b):
        a, b = a.detach().cpu().double(), b.detach().cpu().double()
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    loss = {k: float(v[0]) for k, v in steps.items()}
    names = [f"{tower}.{i}" for tower in steps["fused"][2]
             for i in range(len(steps["fused"][2][tower]))]
    flat = {k: [g for tower in v[2] for g in v[2][tower]]
            for k, v in steps.items()}
    rel = {pair: [rel_l2(a, b) for a, b in zip(flat[pair[0]], flat[pair[1]])]
           for pair in (("fused", "f64"), ("eager", "f64"),
                        ("fused", "eager"))}
    errs = {f"{x}_vs_{y}": dict(max_rel_l2=max(r),
                                worst=names[int(np.argmax(r))])
            for (x, y), r in rel.items()}
    log(f"[fused] one step at dropout 0: losses {json.dumps(loss)}; "
        f"gradient errors, relative 2-norm per tensor (max over tensors) "
        f"{json.dumps(errs)}")
    # f32 rounding on the card moves a few of the step's pre-activations
    # across ReLU's kink against float64, and cancellation-dominated
    # gradients (biases ahead of a BatchNorm) amplify it, on the eager path
    # as on the fused one. So the fused step is held, tensor by tensor, to
    # be no further from float64 than the eager step is
    torch.testing.assert_close(steps["fused"][0], steps["eager"][0],
                               rtol=1e-5, atol=0)
    worse = [(n, f, e) for n, f, e in zip(names, rel[("fused", "f64")],
                                          rel[("eager", "f64")])
             if f > 2 * e + 1e-5]
    if worse:
        raise AssertionError(f"fused gradients further from float64 than "
                             f"eager ones: {worse}")

    hyper = engine.Hyper.single(*CANONICAL)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    res = train_loop(fused, hyper, TRAIN_EPOCHS, seed=0, annealing=True,
                     verbose=False)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    counts = {name: K.launch_counts[name]
              for name in (*FUSED_KERNELS, *TRAIN_KERNELS)}
    n_steps = TRAIN_EPOCHS * steps_per_epoch
    want = {"dense_block_fwd": n_linear * n_steps,
            "dense_block_bwd": n_linear * n_steps,
            "chain_tail_fwd": n_steps, "chain_tail_bwd": n_steps,
            "dropout_masks": 0, "contrastive_loss_fwd": n_steps,
            "contrastive_loss_bwd": n_steps}
    if counts != want:
        raise AssertionError(f"fused launches {counts}, want {want}")
    test = run_test(fused, res.state, hyper, fused.generator(5))
    if not (np.isfinite(res.train_losses).all()
            and res.train_losses[-1] < res.train_losses[0]):
        raise AssertionError(f"fused train losses {res.train_losses}")
    if res.train_accs[-1] <= 0.5 or float(test.accuracy) <= 0.5:
        raise AssertionError(f"fused train acc {res.train_accs[-1]}, test "
                             f"acc {float(test.accuracy)}: not above 0.5")
    if not bool(torch.isfinite(test.logits).all()):
        raise AssertionError("fused test logits are not finite")
    log(f"[fused] train_loop {TRAIN_EPOCHS} epochs ({n_steps} steps) in "
        f"{loop_s:.2f} s: losses {res.train_losses}, accs {res.train_accs}, "
        f"val loss {res.val_loss:.4f} acc {res.val_acc:.4f}; test loss "
        f"{float(test.loss):.4f} voted acc {float(test.accuracy):.4f}; "
        f"launches {counts}")

    # eager and fused epochs in turns, from the trained state, by CUDA events
    state = res.state
    epoch_ms = {"eager": [], "fused": []}
    for name in ("eager", "fused", "fused", "eager"):
        trainer = fused if name == "fused" else eager
        gen = trainer.generator(11)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        trainer.train_epoch(state, gen, hyper)
        end.record()
        torch.cuda.synchronize()
        epoch_ms[name].append(start.elapsed_time(end))
    windows = fused.batch_size * v.n_tasks * steps_per_epoch
    timing = {name: dict(epoch_ms=ms, ms_per_step=[m / steps_per_epoch
                                                   for m in ms],
                         train_windows_per_s=[windows / m * 1e3 for m in ms])
              for name, ms in epoch_ms.items()}
    K.reset_launch_counts()
    trace = trace_train_steps(fused, state, hyper, 20)
    # by the wrappers' counts over the trace's 2 warm and 20 traced steps
    tail_counts = {k: K.launch_counts[k] / 22 for k in (*TAIL_KERNELS,
                                                        "dropout_masks")}
    fam = trace["device_ms_by_family"]
    per = trace["device_launches_per_step"]
    step = dict(launches_per_step=sum(per.values()),
                tail_device_ms_per_step=sum(fam.get(k, 0.0)
                                            for k in TAIL_KERNELS),
                tail_launches_per_step={k: per.get(k, 0.0)
                                        for k in (*TAIL_KERNELS,
                                                  "dropout_masks")},
                device_ms_per_step=trace["device_ms_per_step"],
                device_idle_share=trace["device_idle_share"])
    tail_want = {"chain_tail_fwd": 1.0, "chain_tail_bwd": 1.0,
                 "dropout_masks": 0.0}
    if tail_counts != tail_want:
        raise AssertionError(f"the traced fused step's tail launches "
                             f"{tail_counts}")
    log(f"[fused] epochs in turns (eager, fused, fused, eager): "
        f"{json.dumps(timing)}; profiler trace of 20 fused steps: "
        f"{json.dumps(trace)}")
    log(f"[fused] per traced step: {json.dumps(step)}")

    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--synthetic", "--crossval_size", "0", "--final_epochs", "1",
                "--batch_size", "8", "--test", "--no_adabn", "--fused_train",
                "on", "--data_dir", tmp, "--checkpoint_dir", tmp]
        if cli_train.main(argv) != 0:
            raise AssertionError("cptorch-train --fused_train on failed")
        model_from_state_dict(load_reference_checkpoint(
            f"{tmp}/contrastive.pt"))
    log("[cli] cptorch-train --synthetic --fused_train on ok on cuda; "
        "contrastive.pt loads strictly")
    fused_res = dict(
        step_check=dict(losses=loss, grad_errors=errs, tolerance=(
            "loss rtol 1e-5 against eager; each gradient tensor's relative "
            "2-norm error against float64 on the CPU at most twice the "
            "eager step's plus 1e-5")),
        train_loop_s=loop_s, train_losses=res.train_losses,
        train_accs=res.train_accs, val_loss=res.val_loss,
        val_acc=res.val_acc, test_loss=float(test.loss),
        test_acc=float(test.accuracy), launches=counts, steps=n_steps,
        launches_per_step={k: c / n_steps for k, c in counts.items()},
        epochs_in_turns=timing, step_trace=trace, traced_step=step)
    return fused_res, counts


def sweep_inputs(trainer, hyper, seed: int):
    """A fresh stacked state of ``hyper``'s configs (numpy (C,) arrays),
    the same hyperparameters as (C,) tensors on the card, one epoch's
    index matrices from each config's generator and a chunk generator for
    the dropout masks, as ``Trainer.sweep_chunk`` makes them."""
    from contrastiveprosthetics_torch.data.sampler import (
        stacked_epoch_batches,
        stacked_task_permutations,
    )
    from contrastiveprosthetics_torch.train import engine
    from contrastiveprosthetics_torch.train.crossval import config_seed

    C = len(hyper.lr_emg)
    gens = [trainer.generator(config_seed(seed, i)) for i in range(C)]
    state = trainer.init_sweep_state(gens)
    h = engine.Hyper(*[torch.as_tensor(np.asarray(x, np.float32),
                                       device=trainer.device) for x in hyper])
    v = trainer.view_train
    emg_rand = stacked_task_permutations(gens, v.n_tasks, v.D)
    batches, _ = stacked_epoch_batches(gens, v.D, trainer.batch_size)
    return (state, h, emg_rand, batches,
            trainer.generator(config_seed(seed, 0, stream=1)))


def run_sweep_steps(trainer, inputs, start: int, n: int, tail: int = 0):
    """Stacked steps over batches ``start`` to ``start + n`` of
    :func:`sweep_inputs`; with ``tail``, the last of them trains only its
    first ``tail`` items, as an epoch's tail does."""
    state, h, emg_rand, batches, gen = inputs
    part = batches[:, start:start + n]
    last = part[:, :0, 0]
    if tail:
        part, last = part[:, :-1], part[:, -1, :tail]
    return trainer.sweep_epoch_from_indices(state, emg_rand, part, last, h,
                                            1.0, 1.0, gen)


def sweep_step_check(K, trainer) -> dict:
    """Phase 9, part 1: one stacked step of 3 configs at dropout 0, (a)
    with the K1 kernels against the same step with the plain loss; (b) in
    float64 against 3 single-config eager steps in float64 from the same
    unstacked weights and batch (the plain loss: K1 takes f32); (c) in f32
    against the single steps' losses; then 5 steps in a row, stacked and
    single, in f32 (K1) and in float64 (plain loss)."""
    import copy

    from contrastiveprosthetics_torch.data.sampler import (
        stacked_gather_train_batch,
    )
    from contrastiveprosthetics_torch.train import engine

    table = np.array(SWEEP_STEP_HYPERS, np.float32)
    inputs = sweep_inputs(trainer, engine.Hyper(*table.T), seed=3)
    state, h, emg_rand, batches, _ = inputs
    base = copy.deepcopy(state.model)
    v = trainer.view_train
    emg_b = stacked_gather_train_batch(v.emg_flat, emg_rand, batches[:, 0])
    hypers = [engine.Hyper.single(*row) for row in table]
    dev = trainer.device

    def step(model, batch, hyper, loss_fn, f64=False):
        """loss_and_grads of a fresh state of a copy of ``model``."""
        model = copy.deepcopy(model)
        if f64:
            model, batch = model.double(), batch.double()
            hyper = engine.Hyper(*[torch.as_tensor(x, dtype=torch.float64,
                                                   device=dev)
                                   for x in hyper])
        engine.fused_contrastive_loss = loss_fn
        try:
            return trainer.loss_and_grads(engine.TrainState.fresh(model),
                                          batch, hyper, None)
        finally:
            engine.fused_contrastive_loss = K.fused_contrastive_loss

    def flat(grads, c=None):
        return [g if c is None else g[c] for tower in ("emg_net", "glove_net")
                for g in grads[tower]]

    def rel_l2(a, b):
        a, b = a.detach().double(), b.detach().double()
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    plain = K.fused_contrastive_reference
    loss_k, acc_k, grads_k = step(base, emg_b, h, K.fused_contrastive_loss)
    loss_p, acc_p, grads_p = step(base, emg_b, h, plain)
    loss_64, _, grads_64 = step(base, emg_b, table.T, plain, f64=True)
    torch.cuda.synchronize()
    # (a) the forward is the same launches either way, so no ReLU mask
    # moves and K1's own tolerances hold elementwise
    torch.testing.assert_close(loss_k, loss_p, rtol=1e-5, atol=0)
    if not torch.equal(acc_k, acc_p):
        raise AssertionError(f"stacked accuracies {acc_k.tolist()} against "
                             f"{acc_p.tolist()} with the plain loss")
    k1_err = 0.0
    for a, b in zip(flat(grads_k), flat(grads_p)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
        k1_err = max(k1_err, max_abs(a, b))

    # (b) float64: the stacked step computes each config's single step;
    # (c) f32: the losses, and each f32 step's distance to float64
    single_loss, worst64 = [], 0.0
    to_f64 = {"stacked_f32": 0.0, "single_f32": 0.0}
    for c in range(len(table)):
        single = step(base.unstack(c), emg_b[c], hypers[c],
                      K.fused_contrastive_loss)
        single64 = step(base.unstack(c), emg_b[c], table[c], plain, f64=True)
        single_loss.append(float(single[0]))
        np.testing.assert_allclose(float(loss_64[c]), float(single64[0]),
                                   rtol=1e-12)
        for s64, o64, s32, o32 in zip(flat(grads_64, c), flat(single64[2]),
                                      flat(grads_k, c), flat(single[2])):
            worst64 = max(worst64, rel_l2(s64, o64))
            to_f64["stacked_f32"] = max(to_f64["stacked_f32"],
                                        rel_l2(s32, o64))
            to_f64["single_f32"] = max(to_f64["single_f32"], rel_l2(o32, o64))
    if worst64 > SWEEP_F64_RTOL:
        raise AssertionError(f"float64 stacked step against the single "
                             f"steps: relative 2-norm {worst64:.3g}")
    np.testing.assert_allclose(loss_k.cpu().numpy(), single_loss, rtol=1e-5)

    # 5 steps in a row from the same weights, stacked and single: in f32
    # with the K1 kernels, and in float64 with the plain loss
    runs = {}
    for name, loss_fn, f64 in (("f32", K.fused_contrastive_loss, False),
                               ("float64", plain, True)):
        cast = (lambda t: t.double()) if f64 else (lambda t: t)
        state = engine.TrainState.fresh(cast(copy.deepcopy(base)))
        singles = [engine.TrainState.fresh(cast(base.unstack(c)))
                   for c in range(len(table))]
        hh = engine.Hyper(*[cast(x) for x in h])
        losses = {"stacked": [], "single": []}
        engine.fused_contrastive_loss = loss_fn
        try:
            for i in range(SWEEP_CHECK_STEPS):
                emg_b = cast(stacked_gather_train_batch(
                    v.emg_flat, emg_rand, batches[:, i]))
                loss, _ = trainer._sgd_step(state, emg_b, hh, hh.lr_emg,
                                            hh.lr_glove, None)
                losses["stacked"].append(loss.tolist())
                losses["single"].append([float(trainer._sgd_step(
                    s, emg_b[c], hypers[c], hypers[c].lr_emg,
                    hypers[c].lr_glove, None)[0])
                    for c, s in enumerate(singles)])
        finally:
            engine.fused_contrastive_loss = K.fused_contrastive_loss
        params = max(
            rel_l2(a[c], b) for c, s in enumerate(singles)
            for a, b in zip(state.model.state_dict().values(),
                            s.model.state_dict().values())
            if a.is_floating_point())
        runs[name] = dict(
            losses, max_loss_rel_diff=float(np.max(np.abs(np.subtract(
                losses["stacked"], losses["single"]))
                / np.abs(losses["single"]))),
            max_state_rel_l2=params)
    np.testing.assert_allclose(runs["f32"]["stacked"], runs["f32"]["single"],
                               rtol=SWEEP_STEPS_RTOL)
    np.testing.assert_allclose(runs["float64"]["stacked"],
                               runs["float64"]["single"], rtol=SWEEP_F64_RTOL)
    if runs["float64"]["max_state_rel_l2"] > SWEEP_F64_RTOL:
        raise AssertionError(f"float64 stacked state after "
                             f"{SWEEP_CHECK_STEPS} steps against the single "
                             f"ones: {runs['float64']['max_state_rel_l2']}")
    res = dict(
        configs=len(table), k1_vs_plain=dict(
            loss_kernel=loss_k.tolist(), loss_plain=loss_p.tolist(),
            max_grad_abs_err=k1_err,
            tolerance="loss rtol 1e-5, accuracy equal, grads rtol 1e-4 atol "
                      "1e-6 (phase 7's)"),
        float64_vs_single_steps=dict(
            loss=loss_64.tolist(), max_grad_rel_l2=worst64,
            tolerance=f"loss rtol 1e-12, each gradient tensor's relative "
                      f"2-norm {SWEEP_F64_RTOL}"),
        f32_vs_single_steps=dict(
            loss_stacked=loss_k.tolist(), loss_single=single_loss,
            tolerance="loss rtol 1e-5",
            max_grad_rel_l2_to_float64=to_f64,
            note="f32 gradients against float64, reported, not bounded: "
                 "a pre-activation within rounding of 0 takes another ReLU "
                 "branch in f32 than in float64 and the BatchNorm below "
                 "spreads that over the whole tensor, on whichever path "
                 "rounds it so"),
        steps_in_a_row=dict(
            runs, tolerance=f"f32 losses rtol {SWEEP_STEPS_RTOL}; float64 "
                            f"losses rtol {SWEEP_F64_RTOL} and every "
                            f"parameter and statistic at a relative 2-norm "
                            f"of {SWEEP_F64_RTOL}"))
    log(f"[sweep] one stacked step of 3 configs at dropout 0: "
        f"{json.dumps(res)}")
    return res


def sweep_trace(K, trainer, hypers, C: int) -> dict:
    """Phase 9, part 3: profiler traces of 10 stacked steps of C configs
    (the last a 5-item tail step) with dropout, taken SWEEP_TRACE_REPEATS
    times on one state. K1f and K1b must launch once per stacked step, by
    their wrappers' counts. The breakdown is the first trace's; the
    launches per step are the most any trace counted, since a trace only
    ever misses records."""
    from contrastiveprosthetics_torch.train import engine

    inputs = sweep_inputs(trainer, engine.Hyper(*[np.asarray(x)[:C]
                                                  for x in hypers]), seed=5)
    n = SWEEP_TRACE_STEPS
    traces, k1 = [], []

    def run():
        K.reset_launch_counts()
        run_sweep_steps(trainer, inputs, 2, n, tail=5)
        k1.append({k: K.launch_counts[k] / n for k in TRAIN_KERNELS})

    for _ in range(SWEEP_TRACE_REPEATS):
        traces.append(trace_families(
            lambda: run_sweep_steps(trainer, inputs, 0, 2), run, n))
    if any(per[k] != 1.0 for per in k1 for k in TRAIN_KERNELS):
        raise AssertionError(f"K1 launches per stacked step at C={C}: {k1}")
    trace = traces[0]
    trace["configs"] = C
    trace["k1_wrapper_launches_per_step"] = k1[0]
    for key in ("host_launch_calls_per_step", "host_op_calls_per_step",
                "device_records_missing_per_step"):
        trace[key + "_by_trace"] = [tr[key] for tr in traces]
    trace["launches_per_step"] = max(tr["host_launch_calls_per_step"]
                                     for tr in traces)
    trace["host_ops_per_step"] = max(tr["host_op_calls_per_step"]
                                     for tr in traces)
    return trace


def sweep_phase(K, trainer, sweep_dir: str) -> tuple[dict, dict, dict]:
    """Phase 9, the crossval sweep on phase 7's store and trainer (bs 8,
    plain BatchNorm, full width); ``cross_validate`` writes its files into
    ``sweep_dir``, where phase 10 loads them. Returns the ``sweep``
    results, the K1 launch counts of the 150-config ``cross_validate`` and
    the trace of its stacked step at C=150."""
    from contrastiveprosthetics_torch.cli import train as cli_train
    from contrastiveprosthetics_torch.models.convert import (
        load_reference_checkpoint,
        model_from_state_dict,
    )
    from contrastiveprosthetics_torch.train import crossval, engine

    t_phase = time.perf_counter()
    v = trainer.view_train
    steps = -(-v.D // trainer.batch_size)
    windows_per_step = trainer.batch_size * v.n_tasks
    step_check = sweep_step_check(K, trainer)

    # 2. the full sweep through cross_validate, as go.sh runs it
    n = SWEEP_CONFIGS
    hypers = crossval.sample_hyperparams(n, seed=42)
    chunk = crossval.resolve_chunk(n)
    n_chunks = -(-n // chunk)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    start.record()
    values = crossval.cross_validate(trainer, hypers, SWEEP_EPOCHS, seed=42,
                                     save_dir=sweep_dir)
    end.record()
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    counts = {name: K.launch_counts[name] for name in TRAIN_KERNELS}
    back_values, back_keys = crossval.load_crossval(sweep_dir)
    sweep_ms = start.elapsed_time(end)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = n_chunks * steps * SWEEP_EPOCHS
    if any(c != want for c in counts.values()):
        raise AssertionError(f"K1 launches in the sweep {counts}, want "
                             f"{want} each")
    if not (values.shape == (n, 2) and np.isfinite(values).any()):
        raise AssertionError(f"sweep values {values.shape}, none finite")
    best_acc = float(np.nanmax(values[:, 1]))
    if best_acc <= 0.1:
        raise AssertionError(f"best val accuracy {best_acc}: not above 0.1")
    if not (np.array_equal(back_values, values, equal_nan=True)
            and np.array_equal(back_keys, crossval.keys_array(hypers, 16))):
        raise AssertionError("the sweep's .npy files do not read back")
    config_steps = n * steps * SWEEP_EPOCHS
    full = dict(
        configs=n, epochs=SWEEP_EPOCHS, chunk=chunk, chunks=n_chunks,
        sweep_ms=sweep_ms, sweep_wall_s=sweep_s,
        configs_per_s=n / (sweep_ms / 1e3),
        windows_per_s=config_steps * windows_per_step / (sweep_ms / 1e3),
        ms_per_stacked_step_all_in=sweep_ms / (n_chunks * steps
                                               * SWEEP_EPOCHS),
        peak_device_memory_gb=peak_gb, k1_launches=counts,
        best_val_acc=best_acc, finite=int(np.isfinite(values).all(1).sum()),
        val_acc_quantiles=np.nanquantile(values[:, 1],
                                         [0, 0.25, 0.5, 0.75, 1]).tolist())
    log(f"[sweep] cross_validate of {n} configs x {SWEEP_EPOCHS} epoch "
        f"(chunk {chunk}): {json.dumps(full)}")

    # 3. profiler traces of 10 stacked steps at C=2 and C=150
    traces = {C: sweep_trace(K, trainer, hypers, C) for C in (2, n)}
    launches = {C: tr["launches_per_step"] for C, tr in traces.items()}
    host_ops = {C: tr["host_ops_per_step"] for C, tr in traces.items()}
    log(f"[sweep] profiler traces of {SWEEP_TRACE_STEPS} stacked steps: "
        f"{json.dumps({str(C): tr for C, tr in traces.items()})}")
    # the host's launch calls and operator calls, not the device's
    # records: a trace drops some of those now and then
    if launches[2] != launches[n] or host_ops[2] != host_ops[n]:
        raise AssertionError(f"launches per stacked step {launches} and "
                             f"operator calls {host_ops} differ with C")

    # 4. the chunk-width scan
    scan = {}
    for C in SCAN_WIDTHS:
        inputs = sweep_inputs(trainer, engine.Hyper(
            *[np.asarray(x)[:C] for x in hypers]), seed=7)
        run_sweep_steps(trainer, inputs, 0, 2)
        torch.cuda.synchronize()
        start.record()
        run_sweep_steps(trainer, inputs, 2, SCAN_STEPS)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / SCAN_STEPS
        scan[C] = dict(ms_per_stacked_step=ms, config_steps_per_s=C / ms * 1e3,
                       windows_per_s=C * windows_per_step / ms * 1e3)
        del inputs
    best = max(scan, key=lambda C: scan[C]["config_steps_per_s"])
    log(f"[sweep] chunk-width scan, {SCAN_STEPS} stacked steps each: "
        f"{json.dumps(scan)}; best width {best}, resolve_chunk's default "
        f"{crossval.DEFAULT_SWEEP_CHUNK}")

    # 5. the CLI
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--synthetic", "--crossval_size", "3", "--crossval_epochs",
                "1", "--final_epochs", "1", "--batch_size", "8", "--test",
                "--no_adabn", "--data_dir", tmp, "--checkpoint_dir", tmp]
        if cli_train.main(argv) != 0:
            raise AssertionError("cptorch-train with a sweep failed")
        if np.load(f"{tmp}/cross_val_values.npy").shape != (3, 2):
            raise AssertionError("cptorch-train wrote no sweep values")
        model_from_state_dict(load_reference_checkpoint(
            f"{tmp}/contrastive.pt"))
    log("[cli] cptorch-train --synthetic --crossval_size 3 "
        "--crossval_epochs 1 --final_epochs 1 --batch_size 8 --test "
        "--no_adabn ok on cuda; sweep files written, contrastive.pt loads "
        "strictly")
    phase_s = time.perf_counter() - t_phase
    log(f"[sweep] phase 9 took {phase_s:.1f} s")
    res = dict(step_check=step_check, sweep=full,
               traces={str(C): tr for C, tr in traces.items()},
               launches_per_stacked_step=launches, chunk_scan=scan,
               best_scan_width=best,
               default_chunk=crossval.DEFAULT_SWEEP_CHUNK, phase_s=phase_s)
    return res, counts, traces[n]


def eval_tied_items(a: torch.Tensor, b: torch.Tensor, D: int,
                    err: float) -> torch.Tensor:
    """(D,) items with a score row whose top two scores lie within
    ``2 * err`` in either of two evaluations that differ by at most ``err``
    per score: only there can a frame's first-max class, and so the item's
    votes, differ."""
    gap = lambda x: x.topk(2, dim=-1).values.diff(dim=-1).abs()[..., 0]  # noqa: E731
    close = (gap(a) <= 2 * err) | (gap(b) <= 2 * err)
    return close.reshape(D, -1).any(dim=1)


def encoder_timing(K, frames, folded) -> dict:
    """``encoder_chain`` on ``frames`` (one evaluation batch's rows of a
    folded chain, no affines) against its plain version and the ``addmm``
    chain: CUDA-event ms per call, device time per launch, its TF32
    bound and the largest difference from the plain version."""
    got = K.fused_encoder_logits(frames, folded)
    want = K.fused_encoder_logits_reference(frames, folded)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)
    device_ms, per_call = device_per_call(
        lambda: K.fused_encoder_logits(frames, folded), 10)
    return dict(
        rows=frames.shape[0], max_abs_err=max_abs(got, want),
        ms=time_ms(lambda: K.fused_encoder_logits(frames, folded), 10, 2),
        plain_ms=time_ms(
            lambda: K.fused_encoder_logits_reference(frames, folded), 5, 1),
        library_ms=time_ms(lambda: matmul_chain(frames, folded, None), 10, 2),
        device_ms_per_launch=device_ms / per_call,
        device_launches_per_call=per_call,
        **encoder_bounds(folded, frames.shape[0], (frames, got, *folded)))


def encoder_eval_entry(K, frames, folded, launches: int, path: str) -> dict:
    """A ``kernels`` entry for ``encoder_chain`` at the rows of one batch of
    evaluation path ``path``, with its launches on that path."""
    return dict(
        name="encoder_chain", route="cuda", source=SOURCES["encoder_chain"],
        replaces=REPLACES["encoder_chain"], path=path,
        shape=f"rows={frames.shape[0]} (one {path} batch, folded chain, "
              "no affines)",
        launches=launches, launches_by_path={path: launches},
        tolerance="rtol 2e-4 atol 2e-5 against the plain f32 version",
        **encoder_timing(K, frames, folded),
        peaks={"f32_flops": PEAK_F32_FLOPS, "tf32_flops": PEAK_TF32_FLOPS,
               "bytes_per_s": PEAK_BYTES_PER_S})


def timed_sweep(logits) -> tuple[object, dict]:
    """``subset_size_sweep`` of ``logits`` on the card (CUDA events, the
    host clock, peak memory above what was allocated before), then on a
    CPU copy, which must give the same bits."""
    from contrastiveprosthetics_torch.eval.subset_sweep import (
        subset_size_sweep,
    )

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    sweep = subset_size_sweep(logits)
    end.record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    t0 = time.perf_counter()
    on_cpu = subset_size_sweep(logits.cpu())
    cpu_s = time.perf_counter() - t0
    for name in sweep._fields:
        a, b = getattr(sweep, name), getattr(on_cpu, name)
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError(f"sweep {name} on the card differs from the "
                                 "CPU run")
    return sweep, dict(rows=logits.shape[0] * logits.shape[1],
                       masks=int(sweep.raw.size), ms=start.elapsed_time(end),
                       wall_ms=wall_ms, peak_gb_above_inputs=peak_gb,
                       cpu_s=cpu_s, bit_equal_to_cpu=True,
                       mean_size_1=float(sweep.mean[1]),
                       mean_size_40=float(sweep.mean[-1]))


def eval_phase(K, trainer, state, sweep_dir: str) -> tuple[dict, list]:
    """Phase 10, the evaluation and results path on phase 7's trained
    plain-BN state and store (bs 8): the test pass without and with the
    fused encoder from one index draw, the fused val pass, ``encoder_chain``
    at both batches' rows, ``subset_size_sweep`` at full size against its
    CPU run, ``export_results``, ``evaluate_per_subject`` and the three
    CLIs. Returns the ``eval`` results and the two ``kernels`` entries."""
    from contrastiveprosthetics_torch.cli import parity as cli_parity
    from contrastiveprosthetics_torch.cli import results as cli_results
    from contrastiveprosthetics_torch.cli import train as cli_train
    from contrastiveprosthetics_torch.data.sampler import (
        epoch_batches_padded,
        gather_eval_batch,
        task_permutations,
    )
    from contrastiveprosthetics_torch.eval.subset_sweep import _subset_masks
    from contrastiveprosthetics_torch.ops.kernels import fold_encoder_params
    from contrastiveprosthetics_torch.results.export import (
        export_per_subject,
        export_results,
    )
    from contrastiveprosthetics_torch.train import engine
    from contrastiveprosthetics_torch.utils.xlsx import read_xlsx

    t_phase = time.perf_counter()
    cfg, bs = trainer.cfg, trainer.batch_size
    plain = engine.Trainer(cfg, trainer.store, adabn=False, batch_size=bs)
    fused = engine.Trainer(cfg, trainer.store, adabn=False, batch_size=bs,
                           use_fused_encoder=True)
    n_layers = fused.n_linear + 3  # two convs, the dense layers, the head
    v = plain.view_test
    T, W = v.n_tasks, cfg.prediction_window_size
    gen = plain.generator(21)
    emg_rand = task_permutations(gen, T, v.D)
    indices = (emg_rand, *epoch_batches_padded(gen, v.D, 8 * bs))
    n_batches = indices[1].shape[0]

    # 1. the test pass, unfused then fused, from one index draw: launches
    # counted from 0 around each, CUDA events, then a trace of each
    passes, counts, ms = {}, {}, {}
    for name, tr in (("unfused", plain), ("fused", fused)):
        K.reset_launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        passes[name] = tr.evaluate_from_indices(state, v, *indices)
        end.record()
        torch.cuda.synchronize()
        counts[name] = K.launch_counts["encoder_chain"]
        ms[name] = start.elapsed_time(end)
    if counts != {"unfused": 0, "fused": n_layers * n_batches}:
        raise AssertionError(f"encoder_chain launches {counts}, want 0 and "
                             f"{n_layers} x {n_batches} batches")
    timed = {name: time_ms(lambda tr=tr: tr.evaluate_from_indices(
        state, v, *indices), 3, 0) for name, tr in (("unfused", plain),
                                                   ("fused", fused))}
    traces = {name: trace_call(lambda tr=tr: tr.evaluate_from_indices(
        state, v, *indices)) for name, tr in (("unfused", plain),
                                             ("fused", fused))}
    got, want = passes["fused"], passes["unfused"]
    if got.logits.shape != (v.D * W, T, T) or not bool(
            torch.isfinite(got.logits).all()):
        raise AssertionError(f"fused logits {tuple(got.logits.shape)}, or "
                             "not finite")
    torch.testing.assert_close(got.logits, want.logits, rtol=2e-4, atol=2e-5)
    err = max_abs(got.logits, want.logits)
    tied = eval_tied_items(got.logits, want.logits, v.D, err)
    n_tied = int(tied.sum())
    if not torch.equal(got.y_true, want.y_true):
        raise AssertionError("fused and unfused y_true differ")
    for name in ("curve", "y_pred"):
        if not torch.equal(getattr(got, name)[~tied],
                           getattr(want, name)[~tied]):
            raise AssertionError(f"fused and unfused {name} differ away from "
                                 "near-tie items")
    acc_diff = abs(float(got.accuracy) - float(want.accuracy))
    if acc_diff > n_tied / v.D + 1e-7:
        raise AssertionError(f"accuracy differs by {acc_diff} with {n_tied} "
                             "near-tie items")
    test_pass = dict(
        items=v.D, batches=n_batches, batch_items=8 * bs,
        rows_per_batch=indices[1].shape[1] * T * W, launches=counts,
        first_call_ms=ms, ms=timed, traces=traces,
        loss=dict(unfused=float(want.loss), fused=float(got.loss)),
        accuracy=dict(unfused=float(want.accuracy),
                      fused=float(got.accuracy)),
        max_abs_logit_err=err, near_tie_items=n_tied,
        accuracy_diff=acc_diff,
        tolerance="logits rtol 2e-4 atol 2e-5 (encoder_chain's against its "
                  "plain version); curve and y_pred equal except on items "
                  "with a score row whose top two lie within twice the "
                  "largest logit difference")
    log(f"[eval] test pass of {v.D} items in {n_batches} batches: "
        f"{json.dumps({k: v_ for k, v_ in test_pass.items() if k != 'traces'})}")
    log(f"[eval] traces of one test pass: {json.dumps(traces)}")

    # 2. the fused val pass (its own launches) and encoder_chain at both
    # batches' rows, beside its plain version and the addmm chain
    vv = fused.view_val
    K.reset_launch_counts()
    val = fused.evaluate(state, fused.generator(22), None, "val")
    torch.cuda.synchronize()
    val_launches = K.launch_counts["encoder_chain"]
    n_val = -(-vv.D // bs)
    if val_launches != n_layers * n_val:
        raise AssertionError(f"fused val pass: {val_launches} encoder_chain "
                             f"launches, want {n_layers} x {n_val}")
    model = state.model.eval()
    with torch.no_grad():
        folded = fold_encoder_params(model.emg_net, model.encode_classes())
    test_rows = gather_eval_batch(v.emg_groups, emg_rand,
                                  indices[1][0]).reshape(-1, cfg.emg_dim)
    val_rows = gather_eval_batch(vv.emg_groups, task_permutations(
        gen, T, vv.D), torch.arange(bs, device=gen.device)).reshape(
            -1, cfg.emg_dim)
    entries = [encoder_eval_entry(K, test_rows, folded, counts["fused"],
                                  "eval_test"),
               encoder_eval_entry(K, val_rows, folded, val_launches,
                                  "eval_val")]
    # a full test batch of 8 x bs items (a split of 64 items or more)
    full = gather_eval_batch(v.emg_groups, emg_rand, torch.arange(
        8 * bs, device=gen.device) % v.D).reshape(-1, cfg.emg_dim)
    entries[0]["rows_full_test_batch"] = encoder_timing(K, full, folded)
    del full
    log(f"[eval] fused val pass of {vv.D} items: acc "
        f"{float(val.accuracy):.4f}, {val_launches} launches; encoder_chain "
        f"at the eval rows: {json.dumps(entries)}")
    del test_rows, val_rows

    # 3. the set-size sweep on the test pass's logits, on the card and on
    # the CPU, its masks' draw timed alone (numpy, on the host); then on
    # 922,500 seeded score rows (22,500 x 41 x 41, true class favoured),
    # whose rows are nearly all distinct
    t0 = time.perf_counter()
    _subset_masks(np.random.default_rng(0), T, 144)
    masks_ms = (time.perf_counter() - t0) * 1e3
    sweep, sweep_path = timed_sweep(got.logits)
    rng = np.random.default_rng(10)
    big = rng.standard_normal((22500, T, T), dtype=np.float32)
    big[:, np.arange(T), np.arange(T)] += 1.0
    _, sweep_big = timed_sweep(torch.from_numpy(big).to(got.logits.device))
    del big
    sweep_res = dict(path=sweep_path, seeded_922500_rows=sweep_big,
                     mask_draw_ms=masks_ms)
    log(f"[eval] subset_size_sweep: {json.dumps(sweep_res)}")

    # 4. per-subject evaluation, then the artifacts of both
    t0 = time.perf_counter()
    per = plain.evaluate_per_subject(state, None, "test")
    torch.cuda.synchronize()
    per_s = time.perf_counter() - t0
    people = plain.store.people_ids()
    acc = per.curve[:, -1].cpu().numpy().reshape(len(people), -1).mean(1)
    if not (len(acc) == v.n_people and np.isfinite(acc).all()
            and abs(acc.mean() - float(per.curve[:, -1].mean())) < 1e-6):
        raise AssertionError(f"per-subject accuracies {acc}")
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        export_results(got, out, n_classes=T)
        export_per_subject(per, out, people)
        export_s = time.perf_counter() - t0
        shapes = {"logs": (v.D * W, T, T), "y_pred": (v.D * T,),
                  "y_true": (v.D * T,), "voting": (v.D, cfg.n_voting_cols),
                  "confusion_matrix": (T, T),
                  "per_subject_acc": (v.n_people,),
                  **{f"{s}_grasp": (T,) for s in ("mean", "min", "max",
                                                  "std")}}
        for stem, shape in shapes.items():
            arr = np.load(f"{out}/{stem}.npy")
            if arr.shape != shape:
                raise AssertionError(f"{stem}.npy {arr.shape}, want {shape}")
            if stem in ("logs", "y_pred", "y_true"):  # .npy only
                continue
            sheet = read_xlsx(f"{out}/{stem}.xlsx")
            sheet = sheet[:, -1] if arr.ndim == 1 else sheet
            if not np.array_equal(sheet, arr.astype(np.float64)):
                raise AssertionError(f"{stem}.xlsx does not read back as "
                                     f"{stem}.npy")
        curve = np.load(f"{out}/voting.npy").astype(np.float64)
        for stem, want_ in (("voting_avg", curve.mean(0)),
                            ("voting_std", curve.std(0))):
            if not np.allclose(read_xlsx(f"{out}/{stem}.xlsx")[:, 0], want_,
                               rtol=1e-6, atol=1e-7):
                raise AssertionError(f"{stem}.xlsx")
        if not np.array_equal(np.load(f"{out}/mean_grasp.npy"), sweep.mean):
            raise AssertionError("exported mean_grasp is not the sweep's")
    log(f"[eval] evaluate_per_subject in {per_s:.2f} s: {acc.tolist()}; "
        f"export_results and export_per_subject in {export_s:.2f} s, every "
        "artifact present with its shape, every sheet reads back as its .npy")

    # 5. the CLIs on cuda: train with the fused encoder into A, results
    # from its checkpoint with it into B and without it into C
    with tempfile.TemporaryDirectory() as tmp:
        common = ["--synthetic", "--crossval_load", "--data_dir", sweep_dir,
                  "--checkpoint_dir", tmp, "--batch_size", "8", "--no_adabn",
                  "--per_subject_eval"]
        a, b, c = (f"{tmp}/{x}" for x in "ABC")
        t0 = time.perf_counter()
        if cli_train.main([*common, "--final_epochs", "1", "--test",
                           "--fused_encoder", "--results_dir", a]) != 0:
            raise AssertionError("cptorch-train --fused_encoder failed")
        t1 = time.perf_counter()
        for argv in ([*common, "--fused_encoder", "--results_dir", b],
                     [*common, "--results_dir", c]):
            if cli_results.main(argv) != 0:
                raise AssertionError(f"cptorch-results {argv} failed")
        t2 = time.perf_counter()
        la, lb = np.load(f"{a}/logs.npy"), np.load(f"{b}/logs.npy")
        logs_equal = bool(np.array_equal(la, lb))
        np.testing.assert_allclose(lb, la, rtol=2e-4, atol=2e-5)
        logs_diff = float(np.abs(la - lb).max())
        if cli_parity.main([c, "--ref", a]) != 0:
            raise AssertionError("cptorch-parity C --ref A failed")
        if not all(os.path.exists(f"{d}/per_subject_acc.npy")
                   for d in (a, b, c)):
            raise AssertionError("a CLI wrote no per-subject accuracies")
    clis = dict(train_s=t1 - t0, results_s_each=(t2 - t1) / 2,
                logs_bit_equal_train_vs_results=logs_equal,
                logs_max_abs_diff=logs_diff, parity_c_vs_a="PASS")
    log(f"[cli] cptorch-train --crossval_load --fused_encoder "
        f"--per_subject_eval --results_dir A, cptorch-results into B "
        f"(fused) and C (unfused), cptorch-parity C --ref A ok on cuda: "
        f"{json.dumps(clis)}")
    phase_s = time.perf_counter() - t_phase
    log(f"[eval] phase 10 took {phase_s:.1f} s")
    res = dict(test_pass=test_pass,
               val_pass=dict(items=vv.D, batches=n_val,
                             launches=val_launches,
                             accuracy=float(val.accuracy)),
               sweep=sweep_res,
               per_subject=dict(accuracies=acc.tolist(), s=per_s),
               export_s=export_s, clis=clis, phase_s=phase_s)
    return res, entries


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
    warm_profiler()

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
    carries = batched.init_carries()
    sos, mu, sd = single._sos, single._mean, single._std
    frames = K.dsp_frames(carries.iir_state, carries.tail, blocks_t, sos, mu,
                          sd)[0]
    scores, enc = check_encoder(K, frames.reshape(T * S, D), single, batched)
    del frames
    sm_clock_hz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0]) * 1e6
    entries = check_serve_kernels(
        K, serve_cases(dev, carries, blocks_t, masks_t, scores.view(T, S, C),
                       sos, mu, sd), sm_clock_hz)
    entries["encoder_chain"] = enc
    del scores

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
    torch.cuda.synchronize()
    step_counts = dict(K.launch_counts)
    _, preds, votes = single.steps(single.init_carry(), blocks, mask1)
    torch.cuda.synchronize()
    steps_counts = {k: v - step_counts[k] for k, v in K.launch_counts.items()}
    if (preds[:50].tolist() != step_p or votes[:50].tolist() != step_v):
        raise AssertionError("step loop and steps disagree")
    if not set(preds.tolist()) <= set(np.flatnonzero(mask1).tolist()):
        raise AssertionError("single-session preds outside the subset")
    lat = np.array(lat[1:])
    steps_ms = time_ms(lambda: single.steps(single.init_carry(), blocks,
                                            mask1), reps=5)
    trace = trace_steps(single, blocks, mask1, 20)
    steps_trace_1 = trace_call(lambda: single.steps(single.init_carry(),
                                                    blocks, mask1))
    single_res = dict(step_p50_ms=float(np.percentile(lat, 50)),
                      step_p99_ms=float(np.percentile(lat, 99)),
                      steps_200_ticks_ms=steps_ms, step_trace=trace,
                      steps_200_ticks_trace=steps_trace_1,
                      preprocess_recording_ms=preprocess_ms,
                      calibrate_ms=calibrate_ms,
                      calibrate_session_ms=calibrate_session_ms)
    log(f"[single] step p50 {single_res['step_p50_ms']:.4f} ms, p99 "
        f"{single_res['step_p99_ms']:.4f} ms (49 ticks after the first); "
        f"steps over 200 ticks {steps_ms:.4f} ms; step loop == steps; "
        f"launches: step {step_counts}, steps {steps_counts}")
    log(f"[single] profiler trace of 20 steps: {json.dumps(trace)}; of one "
        f"200-tick steps call: {json.dumps(steps_trace_1)}")

    # ------------------------------------------------------- 4. batched
    K.reset_launch_counts()
    out_carry, b_preds, b_votes = batched.steps(batched.init_carries(),
                                                batch_blocks, masks)
    torch.cuda.synchronize()
    batched_counts = dict(K.launch_counts)
    for name in SERVE_KERNELS:
        if not (step_counts[name] and steps_counts[name]
                and batched_counts[name]):
            raise AssertionError(f"{name} never launched on the main path: "
                                 f"{step_counts} {steps_counts} "
                                 f"{batched_counts}")
    shared, affines = batched.shared_chain, batched.session_affines()
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
    live = batched.init_carries()
    live_ms = time_ms(lambda: batched.step(live, blocks_t[0], masks_t),
                      reps=10, warmup=2)
    steps_trace = trace_call(lambda: batched.steps(
        batched.init_carries(), blocks_t, masks_t))
    batched_res = dict(sessions=S, ticks=T, steps_ms=batched_ms,
                       ms_per_tick=batched_ms / T,
                       steps_ms_numpy_input=host_ms,
                       live_step_ms=live_ms, steps_trace=steps_trace,
                       pred_near_tie_disagreements=int(diff.sum()))
    log(f"[batched] {S} sessions x {T} ticks: {batched_ms:.3f} ms per "
        f"steps call on device-resident blocks, {batched_ms / T:.4f} "
        f"ms/tick; {host_ms:.3f} ms with numpy blocks copied in; one live "
        f"step of all {S} sessions {live_ms:.4f} ms; "
        f"{int(diff.sum())} near-tie pred differences vs plain; "
        f"launches {batched_counts}")
    log(f"[batched] profiler trace of one {T}-tick steps call: "
        f"{json.dumps(steps_trace)}")
    del k_scores, p_scores, blocks_t

    # ----------------------------------------------------------- 5. CLI
    for argv in (["--demo", "--sessions", "1", "--quiet"],
                 ["--demo", "--sessions", "64", "--replay", "--quiet"]):
        if cli.main(argv) != 0:
            raise AssertionError(f"cptorch-serve {' '.join(argv)} failed")
    log("[cli] cptorch-serve --demo --sessions 1 and --sessions 64 "
        "--replay ok on cuda")

    # ------------------------------------------------ 6. the K1 kernels
    entries.update(check_k1(K, dev))

    # ---------------------------------------------------------- 7. train
    train_res, train_counts, trainer, state = train_phase(K, dev)

    # ------------------------------------------- 8. the fused train chain
    from contrastiveprosthetics_torch.ops import train_fused as TF

    entries.update(check_k5(TF, K, dev))
    fused_res, fused_counts = fused_train_phase(K, trainer)

    with tempfile.TemporaryDirectory() as sweep_dir:
        # -------------------------------------------- 9. the crossval sweep
        sweep_res, sweep_counts, sweep_trace_150 = sweep_phase(K, trainer,
                                                               sweep_dir)
        # ---------------------------------- 10. evaluation and the results
        eval_res, eval_entries = eval_phase(K, trainer, state, sweep_dir)

    for name, entry in entries.items():
        if name in FUSED_KERNELS:
            by_path = {"fused_train": fused_counts[name]}
            fam = fused_res["step_trace"]["device_ms_by_family"]
            per = fused_res["step_trace"]["device_launches_per_step"]
            entry["device_ms_per_launch_traced"] = (
                fam[name] / per[name] if per.get(name) else None)
        elif name in TRAIN_KERNELS:
            by_path = {"train": train_counts[name],
                       "fused_train": fused_counts[name],
                       "sweep": sweep_counts[name]}
            traced = {}
            for path, trace in (("train", train_res["step_trace"]),
                                ("fused_train", fused_res["step_trace"]),
                                ("sweep", sweep_trace_150)):
                fam = trace["device_ms_by_family"]
                per = trace["device_launches_per_step"]
                traced[path] = fam[name] / per[name] if per.get(name) else None
            entry["device_ms_per_launch_traced"] = traced
        else:
            by_path = {"step": step_counts[name],
                       "steps": steps_counts[name],
                       "batched": batched_counts[name]}
            entry["device_ms_per_launch_by_path"] = {
                "step": per_launch(single_res["step_trace"], name),
                "steps": per_launch(steps_trace_1, name),
                "batched": per_launch(steps_trace, name)}
        entry.update(name=name, source=SOURCES[name], replaces=REPLACES[name],
                     kernel_ms=entry["ms"], launches=sum(by_path.values()),
                     launches_by_path=by_path,
                     peaks={"f32_flops": PEAK_F32_FLOPS,
                            "tf32_flops": PEAK_TF32_FLOPS,
                            "bytes_per_s": PEAK_BYTES_PER_S})
    print(json.dumps({"single": single_res, "batched": batched_res}))
    print(json.dumps({"train": train_res}))
    print(json.dumps({"fused_train": fused_res}))
    print(json.dumps({"sweep": sweep_res}))
    print(json.dumps({"eval": eval_res}))
    print(card)
    print(json.dumps({"kernels": list(entries.values()) + eval_entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
