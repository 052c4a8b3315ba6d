#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port: the streaming serve path and
its calibration, contrastive training, training on the fused chain, the
crossval sweep, the evaluation and results path, ingest from raw ``.mat``
files, the softmax baseline and glove modes, bfloat16 serving,
bfloat16 training, the go.sh/results.sh twins with checkpoint interop,
and the crossval sweep on the fused chain and the fused encoder with
``Trainer(remat=True)``.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the seven CUDA kernel sources from
``contrastiveprosthetics_torch/csrc`` and drives the port at full model
width (d_e=16, 64 conv features, 7 x 512 dense, 41 classes) with weights
from a seeded ``torch.Generator`` and raw recordings and synthetic data
made with numpy from a seed:

1. set-up: kernel build (seconds printed), the card's name and power limit;
   calibration of the single engine and of 4 of the batched engine's
   sessions (``preprocess_recording``, ``calibrate``,
   ``calibrate_session``, timed), each recording one ``iir_rms_frames``
   launch, with the plain IIR fenced off;
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
   a dependent f32 add's latency in SM cycles (one thread's chain of
   ``__fadd_rn``), which sets the recurrence floors of ``dsp_frames`` and
   ``iir_rms_frames``; ``iir_rms_frames`` bit for bit and on a rerun at
   one subject read through its row table from its two recordings (246 x
   2,010 samples, stride 20), the corpus through tables into 46 subjects'
   recordings in one call (11,316 segments, 1.09 GB), the same two as
   contiguous segments, a calibration recording (4,000 samples), the
   compat mask's stride 1 and ragged shapes (37 segments; T = W; T = W +
   stride - 1), against float64 scipy, each timed beside its byte bound,
   its recurrence floor and the earlier one-thread-a-chain design's time;
3. single session: 50 per-tick ``step`` calls (p50/p99 tick latency) and a 200-tick ``steps``
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
   differ between the two by a launch per step, one K1f and one K1b
   per stacked step and one ``adam_stacked`` a live tower; the
   chunk-width scan (20 stacked steps at 1, 2, 10, 50 and 150 configs);
   ``cptorch-train --crossval_size 3``; then ``adam_stacked`` against its
   plain version at the sweep's C=150 and the EMG tower's 37 parameters,
   f32 and bf16 mu, bit for bit over 3 updates, timed in turns beside
   its byte bound;
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
   ``cptorch-parity C --ref A``;
11. ingest from raw ``.mat`` files at the full per-subject geometry (41
   stimuli x 6 reps x 2,020 samples x 12 channels) for two DB2 and two
   DB3 subjects and glove subjects 28-29, written to a temporary
   directory (about 210 MB): ``cptorch-load --synthetic_fixture --load
   --info`` on cuda (one ``iir_rms_frames`` launch per subject, reading
   its recordings through the row table; the host's segment extraction
   fenced off), the same ingest with ``--backend scipy`` (float64) holding
   the artifacts to rtol 1e-3, atol 1e-4, a second device run and a run on
   the CPU whose ``emg`` and statistics must be the card's bits, per-subject
   times (``.mat`` read, row table, copies and kernel, statistics), one
   subject's recordings to the card cast on the host and on the card,
   ``emg.npz`` through ``DeviceStore.load`` on the card, and
   ``cptorch-train --crossval_size 3 --final_epochs 1 --batch_size 8
   --test`` on it;
12. the softmax baseline and the glove modes on phase 7's store (bs 8,
   plain BatchNorm, full width, the synthetic glove corpus): one step
   per mode at dropout 0 against a reference step (glove encoding: the
   K1 kernels against the plain loss at phase 7's tolerance; the baseline,
   which runs no kernel: the loss against float64 on the CPU);
   ``train_loop`` for 2 annealed epochs and ``run_test`` in prediction
   (asking for the fused chain and the fused encoder, which warn),
   glove prediction, glove encoding (asking for the fused encoder, which
   warns) and glove encoding on the fused chain, each test accuracy above
   0.1; one epoch of each timed by CUDA events beside phase 7's; a
   stacked step of 3 configs in each mode against 3 single steps in
   float64 at 1e-9; ``cross_validate`` of go.sh's 150 configs x 1 epoch
   in glove encoding (configs/s, best val accuracy above 0.1) and traces
   of 10 stacked steps at C=2 and C=150 with equal host launch calls;
   ``cptorch-train --synthetic --crossval_size 3 --final_epochs 1 --test
   --results_dir A`` with ``--prediction`` and with ``--glove_encoding``,
   each checkpoint loaded back strictly in its mode, and
   ``cptorch-results`` with the same flag writing the same ``logs.npy``;
13. bfloat16 serving (``cptorch-serve --bf16``) at full width, the same
   seeded weights in ``ContrastiveModel(dtype=torch.bfloat16)``: the bf16
   engines calibrated through the bf16 tower (one ``iir_rms_frames``
   launch a recording); ``encoder_chain``'s bf16 variant (bf16 folds, one
   ``mma.sync`` m16n8k16 pass a product) at phase 2's ladder of row
   counts, with and without affines, against its plain version (atol
   ``BF16_ATOL``) and the f32 fold of the same statistics (rtol 0.1, atol
   0.05, JAX's bound), reruns and smaller calls bit-identical, against
   float64 on the same bf16 operands at one tick, timed in turns with the
   f32 kernel at 819,200, 32,768 and 1 rows beside its bound, its plain
   version and the cuBLAS bf16 chain, both tilings by rows, its ptxas
   stack frames and spills 0; 50 per-tick ``step`` calls (p50/p99) and a
   200-tick ``steps`` replay that must agree, a trace of 20 steps; the
   batched replay of 32,768 sessions x 25 ticks with subset masks against
   the plain version away from near-ties, timed, traced, one live
   ``step``; one timed replay at 65,536 sessions; the share of preds equal
   to phase 4's f32 engine's; ``cptorch-serve --bf16`` per tick and
   ``--sessions 64 --replay``;
14. bfloat16 training (``cptorch-train --bf16``) on phase 7's store at
   full width, bs 8: the bf16 variants of K5f, K5b and the tail pair
   (``*_bf16``: bf16 x, W, r, dz, dx, h; f32 statistics, sums, dW, db)
   against their plain versions at N=328 and 123, block 0's 768 inputs
   and an inner dropped block's 512 (rtol and atol 0.05 on r and dx, the
   f32 K5b's tolerance on dW, db and the sums, the tail bit for bit),
   reruns, both tilings, both weight layouts and replayed masks
   bit-identical, against float64 on the same bf16 operands no worse than
   the plain versions, each timed in turns with the f32 kernel beside its
   bound at the bf16 peak and the cuBLAS bf16 GEMMs; ``train_loop`` for 2
   annealed epochs eager and on the fused chain (test accuracy above 0.5;
   the fused run 7 launches of each bf16 K5 variant a step and one of each
   bf16 tail kernel, the f32 ones never, the eager run none); 50 steps of
   the f32 and the bf16 paths, eager and fused, in turns; traces of 20 bf16 steps each way;
   a stacked bf16 step of 2 configs against their single steps;
   ``cross_validate`` of the CLI's default 10 configs in bf16; the fused
   bf16 state's test pass unfused and on the fused encoder
   (``encoder_chain_bf16`` 10 launches a batch); ``cptorch-train --bf16``
   and ``cptorch-results`` with and without ``--bf16``;
15. the twins and checkpoint interop, in a temporary directory holding a
   copy of the repo's cached 150-config crossval: ``scripts/go_torch.sh
   --synthetic --final_epochs 1`` (go.sh runs 8) and
   ``scripts/results_torch.sh`` over its checkpoint, each in its own
   process, whose test loss and accuracy must be equal; ``cptorch-export`` of the checkpoint to the JAX
   ``TrainState`` msgpack and ``cptorch-import`` of that into a second
   directory (state_dict and both Adam chains bit-equal) and
   ``cptorch-results`` over the import (the same test numbers);
   ``cptorch-serve --checkpoint X.msgpack`` per tick and ``--replay``,
   preds and votes equal to the ``.pt``'s; ``cptorch-train --crossval_size
   0 --final_epochs 1 --batch_size 64`` timed without and with
   ``--profile``, whose Chrome
   trace must parse and hold a ``contrastive_loss_fwd`` device record;
   ``cptorch-train --spmd_crossval --crossval_size 2`` and
   ``cptorch-serve --spmd --demo --sessions 8 --replay`` on the one card;
16. the sweep on the fused chain and the fused encoder, and remat, on
   phase 7's store: K5f, K5b and the tail pair at their config axis
   against their plain versions at C=1, 2 and 150, N=328 and 123, block
   0 and an inner dropped block, f32 and bf16 (the single-config rows'
   tolerances; bf16 statistics at phase 14's), reruns bit-identical,
   every config of the C=2 and C=150 launches bit-equal to its own
   launch, each timed at C=150 beside the stacked eager layer's
   ``baddbmm``/``bmm``; ``encoder_chain`` at its config axis on a stacked
   fold of 150 configs, 8,200 rows a config, at C=1, 2, 10 and 150, both
   tilings, f32 and bf16, against its plain version, float64 at C=2 and
   each config's own call, timed at C=150 beside the ``baddbmm`` chain
   (``library_ms``); ``Trainer(remat=True)``: 45 steps (cut from an epoch) eager and fused,
   f32 and bf16, and 20 stacked steps of 150 configs eager and fused,
   bit-equal to remat off under deterministic algorithms, ms a step and
   peak memory beside it; ``cross_validate`` of 150 configs x 1 epoch on
   both fused paths, in turns with phase 9's eager sweep, traces of 10
   stacked fused
   steps at C=2 and 150, a dropout-0 chunk fused against eager, the bf16
   and glove-encoding fused sweeps of 10 configs, the sweep's val of 150
   configs fused against unfused; ``scripts/go_torch.sh --synthetic
   --fused_train on --fused_encoder --crossval_size 150 --final_epochs
   1`` in its own process;
17. the parallel layer (``parallel/``): (a) a world of one rank over NCCL
   in this process, at full width: ``make_sharded_train_step`` on a (1,
   1) mesh, eager f32 and then fused, remat (eager and fused) and bf16
   (eager and fused), each with its twin's launches and no dp mode of a
   kernel, ``cross_validate(mesh=)`` of 2 configs x 1 epoch and
   ``BatchedStreamingEngine(mesh=)`` at 32,768 sessions x 25 ticks, each
   bit-equal to its unsharded twin and timed beside it in turns; (c) K5f,
   K5b and the tail pair, f32 and bf16, in a dp rank's modes (Philox row
   base, K5f's sums-only end and ``finish_stats``, K5b's n_total) at
   N=164 and 82 against their plain versions and the whole batch's rows,
   timed; (b) one
   spawned group of 4 ranks over gloo on the one card (NCCL refuses two
   ranks on one device; gloo is asked for here): the dp=2 step (ranks
   0-1) and the dp=2 x mp=2 step (all four) against the unsharded step on
   the card at JAX's bounds, K1f/K1b once a step on each rank at N=4; the
   fused f32 and bf16 steps at dp=2 x mp=2 and dp=4 (all sums-only K5f,
   K5b given n_total, the row-based launches), f32 at JAX's bounds, bf16
   within the eager/fused bf16 spread; the
   config-sharded sweep of 4 configs x 1 epoch over 2 ranks (cut from
   go.sh's 150 for time), eager and on the fused chain and encoder,
   bit-equal to the unsharded sweep at chunk 2, 7 K5f, 7 K5b and one of
   each tail kernel a stacked step on each rank; session-sharded serving
   of 32,768 sessions x 25 ticks over 2 ranks, f32 and bf16, preds and
   votes equal to the unsharded engine's, each rank's kernels launched on
   its shard; ``cptorch-train --spmd_crossval --crossval_size 4`` and
   ``cptorch-serve --spmd --demo --sessions 8 --replay`` in a 2-rank
   group, writing the unsharded commands' files. Its times are per rank
   on one shared card, not scaling numbers.

Launch counts are reset just before the calibration, phases 3, 4, 7's and
8's ``train_loop``, 9's ``cross_validate`` and ``adam_stacked`` check,
10's test and val passes, 11's ``cptorch-load`` and 12's ``train_loop``
runs (read again after each run's test pass) and ``cross_validate``, 13's calibration, ``step`` loop,
``steps``, batched replays and CLI runs, 14's ``train_loop`` runs,
sweep and test passes, 15's serving from the checkpoints and its
profiled run, and read just after each (phase
3's after its ``step`` loop and after its ``steps`` call); every serve
kernel must have launched on each of the three serve paths,
``iir_rms_frames`` once per calibration recording and once per ingested
subject, each K1
kernel once per train step in 7 and 8 and once per stacked step in 9,
``adam_stacked`` once a call in 9's check (reset just before it),
and the chain's kernels as its depth says in 8; in 12 K1 once per step
of both glove-encoding runs and per stacked step of their sweep and never
in the baseline, the chain's kernels as its depth says in the fused run,
and ``encoder_chain`` never; in 13 the bf16 variant on every path and
the f32 one on none, and the bf16 variant never in phases 1-12 (its
launches summed across every reset there); in 14 the bf16 chain's four
kernels as its depth says on the fused run and never in phases 1-13; in
16, reset before each remat run, each sweep and each val pass, 7 K5f,
7 K5b and one of each tail kernel a fused step (with remat: 14 K5f, 2
tail forwards and 2 K1f a step, the backward's as without), per stacked
fused step whatever C is, ``encoder_chain`` 10 times a val batch of the
fused sweep, none of them on the eager sweep; in 17, reset before each
sharded run on each rank, each K1 kernel once a sharded step, 7 K5f, 7
K5b and one of each tail kernel a stacked step of the fused sweep on
each rank (none eager), and the serve kernels on each rank's shard.
TF32
is off throughout
(``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` set False), so the plain versions run
in full f32 (``encoder_chain``, K5f and K5b run 3xTF32 by their own
instructions, whatever the flags). Any failure raises and the exit code
is not 0. The last lines are ``{"single", "batched"}``, ``{"train"}``,
``{"fused_train"}``, ``{"sweep"}``, ``{"eval"}``, ``{"ingest"}``,
``{"modes"}``, ``{"bf16_serve"}``, ``{"bf16_train"}``, ``{"interop"}``,
``{"sweep_fused"}`` and ``{"parallel"}`` JSON lines, the
card
line from nvidia-smi, one
``{"kernels": [...]}`` JSON line, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import copy
import functools
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet): f32 outside the tensor
# cores, dense TF32 and bf16 on the tensor cores and HBM3 bandwidth; a
# card below its 700 W limit runs slower.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
REPLACES = {
    "dsp_frames": "contrastiveprosthetics_tpu/ops/pallas_ops.py:544 "
                  "(_tick_chain_kernel, DSP part) and :746 "
                  "(_batched_tick_chain_kernel, DSP part)",
    "encoder_chain": "contrastiveprosthetics_tpu/ops/pallas_ops.py:460 "
                     "(_enc_kernel via fused_encoder_logits :475; the chain "
                     "inside :544 and :746)",
    "encoder_chain_bf16": "contrastiveprosthetics_tpu/ops/pallas_ops.py:460 "
                          "(_enc_kernel on a bf16 fold, :318-322, via "
                          "fused_encoder_logits :475; the chain inside :544 "
                          "and :746)",
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
    "dense_block_fwd_bf16": "contrastiveprosthetics_tpu/ops/train_fused.py:362 "
                            "(_fwd_block_call with ChainCfg.dtype bfloat16, "
                            ":127; body _fwd_block_kernel :183, roundings "
                            ":221-228)",
    "dense_block_bwd_bf16": "contrastiveprosthetics_tpu/ops/train_fused.py:412 "
                            "(_bwd_block_call with ChainCfg.dtype bfloat16; "
                            "body _bwd_block_kernel :239, roundings "
                            ":292-317)",
    "chain_tail_fwd_bf16": "contrastiveprosthetics_tpu/ops/train_fused.py:777 "
                           "(K5m, the last block's mask) and the XLA tail in "
                           "bfloat16 (_chain_fwd :593-601)",
    "chain_tail_bwd_bf16": "contrastiveprosthetics_tpu/ops/train_fused.py:777 "
                           "(K5m, the mask redrawn) and the XLA tail in "
                           "bfloat16 (_chain_bwd :624-638)",
    "iir_rms_frames": "no Pallas kernel: XLA's lax.scan "
                      "contrastiveprosthetics_tpu/ops/signal.py:65 (sosfilt) "
                      "and :128 (moving_rms), as preprocess_segment :149 "
                      "(vmapped by data/ingest.py:63-84) and "
                      "serve/stream.py:356-366 (preprocess_recording) run "
                      "them",
    "adam_stacked": "no Pallas kernel: optax.scale_by_adam "
                    "(contrastiveprosthetics_tpu/train/engine.py:257) under "
                    "the sweep's jax.vmap, fused into the step by XLA",
}
SERVE_KERNELS = ("dsp_frames", "encoder_chain", "vote_scan")
TRAIN_KERNELS = ("contrastive_loss_fwd", "contrastive_loss_bwd")
FUSED_KERNELS = ("dense_block_fwd", "dense_block_bwd", "chain_tail_fwd",
                 "chain_tail_bwd", "dropout_masks")
TAIL_KERNELS = ("chain_tail_fwd", "chain_tail_bwd")
# the bf16 chain's variants, counted under their own names
BF16_K5 = ("dense_block_fwd_bf16", "dense_block_bwd_bf16",
           "chain_tail_fwd_bf16", "chain_tail_bwd_bf16")
# the element type of the bf16 instantiations in a demangled kernel name
# (bf16_t, a bf16 value's 16 bits)
BF16_ELEMENT = "unsigned short"
SOURCES = {name: "contrastiveprosthetics_torch/csrc/" + (
    "contrastive_loss" if name in TRAIN_KERNELS else
    "train_fused" if name in FUSED_KERNELS + BF16_K5 else
    "iir_rms" if name == "iir_rms_frames" else
    "encoder_chain" if name == "encoder_chain_bf16" else name) + ".cu"
    for name in REPLACES}
# the CUDA functions each port kernel launches, as named in a profiler trace
DEVICE_FUNCTIONS = {"dsp_frames_kernel": "dsp_frames",
                    "encoder_layer_large_kernel": "encoder_chain",
                    "encoder_layer_small_kernel": "encoder_chain",
                    "encoder_head_kernel": "encoder_chain",
                    "encoder_layer_large_bf16_kernel": "encoder_chain_bf16",
                    "encoder_layer_small_bf16_kernel": "encoder_chain_bf16",
                    "encoder_head_bf16_kernel": "encoder_chain_bf16",
                    "vote_scan_kernel": "vote_scan",
                    "contrastive_loss_fwd_kernel": "contrastive_loss_fwd",
                    "contrastive_loss_bwd_kernel": "contrastive_loss_bwd",
                    "dense_block_fwd_kernel": "dense_block_fwd",
                    "dense_block_bwd_kernel": "dense_block_bwd",
                    "chain_tail_fwd_kernel": "chain_tail_fwd",
                    "chain_tail_bwd_kernel": "chain_tail_bwd",
                    "dropout_masks_kernel": "dropout_masks",
                    "iir_rms_frames_kernel": "iir_rms_frames",
                    "adam_stacked_kernel": "adam_stacked"}
# kernel families of a train step, by (lower-case) name fragment, in the
# order they are tried
TRAIN_FAMILIES = (
    ("dense_block_fwd", ("dense_block_fwd",)),
    ("dense_block_bwd", ("dense_block_bwd",)),
    ("chain_tail_fwd", ("chain_tail_fwd",)),
    ("chain_tail_bwd", ("chain_tail_bwd",)),
    ("dropout_masks", ("dropout_masks",)),
    ("adam_stacked", ("adam_stacked",)),
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
SWEEP_TRACE_REPEATS = 2  # cut from 3 for phase 16's time
SWEEP_CHECK_STEPS = 5
ADAM_CHECK_UPDATES = 3  # stacked Adam updates a mu dtype, each checked
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
# (path, B, T, stride, n_frames) of iir_rms_frames in phase 2: one
# subject's ingest call through its row table into its two recordings, and
# all 46 subjects' in one call (each subject's table on its own rows); the
# same two as contiguous segments; a 2 s calibration recording; the compat
# uint8 mask (stride 1 up to index 252); 37 segments (an odd count: a CTA
# of one segment); T = W and T = W + stride - 1 (one frame each)
IIR_RMS_SHAPES = (("subject_rows", 246, 2010, 20, None),
                  ("corpus_rows", 46 * 246, 2010, 20, None),
                  ("subject", 246, 2010, 20, None),
                  ("corpus", 46 * 246, 2010, 20, None),
                  ("calibration", 1, 4000, 20, None),
                  ("compat", 246, 2010, 1, 253),
                  ("ragged", 37, 2010, 20, None),
                  ("one_window", 11, 11, 20, None),
                  ("one_stride", 11, 30, 20, None))
# the earlier iir_rms_frames (one thread a chain), device ms per launch on
# an H100 80GB HBM3 at 700 W (PERF.md section 6), printed beside this run's
ONE_THREAD_IIR_DEVICE_MS = {"subject": 0.13284, "corpus": 0.78483,
                            "calibration": 0.25767, "compat": 0.03962}
# iir_rms_frames against float64 scipy (sosfilt with the float64 sections,
# the window sum in float64): the f32 cascade rounds within 2e-5 of it on
# the CPU (tests/test_torch_port_ingest.py)
IIR_F64_RTOL, IIR_F64_ATOL = 1e-4, 1e-6
# phase 11: two DB2 and two DB3 subjects (tests/test_data.py:27), and the
# glove subjects that --synthetic_fixture writes
INGEST_POSITIONS = (0, 1, 40, 41)
# the device backend's artifacts against the scipy backend's: tighter than
# the JAX package's own device-vs-scipy check (rtol 5e-3, atol 2e-3,
# tests/test_data.py:68-73)
INGEST_RTOL, INGEST_ATOL = 1e-3, 1e-4
# phase 13: encoder_chain's bf16 variant against its plain version. Both
# round every dot's activations to bf16 (ties to even); their f32 sums run
# in other orders, and a sum within an f32 rounding of a bf16 boundary
# rounds to the other neighbour, one bf16 ulp (2^-8) of that activation,
# which the layers after it carry on. Scores are cosines in [-1, 1]; on
# this phase's frames (std 217 before the first layer) the plain version
# lies up to 0.014 from float64 on the same bf16 operands and the kernel
# 0.018 (this script on an H100 80GB HBM3 at 700 W). Elementwise the
# two are held at JAX's own absolute bound for bf16 scores (atol 0.05,
# test_pallas.py:226); that the kernel rounds no worse than the plain
# version is held against float64: its mean error at most BF16_F64_MEAN
# times the plain version's (measured 0.85) and its largest at most
# BF16_F64_MAX times (measured 1.28)
BF16_ATOL = 5e-2
BF16_F64_MEAN, BF16_F64_MAX = 1.25, 2.0
# phase 14: the bf16 K5 pair against its plain versions. Both compute h and
# dy in f32 with the same operations and round the GEMM operands to bf16
# the same way; their f32 sums run in other orders, so r and dx, rounded to
# bf16 after them, may land on the other bf16 neighbour: each element held
# within one bf16 ulp of the plain version's (of the larger magnitude),
# plus BF16_K5_ORDER_FLOOR x the largest |value| where a sum cancels to
# near 0 and two f32 orders differ by more than its own tiny ulp, and at
# most BF16_K5_FLIP_SHARE of the elements apart at all; JAX's own bf16
# bound (atol BF16_ATOL, test_train_fused.py:131-152) is reported beside.
# dW, db and the lower block's sums are f32 sums of the same exact
# products: held as the f32 K5b is (rtol 1e-4, atol 1e-5 x max). Against
# float64 on the same bf16 operands, the kernel's error (r and dx: largest
# and mean absolute; dW, db and the sums: relative 2-norm) is held at most
# BF16_K5_F64 times the plain version's plus BF16_K5_F64_FLOOR (r and dx)
# or one f32 order's error of the sum (k5_bf16_vs_f64): two f32 orders of
# the same sums, neither more accurate by construction
BF16_K5_F64, BF16_K5_F64_FLOOR = 1.25, 1e-7
BF16_K5_ORDER_FLOOR, BF16_K5_FLIP_SHARE = 2.0 ** -16, 0.05
CLI_SWEEP_CONFIGS = 10  # cptorch-train's --crossval_size default
TURN_STEPS = 50  # phase 14's steps a turn: 2/9 of an epoch
TWIN_EPOCHS = 1  # phase 15's go twin (go.sh runs 8)


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


def device_per_call(fn, n: int = 50,
                    only: str | None = None) -> tuple[float, float]:
    """Device milliseconds and CUDA kernel launches per call of ``fn`` from
    a profiler trace of ``n`` bare calls (the sum of the CUDA kernels'
    intervals over ``n``): the kernels' own time, without the wrapper's
    host work; with ``only``, of the kernels whose name holds it."""
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
                 if e.device_type == DeviceType.CUDA
                 and (only is None or only in e.name)]
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
            if family in FUSED_KERNELS and BF16_ELEMENT in low:
                return family + "_bf16"
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


def check_serve_kernels(K, cases, sm_clock_hz: float,
                        fadd_cycles: float) -> dict:
    """Phase 2, ``dsp_frames`` and ``vote_scan`` at every serve path's shape
    (``serve_cases``): each held bit for bit against its plain version,
    ``vote_scan`` with its masked-score output on and off; per path the
    wrapper and the plain version timed with CUDA events, the device time
    per launch from a profiler trace of bare calls, and the bound. For the
    one-session paths, ``dsp_frames`` also gets the recurrence floor of its
    IIR, as ``iir_rms_frames`` does: per sample, one section's 4 dependent
    f32 operations at ``fadd_cycles`` each (measured), at the SM's top
    clock. Returns the two ``kernels`` entries, at the batched shape on
    top."""
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
            entry["recurrence_floor_ms"] = recurrence_floor_ms(
                Kt * F, fadd_cycles, sm_clock_hz)
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


def iir_rms_oracle(x: torch.Tensor, sos64: np.ndarray, stride: int,
                   n: int, W: int) -> np.ndarray:
    """float64 scipy: ``sosfilt`` from zero state on the prescaled input,
    then the valid-mode RMS (the reference's trimmed ``uniform_filter1d``
    window) at every ``stride``-th sample, ``n`` frames."""
    from scipy import signal as ssig

    from contrastiveprosthetics_torch.config import INGEST_PRESCALE

    span = (n - 1) * stride + 1
    xn = x[:, :span + W - 1].double().cpu().numpy() * INGEST_PRESCALE
    sq = np.square(ssig.sosfilt(sos64, xn, axis=1))
    return np.sqrt(sum(sq[:, k:k + span:stride] for k in range(W)) / W)


def recurrence_floor_ms(samples: int, fadd_cycles: float,
                        sm_clock_hz: float) -> float:
    """The least time of a band-pass over ``samples`` samples in order:
    per sample, one section's loop-carried line of 4 dependent f32
    operations (z0 -> yk -> a1*yk -> - -> + z1), each taking
    ``fadd_cycles`` (the card's dependent f32 add latency, measured), at
    the SM's top clock."""
    return samples * 4 * fadd_cycles / sm_clock_hz * 1e3


def subject_recordings(cfg, root: str):
    """One subject's two exercise files at the full geometry (DB2 subject
    position 0, as ``--synthetic_fixture`` writes them), read back as the
    ingest reads them: returns ``Es`` and the row table of its 246
    segments (``_segment_rows``)."""
    from contrastiveprosthetics_torch.data import ingest, synthetic

    synthetic.write_emg_mat_files(root, cfg, [0])
    dbnum, p_dir = ingest._person_location(cfg, int(cfg.people()[0]))
    Es = tuple(ingest._load_emg_mat(root, dbnum, p_dir, ex)
               for ex in ("1", "2"))
    return Es, ingest._segment_rows(cfg, Es)


def check_iir_rms(K, dev, sos, sm_clock_hz: float,
                  fadd_cycles: float) -> dict:
    """Phase 2, ``iir_rms_frames`` at each of ``IIR_RMS_SHAPES`` on seeded
    EMG-scale input made on the card, and through row tables: one
    subject's two recordings (the ingest's call) and the corpus's 46
    subjects' recordings in one call. Each bit for bit against its plain
    version (on ``x[rows]`` for a table), the same bits on a rerun, and
    (all but the corpus) against float64 scipy; the wrapper timed by CUDA
    events (with a table: its range check included), the kernel's device
    time per launch from a profiler trace of bare calls, the plain version
    once, beside the bound (bytes of the samples the frames use, of the
    table's entries they use and of the frames, or f32 operations), the
    recurrence floor (``recurrence_floor_ms`` of the samples the frames
    use) and the earlier design's device time. Returns the ``kernels``
    entry, at one subject's shape on top."""
    from contrastiveprosthetics_torch.config import DEFAULT_CONFIG as cfg
    from contrastiveprosthetics_torch.ops.signal import butter_bandpass_sos

    sos64 = butter_bandpass_sos(20, 450, cfg.hz)
    n_sec, W, D = sos.shape[0], cfg.rms_window, cfg.emg_dim
    gen = torch.Generator(device=dev).manual_seed(11)
    reps = {"subject": 50, "corpus": 5, "calibration": 50,
            "subject_rows": 50, "corpus_rows": 5}
    with tempfile.TemporaryDirectory() as root:
        Es, rows = subject_recordings(cfg, root)
    per_subject = sum(E[0].shape[0] for E in Es)
    subject_x = np.empty((per_subject, D), np.float32)
    np.concatenate([E[0] for E in Es], out=subject_x)
    subject_rows = torch.from_numpy(rows).to(dev)
    del Es
    by_shape = {}
    for path, B, T, stride, n_frames in IIR_RMS_SHAPES:
        table = None
        if path == "subject_rows":
            x, table = torch.from_numpy(subject_x).to(dev), subject_rows
        elif path == "corpus_rows":  # each subject's table on its rows
            x = torch.randn((B // len(rows) * per_subject, D), generator=gen,
                            device=dev) * 1e-4
            table = (subject_rows + per_subject * torch.arange(
                B // len(rows), dtype=torch.int32, device=dev)[:, None, None]
            ).reshape(B, T)
        else:
            gain = torch.rand((B, 1, D), generator=gen, device=dev) * 2.8 + 0.2
            x = (torch.randn((B, T, D), generator=gen, device=dev) * gain
                 * 1e-4).contiguous()
        got = K.iir_rms_frames(x, sos, stride, n_frames, rows=table)
        want = K.iir_rms_frames_reference(x, sos, stride, n_frames, table)
        again = K.iir_rms_frames(x, sos, stride, n_frames, rows=table)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"iir_rms_frames differs from its plain "
                                 f"version at {path}: {max_abs(got, want)}")
        if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
            raise AssertionError(f"iir_rms_frames rerun differs at {path}")
        n = got.shape[1]
        t_used = (n - 1) * stride + W
        f64 = None
        if not path.startswith("corpus"):
            xs = x if table is None else x[table.long()]
            ref = iir_rms_oracle(xs, sos64, stride, n, W)
            err = np.abs(got.double().cpu().numpy() - ref)
            scale = float(np.abs(ref).max())
            bad = err > IIR_F64_RTOL * np.abs(ref) + IIR_F64_ATOL * scale
            if bad.any():
                raise AssertionError(f"iir_rms_frames at {path}: {bad.sum()} "
                                     f"frames off float64 scipy, max "
                                     f"{err.max()}")
            f64 = dict(max_abs=float(err.max()), max_rel=float(
                (err / np.maximum(np.abs(ref), 1e-30)).max()), scale=scale)
            del xs
        call = functools.partial(K.iir_rms_frames, x, sos, stride, n_frames,
                                 rows=table)
        dev_ms, dev_launches = device_per_call(call, 20,
                                               only="iir_rms_frames_kernel")
        b, by = bound_ms(B * t_used * D * 4 + nbytes(got, sos)
                         + (B * t_used * 4 if table is not None else 0),
                         B * D * (t_used * (2 + 9 * n_sec) + n * (W + 1)))
        by_shape[path] = dict(
            shape=f"B={B} T={T} D={D} stride={stride} frames={n}"
                  + (f", rows of {x.shape[0]}" if table is not None else ""),
            max_abs_err=0.0, float64=f64,
            ms=time_ms(call, reps.get(path, 20), 2),
            plain_ms=time_ms(lambda: K.iir_rms_frames_reference(
                x, sos, stride, n_frames, table), 1, 0),
            device_ms_per_launch=dev_ms / dev_launches,
            device_launches_per_call=dev_launches,
            bound_ms=b, bound_by=by,
            recurrence_floor_ms=recurrence_floor_ms(t_used, fadd_cycles,
                                                    sm_clock_hz))
        del x, got, want, again, table
    log(f"[kernels] iir_rms_frames bit-identical to its plain version and "
        f"on rerun at {', '.join(by_shape)}, within rtol {IIR_F64_RTOL}, "
        f"atol {IIR_F64_ATOL} x max of float64 scipy; dependent f32 add "
        f"{fadd_cycles:.4f} cycles at {sm_clock_hz / 1e6:.0f} MHz; the "
        f"earlier one-thread-a-chain design, device ms per launch "
        f"(PERF.md): "
        f"{json.dumps(ONE_THREAD_IIR_DEVICE_MS)}: {json.dumps(by_shape)}")
    top = by_shape["subject_rows"]
    return dict(
        route="cuda", max_abs_err=0.0,
        tolerance=("exact (same operation order as the plain version, each "
                   f"step rounded); against float64 scipy rtol "
                   f"{IIR_F64_RTOL} + atol {IIR_F64_ATOL} x max"),
        ms=top["ms"], plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
        bound_by=top["bound_by"],
        recurrence_floor_ms=top["recurrence_floor_ms"],
        fadd_latency_cycles=fadd_cycles,
        device_ms_per_launch=top["device_ms_per_launch"], library_ms=None,
        library_note="no single PyTorch call computes it: an IIR cascade "
                     "along time, then a windowed RMS at a stride",
        shape=top["shape"], by_shape=by_shape,
        bound_ms_by_shape={p: e["bound_ms"] for p, e in by_shape.items()},
        ptxas=ptxas_report("iir_rms"))


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


def within_one_bf16_ulp(got: torch.Tensor, want: torch.Tensor) -> float:
    """Raises unless each element of bf16 ``got`` lies within one bf16 ulp
    of bf16 ``want`` (of the larger magnitude's) plus
    ``BF16_K5_ORDER_FLOOR`` x max |want|, and at most
    ``BF16_K5_FLIP_SHARE`` of them differ; returns the share that differs."""
    g, w = got.float(), want.float()
    big = torch.maximum(g.abs(), w.abs())
    ulp = torch.exp2(torch.floor(torch.log2(torch.where(big > 0, big, 1.0)))
                     - 7)
    floor = BF16_K5_ORDER_FLOOR * float(w.abs().max())
    over = float(((g - w).abs() / (ulp + floor)).max())
    share = float((g != w).float().mean())
    if over > 1.0 or share > BF16_K5_FLIP_SHARE:
        raise AssertionError(f"bf16 values {over:.3g} ulps off, {share:.3g} "
                             f"of them apart (max abs {max_abs(g, w)})")
    return share


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
    index matrices from each config's generator (the glove task
    permutations too, None in the one-hot modes) and a chunk generator
    for the dropout masks, as ``Trainer.sweep_chunk`` makes them."""
    from contrastiveprosthetics_torch.data.sampler import (
        stacked_epoch_batches,
    )
    from contrastiveprosthetics_torch.train import engine
    from contrastiveprosthetics_torch.train.crossval import config_seed

    C = len(hyper.lr_emg)
    gens = [trainer.generator(config_seed(seed, i)) for i in range(C)]
    state = trainer.init_sweep_state(gens)
    h = engine.Hyper(*[torch.as_tensor(np.asarray(x, np.float32),
                                       device=trainer.device) for x in hyper])
    v = trainer.view_train
    emg_rand, glove_rand = trainer._stacked_permutations(gens, v)
    batches, _ = stacked_epoch_batches(gens, v.D, trainer.batch_size)
    return (state, h, emg_rand, batches,
            trainer.generator(config_seed(seed, 0, stream=1)), glove_rand)


def run_sweep_steps(trainer, inputs, start: int, n: int, tail: int = 0):
    """Stacked steps over batches ``start`` to ``start + n`` of
    :func:`sweep_inputs`; with ``tail``, the last of them trains only its
    first ``tail`` items, as an epoch's tail does."""
    state, h, emg_rand, batches, gen, glove_rand = inputs
    part = batches[:, start:start + n]
    last = part[:, :0, 0]
    if tail:
        part, last = part[:, :-1], part[:, -1, :tail]
    return trainer.sweep_epoch_from_indices(state, emg_rand, part, last, h,
                                            1.0, 1.0, gen, glove_rand)


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
    state, h, emg_rand, batches, _, _ = inputs
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


def sweep_trace(K, trainer, hypers, C: int,
                repeats: int = SWEEP_TRACE_REPEATS) -> dict:
    """Phase 9, part 3: profiler traces of 10 stacked steps of C configs
    (the last a 5-item tail step) with dropout, taken ``repeats`` times
    on one state. K1f and K1b must launch once per stacked step, and
    ``adam_stacked`` once a live tower, by their wrappers' counts. The breakdown is the first trace's; the
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
        k1.append({k: K.launch_counts[k] / n
                   for k in (*TRAIN_KERNELS, *AXIS_K5, "adam_stacked")})

    for _ in range(repeats):
        traces.append(trace_families(
            lambda: run_sweep_steps(trainer, inputs, 0, 2), run, n))
    if any(per[k] != 1.0 for per in k1 for k in TRAIN_KERNELS):
        raise AssertionError(f"K1 launches per stacked step at C={C}: {k1}")
    state = inputs[0]
    live = sum(opt.flat is not None for opt in (state.opt_emg,
                                                state.opt_glove))
    if any(per["adam_stacked"] != live for per in k1):
        raise AssertionError(f"adam_stacked launches per stacked step at "
                             f"C={C}: {k1}, want one a live tower ({live})")
    trace = traces[0]
    trace["configs"] = C
    trace["k1_wrapper_launches_per_step"] = {k: k1[0][k]
                                             for k in TRAIN_KERNELS}
    trace["wrapper_launches_per_step"] = k1[0]
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
    results, the K1 and ``adam_stacked`` launch counts of the 150-config
    ``cross_validate`` and the trace of its stacked step at C=150."""
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
    all_counts = dict(K.launch_counts)
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
        launches=all_counts,
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
    counts["adam_stacked"] = all_counts["adam_stacked"]
    return res, counts, traces[n]


def check_adam_stacked(K, dev) -> dict:
    """The stacked Adam kernel against its plain version at the sweep's
    shape: C=150 configs of the EMG tower (37 parameters, 2,022,848
    elements a config), a distinct lr a config, an f32 and a bf16 ``mu``.
    From one state, ``ADAM_CHECK_UPDATES`` updates each way (steps 1 to
    3's bias corrections, gradients of another scale each step, exact
    zeros among them): parameters, mu and nu bit for bit
    (``torch.equal``) after each. Launches counted from a reset just
    before those updates: one a call, bf16-mu ones under
    ``adam_stacked_bf16_mu`` too. Times: CUDA-event means of a wrapper
    call, kernel and plain version in turns (kernel, plain, plain,
    kernel); device time a launch, the mean of the launches a profiler
    trace kept; ``bound_ms`` from 28 bytes an element with an f32 mu and
    24 with a bf16 one (p, g, mu and nu read once, p, mu and nu written
    once) at 3.35 TB/s, which no launch can beat. Returns
    the f32 mu's ``kernels`` entry, the bf16 mu's under ``bf16_mu``."""
    from contrastiveprosthetics_torch.models.clip import ContrastiveModel
    from contrastiveprosthetics_torch.train.engine import stacked_adam_init

    C = SWEEP_CONFIGS
    gen = torch.Generator(device=dev).manual_seed(24)
    params = [torch.randn((C, *p.shape), generator=gen, device=dev)
              for p in ContrastiveModel().towers()["emg_net"].parameters()]
    N = sum(p[0].numel() for p in params)
    lr = torch.linspace(1e-4, 3e-3, C, device=dev)
    out = {}
    for name, mu_dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        ours = [p.clone() for p in params]
        plain = [p.clone() for p in params]
        st_k, st_p = (stacked_adam_init(x, mu_dtype) for x in (ours, plain))
        K.reset_launch_counts()
        for step in range(1, ADAM_CHECK_UPDATES + 1):
            grads = [torch.randn(p.shape, generator=gen, device=dev)
                     * 10.0 ** -(step % 3 + 1) for p in params]
            for g in grads:
                g.view(-1)[::7] = 0
            t = np.float32(step)
            bc1 = float(np.float32(1) - np.float32(0.9) ** t)
            bc2 = float(np.float32(1) - np.float32(0.999) ** t)
            K.adam_stacked(ours, grads, st_k, lr, bc1, bc2)
            K.adam_stacked_reference(plain, grads, st_p, lr, bc1, bc2)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(
                    ours + list(st_k.flat), plain + list(st_p.flat))):
                raise AssertionError(f"adam_stacked, {name} mu, not "
                                     f"bit-equal to its plain version at "
                                     f"step {step}")
        launches = K.launch_counts["adam_stacked"]
        low = K.mode_counts["adam_stacked_bf16_mu"]
        want = ADAM_CHECK_UPDATES
        if (launches, low) != (want, want if name == "bf16" else 0):
            raise AssertionError(f"adam_stacked, {name} mu: {launches} "
                                 f"launches ({low} bf16-mu) for {want} calls")
        err = max(max_abs(a, b) for a, b in zip(ours + list(st_k.flat),
                                                plain + list(st_p.flat)))
        del plain, st_p

        def kernel():
            K.adam_stacked(ours, grads, st_k, lr, bc1, bc2)

        def reference():
            K.adam_stacked_reference(ours, grads, st_k, lr, bc1, bc2)

        turns = {"kernel": [], "plain": []}
        for who in ("kernel", "plain", "plain", "kernel"):
            turns[who].append(time_ms(kernel if who == "kernel"
                                      else reference, reps=20, warmup=2))
        # a launch's device time from the records the trace kept: a trace
        # on an H100 kept 12 of 20 launches, so the sum over calls read low
        # (``device_records_per_call`` says how many it kept)
        total_ms, records = device_per_call(kernel, n=20, only="adam_stacked")
        device_ms = total_ms / records
        bd, by = bound_ms(C * N * (20 + 2 * mu_dtype.itemsize),
                          15.0 * C * N)
        if bd > 1.05 * device_ms:
            raise AssertionError(f"adam_stacked, {name} mu: {device_ms} ms "
                                 f"a launch, under its bound {bd} ms")
        out[name] = dict(
            route="cuda", max_abs_err=err,
            tolerance="parameters, mu and nu bit for bit (torch.equal)",
            ms=statistics.median(turns["kernel"]),
            plain_ms=statistics.median(turns["plain"]),
            ms_in_turns=turns["kernel"], plain_ms_in_turns=turns["plain"],
            device_ms=device_ms, device_records_per_call=records,
            bound_ms=bd, bound_by=by, roofline_share=bd / device_ms,
            bytes_per_s=C * N * (20 + 2 * mu_dtype.itemsize)
            / device_ms * 1e3,
            library_ms=None,
            library_note=("torch.optim's fused Adam orders the bias "
                          "correction otherwise and takes a scalar lr"),
            launches_checked=launches, bf16_mu_launches_checked=low,
            shape=f"C={C} x N={N} (the EMG tower), {name} mu")
        log(f"[kernels] adam_stacked, {name} mu, at C={C} x N={N}: "
            f"bit-equal to its plain version over {want} updates, "
            f"{launches} launches; {json.dumps(out[name])}")
        del ours, st_k, grads
    entry = out["f32"]
    entry["bf16_mu"] = out["bf16"]
    return entry


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


def recording_copy_ms(cfg, root: str, dev) -> dict:
    """One subject's two recordings (position 0's ``.mat`` files under
    ``root``) to the card as one (N, 12) f32 tensor, two ways, timed in
    turns by the host clock (synchronised), 3 times each: cast and laid
    end to end on the host, then one copy; or copied as float64, laid end
    to end and cast on the card (the ingest's way). Both give the same
    bits."""
    from contrastiveprosthetics_torch.data import ingest

    dbnum, p_dir = ingest._person_location(cfg, int(cfg.people()[0]))
    Es = [ingest._load_emg_mat(root, dbnum, p_dir, ex)[0] for ex in "12"]

    def on_host():
        x = np.empty((sum(e.shape[0] for e in Es), cfg.emg_dim), np.float32)
        np.concatenate(Es, out=x)
        return torch.from_numpy(x).to(dev)

    def on_card():
        return torch.cat([torch.from_numpy(e).to(dev) for e in Es]).float()

    out = {"host_cast": [], "card_cast": []}
    for _ in range(3):
        for name, fn in (("host_cast", on_host), ("card_cast", on_card)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out[name].append((time.perf_counter() - t0) * 1e3)
    if not torch.equal(on_host(), on_card()):
        raise AssertionError("the two casts of the recordings differ")
    return out


def ingest_phase(K, dev) -> tuple[dict, dict]:
    """Phase 11, ingest from raw ``.mat`` files at the full per-subject
    geometry (41 stimuli x 6 reps x 2,020 samples x 12 channels) for
    ``INGEST_POSITIONS`` and glove subjects 28-29, in a temporary
    directory: ``cptorch-load --synthetic_fixture --load --info`` on cuda
    (one ``iir_rms_frames`` launch per subject), the same ingest with
    ``--backend scipy`` (float64) as the yardstick, the per-subject times
    of a second device run (``.mat`` read, segment extraction,
    preprocessing, statistics), ``emg.npz`` through ``DeviceStore.load``
    on the card, then ``cptorch-train`` on that store. Returns the
    ``ingest`` results and the launch counts of the CLI's run."""
    from contrastiveprosthetics_torch.cli import load as cli_load
    from contrastiveprosthetics_torch.cli import train as cli_train
    from contrastiveprosthetics_torch.config import DEFAULT_CONFIG as cfg
    from contrastiveprosthetics_torch.data.ingest import ingest_emg
    from contrastiveprosthetics_torch.data.store import DeviceStore
    from contrastiveprosthetics_torch.models.convert import (
        load_reference_checkpoint,
        model_from_state_dict,
    )

    from contrastiveprosthetics_torch.data import ingest

    t_phase = time.perf_counter()
    people = [str(p) for p in INGEST_POSITIONS]
    n_people = len(people)
    with tempfile.TemporaryDirectory() as root:
        data, data_f64 = os.path.join(root, "data"), os.path.join(root, "f64")

        def host_masks(*args, **kwargs):
            raise AssertionError("the device ingest extracted a segment on "
                                 "the host")

        K.reset_launch_counts()
        extract, ingest._extract_segment = ingest._extract_segment, host_masks
        try:
            t0 = time.perf_counter()
            rc = cli_load.main(["--synthetic_fixture", "--root", root,
                                "--people", *people, "--load", "--data_dir",
                                data, "--info"])
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t0
        finally:
            ingest._extract_segment = extract
        counts = dict(K.launch_counts)
        if rc != 0:
            raise AssertionError("cptorch-load on cuda failed")
        if counts["iir_rms_frames"] != n_people:
            raise AssertionError(f"cptorch-load launched iir_rms_frames "
                                 f"{counts['iir_rms_frames']} times for "
                                 f"{n_people} subjects")
        mat_bytes = sum(os.path.getsize(os.path.join(d, f))
                        for d, _, files in os.walk(root) for f in files
                        if f.endswith(".mat"))
        t0 = time.perf_counter()
        if cli_load.main(["--root", root, "--people", *people, "--load",
                          "--no_glove", "--backend", "scipy", "--data_dir",
                          data_f64]) != 0:
            raise AssertionError("cptorch-load --backend scipy failed")
        scipy_s = time.perf_counter() - t0

        with np.load(os.path.join(data, "emg.npz")) as z:
            emg, positions = z["emg"], z["people_positions"]
        with np.load(os.path.join(data_f64, "emg.npz")) as z:
            emg_f64 = z["emg"]
        shape = (n_people, cfg.max_tasks, cfg.max_reps,
                 cfg.final_window_size, cfg.emg_dim)
        if emg.shape != shape or emg.dtype != np.float32:
            raise AssertionError(f"emg.npz: {emg.shape} {emg.dtype}")
        if positions.tolist() != list(INGEST_POSITIONS):
            raise AssertionError(f"people_positions {positions}")
        if not np.isfinite(emg).all():
            raise AssertionError("non-finite ingested EMG")
        err = np.abs(emg.astype(np.float64) - emg_f64)
        bad = err > INGEST_RTOL * np.abs(emg_f64) + INGEST_ATOL
        if bad.any():
            raise AssertionError(f"{bad.sum()} ingested values off the "
                                 f"scipy backend's, max {err.max()}")
        stats_err = {}
        for name, rtol in (("emg_mean", 1e-4), ("emg_std", 1e-3)):
            a = np.load(os.path.join(data, name + ".npy"))
            b = np.load(os.path.join(data_f64, name + ".npy"))
            stats_err[name] = float(np.max(np.abs(a - b) / np.abs(b)))
            if stats_err[name] > rtol:
                raise AssertionError(f"{name} off the scipy backend's: "
                                     f"{stats_err[name]}")

        # per-subject times, a second run (the first paid the load of the
        # kernel's library); its bits equal the CLI's run and a run of the
        # plain version on the CPU, statistics included
        res = ingest_emg(cfg, root, os.path.join(root, "again"),
                         list(INGEST_POSITIONS), device=dev, verbose=False)
        if not np.array_equal(res["emg"], emg):
            raise AssertionError("a second device ingest gave other bits")
        t0 = time.perf_counter()
        on_cpu = ingest_emg(cfg, root, os.path.join(root, "cpu"),
                            list(INGEST_POSITIONS), device="cpu",
                            verbose=False)
        cpu_s = time.perf_counter() - t0
        for name in ("emg", "mean", "std"):
            if not np.array_equal(on_cpu[name], res[name]):
                raise AssertionError(f"the card's {name} differs from the "
                                     "CPU run's")
        for name in ("emg_mean.npy", "emg_std.npy"):
            if not np.array_equal(np.load(os.path.join(data, name)),
                                  np.load(os.path.join(root, "cpu", name))):
                raise AssertionError(f"{name}: the card's and the CPU's "
                                     "differ")
        copies = recording_copy_ms(cfg, root, dev)

        store = DeviceStore.load(cfg, data, device=dev)
        want = torch.from_numpy(np.ascontiguousarray(
            np.transpose(emg, (1, 0, 2, 3, 4)))).to(dev)
        if not (store.emg.device.type == dev.type
                and torch.equal(store.emg, want)
                and store.people_positions.tolist() == list(INGEST_POSITIONS)
                and tuple(store.glove.shape) == (
                    cfg.max_tasks, 2 * cfg.max_reps * cfg.glove_window_size,
                    cfg.glove_dim)):
            raise AssertionError("DeviceStore.load of the ingested artifacts")
        views = {}
        for split in ("train", "val", "test"):
            v = store.view(split)
            v.check_indexing()
            views[split] = dict(n_people=v.n_people, n_reps=v.n_reps, D=v.D)

        ckpt = os.path.join(root, "ckpt")
        t0 = time.perf_counter()
        if cli_train.main(["--data_dir", data, "--checkpoint_dir", ckpt,
                           "--crossval_size", "3", "--final_epochs", "1",
                           "--batch_size", "8", "--test"]) != 0:
            raise AssertionError("cptorch-train on the ingested store failed")
        train_s = time.perf_counter() - t0
        model_from_state_dict(load_reference_checkpoint(
            os.path.join(ckpt, "contrastive.pt")))
        sweep = np.load(os.path.join(data, "cross_val_values.npy"))
        if sweep.shape != (3, 2) or not np.isfinite(sweep[:, 0]).any():
            raise AssertionError(f"the sweep's values: {sweep}")
    phase_s = time.perf_counter() - t_phase
    timings = res["timings"]
    per_subject = {k: float(np.mean([t[k] for t in timings]))
                   for k in ("read_s", "extract_s", "preprocess_s", "stats_s")}
    log(f"[ingest] cptorch-load of {n_people} subjects on cuda "
        f"({mat_bytes / 1e6:.1f} MB of .mat) in {cli_s:.2f} s, "
        f"iir_rms_frames launched {counts['iir_rms_frames']} times, no "
        f"segment extracted on the host; the scipy backend {scipy_s:.2f} s; "
        f"max |device - scipy| {float(err.max()):.3g} (rtol {INGEST_RTOL}, "
        f"atol {INGEST_ATOL}); emg.npz and statistics bit-equal to a CPU "
        f"run ({cpu_s:.2f} s); per subject (mean of {n_people}, second "
        f"run; extract_s is the row table, preprocess_s the copies and the "
        f"kernel): {json.dumps(per_subject)}; one subject's recordings to "
        f"the card, cast on the host or on the card (ms, in turns): "
        f"{json.dumps(copies)}; cptorch-train --crossval_size 3 "
        f"--final_epochs 1 --batch_size 8 --test on the store {train_s:.2f} "
        f"s; phase 11 took {phase_s:.1f} s")
    return dict(positions=list(INGEST_POSITIONS), mat_bytes=mat_bytes,
                cli_s=cli_s, scipy_backend_s=scipy_s, cpu_run_s=cpu_s,
                recording_copy_ms=copies,
                max_abs_vs_scipy=float(err.max()),
                tolerance=f"rtol {INGEST_RTOL}, atol {INGEST_ATOL}",
                stats_rel_err=stats_err, per_subject_mean=per_subject,
                per_subject=timings, views=views, train_s=train_s,
                sweep_values=sweep.tolist(), launches=counts,
                phase_s=phase_s), counts


# ------------------------------------------------------------ 12. the modes
MODES = {"prediction": dict(prediction=True),
         "glove_prediction": dict(prediction=True, glove=True),
         "glove_encoding": dict(glove_encoding=True),
         "glove_encoding_fused": dict(glove_encoding=True,
                                      use_fused_train=True)}
# a forward on the CPU in float64 against the card's in f32: the loss of a
# step in the baseline (no kernel runs there), as phase 7 holds its K1 pair
MODES_F64_LOSS_RTOL = 1e-5


def mode_batch(trainer, seed: int, bs: int = 8):
    """One train batch of ``trainer``'s mode from a seeded generator: (B,
    T, emg_dim) EMG windows and, where the mode reads them, (B, T,
    glove_dim) glove rows (else None)."""
    from contrastiveprosthetics_torch.data.sampler import (
        gather_glove_batch,
        gather_train_batch,
    )

    v = trainer.view_train
    gen = trainer.generator(seed)
    emg_rand, glove_rand = trainer._permutations(gen, v)
    items = torch.randperm(v.D, generator=gen, device=trainer.device)[:bs]
    glove_b = None
    if trainer.reads_glove:
        glove_b = gather_glove_batch(v.glove_flat, glove_rand, items,
                                     v.D_glove)
    return gather_train_batch(v.emg_flat, emg_rand, items), glove_b


def modes_step_check(K, trainers) -> dict:
    """Phase 12, part 1: one step per mode at dropout 0 against a
    reference step: in glove encoding the step with the K1 kernels against
    the step with the plain loss (phase 7's tolerance); in the baseline,
    which runs no kernel, the card's f32 step against the same step in
    float64 on the CPU (the loss; the gradients' distance is reported)."""
    from contrastiveprosthetics_torch.train import engine

    hyper0 = engine.Hyper.single(1e-3, 1e-6, 0.0, 1e-3, 1e-6, 0.0)
    out = {}
    for mode in ("prediction", "glove_prediction", "glove_encoding"):
        trainer = trainers[mode]
        emg_b, glove_b = mode_batch(trainer, 7)
        if mode == "glove_encoding":
            steps = {}
            for name, loss_fn in (("kernel", K.fused_contrastive_loss),
                                  ("plain", K.fused_contrastive_reference)):
                engine.fused_contrastive_loss = loss_fn
                try:
                    state = trainer.init_state(trainer.generator(0))
                    steps[name] = trainer.loss_and_grads(
                        state, emg_b, hyper0, None, glove_b=glove_b)
                finally:
                    engine.fused_contrastive_loss = K.fused_contrastive_loss
            torch.cuda.synchronize()
            (loss_k, acc_k, grads_k), (loss_p, acc_p, grads_p) = (
                steps["kernel"], steps["plain"])
            torch.testing.assert_close(loss_k, loss_p, rtol=1e-5, atol=0)
            err = 0.0
            for tower in grads_k:
                if not grads_k[tower]:
                    raise AssertionError(f"glove encoding trains no "
                                         f"{tower} parameters")
                for a, b in zip(grads_k[tower], grads_p[tower]):
                    torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
                    err = max(err, max_abs(a, b))
            out[mode] = dict(loss_kernel=float(loss_k),
                             loss_plain=float(loss_p),
                             max_grad_abs_err=err, tolerance="loss rtol "
                             "1e-5, grads rtol 1e-4 atol 1e-6 (phase 7's)")
            continue
        state = trainer.init_state(trainer.generator(0))
        ref = engine.TrainState.fresh(copy.deepcopy(state.model).cpu()
                                      .double())
        loss, acc, grads = trainer.loss_and_grads(state, emg_b, hyper0, None,
                                                  glove_b=glove_b)
        loss64, acc64, grads64 = trainer.loss_and_grads(
            ref, emg_b.cpu().double(), hyper0, None,
            glove_b=None if glove_b is None else glove_b.cpu().double())
        torch.cuda.synchronize()
        np.testing.assert_allclose(float(loss), float(loss64),
                                   rtol=MODES_F64_LOSS_RTOL)
        rel = [float((a.cpu().double() - b).norm()
                     / b.norm().clamp_min(1e-30))
               for tower in grads for a, b in zip(grads[tower],
                                                  grads64[tower])]
        trained = {t: len(g) for t, g in grads.items()}
        want_idle = "emg_net" if mode == "glove_prediction" else "glove_net"
        if trained[want_idle] or not all(
                n for t, n in trained.items() if t != want_idle):
            raise AssertionError(f"{mode} trains {trained} parameter "
                                 f"tensors by tower")
        out[mode] = dict(loss=float(loss), loss_float64_cpu=float(loss64),
                         acc=float(acc), acc_float64_cpu=float(acc64),
                         max_grad_rel_l2_to_float64=max(rel),
                         tensors_by_tower=trained,
                         tolerance=f"loss rtol {MODES_F64_LOSS_RTOL} "
                                   "against float64; gradients reported")
    log(f"[modes] one step per mode at dropout 0: {json.dumps(out)}")
    return out


def modes_stacked_check(K, trainers) -> dict:
    """Phase 12, part 4: a stacked step of 3 configs at dropout 0 in each
    mode (each config its own lr, reg, EMG and glove batch) against the 3
    single steps, in float64 on the card (the plain loss: K1 takes f32):
    the losses, every gradient and every parameter and statistic after
    both Adam chains, within SWEEP_F64_RTOL."""
    from contrastiveprosthetics_torch.data.sampler import (
        stacked_gather_glove_batch,
        stacked_gather_train_batch,
    )
    from contrastiveprosthetics_torch.train import engine

    table = np.array(SWEEP_STEP_HYPERS, np.float64)
    dev = trainers["prediction"].device

    def rel_l2(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-300))

    out = {}
    engine.fused_contrastive_loss = K.fused_contrastive_reference
    try:
        for mode in ("prediction", "glove_prediction", "glove_encoding"):
            trainer = trainers[mode]
            state, _, emg_rand, batches, _, glove_rand = sweep_inputs(
                trainer, engine.Hyper(*table.T.astype(np.float32)), seed=3)
            base = copy.deepcopy(state.model).double()
            v = trainer.view_train
            emg_b = stacked_gather_train_batch(v.emg_flat, emg_rand,
                                               batches[:, 0]).double()
            glove_b = None
            if trainer.reads_glove:
                glove_b = stacked_gather_glove_batch(
                    v.glove_flat, glove_rand, batches[:, 0],
                    v.D_glove).double()
            h = engine.Hyper(*[torch.as_tensor(x, device=dev)
                               for x in table.T])
            loss, _, grads = trainer.loss_and_grads(
                engine.TrainState.fresh(copy.deepcopy(base)), emg_b, h, None,
                glove_b=glove_b)
            stepped = engine.TrainState.fresh(copy.deepcopy(base))
            trainer._sgd_step(stepped, emg_b, h, h.lr_emg, h.lr_glove, None,
                              glove_b=glove_b)
            worst = dict(loss=0.0, grads=0.0, state=0.0)
            for c in range(len(table)):
                hc = engine.Hyper(*[float(x) for x in table[c]])
                gb = None if glove_b is None else glove_b[c]
                single = engine.TrainState.fresh(base.unstack(c).double())
                loss_c, _, grads_c = trainer.loss_and_grads(
                    single, emg_b[c], hc, None, glove_b=gb)
                worst["loss"] = max(worst["loss"], abs(
                    float(loss[c]) / float(loss_c) - 1))
                for tower in grads_c:
                    for a, b in zip(grads[tower], grads_c[tower]):
                        worst["grads"] = max(worst["grads"], rel_l2(a[c], b))
                single = engine.TrainState.fresh(base.unstack(c).double())
                trainer._sgd_step(single, emg_b[c], hc, hc.lr_emg,
                                  hc.lr_glove, None, glove_b=gb)
                for a, b in zip(stepped.model.state_dict().values(),
                                single.model.state_dict().values()):
                    if a.is_floating_point():
                        worst["state"] = max(worst["state"], rel_l2(a[c], b))
            if max(worst.values()) > SWEEP_F64_RTOL:
                raise AssertionError(f"{mode}: float64 stacked step against "
                                     f"the single steps {worst}")
            out[mode] = dict(worst_rel=worst, losses=loss.tolist())
    finally:
        engine.fused_contrastive_loss = K.fused_contrastive_loss
    out["tolerance"] = (f"loss, each gradient tensor and each parameter or "
                        f"statistic after Adam at a relative 2-norm of "
                        f"{SWEEP_F64_RTOL}")
    log(f"[modes] stacked step of 3 configs against 3 single steps in "
        f"float64: {json.dumps(out)}")
    return out


def modes_phase(K, eager, train_res) -> tuple[dict, dict]:
    """Phase 12, the softmax baseline and the glove modes on phase 7's
    store (bs 8, plain BatchNorm, full width). Returns the ``modes``
    results and the kernels' launch counts over the modes' ``train_loop``
    runs and the glove-encoding sweep."""
    import warnings

    from contrastiveprosthetics_torch.cli import results as cli_results
    from contrastiveprosthetics_torch.cli import train as cli_train
    from contrastiveprosthetics_torch.models.convert import (
        load_reference_checkpoint,
        model_from_state_dict,
    )
    from contrastiveprosthetics_torch.train import crossval, engine
    from contrastiveprosthetics_torch.train.loop import run_test, train_loop

    t_phase = time.perf_counter()
    widths = dict(n_linear=eager.n_linear, hidden=eager.hidden,
                  conv_features=eager.conv_features)
    trainers = {mode: engine.Trainer(eager.cfg, eager.store, adabn=False,
                                     batch_size=8, **widths, **kw)
                for mode, kw in MODES.items()}
    v = eager.view_train
    steps_per_epoch = -(-v.D // eager.batch_size)
    n_steps = TRAIN_EPOCHS * steps_per_epoch
    windows = eager.batch_size * v.n_tasks * steps_per_epoch
    parts_s = {}
    t0 = time.perf_counter()
    step_check = modes_step_check(K, trainers)
    parts_s["step_check"] = time.perf_counter() - t0

    # 2. train_loop and run_test per mode; the baseline asks for the fused
    # chain and the eager glove encoding for the fused encoder: both warn
    # and run unfused
    hyper = engine.Hyper.single(*CANONICAL)
    runs, counts_by_mode, epochs, warned = {}, {}, {}, {}
    n_linear = eager.n_linear
    t_runs = time.perf_counter()
    for mode, trainer in trainers.items():
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if mode == "prediction":
                trainer = engine.Trainer(eager.cfg, eager.store, adabn=False,
                                         batch_size=8, use_fused_train=True,
                                         use_fused_encoder=True, **widths,
                                         **MODES[mode])
            elif mode == "glove_encoding":
                trainer.use_fused_encoder = True
            K.reset_launch_counts()
            t0 = time.perf_counter()
            res = train_loop(trainer, hyper, TRAIN_EPOCHS, seed=0,
                             annealing=True, verbose=False)
            torch.cuda.synchronize()
            loop_s = time.perf_counter() - t0
            counts = dict(K.launch_counts)
            test = run_test(trainer, res.state, hyper, trainer.generator(5))
            torch.cuda.synchronize()
            test_chain = K.launch_counts["encoder_chain"]
            trainer.use_fused_encoder = False
        warned[mode] = sorted({str(w.message).split(";")[0] for w in caught
                               if "requested but" in str(w.message)})
        fused = mode == "glove_encoding_fused"
        k1 = n_steps if mode.startswith("glove_encoding") else 0
        want = {"contrastive_loss_fwd": k1, "contrastive_loss_bwd": k1,
                "dense_block_fwd": n_linear * n_steps if fused else 0,
                "dense_block_bwd": n_linear * n_steps if fused else 0,
                "chain_tail_fwd": n_steps if fused else 0,
                "chain_tail_bwd": n_steps if fused else 0,
                "dropout_masks": 0, "encoder_chain": 0}
        got = {k: counts[k] for k in want}
        if got != want or test_chain:
            raise AssertionError(f"{mode} launches {got} (encoder_chain "
                                 f"{test_chain} by the test too), want {want}")
        if mode in ("prediction", "glove_encoding") and not warned[mode]:
            raise AssertionError(f"{mode}: the ineligible fused request "
                                 "did not warn")
        D_test = trainer.view_test.D
        if not (np.isfinite(res.train_losses).all()
                and res.train_losses[-1] < res.train_losses[0]):
            raise AssertionError(f"{mode} train losses {res.train_losses}")
        if float(test.accuracy) <= 0.1:
            raise AssertionError(f"{mode} test acc {float(test.accuracy)}: "
                                 "not above 0.1")
        if not (test.curve.shape == (D_test, eager.cfg.n_voting_cols)
                and test.y_pred.shape == (D_test, eager.cfg.max_tasks)
                and test.logits.shape == (D_test * 25, 41, 41)
                and bool(torch.isfinite(test.logits).all())
                and bool(test.logits.any()) == mode.startswith("glove_enc")):
            raise AssertionError(f"{mode} test outputs have the wrong shape "
                                 "or values")
        counts_by_mode[mode] = got
        # 3. one epoch from the trained state, by CUDA events
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        gen = trainer.generator(11)
        torch.cuda.synchronize()
        start.record()
        trainer.train_epoch(res.state, gen, hyper)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        epochs[mode] = dict(epoch_ms=ms, ms_per_step=ms / steps_per_epoch,
                            train_windows_per_s=windows / ms * 1e3)
        runs[mode] = dict(train_loop_s=loop_s, train_losses=res.train_losses,
                          train_accs=res.train_accs, val_loss=res.val_loss,
                          val_acc=res.val_acc, test_loss=float(test.loss),
                          test_acc=float(test.accuracy), launches=got,
                          launches_per_step={k: c / n_steps
                                             for k, c in got.items()},
                          warnings=warned[mode])
        log(f"[modes] {mode}: train_loop {TRAIN_EPOCHS} epochs ({n_steps} "
            f"steps) in {loop_s:.2f} s: {json.dumps(runs[mode])}; one epoch "
            f"{json.dumps(epochs[mode])}")
    epochs["onehot_contrastive_phase_7"] = dict(
        epoch_ms=train_res["epoch_ms"], ms_per_step=train_res["ms_per_step"],
        train_windows_per_s=train_res["train_windows_per_s"])
    parts_s["runs_and_epochs"] = time.perf_counter() - t_runs

    # 4. the stacked step in every mode
    t0 = time.perf_counter()
    stacked = modes_stacked_check(K, trainers)
    parts_s["stacked_check"] = time.perf_counter() - t0

    # 5. go.sh's sweep in glove encoding; traces of 10 stacked steps at
    # C=2 and C=150, whose host launch calls must be equal
    ge = trainers["glove_encoding"]
    n = SWEEP_CONFIGS
    hypers = crossval.sample_hyperparams(n, seed=42)
    chunks = -(-n // crossval.resolve_chunk(n))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        K.reset_launch_counts()
        start.record()
        values = crossval.cross_validate(ge, hypers, SWEEP_EPOCHS, seed=42,
                                         save_dir=tmp, verbose=False)
        end.record()
        torch.cuda.synchronize()
    sweep_counts = {k: K.launch_counts[k] for k in TRAIN_KERNELS}
    want = chunks * steps_per_epoch * SWEEP_EPOCHS
    if any(c != want for c in sweep_counts.values()):
        raise AssertionError(f"K1 launches in the glove-encoding sweep "
                             f"{sweep_counts}, want {want} each")
    best_acc = float(np.nanmax(values[:, 1]))
    if best_acc <= 0.1:
        raise AssertionError(f"glove-encoding sweep: best val accuracy "
                             f"{best_acc}, not above 0.1")
    sweep_ms = start.elapsed_time(end)
    parts_s["sweep"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    # one trace at each width: the host's launch and operator calls, which
    # the check compares, read the same in all of phase 9's repeats
    traces = {C: sweep_trace(K, ge, hypers, C, repeats=1) for C in (2, n)}
    parts_s["sweep_traces"] = time.perf_counter() - t0
    launches = {C: tr["launches_per_step"] for C, tr in traces.items()}
    host_ops = {C: tr["host_ops_per_step"] for C, tr in traces.items()}
    if launches[2] != launches[n] or host_ops[2] != host_ops[n]:
        raise AssertionError(f"glove encoding: launches per stacked step "
                             f"{launches} and operator calls {host_ops} "
                             f"differ with C")
    sweep = dict(configs=n, epochs=SWEEP_EPOCHS, chunks=chunks,
                 sweep_ms=sweep_ms, configs_per_s=n / (sweep_ms / 1e3),
                 windows_per_s=n * steps_per_epoch * eager.batch_size
                 * v.n_tasks / (sweep_ms / 1e3),
                 best_val_acc=best_acc, k1_launches=sweep_counts,
                 finite=int(np.isfinite(values).all(1).sum()),
                 launches_per_stacked_step=launches,
                 host_ops_per_stacked_step=host_ops,
                 device_ms_per_stacked_step={
                     C: tr["device_ms_per_step"] for C, tr in traces.items()},
                 device_idle_share={C: tr["device_idle_share"]
                                    for C, tr in traces.items()})
    log(f"[modes] glove-encoding cross_validate of {n} configs x "
        f"{SWEEP_EPOCHS} epoch: {json.dumps(sweep)}")

    # 6. the CLIs in the baseline and in glove encoding
    clis = {}
    t_clis = time.perf_counter()
    for flag in ("--prediction", "--glove_encoding"):
        with tempfile.TemporaryDirectory() as tmp:
            common = ["--synthetic", "--data_dir", tmp, "--checkpoint_dir",
                      tmp, "--no_verbose", flag]
            t0 = time.perf_counter()
            if cli_train.main([*common, "--crossval_size", "3",
                               "--final_epochs", "1", "--test",
                               "--results_dir", f"{tmp}/A"]) != 0:
                raise AssertionError(f"cptorch-train {flag} failed")
            train_s = time.perf_counter() - t0
            model = model_from_state_dict(load_reference_checkpoint(
                f"{tmp}/contrastive.pt"))
            if (model.prediction, model.glove_encoding) != (
                    flag == "--prediction", flag == "--glove_encoding"):
                raise AssertionError(f"cptorch-train {flag} wrote a model "
                                     "of another mode")
            t0 = time.perf_counter()
            if cli_results.main([*common, "--results_dir", f"{tmp}/B"]) != 0:
                raise AssertionError(f"cptorch-results {flag} failed")
            results_s = time.perf_counter() - t0
            logs = np.load(f"{tmp}/A/logs.npy")
            if not np.array_equal(logs, np.load(f"{tmp}/B/logs.npy")):
                raise AssertionError(f"cptorch-results {flag} wrote other "
                                     "logs.npy than cptorch-train")
            clis[flag] = dict(train_s=train_s, results_s=results_s,
                              logs_shape=list(logs.shape),
                              logs_all_zero=not logs.any())
    log(f"[cli] cptorch-train --synthetic --crossval_size 3 --final_epochs 1 "
        f"--test --results_dir A and cptorch-results --results_dir B, with "
        f"--prediction and with --glove_encoding, ok on cuda; checkpoints "
        f"load strictly in their mode, logs.npy equal: {json.dumps(clis)}")
    parts_s["clis"] = time.perf_counter() - t_clis
    phase_s = time.perf_counter() - t_phase
    log(f"[modes] phase 12 took {phase_s:.1f} s: {json.dumps(parts_s)}")
    totals = {k: sum(c.get(k, 0) for c in counts_by_mode.values())
              for k in (*TRAIN_KERNELS, *FUSED_KERNELS)}
    for k in TRAIN_KERNELS:
        totals[k] += sweep_counts[k]
    res = dict(geometry=dict(batch_size=8, D=v.D, n_tasks=v.n_tasks,
                             steps_per_epoch=steps_per_epoch,
                             D_glove=v.D_glove),
               step_check=step_check, runs=runs, epochs=epochs,
               stacked_check=stacked, sweep=sweep, clis=clis,
               phase_s=phase_s, parts_s=parts_s)
    return res, totals


# ------------------------------------------------------------ phase 13
def mm_f32_out(product=torch.mm):
    """A cuBLAS bf16 product (``product``: ``torch.mm``, or ``torch.bmm``
    for batched operands) with f32 output, ``product(a, b, out_dtype=
    torch.float32)``, where the installed torch takes ``out_dtype``; else
    ``product`` on bf16, whose output rounds to bf16. Returns the function
    and its name for the ``kernels`` line."""
    name = product.__name__
    shape = (16, 16) if product is torch.mm else (2, 16, 16)
    a = torch.ones(shape, dtype=torch.bfloat16, device="cuda")
    try:
        product(a, a, out_dtype=torch.float32)
    except (TypeError, RuntimeError):
        return (lambda x, y: product(x, y).float(),
                f"torch.{name} on bf16 operands (its output rounds to bf16; "
                f"this torch's {name} takes no out_dtype)")
    return (lambda x, y: product(x, y, out_dtype=torch.float32),
            f"torch.{name}(bf16, bf16, out_dtype=torch.float32)")


def bf16_matmul_chain(mm, frames, folded, affines):
    """One cuBLAS pass of the bf16 fold: each layer's activations as bf16
    operands times the bf16 weights with f32 output (``mm``), bias, ReLU
    and affine in place in f32, the head alike: the library yardstick for
    ``encoder_chain``'s bf16 variant."""
    *ws, gt = folded
    h = frames.to(torch.bfloat16)
    for j in range(0, len(ws) - 2, 2):
        y = mm(h, ws[j]).add_(ws[j + 1]).relu_()
        if affines is not None:
            S = affines[j].shape[0]
            y.view(-1, S, y.shape[1]).mul_(affines[j]).add_(affines[j + 1])
        h = y.to(torch.bfloat16)
    e = mm(h, ws[-2]).add_(ws[-1])
    e = e / torch.linalg.vector_norm(e, dim=-1, keepdim=True)
    return mm(e.to(torch.bfloat16), gt)


def f64_operands(chain):
    """A bf16 chain's f32 tensors (biases, affines) in float64, its bf16
    weights as they are: the plain version then computes in float64 on
    the same bf16 operands, rounding each dot's activations to bf16."""
    return tuple(t.double() if t.dtype == torch.float32 else t
                 for t in chain)


def encoder_bf16_bounds(chain, M: int, tensors) -> dict:
    """The bf16 variant's bound at ``M`` rows: the bytes of ``tensors``
    (each input read once, each output written once) against one bf16
    product a multiply-add at the bf16 peak."""
    b, by = bound_ms(nbytes(*tensors), 2.0 * chain_macs(chain) * M,
                     PEAK_BF16_FLOPS)
    return dict(bound_ms=b, bound_by=by)


def check_encoder_bf16(K, rows, single, batched, f32_chains) -> dict:
    """Phase 13, ``encoder_chain``'s bf16 variant: at every M of phase 2's
    ladder (the bf16 regime threshold -+ 1, and the f32 one's + 1) on the
    bf16 engines' shared chain with per-session affines and
    on the single engine's folded chain, held against its plain version
    (atol ``BF16_ATOL``); each call's first rows bit-identical to the
    smaller call's and to a rerun; at one tick of S sessions the kernel
    and the plain version against float64 on the same bf16 operands. The
    f32 fold of the same statistics is held at JAX's loose bound on frames
    of unit scale (seeded normal: the scale the ingest's normalisation
    gives and JAX's test uses); on ``rows`` (this script's DSP frames, std
    about 217, since its mean and std are not the recordings' statistics)
    the distance to the f32 fold is reported only: there bf16 and f32
    differ by more, in the plain version as in the kernel.
    Timed with CUDA events and traced beside its bound, the cuBLAS bf16
    chain and the f32 kernel at the same shape (the two kernels in turns).
    Returns the ``kernels`` entry."""
    S = batched.n_sessions
    M_all = rows.shape[0]
    thr = K.ENCODER_SMALL_ROWS_BF16
    shared, affines = batched.shared_chain, batched.session_affines()
    folded = single.folded_chain
    f32_shared, f32_folded = f32_chains
    chains = {"affines": lambda M: (shared, f32_shared,
                                    tuple(x[:min(M, S)] for x in affines)),
              "folded": lambda M: (folded, f32_folded, None)}
    unit = torch.randn(rows.shape, generator=torch.Generator(
        rows.device).manual_seed(14), device=rows.device)
    errs, vs_f32, vs_f32_dsp, prev = {}, {}, {}, {}
    for M in sorted({1, 16, 200, thr - 1, thr + 1, K.ENCODER_SMALL_ROWS + 1,
                     S, M_all}):
        for kind, make in chains.items():
            chain, chain32, aff = make(M)
            got = K.fused_encoder_logits(rows[:M], chain, aff)
            again = K.fused_encoder_logits(rows[:M], chain, aff)
            want = K.fused_encoder_logits_reference(rows[:M], chain, aff)
            got_unit = K.fused_encoder_logits(unit[:M], chain, aff)
            want32 = K.fused_encoder_logits_reference(unit[:M], chain32, aff)
            torch.cuda.synchronize()
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"encoder_chain_bf16: non-finite, M={M}")
            torch.testing.assert_close(got, want, rtol=0, atol=BF16_ATOL)
            torch.testing.assert_close(got_unit, want32, rtol=0.1, atol=0.05)
            vs_f32[f"M={M} {kind}"] = max_abs(got_unit, want32)
            vs_f32_dsp[f"M={M} {kind}"] = max_abs(
                got, K.fused_encoder_logits_reference(rows[:M], chain32, aff))
            if not torch.equal(got, again):
                raise AssertionError(f"encoder_chain_bf16 rerun differs, "
                                     f"M={M}")
            if kind in prev and not torch.equal(got[:len(prev[kind])],
                                                prev[kind]):
                raise AssertionError(
                    f"encoder_chain_bf16 rows differ between M="
                    f"{len(prev[kind])} and M={M} ({kind})")
            errs[f"M={M} {kind}"] = max_abs(got, want)
            prev[kind] = got
            del again, want, want32, got_unit
    # against float64 on the same bf16 operands at one tick: the kernel
    # no farther than the plain version, in the mean and at the worst
    vs_f64 = {}
    for kind, make in chains.items():
        chain, _, aff = make(S)
        want64 = K.fused_encoder_logits_reference(
            rows[:S].double(), f64_operands(chain),
            f64_operands(aff) if aff else None)
        err_k = (prev[kind][:S].double() - want64).abs()
        err_p = (K.fused_encoder_logits_reference(rows[:S], chain, aff
                                                  ).double() - want64).abs()
        vs_f64[kind] = e = dict(
            kernel_max=float(err_k.max()), plain_max=float(err_p.max()),
            kernel_mean=float(err_k.mean()), plain_mean=float(err_p.mean()))
        if (e["kernel_mean"] > BF16_F64_MEAN * e["plain_mean"]
                or e["kernel_max"] > BF16_F64_MAX * e["plain_max"]):
            raise AssertionError(f"encoder_chain_bf16 rounds farther from "
                                 f"float64 than its plain version ({kind}): "
                                 f"{e}")
        del want64, err_k, err_p
    scores = prev["affines"]
    log(f"[bf16] encoder_chain_bf16 ok at M = 1 .. {M_all} (threshold "
        f"{thr}), affines and folded: max abs err {max(errs.values()):.3g} "
        f"against its plain version (atol {BF16_ATOL}), "
        f"{max(vs_f32.values()):.3g} against the f32 fold on unit-scale "
        f"frames (rtol 0.1, atol 0.05; {max(vs_f32_dsp.values()):.3g} on the "
        "DSP frames, reported); first rows bit-identical across M and the "
        "regime switch; "
        f"reruns bit-identical; against float64 at M={S}: "
        f"{json.dumps(vs_f64)}")

    mm, mm_name = mm_f32_out()
    tick, one = rows[:S], rows[:1]
    shapes = {
        f"rows_{M_all}": (rows, shared, f32_shared, affines, 3),
        f"rows_{S}": (tick, shared, f32_shared, affines, 20),
        "rows_1": (one, folded, f32_folded, None, 200)}
    by_shape = {}
    for name, (x, chain, chain32, aff, reps) in shapes.items():
        kernel = functools.partial(K.fused_encoder_logits, x, chain, aff)
        f32_kernel = functools.partial(K.fused_encoder_logits, x, chain32,
                                       aff)
        turns = [time_ms(fn, reps, 2) for fn in (f32_kernel, kernel, kernel,
                                                 f32_kernel)]
        device_ms, per_call = device_per_call(kernel, 10 if reps < 10
                                              else 50)
        out = kernel()
        by_shape[name] = dict(
            ms=(turns[1] + turns[2]) / 2, f32_kernel_ms=(turns[0] + turns[3])
            / 2, ms_in_turns=turns,
            plain_ms=time_ms(functools.partial(
                K.fused_encoder_logits_reference, x, chain, aff),
                max(1, reps // 10), 1),
            library_ms=time_ms(functools.partial(bf16_matmul_chain, mm, x,
                                                 chain, aff), reps, 2),
            device_ms_per_call=device_ms,
            device_ms_per_launch=device_ms / per_call,
            device_launches_per_call=per_call,
            **encoder_bf16_bounds(chain, x.shape[0],
                                  (x, out, *chain, *(aff or ()))))
        del out
    plan = K.encoder_plan(folded)
    tiling = {M: {name: time_ms(lambda: K.encoder_chain(rows[:M], plan,
                                                         regime), 50, 3)
                  for name, regime in (("small", 0), ("large", 1))}
              for M in (16, 64, 128, 256, 384, 512, 640, 768, 1024)}
    top = by_shape[f"rows_{M_all}"]
    report = ptxas_report("encoder_chain")
    frames = {fn: r for fn, r in report.items() if "bf16" in fn}
    bad = {fn: r for fn, r in frames.items()
           if r.get("stack_frame_bytes") or r.get("spill_store_bytes")}
    if len(frames) != 5 or bad:
        raise AssertionError(f"encoder_chain_bf16's functions: stack frame "
                             f"or spills not 0, or missing: {frames}")
    log(f"[bf16] encoder_chain_bf16 by shape: {json.dumps(by_shape)}; "
        f"both tilings by rows: {json.dumps(tiling)}")
    return dict(
        name="encoder_chain_bf16", route="cuda",
        source=SOURCES["encoder_chain_bf16"],
        replaces=REPLACES["encoder_chain_bf16"],
        max_abs_err=max(errs.values()),
        max_abs_err_parts=errs, max_abs_err_vs_f32_fold_unit_frames=vs_f32,
        max_abs_err_vs_f32_fold_dsp_frames=vs_f32_dsp,
        max_abs_err_vs_f64_at_one_tick=vs_f64,
        tolerance=f"atol {BF16_ATOL} against the plain bf16 version (the same "
                  "bf16 roundings; f32 sums in another order flip a few); "
                  f"against float64 on the same bf16 operands its mean error "
                  f"at most {BF16_F64_MEAN}x and its largest at most "
                  f"{BF16_F64_MAX}x the plain version's; rtol 0.1 atol 0.05 "
                  "against the f32 fold on unit-scale frames (JAX's "
                  "test_pallas.py:226); rows bit-identical across M, tilings "
                  "and reruns",
        ms=top["ms"], kernel_ms=top["ms"], plain_ms=top["plain_ms"],
        bound_ms=top["bound_ms"], bound_by=top["bound_by"],
        library_ms=top["library_ms"], library_call=mm_name,
        f32_kernel_ms=top["f32_kernel_ms"],
        shape=f"rows={M_all} (tick, session) with per-session affines",
        by_shape=by_shape,
        bound_ms_by_shape={k: e["bound_ms"] for k, e in by_shape.items()},
        tiling_ms_by_rows=tiling, regime_threshold=thr,
        macs_per_row=chain_macs(shared), ptxas=frames,
        peaks={"bf16_flops": PEAK_BF16_FLOPS,
               "bytes_per_s": PEAK_BYTES_PER_S})


def step_loop_ms(engine, blocks, mask, n: int) -> np.ndarray:
    """Host-clock milliseconds of ``n`` synchronised ``engine.step`` calls
    from a fresh carry (the first, which pays one-time costs, dropped)."""
    carry, lat = engine.init_carry(), []
    for i in range(n):
        t0 = time.perf_counter()
        carry, *_ = engine.step(carry, blocks[i], mask)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    return np.array(lat[1:])


def complete_trace(trace_fn, name: str, want: float, tries: int = 3):
    """A profiler trace (``trace_fn()``) in which kernel ``name`` shows
    ``want`` launches a step: a trace now and then drops device records,
    so up to ``tries`` traces are taken; the last is returned, with the
    count of those that dropped some."""
    for i in range(tries):
        trace = trace_fn()
        if trace["device_launches_per_step"].get(name) == want:
            break
    trace["traces_with_dropped_records"] = i + (
        trace["device_launches_per_step"].get(name) != want)
    return trace


def bf16_phase(K, dev, seed_model, mean, std, calib, recording, batch_blocks,
               masks, subsets, f32_single, f32_batched,
               f32_preds) -> tuple[dict, dict]:
    """Phase 13, bfloat16 serving at full width: the bf16 engines from the
    same seeded weights as phase 1's (``ContrastiveModel(dtype=
    torch.bfloat16)``), calibrated through the bf16 tower (one
    ``iir_rms_frames`` launch a recording); ``encoder_chain``'s bf16
    variant against its plain version (``check_encoder_bf16``); 50
    per-tick ``step`` calls and a 200-tick ``steps`` replay that must
    agree, a trace of 20 steps; the batched replay of S sessions x 25
    ticks with subset masks against the plain version away from near-ties,
    timed and traced, one live ``step``, one timed replay at 65,536
    sessions; the share of preds equal to phase 4's f32 engine's;
    ``cptorch-serve --bf16`` per tick and batched. The step loop and the
    batched replay are timed in turns with phases 3 and 4's f32 engines
    (f32, bf16, bf16, f32). Every bf16 path must launch the bf16 variant
    and never the f32 one. Returns the ``bf16_serve`` results and the
    ``kernels`` entry."""
    from contrastiveprosthetics_torch.cli import serve as cli
    from contrastiveprosthetics_torch.config import DEFAULT_CONFIG as cfg
    from contrastiveprosthetics_torch.models.clip import ContrastiveModel
    from contrastiveprosthetics_torch.serve.stream import (
        BatchedStreamingEngine,
        StreamingEngine,
    )

    t_phase = time.perf_counter()
    S, T = SESSIONS, TICKS
    C, D, F = cfg.max_tasks, cfg.emg_dim, cfg.factor
    bf16 = torch.bfloat16
    model = ContrastiveModel(generator=torch.Generator().manual_seed(
        seed_model), dtype=bf16).to(dev)

    def launched(path: str, counts: dict) -> None:
        """The bf16 variant and the tick's other kernels ran on ``path``,
        the f32 variant did not."""
        if counts["encoder_chain"] or not counts["encoder_chain_bf16"]:
            raise AssertionError(f"bf16 {path}: encoder_chain launches "
                                 f"{counts}")

    K.reset_launch_counts()
    t0 = time.perf_counter()
    single = StreamingEngine(cfg, model, mean, std)
    single.calibrate(calib[4])
    batched = BatchedStreamingEngine(cfg, model, mean, std, n_sessions=S)
    for i in range(4):
        batched.calibrate_session(i, calib[i])
    batched.session_affines()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    calib_counts = dict(K.launch_counts)
    if calib_counts["iir_rms_frames"] != 5 or calib_counts["encoder_chain"] \
            or calib_counts["encoder_chain_bf16"]:
        raise AssertionError(f"bf16 calibration of 5 recordings launched "
                             f"{calib_counts}")
    if single.folded_chain[0].dtype != bf16 or \
            batched.shared_chain[0].dtype != bf16:
        raise AssertionError("the bf16 engines did not fold in bf16")

    # the kernel, at every row count of phase 2's ladder, on this phase's
    # own frames
    blocks_t = torch.as_tensor(batch_blocks, device=dev)
    masks_t = torch.as_tensor(masks, device=dev)
    carries = batched.init_carries()
    sos, mu, sd = single._sos, single._mean, single._std
    frames = K.dsp_frames(carries.iir_state, carries.tail, blocks_t, sos, mu,
                          sd)[0].reshape(T * S, D)
    f32_chains = (K.fold_encoder_params_shared(
        batched._single.model.emg_net, batched._single._class_emb),
        K.fold_encoder_params(single.model.emg_net, single._class_emb))
    entry = check_encoder_bf16(K, frames, single, batched, f32_chains)
    del frames, f32_chains

    # single session
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
    step_counts = dict(K.launch_counts)
    K.reset_launch_counts()
    _, preds, votes = single.steps(single.init_carry(), blocks, mask1)
    torch.cuda.synchronize()
    steps_counts = dict(K.launch_counts)
    launched("step", step_counts)
    launched("steps", steps_counts)
    if preds[:50].tolist() != step_p or votes[:50].tolist() != step_v:
        raise AssertionError("bf16 step loop and steps disagree")
    if not set(preds.tolist()) <= set(np.flatnonzero(mask1).tolist()):
        raise AssertionError("bf16 single-session preds outside the subset")
    lat = np.array(lat[1:])
    steps_ms = time_ms(lambda: single.steps(single.init_carry(), blocks,
                                            mask1), reps=5)
    step_trace = complete_trace(lambda: trace_steps(single, blocks, mask1, 20),
                                "encoder_chain_bf16", 10.0)
    # the f32 and bf16 step loops in turns, 50 ticks each
    turns = [step_loop_ms(eng, blocks, mask1, 50)
             for eng in (f32_single, single, single, f32_single)]
    single_res = dict(step_p50_ms=float(np.percentile(lat, 50)),
                      step_p99_ms=float(np.percentile(lat, 99)),
                      steps_200_ticks_ms=steps_ms, step_trace=step_trace,
                      in_turns_with_f32=dict(
                          order="f32, bf16, bf16, f32",
                          p50_ms=[float(np.percentile(x, 50)) for x in turns],
                          p99_ms=[float(np.percentile(x, 99)) for x in turns]),
                      launches=dict(step=step_counts, steps=steps_counts))
    log(f"[bf16] single session: step p50 {single_res['step_p50_ms']:.4f} "
        f"ms, p99 {single_res['step_p99_ms']:.4f} ms; steps over 200 ticks "
        f"{steps_ms:.4f} ms; step loop == steps; in turns with f32: "
        f"{json.dumps(single_res['in_turns_with_f32'])}; trace of 20 steps: "
        f"{json.dumps(step_trace)}")

    # batched: S sessions x T ticks against the plain version
    K.reset_launch_counts()
    _, b_preds, b_votes = batched.steps(batched.init_carries(), batch_blocks,
                                        masks)
    torch.cuda.synchronize()
    batched_counts = dict(K.launch_counts)
    launched("batched", batched_counts)
    chain_args = (*batched.init_carries(), blocks_t, masks_t, sos, mu, sd,
                  batched.shared_chain, batched.session_affines())
    _, k_preds, k_votes, k_scores = K.tick_chain(*chain_args)
    _, p_preds, p_votes, p_scores = K.tick_chain_reference(*chain_args)
    torch.cuda.synchronize()
    if not (torch.equal(k_preds, b_preds) and torch.equal(k_votes, b_votes)):
        raise AssertionError("bf16 engine steps and the kernel chain disagree")
    if not bool((torch.isfinite(p_scores) | ~masks_t).all()):
        raise AssertionError("bf16: non-finite scores")
    live = masks_t.expand_as(k_scores)
    torch.testing.assert_close(k_scores[live], p_scores[live], rtol=0,
                               atol=BF16_ATOL)
    # a pred can differ only where the top two lie within twice the
    # largest score difference
    err = max_abs(k_scores[live], p_scores[live])
    diff = k_preds != p_preds
    ties = near_tie(k_scores, 2 * err) | near_tie(p_scores, 2 * err)
    if bool((diff & ~ties).any()):
        raise AssertionError("bf16 batched preds disagree away from "
                             "near-ties")
    clean = ~diff.any(dim=0)
    if not torch.equal(k_votes[:, clean], p_votes[:, clean]):
        raise AssertionError("bf16 batched votes disagree")
    for i, ids in enumerate(subsets):
        if not set(b_preds[:, i].tolist()) <= set(ids):
            raise AssertionError(f"bf16 session {i} predicted outside its "
                                 "subset")
    if bool(((b_preds < 0) | (b_preds >= C)).any()):
        raise AssertionError("bf16 pred out of range")
    same_as_f32 = float((b_preds == f32_preds).float().mean())
    del k_scores, p_scores
    batched_ms = time_ms(lambda: batched.steps(batched.init_carries(),
                                               blocks_t, masks_t), reps=3)
    replay_turns = [time_ms(lambda eng=eng: eng.steps(
        eng.init_carries(), blocks_t, masks_t), reps=3)
        for eng in (f32_batched, batched, batched, f32_batched)]
    live_carries = batched.init_carries()
    live_ms = time_ms(lambda: batched.step(live_carries, blocks_t[0],
                                           masks_t), reps=10, warmup=2)
    steps_trace = complete_trace(lambda: trace_call(lambda: batched.steps(
        batched.init_carries(), blocks_t, masks_t)), "encoder_chain_bf16",
        10.0)
    del blocks_t, chain_args, live_carries

    # one replay at the top of the JAX round-5 ladder
    S2 = 2 * S
    big = BatchedStreamingEngine(cfg, model, mean, std, n_sessions=S2)
    big_blocks = torch.randn((T, S2, F, D), generator=torch.Generator(
        dev).manual_seed(13), device=dev)
    K.reset_launch_counts()
    _, big_preds, _ = big.steps(big.init_carries(), big_blocks)
    torch.cuda.synchronize()
    big_counts = dict(K.launch_counts)
    launched(f"batched at {S2} sessions", big_counts)
    if bool(((big_preds < 0) | (big_preds >= C)).any()):
        raise AssertionError(f"bf16 pred out of range at {S2} sessions")
    torch.cuda.reset_peak_memory_stats()
    big_ms = time_ms(lambda: big.steps(big.init_carries(), big_blocks),
                     reps=2)
    big_peak = torch.cuda.max_memory_allocated()
    del big, big_blocks, big_preds
    batched_res = dict(
        sessions=S, ticks=T, steps_ms=batched_ms, ms_per_tick=batched_ms / T,
        steps_ms_in_turns_with_f32=dict(order="f32, bf16, bf16, f32",
                                        ms=replay_turns),
        live_step_ms=live_ms, steps_trace=steps_trace,
        pred_near_tie_disagreements=int(diff.sum()),
        max_abs_score_err=err, near_tie_eps=2 * err,
        preds_equal_to_f32_engine_share=same_as_f32,
        launches=batched_counts,
        sessions_65536=dict(sessions=S2, ticks=T, steps_ms=big_ms,
                            ms_per_tick=big_ms / T, launches=big_counts,
                            peak_memory_bytes=big_peak))
    log(f"[bf16] batched {S} sessions x {T} ticks: {batched_ms:.3f} ms per "
        f"steps call, {batched_ms / T:.4f} ms/tick; live step "
        f"{live_ms:.4f} ms; {int(diff.sum())} near-tie pred differences vs "
        f"plain; preds equal to the f32 engine's: {same_as_f32:.6f}; "
        f"{S2} sessions: {big_ms:.3f} ms, {big_ms / T:.4f} ms/tick, peak "
        f"{big_peak / 1e9:.3f} GB; trace: {json.dumps(steps_trace)}")

    # the CLI in bf16 on the card
    cli_counts = {}
    for argv in (["--demo", "--bf16", "--sessions", "1", "--quiet"],
                 ["--demo", "--bf16", "--sessions", "64", "--replay",
                  "--quiet"]):
        K.reset_launch_counts()
        if cli.main(argv) != 0:
            raise AssertionError(f"cptorch-serve {' '.join(argv)} failed")
        torch.cuda.synchronize()
        cli_counts[" ".join(argv)] = dict(K.launch_counts)
        launched("cptorch-serve " + " ".join(argv), K.launch_counts)
    log("[bf16] cptorch-serve --demo --bf16 --sessions 1 and --sessions 64 "
        "--replay ok on cuda")

    launches = {"step": step_counts["encoder_chain_bf16"],
                "steps": steps_counts["encoder_chain_bf16"],
                "batched": batched_counts["encoder_chain_bf16"]}
    entry.update(launches=sum(launches.values()), launches_by_path=launches,
                 device_ms_per_launch_by_path={
                     "step": per_launch(step_trace, "encoder_chain_bf16"),
                     "batched": per_launch(steps_trace,
                                           "encoder_chain_bf16")})
    res = dict(single=single_res, batched=batched_res,
               setup_s=setup_s, calibration_launches=calib_counts,
               cli_launches=cli_counts,
               phase_s=time.perf_counter() - t_phase)
    return res, entry


# ------------------------------------------------------------ phase 14
def k5_bf16_vs_f64(TF, xb, wb, b, in_stats, dzb, r, st, sums, kw, keep,
                   outs):
    """Errors against float64 of the bf16 block's products on the same bf16
    operands (h and dyc rounded as the kernels and the plain versions round
    them): r and dx, largest and mean absolute error; dW, db and the lower
    block's sums, relative 2-norm. ``outs`` maps a label to (r, (dx, dW,
    db, sums)). Block 0 (``in_stats`` None) has no affine, no dropout and
    no lower block's sums. The label ``"f32_order"`` holds how far a
    kernel may lie beyond ``BF16_K5_F64`` times the plain version's error:
    ``BF16_K5_F64_FLOOR`` for r and dx, and for each sum over the N rows the
    size of one f32 order's error, sqrt(N) 2^-24 |sum of |terms|| /
    |exact sum| (the BatchNorm backward centres dy, so dW and db cancel and
    that size grows with it)."""
    N, K_in = xb.shape
    if in_stats is None:
        z, mask = xb.float(), torch.ones_like(xb, dtype=torch.bool)
    else:
        mask = TF.dropout_masks_reference(kw["seed"], keep, N, K_in,
                                          kw["drop_block"]) > 0
        z = torch.where(mask, (xb.float() * in_stats[3] + in_stats[4])
                        / keep, 0.0)
    h = z.to(torch.bfloat16).double()
    w64 = wb.double()
    r64 = torch.relu(h @ w64 + b.double())
    rf = r.float()
    xn = (rf - st[0]) * st[2]
    n = rf.new_tensor(float(N))
    dy = torch.where(rf > 0, st[3] * (dzb.float() - sums[0] / n
                                      - xn * (sums[1] / n)), 0.0)
    dyc = dy.to(torch.bfloat16).double()
    dh = dyc @ w64.T
    want = dict(dw=h.T @ dyc, db=dy.double().sum(0))
    if in_stats is not None:
        dh = torch.where(mask, dh / keep.double(), 0.0)
        xn_in = (xb.double() - in_stats[0].double()) * in_stats[2].double()
        want["sums"] = torch.stack([dh.sum(0), (dh * xn_in).sum(0)])

    def rel(a, b):
        return float((a.double() - b).norm() / b.norm().clamp_min(1e-30))

    def order(terms, exact):
        return float(N ** 0.5 * 2.0 ** -24 * terms.norm()
                     / exact.norm().clamp_min(1e-30))

    out = {"f32_order": dict(
        r_max=BF16_K5_F64_FLOOR, r_mean=BF16_K5_F64_FLOOR,
        dx_max=BF16_K5_F64_FLOOR, dx_mean=BF16_K5_F64_FLOOR,
        dw_rel_l2=order(h.abs().T @ dyc.abs(), want["dw"]),
        db_rel_l2=order(dy.double().abs().sum(0), want["db"]))}
    if in_stats is not None:
        out["f32_order"]["sums_rel_l2"] = order(torch.stack(
            [dh.abs().sum(0), (dh * xn_in).abs().sum(0)]), want["sums"])
    for label, (rr, (dx, dw, db, osums)) in outs.items():
        er, edx = (rr.double() - r64).abs(), (dx.double() - dh).abs()
        out[label] = dict(r_max=float(er.max()), r_mean=float(er.mean()),
                          dx_max=float(edx.max()), dx_mean=float(edx.mean()),
                          dw_rel_l2=rel(dw, want["dw"]),
                          db_rel_l2=rel(db, want["db"]))
        if osums is not None:
            out[label]["sums_rel_l2"] = rel(osums, want["sums"])
    return out


def check_k5_bf16(TF, dev, f32_entries) -> dict:
    """Phase 14, kernels: the bf16 K5f and K5b (``dense_block_fwd_bf16``,
    ``dense_block_bwd_bf16``) against their plain versions at N=328 and a
    ragged 123, block 0's form (768 inputs) and an inner dropped block's
    (512 inputs, affine, dropout 0.5 drawn), the weight as the chain casts
    it (a Linear weight's ``.T``): r and dx within one bf16 ulp
    (:func:`within_one_bf16_ulp`), the rest as the f32 K5b; reruns, the
    other tiling, the row-major weight and the replayed masks
    bit-identical; at each of the four cases, against float64 on the same
    bf16 operands no worse than the plain version (``BF16_K5_F64``); the bf16
    tail pair bit for bit (its sums within one f32 ulp), drawn and
    replayed. Each timed (CUDA events, profiler device time) beside its
    bound at the bf16 peak, the cuBLAS bf16 GEMMs and the f32 kernel, in
    turns. Returns the four ``kernels`` entries."""
    bf = torch.bfloat16
    F = 512
    keep = torch.full((1,), 0.5, device=dev)
    mm, mm_name = mm_f32_out()
    errs = {name: {} for name in BF16_K5}
    flips, vs_f64 = {}, {}
    for N in (328, 123):
        for K_in, inner in ((768, False), (512, True)):
            x, w, (b, gamma, beta), in_stats, dz, seed = k5_case(
                N, K_in, F, N + K_in, dev)
            xb, dzb = x.to(bf), dz.to(bf)
            w_lin = w.T.contiguous().T.to(bf)  # the chain's weight.T layout
            w_row = w.to(bf)
            kw = dict(seed=seed, keep=keep, drop_block=3) if inner else {}
            in_st = in_stats if inner else None
            r, st = TF.dense_block_fwd(xb, w_lin, b, gamma, beta, in_st, **kw)
            r_p, st_p = TF.dense_block_fwd_reference(xb, w_lin, b, gamma,
                                                     beta, in_st, **kw)
            sums = torch.stack([dzb.float().sum(0), (dzb.float() * (
                r_p.float() - st_p[0]) * st_p[2]).sum(0)])
            got = TF.dense_block_bwd(dzb, r_p, xb, w_lin, st_p, sums, in_st,
                                     **kw)
            want = TF.dense_block_bwd_reference(dzb, r_p, xb, w_lin, st_p,
                                                sums, in_st, **kw)
            torch.cuda.synchronize()
            case = f"N={N} K={K_in}"
            if r.dtype != bf or got[0].dtype != bf or got[1].dtype != \
                    torch.float32:
                raise AssertionError(f"bf16 K5 output dtypes at {case}")
            flips[case] = dict(r=within_one_bf16_ulp(r, r_p),
                               dx=within_one_bf16_ulp(got[0], want[0]))
            e_r = max_abs(r, r_p)
            errs["dense_block_fwd_bf16"][case] = max(
                e_r, close(st, st_p, 1e-3, 1e-3))
            e_dx = max_abs(got[0], want[0])
            errs["dense_block_bwd_bf16"][case] = max(
                e_dx, *(close(g, v, 1e-4, 1e-5) for g, v in
                        zip(got[1:], want[1:]) if v is not None))
            again = (TF.dense_block_fwd(xb, w_lin, b, gamma, beta, in_st,
                                        **kw),
                     TF.dense_block_bwd(dzb, r_p, xb, w_lin, st_p, sums,
                                        in_st, **kw))
            same = [torch.equal(a, c) for a, c in
                    zip((r, st, *got), (*again[0], *again[1]))
                    if a is not None]
            # the other tiling and the row-major weight: r, dx and dW
            for wv, tiling in ((w_lin, 1), (w_row, 0), (w_row, 1)):
                r2, _ = TF.dense_block_fwd(xb, wv, b, gamma, beta, in_st,
                                           tiling=tiling, **kw)
                g2 = TF.dense_block_bwd(dzb, r_p, xb, wv, st_p, sums, in_st,
                                        tiling=tiling, **kw)
                same += [torch.equal(r2, r), torch.equal(g2[0], got[0]),
                         torch.equal(g2[1].T if wv is w_row else g2[1],
                                     got[1].T if wv is w_row else got[1])]
            if inner:
                mask = TF.dropout_masks(seed, keep, N, K_in, 3)
                fed = dict(keep=keep, mask=mask)
                same += [torch.equal(a, c) for a, c in zip(
                    (r, st, *got),
                    (*TF.dense_block_fwd(xb, w_lin, b, gamma, beta, in_st,
                                         **fed),
                     *TF.dense_block_bwd(dzb, r_p, xb, w_lin, st_p, sums,
                                         in_st, **fed)))]
            if not all(same):
                raise AssertionError(f"bf16 K5 not bit-identical on a rerun, "
                                     f"across tilings and layouts or against "
                                     f"replayed masks at {case}")
            # against float64 on the same bf16 operands
            vs_f64[case] = k5_bf16_vs_f64(
                TF, xb, w_lin, b, in_st, dzb, r_p, st_p, sums, kw, keep,
                {"kernel": (r, got), "plain": (r_p, want)})
            worse = [k for k, e in vs_f64[case]["kernel"].items()
                     if e > BF16_K5_F64 * vs_f64[case]["plain"][k]
                     + vs_f64[case]["f32_order"][k]]
            if worse:
                raise AssertionError(f"bf16 K5 farther from float64 than the "
                                     f"plain version at {case}: {worse}")
    # the tail pair: h and dz bit for bit, sums within one f32 ulp
    for N in (328, 123):
        x, _, _, in_stats, dz, seed = k5_case(N, F, F, 7 + N, dev)
        xb, dhb = x.to(bf), dz.to(bf)
        mask = TF.dropout_masks(seed, keep, N, F, 6)
        for form, kw in (("drawn", dict(seed=seed, keep=keep, drop_block=6)),
                         ("replayed", dict(keep=keep, mask=mask))):
            h = TF.chain_tail_fwd(xb, in_stats, **kw)
            dzk, sk = TF.chain_tail_bwd(dhb, xb, in_stats, **kw)
            h_p = TF.chain_tail_fwd_reference(xb, in_stats, **kw)
            dz_p, s_p = TF.chain_tail_bwd_reference(dhb, xb, in_stats, **kw)
            torch.cuda.synchronize()
            if not (torch.equal(h, h_p) and torch.equal(dzk, dz_p)
                    and torch.equal(h, TF.chain_tail_fwd(xb, in_stats, **kw))):
                raise AssertionError(f"bf16 tail disagrees at N={N} {form}")
            within_one_ulp(sk, s_p)
            errs["chain_tail_fwd_bf16"][f"N={N} {form}"] = 0.0
            errs["chain_tail_bwd_bf16"][f"N={N} {form}"] = max_abs(sk, s_p)
    if any(e > BF16_ATOL for parts in errs.values() for e in parts.values()):
        raise AssertionError(f"bf16 K5 beyond JAX's bound {BF16_ATOL}: {errs}")
    log(f"[bf16 train] bf16 K5f/K5b and the tail pair ok at N=328 and 123, "
        f"K=768 and 512: {json.dumps(errs)}; r and dx within one bf16 ulp, "
        f"share of elements apart {json.dumps(flips)}; reruns, both tilings, "
        "both weight layouts and replayed masks bit-identical")
    log(f"[bf16 train] bf16 K5 against float64 on the same bf16 operands "
        f"(F={F}; K=512: affine + dropout 0.5): {json.dumps(vs_f64)}")

    # the timed inputs: the inner dropped block
    N, K_in = 328, 512
    x, w, (b, gamma, beta), in_stats, dz, seed = k5_case(N, K_in, F, 1, dev)
    xb, dzb, wb = x.to(bf), dz.to(bf), w.T.contiguous().T.to(bf)
    kw = dict(seed=seed, keep=keep, drop_block=3)
    r, st = TF.dense_block_fwd(xb, wb, b, gamma, beta, in_stats, **kw)
    r_p, st_p = TF.dense_block_fwd_reference(xb, wb, b, gamma, beta, in_stats,
                                             **kw)
    sums = torch.stack([dzb.float().sum(0), dzb.float().sum(0) * 0.5])
    bk = TF.dense_block_bwd(dzb, r_p, xb, wb, st_p, sums, in_stats, **kw)
    torch.cuda.synchronize()

    # timing: block 0 (768 inputs) and the inner block, the bf16 kernel in
    # turns with the f32 one (f32, bf16, bf16, f32), beside the bf16 GEMMs
    x0, w0 = k5_case(N, 768, F, 2, dev)[:2]
    x0b, w0b = x0.to(bf), w0.T.contiguous().T.to(bf)
    wf = w.T.contiguous().T
    r32, st32 = TF.dense_block_fwd(x, wf, b, gamma, beta, in_stats, **kw)
    calls = {
        "dense_block_fwd_bf16": (
            lambda: TF.dense_block_fwd(xb, wb, b, gamma, beta, in_stats, **kw),
            lambda: TF.dense_block_fwd(x, wf, b, gamma, beta, in_stats, **kw),
            lambda: TF.dense_block_fwd_reference(xb, wb, b, gamma, beta,
                                                 in_stats, **kw),
            lambda: mm(xb, wb)),
        "dense_block_bwd_bf16": (
            lambda: TF.dense_block_bwd(dzb, r, xb, wb, st, sums, in_stats,
                                       **kw),
            lambda: TF.dense_block_bwd(dz, r32, x, wf, st32, sums, in_stats,
                                       **kw),
            lambda: TF.dense_block_bwd_reference(dzb, r, xb, wb, st, sums,
                                                 in_stats, **kw),
            lambda: (mm(dzb, wb.T), mm(xb.T, dzb))),
        "chain_tail_fwd_bf16": (
            lambda: TF.chain_tail_fwd(r, st, seed=seed, keep=keep,
                                      drop_block=6),
            lambda: TF.chain_tail_fwd(r32, st32, seed=seed, keep=keep,
                                      drop_block=6),
            lambda: TF.chain_tail_fwd_reference(r, st, seed=seed, keep=keep,
                                                drop_block=6),
            None),
        "chain_tail_bwd_bf16": (
            lambda: TF.chain_tail_bwd(dzb, r, st, seed=seed, keep=keep,
                                      drop_block=6),
            lambda: TF.chain_tail_bwd(dz, r32, st32, seed=seed, keep=keep,
                                      drop_block=6),
            lambda: TF.chain_tail_bwd_reference(dzb, r, st, seed=seed,
                                                keep=keep, drop_block=6),
            None)}
    h = TF.chain_tail_fwd(r, st, seed=seed, keep=keep, drop_block=6)
    dzt, st_sums = TF.chain_tail_bwd(dzb, r, st, seed=seed, keep=keep,
                                     drop_block=6)
    small = nbytes(b, gamma, beta, in_stats, seed, keep)
    bounds = {
        "dense_block_fwd_bf16": bound_ms(nbytes(xb, wb, r, st) + small,
                                         2.0 * N * K_in * F, PEAK_BF16_FLOPS),
        "dense_block_bwd_bf16": bound_ms(
            nbytes(dzb, r, xb, wb, st, sums, *bk) + small,
            4.0 * N * K_in * F, PEAK_BF16_FLOPS),
        "chain_tail_fwd_bf16": bound_ms(nbytes(r, st, h, seed, keep), 0.0),
        "chain_tail_bwd_bf16": bound_ms(nbytes(dzb, r, st, dzt, st_sums, seed,
                                               keep), 0.0)}
    block0 = dict(
        bf16_ms=time_ms(lambda: TF.dense_block_fwd(x0b, w0b, b, gamma, beta),
                        200, 5),
        f32_ms=time_ms(lambda: TF.dense_block_fwd(x0, w0.T.contiguous().T, b,
                                                  gamma, beta), 200, 5),
        bf16_device_ms=device_ms_per_call(lambda: TF.dense_block_fwd(
            x0b, w0b, b, gamma, beta)),
        gemm_bf16_ms=time_ms(lambda: mm(x0b, w0b), 200, 5),
        shape=f"N={N} K=768 F={F}, no affine or dropout")
    entries = {}
    with torch.no_grad():
        for name, (kernel, f32_kernel, plain, gemm) in calls.items():
            turns = {"f32": [], "bf16": []}
            for which in ("f32", "bf16", "bf16", "f32"):
                turns[which].append(time_ms(
                    kernel if which == "bf16" else f32_kernel, 200, 5))
            f32_name = name[:-len("_bf16")]
            extra = dict(
                device_ms=device_ms_per_call(kernel),
                f32_kernel_ms_in_turns=turns["f32"],
                bf16_kernel_ms_in_turns=turns["bf16"],
                f32_kernel_device_ms=device_ms_per_call(f32_kernel),
                f32_entry_ms=f32_entries[f32_name]["ms"])
            lib = None
            if gemm is not None:
                lib = time_ms(gemm, 200, 5)
                extra.update(
                    library_device_ms=device_ms_per_call(gemm),
                    library_call=mm_name + (" (x W)" if "fwd" in name else
                                            " (dy W^T and h^T dy)"),
                    library_note="not the same function: the bf16 GEMM"
                                 + ("" if "fwd" in name else "s") + " alone",
                    max_abs_err_vs_f64=vs_f64, bf16_flip_share=flips)
                if "fwd" in name:
                    extra["block0"] = block0
            tol = ("h and dz bit for bit, the sums within one f32 ulp"
                   if "tail" in name else
                   "r and dx within one bf16 ulp (of the larger magnitude) "
                   f"+ {BF16_K5_ORDER_FLOOR} x max, at most "
                   f"{BF16_K5_FLIP_SHARE} of them apart, and within JAX's "
                   f"bound atol {BF16_ATOL}; stats rtol 1e-3, "
                   "atol 1e-3 x max; dW, db and sums rtol 1e-4, atol 1e-5 x "
                   "max; reruns, tilings, layouts and replayed masks "
                   "bit-identical; against float64 at each case at most "
                   f"{BF16_K5_F64} x the plain version's error + "
                   f"{BF16_K5_F64_FLOOR}")
            bd, by = bounds[name]
            entries[name] = dict(
                route="cuda", max_abs_err=max(errs[name].values()),
                max_abs_err_parts=errs[name], tolerance=tol,
                ms=sum(turns["bf16"]) / 2,
                plain_ms=time_ms(plain, reps=20, warmup=2),
                bound_ms=bd, bound_by=by, library_ms=lib,
                shape=(f"N={N} K={K_in} F={F}, affine + dropout 0.5 on the "
                       "input" if "dense" in name else
                       f"N={N} F={F}, dropout 0.5"),
                peaks={"bf16_flops": PEAK_BF16_FLOPS,
                       "bytes_per_s": PEAK_BYTES_PER_S}, **extra)
    return entries


def bf16_train_phase(K, TF, eager, train_res, fused_res,
                     f32_entries) -> tuple[dict, dict]:
    """Phase 14, bfloat16 training (``Trainer(compute_dtype="bfloat16")``,
    ``cptorch-train --bf16``) on phase 7's store at full width, bs 8: the
    bf16 K5 kernels (:func:`check_k5_bf16`); ``train_loop`` for 2 annealed
    epochs eager and on the fused chain, each test accuracy above 0.5, the
    fused one launching each bf16 K5 variant 7 times a step, each bf16
    tail kernel once, no f32 K5 kernel, the eager one none of them;
    ``TURN_STEPS`` steps of phase 7's and 8's f32 paths and of the two bf16
    ones in turns by CUDA events; traces of 20 steps of each bf16 path; a stacked bf16 step
    of 2 configs against their single steps; ``cross_validate`` of the
    CLI's default 10 configs x 1 epoch in bf16; the fused bf16 test pass
    (``encoder_chain_bf16`` 10 times a batch, ``encoder_chain`` never)
    against the unfused one; ``cptorch-train --bf16`` and
    ``cptorch-results`` with and without ``--bf16`` on cuda. Returns the
    ``bf16_train`` results and the four ``kernels`` entries."""
    from contrastiveprosthetics_torch.cli import results as cli_results
    from contrastiveprosthetics_torch.cli import train as cli_train
    from contrastiveprosthetics_torch.data.sampler import (
        epoch_batches,
        gather_train_batch,
        task_permutations,
    )
    from contrastiveprosthetics_torch.models.convert import (
        load_reference_checkpoint,
        model_from_state_dict,
    )
    from contrastiveprosthetics_torch.train import engine
    from contrastiveprosthetics_torch.train.crossval import (
        cross_validate,
        sample_hyperparams,
    )
    from contrastiveprosthetics_torch.train.loop import run_test, train_loop

    t_phase = time.perf_counter()
    entries = check_k5_bf16(TF, eager.device, f32_entries)
    cfg, dev = eager.cfg, eager.device
    paths = {name: engine.Trainer(cfg, eager.store, adabn=False, batch_size=8,
                                  compute_dtype="bfloat16",
                                  use_fused_train=(name == "fused"))
             for name in ("eager", "fused")}
    v = eager.view_train
    steps_per_epoch = -(-v.D // 8)
    n_steps = TRAIN_EPOCHS * steps_per_epoch
    L = eager.n_linear
    hyper = engine.Hyper.single(*CANONICAL)
    loops, counts, states = {}, {}, {}
    for name, trainer in paths.items():
        K.reset_launch_counts()
        t0 = time.perf_counter()
        res = train_loop(trainer, hyper, TRAIN_EPOCHS, seed=0, annealing=True,
                         verbose=False)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        counts[name] = dict(K.launch_counts)
        test = run_test(trainer, res.state, hyper, trainer.generator(5))
        fused = name == "fused"
        want = {k: 0 for k in K.launch_counts}
        want.update(contrastive_loss_fwd=n_steps,
                    contrastive_loss_bwd=n_steps)
        if fused:
            want.update(dense_block_fwd_bf16=L * n_steps,
                        dense_block_bwd_bf16=L * n_steps,
                        chain_tail_fwd_bf16=n_steps,
                        chain_tail_bwd_bf16=n_steps)
        if counts[name] != want:
            raise AssertionError(f"bf16 {name} train_loop launches "
                                 f"{counts[name]}, want {want}")
        if not (np.isfinite(res.train_losses).all()
                and res.train_losses[-1] < res.train_losses[0]):
            raise AssertionError(f"bf16 {name} train losses "
                                 f"{res.train_losses}")
        if res.train_accs[-1] <= 0.5 or float(test.accuracy) <= 0.5:
            raise AssertionError(f"bf16 {name} train acc "
                                 f"{res.train_accs[-1]}, test acc "
                                 f"{float(test.accuracy)}: not above 0.5")
        if any(p.dtype != torch.float32 for p in res.state.model.parameters()):
            raise AssertionError("bf16 training left non-f32 parameters")
        states[name] = res.state
        loops[name] = dict(train_loop_s=loop_s, train_losses=res.train_losses,
                           train_accs=res.train_accs, val_loss=res.val_loss,
                           val_acc=res.val_acc, test_loss=float(test.loss),
                           test_acc=float(test.accuracy),
                           launches={k: c for k, c in counts[name].items()
                                     if c})
        log(f"[bf16 train] {name} train_loop {TRAIN_EPOCHS} epochs "
            f"({n_steps} steps) in {loop_s:.2f} s: losses "
            f"{res.train_losses}, accs {res.train_accs}; test loss "
            f"{float(test.loss):.4f} voted acc {float(test.accuracy):.4f}; "
            f"launches {loops[name]['launches']}")

    # steps in turns: phase 7's and 8's f32 paths and the bf16 ones, each
    # on its own copy of the fused bf16 run's weights in its own dtype
    f32_fused = engine.Trainer(cfg, eager.store, adabn=False, batch_size=8,
                               use_fused_train=True)
    trainers = {"f32 eager": eager, "f32 fused": f32_fused,
                "bf16 eager": paths["eager"], "bf16 fused": paths["fused"]}
    order = list(trainers) + list(trainers)[::-1]
    turn_ms = {k: [] for k in trainers}
    weights = states["fused"].model.state_dict()
    turn_states = {name: engine.TrainState.fresh(model_from_state_dict(
        weights, dtype=tr.dtype).to(dev), tr.mu_dtype)
        for name, tr in trainers.items()}
    gen = eager.generator(11)
    emg_rand = task_permutations(gen, v.n_tasks, v.D)
    batches = epoch_batches(gen, v.D, 8)[0][:TURN_STEPS]
    for name in order:
        gen = trainers[name].generator(12)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        trainers[name].train_epoch_from_indices(
            turn_states[name], emg_rand, batches, batches.new_empty(0), hyper, 1.0, 1.0,
            gen)
        end.record()
        torch.cuda.synchronize()
        turn_ms[name].append(start.elapsed_time(end))
    windows = 8 * v.n_tasks * TURN_STEPS
    timing = {name: dict(steps=TURN_STEPS, ms=ms,
                         ms_per_step=[m / TURN_STEPS for m in ms],
                         train_windows_per_s=[windows / m * 1e3 for m in ms])
              for name, ms in turn_ms.items()}
    traces = {name: trace_train_steps(paths[name], turn_states[f"bf16 {name}"],
                                      hyper, 20)
              for name in paths}
    summary = {name: dict(device_ms_per_step=tr["device_ms_per_step"],
                          device_idle_share=tr["device_idle_share"],
                          wall_ms_per_step_traced=tr["wall_ms_per_step_traced"])
               for name, tr in traces.items()}
    summary["f32 eager (phase 7)"] = {
        k: train_res["step_trace"][k] for k in ("device_ms_per_step",
                                                "device_idle_share",
                                                "wall_ms_per_step_traced")}
    summary["f32 fused (phase 8)"] = {
        k: fused_res["step_trace"][k] for k in ("device_ms_per_step",
                                                "device_idle_share",
                                                "wall_ms_per_step_traced")}
    log(f"[bf16 train] {TURN_STEPS} steps in turns ({', '.join(order)}): "
        f"{json.dumps(timing)}; traced steps: {json.dumps(summary)}")
    log(f"[bf16 train] profiler trace of 20 fused bf16 steps: "
        f"{json.dumps(traces['fused'])}")

    # a stacked bf16 step of 2 configs against their single steps: the
    # bf16 roundings flip where the batched and single f32 sums straddle a
    # tie, and the backward compounds the flips, so the whole gradient is
    # held against the spread bf16 itself puts between the single step and
    # its f32 twin on the same weights
    bf = paths["eager"]
    sweep_state = bf.init_sweep_state([bf.generator(21), bf.generator(22)])
    gen = bf.generator(23)
    emg_rand = task_permutations(gen, v.n_tasks, v.D)
    items = torch.randperm(v.D, generator=gen, device=dev)[:16]
    emg_b = gather_train_batch(v.emg_flat, emg_rand, items).reshape(
        2, 8, v.n_tasks, -1)
    hypers = SWEEP_STEP_HYPERS[:2]
    hs = engine.Hyper(*[torch.tensor([h[i] for h in hypers], device=dev)
                        for i in range(6)])
    loss_s, _, grads_s = bf.loss_and_grads(sweep_state, emg_b, hs, None)

    def whole(grads, c=None):
        return torch.cat([(g if c is None else g[c]).reshape(-1)
                          for tower in ("emg_net", "glove_net")
                          for g in grads[tower]]).double()

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    stack_err = {}
    for c in range(2):
        single = engine.TrainState.fresh(sweep_state.model.unstack(c))
        twin = engine.TrainState.fresh(model_from_state_dict(
            single.model.state_dict()).to(dev))
        h1 = engine.Hyper.single(*hypers[c])
        loss_c, _, grads_c = bf.loss_and_grads(single, emg_b[c], h1, None)
        _, _, grads_f = eager.loss_and_grads(twin, emg_b[c], h1, None)
        torch.testing.assert_close(loss_s[c], loss_c, rtol=1e-3, atol=0)
        stack_err[c] = dict(
            loss_stacked=float(loss_s[c]), loss_single=float(loss_c),
            grad_rel_l2_stacked_vs_single=rel(whole(grads_s, c),
                                              whole(grads_c)),
            grad_rel_l2_bf16_vs_f32=rel(whole(grads_c), whole(grads_f)))
        if (stack_err[c]["grad_rel_l2_stacked_vs_single"]
                > stack_err[c]["grad_rel_l2_bf16_vs_f32"]):
            raise AssertionError(f"stacked bf16 step config {c}: "
                                 f"{stack_err[c]}")
    log(f"[bf16 train] stacked bf16 step of 2 configs against single steps "
        f"(loss rtol 1e-3; the whole gradient's relative 2-norm no larger "
        f"than the single bf16 step's from its f32 twin): "
        f"{json.dumps(stack_err)}")

    # the CLI's default sweep in bf16
    K.reset_launch_counts()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        values = cross_validate(bf, sample_hyperparams(CLI_SWEEP_CONFIGS,
                                                       seed=42),
                                epochs=1, seed=42, save_dir=tmp)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    sweep_counts = {k: c for k, c in K.launch_counts.items() if c}
    if not (np.isfinite(values).all() and np.nanmax(values[:, 1]) > 0.1):
        raise AssertionError(f"bf16 sweep values {values.tolist()}")
    if set(sweep_counts) != {*TRAIN_KERNELS, "adam_stacked"}:
        raise AssertionError(f"bf16 sweep launches {sweep_counts}")
    log(f"[bf16 train] cross_validate of {CLI_SWEEP_CONFIGS} configs x 1 "
        f"epoch in bf16: {sweep_s:.2f} s, best val acc "
        f"{float(np.nanmax(values[:, 1])):.4f}; launches {sweep_counts}")

    # the test pass of the fused bf16 state, unfused and on the fused encoder
    folded = engine.Trainer(cfg, eager.store, adabn=False, batch_size=8,
                            compute_dtype="bfloat16", use_fused_encoder=True)
    K.reset_launch_counts()
    t_unf = run_test(paths["eager"], states["fused"], hyper,
                     folded.generator(5))
    unf_counts = dict(K.launch_counts)
    K.reset_launch_counts()
    t_fus = run_test(folded, states["fused"], hyper, folded.generator(5))
    torch.cuda.synchronize()
    fus_counts = dict(K.launch_counts)
    n_batches = -(-folded.view_test.D // 64)
    if not (fus_counts["encoder_chain_bf16"] == 10 * n_batches
            and fus_counts["encoder_chain"] == 0
            and unf_counts["encoder_chain_bf16"] == 0):
        raise AssertionError(f"bf16 test pass launches: fused {fus_counts}, "
                             f"unfused {unf_counts}")
    logit_err = max_abs(t_fus.logits, t_unf.logits)
    if logit_err > BF16_ATOL or not torch.equal(t_fus.y_true, t_unf.y_true):
        raise AssertionError(f"fused bf16 test pass logits {logit_err} from "
                             "the unfused one's")
    eval_res = dict(unfused_acc=float(t_unf.accuracy),
                    fused_acc=float(t_fus.accuracy),
                    max_abs_logit_diff=logit_err,
                    encoder_chain_bf16_launches=fus_counts[
                        "encoder_chain_bf16"])
    log(f"[bf16 train] test pass of the fused bf16 state: unfused acc "
        f"{eval_res['unfused_acc']:.4f}, fused encoder acc "
        f"{eval_res['fused_acc']:.4f}, logits within {logit_err:.3g}; "
        f"encoder_chain_bf16 launched {fus_counts['encoder_chain_bf16']} "
        f"times ({n_batches} batches)")

    # the CLIs on cuda
    with tempfile.TemporaryDirectory() as tmp:
        common = ["--synthetic", "--batch_size", "8", "--no_adabn",
                  "--data_dir", tmp, "--checkpoint_dir", tmp]
        t0 = time.perf_counter()
        if cli_train.main([*common, "--bf16", "--crossval_size", "2",
                           "--final_epochs", "1", "--test", "--results_dir",
                           f"{tmp}/A"]) != 0:
            raise AssertionError("cptorch-train --bf16 failed")
        cli_s = time.perf_counter() - t0
        model_from_state_dict(load_reference_checkpoint(
            f"{tmp}/contrastive.pt"))
        for out, extra in (("B", ["--bf16"]), ("C", [])):
            if cli_results.main([*common, *extra, "--results_dir",
                                 f"{tmp}/{out}"]) != 0:
                raise AssertionError(f"cptorch-results {extra} failed")
        if not np.array_equal(np.load(f"{tmp}/B/logs.npy"),
                              np.load(f"{tmp}/C/logs.npy")):
            raise AssertionError("cptorch-results --bf16 differs from the "
                                 "f32 evaluation")
    log(f"[cli] cptorch-train --bf16 --synthetic --crossval_size 2 "
        f"--final_epochs 1 --test --results_dir ok on cuda in {cli_s:.1f} s; "
        "cptorch-results with and without --bf16 wrote the same logs.npy")
    launches = {
        "dense_block_fwd_bf16": counts["fused"]["dense_block_fwd_bf16"],
        "dense_block_bwd_bf16": counts["fused"]["dense_block_bwd_bf16"],
        "chain_tail_fwd_bf16": counts["fused"]["chain_tail_fwd_bf16"],
        "chain_tail_bwd_bf16": counts["fused"]["chain_tail_bwd_bf16"]}
    fam = traces["fused"]["device_ms_by_family"]
    per = traces["fused"]["device_launches_per_step"]
    for name, entry in entries.items():
        entry.update(name=name, source=SOURCES[name], replaces=REPLACES[name],
                     kernel_ms=entry["ms"], launches=launches[name],
                     launches_by_path={"bf16_fused_train": launches[name]},
                     device_ms_per_launch_traced=(
                         fam[name] / per[name] if per.get(name) else None))
    res = dict(train=loops, steps_in_turns=timing, traced_steps=summary,
               step_traces=traces, stacked_step=stack_err,
               sweep=dict(configs=CLI_SWEEP_CONFIGS, seconds=sweep_s,
                          values=values.tolist(), launches=sweep_counts),
               test_pass=eval_res, cli_train_s=cli_s,
               phase_s=time.perf_counter() - t_phase)
    log(f"[bf16 train] phase 14 took {res['phase_s']:.1f} s")
    return res, entries


# ------------------------------------------------------------ phase 15
TEST_NUMBERS = re.compile(r"loss,\t+correct\n(\(.*\))")


def run_captured(main, argv: list[str]) -> str:
    """An in-process CLI ``main(argv)``, which must return 0; its standard
    output."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    if rc != 0:
        raise AssertionError(f"{main.__module__} {' '.join(argv)} exited "
                             f"{rc}:\n{buf.getvalue()[-2000:]}")
    return buf.getvalue()


def run_twin(script: str, args: list[str], shim_dir: str) -> tuple[str, float]:
    """``bash scripts/<script> ARGS`` in its own process, ``python`` on its
    PATH being this interpreter; its standard output and seconds."""
    env = {**os.environ, "PATH": f"{shim_dir}{os.pathsep}{os.environ['PATH']}"}
    t0 = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    r = subprocess.run(["bash", os.path.join(repo, "scripts", script), *args],
                       capture_output=True, text=True, timeout=600, env=env,
                       cwd=repo)
    seconds = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"{script} exited {r.returncode}:\n"
                             f"{r.stdout[-2000:]}\n{r.stderr[-3000:]}")
    return r.stdout, seconds


def test_numbers(out: str, what: str) -> str:
    found = TEST_NUMBERS.search(out)
    if found is None:
        raise AssertionError(f"{what} printed no test numbers")
    return found.group(1)


def same_pair(path_a: str, path_b: str) -> None:
    """Two checkpoint pairs hold the same state_dict and Adam chains, bit
    for bit."""
    from contrastiveprosthetics_torch.train.checkpoint import load_checkpoint

    a, b = (load_checkpoint(p, torch.device("cpu")) for p in (path_a, path_b))
    sa, sb = a.model.state_dict(), b.model.state_dict()
    if set(sa) != set(sb):
        raise AssertionError("the imported state_dict has other keys")
    for name in sa:
        if sa[name].dtype != sb[name].dtype or not torch.equal(sa[name],
                                                               sb[name]):
            raise AssertionError(f"{name} differs after export and import")
    for x, y in ((a.opt_emg, b.opt_emg), (a.opt_glove, b.opt_glove)):
        if x.count != y.count or len(x.mu) != len(y.mu):
            raise AssertionError("Adam counts or chains differ")
        for u, v in zip(x.mu + x.nu, y.mu + y.nu):
            if u.dtype != v.dtype or not torch.equal(u, v):
                raise AssertionError("an Adam moment differs after export "
                                     "and import")


def interop_phase(K, cli, cli_train, cli_results) -> tuple[dict, dict]:
    """Phase 15: the go and results twins, checkpoint interop with the JAX
    format, serving from a msgpack, ``--profile`` and the ``--spmd*``
    flags on one card. Returns the results and the launch counts of the
    in-process main-path runs (serving from the msgpack, the profiled
    train)."""
    from contrastiveprosthetics_torch.cli import export_ckpt, import_ckpt
    from contrastiveprosthetics_torch.config import DEFAULT_CONFIG as cfg

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()  # room for the twins' own processes
    res: dict = {}
    counts = dict.fromkeys(K.launch_counts, 0)
    with tempfile.TemporaryDirectory() as tmp:
        data, ckpt, ckpt2 = (os.path.join(tmp, d) for d in
                             ("data", "ckpt", "ckpt2"))
        os.makedirs(data)
        repo = os.path.dirname(os.path.abspath(__file__))
        for name in ("cross_val_keys.npy", "cross_val_values.npy"):
            shutil.copy(os.path.join(repo, "data", name), data)
        shim = os.path.join(tmp, "bin")
        os.makedirs(shim)
        with open(os.path.join(shim, "python"), "w") as f:
            f.write(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
        os.chmod(os.path.join(shim, "python"), 0o755)
        dirs = ["--data_dir", data, "--checkpoint_dir", ckpt]

        # the twins: go.sh's flags (its epochs cut to 1 for the script's
        # time), then results.sh's over its checkpoint
        go, go_s = run_twin("go_torch.sh", ["--synthetic", "--final_epochs",
                                            str(TWIN_EPOCHS), *dirs], shim)
        if "no cached crossval found" in go:
            raise AssertionError("the go twin did not load the cache")
        results, results_s = run_twin(
            "results_torch.sh", ["--synthetic", "--batch_size", "8", *dirs,
                                 "--results_dir", os.path.join(tmp, "B")],
            shim)
        numbers = test_numbers(go, "the go twin")
        if test_numbers(results, "the results twin") != numbers:
            raise AssertionError(f"the twins' test numbers differ: {numbers}"
                                 f" and {test_numbers(results, '')}")
        res["twins"] = dict(go_s=go_s, results_s=results_s,
                            test_numbers=numbers)
        log(f"[interop] go_torch.sh --synthetic --final_epochs {TWIN_EPOCHS} in "
            f"{go_s:.1f} s, results_torch.sh in {results_s:.1f} s (own "
            f"processes): both print {numbers}")

        # export to the JAX format, import into a second directory
        pt, msg = os.path.join(ckpt, "contrastive.pt"), \
            os.path.join(tmp, "contrastive.msgpack")
        pt2 = os.path.join(ckpt2, "contrastive.pt")
        t0 = time.perf_counter()
        run_captured(export_ckpt.main, [pt, "--out", msg])
        export_s = time.perf_counter() - t0
        run_captured(import_ckpt.main, [msg, "--out", pt2, "--no_adabn"])
        import_s = time.perf_counter() - t0 - export_s
        same_pair(pt, pt2)
        t0 = time.perf_counter()
        out = run_captured(cli_results.main, [
            "--synthetic", "--batch_size", "8", "--no_adabn", "--data_dir",
            data, "--checkpoint_dir", ckpt2, "--results_dir",
            os.path.join(tmp, "C")])
        if test_numbers(out, "cptorch-results on the import") != numbers:
            raise AssertionError("cptorch-results over the imported pair "
                                 f"printed {test_numbers(out, '')}, the go "
                                 f"twin {numbers}")
        results_import_s = time.perf_counter() - t0
        res["interop"] = dict(export_s=export_s, import_s=import_s,
                              msgpack_bytes=os.path.getsize(msg),
                              results_on_import_s=results_import_s)
        log(f"[interop] cptorch-export {export_s:.2f} s, cptorch-import "
            f"{import_s:.2f} s ({os.path.getsize(msg)} bytes): state_dict "
            "and both Adam chains bit-equal; cptorch-results over the import "
            f"({results_import_s:.2f} s, in process) prints {numbers}")

        # serve from the msgpack and from the .pt, per tick and replayed
        rng = np.random.default_rng(15)
        rec = os.path.join(tmp, "recording.npy")
        np.save(rec, rng.standard_normal((2 * cfg.hz, cfg.emg_dim)
                                         ).astype(np.float32))
        K.reset_launch_counts()
        t0 = time.perf_counter()
        for extra in ([], ["--replay"]):
            got = []
            for src in (msg, pt):
                out_npz = os.path.join(tmp, "serve.npz")
                run_captured(cli.main, ["--checkpoint", src, "--recording",
                                        rec, "--data_dir", data, "--quiet",
                                        "--out", out_npz, *extra])
                with np.load(out_npz) as z:
                    got.append((z["preds"], z["votes"]))
            if not (np.array_equal(got[0][0], got[1][0])
                    and np.array_equal(got[0][1], got[1][1])):
                raise AssertionError(f"serve {extra} from the msgpack "
                                     "differs from serve from the .pt")
        torch.cuda.synchronize()
        serve_counts = dict(K.launch_counts)
        res["serve_4_runs_s"] = time.perf_counter() - t0
        for name in SERVE_KERNELS:
            if not serve_counts[name]:
                raise AssertionError(f"{name} never launched serving from "
                                     f"the checkpoints: {serve_counts}")
        log(f"[interop] cptorch-serve --checkpoint X.msgpack per tick and "
            "--replay: preds and votes equal to the .pt's; launches "
            f"{ {k: v for k, v in serve_counts.items() if v} }")

        # --profile: one epoch with and without the trace, at batch size
        # 64 (28 steps): the trace needs K1f records, not many of them
        prof_args = ["--synthetic", "--crossval_size", "0", "--final_epochs",
                     "1", "--batch_size", "64", "--no_adabn", "--data_dir",
                     data, "--checkpoint_dir", os.path.join(tmp, "p")]
        t0 = time.perf_counter()
        run_captured(cli_train.main, prof_args)
        plain_s = time.perf_counter() - t0
        K.reset_launch_counts()
        t0 = time.perf_counter()
        out = run_captured(cli_train.main, [*prof_args, "--profile"])
        profile_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        train_counts = dict(K.launch_counts)
        for name in TRAIN_KERNELS:
            if not train_counts[name]:
                raise AssertionError(f"{name} never launched in the profiled "
                                     f"run: {train_counts}")
        if f"profile trace written to {cli_train.trace_dir()}" not in out:
            raise AssertionError("--profile printed no trace path")
        path = out.split("profile trace written to")[1].splitlines()[1].strip()
        with open(path) as f:
            trace = json.load(f)
        size_mb = os.path.getsize(path) / 1e6
        os.remove(path)
        k1f = sum(1 for e in trace["traceEvents"]
                  if e.get("cat") == "kernel"
                  and "contrastive_loss_fwd" in e.get("name", ""))
        if not k1f:
            raise AssertionError("the trace holds no contrastive_loss_fwd "
                                 "device record")
        res["profile"] = dict(plain_s=plain_s, profile_s=profile_s,
                              trace_mb=size_mb, k1f_device_records=k1f,
                              k1f_launches=train_counts[
                                  "contrastive_loss_fwd"])
        log(f"[interop] cptorch-train --crossval_size 0 --final_epochs 1: "
            f"{plain_s:.2f} s, with --profile {profile_s:.2f} s; trace "
            f"{size_mb:.1f} MB, {k1f} contrastive_loss_fwd device records "
            f"of {train_counts['contrastive_loss_fwd']} launches")

        # --spmd_crossval and --spmd run unsharded on the one card
        t0 = time.perf_counter()
        out = run_captured(cli_train.main, [
            "--spmd_crossval", "--synthetic", "--crossval_size", "2",
            "--final_epochs", "1", "--no_adabn",
            "--data_dir", os.path.join(tmp, "s"), "--checkpoint_dir",
            os.path.join(tmp, "s")])
        out += run_captured(cli.main, ["--spmd", "--demo", "--sessions", "8",
                                       "--replay", "--quiet"])
        spmd_s = time.perf_counter() - t0
        for flag in ("--spmd_crossval: 1 cuda device visible",
                     "--spmd: 1 cuda device visible"):
            if flag not in out:
                raise AssertionError(f"no '{flag}' line")
        res["spmd_s"] = spmd_s
        log(f"[interop] --spmd_crossval (2 configs) and --spmd --sessions 8 "
            f"--replay ran unsharded on one card in {spmd_s:.1f} s")
    for name in SERVE_KERNELS:
        counts[name] = serve_counts[name]
    for name in TRAIN_KERNELS:
        counts[name] = train_counts[name]
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"[interop] phase 15 took {res['phase_s']:.1f} s")
    return res, counts


# ------------------------------------------------------------ phase 16
AXIS_CONFIGS = (1, 2, 150)         # K5f, K5b and the tail pair
ENCODER_CONFIGS = (1, 2, 10, 150)  # encoder_chain
VAL_ROWS = 8 * 41 * 25             # a val batch of 8 items, one config
AXIS_K5 = FUSED_KERNELS[:4]        # the chain's kernels with a config axis
REMAT_STACKED_STEPS = 20
REMAT_STEPS = 45  # a single model's remat run: cut from an epoch (225)
SMALL_SWEEP_CONFIGS = 10           # phase 16's bf16 and glove-encoding sweeps


def device_ms_whole(fn, launches: float, n: int = 20, tries: int = 5):
    """Device milliseconds per call of ``fn`` from a profiler trace of
    ``n`` calls in which every one of its ``launches`` kernel launches a
    call was recorded: a trace now and then drops records (in one run at
    C=150, 4 of an ``encoder_chain`` call's 30), so up to ``tries`` traces
    are taken. Returns (ms, traces that dropped records); ms is None when
    every trace dropped some."""
    for i in range(tries):
        ms, per_call = device_per_call(fn, n)
        if per_call == launches:
            return ms, i
    return None, tries


def k5_stacked(C: int, N: int, K_in: int, F: int, seed: int, dev):
    """C configs' dense-block inputs at the chain's widths, drawn on the
    card: ReLU outputs as input (C, N, K_in), the previous block's (C, 5,
    K_in) statistics, Linear-scaled weights in ``StackedLinear``'s layout
    (C, F, K_in) as the chain takes them, ``.transpose(1, 2)``, the
    vectors, the gradient from above, one pair of seed words and one keep
    in the sweep's range (rates 0.4-0.6) a config."""
    g = torch.Generator(dev).manual_seed(seed)

    def u(*shape):
        return torch.rand(*shape, generator=g, device=dev)

    def n(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    x = n(C, N, K_in).clamp_min_(0.0)
    mean, var = 0.2 + 0.4 * u(C, K_in), 0.2 + 0.3 * u(C, K_in)
    rstd = torch.rsqrt(var + 1e-5)
    a = (0.8 + 0.4 * u(C, K_in)) * rstd
    in_stats = torch.stack([mean, var, rstd, a, 0.1 * n(C, K_in) - mean * a],
                           1)
    w = ((2.0 * u(C, F, K_in) - 1.0) / np.sqrt(K_in)).transpose(1, 2)
    b, gamma, beta = 0.1 * n(C, F), 0.8 + 0.4 * u(C, F), 0.1 * n(C, F)
    dz = 0.01 * n(C, N, F)
    seeds = torch.randint(-2**31, 2**31, (C, 2), dtype=torch.int32,
                          generator=g, device=dev)
    keep = 0.4 + 0.2 * u(C)
    return x, w, b, gamma, beta, in_stats, dz, seeds, keep


def k5_axis_case(TF, C, N, K_in, inner, bf16, dev):
    """One config-axis case of the chain's four kernels: the block's
    forward and backward (block 0: 768 inputs, no affine, no dropout; an
    inner block: affine + drawn dropout) and the tail pair on its output,
    each beside its plain version. Returns the inputs, the kernels'
    outputs and the plain versions'."""
    x, w, b, gamma, beta, in_stats, dz, seeds, keep = k5_stacked(
        C, N, K_in, 512, 1000 * C + N + K_in, dev)
    if bf16:
        x, w, dz = (t.to(torch.bfloat16) for t in (x, w, dz))
    kw = dict(seed=seeds, keep=keep, drop_block=3) if inner else {}
    ins = in_stats if inner else None
    td = dict(seed=seeds, keep=keep, drop_block=6)
    r_p, st_p = TF.dense_block_fwd_reference(x, w, b, gamma, beta, ins, **kw)
    dzf = dz.float()
    sums = torch.stack([dzf.sum(1), (dzf * (r_p.float() - st_p[:, :1])
                                     * st_p[:, 2:3]).sum(1)], 1)
    args = dict(x=x, w=w, b=b, gamma=gamma, beta=beta, ins=ins, dz=dz,
                sums=sums, r=r_p, st=st_p, kw=kw, td=td, seeds=seeds,
                keep=keep)

    def kernels():
        return (TF.dense_block_fwd(x, w, b, gamma, beta, ins, **kw),
                TF.dense_block_bwd(dz, r_p, x, w, st_p, sums, ins, **kw),
                TF.chain_tail_fwd(r_p, st_p, **td),
                TF.chain_tail_bwd(dz, r_p, st_p, **td))

    plain = (TF.dense_block_fwd_reference(x, w, b, gamma, beta, ins, **kw),
             TF.dense_block_bwd_reference(dz, r_p, x, w, st_p, sums, ins,
                                          **kw),
             TF.chain_tail_fwd_reference(r_p, st_p, **td),
             TF.chain_tail_bwd_reference(dz, r_p, st_p, **td))
    return args, kernels, plain


def hold_k5_axis(got, plain, bf16: bool) -> dict:
    """The config-axis kernels against their plain versions at the
    single-config rows' tolerances: f32 r rtol 1e-5, the rest rtol 1e-4
    (atol 1e-5 x max); bf16 r and dx within one bf16 ulp, the rest as
    f32 but the statistics at phase 14's rtol 1e-3, atol 1e-3 x max (a
    bf16 flip of r moves them); the tail's h and dz bit for bit, its sums
    within one f32 ulp.
    Returns the max abs errors by kernel."""
    (r, st), bwd, h, (tz, ts) = got
    (r_p, st_p), bwd_p, h_p, (tz_p, ts_p) = plain
    if bf16:
        within_one_bf16_ulp(r, r_p)
        within_one_bf16_ulp(bwd[0], bwd_p[0])
        fwd_err = max(max_abs(r, r_p), close(st, st_p, 1e-3, 1e-3))
        bwd_err = max([max_abs(bwd[0], bwd_p[0])]
                      + [close(g, v, 1e-4, 1e-5)
                         for g, v in zip(bwd[1:], bwd_p[1:]) if v is not None])
    else:
        fwd_err = max(close(r, r_p, 1e-5, 1e-5), close(st, st_p, 1e-4, 1e-5))
        bwd_err = max(close(g, v, 1e-4, 1e-5) for g, v in zip(bwd, bwd_p)
                      if v is not None)
    if not (torch.equal(h, h_p) and torch.equal(tz, tz_p)):
        raise AssertionError("the config-axis tail's h or dz is not "
                             "bit-equal to its plain version")
    within_one_ulp(ts, ts_p)
    return {"dense_block_fwd": fwd_err, "dense_block_bwd": bwd_err,
            "chain_tail_fwd": 0.0, "chain_tail_bwd": max_abs(ts, ts_p)}


def k5_singles_equal(TF, a, got) -> bool:
    """Every config's outputs in a config-axis launch against a launch of
    each kernel on that config alone, bit for bit."""
    (r, st), bwd, h, (tz, ts) = got
    same = []
    for c in range(a["x"].shape[0]):
        kw = dict(a["kw"])
        td = dict(a["td"], seed=a["seeds"][c], keep=a["keep"][c:c + 1])
        if kw:
            kw.update(seed=a["seeds"][c], keep=a["keep"][c:c + 1])
        ins = None if a["ins"] is None else a["ins"][c]
        r1, st1 = TF.dense_block_fwd(a["x"][c], a["w"][c], a["b"][c],
                                     a["gamma"][c], a["beta"][c], ins, **kw)
        b1 = TF.dense_block_bwd(a["dz"][c], a["r"][c], a["x"][c], a["w"][c],
                                a["st"][c], a["sums"][c], ins, **kw)
        h1 = TF.chain_tail_fwd(a["r"][c], a["st"][c], **td)
        tz1, ts1 = TF.chain_tail_bwd(a["dz"][c], a["r"][c], a["st"][c], **td)
        same += [torch.equal(r[c], r1), torch.equal(st[c], st1),
                 torch.equal(h[c], h1), torch.equal(tz[c], tz1),
                 torch.equal(ts[c], ts1)]
        same += [torch.equal(g[c], v) for g, v in zip(bwd, b1)
                 if v is not None]
    return all(same)


def check_k5_config_axis(TF, dev) -> dict:
    """Phase 16, part 1a: K5f, K5b and the tail pair at their config axis
    against their plain versions at C=1, 2 and 150, N=328 (bs 8 x 41) and
    a ragged 123, block 0 (768 -> 512) and an inner dropped block (512 ->
    512), f32 and bf16 (:func:`hold_k5_axis`); a rerun bit-identical;
    every config of the C=2 and C=150 launches bit-equal to a launch on
    that config alone (N=328, inner block). Then each kernel timed at
    C=150, N=328, the inner block, f32 and bf16: CUDA events per call,
    profiler device time per launch (:func:`device_ms_whole`), its plain
    version, the bound (3xTF32 or bf16 products on the tensor cores, the
    bytes) and, by CUDA events, the stacked eager step's batched GEMMs
    beside it (``torch.baddbmm`` of the forward; the backward's two
    ``torch.bmm``): not the same function, so not ``library_ms``. Returns
    the eight ``kernels`` entries."""
    errs: dict = {}
    singles: dict = {}
    for bf16 in (False, True):
        suffix = "_bf16" if bf16 else ""
        for C in AXIS_CONFIGS:
            for N in (328, 123):
                for K_in, inner in ((768, False), (512, True)):
                    a, kernels, plain = k5_axis_case(TF, C, N, K_in, inner,
                                                     bf16, dev)
                    got = kernels()
                    case = f"C={C} N={N} K={K_in}"
                    for name, err in hold_k5_axis(got, plain, bf16).items():
                        errs.setdefault(name + suffix, {})[case] = err
                    again = kernels()
                    flat = [t for part in (got, again) for grp in part
                            for t in (grp if isinstance(grp, tuple) else
                                      (grp,)) if t is not None]
                    half = len(flat) // 2
                    if not all(torch.equal(p, q) for p, q in
                               zip(flat[:half], flat[half:])):
                        raise AssertionError(f"config-axis K5 not "
                                             f"bit-identical on a rerun at "
                                             f"{case}{suffix}")
                    if C > 1 and N == 328 and inner:
                        if not k5_singles_equal(TF, a, got):
                            raise AssertionError(
                                f"a config of the C={C} launch differs from "
                                f"its single-config launch{suffix}")
                        singles[f"C={C}{suffix}"] = "bit-equal, every config"
                    del a, kernels, plain, got, again, flat
    log(f"[config axis] K5f, K5b and the tail pair against their plain "
        f"versions: {json.dumps(errs)}; reruns bit-identical; single-config "
        f"launches: {json.dumps(singles)}")

    entries = {}
    C, N, K_in, F = 150, 328, 512, 512
    for bf16 in (False, True):
        suffix = "_bf16" if bf16 else ""
        a, kernels, _ = k5_axis_case(TF, C, N, K_in, True, bf16, dev)
        (r, st), (dx, dw, db, osums), h, (tz, ts) = kernels()
        x, w, dz, sums, kw, td = (a[k] for k in ("x", "w", "dz", "sums",
                                                   "kw", "td"))
        small = nbytes(a["b"], a["gamma"], a["beta"], a["ins"], a["seeds"],
                       a["keep"])
        macs = float(C) * N * K_in * F
        peak, products = ((PEAK_BF16_FLOPS, 1) if bf16
                          else (PEAK_TF32_FLOPS, 3))
        wt = w.transpose(1, 2)
        specs = {
            "dense_block_fwd": (
                lambda: TF.dense_block_fwd(x, w, a["b"], a["gamma"],
                                           a["beta"], a["ins"], **kw),
                lambda: TF.dense_block_fwd_reference(
                    x, w, a["b"], a["gamma"], a["beta"], a["ins"], **kw),
                bound_ms(nbytes(x, w, r, st) + small, products * 2 * macs,
                         peak),
                lambda: torch.baddbmm(a["b"].unsqueeze(1).to(x.dtype), x, w),
                "torch.baddbmm(b, x, W): the stacked eager step's dense "
                "layer, without the input's affine and dropout, the ReLU "
                "and the column statistics"),
            "dense_block_bwd": (
                lambda: TF.dense_block_bwd(dz, a["r"], x, w, a["st"], sums,
                                           a["ins"], **kw),
                lambda: TF.dense_block_bwd_reference(
                    dz, a["r"], x, w, a["st"], sums, a["ins"], **kw),
                bound_ms(nbytes(dz, a["r"], x, w, a["st"], sums, dx, dw, db,
                                osums) + small, products * 4 * macs, peak),
                lambda: (torch.bmm(dz, wt), torch.bmm(x.transpose(1, 2), dz)),
                "torch.bmm(dy, W^T) and torch.bmm(h^T, dy): the stacked eager "
                "step's two GEMMs of the layer, without the BatchNorm "
                "backward, the input's affine and dropout, db and the "
                "lower block's sums"),
            "chain_tail_fwd": (
                lambda: TF.chain_tail_fwd(a["r"], a["st"], **td),
                lambda: TF.chain_tail_fwd_reference(a["r"], a["st"], **td),
                bound_ms(nbytes(a["r"], a["st"], h, a["seeds"], a["keep"]),
                         0.0), None, None),
            "chain_tail_bwd": (
                lambda: TF.chain_tail_bwd(dz, a["r"], a["st"], **td),
                lambda: TF.chain_tail_bwd_reference(dz, a["r"], a["st"],
                                                    **td),
                bound_ms(nbytes(dz, a["r"], a["st"], tz, ts, a["seeds"],
                                a["keep"]), 0.0), None, None)}
        with torch.no_grad():
            for name, (kernel, plain, (bd, by), eager, note) in specs.items():
                full = name + suffix
                entry = dict(
                    name=f"{full}@C{C}", kernel=full, route="cuda",
                    source=SOURCES[full], replaces=REPLACES[full],
                    configs=C,
                    shape=(f"C={C} configs x N={N} rows, {K_in}->{F}, "
                           "affine + dropout at each config's rate "
                           "(0.4-0.6) on the input" if "block" in name else
                           f"C={C} configs x N={N} rows, F={F}, each "
                           "config's dropout of block 6"),
                    max_abs_err=max(errs[full].values()),
                    max_abs_err_parts=errs[full],
                    tolerance=(
                        "h and dz bit for bit, the sums within one f32 ulp"
                        if "tail" in name else
                        "r and dx within one bf16 ulp, the statistics rtol "
                        "1e-3, atol 1e-3 x max, the rest rtol 1e-4, atol "
                        "1e-5 x max" if bf16 else
                        "r rtol 1e-5, the rest rtol 1e-4, atol 1e-5 x max"),
                    single_config_launches="every config bit-equal at C=2 "
                                           "and C=150",
                    ms=time_ms(kernel, 50, 3),
                    plain_ms=time_ms(plain, 3, 1),
                    bound_ms=bd, bound_by=by, library_ms=None,
                    library_note=("no single PyTorch call computes it"
                                  + ("" if eager is None else
                                     "; the stacked eager layer's batched "
                                     "GEMMs are timed beside it")))
                entry["device_ms"], entry["traces_with_dropped_records"] = \
                    device_ms_whole(kernel, 1)
                if eager is not None:
                    # CUDA events: the cuBLAS calls' own kernel counts vary
                    entry.update(eager_bmm_ms=time_ms(eager, 50, 3),
                                 eager_bmm_note=note)
                entries[full] = entry
        del a, kernels
    log(f"[config axis] K5 family at C={C}, N={N}, {K_in}->{F}, ms and "
        f"device ms a launch: " + json.dumps(
            {k: [e["ms"], e["device_ms"], e["bound_ms"], e.get("eager_bmm_ms")]
             for k, e in entries.items()}))
    return entries


def baddbmm_chain(frames, folded, bmm=None):
    """The stacked eager val's form of a stacked folded chain: one batched
    GEMM per layer for all C configs (``torch.baddbmm`` with the bias,
    ReLU in place; a bf16 fold through ``bmm`` on bf16 operands with f32
    output), the head's norm and the class scores: the same function as
    ``encoder_chain`` at its config axis, the library yardstick."""
    *ws, gt = folded
    if bmm is None:
        h = frames
        for j in range(0, len(ws) - 2, 2):
            h = torch.baddbmm(ws[j + 1].unsqueeze(1), h, ws[j]).relu_()
        e = torch.baddbmm(ws[-1].unsqueeze(1), h, ws[-2])
        e = e / torch.linalg.vector_norm(e, dim=-1, keepdim=True)
        return torch.bmm(e, gt)
    h = frames.to(torch.bfloat16)
    for j in range(0, len(ws) - 2, 2):
        h = bmm(h, ws[j]).add_(ws[j + 1].unsqueeze(1)).relu_().to(
            torch.bfloat16)
    e = bmm(h, ws[-2]).add_(ws[-1].unsqueeze(1))
    e = e / torch.linalg.vector_norm(e, dim=-1, keepdim=True)
    return bmm(e.to(torch.bfloat16), gt)


def check_encoder_config_axis(K, trainer, dev) -> dict:
    """Phase 16, part 1b: ``encoder_chain`` at its config axis on a
    stacked fold of 150 configs (``fold_encoder_params`` of a
    ``StackedEMGNet`` from the sweep's init, running statistics drawn away
    from the identity), 8,200 rows a config (a val batch of 8 items), at
    C=1, 2, 10 and 150, f32 and bf16: both tilings bit-equal to each other
    and to a rerun, against the plain version (f32 rtol 2e-4, atol 2e-5;
    bf16 atol 0.05), every config bit-equal to a call on its own fold, and
    at C=2 both against float64 (bf16: no farther than the plain version,
    phase 13's ratios). Timed at C=150 (the large tiling, as
    ``encoder_regime`` picks for 8,200 rows): CUDA events, device time per
    launch, the plain version, the ``baddbmm`` chain (``library_ms``: the
    same function) and the bound. Returns the two ``kernels`` entries."""
    from contrastiveprosthetics_torch.models.stacked import (
        StackedContrastiveModel,
    )

    C_max = max(ENCODER_CONFIGS)
    model = StackedContrastiveModel.from_models(
        [trainer._model(trainer.generator(900 + c))
         for c in range(C_max)]).eval()
    g = torch.Generator(dev).manual_seed(16)
    with torch.no_grad():
        for bn in model.emg_net.norms():
            bn.running_mean.normal_(0.0, 0.2, generator=g)
            bn.running_var.uniform_(0.5, 2.0, generator=g)
    torch.cuda.synchronize()
    frames = torch.randn(C_max, VAL_ROWS, 12, generator=g, device=dev)
    bmm, bmm_name = mm_f32_out(torch.bmm)
    entries, summary = {}, {}
    for dtype, name in ((torch.float32, "encoder_chain"),
                        (torch.bfloat16, "encoder_chain_bf16")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fold = K.fold_encoder_params(model.emg_net, model.encode_classes(),
                                     dtype=dtype)
        torch.cuda.synchronize()
        fold_ms = (time.perf_counter() - t0) * 1e3
        errs, vs_f64 = {}, {}
        for C in ENCODER_CONFIGS:
            fc, fr = tuple(x[:C] for x in fold), frames[:C]
            plan = K.encoder_plan(fc)
            outs = [K.encoder_chain(fr, plan, regime) for regime in (0, 1)]
            again = K.encoder_chain(fr, plan, 1)
            if not (torch.equal(outs[0], outs[1])
                    and torch.equal(outs[1], again)):
                raise AssertionError(f"{name} at C={C}: the tilings or a "
                                     "rerun differ")
            want = K.fused_encoder_logits_reference(fr, fc)
            if dtype == torch.float32:
                torch.testing.assert_close(outs[1], want, rtol=2e-4,
                                           atol=2e-5)
            elif max_abs(outs[1], want) > BF16_ATOL:
                raise AssertionError(f"{name} at C={C}: "
                                     f"{max_abs(outs[1], want)} from its "
                                     "plain version")
            errs[f"C={C}"] = max_abs(outs[1], want)
            for c in range(C):
                one = K.encoder_chain(fr[c], K.encoder_plan(
                    tuple(x[c] for x in fc)), 1)
                if not torch.equal(one, outs[1][c]):
                    raise AssertionError(f"{name}: config {c} of C={C} "
                                         "differs from a call on its fold")
            if C == 2:
                f64 = (tuple(x.double() for x in fc) if dtype == torch.float32
                       else f64_operands(fc))
                ref = K.fused_encoder_logits_reference(fr.double(), f64)
                k_err = (outs[1].double() - ref).abs()
                p_err = (want.double() - ref).abs()
                vs_f64 = dict(kernel_max=float(k_err.max()),
                              kernel_mean=float(k_err.mean()),
                              plain_max=float(p_err.max()),
                              plain_mean=float(p_err.mean()))
                if dtype == torch.bfloat16 and (
                        vs_f64["kernel_mean"] > BF16_F64_MEAN
                        * vs_f64["plain_mean"]
                        or vs_f64["kernel_max"] > BF16_F64_MAX
                        * vs_f64["plain_max"]):
                    raise AssertionError(f"{name} farther from float64 than "
                                         f"its plain version: {vs_f64}")
                del ref, k_err, p_err, f64
            del outs, again, want
        C = C_max
        plan = K.encoder_plan(fold)
        regime = K.encoder_regime(VAL_ROWS, dtype)
        out = K.encoder_chain(frames, plan, regime)
        per_call = plan.n_hidden + 1
        device_ms, dropped = device_ms_whole(
            lambda: K.encoder_chain(frames, plan, regime), per_call, 3)
        if dtype == torch.float32:
            b = encoder_bounds(tuple(x[0] for x in fold), C * VAL_ROWS,
                               (frames, out, *fold))
            library = lambda: baddbmm_chain(frames, fold)  # noqa: E731
            lib_name = "torch.baddbmm chain (the stacked eager val's form)"
        else:
            b = encoder_bf16_bounds(tuple(x[0] for x in fold), C * VAL_ROWS,
                                    (frames, out, *fold))
            library = lambda: baddbmm_chain(frames, fold, bmm)  # noqa: E731
            lib_name = f"a {bmm_name} chain"
        entries[name] = dict(
            name=f"{name}@C{C}", kernel=name, route="cuda",
            source=SOURCES[name], replaces=REPLACES[name], configs=C,
            shape=f"C={C} configs x {VAL_ROWS} rows (a val batch of 8 items "
                  f"each), stacked fold, no affines, regime {regime}",
            max_abs_err=max(errs.values()), max_abs_err_by_C=errs,
            max_abs_err_vs_f64_at_C2=vs_f64,
            tolerance=("rtol 2e-4 atol 2e-5 against the plain version"
                       if dtype == torch.float32 else
                       "atol 0.05 against the plain version, no farther from "
                       "float64 (phase 13's ratios)"),
            single_config_calls="every config bit-equal at C=2, 10 and 150",
            ms=time_ms(lambda: K.encoder_chain(frames, plan, regime), 3, 1),
            device_ms=device_ms, device_launches_per_call=per_call,
            device_ms_per_launch=(None if device_ms is None
                                  else device_ms / per_call),
            traces_with_dropped_records=dropped,
            plain_ms=time_ms(lambda: K.fused_encoder_logits_reference(
                frames, fold), 2, 1),
            library_ms=time_ms(library, 3, 1), library_name=lib_name,
            fold_ms=fold_ms, **b)
        summary[name] = [entries[name][k] for k in ("ms", "device_ms",
                                                    "bound_ms", "plain_ms",
                                                    "library_ms", "fold_ms")]
        del fold, plan, out
        torch.cuda.empty_cache()
    log(f"[config axis] encoder_chain at C=1, 2, 10, 150 x {VAL_ROWS} rows: "
        f"both tilings and reruns bit-equal, every config bit-equal to its "
        f"own call; at C={C_max} [ms, device ms, bound, plain, baddbmm "
        f"chain, fold ms]: {json.dumps(summary)}")
    del model, frames
    return entries


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic algorithms (cuDNN's convolutions among them;
    the trainer's ``f32_convolutions`` context leaves cuDNN's own flag
    off), for runs that must repeat bit for bit. Warnings only where an
    operation has none."""
    import warnings

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            yield
    finally:
        torch.use_deterministic_algorithms(False)


def same_state(a, b) -> bool:
    """Two train states hold the same parameters, buffers and Adam
    chains, bit for bit."""
    sa, sb = a.model.state_dict(), b.model.state_dict()
    if sa.keys() != sb.keys() or not all(torch.equal(sa[k], sb[k])
                                         for k in sa):
        return False
    return all(x.count == y.count and all(
        torch.equal(u, v) for u, v in zip(x.mu + x.nu, y.mu + y.nu))
        for x, y in ((a.opt_emg, b.opt_emg), (a.opt_glove, b.opt_glove)))


def remat_check(K, trainer) -> dict:
    """Phase 16, part 2: ``Trainer(remat=True)`` on phase 7's store, bs 8:
    45 steps (a fifth of an epoch, cut for the script's time) eager and
    fused, f32 and bf16, and 20 stacked
    steps of the 150 sampled configs eager and fused, each with remat off
    and on from the same seeds, dropout on, under deterministic
    algorithms: parameters, running statistics, both Adam chains, the
    losses and accuracies and the dropout generator's state bit-equal.
    The forward's kernels launch twice a step with remat (K5f 14, the
    tail's forward 2, K1f 2), the backward's once (K5b 7, the tail's
    backward 1, K1b 1); without remat 7/7/1/1 and K1 1/1, by the
    wrappers' counts. ms per step (CUDA events) and the peak of
    ``torch.cuda.max_memory_allocated`` beside remat off: reported, not
    compared."""
    from contrastiveprosthetics_torch.data.sampler import (
        epoch_batches,
        task_permutations,
    )
    from contrastiveprosthetics_torch.train import crossval, engine

    hyper = engine.Hyper.single(*CANONICAL)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    res = {}

    def timed(run):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        start.record()
        out = run()
        end.record()
        torch.cuda.synchronize()
        return (out, start.elapsed_time(end),
                torch.cuda.max_memory_allocated() / 1e9,
                dict(K.launch_counts))

    def want_counts(fused, bf16, remat, steps):
        if not fused:
            return {k: 0 for k in AXIS_K5}
        sfx = "_bf16" if bf16 else ""
        n = 2 if remat else 1
        return {"dense_block_fwd" + sfx: 7 * n * steps,
                "dense_block_bwd" + sfx: 7 * steps,
                "chain_tail_fwd" + sfx: n * steps,
                "chain_tail_bwd" + sfx: steps,
                "contrastive_loss_fwd": n * steps,
                "contrastive_loss_bwd": steps}

    with deterministic():
        for path, fused, dtype in (("eager", False, "float32"),
                                   ("fused", True, "float32"),
                                   ("eager_bf16", False, "bfloat16"),
                                   ("fused_bf16", True, "bfloat16")):
            runs = {}
            for remat in (False, True):
                tr = engine.Trainer(trainer.cfg, trainer.store, adabn=False,
                                    batch_size=8, use_fused_train=fused,
                                    compute_dtype=dtype, remat=remat)
                state = tr.init_state(tr.generator(70))
                gen = tr.generator(71)
                v = tr.view_train
                emg_rand = task_permutations(gen, v.n_tasks, v.D)
                batches, tail = epoch_batches(gen, v.D, 8)
                batches, tail = batches[:REMAT_STEPS], tail[:0]
                steps = batches.shape[0]
                out, ms, peak, counts = timed(
                    lambda: tr.train_epoch_from_indices(
                        state, emg_rand, batches, tail, hyper, 1.0, 1.0,
                        gen))
                want = want_counts(fused, dtype == "bfloat16", remat, steps)
                if any(counts[k] != n for k, n in want.items()):
                    raise AssertionError(f"{path} remat={remat}: launches "
                                         f"{counts}, want {want}")
                runs[remat] = (state, out, gen.get_state(), ms / steps, peak)
            (s0, o0, g0, ms0, p0), (s1, o1, g1, ms1, p1) = runs[False], \
                runs[True]
            if not (same_state(s0, s1) and torch.equal(o0[0], o1[0])
                    and torch.equal(o0[1], o1[1]) and torch.equal(g0, g1)):
                raise AssertionError(f"{path}: remat is not bit-equal to the "
                                     "stored forward")
            res[path] = dict(steps=steps, ms_per_step=ms0,
                             ms_per_step_remat=ms1, peak_gb=p0,
                             peak_gb_remat=p1, bit_equal=True)
            del runs, s0, s1

        hypers = crossval.sample_hyperparams(SWEEP_CONFIGS, seed=42)
        n = REMAT_STACKED_STEPS
        for path, fused in (("stacked_eager", False), ("stacked_fused", True)):
            runs = {}
            for remat in (False, True):
                tr = engine.Trainer(trainer.cfg, trainer.store, adabn=False,
                                    batch_size=8, use_fused_train=fused,
                                    remat=remat)
                inputs = sweep_inputs(tr, hypers, seed=16)
                out, ms, peak, counts = timed(
                    lambda: run_sweep_steps(tr, inputs, 0, n))
                want = want_counts(fused, False, remat, n)
                if any(counts[k] != c for k, c in want.items()):
                    raise AssertionError(f"{path} remat={remat}: launches "
                                         f"{counts}, want {want}")
                runs[remat] = (inputs[0], out, inputs[4].get_state(), ms / n,
                               peak)
                del inputs
            (s0, o0, g0, ms0, p0), (s1, o1, g1, ms1, p1) = runs[False], \
                runs[True]
            if not (same_state(s0, s1) and torch.equal(o0[0], o1[0])
                    and torch.equal(o0[1], o1[1]) and torch.equal(g0, g1)):
                raise AssertionError(f"{path}: remat is not bit-equal to the "
                                     "stored forward")
            res[path] = dict(configs=SWEEP_CONFIGS, steps=n, ms_per_step=ms0,
                             ms_per_step_remat=ms1, peak_gb=p0,
                             peak_gb_remat=p1, bit_equal=True)
            del runs, s0, s1
    torch.cuda.empty_cache()
    log(f"[remat] bit-equal to remat off (parameters, statistics, Adam, "
        f"losses, generator): {json.dumps(res)}")
    return res


def fused_sweep_check(K, trainer, eager=None) -> dict:
    """Phase 16, parts 3 and 4: ``cross_validate`` of go.sh's 150 configs x
    1 epoch on the fused chain and the fused encoder, in turns with the
    eager sweep (``eager``: phase 9's run of it, its ``sweep`` results;
    None: run it here after the fused one): configs/s and ms per stacked
    step; per
    stacked fused step 7 K5f, 7 K5b, 1 of each tail kernel and K1 once,
    ``encoder_chain`` 10 times per val batch, none of them on the eager
    sweep (K1 aside); traces of 10 stacked fused steps at C=2 and C=150
    (device time, idle share; the wrappers' launches per step equal at
    both); a 3-config chunk at dropout 0 fused against eager (val losses
    at rtol 1e-3, the voted accuracies within one vote: the CPU tests'
    tolerances); the bf16 and the glove-encoding fused sweeps of 10
    configs; the sweep's val of 150 configs on the fused encoder against
    the unfused one from one index draw (losses rtol 1e-4, accuracies
    within 3 votes a config), both timed. Returns the results with the
    launch counts of the main-path sweeps."""
    from contrastiveprosthetics_torch.data.sampler import (
        stacked_epoch_batches_padded,
    )
    from contrastiveprosthetics_torch.train import crossval, engine

    cfg, store = trainer.cfg, trainer.store
    n = SWEEP_CONFIGS
    hypers = crossval.sample_hyperparams(n, seed=42)
    fused = engine.Trainer(cfg, store, adabn=False, batch_size=8,
                           use_fused_train=True, use_fused_encoder=True)
    v, vv = fused.view_train, fused.view_val
    steps = -(-v.D // 8)
    val_batches = -(-vv.D // 8)
    windows = 8 * v.n_tasks
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    res, counts = {}, {}

    def sweep(tr, hy, name):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        start.record()
        values = crossval.cross_validate(tr, hy, SWEEP_EPOCHS, seed=42,
                                         verbose=False)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        C = len(hy.lr_emg)
        counts[name] = dict(K.launch_counts)
        best = float(np.nanmax(values[:, 1]))
        if best <= 0.1:
            raise AssertionError(f"{name}: best val accuracy {best}")
        res[name] = dict(configs=C, sweep_ms=ms, configs_per_s=C / ms * 1e3,
                         windows_per_s=C * steps * windows / ms * 1e3,
                         ms_per_stacked_step_all_in=ms / steps,
                         peak_device_memory_gb=torch.cuda.max_memory_allocated()
                         / 1e9, best_val_acc=best,
                         finite=int(np.isfinite(values).all(1).sum()))
        return values

    def hold(name, bf16, encoder):
        sfx = "_bf16" if bf16 else ""
        got = counts[name]
        want = {"dense_block_fwd" + sfx: 7 * steps,
                "dense_block_bwd" + sfx: 7 * steps,
                "chain_tail_fwd" + sfx: steps, "chain_tail_bwd" + sfx: steps,
                "contrastive_loss_fwd": steps, "contrastive_loss_bwd": steps,
                "encoder_chain" + sfx: 10 * val_batches if encoder else 0}
        if any(got[k] != c for k, c in want.items()):
            raise AssertionError(f"{name} launches {got}, want {want}")

    sweep(fused, hypers, "fused")
    if eager is None:
        sweep(trainer, hypers, "eager")
    else:
        res["eager"] = dict(
            {k: eager[k] for k in ("configs", "sweep_ms", "configs_per_s",
                                   "windows_per_s", "best_val_acc",
                                   "ms_per_stacked_step_all_in",
                                   "peak_device_memory_gb", "finite")},
            run="phase 9's cross_validate, before this phase's fused one")
        counts["eager"] = eager["launches"]
    hold("fused", False, True)
    if any(counts["eager"][k] for k in (*AXIS_K5, "encoder_chain")):
        raise AssertionError(f"the eager sweep launched fused kernels: "
                             f"{counts['eager']}")
    res["fused_over_eager_configs_per_s"] = (res["fused"]["configs_per_s"]
                                             / res["eager"]["configs_per_s"])
    log(f"[sweep fused] cross_validate of {n} configs x {SWEEP_EPOCHS} epoch, "
        f"fused and eager: "
        f"{json.dumps({k: res[k] for k in ('fused', 'eager')})}"
        f"; launches {json.dumps(counts['fused'])}")

    traces = {}
    for C in (2, n):
        tr = sweep_trace(K, fused, hypers, C, repeats=1)
        per = tr["wrapper_launches_per_step"]
        want = dict(dense_block_fwd=7.0, dense_block_bwd=7.0,
                    chain_tail_fwd=1.0, chain_tail_bwd=1.0)
        if any(per[k] != c for k, c in want.items()):
            raise AssertionError(f"fused launches per stacked step at C={C}: "
                                 f"{per}")
        traces[str(C)] = tr
    if traces["2"]["launches_per_step"] != traces[str(n)]["launches_per_step"]:
        raise AssertionError("host launch calls per stacked fused step "
                             "differ with C: " + json.dumps(
                                 {k: t["launches_per_step"]
                                  for k, t in traces.items()}))
    res["traces"] = traces
    log(f"[sweep fused] traces of {SWEEP_TRACE_STEPS} stacked fused steps: "
        + json.dumps({k: {f: t[f] for f in (
            "wall_ms_per_step_traced", "device_ms_per_step",
            "device_idle_share", "launches_per_step",
            "wrapper_launches_per_step", "device_ms_by_family")}
            for k, t in traces.items()}))

    # dropout 0: the fused and the eager chunk, the same seeds
    h0 = engine.Hyper(*[np.asarray(col, np.float32)
                        for col in zip(*SWEEP_STEP_HYPERS)])
    out = {}
    for name, kw in (("eager", {}), ("fused", dict(use_fused_train=True,
                                                   use_fused_encoder=True))):
        tr = engine.Trainer(cfg, store, adabn=False, batch_size=64, **kw)
        out[name] = [x.cpu().numpy() for x in tr.sweep_chunk(
            h0, [tr.generator(160 + c) for c in range(3)], [1.0], [1.0],
            None)]
    vote = 1.0 / (vv.D * vv.n_tasks)
    np.testing.assert_allclose(out["fused"][0], out["eager"][0], rtol=1e-3)
    np.testing.assert_allclose(out["fused"][1], out["eager"][1],
                               atol=vote + 1e-6)
    res["dropout0"] = dict(val_loss_fused=out["fused"][0].tolist(),
                           val_loss_eager=out["eager"][0].tolist(),
                           val_acc_fused=out["fused"][1].tolist(),
                           val_acc_eager=out["eager"][1].tolist(),
                           batch_size=64)

    # the bf16 and glove-encoding fused sweeps of 10 configs
    small = crossval.sample_hyperparams(SMALL_SWEEP_CONFIGS, seed=42)
    bf16 = engine.Trainer(cfg, store, adabn=False, batch_size=8,
                          use_fused_train=True, use_fused_encoder=True,
                          compute_dtype="bfloat16")
    sweep(bf16, small, "fused_bf16")
    hold("fused_bf16", True, True)
    glove = engine.Trainer(cfg, store, adabn=False, batch_size=8,
                           use_fused_train=True, glove_encoding=True)
    sweep(glove, small, "fused_glove_encoding")
    hold("fused_glove_encoding", False, False)
    log("[sweep fused] 10-config fused sweeps: " + json.dumps(
        {k: res[k] for k in ("fused_bf16", "fused_glove_encoding")}))

    # the sweep's val on the fused encoder against the unfused val, on a
    # chunk after 10 stacked fused steps
    inputs = sweep_inputs(fused, hypers, 17)
    run_sweep_steps(fused, inputs, 0, 10)
    state = inputs[0]
    del inputs
    gens = [fused.generator(170 + c) for c in range(n)]
    emg_rand, _ = fused._stacked_permutations(gens, vv)
    idx = (emg_rand, *stacked_epoch_batches_padded(gens, vv.D, 8))
    vals, ms = {}, {}
    for name, tr in (("fused", fused), ("unfused", trainer)):
        K.reset_launch_counts()
        vals[name] = [x.cpu().numpy() for x in tr.sweep_evaluate_from_indices(
            state, vv, *idx)]
        counts["val_" + name] = K.launch_counts["encoder_chain"]
        ms[name] = time_ms(lambda tr=tr: tr.sweep_evaluate_from_indices(
            state, vv, *idx), 2, 0)
    if (counts["val_fused"] != 10 * val_batches
            or counts["val_unfused"] != 0):
        raise AssertionError(f"val launches of encoder_chain: fused "
                             f"{counts['val_fused']}, unfused "
                             f"{counts['val_unfused']}")
    np.testing.assert_allclose(vals["fused"][0], vals["unfused"][0],
                               rtol=1e-4)
    acc_diff = np.abs(vals["fused"][1] - vals["unfused"][1])
    if float(acc_diff.max()) > 3 * vote + 1e-6:
        raise AssertionError(f"fused val accuracy {float(acc_diff.max())} "
                             "from the unfused one")
    res["val"] = dict(configs=n, batches=val_batches, ms_fused=ms["fused"],
                      ms_unfused=ms["unfused"],
                      encoder_chain_launches=counts["val_fused"],
                      max_loss_rel_diff=float(np.max(np.abs(
                          vals["fused"][0] / vals["unfused"][0] - 1))),
                      acc_max_diff=float(acc_diff.max()),
                      configs_acc_differ=int((acc_diff > 0).sum()))
    log(f"[sweep fused] the sweep's val of {n} configs: {json.dumps(res['val'])}")
    del state, gens
    torch.cuda.empty_cache()
    return res, counts


def go_fused_twin() -> dict:
    """Phase 16, part 4: ``scripts/go_torch.sh --synthetic --fused_train on
    --fused_encoder --crossval_size 150 --final_epochs 1`` in its own
    process on a data directory with no cached crossval: go.sh's
    150-config sweep on the fused chain and the fused encoder, the final
    train and the test. Its test numbers and seconds."""
    with tempfile.TemporaryDirectory() as tmp:
        shim = os.path.join(tmp, "bin")
        os.makedirs(shim)
        with open(os.path.join(shim, "python"), "w") as f:
            f.write(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
        os.chmod(os.path.join(shim, "python"), 0o755)
        data = os.path.join(tmp, "data")
        out, seconds = run_twin("go_torch.sh", [
            "--synthetic", "--fused_train", "on", "--fused_encoder",
            "--crossval_size", str(SWEEP_CONFIGS), "--final_epochs",
            str(TWIN_EPOCHS), "--data_dir", data, "--checkpoint_dir", data],
            shim)
        if "no cached crossval found" not in out:
            raise AssertionError("the fused go twin did not run the sweep")
        values = np.load(os.path.join(data, "cross_val_values.npy"))
        if values.shape != (SWEEP_CONFIGS, 2):
            raise AssertionError(f"the fused go twin's sweep wrote "
                                 f"{values.shape}")
        numbers = test_numbers(out, "the fused go twin")
    log(f"[sweep fused] go_torch.sh --synthetic --fused_train on "
        f"--fused_encoder --crossval_size {SWEEP_CONFIGS} --final_epochs "
        f"{TWIN_EPOCHS}: {seconds:.1f} s in its own process, test {numbers}")
    return dict(seconds=seconds, test_numbers=numbers,
                best_val_acc=float(np.nanmax(values[:, 1])))


def sweep_fused_phase(K, TF, trainer, dev,
                      eager_sweep=None) -> tuple[dict, dict]:
    """Phase 16, the crossval sweep on the fused chain and the fused
    encoder, and ``Trainer(remat=True)``, on phase 7's store at full
    width: the config-axis kernels (:func:`check_k5_config_axis`,
    :func:`check_encoder_config_axis`), remat (:func:`remat_check`), the
    fused sweep and its val (:func:`fused_sweep_check`, in turns with
    phase 9's eager sweep, ``eager_sweep``) and the fused go
    twin (:func:`go_fused_twin`). Returns the ``sweep_fused`` results and
    the ten ``kernels`` entries, each with its launches on this phase's
    main paths (the 150-config fused sweep; the bf16 ones' the 10-config
    bf16 sweep)."""
    t_phase = time.perf_counter()
    parts = {}
    t0 = time.perf_counter()
    entries = check_k5_config_axis(TF, dev)
    entries.update(check_encoder_config_axis(K, trainer, dev))
    parts["kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    remat = remat_check(K, trainer)
    parts["remat"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sweeps, counts = fused_sweep_check(K, trainer, eager_sweep)
    parts["sweeps"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    twin = go_fused_twin()
    parts["go_twin"] = time.perf_counter() - t0
    for kernel, entry in entries.items():
        path = "fused_bf16" if kernel.endswith("_bf16") else "fused"
        n = counts[path][kernel]
        if not n:
            raise AssertionError(f"{kernel} never launched on the {path} "
                                 "sweep")
        entry.update(launches=n, launches_by_path={f"sweep_{path}": n},
                     kernel_ms=entry["ms"],
                     peaks={"tf32_flops": PEAK_TF32_FLOPS,
                            "bf16_flops": PEAK_BF16_FLOPS,
                            "bytes_per_s": PEAK_BYTES_PER_S})
    phase_s = time.perf_counter() - t_phase
    log(f"[sweep fused] phase 16 took {phase_s:.1f} s: {json.dumps(parts)}")
    return dict(remat=remat, sweeps=sweeps, go_twin=twin, phase_s=phase_s,
                parts_s=parts), entries


# ------------------------------------------------------------ phase 17
PARALLEL_RANKS = 4      # one gloo group on the one card: dp=2 x mp=2
PARALLEL_STEPS = 10     # timed steps a path a turn (a rank's gloo step)
WORLD1_TURNS, WORLD1_STEPS = 6, 50  # the world-1 step, sharded and not
PARALLEL_CONFIGS = 4    # the config-sharded sweep (cut from go.sh's 150)
PARALLEL_CHUNK = 2      # one chunk a rank over 2 ranks
WORLD1_CONFIGS = 2      # the world-1 sweep
CLI_SPMD_CONFIGS = 4    # cptorch-train --spmd_crossval --crossval_size
# JAX's bounds of a sharded step against the unsharded one
# (tests/test_parallel.py:98-117): the loss within rtol 1e-4; more than
# 98 % of each parameter within rtol 5e-3, atol 1e-5, all within 2.5 lr
STEP_LOSS_RTOL, STEP_CLOSE_SHARE = 1e-4, 0.98
# the sharded step's other paths at world 1, each beside its unsharded twin
WORLD1_PATHS = (("fused", dict(use_fused_train=True)),
                ("remat_eager", dict(remat=True)),
                ("remat_fused", dict(use_fused_train=True, remat=True)),
                ("bf16_eager", dict(compute_dtype="bfloat16")),
                ("bf16_fused", dict(use_fused_train=True,
                                    compute_dtype="bfloat16")))
WORLD1_PATH_TURNS, WORLD1_PATH_STEPS = 2, 20
# a dp rank's rows [lo, 328) of the step's batch: dp=2's second rank (164
# rows, as at dp2 x mp2) and dp=4's last (82 rows)
DP_RANK_ROWS = ((164, "fused_dp2_mp2"), (246, "fused_dp4"))
# the bf16 step's bounds (tests/test_torch_port_train_bf16.py's): the
# loss within 1e-2; the EMG tower's gradient no farther (relative 2-norm)
# from the reference's than the spread of two valid bf16 orders of the same
# step, here the unsharded eager step's from the unsharded fused step's (as
# the CPU tests hold the port against JAX's two bf16 paths), and each
# gradient no farther than BF16_STEP_RATIO times its own spread (the card's
# bf16 chain test's factor against the plain chain) or BF16_STEP_FLOOR
BF16_STEP_LOSS, BF16_STEP_RATIO, BF16_STEP_FLOOR = 1e-2, 1.25, 1e-3


def parallel_inputs(trainer, seed: int = 7):
    """A global train batch of 8 items and the step's hyperparameters
    (the canonical ones: dropout 0.5), the same on every rank."""
    from contrastiveprosthetics_torch.data.sampler import (
        gather_train_batch,
        task_permutations,
    )
    from contrastiveprosthetics_torch.train.engine import Hyper

    v = trainer.view_train
    gen = trainer.generator(seed)
    emg_rand = task_permutations(gen, v.n_tasks, v.D)
    items = torch.randperm(v.D, generator=gen, device=trainer.device)[:8]
    return gather_train_batch(v.emg_flat, emg_rand, items), \
        Hyper.single(*CANONICAL)


def held_to_jax_bounds(got, want, loss_got, loss_want, lr: float) -> dict:
    """A gathered sharded state against the unsharded one at JAX's bounds;
    raises where they fail. The worst share of close elements and the
    largest difference."""
    if abs(loss_got - loss_want) > STEP_LOSS_RTOL * abs(loss_want):
        raise AssertionError(f"sharded loss {loss_got} vs {loss_want}")
    worst_share, worst_abs = 1.0, 0.0
    sg, sw = got.model.state_dict(), want.model.state_dict()
    for name, b in sw.items():
        if not b.is_floating_point():
            continue
        a = sg[name]
        share = float(torch.isclose(a, b, rtol=5e-3, atol=1e-5).float()
                      .mean())
        diff = float((a - b).abs().max())
        if share <= STEP_CLOSE_SHARE or diff > 2.5 * lr:
            raise AssertionError(f"sharded step: {name} {share:.4f} close, "
                                 f"largest difference {diff}")
        worst_share, worst_abs = min(worst_share, share), max(worst_abs, diff)
    return dict(worst_close_share=worst_share, max_abs_diff=worst_abs)


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def held_to_bf16_bounds(got: dict, want: dict, spread: dict,
                        loss_got: float, loss_want: float) -> dict:
    """A sharded bf16 step's gradients (by name, gathered) against the
    unsharded step's ``want`` at the bf16 step's bounds, ``spread`` the
    gradients of another valid bf16 order of the unsharded step; raises
    where they fail. The loss difference, and the largest ratio of a
    gradient's (or the EMG tower's) distance to its spread's."""
    emg = [n for n in want if n.startswith("emg_net.")]

    def whole(g):
        return torch.cat([g[n].flatten() for n in emg])

    pairs = {n: (rel_l2(got[n], w), rel_l2(spread[n], w))
             for n, w in want.items()}
    ratio = max(d / max(sp, BF16_STEP_FLOOR) for d, sp in pairs.values())
    tower = (rel_l2(whole(got), whole(want)),
             rel_l2(whole(spread), whole(want)))
    loss = abs(loss_got - loss_want)
    if (loss > BF16_STEP_LOSS or ratio > BF16_STEP_RATIO
            or tower[0] > tower[1]):
        raise AssertionError(f"sharded bf16 step: loss {loss}, the EMG "
                             f"tower {tower}, gradients against their "
                             f"spread {json.dumps(pairs)}")
    return dict(loss_abs_diff=loss, max_ratio_to_spread=ratio,
                emg_rel_l2=tower[0], emg_spread_rel_l2=tower[1],
                max_grad_rel_l2=max(d for d, _ in pairs.values()))


def world1_paths(K, trainer, mesh, emg_b, hyper, tally) -> dict:
    """Phase 17 (a), the sharded step's other paths at world 1 over NCCL,
    full width: the fused chain, remat (eager and fused) and bf16 (eager
    and fused), each sharded step bit-equal to its unsharded twin under
    deterministic algorithms (the gathered state, both Adam chains, loss
    and accuracy), with the twin's launches (K5f 7, K5b 7, the tail pair
    and K1 once; the forward's twice under remat) and no dp mode of a
    kernel (no sums-only, row-base or n_total launch); then timed in turns
    beside the twin (CUDA events, ``WORLD1_PATH_STEPS`` steps a turn)."""
    from contrastiveprosthetics_torch.parallel.mesh import gather_state
    from contrastiveprosthetics_torch.parallel.spmd import (
        make_sharded_train_step,
    )
    from contrastiveprosthetics_torch.train import engine

    out = {}
    for path, kw in WORLD1_PATHS:
        tr = engine.Trainer(trainer.cfg, trainer.store, adabn=False,
                            batch_size=8, **kw)
        step, place = make_sharded_train_step(tr, mesh)
        n = 2 if tr.remat else 1
        sfx = "_bf16" if tr.dtype == torch.bfloat16 else ""
        want = dict(contrastive_loss_fwd=n, contrastive_loss_bwd=1)
        if tr.use_fused_train:
            want.update({"dense_block_fwd" + sfx: 7 * n,
                         "dense_block_bwd" + sfx: 7,
                         "chain_tail_fwd" + sfx: n,
                         "chain_tail_bwd" + sfx: 1})
        with deterministic():
            plain = tr.init_state(tr.generator(0))
            sharded = place(tr.init_state(tr.generator(0)))
            K.reset_launch_counts()
            lp, ap = tr._sgd_step(plain, emg_b, hyper, 1e-3, 1e-3,
                                  tr.generator(1))
            torch.cuda.synchronize()
            twin = {k: c for k, c in K.launch_counts.items() if c}
            K.reset_launch_counts()
            ls, as_ = step(sharded, emg_b, hyper, 1e-3, 1e-3,
                           tr.generator(1))
            torch.cuda.synchronize()
            got = {k: c for k, c in K.launch_counts.items() if c}
            modes = dict(K.mode_counts)
            tally()
            if got != twin or got != want or any(modes.values()):
                raise AssertionError(f"world-1 {path} step launches {got} "
                                     f"(modes {modes}), twin {twin}, want "
                                     f"{want}")
            if not (torch.equal(lp, ls) and torch.equal(ap, as_)
                    and same_state(plain, gather_state(sharded, mesh))):
                raise AssertionError(f"the world-1 sharded {path} step is "
                                     "not its unsharded twin bit for bit")
        gen_p, gen_s = tr.generator(2), tr.generator(2)
        turns = {"unsharded": [], "sharded": []}
        for _ in range(WORLD1_PATH_TURNS):
            turns["unsharded"].append(time_ms(lambda: tr._sgd_step(
                plain, emg_b, hyper, 1e-3, 1e-3, gen_p),
                reps=WORLD1_PATH_STEPS))
            turns["sharded"].append(time_ms(lambda: step(
                sharded, emg_b, hyper, 1e-3, 1e-3, gen_s),
                reps=WORLD1_PATH_STEPS))
        med = {k: float(np.median(v)) for k, v in turns.items()}
        out[path] = dict(bit_equal=True, launches=got, ms_per_step=turns,
                         median_ms=med, sharded_minus_unsharded_ms=(
                             med["sharded"] - med["unsharded"]))
        del plain, sharded
    log(f"[parallel] world 1: the fused, remat and bf16 sharded steps "
        f"bit-equal to their twins, the twins' launches, no dp mode; "
        f"{json.dumps(out)}")
    return out


def finished_like(got: torch.Tensor, want: torch.Tensor) -> int:
    """``finish_stats`` of K5f's sums against K5f's own finish, the same
    correctly rounded operations in the same order: raises unless mean,
    var, rstd and a lie within one f32 ulp and c = beta - mean a within
    one ulp plus what a one-ulp a moves it by; returns how many elements
    are not bit-equal."""
    within_one_ulp(got[:4], want[:4])
    a_ulp = torch.nextafter(want[3].abs(), torch.full_like(
        want[3], float("inf"))) - want[3].abs()
    c_ulp = torch.nextafter(want[4].abs(), torch.full_like(
        want[4], float("inf"))) - want[4].abs()
    if not bool(((got[4] - want[4]).abs()
                 <= c_ulp + want[0].abs() * a_ulp).all()):
        raise AssertionError(f"finish_stats' c off: max abs error "
                             f"{max_abs(got[4], want[4])}")
    return int((got != want).sum())


def dp_rank_case(TF, lo: int, bf16: bool, dev):
    """An inner block of the chain at full width (512 -> 512, affine and
    dropout 0.5 of block 3 on its input; the tail's of block 6) on the
    step's 328 rows, its kernels' outputs on the whole batch, and the
    inputs of a dp rank's launches on rows [lo, 328) at row base lo."""
    N, K_in, F = 328, 512, 512
    x, w, b, gamma, beta, ins, dz, seeds, _ = (
        t[0] for t in k5_stacked(1, N, K_in, F, 1900 + lo, dev))
    keep = torch.full((1,), 0.5, device=dev)
    if bf16:
        x, w, dz = (t.to(torch.bfloat16) for t in (x, w, dz))
    whole = dict(seed=seeds, keep=keep, drop_block=3)
    r, stats = TF.dense_block_fwd(x, w, b, gamma, beta, ins, **whole)
    rf, dzf = r.float(), dz.float()
    sums = torch.stack([dzf.sum(0), (dzf * (rf - stats[0])
                                     * stats[2]).sum(0)]).contiguous()
    return dict(N=N, lo=lo, x=x, w=w, b=b, gamma=gamma, beta=beta, ins=ins,
                dz=dz, seed=seeds, keep=keep, whole=whole, r=r, stats=stats,
                sums=sums, part=dict(whole, row_base=lo),
                tail=dict(seed=seeds, keep=keep, drop_block=6))


def check_dp_kernels(TF, dev) -> dict:
    """Phase 17 (c): K5f, K5b and the tail pair (f32 and bf16) in a dp
    rank's modes at full width, on rows [lo, 328) of the step's batch for
    lo in 164 and 246 (:func:`dp_rank_case`). K5f's sums-only end gives
    the one-shot r bit for bit and, on the whole batch at row base 0, sums
    whose ``finish_stats`` lies within one f32 ulp of the one-shot
    statistics (:func:`finished_like`; the count of elements not
    bit-equal is reported); the
    rank's r, K5b's dx (given the whole batch's sums and n_total 328), the
    tail's h and dz and ``dropout_masks`` at the row base are those rows
    of the whole batch's launches bit for bit; each held to its plain
    version at the existing tolerances (f32 r rtol 1e-5, bf16 r and dx
    within one bf16 ulp, the sums, dW, db and lower sums rtol 1e-4, atol
    1e-5 x max, bf16 sums rtol 1e-3, atol 1e-3 x max; the tail's h and dz
    bit for bit, its sums within one f32 ulp). Then each kernel timed at
    the rank's shape: CUDA events, profiler device time a launch, its
    plain version, its bound. Returns the sixteen ``kernels`` entries
    (launches filled in by :func:`parallel_phase`)."""
    entries, report = {}, {}
    for bf16 in (False, True):
        sfx = "_bf16" if bf16 else ""
        for lo, _ in DP_RANK_ROWS:
            c = dp_rank_case(TF, lo, bf16, dev)
            N, n = c["N"], c["N"] - lo
            x, w, dz, r, stats, sums = (c[k] for k in ("x", "w", "dz", "r",
                                                       "stats", "sums"))
            vecs = (c["b"], c["gamma"], c["beta"], c["ins"])
            whole, part, tail = c["whole"], c["part"], c["tail"]
            r_all, sums_all = TF.dense_block_fwd(x, w, *vecs, sums_only=True,
                                                 **whole)
            off = finished_like(TF.finish_stats(sums_all, c["gamma"],
                                                c["beta"], N), stats)
            xl, dzl, rl = x[lo:], dz[lo:], r[lo:]
            r_lo, sums_lo = TF.dense_block_fwd(xl, w, *vecs, sums_only=True,
                                               **part)
            bwd = TF.dense_block_bwd(dzl, rl, xl, w, stats, sums, c["ins"],
                                     n_total=N, **part)
            h_lo = TF.chain_tail_fwd(rl, stats, row_base=lo, **tail)
            tz, ts = TF.chain_tail_bwd(dzl, rl, stats, row_base=lo, **tail)
            masks = TF.dropout_masks(c["seed"], c["keep"], n, 512, 6,
                                     row_base=lo)
            rows_equal = (
                torch.equal(r_all, r) and torch.equal(r_lo, r[lo:])
                and torch.equal(bwd[0], TF.dense_block_bwd(
                    dz, r, x, w, stats, sums, c["ins"], **whole)[0][lo:])
                and torch.equal(h_lo, TF.chain_tail_fwd(r, stats,
                                                        **tail)[lo:])
                and torch.equal(tz, TF.chain_tail_bwd(dz, r, stats,
                                                      **tail)[0][lo:])
                and torch.equal(masks, TF.dropout_masks(
                    c["seed"], c["keep"], N, 512, 6)[lo:]))
            if not rows_equal:
                raise AssertionError(f"a dp rank's rows at row base {lo} "
                                     f"are not the whole batch's{sfx}")
            r_p, sums_p = TF.dense_block_fwd_reference(
                xl, w, *vecs, sums_only=True, **part)
            bwd_p = TF.dense_block_bwd_reference(dzl, rl, xl, w, stats, sums,
                                                 c["ins"], n_total=N, **part)
            if bf16:
                within_one_bf16_ulp(r_lo, r_p)
                within_one_bf16_ulp(bwd[0], bwd_p[0])
                fwd_err = max(max_abs(r_lo, r_p),
                              close(sums_lo, sums_p, 1e-3, 1e-3))
                dx_err = max_abs(bwd[0], bwd_p[0])
            else:
                fwd_err = max(close(r_lo, r_p, 1e-5, 1e-5),
                              close(sums_lo, sums_p, 1e-4, 1e-5))
                dx_err = close(bwd[0], bwd_p[0], 1e-4, 1e-5)
            bwd_err = max([dx_err] + [close(g, v, 1e-4, 1e-5)
                                      for g, v in zip(bwd[1:], bwd_p[1:])])
            if not (torch.equal(h_lo, TF.chain_tail_fwd_reference(
                    rl, stats, row_base=lo, **tail))
                    and torch.equal(masks, TF.dropout_masks_reference(
                        c["seed"], c["keep"], n, 512, 6, lo))):
                raise AssertionError(f"the tail's h or the masks at row base "
                                     f"{lo} differ from the plain{sfx}")
            tz_p, ts_p = TF.chain_tail_bwd_reference(dzl, rl, stats,
                                                     row_base=lo, **tail)
            if not torch.equal(tz, tz_p):
                raise AssertionError(f"the tail's dz at row base {lo} "
                                     f"differs from the plain{sfx}")
            within_one_ulp(ts, ts_p)
            report[f"N={n}{sfx}"] = dict(
                finish_stats_not_bit_equal=off, rows_bit_equal=True,
                fwd_err=fwd_err, bwd_err=bwd_err,
                tail_sums_err=max_abs(ts, ts_p))
            macs = float(n) * 512 * 512
            peak, products = ((PEAK_BF16_FLOPS, 1) if bf16
                              else (PEAK_TF32_FLOPS, 3))
            small = nbytes(*vecs, c["seed"], c["keep"])
            specs = {
                "dense_block_fwd" + sfx: (
                    "sums-only end",
                    lambda: TF.dense_block_fwd(xl, w, *vecs, sums_only=True,
                                               **part),
                    lambda: TF.dense_block_fwd_reference(
                        xl, w, *vecs, sums_only=True, **part),
                    bound_ms(nbytes(xl, w, r_lo, sums_lo) + small,
                             products * 2 * macs, peak), fwd_err),
                "dense_block_bwd" + sfx: (
                    "n_total 328, the global sums",
                    lambda: TF.dense_block_bwd(dzl, rl, xl, w, stats, sums,
                                               c["ins"], n_total=N, **part),
                    lambda: TF.dense_block_bwd_reference(
                        dzl, rl, xl, w, stats, sums, c["ins"], n_total=N,
                        **part),
                    bound_ms(nbytes(dzl, rl, xl, w, stats, sums, *bwd)
                             + small, products * 4 * macs, peak), bwd_err),
                "chain_tail_fwd" + sfx: (
                    "dropout of block 6",
                    lambda: TF.chain_tail_fwd(rl, stats, row_base=lo,
                                              **tail),
                    lambda: TF.chain_tail_fwd_reference(
                        rl, stats, row_base=lo, **tail),
                    bound_ms(nbytes(rl, stats, h_lo, c["seed"], c["keep"]),
                             0.0), 0.0),
                "chain_tail_bwd" + sfx: (
                    "dropout of block 6, the top BatchNorm's sums",
                    lambda: TF.chain_tail_bwd(dzl, rl, stats, row_base=lo,
                                              **tail),
                    lambda: TF.chain_tail_bwd_reference(
                        dzl, rl, stats, row_base=lo, **tail),
                    bound_ms(nbytes(dzl, rl, stats, tz, ts, c["seed"],
                                    c["keep"]), 0.0), max_abs(ts, ts_p))}
            with torch.no_grad():
                for kernel, (mode, fn, plain, (bd, by), err) in specs.items():
                    entry = dict(
                        name=f"{kernel}@dp_rank_N{n}", kernel=kernel,
                        route="cuda", source=SOURCES[kernel],
                        replaces=REPLACES[kernel],
                        shape=(f"a dp rank's N={n} of 328 rows at row base "
                               f"{lo}, " + ("512->512, affine + dropout 0.5 "
                                            "on the input, " if "block" in
                                            kernel else "F=512, ") + mode),
                        max_abs_err=err, ms=time_ms(fn, 50, 3),
                        plain_ms=time_ms(plain, 3, 1), bound_ms=bd,
                        bound_by=by, library_ms=None,
                        library_note="no single PyTorch call computes it")
                    entry["device_ms"], entry["traces_with_dropped_records"]                         = device_ms_whole(fn, 1, n=10)
                    entries[(kernel, lo)] = entry
            del c, specs
    log(f"[parallel] dp-rank kernel modes held to their plain versions and "
        f"to the whole batch's rows: {json.dumps(report)}; timed: "
        + json.dumps({e["name"]: [e["ms"], e["device_ms"], e["bound_ms"]]
                      for e in entries.values()}))
    return entries


def parallel_world1(K, trainer, dev, batched_args) -> tuple[dict, dict]:
    """Phase 17 (a): a world of one rank over NCCL in this process, at
    full width: ``make_sharded_train_step`` on a (1, 1) mesh (the eager
    f32 step, then its other paths, :func:`world1_paths`),
    ``cross_validate(mesh=)`` of 2 configs x 1 epoch and
    ``BatchedStreamingEngine(mesh=)`` at 32,768 sessions x 25 ticks, each
    bit-equal to its unsharded twin and timed beside it in turns (the
    sharded code's collectives and slicing at world 1). The results and
    each kernel's launches in the sharded runs."""
    import torch.distributed as dist

    from contrastiveprosthetics_torch.config import DEFAULT_CONFIG as cfg
    from contrastiveprosthetics_torch.parallel.mesh import (
        gather_state,
        make_mesh,
    )
    from contrastiveprosthetics_torch.parallel.spmd import (
        make_sharded_train_step,
    )
    from contrastiveprosthetics_torch.serve.stream import (
        BatchedStreamingEngine,
    )
    from contrastiveprosthetics_torch.train.crossval import (
        cross_validate,
        sample_hyperparams,
    )

    res, counts = {}, dict.fromkeys(K.launch_counts, 0)

    def tally():
        for name, n in K.launch_counts.items():
            counts[name] += n

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rdv",
                                rank=0, world_size=1)
        try:
            mesh = make_mesh(1, 1)
            emg_b, hyper = parallel_inputs(trainer)
            step, place = make_sharded_train_step(trainer, mesh)
            with deterministic():
                plain = trainer.init_state(trainer.generator(0))
                sharded = place(trainer.init_state(trainer.generator(0)))
                lp, ap = trainer._sgd_step(plain, emg_b, hyper, 1e-3, 1e-3,
                                           trainer.generator(1))
                K.reset_launch_counts()
                ls, as_ = step(sharded, emg_b, hyper, 1e-3, 1e-3,
                               trainer.generator(1))
                torch.cuda.synchronize()
                step_counts = {k: K.launch_counts[k] for k in TRAIN_KERNELS}
                tally()
                if step_counts != dict.fromkeys(TRAIN_KERNELS, 1):
                    raise AssertionError(f"world-1 step launches "
                                         f"{step_counts}")
                whole = gather_state(sharded, mesh)
                if not (torch.equal(lp, ls) and torch.equal(ap, as_)
                        and same_state(plain, whole)):
                    raise AssertionError("the world-1 sharded step is not "
                                         "the unsharded step bit for bit")
            gen_p, gen_s = trainer.generator(2), trainer.generator(2)
            turns = {"unsharded": [], "sharded": []}
            for _ in range(WORLD1_TURNS):
                turns["unsharded"].append(time_ms(lambda: trainer._sgd_step(
                    plain, emg_b, hyper, 1e-3, 1e-3, gen_p),
                    reps=WORLD1_STEPS))
                turns["sharded"].append(time_ms(lambda: step(
                    sharded, emg_b, hyper, 1e-3, 1e-3, gen_s),
                    reps=WORLD1_STEPS))
            med = {k: float(np.median(v)) for k, v in turns.items()}
            res["step"] = dict(bit_equal=True, ms_per_step=turns,
                               median_ms=med, sharded_minus_unsharded_ms=(
                                   med["sharded"] - med["unsharded"]),
                               launches=step_counts)
            res["paths"] = world1_paths(K, trainer, mesh, emg_b, hyper,
                                        tally)

            hypers = sample_hyperparams(WORLD1_CONFIGS, seed=42)
            sweep = {}
            with deterministic():
                for name in ("unsharded", "sharded"):
                    K.reset_launch_counts()
                    t0 = time.perf_counter()
                    v = cross_validate(trainer, hypers, epochs=1, seed=42,
                                       verbose=False, mesh=(
                                           mesh if name == "sharded"
                                           else None))
                    seconds = time.perf_counter() - t0
                    if name == "sharded":
                        tally()
                    sweep.setdefault(name, []).append((v, seconds))
            values = [v for runs in sweep.values() for v, _ in runs]
            if not all(np.array_equal(values[0], v, equal_nan=True)
                       for v in values):
                raise AssertionError("the world-1 sharded sweep differs "
                                     "from the unsharded one")
            res["sweep"] = dict(configs=WORLD1_CONFIGS, bit_equal=True,
                                seconds={k: [t for _, t in r]
                                         for k, r in sweep.items()})

            model, mean, std, blocks_t, masks_t = batched_args
            S = blocks_t.shape[1]
            engines = {"unsharded": BatchedStreamingEngine(
                           cfg, model, mean, std, n_sessions=S),
                       "sharded": BatchedStreamingEngine(
                           cfg, model, mean, std, n_sessions=S, mesh=mesh)}
            outs, serve_ms = {}, {k: [] for k in engines}
            for name, eng in engines.items():
                K.reset_launch_counts()
                _, p, v = eng.steps(eng.init_carries(), blocks_t, masks_t)
                _, p1, v1, sc = eng.step(eng.init_carries(), blocks_t[0],
                                         masks_t)
                torch.cuda.synchronize()
                if name == "sharded":
                    serve_counts = {k: K.launch_counts[k]
                                    for k in SERVE_KERNELS}
                    tally()
                outs[name] = (p, v, p1, v1, sc)
            if not all(torch.equal(a, b) for a, b in zip(outs["sharded"],
                                                         outs["unsharded"])):
                raise AssertionError("the world-1 sharded engine's preds, "
                                     "votes or scores differ")
            if min(serve_counts.values()) < 1:
                raise AssertionError(f"world-1 serve launches {serve_counts}")
            for _ in range(2):
                for name, eng in engines.items():
                    serve_ms[name].append(time_ms(lambda: eng.steps(
                        eng.init_carries(), blocks_t, masks_t), reps=3))
            res["serve"] = dict(sessions=S, ticks=blocks_t.shape[0],
                                bit_equal=True, steps_ms=serve_ms,
                                launches=serve_counts)
        finally:
            dist.destroy_process_group()
    log(f"[parallel] world 1 over NCCL: step, {WORLD1_CONFIGS}-config sweep "
        f"and {res['serve']['sessions']}-session serving bit-equal to "
        f"unsharded; {json.dumps(res)}")
    return res, counts


def rank_step(K, trainer, mesh, rank: int) -> dict:
    """A rank's sharded step of phase 17 (b) on ``mesh``, held (rank 0)
    against the unsharded step on the card at JAX's bounds; its K1
    launches and its time a step."""
    from contrastiveprosthetics_torch.parallel.mesh import gather_state
    from contrastiveprosthetics_torch.parallel.spmd import (
        make_sharded_train_step,
    )

    emg_b, hyper = parallel_inputs(trainer)
    step, place = make_sharded_train_step(trainer, mesh)
    sharded = place(trainer.init_state(trainer.generator(0)))
    K.reset_launch_counts()
    loss, _ = step(sharded, emg_b, hyper, 1e-3, 1e-3, trainer.generator(1))
    torch.cuda.synchronize()
    launches = {k: K.launch_counts[k] for k in TRAIN_KERNELS}
    if launches != dict.fromkeys(TRAIN_KERNELS, 1):
        raise AssertionError(f"rank {rank}: K1 launches {launches}")
    whole = gather_state(sharded, mesh)
    out = dict(launches=launches, k1_items=emg_b.shape[0] // mesh.n_dp)
    if rank == 0:
        plain = trainer.init_state(trainer.generator(0))
        lp, _ = trainer._sgd_step(plain, emg_b, hyper, 1e-3, 1e-3,
                                  trainer.generator(1))
        out["vs_unsharded"] = held_to_jax_bounds(whole, plain, float(loss),
                                                 float(lp), 1e-3)
    gen = trainer.generator(2)
    out["ms_per_step"] = time_ms(lambda: step(sharded, emg_b, hyper, 1e-3,
                                              1e-3, gen), reps=PARALLEL_STEPS)
    return out


def rank_fused_step(K, trainer, mesh, rank: int, bf16: bool) -> dict:
    """A rank's fused step of phase 17 (b) on ``mesh`` (dp2 x mp2 or dp4),
    f32 or bf16: its launches (K5f 7, all sums-only, K5b 7, all given
    n_total, the tail pair and K1 once; the row-based launches, 8 a step,
    on the ranks whose rows start past row 0) and, on rank 0, the step
    held to the unsharded fused step on the card: f32 at JAX's bounds
    (:func:`held_to_jax_bounds`) at the canonical dropout 0.5, bf16 its
    gradients at dropout 0 at the bf16 step's (:func:`held_to_bf16_bounds`,
    against the spread of the unsharded eager bf16 step's); its ms a
    step."""
    from contrastiveprosthetics_torch.parallel.mesh import (
        gather_grads,
        gather_state,
        local_range,
    )
    from contrastiveprosthetics_torch.parallel.spmd import (
        make_sharded_train_step,
    )
    from contrastiveprosthetics_torch.train import engine

    tr = engine.Trainer(trainer.cfg, trainer.store, adabn=False, batch_size=8,
                        use_fused_train=True,
                        compute_dtype="bfloat16" if bf16 else "float32")
    emg_b, hyper = parallel_inputs(tr)
    step, place = make_sharded_train_step(tr, mesh)
    sharded = place(tr.init_state(tr.generator(0)))
    if bf16:  # at dropout 0: the eager step's masks are other draws
        hyper = engine.Hyper.single(*(0.0 if i in (2, 5) else v
                                      for i, v in enumerate(CANONICAL)))
    K.reset_launch_counts()
    if bf16:
        loss, _, grads = tr.loss_and_grads(sharded, emg_b, hyper,
                                           tr.generator(1), mesh=mesh)
    else:
        loss, _ = step(sharded, emg_b, hyper, 1e-3, 1e-3, tr.generator(1))
    torch.cuda.synchronize()
    launches = {k: c for k, c in K.launch_counts.items() if c}
    modes = dict(K.mode_counts)
    sfx = "_bf16" if bf16 else ""
    lo, hi = local_range(emg_b.shape[0], mesh.n_dp, mesh.dp_rank)
    want = {"dense_block_fwd" + sfx: 7, "dense_block_bwd" + sfx: 7,
            "chain_tail_fwd" + sfx: 1, "chain_tail_bwd" + sfx: 1,
            "contrastive_loss_fwd": 1, "contrastive_loss_bwd": 1}
    want_modes = dict.fromkeys(K.mode_counts, 0)
    want_modes.update({"dense_block_fwd" + sfx + "_sums": 7, "n_total": 7,
                       "row_base": 8 if lo else 0})
    if launches != want or modes != want_modes:
        raise AssertionError(f"rank {rank} fused{sfx} step launches "
                             f"{launches}, modes {modes}; want {want}, "
                             f"{want_modes}")
    out = dict(launches=launches, modes=modes, rows=(hi - lo) * 41)
    if bf16:
        got = gather_grads(sharded.model, grads)
    else:
        whole = gather_state(sharded, mesh)
    if rank == 0:
        plain = tr.init_state(tr.generator(0))
        if bf16:
            lp, _, pg = tr.loss_and_grads(plain, emg_b, hyper,
                                          tr.generator(1))
            eager = engine.Trainer(tr.cfg, tr.store, adabn=False,
                                   batch_size=8, compute_dtype="bfloat16")
            _, _, eg = eager.loss_and_grads(plain, emg_b, hyper,
                                            tr.generator(1))
            out["vs_unsharded"] = held_to_bf16_bounds(
                got, gather_grads(plain.model, pg),
                gather_grads(plain.model, eg), float(loss), float(lp))
        else:
            lp, _ = tr._sgd_step(plain, emg_b, hyper, 1e-3, 1e-3,
                                 tr.generator(1))
            out["vs_unsharded"] = held_to_jax_bounds(whole, plain,
                                                     float(loss), float(lp),
                                                     1e-3)
    gen = tr.generator(2)
    out["ms_per_step"] = time_ms(lambda: step(sharded, emg_b, hyper, 1e-3,
                                              1e-3, gen), reps=PARALLEL_STEPS)
    return out


def rank_sweep(K, cfg, store, mesh, rank: int) -> dict:
    """A rank's config-sharded sweeps of phase 17 (b), eager and on the
    fused chain (and the fused encoder), each its chunk of 2 configs;
    then the unsharded sweep of the same 4 configs, the two ranks at once
    (rank 0 the eager one, rank 1 the fused one), bit-equal; the launches
    a stacked step."""
    from contrastiveprosthetics_torch.train import engine
    from contrastiveprosthetics_torch.train.crossval import (
        cross_validate,
        sample_hyperparams,
    )

    hypers = sample_hyperparams(PARALLEL_CONFIGS, seed=42)
    out, got, trainers = {}, {}, {}
    with deterministic():
        for path, fused in (("eager", False), ("fused", True)):
            tr = trainers[path] = engine.Trainer(
                cfg, store, adabn=False, batch_size=8,
                use_fused_train=fused, use_fused_encoder=fused)
            K.reset_launch_counts()
            t0 = time.perf_counter()
            got[path] = cross_validate(tr, hypers, epochs=1, seed=42,
                                       chunk=PARALLEL_CHUNK, verbose=False,
                                       mesh=mesh)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = dict(K.launch_counts)
            steps = -(-tr.view_train.D // tr.batch_size)
            want = dict(dense_block_fwd=7 * steps, dense_block_bwd=7 * steps,
                        chain_tail_fwd=steps, chain_tail_bwd=steps) if fused \
                else dict.fromkeys(FUSED_KERNELS, 0)
            want.update(contrastive_loss_fwd=steps, contrastive_loss_bwd=steps)
            if any(launches[k] != n for k, n in want.items()) or (
                    fused != bool(launches["encoder_chain"])):
                raise AssertionError(f"rank {rank} {path} sweep launches "
                                     f"{launches}, want {want}")
            out[path] = dict(seconds=seconds, launches=launches,
                             stacked_steps=steps, configs=PARALLEL_CHUNK)
        path = "eager" if rank == 0 else "fused"
        plain = cross_validate(trainers[path], hypers, epochs=1, seed=42,
                               chunk=PARALLEL_CHUNK, verbose=False)
    if not np.array_equal(got[path], plain, equal_nan=True):
        raise AssertionError(f"the {path} config-sharded sweep differs from "
                             "the unsharded one")
    out[path]["bit_equal"] = True
    return out


def rank_serve(K, cfg, mesh, rank: int) -> dict:
    """A rank's session-sharded serving of phase 17 (b): 32,768 sessions x
    25 ticks over 2 ranks, f32 and bf16; then the unsharded engine, the two
    ranks at once (rank 0 f32, rank 1 bf16), preds and votes equal; the
    launches on the rank's shard and its ms a call."""
    from contrastiveprosthetics_torch.models.clip import ContrastiveModel
    from contrastiveprosthetics_torch.serve.stream import (
        BatchedStreamingEngine,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    mean = rng.normal(0.0, 0.1, cfg.emg_dim).astype(np.float32)
    std = rng.uniform(0.8, 1.2, cfg.emg_dim).astype(np.float32)
    g = torch.Generator(dev).manual_seed(3)
    blocks = torch.randn((TICKS, SESSIONS, cfg.factor, cfg.emg_dim),
                         generator=g, device=dev) * 200
    masks = torch.rand((SESSIONS, cfg.max_tasks), generator=g,
                       device=dev) < 0.5
    masks[:, 0] = True
    out, got, models = {}, {}, {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        models[name] = ContrastiveModel(
            generator=torch.Generator().manual_seed(0), dtype=dtype).to(dev)
        eng = BatchedStreamingEngine(cfg, models[name], mean, std, SESSIONS,
                                     mesh=mesh)
        K.reset_launch_counts()
        _, preds, votes = eng.steps(eng.init_carries(), blocks, masks)
        torch.cuda.synchronize()
        got[name] = (preds, votes)
        launches = {k: n for k, n in K.launch_counts.items() if n}
        enc = "encoder_chain_bf16" if name == "bf16" else "encoder_chain"
        if not all(launches.get(k) for k in ("dsp_frames", enc,
                                             "vote_scan")):
            raise AssertionError(f"rank {rank} {name} serve launches "
                                 f"{launches}")
        out[name] = dict(launches=launches, sessions_a_rank=eng.hi - eng.lo,
                         steps_ms=time_ms(lambda: eng.steps(
                             eng.init_carries(), blocks, masks), reps=3))
        del eng
    name = "f32" if rank == 0 else "bf16"
    plain = BatchedStreamingEngine(cfg, models[name], mean, std, SESSIONS)
    _, p, v = plain.steps(plain.init_carries(), blocks, masks)
    if not (torch.equal(p, got[name][0]) and torch.equal(v, got[name][1])):
        raise AssertionError(f"{name} session-sharded preds or votes differ "
                             "from the unsharded")
    out[name]["equal"] = True
    return out


def rank_clis(rank: int, path: str, tmp: str) -> dict:
    """Phase 17 (b)'s CLIs in a 2-rank group: ``cptorch-train
    --spmd_crossval`` and ``cptorch-serve --spmd --replay`` on both
    ranks; then, the group gone, rank 0 runs the unsharded commands and
    holds the files against the sharded ones'."""
    import torch.distributed as dist

    from contrastiveprosthetics_torch.cli import serve as cli_serve
    from contrastiveprosthetics_torch.cli import train as cli_train

    def train_args(d):
        return ["--synthetic", "--crossval_size", str(CLI_SPMD_CONFIGS),
                "--crossval_chunk", str(CLI_SPMD_CONFIGS // 2),
                "--final_epochs", "1", "--no_adabn", "--no_verbose",
                "--data_dir", d, "--checkpoint_dir", d]

    def serve_args(d):
        return ["--demo", "--sessions", "8", "--replay", "--quiet", "--out",
                os.path.join(d, "serve.npz")]

    sharded, plain = os.path.join(tmp, "sharded"), os.path.join(tmp, "plain")
    dist.init_process_group("gloo", init_method=f"file://{path}", rank=rank,
                            world_size=2)
    t0 = time.perf_counter()
    try:
        with deterministic():
            out = run_captured(cli_train.main, [*train_args(sharded),
                                                "--spmd_crossval"])
            out += run_captured(cli_serve.main, [*serve_args(sharded),
                                                 "--spmd"])
    finally:
        dist.destroy_process_group()
    seconds = time.perf_counter() - t0
    if rank:
        return dict(seconds=seconds)
    for line in ("crossval sharded over", "sessions sharded over"):
        if line not in out:
            raise AssertionError(f"no '{line}' line")
    with deterministic():
        run_captured(cli_train.main, train_args(plain))
        run_captured(cli_serve.main, serve_args(plain))
    for name in ("cross_val_values.npy", "cross_val_keys.npy"):
        if not np.array_equal(np.load(os.path.join(sharded, name)),
                              np.load(os.path.join(plain, name)),
                              equal_nan=True):
            raise AssertionError(f"--spmd_crossval wrote another {name}")
    a, b = (torch.load(os.path.join(d, "contrastive.pt"), map_location="cpu")
            for d in (sharded, plain))
    if a.keys() != b.keys() or not all(torch.equal(a[k], b[k]) for k in a):
        raise AssertionError("--spmd_crossval's checkpoint differs")
    with np.load(os.path.join(sharded, "serve.npz")) as x, \
            np.load(os.path.join(plain, "serve.npz")) as y:
        if not all(np.array_equal(x[k], y[k]) for k in ("preds", "votes")):
            raise AssertionError("cptorch-serve --spmd wrote other preds")
    return dict(seconds=seconds, equal=True)


def parallel_rank(rank: int, world: int, tmp: str) -> None:
    """Phase 17 (b), one rank of the gloo group on the one card: the dp=2
    step (ranks 0-1) and the dp=2 x mp=2 step (all four), the fused
    chain's f32 and bf16 steps at dp=2 x mp=2 and dp=4 (all four), the
    config-sharded sweeps and session-sharded serving (ranks 0-1), then
    the CLIs in a 2-rank group. Writes its results to
    ``tmp/rank<r>.json``."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from contrastiveprosthetics_torch.config import DEFAULT_CONFIG as cfg
    from contrastiveprosthetics_torch.data.store import DeviceStore
    from contrastiveprosthetics_torch.data.synthetic import (
        make_processed_dataset,
    )
    from contrastiveprosthetics_torch.ops import kernels as K
    from contrastiveprosthetics_torch.parallel.mesh import make_mesh
    from contrastiveprosthetics_torch.train import engine

    t0 = time.perf_counter()
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv",
                            rank=rank, world_size=world)
    res = {"start_s": time.perf_counter() - t0}
    store = DeviceStore(cfg, *make_processed_dataset(cfg),
                        device=torch.device("cuda"))
    trainer = engine.Trainer(cfg, store, adabn=False, batch_size=8)
    pair, square, quad = make_mesh(2, 1), make_mesh(2, 2), make_mesh(4, 1)
    parts = {}
    for key, mesh in (("dp2", pair), ("dp2_mp2", square)):
        t0 = time.perf_counter()
        if mesh.active:
            res[key] = rank_step(K, trainer, mesh, rank)
        parts[key] = time.perf_counter() - t0
    for key, mesh in (("fused_dp2_mp2", square), ("fused_dp4", quad)):
        t0 = time.perf_counter()
        res[key] = {dtype: rank_fused_step(K, trainer, mesh, rank,
                                           dtype == "bf16")
                    for dtype in ("f32", "bf16")}
        parts[key] = time.perf_counter() - t0
    if pair.active:
        t0 = time.perf_counter()
        res["sweep"] = rank_sweep(K, cfg, store, pair, rank)
        parts["sweep"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res["serve"] = rank_serve(K, cfg, pair, rank)
        parts["serve"] = time.perf_counter() - t0
    dist.destroy_process_group()
    if rank < 2:
        t0 = time.perf_counter()
        res["cli"] = rank_clis(rank, f"{tmp}/rdv_cli", tmp)
        parts["cli"] = time.perf_counter() - t0
    res["parts_s"] = parts
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def parallel_phase(K, trainer, dev, batched_args) -> tuple[dict, dict,
                                                          list]:
    """Phase 17, the parallel layer on the one card: (a) world 1 over NCCL
    in this process, bit-equal to the unsharded paths; (c) the kernels in
    a dp rank's modes (:func:`check_dp_kernels`); (b) one spawned group
    of 4 ranks over gloo on the card (NCCL refuses two ranks on one
    device; gloo is asked for here, never a fallback). Returns the
    ``parallel`` results, each kernel's launches on the sharded paths
    (every rank's summed) and the dp-mode ``kernels`` entries, each with
    its launches on the fused steps at its shape. The times are per rank
    on one shared card, not scaling numbers."""
    import torch.multiprocessing as mp

    from contrastiveprosthetics_torch.ops import train_fused as TF

    t_phase = time.perf_counter()
    world1, counts = parallel_world1(K, trainer, dev, batched_args)
    t0 = time.perf_counter()
    dp_entries = check_dp_kernels(TF, dev)
    kernels_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(parallel_rank, args=(PARALLEL_RANKS, tmp),
                 nprocs=PARALLEL_RANKS)
        ranks = []
        for r in range(PARALLEL_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    group_s = time.perf_counter() - t0
    for r in ranks:
        for part in ("dp2", "dp2_mp2"):
            for k, n in r.get(part, {}).get("launches", {}).items():
                counts[k] += n
        for _, key in DP_RANK_ROWS:
            for step_res in r[key].values():
                for k, n in step_res["launches"].items():
                    counts[k] += n
        for path in r.get("sweep", {}).values():
            for k, n in path["launches"].items():
                counts[k] += n
        for dtype in r.get("serve", {}).values():
            for k, n in dtype["launches"].items():
                counts[k] += n
    # each dp-mode row's launches: its kernel's on the fused steps at its
    # rank shape (dp2 x mp2: 164 rows a rank; dp4: 82), every rank's
    for (kernel, lo), entry in dp_entries.items():
        key = dict(DP_RANK_ROWS)[lo]
        dtype = "bf16" if kernel.endswith("_bf16") else "f32"
        n = sum(r[key][dtype]["launches"].get(kernel, 0) for r in ranks)
        if not n:
            raise AssertionError(f"{entry['name']} never launched on the "
                                 f"{key} steps")
        entry.update(launches=n, launches_by_path={f"parallel_{key}": n},
                     kernel_ms=entry["ms"],
                     peaks={"tf32_flops": PEAK_TF32_FLOPS,
                            "bf16_flops": PEAK_BF16_FLOPS,
                            "bytes_per_s": PEAK_BYTES_PER_S})
    res = dict(
        note="per-rank times on one shared card (4 ranks, gloo on the "
             "card), not scaling numbers; world 1 over NCCL",
        world1=world1, ranks=ranks, group_s=group_s, dp_kernels_s=kernels_s,
        phase_s=time.perf_counter() - t_phase)
    log(f"[parallel] 4-rank gloo group on the card in {group_s:.1f} s: "
        f"dp2 and dp2 x mp2 steps at JAX's bounds, the fused f32 steps at "
        f"dp2 x mp2 and dp4 at JAX's bounds and the fused bf16 ones at the "
        f"bf16 step's, the {PARALLEL_CONFIGS}-config sweep bit-equal eager "
        f"and fused, {SESSIONS} sessions f32 and bf16 equal, the CLIs' "
        f"files equal; phase 17 took {res['phase_s']:.1f} s")
    return res, counts, list(dp_entries.values())


def main() -> int:
    t_script = time.perf_counter()
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

    # the bf16 variants' launches before their phases (encoder_chain's in
    # phases 1-12, the bf16 chain's four in phases 1-13), summed across
    # every reset of the counts: they must stay 0
    before = dict.fromkeys(("encoder_chain_bf16", *BF16_K5), 0)
    tracked = set(before)
    reset_counts = K.reset_launch_counts

    def tallying_reset() -> None:
        for name in tracked:
            before[name] += K.launch_counts[name]
        reset_counts()

    K.reset_launch_counts = tallying_reset

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
    # calibration: one iir_rms_frames launch per recording (band-pass and
    # RMS), then the normalisation and BatchNorm passes, all on the card.
    # The plain version (the IIR as a host loop of launches) is fenced off
    # while the three calibration calls run, and each must launch the
    # kernel once
    from contrastiveprosthetics_torch.ops import signal as sig

    def host_iir(*args, **kwargs):
        raise AssertionError("calibration reached the plain IIR")

    K.reset_launch_counts()
    plain = (K.iir_rms_frames_reference, sig.sosfilt)
    K.iir_rms_frames_reference = sig.sosfilt = host_iir
    try:
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
        calib_counts = dict(K.launch_counts)
        preprocess_warm_ms = time_ms(
            lambda: single.preprocess_recording(calib[4]), 20, 2)
        # the first calibrate paid one-time costs (the first train-mode
        # forward on the card): a second, on a copy of the engine
        spare = copy.deepcopy(single)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        spare.calibrate(calib[4])
        torch.cuda.synchronize()
        calibrate_warm_ms = (time.perf_counter() - t0) * 1e3
        del spare
    finally:
        K.iir_rms_frames_reference, sig.sosfilt = plain
    if calib_counts["iir_rms_frames"] != 6:
        raise AssertionError(f"calibration launched iir_rms_frames "
                             f"{calib_counts['iir_rms_frames']} times for 6 "
                             "recordings")
    masks_t = torch.as_tensor(masks, device=dev)
    blocks_t = torch.as_tensor(batch_blocks, device=dev)
    log(f"[setup] engines ready: single session calibrated; {S} sessions, "
        "4 calibrated with subset masks")
    log(f"[setup] calibration on a {2 * cfg.hz}-sample recording, "
        f"iir_rms_frames launched once per recording, no host IIR: "
        f"preprocess_recording {preprocess_ms:.3f} ms (first call; "
        f"{preprocess_warm_ms:.4f} ms warm, mean of 20), calibrate "
        f"{calibrate_ms:.3f} ms (first call; {calibrate_warm_ms:.3f} ms on a "
        f"copy after it), calibrate_session {calibrate_session_ms:.3f} "
        "ms (mean of 4, affines re-derived once); with the host IIR before "
        "this kernel (PERF.md section 5): 392.21, 574.50 and 446.33 ms")

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
    fadd_cycles = min(K.fadd_latency_cycles(dev) for _ in range(3))
    log(f"[kernels] a dependent f32 add takes {fadd_cycles:.4f} SM cycles "
        f"(the recurrence floors' latency)")
    entries = check_serve_kernels(
        K, serve_cases(dev, carries, blocks_t, masks_t, scores.view(T, S, C),
                       sos, mu, sd), sm_clock_hz, fadd_cycles)
    entries["encoder_chain"] = enc
    del scores
    entries["iir_rms_frames"] = check_iir_rms(K, dev, sos, sm_clock_hz,
                                              fadd_cycles)

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
                      preprocess_recording_warm_ms=preprocess_warm_ms,
                      calibrate_ms=calibrate_ms,
                      calibrate_warm_ms=calibrate_warm_ms,
                      calibrate_session_ms=calibrate_session_ms,
                      calibration_launches=calib_counts)
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
        adam_entry = check_adam_stacked(K, dev)
        # ---------------------------------- 10. evaluation and the results
        eval_res, eval_entries = eval_phase(K, trainer, state, sweep_dir)

    # ---------------------------------------------- 11. ingest from .mat
    ingest_res, ingest_counts = ingest_phase(K, dev)

    # ------------------------------ 12. the softmax baseline and glove modes
    modes_res, modes_counts = modes_phase(K, trainer, train_res)

    # ------------------------------------------------ 13. bf16 serving
    if before["encoder_chain_bf16"] + K.launch_counts["encoder_chain_bf16"]:
        raise AssertionError("encoder_chain_bf16 launched in phases 1-12: "
                             f"{before}")
    tracked.discard("encoder_chain_bf16")
    bf16_res, bf16_entry = bf16_phase(K, dev, 0, mean, std, calib, recording,
                                      batch_blocks, masks, subsets, single,
                                      batched, b_preds)

    # ----------------------------------------------- 14. bf16 training
    K.reset_launch_counts = reset_counts
    early = {name: before[name] + K.launch_counts[name] for name in BF16_K5}
    if any(early.values()):
        raise AssertionError(f"the bf16 chain's kernels launched in phases "
                             f"1-13: {early}")
    f32_k5 = {name: dict(entries[name]) for name in FUSED_KERNELS}
    bf16_train_res, bf16_train_entries = bf16_train_phase(
        K, TF, trainer, train_res, fused_res, f32_k5)

    # ------------------------- 15. interop, the twins, --profile, --spmd*
    from contrastiveprosthetics_torch.cli import results as cli_results
    from contrastiveprosthetics_torch.cli import train as cli_train

    interop_res, interop_counts = interop_phase(K, cli, cli_train,
                                                cli_results)

    # ----- 16. the sweep on the fused chain and the fused encoder, remat
    sweep_fused_res, axis_entries = sweep_fused_phase(K, TF, trainer, dev,
                                                      sweep_res["sweep"])

    # ------------------------------------------- 17. the parallel layer
    parallel_res, parallel_counts, dp_entries = parallel_phase(
        K, trainer, dev, (model, mean, std,
                          torch.as_tensor(batch_blocks, device=dev),
                          torch.as_tensor(masks, device=dev)))

    for name, entry in entries.items():
        if name in FUSED_KERNELS:
            by_path = {"fused_train": fused_counts[name],
                       "modes": modes_counts[name]}
            fam = fused_res["step_trace"]["device_ms_by_family"]
            per = fused_res["step_trace"]["device_launches_per_step"]
            entry["device_ms_per_launch_traced"] = (
                fam[name] / per[name] if per.get(name) else None)
        elif name == "iir_rms_frames":
            by_path = {"calibration": calib_counts[name],
                       "ingest": ingest_counts[name]}
        elif name in TRAIN_KERNELS:
            by_path = {"train": train_counts[name],
                       "fused_train": fused_counts[name],
                       "sweep": sweep_counts[name],
                       "modes": modes_counts[name],
                       "interop": interop_counts[name]}
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
                       "batched": batched_counts[name],
                       "interop": interop_counts[name]}
            entry["device_ms_per_launch_by_path"] = {
                "step": per_launch(single_res["step_trace"], name),
                "steps": per_launch(steps_trace_1, name),
                "batched": per_launch(steps_trace, name)}
        by_path["parallel"] = parallel_counts[name]
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
    print(json.dumps({"ingest": ingest_res}))
    print(json.dumps({"modes": modes_res}))
    print(json.dumps({"bf16_serve": bf16_res}))
    print(json.dumps({"bf16_train": bf16_train_res}))
    print(json.dumps({"interop": interop_res}))
    print(json.dumps({"sweep_fused": sweep_fused_res}))
    fam = sweep_trace_150["device_ms_by_family"]
    by_path = {"check": adam_entry["launches_checked"]
               + adam_entry["bf16_mu"]["launches_checked"],
               "sweep": sweep_counts["adam_stacked"],
               "bf16_train": bf16_train_res["sweep"]["launches"][
                   "adam_stacked"],
               "parallel": parallel_counts["adam_stacked"]}
    adam_entry.update(
        name="adam_stacked", source=SOURCES["adam_stacked"],
        replaces=REPLACES["adam_stacked"], kernel_ms=adam_entry["ms"],
        launches=sum(by_path.values()), launches_by_path=by_path,
        device_ms_per_step_traced=fam.get("adam_stacked"),
        peaks={"f32_flops": PEAK_F32_FLOPS, "bytes_per_s": PEAK_BYTES_PER_S})
    bf16_entry["launches_by_path"]["parallel"] = parallel_counts[
        "encoder_chain_bf16"]
    bf16_entry["launches"] += parallel_counts["encoder_chain_bf16"]
    print(json.dumps({"parallel": parallel_res}))
    log(f"[done] phases 1-17 took {time.perf_counter() - t_script:.1f} s")
    print(card)
    print(json.dumps({"kernels": list(entries.values()) + eval_entries
                      + [bf16_entry, adam_entry]
                      + list(bf16_train_entries.values())
                      + list(axis_entries.values()) + dp_entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
