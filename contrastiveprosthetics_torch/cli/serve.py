"""Streaming-inference CLI (``cptorch-serve``), the port of ``cptpu-serve``.

Streams a raw 2 kHz recording through the online pipeline (stateful
band-pass -> trailing RMS -> encoder -> subset-masked scores -> majority
vote) one 10 ms control tick at a time and reports per-tick predictions,
the running majority vote, and the measured tick latency.

Inputs:
  --checkpoint   a reference ``Model.state_dict()`` saved with torch.save
                 (``.pt``), or the JAX package's ``TrainState`` msgpack
                 (``.msgpack``, from ``cptpu-train``; read by
                 ``train/jax_interop.py``); serve requires a plain-BN
                 model.
  --data_dir     where ``emg_mean.npy``/``emg_std.npy`` live (ingest stats).
  --recording    .npy (T, 12) raw 2 kHz samples, or .npz with key ``emg``;
                 with --sessions S also (S, T, 12).
  --calibrate    optional calibration recording: online AdaBN
                 re-estimation of BN statistics before streaming (per
                 session with --sessions).
  --subset       comma-separated class ids to restrict prediction to.
  --sessions     serve S concurrent sessions with the batched engine.
  --replay       the whole recording in one call instead of tick by tick.
  --bf16         bfloat16 compute: the EMG tower (calibration) in bf16 and
                 the weight folds in bf16, which run encoder_chain's bf16
                 variant; parameters, DSP and votes stay f32.
  --demo         fabricate recording, stats and weights (no files needed).
  --platform     cuda (default) or cpu.

The JAX CLI's ``--fused_encoder`` is taken as a no-op (on CUDA every tick
already runs ``encoder_chain``); ``--no_fused_encoder`` exits, since no
other encoder path serves on the card. ``--spmd`` shards the sessions
of the batched engine over ranks (``BatchedStreamingEngine(mesh=)``), as
the JAX CLI does where more than one device is visible and the session
count divides by theirs: over the ranks of an initialized default
process group (torchrun, or a caller's group), else over one NCCL rank
per visible CUDA device, which the CLI starts itself; otherwise it serves
unsharded and says so. Under a group rank 0 alone prints the results and
writes ``--out``.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from contrastiveprosthetics_torch.cli.train import (
    launcher_group,
    rank0,
    spawn_ranks,
    spmd_ranks,
)
from contrastiveprosthetics_torch.config import DEFAULT_CONFIG as cfg
from contrastiveprosthetics_torch.device import add_platform_flag, select_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Stream a recording through the online inference engine")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="reference state_dict .pt, or a JAX TrainState "
                        ".msgpack (default: fresh weights)")
    p.add_argument("--data_dir", type=str, default="data")
    p.add_argument("--recording", type=str, default=None)
    p.add_argument("--calibrate", type=str, default=None)
    p.add_argument("--subset", type=str, default=None,
                   help="comma-separated class ids, e.g. 3,7,12")
    p.add_argument("--sessions", type=int, default=1)
    p.add_argument("--seconds", type=float, default=2.0,
                   help="--demo recording length")
    p.add_argument("--d_e", type=int, default=16)
    p.add_argument("--out", type=str, default=None,
                   help="save preds/votes (npz)")
    p.add_argument("--demo", action="store_true",
                   help="synthetic recording + fresh weights (no files)")
    p.add_argument("--replay", action="store_true",
                   help="process the whole recording in one call instead "
                        "of simulating real-time ticks (identical outputs)")
    p.add_argument("--spmd", action="store_true",
                   help="shard the session axis over several devices")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 tick compute (parameters stay f32; the "
                        "weight folds are bf16)")
    p.add_argument("--fused_encoder", action="store_true",
                   help="a no-op: every tick runs the encoder_chain kernel")
    p.add_argument("--no_fused_encoder", action="store_true",
                   help="refused: encoder_chain is the only encoder path "
                        "of the tick")
    p.add_argument("--quiet", action="store_true")
    add_platform_flag(p)
    return p


def _load_recording(path: str) -> np.ndarray:
    if path.endswith(".npz"):
        with np.load(path) as z:
            return np.asarray(z["emg"], np.float32)
    return np.asarray(np.load(path), np.float32)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    if args.no_fused_encoder:
        raise SystemExit(
            "--no_fused_encoder: the port's tick has one encoder path, the "
            "encoder_chain kernel on the folded weights (ops/kernels.py), "
            "and no unfused one to switch to; drop the flag")
    device = select_device(args.platform)
    with launcher_group(device, asked=args.spmd):
        return serve(args, argv, device)


def serve(args, argv, device) -> int:
    """The run after the flags' checks, on ``device``: ``--spmd``'s ranks
    (``cli/train.py::spmd_ranks``), the model, the recording, the
    engine, the ticks and the report."""
    mesh = None
    if args.spmd:
        n = spmd_ranks("--spmd", "the sessions served", device,
                       sessions=args.sessions)
        if n > 1 and not dist.is_initialized():
            return spawn_ranks(main, argv, n)
        if n > 1:
            from contrastiveprosthetics_torch.parallel.mesh import make_mesh

            mesh = make_mesh(n_dp=n)
            if rank0():
                print(f"sessions sharded over {mesh} ({dist.get_backend()})")

    from contrastiveprosthetics_torch.models.clip import ContrastiveModel
    from contrastiveprosthetics_torch.models.convert import (
        load_reference_checkpoint,
        model_from_state_dict,
    )
    from contrastiveprosthetics_torch.serve.stream import (
        BatchedStreamingEngine,
        StreamingEngine,
    )

    dtype = torch.bfloat16 if args.bf16 else torch.float32
    if args.checkpoint:
        if args.checkpoint.endswith(".msgpack"):
            from contrastiveprosthetics_torch.train.jax_interop import (
                read_msgpack,
            )

            # serving runs plain BatchNorm, as the JAX CLI builds its model
            sd = read_msgpack(args.checkpoint,
                              adabn=False)[0].model.state_dict()
        else:
            sd = load_reference_checkpoint(args.checkpoint)
        model = model_from_state_dict(sd, dtype=dtype)
        if model.prediction or model.glove_encoding:
            raise SystemExit(f"{args.checkpoint}: the serve path scores "
                             "EMG against one-hot class embeddings; a "
                             "--prediction or --glove_encoding model has "
                             "none (as in the JAX serve path)")
    else:
        if not args.demo:
            print("warning: no --checkpoint given — using fresh-init weights")
        model = ContrastiveModel(d_e=args.d_e, emg_dim=cfg.emg_dim,
                                 n_classes=cfg.max_tasks, dtype=dtype,
                                 generator=torch.Generator().manual_seed(0))
    model = model.to(device)

    mean_p = os.path.join(args.data_dir, "emg_mean.npy")
    std_p = os.path.join(args.data_dir, "emg_std.npy")
    if os.path.exists(mean_p) and os.path.exists(std_p):
        # the compat 'complete' stats ship a scalar mean (utils.py:104-117)
        emg_mean = np.broadcast_to(np.load(mean_p).astype(np.float32),
                                   (cfg.emg_dim,)).copy()
        emg_std = np.broadcast_to(np.load(std_p).astype(np.float32),
                                  (cfg.emg_dim,)).copy()
    else:
        if not args.demo:
            print(f"warning: no ingest stats under {args.data_dir} — "
                  "using identity normalization")
        emg_mean = np.zeros(cfg.emg_dim, np.float32)
        emg_std = np.ones(cfg.emg_dim, np.float32)

    S = args.sessions
    if args.recording:
        raw = _load_recording(args.recording)
    elif args.demo:
        rng = np.random.default_rng(0)
        n = int(args.seconds * cfg.hz)
        raw = rng.standard_normal((n, cfg.emg_dim)).astype(np.float32)
    else:
        raise SystemExit("need --recording FILE (or --demo)")
    if raw.ndim == 2:
        raw = np.broadcast_to(raw, (S,) + raw.shape)
    if raw.shape[0] != S:
        raise SystemExit(f"recording has {raw.shape[0]} sessions, "
                         f"--sessions={S}")

    subset_mask = None
    if args.subset:
        ids = [int(x) for x in args.subset.split(",")]
        bad = [i for i in ids if not 0 <= i < cfg.max_tasks]
        if bad:
            raise SystemExit(f"--subset ids must be in [0, {cfg.max_tasks}), "
                             f"got {bad}")
        subset_mask = np.zeros(cfg.max_tasks, dtype=bool)
        subset_mask[ids] = True

    calib = _load_recording(args.calibrate) if args.calibrate else None
    n_blocks = raw.shape[1] // cfg.factor
    if n_blocks < 1:
        raise SystemExit(f"recording has {raw.shape[1]} samples — shorter "
                         f"than one {cfg.factor}-sample tick")
    seq = np.ascontiguousarray(raw[:, : n_blocks * cfg.factor]).reshape(
        S, n_blocks, cfg.factor, -1)

    lat = []
    if S == 1:
        engine = StreamingEngine(cfg, model, emg_mean, emg_std)
        if calib is not None:
            if calib.ndim == 3:  # (sessions, samples, ch) file
                if calib.shape[0] != 1:
                    raise SystemExit(f"--calibrate has {calib.shape[0]} "
                                     "sessions; --sessions=1 needs one")
                calib = calib[0]
            engine.calibrate(calib)
            print(f"calibrated BN statistics from {args.calibrate}")
        carry = engine.init_carry()
        if args.replay:
            t0 = time.perf_counter()
            _, p, v = engine.steps(carry, seq[0], subset_mask)
            preds, votes = p.cpu().numpy()[None], v.cpu().numpy()[None]
            lat.append(time.perf_counter() - t0)
        else:
            preds = np.empty((1, n_blocks), np.int32)
            votes = np.empty((1, n_blocks), np.int32)
            for i in range(n_blocks):
                t0 = time.perf_counter()
                carry, p, v, _ = engine.step(carry, seq[0, i], subset_mask)
                votes[0, i] = int(v)  # waits for the tick's result
                lat.append(time.perf_counter() - t0)
                preds[0, i] = int(p)
    else:
        engine = BatchedStreamingEngine(cfg, model, emg_mean, emg_std,
                                        n_sessions=S, mesh=mesh)
        if calib is not None:
            if calib.ndim == 2:
                calib = np.broadcast_to(calib, (S,) + calib.shape)
            for s in range(S):
                engine.calibrate_session(s, calib[s])
            print(f"calibrated BN statistics for {S} sessions")
        masks = (np.broadcast_to(subset_mask, (S, cfg.max_tasks))
                 if subset_mask is not None else None)
        carries = engine.init_carries()
        if args.replay:
            t0 = time.perf_counter()
            _, p, v = engine.steps(carries, np.moveaxis(seq, 0, 1), masks)
            preds, votes = p.cpu().numpy().T, v.cpu().numpy().T
            lat.append(time.perf_counter() - t0)
        else:
            preds = np.empty((S, n_blocks), np.int32)
            votes = np.empty((S, n_blocks), np.int32)
            for i in range(n_blocks):
                t0 = time.perf_counter()
                carries, p, v, _ = engine.step(carries, seq[:, i], masks)
                votes[:, i] = v.cpu().numpy()
                lat.append(time.perf_counter() - t0)
                preds[:, i] = p.cpu().numpy()
    _sync(device)
    if not rank0():
        return 0

    budget = 1000.0 * cfg.factor / cfg.hz
    if args.replay:
        # one call for the whole recording: no per-tick latencies exist
        dt = float(lat[0])
        timing = {"replay_total_ms": np.float64(dt * 1e3)}
        print(f"replayed {n_blocks} ticks × {S} session(s) in one call on "
              f"{device.type}: {dt * 1e3:.1f} ms total (first call), "
              f"{dt / n_blocks * 1e6:.1f} µs/tick amortized")
    else:
        lat_ms = np.array(lat[1:]) * 1e3  # drop the first (build) tick
        timing = {"lat_ms": lat_ms}
        if lat_ms.size:
            print(f"streamed {n_blocks} ticks × {S} session(s) on "
                  f"{device.type}: p50 {np.percentile(lat_ms, 50):.3f} "
                  f"ms/tick, p99 {np.percentile(lat_ms, 99):.3f} ms "
                  f"(budget {budget:.0f} ms)")
        else:
            print(f"streamed {n_blocks} tick × {S} session(s): first tick "
                  f"{lat[0] * 1e3:.3f} ms (budget {budget:.0f} ms)")
    if not args.quiet:
        for s in range(min(S, 4)):
            uniq, cnt = np.unique(votes[s], return_counts=True)
            top = ", ".join(
                f"{int(u)}×{int(c)}"
                for u, c in sorted(zip(uniq, cnt), key=lambda t: -t[1])[:5])
            print(f"session {s}: final vote class {int(votes[s, -1])}; "
                  f"vote counts: {top}")
    if args.out:
        np.savez(args.out, preds=preds, votes=votes, **timing)
        print(f"saved preds/votes to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
