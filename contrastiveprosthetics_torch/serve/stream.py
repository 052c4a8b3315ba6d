"""Streaming sliding-window inference at prosthesis-control latency.

Counterpart of the JAX package's ``serve/stream.py``. Each 10 ms control
tick: raw 2 kHz block (20 samples x 12 channels) -> stateful SOS band-pass
(IIR state carried across ticks) -> trailing window-11 RMS -> (x-mean)/std
-> EMG encoder -> cosine scores against the subset-masked class embeddings
-> majority vote over the last ``prediction_window_size`` frames.

On CUDA every tick, single (:meth:`StreamingEngine.step`) or many
(:meth:`StreamingEngine.steps`, :meth:`BatchedStreamingEngine.steps`), runs
the three kernels of ``ops/kernels.py``, and calibration
(:meth:`StreamingEngine.preprocess_recording`) the ``iir_rms_frames``
kernel; on the CPU their plain versions.
The single-session engine folds its (calibrated) BatchNorm statistics into
the weight chain; the batched engine keeps per-session statistics over one
shared BN-free chain and applies them as per-session affines.

Both fold in the model's compute dtype (JAX ``serve/stream.py:203,526``): a
bf16 model (``ContrastiveModel(dtype=torch.bfloat16)``) gives bf16 weight
chains, which run ``encoder_chain``'s bf16 variant, and calibrates through
its bf16 tower; the DSP, the affines and the vote stay f32, as in the JAX
tick, where only the dots take the folds' dtype.

``BatchedStreamingEngine(mesh=)`` shards the session axis over the
mesh's dp ranks (JAX ``serve/stream.py:396-441``): each rank holds its
block of sessions (DSP carries, vote windows, BN affines), takes every
session's blocks and subset masks, runs the tick's kernels on its own
rows and returns every session's outputs, gathered. Left out against the
JAX engines: the TPU's VMEM session-block census and its compile probe.

Under ``torch.profiler`` each engine's ``step`` runs in the span
``cptorch.serve.step`` (``utils/spans.py``), and inside it the host's
work before the first launch (the blocks as a tensor, the subset masks,
the per-session affines) in ``cptorch.serve.prepare``.
"""
from __future__ import annotations

import copy
from typing import NamedTuple

import numpy as np
import torch

from contrastiveprosthetics_torch.config import Config
from contrastiveprosthetics_torch.device import f32_convolutions
from contrastiveprosthetics_torch.models.clip import ContrastiveModel
from contrastiveprosthetics_torch.models.layers import update_running
from contrastiveprosthetics_torch.ops.kernels import (
    fold_encoder_params,
    fold_encoder_params_shared,
    fused_tick_chain,
    fused_tick_chain_batched,
    iir_rms_frames,
    session_bn_affines,
    tick_chain,
)
from contrastiveprosthetics_torch.ops.signal import butter_bandpass_sos
from contrastiveprosthetics_torch.parallel.collectives import gather_rows
from contrastiveprosthetics_torch.parallel.mesh import local_range
from contrastiveprosthetics_torch.utils.spans import span


@torch.no_grad()
def recalibrate_batch_stats(model: ContrastiveModel, frames: torch.Tensor,
                            stats=None, passes: int = 40):
    """Online AdaBN: re-estimate every BatchNorm's running statistics from
    preprocessed calibration ``frames`` (T, emg_dim)
    (``serve/stream.py:53-93`` of the JAX package), through the model's
    compute dtype: a bf16 tower gives the statistics of JAX's bf16
    ``_calibration_pass``.

    The JAX version iterates ``passes`` train-mode forwards, each moving
    the running averages toward the batch (flax momentum 0.9, biased
    variance). A train-mode BatchNorm normalizes with the batch's own
    statistics, so every pass sees the same batch statistics; this takes
    them from one forward and applies the ``passes`` updates in the same
    order. ``stats``: the (mean, var) pairs to start from (default: the
    model's running statistics). Returns the new pairs.
    """
    norms = model.emg_net.norms()
    if stats is None:
        stats = [(bn.running_mean, bn.running_var) for bn in norms]
    modes = [bn.training for bn in norms]
    batch: list = []
    try:
        for bn in norms:
            bn.train()
        with f32_convolutions():
            model.emg_net(frames, batch)
    finally:
        for bn, mode in zip(norms, modes):
            bn.train(mode)
    out = []
    for (mean, var), (b_mean, b_var) in zip(stats, batch):
        for _ in range(passes):
            mean = update_running(mean, b_mean)
            var = update_running(var, b_var)
        out.append((mean, var))
    return out


class StreamCarry(NamedTuple):
    iir_state: torch.Tensor  # (n_sections, 2, emg_dim) [or (S, ...)]
    tail: torch.Tensor       # (rms_window-1, emg_dim) last filtered samples
    votes: torch.Tensor      # (prediction_window_size,) int32, oldest first
    n_seen: torch.Tensor     # () int32 frames seen so far (vote warm-up)


class StreamingEngine:
    """Per-tick inference for one session with carried DSP state."""

    def __init__(self, cfg: Config, model: ContrastiveModel,
                 emg_mean: np.ndarray, emg_std: np.ndarray):
        """The engine works on its own copy of ``model`` (calibration
        changes the copy's statistics) on the model's device."""
        if model.adabn:
            # AdaBN normalizes a single streamed frame against its own
            # zero-variance statistics and ignores calibrated ones
            raise ValueError(
                "StreamingEngine requires a plain-BN model (adabn=False): "
                "AdaBN ignores calibrated running statistics at inference. "
                "Train with --no_adabn and use calibrate() for "
                "subject-adapted statistics.")
        self.cfg = cfg
        self.model = copy.deepcopy(model).eval()
        self.device = self.model.logit_scale.device
        f32 = dict(dtype=torch.float32, device=self.device)
        self._sos = torch.as_tensor(butter_bandpass_sos(20, 450, cfg.hz), **f32)
        self._mean = torch.as_tensor(np.asarray(emg_mean, np.float32), **f32)
        self._std = torch.as_tensor(np.asarray(emg_std, np.float32), **f32)
        with torch.no_grad():
            self._class_emb = self.model.encode_classes()
        self._folded = self._fold()

    def _fold(self) -> tuple[torch.Tensor, ...]:
        return fold_encoder_params(self.model.emg_net, self._class_emb,
                                   dtype=self.model.dtype)

    @property
    def folded_chain(self) -> tuple[torch.Tensor, ...]:
        """The weight chain with this session's statistics folded in."""
        return self._folded

    @property
    def n_classes(self) -> int:
        return self._class_emb.shape[0]

    def init_carry(self) -> StreamCarry:
        cfg, dev = self.cfg, self.device
        return StreamCarry(
            torch.zeros((self._sos.shape[0], 2, cfg.emg_dim), device=dev),
            torch.zeros((cfg.rms_window - 1, cfg.emg_dim), device=dev),
            torch.zeros(cfg.prediction_window_size, dtype=torch.int32,
                        device=dev),
            torch.zeros((), dtype=torch.int32, device=dev),
        )

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.array(x, np.float32)
                               if not torch.is_tensor(x) else x,
                               dtype=torch.float32,
                               device=self.device).contiguous()

    def _mask(self, subset_mask, shape) -> torch.Tensor:
        if subset_mask is None:
            return torch.ones(shape, dtype=torch.bool, device=self.device)
        return torch.as_tensor(np.array(subset_mask, bool)
                               if not torch.is_tensor(subset_mask)
                               else subset_mask,
                               dtype=torch.bool, device=self.device
                               ).expand(shape).contiguous()

    def step(self, carry: StreamCarry, raw_block, subset_mask=None):
        """One tick: ``raw_block`` (factor, emg_dim). Returns (carry,
        pred (), vote (), masked scores (n_classes,))."""
        with span("cptorch.serve.step"):
            with span("cptorch.serve.prepare"):
                block = self._tensor(raw_block)
                mask = self._mask(subset_mask, (1, self.n_classes))
            (iir, tail, votes, n_seen), preds, vote_preds, masked = (
                tick_chain(carry.iir_state[None], carry.tail[None],
                           carry.votes[None], carry.n_seen.reshape(1),
                           block[None, None], mask, self._sos, self._mean,
                           self._std, self._folded))
            return (StreamCarry(iir[0], tail[0], votes[0], n_seen[0]),
                    preds[0, 0], vote_preds[0, 0], masked[0, 0])

    def steps(self, carry: StreamCarry, raw_blocks, subset_mask=None):
        """``(K, factor, emg_dim)`` blocks in one call, tick for tick the
        same as K :meth:`step` calls. Returns (carry, preds (K,), votes
        (K,))."""
        (iir, tail, votes, n_seen), preds, vote_preds = fused_tick_chain(
            carry.iir_state, carry.tail, carry.votes, carry.n_seen,
            self._tensor(raw_blocks), self._mask(subset_mask,
                                                 (self.n_classes,)),
            self._sos, self._mean, self._std, self._folded)
        return StreamCarry(iir, tail, votes, n_seen), preds, vote_preds

    def preprocess_recording(self, raw_recording) -> torch.Tensor:
        """A raw 2 kHz recording (T, emg_dim) -> normalized frames on the
        engine's device, by the ingest pipeline (filter -> valid-mode RMS ->
        every ``factor``-th frame -> normalize): the band-pass and the RMS
        are one ``iir_rms_frames`` call on a batch of one at stride
        ``factor``."""
        raw = self._tensor(raw_recording)
        frames = iir_rms_frames(raw[None], self._sos, self.cfg.factor)[0]
        return (frames - self._mean) / self._std

    def calibrate(self, raw_recording) -> None:
        """Online AdaBN at test time: re-estimate the BN running statistics
        from a calibration recording of the current user, then re-fold the
        weight chain (the fold absorbs the statistics)."""
        frames = self.preprocess_recording(raw_recording)
        new_stats = recalibrate_batch_stats(self.model, frames)
        for bn, (mean, var) in zip(self.model.emg_net.norms(), new_stats):
            bn.running_mean.copy_(mean)
            bn.running_var.copy_(var)
        self._folded = self._fold()

    def run(self, raw: np.ndarray, subset_mask=None):
        """Stream a whole recording (T, emg_dim) through :meth:`steps`;
        returns per-block (preds, votes) as numpy arrays."""
        n_blocks = raw.shape[0] // self.cfg.factor
        blocks = np.asarray(raw[: n_blocks * self.cfg.factor],
                            np.float32).reshape(n_blocks, self.cfg.factor, -1)
        _, preds, votes = self.steps(self.init_carry(), blocks, subset_mask)
        return preds.cpu().numpy(), votes.cpu().numpy()


class BatchedStreamingEngine:
    """``n_sessions`` prosthesis users served together: shared encoder
    weights, per-session BatchNorm statistics (each calibrated by
    :meth:`calibrate_session`), per-session DSP state, vote window and
    grasp-subset mask.

    ``mesh``: a ``parallel/mesh.py::Mesh``; its dp ranks each serve
    ``n_sessions / n_dp`` sessions, ``[lo, hi)`` (``n_sessions`` must
    divide by dp). Its carries are that block's; :meth:`step` and
    :meth:`steps` take every session's blocks and masks and return every
    session's outputs; each session is calibrated by the rank that holds
    it. Every rank of the mesh calls each method."""

    def __init__(self, cfg: Config, model: ContrastiveModel,
                 emg_mean: np.ndarray, emg_std: np.ndarray, n_sessions: int,
                 mesh=None):
        self.n_sessions = n_sessions
        self.cfg = cfg
        self.mesh = mesh
        self.lo, self.hi = 0, n_sessions
        if mesh is not None:
            if n_sessions % mesh.n_dp:
                raise ValueError(f"n_sessions={n_sessions} must divide by "
                                 f"the mesh's dp size {mesh.n_dp}")
            self.lo, self.hi = local_range(n_sessions, mesh.n_dp,
                                           mesh.dp_rank)
        self._single = StreamingEngine(cfg, model, emg_mean, emg_std)
        emg_net = self._single.model.emg_net
        self._shared = fold_encoder_params_shared(
            emg_net, self._single._class_emb, dtype=self._single.model.dtype)
        S = self.hi - self.lo
        self._stats = [(bn.running_mean.expand(S, -1).clone(),
                        bn.running_var.expand(S, -1).clone())
                       for bn in emg_net.norms()]
        self._affines = session_bn_affines(emg_net, self._stats)
        self._affines_dirty = False

    def init_carries(self) -> StreamCarry:
        """The carries of this rank's sessions (all of them unsharded)."""
        one = self._single.init_carry()
        return StreamCarry(*(x.expand((self.hi - self.lo,) + x.shape).clone()
                             for x in one))

    def calibrate_session(self, i: int, raw_recording) -> None:
        """Re-estimate session ``i``'s BN statistics from its own
        calibration recording; the affines are re-derived once, lazily, by
        the next tick. Under a mesh the rank holding session ``i`` does
        it, and the others return."""
        if not self.lo <= i < self.hi:
            return
        i -= self.lo
        frames = self._single.preprocess_recording(raw_recording)
        current = [(mean[i], var[i]) for mean, var in self._stats]
        new = recalibrate_batch_stats(self._single.model, frames, current)
        for (mean, var), (new_mean, new_var) in zip(self._stats, new):
            mean[i] = new_mean
            var[i] = new_var
        self._affines_dirty = True

    @property
    def shared_chain(self) -> tuple[torch.Tensor, ...]:
        """The BN-free weight chain every session shares."""
        return self._shared

    def session_affines(self) -> tuple[torch.Tensor, ...]:
        """The per-session BN affines, re-derived first if a session was
        calibrated since they were last derived."""
        if self._affines_dirty:
            self._affines = session_bn_affines(self._single.model.emg_net,
                                               self._stats)
            self._affines_dirty = False
        return self._affines

    def _args(self, subset_masks):
        """The tick chain's arguments after the blocks, for this rank's
        sessions."""
        single = self._single
        masks = single._mask(subset_masks, (self.n_sessions, single.n_classes))
        return (masks[self.lo:self.hi], single._sos, single._mean,
                single._std, self._shared, self.session_affines())

    def _gathered(self, dim: int, *parts):
        """Every session's outputs from each rank's ``parts``, along
        ``dim`` (as they are unsharded)."""
        if self.mesh is None:
            return parts
        return tuple(gather_rows(p, self.lo, self.n_sessions,
                                 self.mesh.dp_group, dim) for p in parts)

    def step(self, carries: StreamCarry, raw_blocks, subset_masks=None):
        """One tick of every session: ``raw_blocks`` (S, factor, emg_dim),
        ``subset_masks`` (S, n_classes) bool or None. Returns (carries,
        preds (S,), votes (S,), masked scores (S, n_classes))."""
        with span("cptorch.serve.step"):
            with span("cptorch.serve.prepare"):
                blocks = self._single._tensor(raw_blocks[self.lo:self.hi])
                args = self._args(subset_masks)
            carry, preds, vote_preds, masked = tick_chain(
                *carries, blocks[None], *args)
            return (StreamCarry(*carry),
                    *self._gathered(0, preds[0], vote_preds[0], masked[0]))

    def steps(self, carries: StreamCarry, raw_blocks_seq, subset_masks=None):
        """``(K, S, factor, emg_dim)`` blocks in one call. Returns
        (carries, preds (K, S), votes (K, S))."""
        carry, preds, vote_preds = fused_tick_chain_batched(
            *carries,
            self._single._tensor(raw_blocks_seq[:, self.lo:self.hi]),
            *self._args(subset_masks))
        return (StreamCarry(*carry),
                *self._gathered(1, preds, vote_preds))
