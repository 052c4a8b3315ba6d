"""Offline ingest: raw Ninapro ``.mat`` files -> normalized tensors.

Counterpart of the JAX package's ``data/ingest.py`` (the reference's
``load.py:103-155``, a person x rep x stim loop of 11,316 scipy calls).
Each subject's 246 (stim, rep) segments are preprocessed in one call on
the chosen device (:class:`_TorchPreprocessor`): one pass over each
exercise file's labels gives a (246, 2010) table of the segments' sample
rows (:func:`_segment_rows`), and one ``iir_rms_frames`` kernel launch on
CUDA (its plain version on the CPU) reads the subject's two recordings
through it. The float64 scipy oracle (:class:`_ScipyPreprocessor`, the
reference's own pipeline) takes the segments the JAX package's way, a
boolean mask each (:func:`_extract_segment`).

Artifacts, with the JAX package's names, keys, dtypes and shapes, so both
packages' ``DeviceStore.load`` read them:
  ``emg.npz``: ``emg`` (n_people, 41, 6, 100, 12) f32, person-first (the
      store transposes it to tasks-first, reference ``load.py:71``), and
      ``people_positions`` (n_people,) int64;
  ``emg_mean.npy``, ``emg_std.npy``: the Welford mean and std, f32;
  ``glove.npz``: ``glove`` (41, n_glove_people * 25, 20) f32;
  ``glove_mean.npy``, ``glove_std.npy``: f64.
"""
from __future__ import annotations

import os
import time
from typing import Sequence

import numpy as np
import scipy.io as sio
import torch

from contrastiveprosthetics_torch.config import INGEST_PRESCALE, Config
from contrastiveprosthetics_torch.device import select_device
from contrastiveprosthetics_torch.ops.signal import (
    butter_bandpass_sos,
    preprocess_segments,
)
from contrastiveprosthetics_torch.ops.stats import RunningStats

# backends of ingest_emg: the device one (the JAX package's name for it is
# taken too, so a JAX command line runs) and the float64 oracle
DEVICE_BACKENDS = ("torch", "jax")
BACKENDS = DEVICE_BACKENDS + ("scipy",)


def _load_emg_mat(root: str, dbnum: str, p_dir: str, ex: str):
    """Read one exercise file (reference ``load.py:78-83``)."""
    m = sio.loadmat(os.path.join(root, f"db{dbnum}", f"s{p_dir}",
                                 f"S{p_dir}_E{ex}_A1.mat"))
    return m["emg"], m["restimulus"], m["rerepetition"]


def _person_location(cfg: Config, person: int) -> tuple[str, str]:
    """A canonical person id -> (dbnum, subject dir), reference
    ``load.py:124-128``: ids from 40 are DB3, id % 40 recovers the dir."""
    dbnum = "3" if person >= cfg.max_people_d2 else "2"
    subject = person % cfg.max_people_d2 if dbnum == "3" else person
    return dbnum, str(subject + 1)


def _extract_segment(cfg: Config, Es, stim: int, rep: int) -> np.ndarray:
    """The first ``ingest_segment_len`` samples of the (stim, rep) mask
    (reference ``load.py:85-93``), edge-padded if the recording is short
    (where the reference would make a ragged window)."""
    ex = int(np.searchsorted(cfg.task_dist.cumsum(), stim))
    emg, stim_arr, rep_arr = Es[ex]
    mask = ((stim_arr == stim) & (rep_arr == rep)).squeeze()
    seg = emg[mask][: cfg.ingest_segment_len]
    if seg.shape[0] < cfg.ingest_segment_len:
        if seg.shape[0] == 0:
            raise ValueError(f"no samples for stim={stim} rep={rep}")
        pad = np.repeat(seg[-1:], cfg.ingest_segment_len - seg.shape[0],
                        axis=0)
        seg = np.concatenate([seg, pad], axis=0)
    return seg.astype(np.float64)


def _label_groups(stim_arr, rep_arr, stims, reps):
    """One pass over an exercise file's (restimulus, rerepetition) labels.
    Returns ``order``, the file's sample indices grouped by (stim, rep)
    and in time order within a group, and for each queried ``(stims[i],
    reps[i])`` its group's first position in ``order`` and its sample
    count (0 where it has none): the samples of that (stim, rep) are
    ``order[first[i]:first[i] + count[i]]``. The labels are integers, as
    Ninapro's."""
    s = np.asarray(stim_arr).reshape(-1).astype(np.int64)
    r = np.asarray(rep_arr).reshape(-1).astype(np.int64)

    def key(a, b):  # (stim, rep) as one sortable int64
        return (np.asarray(a, np.int64) << 32) + (np.asarray(b, np.int64)
                                                  & 0xFFFFFFFF)

    n = s.size
    starts = np.zeros(0, np.int64)
    if n:  # where a run of equal labels starts
        starts = np.flatnonzero(np.r_[True, (s[1:] != s[:-1])
                                      | (r[1:] != r[:-1])])
    lengths = np.diff(np.r_[starts, n])
    run_keys = key(s[starts], r[starts])
    by = np.argsort(run_keys, kind="stable")  # runs by key, in time order
    run_keys, starts, lengths = run_keys[by], starts[by], lengths[by]
    ends = np.cumsum(lengths)  # each run's end position in ``order``
    order = np.arange(n) + np.repeat(starts - (ends - lengths), lengths)
    q = key(stims, reps)
    lo = np.searchsorted(run_keys, q, "left")
    hi = np.searchsorted(run_keys, q, "right")
    ends = np.r_[0, ends]
    return order, ends[lo], ends[hi] - ends[lo]


def _segment_rows(cfg: Config, Es) -> np.ndarray:
    """The rows of every segment that :func:`ingest_emg` visits, (stim,
    rep) in its order (stim-major, reps 1..max_reps), as a (max_tasks *
    max_reps, ingest_segment_len) int32 table into the concatenation of
    ``Es``' recordings (the second file's rows offset by the first's
    length): row for row the samples of :func:`_extract_segment`, the last
    index repeated where a segment is short, and its ``ValueError`` for
    the first (stim, rep) with no samples. One label pass per file."""
    L = cfg.ingest_segment_len
    stims = np.repeat(np.arange(cfg.max_tasks), cfg.max_reps)
    reps = np.tile(np.arange(1, cfg.max_reps + 1), cfg.max_tasks)
    ex = np.searchsorted(cfg.task_dist.cumsum(), stims)
    first = np.zeros(stims.size, np.int64)
    count = np.zeros(stims.size, np.int64)
    orders, offset = [], 0
    for e, (emg, stim_arr, rep_arr) in enumerate(Es):
        sel = ex == e
        order, first[sel], count[sel] = _label_groups(
            stim_arr, rep_arr, stims[sel], reps[sel])
        orders.append(order + offset)
        offset += emg.shape[0]
    empty = np.flatnonzero(count == 0)
    if empty.size:
        k = empty[0]
        raise ValueError(f"no samples for stim={stims[k]} rep={reps[k]}")
    if offset >= 2**31:
        raise ValueError(f"{offset} samples: the table is int32")
    # each segment's k-th sample, k past its count -> its last sample
    pos = first[:, None] + np.minimum(np.arange(L), count[:, None] - 1)
    rows = np.empty((stims.size, L), np.int32)
    for e, order in enumerate(orders):
        rows[ex == e] = order[pos[ex == e]]
    return rows


class _TorchPreprocessor:
    """A subject's segments in one call on ``device``: its recordings
    copied to the card once and cast to f32 there, the
    :func:`_segment_rows` table beside them, :func:`preprocess_segments`
    (one ``iir_rms_frames`` launch reading the recordings through the
    table), back as float64 numpy."""

    def __init__(self, cfg: Config, device):
        self.device = torch.device(device)
        self._sos = torch.as_tensor(butter_bandpass_sos(20, 450, cfg.hz),
                                    dtype=torch.float32, device=self.device)
        self._time_mask = cfg.time_mask()

    def __call__(self, Es, rows: np.ndarray) -> np.ndarray:
        # copied as they are (loadmat's Fortran-order f64), laid end to end
        # and cast on the device: on an H100 about half the time of a cast
        # on the host (chip_smoke.py phase 11); both round alike
        x = torch.cat([torch.from_numpy(E[0]).to(self.device)
                       for E in Es]).float()
        frames = preprocess_segments(
            x, self._sos, self._time_mask,
            rows=torch.from_numpy(rows).to(self.device))
        return frames.cpu().numpy().astype(np.float64)


class _ScipyPreprocessor:
    """The float64 oracle (the reference's exact scipy pipeline)."""

    def __init__(self, cfg: Config):
        from scipy import signal as ssig
        from scipy.ndimage import uniform_filter1d

        nyq = cfg.hz / 2
        self._b, self._a = ssig.butter(4, [20 / nyq, 450 / nyq],
                                       btype="bandpass")
        self._lfilter = ssig.lfilter
        self._uf1d = uniform_filter1d
        self._cfg = cfg

    def __call__(self, segments: np.ndarray) -> np.ndarray:
        cfg = self._cfg
        out = []
        for seg in segments:
            f = self._lfilter(self._b, self._a, seg * INGEST_PRESCALE, axis=0)
            r = np.sqrt(
                self._uf1d(np.square(f), size=cfg.rms_window, axis=0,
                           mode="nearest")
            )[cfg.window_edge: -cfg.window_edge]
            out.append(r[cfg.time_mask()])
        return np.stack(out)


def ingest_emg(
    cfg: Config,
    root: str,
    out_dir: str,
    people_positions: Sequence[int] | None = None,
    complete: bool = False,
    backend: str = "torch",
    verbose: bool = True,
    device=None,
) -> dict:
    """Build the normalized EMG tensor (reference ``DB23.load_dataset``,
    ``load.py:103-155``) and save ``emg.npz`` and ``emg_{mean,std}.npy``.

    ``backend``: ``"torch"`` (or ``"jax"``, the JAX package's name for its
    device backend) runs on ``device`` (default: ``select_device()``,
    cuda); ``"scipy"`` is the float64 oracle on the host. Returns the
    arrays and, per subject, the seconds of its ``.mat`` read, segment
    extraction (the row table on a device backend, the segments' copies
    on the scipy one), preprocessing (copies and kernel) and statistics
    (``timings``)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    people = cfg.people()
    if people_positions is None:
        people_positions = list(range(len(people)))
    if backend in DEVICE_BACKENDS:
        pre = _TorchPreprocessor(cfg, device or select_device())
    else:
        pre = _ScipyPreprocessor(cfg)
    stats = RunningStats(complete=complete)

    n_rows = len(people_positions)
    emg_tensor = np.empty(
        (n_rows, cfg.max_tasks, cfg.max_reps, cfg.final_window_size,
         cfg.emg_dim),
        dtype=np.float64,
    )
    train_rep_set = set(cfg.rep_train_idx.tolist())
    timings = []

    for row, pos in enumerate(people_positions):
        person = int(people[pos])
        dbnum, p_dir = _person_location(cfg, person)
        t0 = time.perf_counter()
        Es = (
            _load_emg_mat(root, dbnum, p_dir, "1"),
            _load_emg_mat(root, dbnum, p_dir, "2"),
        )
        t1 = time.perf_counter()
        if backend in DEVICE_BACKENDS:
            rows = _segment_rows(cfg, Es)  # (41*6, 2010)
            t2 = time.perf_counter()
            windows = pre(Es, rows)
        else:
            segments = np.stack(
                [
                    _extract_segment(cfg, Es, stim, rep + 1)
                    for stim in range(cfg.max_tasks)
                    for rep in range(cfg.max_reps)
                ]
            )  # (41*6, 2010, 12)
            t2 = time.perf_counter()
            windows = pre(segments)
        windows = windows.reshape(
            cfg.max_tasks, cfg.max_reps, cfg.final_window_size, cfg.emg_dim
        )
        t3 = time.perf_counter()
        # stats over train-split windows only (load.py:139-141): every
        # person and stim counts, reps restricted to the train split
        for stim in range(cfg.max_tasks):
            for rep in range(cfg.max_reps):
                if rep in train_rep_set:
                    stats.push(windows[stim, rep])
        emg_tensor[row] = windows
        t4 = time.perf_counter()
        timings.append(dict(person=person, read_s=t1 - t0, extract_s=t2 - t1,
                            preprocess_s=t3 - t2, stats_s=t4 - t3))
        if verbose:
            print(f"ingested person {person} (db{dbnum}/s{p_dir}) "
                  f"[{row + 1}/{n_rows}]: read {t1 - t0:.3f} s, extract "
                  f"{t2 - t1:.3f} s, preprocess {t3 - t2:.3f} s, stats "
                  f"{t4 - t3:.3f} s")

    mean, std = stats.mean_std()
    emg_tensor = ((emg_tensor - mean) / std).astype(np.float32)

    os.makedirs(out_dir, exist_ok=True)
    np.savez(
        os.path.join(out_dir, "emg.npz"),
        emg=emg_tensor,
        people_positions=np.asarray(people_positions, dtype=np.int64),
    )
    np.save(os.path.join(out_dir, "emg_mean.npy"),
            np.asarray(mean, dtype=np.float32))
    np.save(os.path.join(out_dir, "emg_std.npy"),
            np.asarray(std, dtype=np.float32))
    return {"emg": emg_tensor, "mean": mean, "std": std, "timings": timings}


def _load_glove_mat(root: str, p_dir: str, ex: str, angle_idxs: np.ndarray):
    m = sio.loadmat(os.path.join(root, f"s_{p_dir}_angles",
                                 f"S{p_dir}_E{ex}_A1.mat"))
    return m["angles"][:, angle_idxs], m["restimulus"], m["rerepetition"]


def ingest_glove(
    cfg: Config,
    root: str,
    out_dir: str,
    people: Sequence[int] | None = None,
    verbose: bool = True,
) -> dict:
    """Build the normalized glove-angle corpus (reference ``Glover``,
    ``utils.py:185-246``) and save ``glove.npz`` and
    ``glove_{mean,std}.npy``. numpy on the host, as in the JAX package."""
    if people is None:
        people = list(range(cfg.glove_people_start, cfg.glove_people_stop))
    angle_idxs = np.delete(np.arange(22), list(cfg.glove_drop_sensors))
    task_cumsum = cfg.task_dist.cumsum()
    stats = RunningStats()
    train_tasks = cfg.tasks()

    all_stims = np.arange(cfg.max_tasks)
    ex = np.searchsorted(task_cumsum, all_stims)
    dats = []
    for person in people:
        p_dir = str(person + 1)
        Es = (
            _load_glove_mat(root, p_dir, "1", angle_idxs),
            _load_glove_mat(root, p_dir, "2", angle_idxs),
        )
        # each stim's first glove_window_size rows of reps 1..max_rep (its
        # file's largest rep), reps in order, from one label pass per file
        idx, per_stim, offset = [], np.zeros(cfg.max_tasks, np.int64), 0
        for e, (angles, stim_arr, rep_arr) in enumerate(Es):
            stims = all_stims[ex == e]
            max_rep = int(rep_arr.max())
            qs = np.repeat(stims, max_rep)
            qr = np.tile(np.arange(1, max_rep + 1), stims.size)
            order, first, count = _label_groups(stim_arr, rep_arr, qs, qr)
            take = np.minimum(count, cfg.glove_window_size)
            pos = np.repeat(first - (np.cumsum(take) - take), take)
            idx.append(order[pos + np.arange(pos.size)] + offset)
            np.add.at(per_stim, qs, take)
            offset += angles.shape[0]
        rows = np.concatenate([E[0] for E in Es])[np.concatenate(idx)]
        all_tasks = np.split(rows, np.cumsum(per_stim)[:-1])
        lens = {a.shape[0] for a in all_tasks}
        if len(lens) != 1:
            # ragged per-task rep counts: truncate to the shortest so the
            # shapes stay fixed (the reference's np.array would fail here)
            m = min(lens)
            all_tasks = [a[:m] for a in all_tasks]
        all_tasks = np.stack(all_tasks)  # (41, n, 20)
        stats.push(all_tasks[train_tasks].reshape(-1, cfg.glove_dim))
        dats.append(all_tasks)
        if verbose:
            print(f"ingested glove person {person}")

    glove = np.concatenate(dats, axis=1)
    glove = stats.normalize(glove).astype(np.float32)

    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, "glove.npz"), glove=glove)
    np.save(os.path.join(out_dir, "glove_mean.npy"),
            np.asarray(stats.mean(), dtype=np.float64))
    np.save(os.path.join(out_dir, "glove_std.npy"),
            np.asarray(stats.std(), dtype=np.float64))
    return {"glove": glove, "mean": stats.mean(), "std": stats.std()}
