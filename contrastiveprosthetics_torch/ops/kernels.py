"""The port's kernels: the serve path's three, the train step's fused
contrastive loss, and the folds that feed the serve kernels.

Counterpart of the JAX package's ``ops/pallas_ops.py`` sections 2-4. On the
TPU the tick chain was one Pallas kernel whose sequential grid step was the
tick, with the weights resident in VMEM. Nothing in a tick depends on the
previous tick's encoder: the IIR/RMS state depends only on the raw input
and the vote window only on the per-tick preds. So here a recording runs
as three phases over all its ticks, each a hand-written CUDA kernel for
Hopper (``csrc/``):

* ``dsp_frames``: prescale -> SOS band-pass -> trailing RMS -> normalize,
  one thread per (session, channel) running the IIR over input staged in
  shared memory by ``cp.async``, the frames taken by the whole CTA;
* ``encoder_chain`` (:func:`fused_encoder_logits`): the folded encoder
  chain in 3xTF32 on the tensor cores, one host call that issues 9 layer
  launches and 1 head launch; on a bf16 fold its bf16 variant (counted
  as ``encoder_chain_bf16``), one bf16 ``mma.sync`` pass a product;
* ``vote_scan``: masked first-max prediction and the majority vote,
  parallel over (tick, session), and the masked scores where asked.

The ingest's and the calibration's band-pass and RMS run as one more
kernel, ``iir_rms_frames`` (``csrc/iir_rms.cu``): from zero state, the
leading-window RMS at every stride-th sample (``ops/signal.py``'s
``preprocess_segments`` and ``StreamingEngine.preprocess_recording``),
reading each segment's samples from a recording through a row table
where the ingest gives one.

The fused training chain's kernels (``ops/train_fused.py``: K5f, K5b,
the chain's tail pair and K5m) launch through the same table and count
here too; the bf16 chain's four (K5f, K5b and the tail pair on bf16
activations) count under their own names, ``*_bf16``.

The crossval sweep's stacked Adam update is one more kernel,
:func:`adam_stacked` (``csrc/adam_stacked.cu``): one pass over every
parameter of a tower, for all its C configs, bit for bit the plain tensor
ops it replaced (:func:`adam_stacked_reference`).

The train step's K1 pair (``pallas_ops.py:185,213``) is
:func:`fused_contrastive_loss`, a ``torch.autograd.Function`` whose forward
launches ``contrastive_loss_fwd`` and whose backward launches
``contrastive_loss_bwd`` (``csrc/contrastive_loss.cu``).

Every wrapper has its plain PyTorch version beside it (``*_reference``),
which repeats the kernel's arithmetic with ``torch.matmul`` and loops. A
wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel or raises, never falls back. ``launch_counts`` counts
kernel launches, one per CUDA kernel launched; a span of
``utils/spans.py`` counts them between its edges (this module hands it
the counter), and the tick chain's three phases each run in one
(``cptorch.serve.<phase>``).

The folds (:func:`fold_encoder_params`, :func:`fold_encoder_params_shared`,
:func:`session_bn_affines`) are plain torch on the weights, in the JAX
package's layout: activations position-major (``p*F+c``), both convs as
banded dense matrices, each BatchNorm affine absorbed into the following
layer (``pallas_ops.py:280-397``). They fold in f32; with ``dtype=
torch.bfloat16`` each weight matrix and ``Gt`` is then cast to bf16, the
biases and the per-session affines stay f32 (``pallas_ops.py:318-322``).
"""
from __future__ import annotations

import ctypes
import functools
import weakref
from typing import NamedTuple

import torch

from contrastiveprosthetics_torch.config import INGEST_PRESCALE
from contrastiveprosthetics_torch.models.stacked import StackedLinear
from contrastiveprosthetics_torch.ops import _build
from contrastiveprosthetics_torch.utils.spans import count_with, span

NEG = torch.finfo(torch.float32).min  # the mask value of stream.py:268

launch_counts = {"dsp_frames": 0, "encoder_chain": 0,
                 "encoder_chain_bf16": 0, "vote_scan": 0,
                 "iir_rms_frames": 0,
                 "contrastive_loss_fwd": 0, "contrastive_loss_bwd": 0,
                 "dense_block_fwd": 0, "dense_block_bwd": 0,
                 "chain_tail_fwd": 0, "chain_tail_bwd": 0,
                 "dense_block_fwd_bf16": 0, "dense_block_bwd_bf16": 0,
                 "chain_tail_fwd_bf16": 0, "chain_tail_bwd_bf16": 0,
                 "dropout_masks": 0, "adam_stacked": 0}
# launches of the fused chain's kernels in a dp rank's modes, counted
# beside their kernel's launch_counts: K5f's sums-only end (by kernel), and
# any chain kernel given a nonzero row base or K5b a batch's row count; and
# adam_stacked's launches on a bf16 first moment
mode_counts = {"dense_block_fwd_sums": 0, "dense_block_fwd_bf16_sums": 0,
               "row_base": 0, "n_total": 0, "adam_stacked_bf16_mu": 0}
count_with(lambda: sum(launch_counts.values()))


def reset_launch_counts() -> None:
    for counts in (launch_counts, mode_counts):
        for name in counts:
            counts[name] = 0


# ------------------------------------------------------------------ folds
CHAIN_DTYPES = (torch.float32, torch.bfloat16)


def _vecmat(c: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``c @ w`` of a vector and a matrix, or of each config's ((C, K) by
    (C, K, N)) one config at a time, so that a config's fold has the bits
    of its own."""
    if c.dim() == 1:
        return c @ w
    return torch.stack([ci @ wi for ci, wi in zip(c, w)])


def _tile(t: torch.Tensor, P: int) -> torch.Tensor:
    """A (.., F) vector repeated P times along its last axis."""
    return t.repeat(*[1] * (t.dim() - 1), P)


@torch.no_grad()
def _fold_chain(emg_net, bn_affine, class_emb,
                dtype) -> tuple[torch.Tensor, ...]:
    """EMGNet weights + a ``bn_affine(i) -> (a, c)`` policy -> the flat
    (A0, d0, ..., Ah, dh, Gt) chain; each BN affine goes into the next
    layer's weights (``pallas_ops.py:280-323``), in f32; then the weights
    and Gt are cast to ``dtype``. Biases are 1-D f32. A ``StackedEMGNet``
    of C configs (its parameters with a leading config axis, and
    ``class_emb`` (C, n_classes, d_e)) folds each config as one would,
    stacked: weights (C, K, N), biases (C, N), Gt (C, d_e, n_classes)."""
    if dtype not in CHAIN_DTYPES:
        raise ValueError(f"fold dtype {dtype}: want one of {CHAIN_DTYPES}")
    conv1, conv2 = emg_net.conv_emg[0], emg_net.conv_emg[3]
    # only the middle kernel row touches the 1x12 image
    k1 = conv1.weight[..., 0, 1, :].transpose(-1, -2)  # (3, F)
    # (3, F_in, F_out)
    k2 = conv2.weight[..., 1, :].movedim(-1, -3).transpose(-1, -2)
    lead = k1.shape[:-2]
    F = k1.shape[-1]
    P = emg_net.emg_dim
    m1 = k1.new_zeros((*lead, P, P * F))
    m2 = k2.new_zeros((*lead, P * F, P * F))
    for p in range(P):
        for kw in range(3):
            ps = p + kw - 1  # source position (SAME padding)
            if 0 <= ps < P:
                m1[..., ps, p * F:(p + 1) * F] = k1[..., kw, :]
                m2[..., ps * F:(ps + 1) * F, p * F:(p + 1) * F] = \
                    k2[..., kw, :, :]

    layers = [(m1, _tile(conv1.bias, P))]
    a, c = (_tile(t, P) for t in bn_affine(0))
    layers.append((a[..., :, None] * m2,
                   _tile(conv2.bias, P) + _vecmat(c, m2)))
    a, c = (_tile(t, P) for t in bn_affine(1))
    lin = [m for m in emg_net.linear
           if isinstance(m, (torch.nn.Linear, StackedLinear))]
    for i, m in enumerate(lin):
        if i == 0:  # un-permute the reference's channel-major c*P+p input
            # (in, out), position-major p*F+c
            w = (m.weight.unflatten(-1, (F, P)).movedim(-3, -1)
                 .transpose(-3, -2).flatten(-3, -2))
        else:
            w = m.weight.transpose(-1, -2)
        layers.append((a[..., :, None] * w, m.bias + _vecmat(c, w)))
        a, c = bn_affine(i + 2)
    wh = emg_net.last[0].weight.transpose(-1, -2)
    layers.append((a[..., :, None] * wh, _vecmat(c, wh)))
    flat = []
    for w, b in layers:
        flat += [w.float().to(dtype).contiguous(), b.float().contiguous()]
    # Gt: (d_e, n_classes)
    flat.append(class_emb.transpose(-1, -2).float().to(dtype).contiguous())
    return tuple(flat)


def fold_encoder_params(emg_net, class_emb, *, eps: float = 1e-5,
                        dtype: torch.dtype = torch.float32):
    """EMGNet (running statistics absorbed) + normalized class embeddings
    -> the chain :func:`fused_encoder_logits` takes, its weights in
    ``dtype`` (``pallas_ops.py:326-351``). A ``StackedEMGNet`` and (C,
    n_classes, d_e) class embeddings give each config's chain stacked on
    a leading axis, config c's bit-equal to the fold of config c alone."""
    norms = emg_net.norms()

    def bn_affine(i):
        bn = norms[i]
        a = bn.weight / torch.sqrt(bn.running_var + eps)
        return a, bn.bias - bn.running_mean * a

    return _fold_chain(emg_net, bn_affine, class_emb, dtype)


def fold_encoder_params_shared(emg_net, class_emb, *,
                               dtype: torch.dtype = torch.float32):
    """The BN-free chain shared by every session of the batched engine, its
    weights in ``dtype``; the per-session statistics come as
    :func:`session_bn_affines`, f32 in any dtype (``pallas_ops.py:354-368``).
    """
    norms = emg_net.norms()

    def identity(i):
        return torch.ones_like(norms[i].weight), torch.zeros_like(norms[i].bias)

    return _fold_chain(emg_net, identity, class_emb, dtype)


@torch.no_grad()
def session_bn_affines(emg_net, stats, *, eps: float = 1e-5):
    """Per-session BatchNorm affines ``(a0, c0, a1, c1, ...)``, each
    (S, width) f32: ``y = relu(h @ W + b) * a + c`` reproduces
    Conv/Dense -> ReLU -> BN. ``stats``: one (mean, var) pair of (S, width)
    tensors per BatchNorm. Conv affines are tiled over the P positions
    (``pallas_ops.py:371-397``)."""
    P = emg_net.emg_dim
    flat = []
    for i, (bn, (mean, var)) in enumerate(zip(emg_net.norms(), stats)):
        a = bn.weight[None, :] / torch.sqrt(var + eps)
        c = bn.bias[None, :] - mean * a
        if i < 2:  # post-conv BNs act per channel at every position
            a, c = a.repeat(1, P), c.repeat(1, P)
        flat += [a.float().contiguous(), c.float().contiguous()]
    return tuple(flat)


# --------------------------------------------------------- wrapper helpers
def _ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t is not None else None)


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _expect(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want {tuple(shape)}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, want {dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, want {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


# launcher -> (library, C symbol, pointers, ints, has a float argument)
_SIGNATURES = {
    "dsp_frames": ("dsp_frames", "dsp_frames_launch", 9, 6, True),
    "vote_scan": ("vote_scan", "vote_scan_launch", 9, 4, False),
    "iir_rms_frames": ("iir_rms", "iir_rms_frames_launch", 4, 8, True),
    "fadd_latency": ("iir_rms", "fadd_latency_launch", 2, 1, False),
    "contrastive_loss_fwd": ("contrastive_loss", "contrastive_loss_fwd_launch",
                             3, 4, False),
    "contrastive_loss_bwd": ("contrastive_loss", "contrastive_loss_bwd_launch",
                             5, 4, False),
    "dense_block_fwd": ("train_fused", "dense_block_fwd_launch", 13, 10, True),
    "dense_block_bwd": ("train_fused", "dense_block_bwd_launch", 16, 10, False),
    "chain_tail_fwd": ("train_fused", "chain_tail_fwd_launch", 6, 5, False),
    "chain_tail_bwd": ("train_fused", "chain_tail_bwd_launch", 8, 5, False),
    "dense_block_fwd_bf16": ("train_fused", "dense_block_fwd_bf16_launch", 13,
                             10, True),
    "dense_block_bwd_bf16": ("train_fused", "dense_block_bwd_bf16_launch", 16,
                             10, False),
    "chain_tail_fwd_bf16": ("train_fused", "chain_tail_fwd_bf16_launch", 6, 5,
                            False),
    "chain_tail_bwd_bf16": ("train_fused", "chain_tail_bwd_bf16_launch", 8, 5,
                            False),
    "dropout_masks": ("train_fused", "dropout_masks_launch", 3, 4, False),
    "philox_check": ("train_fused", "philox_check_launch", 4, 1, False),
}
# adam_stacked_launch: the leaf table (parameter and gradient pointers,
# column offsets, sizes, vector flags, its length), mu, nu, lr, C, N, the
# kind, seven float64 numbers, the grid and the stream
_ADAM_ARGTYPES = ([ctypes.POINTER(ctypes.c_void_p)] * 2
                  + [ctypes.POINTER(ctypes.c_longlong)]
                  + [ctypes.POINTER(ctypes.c_int)] * 2 + [ctypes.c_int]
                  + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong,
                                             ctypes.c_int]
                  + [ctypes.c_double] * 7 + [ctypes.c_int, ctypes.c_void_p])


_fns: dict = {}


def _fn(name: str):
    """The C launcher ``name`` with its ctypes signature: pointers, ints,
    an optional float, then the stream; returns the cudaError_t."""
    if name not in _fns:
        if name in ("encoder_chain", "encoder_chain_bf16"):
            # the layer table, then as below
            fn = getattr(_build.load("encoder_chain"), name + "_launch")
            fn.argtypes = ([ctypes.POINTER(ctypes.c_void_p),
                            ctypes.POINTER(ctypes.c_int), ctypes.c_int]
                           + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                           + [ctypes.c_void_p])
        elif name == "adam_stacked":
            fn = _build.load(name).adam_stacked_launch
            fn.argtypes = _ADAM_ARGTYPES
        else:
            library, symbol, n_ptr, n_int, has_float = _SIGNATURES[name]
            fn = getattr(_build.load(library), symbol)
            fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                           + ([ctypes.c_float] if has_float else [])
                           + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _launch(name: str, counter: str, *args) -> None:
    rc = _fn(name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    launch_counts[counter] += 1


# -------------------------------------------------------------- dsp_frames
def dsp_frames_reference(iir_state, tail, blocks, sos, mean, std):
    """Plain version of ``dsp_frames``. ``blocks`` (K, S, factor, D),
    ``iir_state`` (S, n_sec, 2, D), ``tail`` (S, rms_window-1, D), ``sos``
    (n_sec, 6) f32. Returns frames (K, S, D), new iir_state, new tail."""
    K, S, factor, D = blocks.shape
    R = tail.shape[1]
    W = R + 1
    n_sec = sos.shape[0]
    z = [[iir_state[:, k, 0].clone(), iir_state[:, k, 1].clone()]
         for k in range(n_sec)]
    coef = [[sos[k, i] for i in range(6)] for k in range(n_sec)]
    frames = blocks.new_empty((K, S, D))
    x = blocks * INGEST_PRESCALE
    # a tensor divisor: CUDA divides by a Python scalar as a multiply by
    # its rounded reciprocal, the kernel (and the CPU) divide exactly
    n_win = blocks.new_tensor(float(W))
    for k in range(K):
        filt = []
        for t in range(factor):
            y = x[k, :, t]
            for j in range(n_sec):
                b0, b1, b2, _, a1, a2 = coef[j]
                yk = b0 * y + z[j][0]
                z[j] = [b1 * y - a1 * yk + z[j][1], b2 * y - a2 * yk]
                y = yk
            filt.append(y)
        buf = torch.cat([tail, torch.stack(filt, dim=1)], dim=1)
        win = buf[:, R + factor - W:]
        acc = win[:, 0] * win[:, 0]
        for i in range(1, W):
            acc = acc + win[:, i] * win[:, i]
        # the f32 square root correctly rounded, as the kernel's
        # __fsqrt_rn: a CPU build's vectorised f32 sqrt can be an ulp off,
        # and a float64 root rounded once to f32 is exact
        rms = torch.sqrt((acc / n_win).double()).float()
        frames[k] = (rms - mean) / std
        tail = buf[:, factor:]
    new_iir = torch.stack([torch.stack(zk, dim=1) for zk in z], dim=1)
    return frames, new_iir, tail.contiguous()


# (n_sec, factor, rms_window, D) the dsp_frames kernel is compiled for: the
# config's 4 SOS sections, 20 samples per tick, an 11-sample RMS window and
# 12 channels (csrc/dsp_frames.cu instantiates its template for these only)
DSP_FRAMES_SHAPE = (4, 20, 11, 12)


def dsp_frames(iir_state, tail, blocks, sos, mean, std):
    """The ``dsp_frames`` kernel (see :func:`dsp_frames_reference`). On the
    card it takes ``DSP_FRAMES_SHAPE`` only, and ``blocks`` 16-byte
    aligned."""
    if blocks.device.type == "cpu":
        return dsp_frames_reference(iir_state, tail, blocks, sos, mean, std)
    K, S, factor, D = blocks.shape
    n_sec, R = sos.shape[0], tail.shape[1]
    if (n_sec, factor, R + 1, D) != DSP_FRAMES_SHAPE:
        raise ValueError(f"dsp_frames kernel: (n_sec, factor, rms_window, D) "
                         f"= {(n_sec, factor, R + 1, D)}, compiled for "
                         f"{DSP_FRAMES_SHAPE} only")
    dev, f32 = blocks.device, torch.float32
    _expect_aligned("blocks", blocks, (K, S, factor, D), dev)
    for name, t, shape in (("iir_state", iir_state, (S, n_sec, 2, D)),
                           ("tail", tail, (S, R, D)), ("sos", sos, (n_sec, 6)),
                           ("mean", mean, (D,)), ("std", std, (D,))):
        _expect(name, t, shape, f32, dev)
    frames = torch.empty((K, S, D), dtype=f32, device=dev)
    iir_out = torch.empty_like(iir_state)
    tail_out = torch.empty_like(tail)
    _launch("dsp_frames", "dsp_frames",
            _ptr(blocks), _ptr(iir_state), _ptr(tail), _ptr(sos), _ptr(mean),
            _ptr(std), _ptr(frames), _ptr(iir_out), _ptr(tail_out),
            K, S, factor, D, n_sec, R + 1, INGEST_PRESCALE, _stream(dev))
    return frames, iir_out, tail_out


# ---------------------------------------------------------- iir_rms_frames
# (n_sec, rms_window, D) the iir_rms_frames kernel is compiled for: the
# config's 4 SOS sections, 11-sample RMS window and 12 channels
IIR_RMS_SHAPE = (4, 11, 12)


def iir_rms_n_frames(T: int, stride: int, rms_window: int,
                     n_frames: int | None = None) -> int:
    """Frames of ``iir_rms_frames`` on T samples: all whole windows that
    start at a multiple of ``stride``, or ``n_frames`` of them (checked)."""
    if stride < 1:
        raise ValueError(f"stride {stride}: want 1 or more")
    n_max = (T - rms_window) // stride + 1 if T >= rms_window else 0
    if n_frames is None:
        return n_max
    if not 0 <= n_frames <= n_max:
        raise ValueError(f"{n_frames} frames at stride {stride}: T={T} "
                         f"samples hold {n_max} whole windows of "
                         f"{rms_window}")
    return n_frames


def iir_rms_frames_reference(x, sos, stride, n_frames=None, rows=None):
    """Plain version of ``iir_rms_frames``. ``x`` (B, T, D) raw, or with
    ``rows`` (B, T) int32 a recording (N, D) whose row ``rows[b, t]`` is
    sample t of segment b; ``sos`` (n_sec, 6) f32. From zero state, ``y =
    sosfilt(sos, INGEST_PRESCALE * x)`` along T, then ``frames[b, f] =
    sqrt(sum_{k<W} y[b, f*stride + k]^2 / W)`` (W = 11) for the first
    ``n_frames`` (default: every whole window) -> (B, n_frames, D). The
    window's squares are summed oldest first, each add rounded: closer to
    float64 than a cumulative-sum difference, and the kernel's order."""
    from contrastiveprosthetics_torch.ops.signal import sosfilt

    if rows is not None:
        x = x[rows.long()]
    B, T, D = x.shape
    W = IIR_RMS_SHAPE[1]
    n = iir_rms_n_frames(T, stride, W, n_frames)
    if n == 0:
        return x.new_empty((B, 0, D))
    span = (n - 1) * stride + 1
    y = sosfilt(sos, (x[:, :span + W - 1] * INGEST_PRESCALE).transpose(0, 1))
    sq = (y * y).transpose(0, 1)  # (B, span + W - 1, D)
    acc = sq[:, 0:span:stride]
    for k in range(1, W):
        acc = acc + sq[:, k:k + span:stride]
    # a tensor divisor and a float64 root rounded once: exact division and
    # the correctly rounded f32 root, as the kernel's __fdiv_rn and
    # __fsqrt_rn (see dsp_frames_reference)
    return torch.sqrt((acc / x.new_tensor(float(W))).double()).float()


def _check_rows(x, rows) -> None:
    """Raise ``ValueError`` unless ``rows`` is a (B, T) int32 table on the
    device of the recording ``x`` (N, D), every row in [0, N)."""
    if x.dim() != 2:
        raise ValueError(f"x: shape {tuple(x.shape)}, want (N, D) with rows")
    if rows.dim() != 2 or rows.dtype != torch.int32:
        raise ValueError(f"rows: {tuple(rows.shape)} {rows.dtype}, want "
                         "(B, T) int32")
    if rows.device != x.device:
        raise ValueError(f"rows: on {rows.device}, want {x.device}")
    if rows.numel():
        lo, hi = (int(v) for v in torch.aminmax(rows))
        if lo < 0 or hi >= x.shape[0]:
            raise ValueError(f"rows: indices in [{lo}, {hi}], x has "
                             f"{x.shape[0]} rows")


def iir_rms_frames(x, sos, stride, n_frames=None, rows=None):
    """The ``iir_rms_frames`` kernel (see :func:`iir_rms_frames_reference`):
    one launch for all B x D chains, reading ``x`` (B, T, D), or with
    ``rows`` (B, T) int32 the rows of a recording ``x`` (N, D) through
    that table (checked before any launch). On the card it takes
    ``IIR_RMS_SHAPE`` only."""
    if rows is not None:
        _check_rows(x, rows)
    if x.device.type == "cpu":
        return iir_rms_frames_reference(x, sos, stride, n_frames, rows)
    if rows is None:
        if x.dim() != 3:
            raise ValueError(f"x: shape {tuple(x.shape)}, want (B, T, D)")
        B, T, D = x.shape
    else:
        (B, T), D = rows.shape, x.shape[1]
    n_sec, W = sos.shape[0], IIR_RMS_SHAPE[1]
    if (n_sec, D) != (IIR_RMS_SHAPE[0], IIR_RMS_SHAPE[2]):
        raise ValueError(f"iir_rms_frames kernel: (n_sec, rms_window, D) = "
                         f"{(n_sec, W, D)}, compiled for {IIR_RMS_SHAPE} "
                         "only")
    n = iir_rms_n_frames(T, stride, W, n_frames)
    dev, f32 = x.device, torch.float32
    _expect_aligned("x", x, x.shape, dev)
    if rows is not None:
        _expect("rows", rows, (B, T), torch.int32, dev)
    _expect("sos", sos, (n_sec, 6), f32, dev)
    frames = torch.empty((B, n, D), dtype=f32, device=dev)
    if B and n:
        N = B * T if rows is None else x.shape[0]
        _launch("iir_rms_frames", "iir_rms_frames", _ptr(x), _ptr(rows),
                _ptr(sos), _ptr(frames), N, B, T, D, n_sec, W, stride, n,
                INGEST_PRESCALE, _stream(dev))
    return frames


def fadd_latency_cycles(device, n: int = 1 << 16) -> float:
    """SM cycles of one f32 add that waits on the one before (a chain of
    ``n`` dependent ``__fadd_rn`` in one thread, ``n`` a multiple of 16):
    the latency that bounds ``iir_rms_frames``' recurrence. A measurement
    only; it is on no path and counts no launch."""
    v = torch.tensor([1.0, 1e-30], dtype=torch.float32, device=device)
    cycles = torch.zeros(1, dtype=torch.int64, device=device)
    rc = _fn("fadd_latency")(_ptr(v), _ptr(cycles), n, _stream(device))
    if rc != 0:
        raise RuntimeError(f"fadd_latency kernel launch failed: cudaError "
                           f"{rc}")
    return int(cycles.item()) / n


# ----------------------------------------------------------- encoder_chain
def _dot(h, w):
    """``h @ w`` as the JAX package's ``_dot_f32`` (``pallas_ops.py:400-404``):
    on a bf16 weight, ``h`` rounded to bf16 and the product summed in the
    activations' precision (each product of two bf16 values is exact in f32
    and in TF32, so TF32 matmuls change no product); else plain."""
    if w.dtype == torch.bfloat16:
        return h.to(torch.bfloat16).to(h.dtype) @ w.to(h.dtype)
    return h @ w


def fused_encoder_logits_reference(frames, folded, affines=None):
    """Plain version of ``encoder_chain``: (N, emg_dim) frames -> (N,
    n_classes) scores. With ``affines`` (the batched engine), rows are
    (tick, session) ordered and row r takes session r % S's affine after
    each hidden layer's ReLU. On a bf16 fold each dot rounds its
    activations to bf16 (:func:`_dot`); bias, ReLU, affine and the norm of
    ``e`` stay in the frames' precision (f32, or float64 given float64
    frames and biases). A stacked fold of C configs (``fold_encoder_params``
    of a ``StackedEMGNet``) takes (C, N, emg_dim) frames, each config's
    through its own chain, and gives (C, N, n_classes)."""
    *ws, gt = folded
    h = frames
    for j in range(0, len(ws) - 2, 2):
        h = torch.relu(_dot(h, ws[j]) + ws[j + 1].unsqueeze(-2))
        if affines is not None:
            a, c = affines[j], affines[j + 1]
            S = a.shape[0]
            h = (h.view(-1, S, h.shape[1]) * a + c).view(-1, h.shape[1])
    e = _dot(h, ws[-2]) + ws[-1].unsqueeze(-2)
    e = e / torch.linalg.vector_norm(e, dim=-1, keepdim=True)
    return _dot(e, gt)


# Calls of at most this many rows run the small-row tiling (16-row tiles,
# N over 64-96 CTAs), larger ones the 128 x 128 pipelined tiling; both give
# a row the same bits. Fixed where chip_smoke.py's timing of both tilings
# crosses on an H100 (between 640 and 768 rows, PERF.md).
ENCODER_SMALL_ROWS = 640
# the bf16 variant's: its tilings cross between 256 and 512 rows, and read
# the same at 384 (chip_smoke.py phase 13 on an H100, PERF.md)
ENCODER_SMALL_ROWS_BF16 = 384
ENCODER_MAX_K = 2048  # the small tiling stages a 16-row A and K x 8 of W
ENCODER_MAX_E = 32    # the head's embedding width held per lane
ENCODER_MAX_C = 65535  # configs: a grid dimension


def encoder_regime(M: int, dtype: torch.dtype = torch.float32) -> int:
    """The tiling ``encoder_chain`` runs ``M`` rows of a ``dtype`` chain
    with: 0 small, 1 large."""
    small = (ENCODER_SMALL_ROWS_BF16 if dtype == torch.bfloat16
             else ENCODER_SMALL_ROWS)
    return 0 if M <= small else 1


class EncoderPlan:
    """A folded chain (and per-session affines) checked once for the
    ``encoder_chain`` kernels, with its launch table: the layer pointers and
    widths as ctypes arrays, and the chain's dtype (f32 or bf16), which
    picks the kernel variant; ``configs`` () for one chain, (C,) for a
    stacked fold of C. Holds its tensors by weak reference."""

    def __init__(self, folded, affines, device, tensors, widths, configs=()):
        self.refs = tuple(weakref.ref(t) for t in (*folded, *(affines or ())))
        self.device = device
        self.configs = tuple(configs)
        self.dtype = folded[0].dtype
        self.n_hidden = len(widths) - 3
        self.S = affines[0].shape[0] if affines is not None else 1
        self.widths = tuple(widths)
        self.max_n = max(widths[1:self.n_hidden + 1])
        self.table = (ctypes.c_void_p * len(tensors))(
            *(t.data_ptr() if t is not None else None for t in tensors))
        self.dims = (ctypes.c_int * len(widths))(*widths)

    def serves(self, folded, affines) -> bool:
        tensors = (*folded, *(affines or ()))
        return (len(tensors) == len(self.refs)
                and all(r() is t for r, t in zip(self.refs, tensors)))


def _expect_aligned(name: str, t: torch.Tensor, shape, device,
                    dtype: torch.dtype = torch.float32) -> None:
    _expect(name, t, shape, dtype, device)
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: not 16-byte aligned")


def encoder_plan(folded, affines=None) -> EncoderPlan:
    """Check ``folded`` (and ``affines``) for the ``encoder_chain`` kernels
    and build their launch table; raises ``ValueError`` on what the
    kernels do not take: a shape, dtype, device or layout that does not
    chain, a hidden width that is not a multiple of 4 (8 in a bf16 chain:
    rows of 16 bytes), a pointer that is not 16-byte aligned, K above
    ``ENCODER_MAX_K`` or E above ``ENCODER_MAX_E``. A chain's weights and
    Gt are all f32 or all bf16 (the dtype of the first weight); its
    biases and affines are f32 in both. A stacked fold of C configs has
    every tensor with a leading axis of C, and no affines."""
    *ws, gt = folded
    n_hidden = (len(ws) - 2) // 2
    if len(ws) % 2 or n_hidden < 1:
        raise ValueError(f"a chain of {len(folded)} tensors: want (W, b) "
                         "per hidden layer, Wh, bh and Gt")
    if affines is not None and len(affines) != 2 * n_hidden:
        raise ValueError(f"{len(affines)} affines for {n_hidden} layers")
    lead = tuple(ws[0].shape[:-2])
    if lead and (affines is not None or not 1 <= lead[0] <= ENCODER_MAX_C):
        raise ValueError(f"a stacked fold of {lead[0]} configs: the kernels "
                         f"take 1 to {ENCODER_MAX_C} and no affines")
    dev = gt.device
    wt = ws[0].dtype
    if wt not in CHAIN_DTYPES:
        raise ValueError(f"w0: dtype {wt}, want one of {CHAIN_DTYPES}")
    vec = 8 if wt == torch.bfloat16 else 4  # elements in 16 bytes
    S = affines[0].shape[0] if affines is not None else 1
    K = ws[0].shape[-2]
    widths, tensors = [K], []
    for j in range(n_hidden):
        w, b = ws[2 * j], ws[2 * j + 1]
        N = w.shape[-1]
        # the first layer reads f32 frames, every later one the scratch
        if K % (4 if j == 0 else vec) or N % vec or K > ENCODER_MAX_K:
            raise ValueError(f"layer {j}: K={K}, N={N}; the kernels take "
                             f"multiples of {vec} (the frames' K: of 4) and "
                             f"K <= {ENCODER_MAX_K}")
        _expect_aligned(f"w{j}", w, (*lead, K, N), dev, wt)
        _expect_aligned(f"b{j}", b, (*lead, N), dev)
        a = c = None
        if affines is not None:
            a, c = affines[2 * j], affines[2 * j + 1]
            _expect_aligned(f"a{j}", a, (S, N), dev)
            _expect_aligned(f"c{j}", c, (S, N), dev)
        tensors += [w, b, a, c]
        widths.append(N)
        K = N
    wh, bh = ws[-2], ws[-1]
    E, C = wh.shape[-1], gt.shape[-1]
    if E > ENCODER_MAX_E or E % 4:
        raise ValueError(f"embedding width {E}: the head takes multiples of "
                         f"4 up to {ENCODER_MAX_E}")
    _expect_aligned("wh", wh, (*lead, K, E), dev, wt)
    _expect("bh", bh, (*lead, E), torch.float32, dev)
    _expect("gt", gt, (*lead, E, C), wt, dev)
    return EncoderPlan(folded, affines, dev, tensors + [wh, bh, gt],
                       widths + [E, C], lead)


_plans: dict = {}


def _plan_for(folded, affines) -> EncoderPlan:
    """The cached plan of a chain, checked where it is first used."""
    key = (id(folded), id(affines))
    plan = _plans.get(key)
    if plan is None or not plan.serves(folded, affines):
        if len(_plans) >= 8:
            _plans.clear()
        plan = _plans[key] = encoder_plan(folded, affines)
    return plan


def encoder_chain(frames, plan: EncoderPlan, regime: int) -> torch.Tensor:
    """One ``encoder_chain_launch`` call on ``frames`` (M, K_0) f32, or
    ``encoder_chain_bf16_launch`` for a bf16 plan: every layer launch and
    the head launch, in the tiling ``regime``. The bf16 variant keeps the
    activations between layers in a bf16 scratch. A stacked plan of C
    configs takes (C, M, K_0) frames and gives (C, M, n_classes), each
    layer and the head one launch for all C."""
    lead = plan.configs
    M = frames.shape[-2]
    _expect_aligned("frames", frames, (*lead, M, plan.widths[0]),
                    plan.device)
    if M % plan.S:
        raise ValueError(f"{M} rows are not whole ticks of {plan.S} sessions")
    scores = torch.empty((*lead, M, plan.widths[-1]), dtype=torch.float32,
                         device=plan.device)
    if M == 0:
        return scores
    name = ("encoder_chain_bf16" if plan.dtype == torch.bfloat16
            else "encoder_chain")
    C = lead[0] if lead else 1
    scratch = torch.empty((2, C, M, plan.max_n), dtype=plan.dtype,
                          device=plan.device)
    rc = _fn(name)(plan.table, plan.dims, plan.n_hidden, frames.data_ptr(),
                   scratch.data_ptr(), scores.data_ptr(), M, C, plan.S,
                   regime, _stream(plan.device))
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    launch_counts[name] += plan.n_hidden + 1
    return scores


def fused_encoder_logits(frames, folded, affines=None):
    """The ``encoder_chain`` kernels (see
    :func:`fused_encoder_logits_reference`): one host call launches one
    tensor-core layer kernel per hidden layer and the head, in the tiling
    :func:`encoder_regime` picks from the row count (a config's, on a
    stacked fold); 3xTF32 on an f32 chain, one bf16 pass on a bf16
    chain."""
    if frames.device.type == "cpu":
        return fused_encoder_logits_reference(frames, folded, affines)
    plan = _plan_for(folded, affines)
    return encoder_chain(frames, plan,
                         encoder_regime(frames.shape[-2], plan.dtype))


# --------------------------------------------------------------- vote_scan
def vote_scan_reference(scores, masks, votes, n_seen, masked=False):
    """Plain version of ``vote_scan``. ``scores`` (K, S, C) f32, ``masks``
    (S, C) bool, ``votes`` (S, W) int32 oldest first, ``n_seen`` (S,) int32.
    Returns preds (K, S), votes (K, S), new votes window, new n_seen, and
    with ``masked`` the masked scores (K, S, C) after them."""
    if masked:
        return (*vote_scan_reference(scores, masks, votes, n_seen),
                torch.where(masks, scores, NEG))
    K, S, C = scores.shape
    W = votes.shape[1]
    preds = torch.empty((K, S), dtype=torch.int32, device=scores.device)
    vote_out = torch.empty_like(preds)
    slots = torch.arange(W, device=scores.device)
    for k in range(K):
        masked = torch.where(masks, scores[k], NEG)
        pred = torch.argmax(masked, dim=1).to(torch.int32)  # first max
        votes = torch.cat([votes[:, 1:], pred[:, None]], dim=1)
        n_seen = torch.clamp(n_seen + 1, max=W)
        valid = slots[None, :] >= (W - n_seen)[:, None]
        hot = torch.nn.functional.one_hot(votes.long(), C) * valid[..., None]
        counts = torch.where(masks, hot.sum(dim=1), -1)
        preds[k] = pred
        vote_out[k] = torch.argmax(counts, dim=1).to(torch.int32)
    return preds, vote_out, votes.contiguous(), n_seen.to(torch.int32)


def vote_scan(scores, masks, votes, n_seen, masked=False):
    """The ``vote_scan`` kernel (see :func:`vote_scan_reference`); with
    ``masked`` the same launch writes the masked scores."""
    if scores.device.type == "cpu":
        return vote_scan_reference(scores, masks, votes, n_seen, masked)
    K, S, C = scores.shape
    W = votes.shape[1]
    dev = scores.device
    _expect("scores", scores, (K, S, C), torch.float32, dev)
    _expect("masks", masks, (S, C), torch.bool, dev)
    _expect("votes", votes, (S, W), torch.int32, dev)
    _expect("n_seen", n_seen, (S,), torch.int32, dev)
    preds = torch.empty((K, S), dtype=torch.int32, device=dev)
    vote_out = torch.empty_like(preds)
    votes_out = torch.empty_like(votes)
    nseen_out = torch.empty_like(n_seen)
    masked_out = (torch.empty((K, S, C), dtype=torch.float32, device=dev)
                  if masked else None)
    _launch("vote_scan", "vote_scan", _ptr(scores), _ptr(masks), _ptr(votes),
            _ptr(n_seen), _ptr(preds), _ptr(vote_out), _ptr(votes_out),
            _ptr(nseen_out), _ptr(masked_out), K, S, C, W, _stream(dev))
    if masked:
        return preds, vote_out, votes_out, nseen_out, masked_out
    return preds, vote_out, votes_out, nseen_out


# ------------------------------------------------------------- tick chains
def _chain(dsp, enc, vote, iir_state, tail, votes, n_seen, blocks,
           subset_masks, sos, mean, std, folded, affines=None, masked=True):
    """K ticks of S sessions through the three phases ``dsp -> enc ->
    vote`` (the kernels or their plain versions), each in its span; the
    masked scores only with ``masked``, else None in their place."""
    K, S = blocks.shape[:2]
    with span("cptorch.serve.dsp_frames"):
        frames, iir_state, tail = dsp(iir_state, tail, blocks, sos, mean,
                                      std)
    with span("cptorch.serve.encoder_chain"):
        scores = enc(frames.reshape(K * S, -1), folded, affines).view(
            K, S, -1)
    with span("cptorch.serve.vote_scan"):
        preds, vote_preds, votes, n_seen, *rest = vote(
            scores, subset_masks, votes, n_seen, masked)
    return ((iir_state, tail, votes, n_seen), preds, vote_preds,
            rest[0] if masked else None)


def tick_chain(*args, **kwargs):
    """K ticks of S sessions: dsp_frames -> encoder_chain -> vote_scan.

    Takes ``(iir_state, tail, votes, n_seen, blocks, subset_masks, sos,
    mean, std, folded, affines=None, masked=True)``; all carry tensors lead
    with the session axis and ``blocks`` is (K, S, factor, D). Returns
    ((iir_state, tail, votes, n_seen), preds (K, S), votes (K, S), masked
    scores (K, S, C), or None without ``masked``)."""
    return _chain(dsp_frames, fused_encoder_logits, vote_scan, *args, **kwargs)


def tick_chain_reference(*args, **kwargs):
    """Plain version of :func:`tick_chain`."""
    return _chain(dsp_frames_reference, fused_encoder_logits_reference,
                  vote_scan_reference, *args, **kwargs)


def _single(chain, iir_state, tail, votes, n_seen, blocks, subset_mask, sos,
            mean, std, folded):
    """One session through ``chain`` as a batch of one, without the masked
    scores."""
    carry, preds, vote_preds, _ = chain(
        iir_state[None], tail[None], votes[None], n_seen.reshape(1),
        blocks[:, None], subset_mask[None], sos, mean, std, folded,
        masked=False)
    iir, tl, vw, ns = carry
    return (iir[0], tl[0], vw[0], ns[0]), preds[:, 0], vote_preds[:, 0]


def fused_tick_chain(*args):
    """K ticks of one session (``pallas_ops.py:627`` signature):
    ``(iir_state (n_sec, 2, D), tail (rms_window-1, D), votes (W,), n_seen
    (), blocks (K, factor, D), subset_mask (C,) bool, sos, mean, std,
    folded)``. Returns ((iir_state, tail, votes, n_seen), preds (K,), votes
    (K,))."""
    return _single(tick_chain, *args)


def fused_tick_chain_reference(*args):
    """Plain version of :func:`fused_tick_chain`."""
    return _single(tick_chain_reference, *args)


def fused_tick_chain_batched(iir_state, tail, votes, n_seen, blocks,
                             subset_masks, sos, mean, std, shared, affines):
    """K ticks of S sessions over the shared BN-free chain with
    per-session affines (``pallas_ops.py:837`` signature, without the TPU's
    ``session_block``). Returns ((iir_state, tail, votes, n_seen), preds
    (K, S), votes (K, S))."""
    return tick_chain(iir_state, tail, votes, n_seen, blocks, subset_masks,
                      sos, mean, std, shared, affines, masked=False)[:3]


def fused_tick_chain_batched_reference(iir_state, tail, votes, n_seen,
                                       blocks, subset_masks, sos, mean, std,
                                       shared, affines):
    """Plain version of :func:`fused_tick_chain_batched`."""
    return tick_chain_reference(iir_state, tail, votes, n_seen, blocks,
                                subset_masks, sos, mean, std, shared,
                                affines, masked=False)[:3]


# ------------------------------------------------------ contrastive loss
CONTRASTIVE_MAX_T = CONTRASTIVE_MAX_D = 64  # what one CTA stages (csrc)
CONTRASTIVE_MAX_N = 8192  # items whose losses the forward's rank 0 holds
CONTRASTIVE_MAX_C = 65535  # configs: the grid's second dimension


def fused_contrastive_reference(e, g):
    """Plain version of the K1 forward: ``e``, ``g`` (N, T, d) or (C, N, T,
    d) normalized -> (mean over items of the symmetric CE, number of rows
    whose first maximum is the diagonal, f32), 0-d or (C,)
    (``pallas_ops.py:1019-1031``, vmapped over configs)."""
    logits = e @ g.transpose(-1, -2)
    T = logits.shape[-1]
    diag_r = torch.log_softmax(logits, dim=-1).diagonal(dim1=-2, dim2=-1)
    diag_c = torch.log_softmax(logits, dim=-2).diagonal(dim1=-2, dim2=-1)
    loss = -(diag_r.sum(-1) + diag_c.sum(-1)) / (2.0 * T)
    labels = torch.arange(T, device=e.device)
    correct = (logits.argmax(dim=-1) == labels).sum((-2, -1))
    return loss.mean(-1), correct.to(torch.float32)


def contrastive_loss_bwd_reference(e, g, dloss):
    """Plain version of the K1 backward: the gradient of each config's mean
    loss, times its upstream scalar ``dloss`` (0-d, (1,) or (C,)), written
    out as the TPU kernel computes it (``pallas_ops.py:169-182``): dlogits
    = (softmax_row - I + softmax_col - I) / (2T N), de = dlogits g, dg =
    dlogits^T e."""
    N, T, _ = e.shape[-3:]
    logits = e @ g.transpose(-1, -2)
    eye = torch.eye(T, device=e.device)
    denom = logits.new_tensor(2.0 * T * N)  # a tensor: exact division
    dl = (torch.softmax(logits, -1) - eye + torch.softmax(logits, -2) - eye
          ) / denom
    up = dloss.reshape(*e.shape[:-3], 1, 1, 1)
    return (dl @ g) * up, (dl.transpose(-1, -2) @ e) * up


def _check_contrastive(e, g) -> tuple[int, int, int, int]:
    """(C, N, T, d) of a (N, T, d) call (C = 1) or a (C, N, T, d) one."""
    if e.dim() not in (3, 4):
        raise ValueError(f"e: shape {tuple(e.shape)}, want (N, T, d) or "
                         "(C, N, T, d)")
    C, N, T, d = (1, *e.shape) if e.dim() == 3 else e.shape
    if (not 1 <= C <= CONTRASTIVE_MAX_C or not 1 <= N <= CONTRASTIVE_MAX_N
            or not 1 <= T <= CONTRASTIVE_MAX_T
            or not 1 <= d <= CONTRASTIVE_MAX_D):
        raise ValueError(f"contrastive loss kernel takes C in [1, "
                         f"{CONTRASTIVE_MAX_C}], N in [1, {CONTRASTIVE_MAX_N}] "
                         f"and T, d in [1, {CONTRASTIVE_MAX_T}]; got "
                         f"{(C, N, T, d)}")
    _expect("e", e, e.shape, torch.float32, e.device)
    _expect("g", g, e.shape, torch.float32, e.device)
    return C, N, T, d


def contrastive_loss_fwd(e, g):
    """The ``contrastive_loss_fwd`` kernel on CUDA tensors: (loss,
    correct), each (C,) f32 on the card, or 0-d for a (N, T, d) call."""
    C, N, T, d = _check_contrastive(e, g)
    out = torch.empty((2, C), dtype=torch.float32, device=e.device)
    _launch("contrastive_loss_fwd", "contrastive_loss_fwd", _ptr(e), _ptr(g),
            _ptr(out), C, N, T, d, _stream(e.device))
    if e.dim() == 3:
        return out[0, 0], out[1, 0]
    return out[0], out[1]


def contrastive_loss_bwd(e, g, dloss):
    """The ``contrastive_loss_bwd`` kernel on CUDA tensors: (de, dg) for the
    upstream scalar of each config, ``dloss`` (C,) (0-d or (1,) for a (N, T,
    d) call), read on the card."""
    C, N, T, d = _check_contrastive(e, g)
    dloss = dloss.reshape(-1) if dloss.dim() == 0 else dloss
    _expect("dloss", dloss, (C,), torch.float32, e.device)
    de, dg = torch.empty_like(e), torch.empty_like(g)
    _launch("contrastive_loss_bwd", "contrastive_loss_bwd", _ptr(e), _ptr(g),
            _ptr(dloss), _ptr(de), _ptr(dg), C, N, T, d, _stream(e.device))
    return de, dg


class _FusedContrastiveLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, e, g):
        loss, correct = contrastive_loss_fwd(e, g)
        ctx.save_for_backward(e, g)
        ctx.mark_non_differentiable(correct)
        return loss, correct

    @staticmethod
    def backward(ctx, dloss, _dcorrect):
        e, g = ctx.saved_tensors
        return contrastive_loss_bwd(e, g, dloss.contiguous())


def fused_contrastive_loss(e, g):
    """Fused symmetric contrastive loss of normalized ``e``, ``g`` (N, T,
    d), or (C, N, T, d) for C configs at once: ``(mean loss, correct
    rows)``, 0-d or (C,); divide ``correct`` by N*T for the train
    accuracy. On CUDA the K1 kernels run forward and backward
    (``correct`` takes no gradient); on the CPU the plain version runs
    under autograd."""
    if e.device.type == "cpu":
        return fused_contrastive_reference(e, g)
    return _FusedContrastiveLoss.apply(e, g)


# ----------------------------------------------------------- adam_stacked
ADAM_MAX_LEAVES = 64     # csrc/adam_stacked.cu's kMaxLeaves: a tower's table
ADAM_BLOCKS_PER_SM = 4   # its __launch_bounds__: blocks resident on an SM
# (parameter dtype, first moment dtype) -> the kernel's instance
ADAM_KINDS = {(torch.float32, torch.float32): 0,
              (torch.float32, torch.bfloat16): 1,
              (torch.float64, torch.float64): 2}


class AdamLeaf(NamedTuple):
    """One parameter of a stacked tower, as ``adam_stacked`` takes it:
    element (c, j) at ``p`` and ``g`` + (c n + j) elements, its moments at
    column ``off`` + j of row c; ``vec``: 16-byte runs of 4 elements."""

    p: int
    g: int
    n: int
    off: int
    vec: bool


def bf16_decay(mu: torch.Tensor, b1: float) -> torch.Tensor:
    """optax's ``b1 * mu`` for a bf16 ``mu``, as f32 values: jnp takes the
    Python float b1 as a weak-typed bf16 constant and rounds the product to
    bf16 (``tree_update_moment``)."""
    return (mu.float() * float(torch.tensor(b1, dtype=torch.bfloat16))
            ).to(torch.bfloat16).float()


@torch.no_grad()
def adam_stacked_reference(params, grads, state, lr, bc1: float, bc2: float,
                           b1: float = 0.9, b2: float = 0.999,
                           eps: float = 1e-8) -> None:
    """Plain version of ``adam_stacked``: one ``optax.scale_by_adam`` update
    (eps_root 0) and ``p -= lr * u`` of stacked parameters (C configs on the
    leading axis) in place, over the flat (C, N) moments ``state.flat`` of
    ``train/engine.py::stacked_adam_init`` (config c's moments of every
    parameter in row c), with a (C,) ``lr`` and the bias corrections
    ``bc1``, ``bc2`` taken in f32. A bf16 ``mu`` takes ``b1 mu`` in bf16
    and the sum in f32; the update is computed from that f32 moment, and
    only the stored ``mu`` is rounded to bf16. On CUDA, ``x / bc`` is a
    product with the reciprocal of the Python float ``bc``, taken in
    float64 and rounded to the tensor's dtype; on the CPU a division."""
    mu, nu = state.flat
    g = torch.cat([x.reshape(mu.shape[0], -1) for x in grads], 1)
    if mu.dtype == torch.bfloat16:
        m = bf16_decay(mu, b1) + g * (1 - b1)
        mu.copy_(m)
    else:
        m = mu.mul_(b1).add_(g * (1 - b1))
    nu.mul_(b2).add_(g * g * (1 - b2))
    update = (m / bc1).div_((nu / bc2).sqrt_().add_(eps)).mul_(
        lr.view(-1, 1))
    for p, u in zip(params, update.split([p[0].numel() for p in params], 1)):
        p.sub_(u.view(p.shape))


def adam_stacked_leaves(params, grads, state) -> list[AdamLeaf]:
    """The leaf table of :func:`adam_stacked`, read off ``state``: leaf i's
    moments start at the column of the flat (C, N) ``mu`` where
    ``state.mu[i]``, the view ``stacked_adam_init`` made of it, starts
    (``state.nu[i]`` must start at the same column of ``nu``); 16-byte runs
    where the f32 leaf's size, its column and N are multiples of 4 and
    every pointer is aligned (8 bytes for a bf16 ``mu``). Raises
    ``ValueError`` where the views are not rows of the flat moments that
    take every column once."""
    mu, nu = state.flat
    C, N = mu.shape
    if not len(params) == len(grads) == len(state.mu) == len(state.nu):
        raise ValueError(f"adam_stacked: {len(params)} parameters, "
                         f"{len(grads)} gradients, moments of "
                         f"{len(state.mu)}")
    aligned = (mu.data_ptr() % (8 if mu.dtype == torch.bfloat16 else 16) == 0
               and nu.data_ptr() % 16 == 0 and N % 4 == 0
               and nu.dtype == torch.float32)
    leaves = []
    for i, (p, g, vm, vn) in enumerate(zip(params, grads, state.mu,
                                           state.nu)):
        n = p[0].numel()
        off = (vm.data_ptr() - mu.data_ptr()) // mu.element_size()
        if not (vm.shape == vn.shape == p.shape and vm[0].is_contiguous()
                and vn[0].is_contiguous()
                and (C == 1 or vm.stride(0) == vn.stride(0) == N)
                and vn.data_ptr() - nu.data_ptr() == off * nu.element_size()
                and 0 <= off <= N - n):
            raise ValueError(f"adam_stacked: the moments of parameter {i} "
                             "are no columns of the flat moments' rows")
        vec = (aligned and n % 4 == 0 and off % 4 == 0
               and p.data_ptr() % 16 == 0 and g.data_ptr() % 16 == 0)
        leaves.append(AdamLeaf(p.data_ptr(), g.data_ptr(), n, off, vec))
    spans = sorted((x.off, x.n) for x in leaves)
    if (sum(n for _, n in spans) != N
            or any(a + n > b for (a, n), (b, _) in zip(spans, spans[1:]))):
        raise ValueError(f"adam_stacked: the parameters hold "
                         f"{sum(n for _, n in spans)} elements a config in "
                         f"the moments' rows of {N}, not each column once")
    return leaves


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@torch.no_grad()
def adam_stacked(params, grads, state, lr, bc1: float, bc2: float,
                 b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8) -> None:
    """The ``adam_stacked`` kernel (see :func:`adam_stacked_reference`): one
    launch a tower of up to ``ADAM_MAX_LEAVES`` parameters, reading each
    gradient where it lies (no ``torch.cat``) and each (C,) ``lr`` on the
    card; the leaf table goes in the launch's arguments. ``state`` is a
    stacked ``AdamState`` (``train/engine.py::stacked_adam_init``): the
    flat moments ``state.flat`` and a view of them a parameter. It takes
    f32 parameters with an f32 or bf16 ``mu``, and float64 ones with a
    float64 ``mu`` (``ADAM_KINDS``)."""
    params, grads = list(params), list(grads)
    if state.flat[0].device.type == "cpu":
        return adam_stacked_reference(params, grads, state, lr, bc1, bc2,
                                      b1, b2, eps)
    mu, nu = state.flat
    dev, (C, N) = mu.device, mu.shape
    dtype = params[0].dtype
    kind = ADAM_KINDS.get((dtype, mu.dtype))
    if kind is None:
        raise ValueError(f"adam_stacked kernel: parameters {dtype} with mu "
                         f"{mu.dtype}; takes {list(ADAM_KINDS)}")
    _expect("mu", mu, (C, N), mu.dtype, dev)
    _expect("nu", nu, (C, N), dtype, dev)
    _expect("lr", lr, (C,), dtype, dev)
    grads = [g.contiguous() for g in grads]  # copies a strided one only
    if len(grads) != len(params):
        raise ValueError(f"adam_stacked: {len(grads)} gradients for "
                         f"{len(params)} parameters")
    for i, (p, g) in enumerate(zip(params, grads)):
        if p.shape[0] != C:
            raise ValueError(f"parameter {i}: {p.shape[0]} configs, the "
                             f"moments {C}")
        _expect(f"parameter {i}", p, p.shape, dtype, dev)
        _expect(f"gradient {i}", g, p.shape, dtype, dev)
    grid = _sm_count(dev.index if dev.index is not None
                     else torch.cuda.current_device()) * ADAM_BLOCKS_PER_SM
    args = adam_stacked_args(params, grads, state, lr, bc1, bc2, b1, b2, eps,
                             grid)
    _launch("adam_stacked", "adam_stacked", *args, _stream(dev))
    if kind == 1:
        mode_counts["adam_stacked_bf16_mu"] += 1


def adam_stacked_args(params, grads, state, lr, bc1, bc2, b1, b2, eps,
                      grid) -> tuple:
    """The arguments of ``adam_stacked_launch`` but the stream, on checked
    tensors: the one launch of a tower. Raises ``ValueError`` above
    ``ADAM_MAX_LEAVES`` parameters."""
    leaves = adam_stacked_leaves(params, grads, state)
    k = len(leaves)
    if k > ADAM_MAX_LEAVES:
        raise ValueError(f"adam_stacked: {k} parameters in a tower, takes "
                         f"up to {ADAM_MAX_LEAVES}")
    mu, nu = state.flat
    kind = ADAM_KINDS[params[0].dtype, mu.dtype]
    b1_mu = float(torch.tensor(b1, dtype=torch.bfloat16)) if kind == 1 else b1
    C, N = mu.shape
    return ((ctypes.c_void_p * k)(*[x.p for x in leaves]),
            (ctypes.c_void_p * k)(*[x.g for x in leaves]),
            (ctypes.c_longlong * k)(*[x.off for x in leaves]),
            (ctypes.c_int * k)(*[x.n for x in leaves]),
            (ctypes.c_int * k)(*[int(x.vec) for x in leaves]), k,
            _ptr(mu), _ptr(nu), _ptr(lr), C, N, kind, b1_mu, 1 - b1, b2,
            1 - b2, bc1, bc2, eps, grid)
