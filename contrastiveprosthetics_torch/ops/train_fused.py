"""The fused training chain of EMGNet's dense stack (the JAX package's
``ops/train_fused.py``).

Per dense block i of L (``models/emg_net.py``)::

    y_i = h_i W_i + b_i;  r_i = relu(y_i);  z_i = BN_i(r_i)
    h_{i+1} = dropout(z_i) if i >= L - 4 else z_i

with h_0 the flattened, batch-normalized conv output and h_L the head's
input. On CUDA each block is one kernel forward and one backward
(``csrc/train_fused.cu``):

* ``dense_block_fwd`` (K5f): the previous block's BatchNorm affine and
  dropout applied to the input on load, GEMM + bias + ReLU, and the
  BatchNorm statistics of the output finished in the same launch;
* ``dense_block_bwd`` (K5b): the BatchNorm backward, dgrad, wgrad, db and
  the lower block's two BatchNorm-backward sums, one launch;
* ``chain_tail_fwd`` and ``chain_tail_bwd``: the top block's BatchNorm
  affine and dropout, h_L = dropout(a r + c), one launch; and in the
  backward dz = dropout^T(dh) with the top BatchNorm's two backward sums,
  one launch. Their consumer, the head GEMM, is outside the kernels;
* ``dropout_masks`` (K5m): one block's {0,1} dropout mask, a replay for
  ``mask_mode="input"``, the tests and the card checks. No kernel of the
  chain stores a mask: each draws its bits where it applies them.

The kernels' GEMMs run in 3xTF32 on the tensor cores with their own
rounding instructions, whatever ``torch.backends.cuda.matmul.allow_tf32``
says (``csrc/tf32_mma.cuh``); the plain versions use ``torch.matmul``.

A mask is a function of the step's two seed words, the dropped block's
index, the row and the column (Philox4x32-10, :func:`philox4x32_10`), so
the backward redraws the forward's bits and ``dropout_masks`` replays
them. ``mask_mode="input"`` feeds explicit masks through the same kernels
instead, for the tests.

The config axis (the crossval sweep's stacked step, the JAX package's
``jax.vmap`` of ``fused_emg_embed``): every kernel wrapper and plain
version also takes C configs at once, each array with a leading axis of C
(x (C, N, K), w (C, K, F), statistics (C, 5, F), seeds (C, 2), ``keep``
(C,), one rate a config), and launches once for all of them; config c's
outputs are bit-equal to a call on config c alone. The chain
(:func:`fused_dense_chain`) and :func:`fused_emg_embed` take a
``StackedEMGNet`` the same way.

Every wrapper has its plain PyTorch version beside it (``*_reference``).
Given CPU tensors a wrapper runs the plain version; given CUDA tensors it
launches its kernel or raises. Launches count in
``ops.kernels.launch_counts``. BatchNorm follows flax, as the JAX package
does: statistics ``max(0, E[r^2] - E[r]^2)`` over the rows, ``rsqrt(var +
eps)``, running averages with momentum 0.9 and the biased variance.
Gradients flow through the batch statistics inside the backward, and the
chain's (means, variances) outputs take none.

On a dp rank of the sharded step (:class:`DpRows`: the chain's rows are
the rank's part of a global batch) K5f ends with its raw column sums,
which are summed over dp and finished (:func:`finish_stats`, the JAX
package's XLA glue) between launches; K5b takes the global sums and row
count; every Philox counter takes the rank's global row
(``row_base``). Where dp has one rank none of this runs.

A bf16 chain (the JAX package's ``compute_dtype=bfloat16``, the dtype of
``x0``) stores x, r, dx and the tail's h and dz in bf16 and keeps the
statistics, the sums, dW and db in f32, rounding where the JAX kernels do
(``train_fused.py:203-236,266-324,593-601,624-638``): h = bf16(a x + c,
dropped) and dyc = bf16(dy) feed the GEMMs, whose products are exact and
sums f32; r is rounded before its statistics are taken; db, the lower
block's two sums and the top BatchNorm's are taken from the unrounded f32
dy, dh and dz. On CUDA these run the ``*_bf16`` kernels, counted under
their own names. The weights are cast to bf16 inside the chain, once per
step, so dW comes back in f32 unrounded, as JAX's custom VJP returns it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as nnf

from contrastiveprosthetics_torch.models.emg_net import whole_weight
from contrastiveprosthetics_torch.models.layers import (
    COMPUTE_DTYPES,
    at_least_f32,
    bf16_values,
    low_precision,
    low_product,
)
from contrastiveprosthetics_torch.models.stacked import (
    StackedEMGNet,
    StackedLinear,
)
from contrastiveprosthetics_torch.ops import kernels as K
from contrastiveprosthetics_torch.parallel.collectives import sum_flat

U32 = 0xFFFFFFFF
# the largest f32 below 1: keep * 2^32 then stays below 2^32 in f32
KEEP_CLIP = float(np.nextafter(np.float32(1.0), np.float32(0.0)))
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
# (rows, columns) of the kernels' output tiles per tiling, as
# csrc/train_fused.cu's FwdTile* and DgradTile* say: they size the column
# partial sums and the tickets. The chain runs tiling 0, the faster one
# measured on an H100 (PERF.md); tiling 1 is kept for tests and timing
FWD_TILES = ((16, 32), (16, 64))
DGRAD_TILES = ((32, 64), (32, 32))
FWD_TILING, BWD_TILING = 0, 0
MOMENTUM = 0.9  # flax's BatchNorm momentum (layers.update_running)
BF16 = torch.bfloat16


def keep_threshold(keep) -> torch.Tensor:
    """The integer threshold t on 32 random bits with P(bits <= t) ~ keep,
    exact at keep 1, so rate 0 keeps every element (``_keep_threshold``,
    ``train_fused.py:89-101``). Returns int64."""
    keep = torch.as_tensor(keep, dtype=torch.float32)
    t = (keep.clamp(0.0, KEEP_CLIP) * 4294967296.0).to(torch.int64)
    return torch.where(keep >= 1.0, U32, t)


# ------------------------------------------------------------------ Philox
def _mulhilo(m: int, c: torch.Tensor):
    """(hi, lo) 32-bit words of m * c for a 32-bit constant m and int64 c in
    [0, 2^32), with every partial product below 2^49."""
    p1 = c * (m & 0xFFFF)
    p2 = c * (m >> 16)
    low = ((p2 & 0xFFFF) << 16) + p1
    return (p2 >> 16) + (low >> 32), low & U32


def philox4x32_10(counter, key):
    """Plain Philox4x32-10 (Salmon et al. 2011, Random123's constants) on
    int64 tensors holding 32-bit words: ``counter`` four words, ``key`` two,
    broadcast together. Returns the four output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for rnd in range(10):
        if rnd:
            k0, k1 = (k0 + PHILOX_W[0]) & U32, (k1 + PHILOX_W[1]) & U32
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def mask_bits(seed: torch.Tensor, n_rows: int, width: int, block: int,
              row_base: int = 0) -> torch.Tensor:
    """(n_rows, width) int64: the 32 random bits of each element of block
    ``block``'s mask. Key = the two seed words, counter = (column // 4,
    row, block, 0); one Philox call covers four neighbouring columns. Row
    i is the global row ``row_base + i`` (a dp rank's rows of the batch).
    Seeds (C, 2) give (C, n_rows, width), config c's from its words."""
    dev = seed.device
    words = seed.to(torch.int64) & U32
    lead = words.shape[:-1]
    groups = -(-width // 4)
    c0 = torch.arange(groups, device=dev, dtype=torch.int64)[None, :]
    c1 = torch.arange(row_base, row_base + n_rows, device=dev,
                      dtype=torch.int64)[:, None]
    c2 = torch.full((1, 1), block, device=dev, dtype=torch.int64)
    out = philox4x32_10((c0, c1, c2, torch.zeros_like(c2)),
                        (words[..., 0, None, None], words[..., 1, None, None]))
    bits = torch.stack(torch.broadcast_tensors(*out), dim=-1)
    return bits.reshape(*lead, n_rows, 4 * groups)[..., :width]


def dropout_masks_reference(seed, keep, n_rows: int, width: int,
                            block: int, row_base: int = 0) -> torch.Tensor:
    """Plain version of ``dropout_masks``: block ``block``'s {0,1} f32 mask,
    (n_rows, width), of global rows ``row_base`` on; or each config's, (C,
    n_rows, width), for seeds (C, 2) and ``keep`` (C,)."""
    thr = keep_threshold(keep).to(seed.device).reshape(
        *seed.shape[:-1], 1, 1)
    return (mask_bits(seed, n_rows, width, block, row_base) <= thr).to(
        torch.float32)


def _check_row_base(row_base: int) -> None:
    if row_base < 0:
        raise ValueError(f"row_base {row_base}: a global row is >= 0")


def _count_modes(name: str, row_base: int = 0, sums_only: bool = False,
                 n_total=None) -> None:
    """Count a launch's dp-rank modes in ``kernels.mode_counts``."""
    if sums_only:
        K.mode_counts[name + "_sums"] += 1
    if row_base:
        K.mode_counts["row_base"] += 1
    if n_total is not None:
        K.mode_counts["n_total"] += 1


def dropout_masks(seed, keep, n_rows: int, width: int, block: int,
                  row_base: int = 0) -> torch.Tensor:
    """The ``dropout_masks`` kernel (K5m): block ``block``'s mask replayed,
    one Philox call and one 16-byte store per 4 columns (scalar stores
    where the width is not a multiple of 4). ``seed`` (2,) int32 and
    ``keep`` (1,) f32, both read on the device. Off the chain's path."""
    if seed.device.type == "cpu":
        return dropout_masks_reference(seed, keep, n_rows, width, block,
                                       row_base)
    dev = seed.device
    K._expect("seed", seed, (2,), torch.int32, dev)
    K._expect("keep", keep, (1,), torch.float32, dev)
    if n_rows < 1 or width < 1:
        raise ValueError(f"mask shape {(n_rows, width)} is empty")
    _check_row_base(row_base)
    out = torch.empty((n_rows, width), dtype=torch.float32, device=dev)
    K._launch("dropout_masks", "dropout_masks", K._ptr(seed), K._ptr(keep),
              K._ptr(out), n_rows, width, block, row_base, K._stream(dev))
    _count_modes("dropout_masks", row_base)
    return out


def philox_check(counters: torch.Tensor, keys: torch.Tensor):
    """The kernels' Philox4x32-10 and the CUDA toolkit's
    ``curand_Philox4x32_10`` on (n, 4) counters and (n, 2) keys (int32 bit
    patterns on a CUDA device): returns both (n, 4) outputs. A check of the
    generator only; it is on no path and counts no launch."""
    n = counters.shape[0]
    dev = counters.device
    K._expect("counters", counters, (n, 4), torch.int32, dev)
    K._expect("keys", keys, (n, 2), torch.int32, dev)
    ours, theirs = torch.empty_like(counters), torch.empty_like(counters)
    rc = K._fn("philox_check")(K._ptr(counters), K._ptr(keys), K._ptr(ours),
                               K._ptr(theirs), n, K._stream(dev))
    if rc != 0:
        raise RuntimeError(f"philox_check kernel launch failed: cudaError {rc}")
    return ours, theirs


# ------------------------------------------------------- one dense block
# The plain versions take one config's arrays, or C configs' with a leading
# axis; a (.., F) vector or a statistics row broadcasts over the rows as
# (1, F) or (C, 1, F).
def _col_sum(t: torch.Tensor) -> torch.Tensor:
    """Column sums over the rows taken in f64 and rounded once (to f32; a
    float64 input's stay float64): the CPU's sequential sum over thousands
    of rows would lose digits that XLA's pairwise sums and the kernels'
    per-tile sums keep."""
    return t.sum(-2, dtype=torch.float64).to(
        torch.promote_types(t.dtype, torch.float32))


def _stat(stats: torch.Tensor, i: int) -> torch.Tensor:
    """Row ``i`` of (.., 5, F) statistics as a row over the rows."""
    return stats[..., i:i + 1, :]


def _keep_rows(keep: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``keep`` (1,) or (C,) as a factor over x's (.., N, K)."""
    return keep if x.dim() == 2 else keep.view(-1, 1, 1)


def _kept(shape, seed, keep, mask, drop_block, row_base=0):
    """The kept elements of block ``drop_block``'s dropout: ``mask > 0``,
    or the bits drawn from ``seed`` for global rows ``row_base`` on; None
    without dropout."""
    if keep is None:
        return None
    if mask is None:
        mask = dropout_masks_reference(seed, keep, *shape[-2:], drop_block,
                                       row_base)
    return mask > 0


def _block_input(x, in_stats, seed, keep, mask, drop_block, row_base=0):
    """h = dropout(a x + c): the previous block's BatchNorm affine
    (``in_stats`` rows 3, 4) and dropout, as the kernels apply them on
    load. Returns h and the kept elements (None without dropout)."""
    z = x if in_stats is None else x * _stat(in_stats, 3) + _stat(in_stats, 4)
    kept = _kept(x.shape, seed, keep, mask, drop_block, row_base)
    if kept is None:
        return z, None
    return torch.where(kept, z / _keep_rows(keep, x), 0.0), kept


def dense_block_fwd_reference(x, w, b, gamma, beta, in_stats=None, *,
                              seed=None, keep=None, mask=None,
                              drop_block: int = -1, row_base: int = 0,
                              sums_only: bool = False, eps: float = 1e-5):
    """Plain version of ``dense_block_fwd`` (``_fwd_block_kernel`` then
    ``_finalize_stats``/``_affine``, ``train_fused.py:183-236,495-505``).

    ``x`` (N, K), ``w`` (K, F), ``b``/``gamma``/``beta`` (F,); ``in_stats``
    the previous block's (5, K) statistics, whose affine (rows 3, 4) is
    applied to ``x``; dropout on the input when ``keep`` is given, with
    ``mask`` or the bits of block ``drop_block`` drawn from ``seed`` for
    global rows ``row_base`` on. Returns r (N, F) and stats (5, F): mean,
    var, rstd, a, c. Or each of them with a leading axis of C configs.
    ``sums_only`` (a dp rank's rows): r and the raw column sums (2, F),
    (sum r, sum r^2), which :func:`finish_stats` finishes once they are
    summed over the ranks.

    bf16 ``x`` and ``w`` (``_fwd_block_kernel`` with ``cdtype`` bf16): h
    computed in f32 and rounded to bf16, f32 sums of the exact products,
    r rounded to bf16 after the ReLU and its statistics taken from the
    rounded values; r is returned in bf16, stats in f32."""
    low = x.dtype == BF16
    h, _ = _block_input(at_least_f32(x), in_stats, seed, keep, mask,
                        drop_block, row_base)
    if low:
        h, w = bf16_values(h), w.float()
    r = torch.relu(h @ w + b.unsqueeze(-2))
    if low:
        r = r.to(BF16)
    rf = at_least_f32(r)
    s1, s2 = _col_sum(rf), _col_sum(rf * rf)
    if sums_only:
        return r, torch.stack([s1, s2], -2)
    n = rf.new_tensor(float(r.shape[-2]))  # a tensor: exact division on CUDA
    mean = s1 / n
    var = torch.clamp(s2 / n - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + eps)
    a = gamma * rstd
    return r, torch.stack([mean, var, rstd, a, beta - mean * a], -2)


def finish_stats(sums, gamma, beta, n_total: int,
                 eps: float = 1e-5) -> torch.Tensor:
    """BatchNorm statistics (5, F) (mean, var, rstd, a, c) from the column
    sums (2, F) of ``n_total`` rows, op for op as K5f finishes them
    (``csrc/train_fused.cu``; the JAX package's XLA glue
    ``_finalize_stats``/``_affine``, ``train_fused.py:495-505``): each
    division a correctly rounded one, rstd = 1 / sqrt(var + eps) as
    ``__fdiv_rn(1, __fsqrt_rn(.))``. Plain PyTorch on either device: a dp
    rank finishes the sums of the global batch between K5f launches. C
    configs' (C, 2, F) sums give (C, 5, F)."""
    n = sums.new_tensor(float(n_total))  # tensors: exact division on CUDA
    mean = sums[..., 0, :] / n
    var = torch.clamp(sums[..., 1, :] / n - mean * mean, min=0.0)
    rstd = torch.ones_like(var) / torch.sqrt(var + eps)
    a = gamma * rstd
    return torch.stack([mean, var, rstd, a, beta - mean * a], -2)


def dense_block_bwd_reference(dz, r, x, w, stats, sums, in_stats=None, *,
                              seed=None, keep=None, mask=None,
                              drop_block: int = -1, row_base: int = 0,
                              n_total: int | None = None):
    """Plain version of ``dense_block_bwd`` (``_bwd_block_kernel``,
    ``train_fused.py:239-324``), the BatchNorm backward written out, not
    autograd.

    ``dz`` (N, F) the gradient at this block's BatchNorm output, ``r`` its
    ReLU output, ``x`` its input, ``stats`` its (5, F) statistics, ``sums``
    (2, F) = (sum dz, sum dz xhat) over ``n_total`` rows (None: the N
    given; a dp rank's: the global batch's); the rest as in
    :func:`dense_block_fwd_reference`. Returns dx (N, K), dW (K, F, laid
    out as ``w``), db (F,) and, with ``in_stats``, the lower block's (2, K)
    sums (sum dx, sum dx xhat_in), else None.

    bf16 ``dz``, ``r``, ``x`` and ``w`` (``_bwd_block_kernel`` with
    ``cdtype`` bf16): dy in f32 from their f32 values; both GEMMs read
    dyc = bf16(dy) and h = bf16(dropout(a x + c)) with f32 sums; db sums
    the unrounded dy, dW stays f32 and unrounded, dh's dropout is applied
    in f32 and the lower block's sums are taken from that f32 dh, which is
    returned rounded to bf16 as dx."""
    low = dz.dtype == BF16
    mean, rstd, a = (_stat(stats, i) for i in (0, 2, 3))
    inv_n = 1.0 / stats.new_tensor(float(n_total or dz.shape[-2]))
    rf, xf = at_least_f32(r), at_least_f32(x)
    xn = (rf - mean) * rstd
    t = (at_least_f32(dz) - _stat(sums, 0) * inv_n
         - xn * (_stat(sums, 1) * inv_n))
    dy = torch.where(rf > 0, a * t, 0.0)
    h, kept = _block_input(xf, in_stats, seed, keep, mask, drop_block,
                           row_base)
    dyc = dy
    if low:
        dyc, h, w = bf16_values(dy), bf16_values(h), w.float()
    dx = dyc @ w.transpose(-1, -2)
    if kept is not None:
        dx = torch.where(kept, dx / _keep_rows(keep, dx), 0.0)
    dw = torch.empty_like(w, dtype=dy.dtype).copy_(h.transpose(-1, -2) @ dyc)
    out_sums = None
    if in_stats is not None:
        xn_in = (xf - _stat(in_stats, 0)) * _stat(in_stats, 2)
        out_sums = torch.stack([_col_sum(dx), _col_sum(dx * xn_in)], -2)
    return dx.to(dz.dtype) if low else dx, dw, _col_sum(dy), out_sums


def _check_weight(w, shape, dtype, dev):
    """``w`` (K, F), or (C, K, F) with configs K * F elements apart: each
    config's row-major or the transpose of a row-major tensor (a Linear
    weight's ``.T``, a ``StackedLinear`` weight's ``.transpose(1, 2)``);
    returns the element strides within a config."""
    if tuple(w.shape) != tuple(shape) or w.dtype != dtype or w.device != dev:
        K._expect("w", w, shape, dtype, dev)
    Kw, F = shape[-2:]
    sk, sn = w.stride()[-2:]
    if (sk, sn) not in ((F, 1), (1, Kw)) or (w.dim() == 3 and w.shape[0] > 1
                                             and w.stride(0) != Kw * F):
        raise ValueError("w: neither contiguous nor a contiguous transpose")
    return sk, sn


def _configs(x: torch.Tensor, name: str) -> tuple:
    """The leading config axis of ``x``: () for one config's (N, K), (C,)
    for C configs' (C, N, K)."""
    if x.dim() not in (2, 3):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, want (N, K) or "
                         "(C, N, K)")
    return tuple(x.shape[:-2])


def _kernel_dtype(t: torch.Tensor) -> torch.dtype:
    """The element type of the chain's activations that a kernel takes:
    f32, or bf16 for the ``*_bf16`` variants."""
    if t.dtype not in COMPUTE_DTYPES:
        raise ValueError(f"dtype {t.dtype}: the kernels take "
                         f"{COMPUTE_DTYPES}")
    return t.dtype


def _variant(name: str, dtype: torch.dtype) -> str:
    return name + "_bf16" if dtype == BF16 else name


def _check_tiled(K_in: int, F: int, tiling: int, *tensors,
                 dtype: torch.dtype = torch.float32) -> None:
    """What the kernels' 16-byte copies need: widths that are multiples of
    4 (8 in bf16) and 16-byte aligned arrays; and a tiling they have."""
    if tiling not in range(len(FWD_TILES)):
        raise ValueError(f"tiling {tiling}: the kernels have "
                         f"0 .. {len(FWD_TILES) - 1}")
    unit = 8 if dtype == BF16 else 4
    if K_in % unit or F % unit:
        raise ValueError(f"widths {K_in} -> {F}: the {dtype} kernels take "
                         f"multiples of {unit}")
    for t in tensors:
        if t is not None and t.data_ptr() % 16:
            raise ValueError("an input is not 16-byte aligned")


def _check_dropout(seed, keep, mask, shape, dev, lead=()):
    """One config's seed (2,) and keep (1,), or C configs' (C, 2) and
    (C,); the mask (.., N, K) as the input."""
    if keep is None:
        if seed is not None or mask is not None:
            raise ValueError("seed or mask given without keep")
        return
    K._expect("keep", keep, lead or (1,), torch.float32, dev)
    if mask is not None:
        K._expect("mask", mask, (*lead, *shape), torch.float32, dev)
    elif seed is None:
        raise ValueError("dropout needs a seed or a mask")
    else:
        K._expect("seed", seed, (*lead, 2), torch.int32, dev)


_tickets: dict = {}


def _zeroed_tickets(dev: torch.device, n: int) -> torch.Tensor:
    """One zeroed int32 counter per column strip of each config. The
    kernels reset each counter they use, so one buffer serves every launch
    on the stream."""
    t = _tickets.get(dev)
    if t is None or t.numel() < n:
        t = _tickets[dev] = torch.zeros(max(n, 64), dtype=torch.int32,
                                        device=dev)
    return t


def dense_block_fwd(x, w, b, gamma, beta, in_stats=None, *, seed=None,
                    keep=None, mask=None, drop_block: int = -1,
                    row_base: int = 0, sums_only: bool = False,
                    eps: float = 1e-5, tiling: int = FWD_TILING):
    """The ``dense_block_fwd`` kernel (K5f), or ``dense_block_fwd_bf16``
    for bf16 ``x`` and ``w``; see :func:`dense_block_fwd_reference`
    (``sums_only``: the kernel's sums-only end, (2, F) sums for the
    statistics). ``tiling`` picks one of the kernel's two tilings (for
    tests and timing); both give the same r. C configs' arrays (a leading
    axis) run in one launch."""
    if x.device.type == "cpu":
        return dense_block_fwd_reference(
            x, w, b, gamma, beta, in_stats, seed=seed, keep=keep, mask=mask,
            drop_block=drop_block, row_base=row_base, sums_only=sums_only,
            eps=eps)
    dev = x.device
    lead = _configs(x, "x")
    C = lead[0] if lead else 1
    N, Kw = x.shape[-2:]
    F = w.shape[-1]
    dtype = _kernel_dtype(x)
    K._expect("x", x, (*lead, N, Kw), dtype, dev)
    wsk, wsn = _check_weight(w, (*lead, Kw, F), dtype, dev)
    for name, t in (("b", b), ("gamma", gamma), ("beta", beta)):
        K._expect(name, t, (*lead, F), torch.float32, dev)
    if in_stats is not None:
        K._expect("in_stats", in_stats, (*lead, 5, Kw), torch.float32, dev)
    _check_dropout(seed, keep, mask, (N, Kw), dev, lead)
    _check_tiled(Kw, F, tiling, x, w, b, in_stats, mask, dtype=dtype)
    _check_row_base(row_base)
    r = torch.empty((*lead, N, F), dtype=dtype, device=dev)
    stats = torch.empty((*lead, 2 if sums_only else 5, F),
                        dtype=torch.float32, device=dev)
    bm, bn = FWD_TILES[tiling]
    partial = torch.empty((C, -(-N // bm), 2, F), dtype=torch.float32,
                          device=dev)
    tickets = _zeroed_tickets(dev, C * -(-F // bn))
    name = _variant("dense_block_fwd", dtype)
    K._launch(name, name, K._ptr(x), K._ptr(w),
              K._ptr(b), K._ptr(gamma), K._ptr(beta), K._ptr(in_stats),
              K._ptr(seed), K._ptr(keep), K._ptr(mask), K._ptr(r),
              K._ptr(partial), K._ptr(tickets), K._ptr(stats), C, N, Kw, F,
              wsk, wsn, drop_block, tiling, row_base, int(sums_only), eps,
              K._stream(dev))
    _count_modes(name, row_base, sums_only)
    return r, stats


def dense_block_bwd(dz, r, x, w, stats, sums, in_stats=None, *, seed=None,
                    keep=None, mask=None, drop_block: int = -1,
                    row_base: int = 0, n_total: int | None = None,
                    tiling: int = BWD_TILING):
    """The ``dense_block_bwd`` kernel (K5b), dgrad and wgrad tiles in one
    launch, or ``dense_block_bwd_bf16`` for bf16 ``dz``, ``r``, ``x`` and
    ``w`` (dW and db f32 either way); see
    :func:`dense_block_bwd_reference`. ``tiling`` as for
    :func:`dense_block_fwd`; C configs as there."""
    if dz.device.type == "cpu":
        return dense_block_bwd_reference(
            dz, r, x, w, stats, sums, in_stats, seed=seed, keep=keep,
            mask=mask, drop_block=drop_block, row_base=row_base,
            n_total=n_total)
    dev = dz.device
    lead = _configs(dz, "dz")
    if x.dim() != dz.dim():
        raise ValueError("dz and x must be (N, F) and (N, K), or (C, N, F) "
                         "and (C, N, K)")
    C = lead[0] if lead else 1
    N, F = dz.shape[-2:]
    Kw = x.shape[-1]
    dtype = _kernel_dtype(dz)
    K._expect("dz", dz, (*lead, N, F), dtype, dev)
    K._expect("r", r, (*lead, N, F), dtype, dev)
    K._expect("x", x, (*lead, N, Kw), dtype, dev)
    wsk, wsn = _check_weight(w, (*lead, Kw, F), dtype, dev)
    K._expect("stats", stats, (*lead, 5, F), torch.float32, dev)
    K._expect("sums", sums, (*lead, 2, F), torch.float32, dev)
    if in_stats is not None:
        K._expect("in_stats", in_stats, (*lead, 5, Kw), torch.float32, dev)
    _check_dropout(seed, keep, mask, (N, Kw), dev, lead)
    _check_tiled(Kw, F, tiling, dz, r, x, w, in_stats, mask, dtype=dtype)
    _check_row_base(row_base)
    if n_total is not None and n_total < N:
        raise ValueError(f"n_total {n_total}: fewer than the {N} rows given")
    dx = torch.empty((*lead, N, Kw), dtype=dtype, device=dev)
    dw = torch.empty_like(w, dtype=torch.float32)  # the strides of w
    db = torch.empty((*lead, F), dtype=torch.float32, device=dev)
    out_sums = partial = None
    if in_stats is not None:
        out_sums = torch.empty((*lead, 2, Kw), dtype=torch.float32,
                               device=dev)
        partial = torch.empty((C, -(-N // DGRAD_TILES[tiling][0]), 2, Kw),
                              dtype=torch.float32, device=dev)
    tickets = _zeroed_tickets(dev, C * -(-Kw // DGRAD_TILES[tiling][1]))
    name = _variant("dense_block_bwd", dtype)
    K._launch(name, name, K._ptr(dz), K._ptr(r),
              K._ptr(x), K._ptr(w), K._ptr(stats), K._ptr(sums),
              K._ptr(in_stats), K._ptr(seed), K._ptr(keep), K._ptr(mask),
              K._ptr(dx), K._ptr(dw), K._ptr(db), K._ptr(out_sums),
              K._ptr(partial), K._ptr(tickets), C, N, Kw, F, wsk, wsn,
              drop_block, tiling, row_base, n_total or 0, K._stream(dev))
    _count_modes(name, row_base, n_total=n_total)
    return dx, dw, db, out_sums


# ------------------------------------------------------- the chain's tail
def chain_tail_fwd_reference(x, stats, *, seed=None, keep=None, mask=None,
                             drop_block: int = -1, row_base: int = 0):
    """Plain version of ``chain_tail_fwd`` (the JAX chain's XLA tail,
    ``train_fused.py:593-600``): the top block's ReLU output ``x`` (N, F)
    through its BatchNorm affine (``stats`` rows 3, 4) and the dropout of
    block ``drop_block``'s output, ``h = where(kept, (a x + c) / keep,
    0)``, the bits drawn for global rows ``row_base`` on; bf16 ``x``
    gives h rounded once to bf16."""
    h = _block_input(at_least_f32(x), stats, seed, keep, mask, drop_block,
                     row_base)[0]
    return h.to(x.dtype)


def chain_tail_bwd_reference(dh, r, stats, *, seed=None, keep=None,
                             mask=None, drop_block: int = -1,
                             row_base: int = 0):
    """Plain version of ``chain_tail_bwd`` (``train_fused.py:624-633``):
    ``dz = where(kept, dh / keep, 0)`` with the forward's dropout, and the
    top BatchNorm's two backward sums ``(sum dz, sum dz xhat)``, xhat =
    (r - mean) rstd from ``stats`` rows 0 and 2. Returns dz (N, F) and
    sums (2, F). bf16 ``dh`` and ``r``: dz and the sums in f32 from their
    f32 values, then dz rounded once to bf16."""
    kept = _kept(dh.shape, seed, keep, mask, drop_block, row_base)
    g = at_least_f32(dh)
    dz = g if kept is None else torch.where(kept, g / _keep_rows(keep, g),
                                            0.0)
    xn = (at_least_f32(r) - _stat(stats, 0)) * _stat(stats, 2)
    return dz.to(dh.dtype), torch.stack([_col_sum(dz), _col_sum(dz * xn)],
                                        -2)


def _check_tail(stats, seed, keep, mask, **arrays):
    """What the tail kernels take: ``arrays`` (N, F), or (C, N, F), of one
    dtype (f32, or bf16 for the ``_bf16`` variants) with F % 4 == 0, (..,
    5, F) f32 statistics, 16-byte aligned arrays. Returns (C, N, F), C 1
    for one config's."""
    name, t = next(iter(arrays.items()))
    lead = _configs(t, name)
    N, F = t.shape[-2:]
    dev = t.device
    dtype = _kernel_dtype(t)
    for name, a in arrays.items():
        K._expect(name, a, (*lead, N, F), dtype, dev)
    K._expect("stats", stats, (*lead, 5, F), torch.float32, dev)
    _check_dropout(seed, keep, mask, (N, F), dev, lead)
    if F % 4:
        raise ValueError(f"width {F}: the tail kernels take multiples of 4")
    for a in (*arrays.values(), stats, mask):
        if a is not None and a.data_ptr() % 16:
            raise ValueError("an input is not 16-byte aligned")
    return (lead[0] if lead else 1), N, F


def chain_tail_fwd(x, stats, *, seed=None, keep=None, mask=None,
                   drop_block: int = -1, row_base: int = 0):
    """The ``chain_tail_fwd`` kernel (``chain_tail_fwd_bf16`` for a bf16
    ``x``): h in one pass, the mask drawn in registers and never stored;
    see :func:`chain_tail_fwd_reference`."""
    if x.device.type == "cpu":
        return chain_tail_fwd_reference(x, stats, seed=seed, keep=keep,
                                        mask=mask, drop_block=drop_block,
                                        row_base=row_base)
    C, N, F = _check_tail(stats, seed, keep, mask, x=x)
    _check_row_base(row_base)
    h = torch.empty_like(x)
    name = _variant("chain_tail_fwd", x.dtype)
    K._launch(name, name, K._ptr(x), K._ptr(stats),
              K._ptr(seed), K._ptr(keep), K._ptr(mask), K._ptr(h), C, N, F,
              drop_block, row_base, K._stream(x.device))
    _count_modes(name, row_base)
    return h


def chain_tail_bwd(dh, r, stats, *, seed=None, keep=None, mask=None,
                   drop_block: int = -1, row_base: int = 0):
    """The ``chain_tail_bwd`` kernel (``chain_tail_bwd_bf16`` for bf16
    ``dh`` and ``r``): dz and the two sums in one launch, the forward's
    bits redrawn, the sums taken in f64 in a fixed order and rounded once;
    see :func:`chain_tail_bwd_reference`."""
    if dh.device.type == "cpu":
        return chain_tail_bwd_reference(dh, r, stats, seed=seed, keep=keep,
                                        mask=mask, drop_block=drop_block,
                                        row_base=row_base)
    C, N, F = _check_tail(stats, seed, keep, mask, dh=dh, r=r)
    _check_row_base(row_base)
    dz = torch.empty_like(dh)
    sums = torch.empty((*dh.shape[:-2], 2, F), dtype=torch.float32,
                       device=dh.device)
    name = _variant("chain_tail_bwd", dh.dtype)
    K._launch(name, name, K._ptr(dh), K._ptr(r),
              K._ptr(stats), K._ptr(seed), K._ptr(keep), K._ptr(mask),
              K._ptr(dz), K._ptr(sums), C, N, F, drop_block, row_base,
              K._stream(dh.device))
    _count_modes(name, row_base)
    return dz, sums


# --------------------------------------------------------------- the chain
@dataclasses.dataclass(frozen=True)
class DpRows:
    """The chain's rows as one dp rank's part of a global batch (the JAX
    package's sharded step, where GSPMD computes every statistic of the
    global batch): ``group`` the dp process group, ``row_base`` the global
    row of the rank's first row, ``n_total`` the global batch's rows."""

    group: object
    row_base: int
    n_total: int


@dataclasses.dataclass(frozen=True)
class _Chain:
    n_linear: int
    dropout_from: int  # the first block whose output is dropped
    mask_mode: str     # "prng" | "input"
    eps: float
    dp: DpRows | None = None

    def dropout(self, block: int, seed, keep, masks) -> dict:
        """Keyword arguments of dropout on block ``block``'s input (the
        output of block - 1; block L's is the tail's), or none."""
        if block < 1 or block - 1 < self.dropout_from:
            return {}
        if self.mask_mode == "input":
            return dict(keep=keep, mask=masks[block - 1 - self.dropout_from])
        return dict(keep=keep, seed=seed, drop_block=block - 1,
                    row_base=0 if self.dp is None else self.dp.row_base)

    def block_fwd(self, x, w, b, gamma, beta, in_stats, drop: dict):
        """K5f on one block: one launch, or on a dp rank the sums-only
        launch, its (2, F) sums summed over dp and finished
        (:func:`finish_stats`) into the global batch's statistics."""
        if self.dp is None:
            return dense_block_fwd(x, w, b, gamma, beta, in_stats,
                                   eps=self.eps, **drop)
        r, sums = dense_block_fwd(x, w, b, gamma, beta, in_stats,
                                  sums_only=True, **drop)
        return r, finish_stats(self.summed(sums), gamma, beta,
                               self.dp.n_total, self.eps)

    def summed(self, sums: torch.Tensor) -> torch.Tensor:
        """Column sums over the rank's rows -> over the global batch."""
        return sums if self.dp is None else sum_flat([sums],
                                                     self.dp.group)[0]


class _FusedDenseChain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, chain, seed, keep, masks, x0, *params):
        L = chain.n_linear
        ws, bs, gammas, betas = (params[j * L:(j + 1) * L] for j in range(4))
        # the f32 weights cast to the chain's dtype once per step, here and
        # not by the caller: autograd would otherwise cast each dW returned
        # for a bf16 input to bf16 (a no-op in f32)
        ws = tuple(w.to(x0.dtype) for w in ws)
        rs, stats = [], []
        x, in_stats = x0, None
        for i in range(L):
            r, st = chain.block_fwd(x, ws[i], bs[i], gammas[i], betas[i],
                                    in_stats,
                                    chain.dropout(i, seed, keep, masks))
            rs.append(r)
            stats.append(st)
            x, in_stats = r, st
        h = chain_tail_fwd(x, in_stats, **chain.dropout(L, seed, keep, masks))
        means = torch.stack([s[..., 0, :] for s in stats], -2)
        variances = torch.stack([s[..., 1, :] for s in stats], -2)
        ctx.chain = chain
        ctx.save_for_backward(x0, seed, keep, *ws, *rs, *stats, *masks)
        ctx.mark_non_differentiable(means, variances)
        return h, means, variances

    @staticmethod
    def backward(ctx, dh, _dmeans, _dvariances):
        chain = ctx.chain
        L = chain.n_linear
        x0, seed, keep, *rest = ctx.saved_tensors
        ws, rs, stats = rest[:L], rest[L:2 * L], rest[2 * L:3 * L]
        masks = tuple(rest[3 * L:])
        # the last dropout and the top BatchNorm's two backward sums
        dz, sums = chain_tail_bwd(dh.contiguous(), rs[-1], stats[-1],
                                  **chain.dropout(L, seed, keep, masks))
        dws, dbs, dgammas, dbetas = ([None] * L for _ in range(4))
        n_total = None if chain.dp is None else chain.dp.n_total
        for i in range(L - 1, -1, -1):
            # a dp rank's sums are its rows': dgamma and dbeta, gradients,
            # are summed over dp with the others by the step; K5b's
            # BatchNorm backward takes the global batch's
            dbetas[i], dgammas[i] = sums[..., 0, :], sums[..., 1, :]
            dz, dws[i], dbs[i], sums = dense_block_bwd(
                dz, rs[i], x0 if i == 0 else rs[i - 1], ws[i], stats[i],
                chain.summed(sums), None if i == 0 else stats[i - 1],
                n_total=n_total, **chain.dropout(i, seed, keep, masks))
        return (None, None, None, None, dz, *dws, *dbs, *dgammas, *dbetas)


def fused_dense_chain(x0, ws, bs, gammas, betas, seeds, rate, *,
                      mask_mode: str = "prng", ext_masks=(),
                      eps: float = 1e-5, dp: DpRows | None = None):
    """The dense stack as fused kernels with their own backward
    (``fused_dense_chain``, ``train_fused.py:669-714``).

    ``x0`` (N, D0) in the compute dtype, f32 or bf16 (the bf16 chain; see
    the module docstring); ``ws`` (D_in, F) f32 per block (a Linear
    weight's ``.T`` is taken without a copy in f32, cast to bf16 inside the
    chain in bf16), ``bs``/``gammas``/``betas`` (F,) f32;
    ``seeds`` (2,) int32, the step's Philox key; ``rate`` the dropout
    rate. ``mask_mode="input"`` takes the masks from
    ``ext_masks`` instead, one (N, F) {0,1} f32 tensor per dropped block
    (the last is the final block's). Dropout acts on the last
    ``min(4, L)`` blocks' outputs.

    Returns ``(h_L, means (L, F), variances (L, F))``: h_L in the compute
    dtype, the statistics f32, for the running averages, taking no
    gradient.

    C configs at once: ``x0`` (C, N, D0), ``ws`` (C, D_in, F) (a
    ``StackedLinear`` weight's ``.transpose(1, 2)``), the vectors (C, F),
    ``seeds`` (C, 2), ``rate`` a (C,) f32 tensor, the masks (C, N, F);
    every kernel launches once for all of them, and the statistics come
    back (C, L, F). On the CPU a float64 chain runs too (the plain versions
    in float64, for checks against float64 evaluations).

    ``dp``: ``x0`` holds one dp rank's rows of a global batch. Each K5f
    launch then ends with its sums, which are summed over dp and finished
    between launches, so every block's statistics, the returned ones
    included, are the global batch's; the backward's BatchNorm sums are
    summed over dp before each K5b takes them, with the global row count;
    the masks are the global batch's rows ``row_base`` on (``ext_masks``
    the global batch's, sliced here). The gradients, ``dgamma`` and
    ``dbeta`` among them, are the rank's rows' share, for the caller to
    sum over dp as it sums the rest."""
    if x0.dtype != torch.float64 or x0.device.type != "cpu":
        _kernel_dtype(x0)
    if mask_mode not in ("prng", "input"):
        raise ValueError(f"mask_mode must be 'prng' or 'input', not "
                         f"{mask_mode!r}")
    if dp is not None and x0.dim() == 3:
        raise ValueError("a dp rank's rows take one config's chain")
    L = len(ws)
    chain = _Chain(L, max(0, L - 4), mask_mode, eps, dp)
    masks = tuple(ext_masks) if mask_mode == "input" else ()
    if mask_mode == "input":
        if len(masks) != L - chain.dropout_from:
            raise ValueError(f"{len(masks)} masks for "
                             f"{L - chain.dropout_from} dropped blocks")
        if dp is not None:
            rows = slice(dp.row_base, dp.row_base + x0.shape[-2])
            masks = tuple(m[rows] for m in masks)
        seeds = None
    elif seeds is None:
        raise ValueError("mask_mode='prng' needs the step's seed words")
    if x0.dim() == 3:  # one keep a config, in f32 as the eager tower's
        keep = (1.0 - rate.to(torch.float32)).contiguous()
    else:
        # a fill kernel, not a host-to-device copy: no sync
        keep = torch.full((1,), 1.0 - rate, dtype=torch.float32,
                          device=x0.device)
    return _FusedDenseChain.apply(chain, seeds, keep, masks, x0, *ws, *bs,
                                  *gammas, *betas)


def dense_chain_reference(x0, ws, bs, gammas, betas, masks, keep, *,
                          dropout_from: int,
                          compute_dtype: torch.dtype = torch.float32,
                          eps: float = 1e-5):
    """The chain in plain PyTorch with explicit {0,1} masks, differentiable
    by autograd (``dense_chain_reference``, ``train_fused.py:722-763``). In
    a bf16 ``compute_dtype`` each block's input and weight are rounded to
    bf16 before the f32 product, r is stored in bf16 and its statistics
    are taken from its f32 values, and h_L is returned in bf16, as JAX's
    oracle does; autograd then rounds the gradients where those casts
    stand."""
    low = compute_dtype == BF16
    L = len(ws)
    x, affine = x0, None
    means, variances = [], []
    mi = 0
    for i in range(L):
        z = at_least_f32(x)
        if affine is not None:
            z = z * affine[0] + affine[1]
        if i > 0 and i - 1 >= dropout_from:
            z = torch.where(masks[mi] > 0, z / keep, 0.0)
            mi += 1
        w = ws[i]
        if low:
            z, w = bf16_values(z), bf16_values(w)
        r = torch.relu(z @ w + bs[i])
        if low:
            r = r.to(BF16)
        rf = at_least_f32(r)
        mu = rf.mean(0)
        var = torch.clamp((rf * rf).mean(0) - mu * mu, min=0.0)
        a = gammas[i] * torch.rsqrt(var + eps)
        means.append(mu)
        variances.append(var)
        x, affine = r, (a, betas[i] - mu * a)
    z = at_least_f32(x) * affine[0] + affine[1]
    if L - 1 >= dropout_from:
        z = torch.where(masks[mi] > 0, z / keep, 0.0)
    return z.to(compute_dtype) if low else z, torch.stack(means), \
        torch.stack(variances)


# ---------------------------------------------- the whole EMG encoder
def _norm(module):
    """The BatchNorm of a BatchNorm or AdaBN, single or stacked."""
    return getattr(module, "bn", module)


def _conv_stack(emg_net, frames):
    """The conv stack in train mode with batch statistics, as the eager
    tower runs it: the flattened input of the first dense block, (rows,
    F*P) channel-major (c*P+p, the reference's flatten), and each
    BatchNorm's batch (mean, var). A ``StackedEMGNet`` takes (C, rows,
    P) frames, runs its channels-last convolutions and gives (C, rows,
    F*P) in the same channel-major order, so its first dense weight is
    used as it is."""
    stacked = isinstance(emg_net, StackedEMGNet)
    dtype = emg_net.dtype
    low = dtype != torch.float32
    conv = emg_net.conv_emg
    x = (frames.unsqueeze(-1) if stacked
         else frames.reshape(-1, 1, 1, emg_net.emg_dim))
    batch = []
    for c, bn in ((conv[0], conv[2]), (conv[3], conv[5])):
        # StackedConv rounds a bf16 tower's product itself
        x = torch.relu(low_precision(c, x, dtype) if low and not stacked
                       else c(x))
        bn = _norm(bn)
        mean, var = bn.batch_stats(x)
        x = bn.normalize(x, mean, var)
        batch.append((mean, var))
    if stacked:  # (C, rows, P, F) -> (C, rows, F*P)
        return x.transpose(2, 3).flatten(2), batch
    return x.flatten(1), batch


def fused_emg_embed(emg_net, frames, rate, seeds, *, mask_mode: str = "prng",
                    ext_masks=(), dp: DpRows | None = None):
    """EMGNet's train-mode forward with the fused dense chain
    (``fused_emg_embed``, ``train_fused.py:848-921``): the conv stack in
    plain PyTorch (cuDNN convolutions, as the JAX package leaves it to
    XLA), the chain, then the head as ``torch.matmul``. A bf16 tower
    (``emg_net.dtype``) runs the convolutions and the head through
    ``low_precision`` and its BatchNorms in bf16, as the eager tower does
    (JAX ``:874-888,902-903``), and the chain in bf16.

    A ``StackedEMGNet`` of C configs (the sweep; the JAX ``jax.vmap`` of
    this function) takes (C, rows, emg_dim) frames, ``rate`` (C,) and
    ``seeds`` (C, 2): its convolutions and head as its eager forward runs
    them, the chain at its config axis, one launch a kernel for all C.

    Under a mesh (the sharded step): ``frames`` are a dp rank's rows and
    ``dp`` says where they lie in the global batch (the chain's dp form;
    the conv stack's BatchNorms take the global statistics themselves).
    A tensor-parallel tower (``EMGNet.shard_dense``) runs the chain and
    the head on whole weights, each weight the mp rule shards gathered
    over mp (``whole_weight``), as GSPMD replicates the operands of a
    ``pallas_call``, which carries no partitioning rule: every mp rank of
    a dp group computes the same rows, and each weight's gradient comes
    back narrowed to the rank's block.

    Returns ``(embeddings (rows, d_e) f32, new running statistics)``: for a
    plain-BatchNorm model one (mean, var) pair per BatchNorm in forward
    order, moved toward the batch's with flax's momentum; None for
    AdaBN. Stacked: (C, rows, d_e) and (C, F) statistics."""
    dtype = emg_net.dtype
    low = dtype != torch.float32
    stacked = isinstance(emg_net, StackedEMGNet)
    x0, batch = _conv_stack(emg_net, frames)
    lins = [m for m in emg_net.linear
            if isinstance(m, (torch.nn.Linear, StackedLinear))]
    norms = [_norm(m) for m in emg_net.norms()]
    h, means, variances = fused_dense_chain(
        x0, [whole_weight(m).transpose(-1, -2) for m in lins],
        [m.bias for m in lins],
        [bn.weight for bn in norms[2:]], [bn.bias for bn in norms[2:]],
        seeds, rate, mask_mode=mask_mode, ext_masks=ext_masks,
        eps=norms[2].eps, dp=dp)
    head = emg_net.last[0]
    if stacked:
        e = at_least_f32(head(h))
    elif low:
        e = at_least_f32(low_product(h, whole_weight(head), head.bias, dtype,
                                     nnf.linear))
    else:
        e = h @ whole_weight(head).T
    if not norms[0].track_running_stats:
        return e, None
    batch += list(zip(means.unbind(-2), variances.unbind(-2)))
    with torch.no_grad():
        old = [t for bn in norms for t in (bn.running_mean, bn.running_var)]
        new = torch._foreach_mul(old, MOMENTUM)
        torch._foreach_add_(new, [t.detach() for mv in batch for t in mv],
                            alpha=1.0 - MOMENTUM)
    return e, list(zip(new[0::2], new[1::2]))
