"""PyTorch port: the fused chain's tail pair (``chain_tail_fwd``,
``chain_tail_bwd``) and the replay kernel ``dropout_masks`` from
``csrc/train_fused.cu``, run on the CPU through ``tests/cuda_emulation.py``
against their plain versions (``ops/train_fused.py``).

The tail's elementwise parts use round-to-nearest intrinsics in the plain
version's order, so h and dz are held bit for bit. The backward's column
sums are taken in float64 in a fixed order and rounded once, as the plain
``_col_sum`` does in its own order: they are held to one f32 ulp. Also
here: the chain on the CPU saves no mask in ``prng`` mode.
"""
from __future__ import annotations

import ctypes

import numpy as np
import pytest
import torch

import cuda_emulation
from contrastiveprosthetics_torch.ops import train_fused as TF

P, I = ctypes.c_void_p, ctypes.c_int


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if cuda_emulation.compiler() is None:
        pytest.skip("needs a host C++ compiler to emulate the kernels")
    lib = cuda_emulation.build("train_fused", tmp_path_factory.mktemp("emu"))
    lib.chain_tail_fwd_launch.argtypes = [P] * 6 + [I] * 5 + [P]
    lib.chain_tail_bwd_launch.argtypes = [P] * 8 + [I] * 5 + [P]
    lib.dropout_masks_launch.argtypes = [P] * 3 + [I] * 4 + [P]
    return lib


def _ptr(t):
    return P(t.data_ptr() if t is not None else None)


def _case(N, F, seed):
    """The top block's ReLU output, its (5, F) statistics, the gradient
    arriving from the head and two seed words."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    r = t(np.maximum(rng.standard_normal((N, F)), 0.0))
    mean, var = t(rng.uniform(0.2, 0.6, F)), t(rng.uniform(0.2, 0.5, F))
    rstd = torch.rsqrt(var + 1e-5)
    a = t(rng.uniform(0.8, 1.2, F)) * rstd
    stats = torch.stack([mean, var, rstd, a,
                         t(rng.normal(0, 0.1, F)) - mean * a])
    dh = t(rng.standard_normal((N, F)) * 0.01)
    seed_words = torch.tensor([int(v) for v in rng.integers(-2**31, 2**31, 2)],
                              dtype=torch.int32)
    return r, stats, dh, seed_words


def _fwd(lib, x, stats, drop):
    """The tail forward through the emulation; C configs' (C, N, F)
    arrays as one launch."""
    C = x.shape[0] if x.dim() == 3 else 1
    N, F = x.shape[-2:]
    h = torch.full(x.shape, float("nan"))
    rc = lib.chain_tail_fwd_launch(
        _ptr(x), _ptr(stats), _ptr(drop.get("seed")), _ptr(drop.get("keep")),
        _ptr(drop.get("mask")), _ptr(h), C, N, F, drop.get("drop_block", -1),
        drop.get("row_base", 0), None)
    assert rc == 0
    return h


def _bwd(lib, dh, r, stats, drop):
    C = dh.shape[0] if dh.dim() == 3 else 1
    N, F = dh.shape[-2:]
    dz = torch.full(dh.shape, float("nan"))
    sums = torch.full((*dh.shape[:-2], 2, F), float("nan"))
    rc = lib.chain_tail_bwd_launch(
        _ptr(dh), _ptr(r), _ptr(stats), _ptr(drop.get("seed")),
        _ptr(drop.get("keep")), _ptr(drop.get("mask")), _ptr(dz), _ptr(sums),
        C, N, F, drop.get("drop_block", -1), drop.get("row_base", 0), None)
    assert rc == 0
    return dz, sums


def _masks(lib, seed, keep, N, F, block, row_base=0):
    out = torch.full((N, F), float("nan"))
    assert lib.dropout_masks_launch(_ptr(seed), _ptr(keep), _ptr(out), N, F,
                                    block, row_base, None) == 0
    return out


def assert_within_one_ulp(got, want):
    """Each element within one f32 unit in the last place of ``want``."""
    ulp = torch.nextafter(want.abs(), torch.tensor(float("inf"))) - want.abs()
    assert bool(((got - want).abs() <= ulp).all()), (got - want).abs().max()


@pytest.mark.parametrize("form", ["drawn", "mask"])
@pytest.mark.parametrize("keep", [0.5, 1.0])
@pytest.mark.parametrize("F", [512, 36])
@pytest.mark.parametrize("N", [328, 123, 5])
def test_emulated_tail_matches_plain(lib, N, F, keep, form):
    """Both tail kernels against their plain versions at the train step's
    328 rows, the ragged tail batch's 123 and 5, the chain's width and a
    narrow ragged one, rate 0.5 and 0, masks drawn in the kernel or given:
    h and dz bit for bit, the sums within one f32 ulp; the drawn bits are
    ``dropout_masks_reference``'s replay of block L-1 (here 6)."""
    r, stats, dh, seed = _case(N, F, N + F)
    kt = torch.full((1,), keep)
    replay = TF.dropout_masks_reference(seed, kt, N, F, 6)
    drop = (dict(seed=seed, keep=kt, drop_block=6) if form == "drawn" else
            dict(keep=kt, mask=replay))
    h = _fwd(lib, r, stats, drop)
    assert torch.equal(h, TF.chain_tail_fwd_reference(r, stats, **drop))
    dz, sums = _bwd(lib, dh, r, stats, drop)
    dz_p, sums_p = TF.chain_tail_bwd_reference(dh, r, stats, **drop)
    assert torch.equal(dz, dz_p)
    assert_within_one_ulp(sums, sums_p)
    # the kept elements are the replay's, forward and backward
    assert torch.equal(h != 0, (replay > 0) & (r * stats[3] + stats[4] != 0))
    assert torch.equal(dz != 0, (replay > 0) & (dh != 0))
    if keep == 1.0:
        assert bool((replay == 1).all())


def test_emulated_tail_reruns_and_replayed_masks_give_the_same_bits(lib):
    """A rerun gives the same bits, and the mask replayed by the
    ``dropout_masks`` kernel fed back in gives those of the drawn one."""
    N, F = 41, 512
    r, stats, dh, seed = _case(N, F, 4)
    keep = torch.full((1,), 0.5)
    drawn = dict(seed=seed, keep=keep, drop_block=6)
    fed = dict(keep=keep, mask=_masks(lib, seed, keep, N, F, 6))
    h = _fwd(lib, r, stats, drawn)
    dz, sums = _bwd(lib, dh, r, stats, drawn)
    for drop in (drawn, fed):
        assert torch.equal(_fwd(lib, r, stats, drop), h)
        dz2, sums2 = _bwd(lib, dh, r, stats, drop)
        assert torch.equal(dz2, dz) and torch.equal(sums2, sums)


def test_emulated_tail_without_dropout_is_the_affine(lib):
    """With no dropout (keep null) the forward is the BatchNorm affine and
    the backward passes dh through."""
    r, stats, dh, _ = _case(40, 64, 5)
    h = _fwd(lib, r, stats, {})
    assert torch.equal(h, TF.chain_tail_fwd_reference(r, stats))
    dz, sums = _bwd(lib, dh, r, stats, {})
    dz_p, sums_p = TF.chain_tail_bwd_reference(dh, r, stats)
    assert torch.equal(dz, dh) and torch.equal(dz_p, dh)
    assert_within_one_ulp(sums, sums_p)


def test_emulated_tail_launchers_refuse_what_they_cannot_take(lib):
    """A width that is not a multiple of 4, a misaligned array or dropout
    with neither seed nor mask: the launchers return an error and write
    nothing."""
    r, stats, dh, seed = _case(8, 64, 6)
    keep = torch.full((1,), 0.5)
    h = torch.full((8, 64), float("nan"))
    odd = torch.empty(8 * 64 + 1)[1:].view(8, 64).copy_(r)

    def fwd(x, F, seed_, keep_):
        return lib.chain_tail_fwd_launch(_ptr(x), _ptr(stats), _ptr(seed_),
                                         _ptr(keep_), None, _ptr(h), 1, 8, F,
                                         6, 0, None)

    def bwd(x, F):
        return lib.chain_tail_bwd_launch(_ptr(dh), _ptr(x), _ptr(stats),
                                         _ptr(seed), _ptr(keep), None,
                                         _ptr(h), _ptr(stats), 1, 8, F, 6,
                                         0, None)

    assert fwd(r, 62, seed, keep) != 0
    assert fwd(odd, 64, seed, keep) != 0
    assert fwd(r, 64, None, keep) != 0
    assert bwd(r, 62) != 0 and bwd(odd, 64) != 0
    assert torch.isnan(h).all()
    assert fwd(r, 64, seed, keep) == 0 and not torch.isnan(h).any()


@pytest.mark.parametrize("N,F", [(5, 512), (123, 512), (7, 36), (9, 37),
                                 (4, 130), (3, 1), (2, 6)])
def test_emulated_dropout_masks_match_plain(lib, N, F):
    """``dropout_masks`` (16-byte stores where F % 4 == 0, scalar stores
    otherwise) equals its plain version bit for bit, ragged widths
    included, at rate 0.5 and 0."""
    seed = torch.tensor([123456789, -98765], dtype=torch.int32)
    for keep in (0.5, 1.0):
        kt = torch.full((1,), keep)
        got = _masks(lib, seed, kt, N, F, 3)
        assert torch.equal(got, TF.dropout_masks_reference(seed, kt, N, F, 3))


@pytest.mark.parametrize("mode", ["prng", "input"])
def test_cpu_chain_saves_no_mask_in_prng_mode(mode):
    """The chain keeps the step's inputs, weights, r and statistics for
    its backward; in ``prng`` mode no mask (the tail's bits are redrawn),
    in ``input`` mode only the masks it was given."""
    L, N, D0, F = 5, 24, 32, 16
    rng = np.random.default_rng(0)

    def leaf(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32) * 0.3).requires_grad_()

    x0 = leaf(N, D0)
    ws = [leaf(D0 if i == 0 else F, F) for i in range(L)]
    bs, gs, betas = ([leaf(F) for _ in range(L)] for _ in range(3))
    seed = torch.tensor([3, -4], dtype=torch.int32)
    keep = torch.tensor([0.6])
    masks = [TF.dropout_masks_reference(seed, keep, N, F, b)
             for b in range(1, L)]
    ext = masks if mode == "input" else ()
    h, _, _ = TF.fused_dense_chain(x0, ws, bs, gs, betas, seed, 0.4,
                                   mask_mode=mode, ext_masks=ext)
    saved = h.grad_fn.saved_tensors
    assert len(saved) == 3 + 3 * L + len(ext)
    n_masks = sum(1 for s in saved if s is not None and s.shape == (N, F)
                  and any(torch.equal(s, m) for m in masks))
    assert n_masks == len(ext)
    # the tail redraws the forward's bits: prng equals input fed the replay
    if mode == "prng":
        hi, _, _ = TF.fused_dense_chain(x0, ws, bs, gs, betas, None, 0.4,
                                        mask_mode="input", ext_masks=masks)
        assert torch.equal(h, hi)
        g = torch.autograd.grad((h * h).sum(), [x0, *ws])
        gi = torch.autograd.grad((hi * hi).sum(), [x0, *ws])
        assert all(torch.equal(a, b) for a, b in zip(g, gi))


def test_emulated_tail_config_axis_is_each_configs_launch(lib):
    """3 configs' tails in one launch each way (the grid's config
    dimension), each its own statistics, seed words and keep: h, dz and
    the sums of config c bit-equal to a launch on config c alone; h and
    dz bit-equal to the config-axis plain versions, the sums within one
    f32 ulp."""
    C, N, F = 3, 37, 36
    cases = [_case(N, F, 20 + c) for c in range(C)]
    r, stats, dh, seed = (torch.stack([c[j] for c in cases])
                          for j in range(4))
    keep = torch.tensor([0.5, 0.7, 1.0])
    drop = dict(seed=seed, keep=keep, drop_block=6)
    h = _fwd(lib, r, stats, drop)
    dz, sums = _bwd(lib, dh, r, stats, drop)
    for c in range(C):
        one = dict(seed=seed[c], keep=keep[c:c + 1], drop_block=6)
        assert torch.equal(h[c], _fwd(lib, r[c], stats[c], one))
        dz1, sums1 = _bwd(lib, dh[c], r[c], stats[c], one)
        assert torch.equal(dz[c], dz1) and torch.equal(sums[c], sums1)
    assert torch.equal(h, TF.chain_tail_fwd_reference(r, stats, **drop))
    dz_p, sums_p = TF.chain_tail_bwd_reference(dh, r, stats, **drop)
    assert torch.equal(dz, dz_p)
    assert_within_one_ulp(sums, sums_p)


@pytest.mark.parametrize("N,F,lo", [(123, 512, 41), (9, 36, 4)])
def test_emulated_tail_and_masks_at_a_row_base(lib, N, F, lo):
    """A dp rank's rows [lo, N) at row base lo: the tail's h and dz and
    ``dropout_masks`` bit-equal to those rows of the whole batch's
    launches and to their plain versions, the tail's sums within one f32
    ulp of the plain version's over the rank's rows."""
    r, stats, dh, seed = _case(N, F, N + lo)
    keep = torch.full((1,), 0.5)
    whole = dict(seed=seed, keep=keep, drop_block=6)
    part = dict(whole, row_base=lo)
    h_lo = _fwd(lib, r[lo:], stats, part)
    assert torch.equal(h_lo, _fwd(lib, r, stats, whole)[lo:])
    assert torch.equal(h_lo, TF.chain_tail_fwd_reference(r[lo:], stats,
                                                         **part))
    dz_lo, sums_lo = _bwd(lib, dh[lo:], r[lo:], stats, part)
    assert torch.equal(dz_lo, _bwd(lib, dh, r, stats, whole)[0][lo:])
    dz_p, sums_p = TF.chain_tail_bwd_reference(dh[lo:], r[lo:], stats,
                                               **part)
    assert torch.equal(dz_lo, dz_p)
    assert_within_one_ulp(sums_lo, sums_p)
    masks = _masks(lib, seed, keep, N - lo, F, 6, lo)
    assert torch.equal(masks, _masks(lib, seed, keep, N, F, 6)[lo:])
    assert torch.equal(masks, TF.dropout_masks_reference(seed, keep, N - lo,
                                                         F, 6, lo))
