"""PyTorch port: the K5 kernels' CUDA source (``csrc/train_fused.cu``) run
on the CPU through ``tests/cuda_emulation.py``, against their plain
versions (``ops/train_fused.py``).

The emulation runs the kernels' own indexing, cp.async ring, elementwise
passes, fragment layouts, epilogues and tickets; its MMA sums each output's
eight products in float64, so the outputs are held to the tolerances the
card holds the kernels to (``chip_smoke.py``), and the bit identities the
card shows (weight layouts, drawn against replayed masks, tilings) hold
here too. Small shapes, ragged in every dimension the kernels tile.
"""
from __future__ import annotations

import ctypes

import numpy as np
import pytest
import torch

import cuda_emulation
from contrastiveprosthetics_torch.ops import train_fused as TF

P, I, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if cuda_emulation.compiler() is None:
        pytest.skip("needs a host C++ compiler to emulate the kernels")
    lib = cuda_emulation.build("train_fused", tmp_path_factory.mktemp("emu"))
    lib.dense_block_fwd_launch.argtypes = [P] * 13 + [I] * 10 + [F32, P]
    lib.dense_block_bwd_launch.argtypes = [P] * 16 + [I] * 10 + [P]
    return lib


def _ptr(t):
    return P(t.data_ptr() if t is not None else None)


def _case(N, K, F, seed):
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    x = t(np.maximum(rng.standard_normal((N, K)), 0.0))
    mean, var = t(rng.uniform(0.2, 0.6, K)), t(rng.uniform(0.2, 0.5, K))
    rstd = torch.rsqrt(var + 1e-5)
    a = t(rng.uniform(0.8, 1.2, K)) * rstd
    in_stats = torch.stack([mean, var, rstd, a,
                            t(rng.normal(0, 0.1, K)) - mean * a])
    w = t(rng.uniform(-1, 1, (K, F)) / np.sqrt(K))
    vecs = [t(rng.normal(0, 0.1, F)), t(rng.uniform(0.8, 1.2, F)),
            t(rng.normal(0, 0.1, F))]
    dz = t(rng.standard_normal((N, F)) * 0.01)
    seed_words = torch.tensor([int(v) for v in rng.integers(-2**31, 2**31, 2)],
                              dtype=torch.int32)
    return x, w, vecs, in_stats, dz, seed_words


def _fwd(lib, x, w, b, gamma, beta, in_stats, drop, tiling,
         sums_only=False):
    """K5f through the emulation; ``drop`` the wrapper's dropout keywords
    (``row_base`` among them). The ticket counters must come back zeroed.
    C configs' arrays (a leading axis) run as one launch. ``sums_only``:
    the (2, F) sums in place of the statistics."""
    lead = x.shape[:-2]
    C = lead[0] if lead else 1
    N, K = x.shape[-2:]
    F = w.shape[-1]
    r = torch.full((*lead, N, F), float("nan"))
    stats = torch.full((*lead, 2 if sums_only else 5, F), float("nan"))
    bm, bn = TF.FWD_TILES[tiling]
    partial = torch.empty((C, -(-N // bm), 2, F))
    tickets = torch.zeros(C * -(-F // bn), dtype=torch.int32)
    rc = lib.dense_block_fwd_launch(
        _ptr(x), _ptr(w), _ptr(b), _ptr(gamma), _ptr(beta), _ptr(in_stats),
        _ptr(drop.get("seed")), _ptr(drop.get("keep")), _ptr(drop.get("mask")),
        _ptr(r), _ptr(partial), _ptr(tickets), _ptr(stats), C, N, K, F,
        *w.stride()[-2:], drop.get("drop_block", -1), tiling,
        drop.get("row_base", 0), int(sums_only), 1e-5, None)
    assert rc == 0 and not tickets.any()
    return r, stats


def _bwd(lib, dz, r, x, w, stats, sums, in_stats, drop, tiling,
         n_total=None):
    lead = dz.shape[:-2]
    C = lead[0] if lead else 1
    N, F = dz.shape[-2:]
    K = x.shape[-1]
    dx = torch.full((*lead, N, K), float("nan"))
    dw = torch.full_like(w, float("nan"))
    db = torch.full((*lead, F), float("nan"))
    out_sums = partial = None
    bm, bn = TF.DGRAD_TILES[tiling]
    if in_stats is not None:
        out_sums = torch.full((*lead, 2, K), float("nan"))
        partial = torch.empty((C, -(-N // bm), 2, K))
    tickets = torch.zeros(C * -(-K // bn), dtype=torch.int32)
    rc = lib.dense_block_bwd_launch(
        _ptr(dz), _ptr(r), _ptr(x), _ptr(w), _ptr(stats), _ptr(sums),
        _ptr(in_stats), _ptr(drop.get("seed")), _ptr(drop.get("keep")),
        _ptr(drop.get("mask")), _ptr(dx), _ptr(dw), _ptr(db), _ptr(out_sums),
        _ptr(partial), _ptr(tickets), C, N, K, F, *w.stride()[-2:],
        drop.get("drop_block", -1), tiling, drop.get("row_base", 0),
        n_total or 0, None)
    assert rc == 0 and not tickets.any()
    return dx, dw, db, out_sums


def _close(got, want, rtol, scale_atol=1e-5):
    atol = scale_atol * max(float(want.abs().max()), 1e-3)
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("N,K,F,form,tiling,linear", [
    (40, 64, 64, "dropout", 0, True),
    (40, 64, 64, "block0", 0, False),
    (17, 64, 32, "dropout", 1, False),
    (123, 128, 64, "affine", 0, True),
    (33, 36, 44, "dropout", 1, True),   # K and F ragged in every tile
    (70, 96, 96, "mask", 1, True),
])
def test_emulated_kernels_match_plain(lib, N, K, F, form, tiling, linear):
    """K5f and K5b against their plain versions, at the card's tolerances,
    in the chain's block forms (block 0; affine; affine + drawn or given
    dropout), both tilings and both weight layouts; dW comes back laid out
    as w."""
    x, w, (b, gamma, beta), in_stats, dz, seed = _case(N, K, F, N + K)
    if linear:  # a Linear weight's .T, as the chain passes it
        w = w.T.contiguous().T
    keep = torch.full((1,), 0.5)
    drop = {}
    if form == "dropout":
        drop = dict(seed=seed, keep=keep, drop_block=3)
    elif form == "mask":
        drop = dict(keep=keep, mask=TF.dropout_masks_reference(
            seed, keep, N, K, 3))
    ins = None if form == "block0" else in_stats
    r, stats = _fwd(lib, x, w, b, gamma, beta, ins, drop, tiling)
    r_p, stats_p = TF.dense_block_fwd_reference(x, w, b, gamma, beta, ins,
                                                **drop)
    _close(r, r_p, 1e-5)
    _close(stats, stats_p, 1e-4)
    sums = torch.stack([dz.sum(0), (dz * (r_p - stats_p[0])
                                    * stats_p[2]).sum(0)])
    got = _bwd(lib, dz, r_p, x, w, stats_p, sums, ins, drop, tiling)
    want = TF.dense_block_bwd_reference(dz, r_p, x, w, stats_p, sums, ins,
                                        **drop)
    for g, v in zip(got, want):
        if v is None:
            assert g is None
        else:
            _close(g, v, 1e-4)
    assert got[1].stride() == w.stride()


def test_emulated_bits_hold_across_layouts_masks_and_tilings(lib):
    """r, dx and dW have the same bits for either weight layout, for masks
    drawn in the kernels or replayed by the plain Philox and fed in, and
    for either tiling (the statistics, summed over other row tiles, are
    compared at one tiling)."""
    N, K, F = 50, 64, 128
    x, w, (b, gamma, beta), in_stats, dz, seed = _case(N, K, F, 1)
    keep = torch.full((1,), 0.5)
    drawn = dict(seed=seed, keep=keep, drop_block=2)
    replayed = dict(keep=keep, mask=TF.dropout_masks_reference(
        seed, keep, N, K, 2))
    wt = w.T.contiguous().T
    r, stats = _fwd(lib, x, w, b, gamma, beta, in_stats, drawn, 0)
    sums = torch.stack([dz.sum(0), dz.sum(0)])
    base = _bwd(lib, dz, r, x, w, stats, sums, in_stats, drawn, 0)
    for wv, drop, tiling in ((wt, drawn, 0), (w, replayed, 0),
                             (w, drawn, 1), (wt, replayed, 1)):
        r2, stats2 = _fwd(lib, x, wv, b, gamma, beta, in_stats, drop, tiling)
        assert torch.equal(r2, r)
        if tiling == 0:
            assert torch.equal(stats2, stats)
        got = _bwd(lib, dz, r, x, wv, stats, sums, in_stats, drop, tiling)
        assert torch.equal(got[0], base[0]) and torch.equal(got[1], base[1])
        if tiling == 0:
            assert all(torch.equal(g, v) for g, v in zip(got[2:], base[2:]))


def test_emulated_launchers_refuse_what_the_copies_cannot_take(lib):
    """Widths that are not multiples of 4, a misaligned array or a weight
    in neither layout: the launcher returns an error and launches
    nothing."""
    x, w, (b, gamma, beta), _, _, _ = _case(8, 64, 32, 2)
    r = torch.full((8, 32), float("nan"))
    stats = torch.empty(5, 32)
    partial = torch.empty(1, 2, 32)
    tickets = torch.zeros(4, dtype=torch.int32)
    odd = torch.empty(8 * 64 + 1)[1:].view(8, 64).copy_(x)

    def launch(xv, K, wsk, wsn):
        return lib.dense_block_fwd_launch(
            _ptr(xv), _ptr(w), _ptr(b), _ptr(gamma), _ptr(beta), None, None,
            None, None, _ptr(r), _ptr(partial), _ptr(tickets), _ptr(stats),
            1, 8, K, 32, wsk, wsn, -1, 0, 0, 0, 1e-5, None)

    assert launch(x, 62, 32, 1) != 0
    assert launch(odd, 64, 32, 1) != 0
    assert launch(x, 64, 2, 1) != 0
    assert torch.isnan(r).all()
    assert launch(x, 64, 32, 1) == 0 and not torch.isnan(r).any()


def _stacked_case(C, N, K, F, linear):
    """C configs' arrays of :func:`_case` (each config its own draw) with
    a leading axis, W (C, K, F) row-major or a ``StackedLinear`` weight's
    ``.transpose(1, 2)``; each config its own seed words and keep."""
    cases = [_case(N, K, F, 100 + c) for c in range(C)]
    x = torch.stack([c[0] for c in cases])
    w = torch.stack([c[1] for c in cases])
    if linear:
        w = w.transpose(1, 2).contiguous().transpose(1, 2)
    vecs = [torch.stack([c[2][j] for c in cases]) for j in range(3)]
    in_stats = torch.stack([c[3] for c in cases])
    dz = torch.stack([c[4] for c in cases])
    seed = torch.stack([c[5] for c in cases])
    keep = torch.linspace(0.5, 0.8, C)
    return x, w, vecs, in_stats, dz, seed, keep


@pytest.mark.parametrize("N,K,F,tiling,linear", [(17, 64, 32, 0, True),
                                                 (40, 36, 44, 1, False)])
def test_emulated_config_axis_is_each_configs_launch(lib, N, K, F, tiling,
                                                     linear):
    """3 configs in one launch (the grid's config dimension), each its own
    weights, statistics, seed words and keep: every output of config c
    bit-equal to a launch on config c alone, the tickets back at 0, and
    the whole against the config-axis plain versions at the card's
    tolerances."""
    C = 3
    x, w, (b, gamma, beta), in_stats, dz, seed, keep = _stacked_case(
        C, N, K, F, linear)
    drop = dict(seed=seed, keep=keep, drop_block=2)
    r, stats = _fwd(lib, x, w, b, gamma, beta, in_stats, drop, tiling)
    sums = torch.stack([dz.sum(1), dz.sum(1) * 0.5], 1)
    got = _bwd(lib, dz, r, x, w, stats, sums, in_stats, drop, tiling)
    for c in range(C):
        one = dict(seed=seed[c], keep=keep[c:c + 1], drop_block=2)
        r1, st1 = _fwd(lib, x[c], w[c], b[c], gamma[c], beta[c], in_stats[c],
                       one, tiling)
        assert torch.equal(r[c], r1) and torch.equal(stats[c], st1)
        want = _bwd(lib, dz[c], r[c], x[c], w[c], stats[c], sums[c],
                    in_stats[c], one, tiling)
        for g, v in zip(got, want, strict=True):
            assert torch.equal(g[c], v)
    r_p, stats_p = TF.dense_block_fwd_reference(x, w, b, gamma, beta,
                                                in_stats, **drop)
    _close(r, r_p, 1e-5)
    _close(stats, stats_p, 1e-4)
    want = TF.dense_block_bwd_reference(dz, r, x, w, stats, sums, in_stats,
                                        **drop)
    for g, v in zip(got, want, strict=True):
        _close(g, v, 1e-4)
    assert got[1].stride() == w.stride()


@pytest.mark.parametrize("N,K,F,tiling,lo", [(50, 64, 64, 0, 17),
                                             (33, 36, 44, 1, 16)])
def test_emulated_dp_rank_rows_are_the_whole_launch_rows(lib, N, K, F,
                                                         tiling, lo):
    """A dp rank's launches on rows [lo, N) of a batch, at row base lo:
    K5f's r (sums-only end) and K5b's dx (given the whole batch's sums and
    n_total N) bit-equal to those rows of the launches on the whole batch,
    the dropout drawn at the global rows; the sums-only end's r the
    one-shot r's bits, its sums and the rank's dW, db and lower sums at
    the plain versions' tolerances, the two ranks' dW, db and lower sums
    adding up to the whole batch's; ``finish_stats`` of the whole batch's
    sums the one-shot statistics (rtol 1e-6: the CPU's vectorised f32
    root may sit an ulp off the kernel's; the card holds them bit for
    bit); the tickets back at 0."""
    x, w, (b, gamma, beta), in_stats, dz, seed = _case(N, K, F, N + lo)
    keep = torch.full((1,), 0.5)
    whole = dict(seed=seed, keep=keep, drop_block=3)
    part = dict(whole, row_base=lo)
    r, stats = _fwd(lib, x, w, b, gamma, beta, in_stats, whole, tiling)
    r_all, sums_all = _fwd(lib, x, w, b, gamma, beta, in_stats, whole,
                           tiling, sums_only=True)
    assert torch.equal(r_all, r)
    _close(TF.finish_stats(sums_all, gamma, beta, N), stats, 1e-6, 1e-6)
    r_lo, sums_lo = _fwd(lib, x[lo:], w, b, gamma, beta, in_stats, part,
                         tiling, sums_only=True)
    assert torch.equal(r_lo, r[lo:])
    _, sums_p = TF.dense_block_fwd_reference(x[lo:], w, b, gamma, beta,
                                             in_stats, sums_only=True, **part)
    _close(sums_lo, sums_p, 1e-4)
    sums = torch.stack([dz.sum(0), (dz * (r - stats[0]) * stats[2]).sum(0)])
    full = _bwd(lib, dz, r, x, w, stats, sums, in_stats, whole, tiling)
    ranks = [_bwd(lib, dz[a:z], r[a:z], x[a:z], w, stats, sums, in_stats,
                  dict(whole, row_base=a), tiling, n_total=N)
             for a, z in ((0, lo), (lo, N))]
    assert torch.equal(ranks[1][0], full[0][lo:])
    want = TF.dense_block_bwd_reference(dz[lo:], r[lo:], x[lo:], w, stats,
                                        sums, in_stats, n_total=N, **part)
    for g, v in zip(ranks[1], want, strict=True):
        _close(g, v, 1e-4)
    for j in (1, 2, 3):
        _close(ranks[0][j] + ranks[1][j], full[j], 1e-4)
