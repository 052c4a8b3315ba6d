"""PyTorch port: the bf16 variants of the fused chain's kernels
(``dense_block_fwd_bf16``, ``dense_block_bwd_bf16``, ``chain_tail_fwd_bf16``
and ``chain_tail_bwd_bf16`` in ``csrc/train_fused.cu``) run on the CPU
through ``tests/cuda_emulation.py``, against their plain versions
(``ops/train_fused.py``, bf16 inputs).

The emulation runs the kernels' own copies of 8 bf16 values, raw tiles,
elementwise passes into the f32 tiles, bf16 fragments (rounded where they
are formed) and epilogues; its m16n8k16 MMA sums each output's sixteen
exact products in float64. The GEMM inputs h and dyc are the plain
version's bits, so what can differ is the f32 order of the sums: r and dx,
rounded to bf16 after them, are held within one bf16 ulp of the plain
version's; dW, db and the sums, f32, at the f32 kernels' tolerances
(rtol 1e-4, atol 1e-5 x max). The tail pair has no sums over K: h and dz
bit for bit, its two f64 sums within one f32 ulp. Bits hold across
tilings, weight layouts and reruns, as in f32. Small shapes, ragged rows
(N not a multiple of 16 or of a k-tile) included.
"""
from __future__ import annotations

import ctypes

import numpy as np
import pytest
import torch

import cuda_emulation
from contrastiveprosthetics_torch.ops import train_fused as TF

P, I, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
BF16 = torch.bfloat16


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if cuda_emulation.compiler() is None:
        pytest.skip("needs a host C++ compiler to emulate the kernels")
    lib = cuda_emulation.build("train_fused", tmp_path_factory.mktemp("emu"))
    lib.dense_block_fwd_bf16_launch.argtypes = [P] * 13 + [I] * 10 + [F32, P]
    lib.dense_block_bwd_bf16_launch.argtypes = [P] * 16 + [I] * 10 + [P]
    lib.chain_tail_fwd_bf16_launch.argtypes = [P] * 6 + [I] * 5 + [P]
    lib.chain_tail_bwd_bf16_launch.argtypes = [P] * 8 + [I] * 5 + [P]
    return lib


def _ptr(t):
    return P(t.data_ptr() if t is not None else None)


def _case(N, K, F, seed):
    """A block's bf16 input (a ReLU output), its bf16 weight, f32 vectors
    and the previous block's f32 statistics, a bf16 upstream gradient and
    two seed words."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    x = t(np.maximum(rng.standard_normal((N, K)), 0.0)).to(BF16)
    mean, var = t(rng.uniform(0.2, 0.6, K)), t(rng.uniform(0.2, 0.5, K))
    rstd = torch.rsqrt(var + 1e-5)
    a = t(rng.uniform(0.8, 1.2, K)) * rstd
    in_stats = torch.stack([mean, var, rstd, a,
                            t(rng.normal(0, 0.1, K)) - mean * a])
    w = t(rng.uniform(-1, 1, (K, F)) / np.sqrt(K)).to(BF16)
    vecs = [t(rng.normal(0, 0.1, F)), t(rng.uniform(0.8, 1.2, F)),
            t(rng.normal(0, 0.1, F))]
    dz = t(rng.standard_normal((N, F)) * 0.01).to(BF16)
    seed_words = torch.tensor([int(v) for v in rng.integers(-2**31, 2**31, 2)],
                              dtype=torch.int32)
    return x, w, vecs, in_stats, dz, seed_words


def _fwd(lib, x, w, b, gamma, beta, in_stats, drop, tiling,
         sums_only=False):
    """The bf16 K5f through the emulation; C configs' arrays (a leading
    axis) as one launch; ``sums_only``: the (2, F) sums in place of the
    statistics."""
    lead = x.shape[:-2]
    C = lead[0] if lead else 1
    N, K = x.shape[-2:]
    F = w.shape[-1]
    r = torch.full((*lead, N, F), float("nan"), dtype=BF16)
    stats = torch.full((*lead, 2 if sums_only else 5, F), float("nan"))
    bm, bn = TF.FWD_TILES[tiling]
    partial = torch.empty((C, -(-N // bm), 2, F))
    tickets = torch.zeros(C * -(-F // bn), dtype=torch.int32)
    rc = lib.dense_block_fwd_bf16_launch(
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
    dx = torch.full((*lead, N, K), float("nan"), dtype=BF16)
    dw = torch.full_like(w, float("nan"), dtype=torch.float32)
    db = torch.full((*lead, F), float("nan"))
    out_sums = partial = None
    bm, _ = TF.DGRAD_TILES[tiling]
    if in_stats is not None:
        out_sums = torch.full((*lead, 2, K), float("nan"))
        partial = torch.empty((C, -(-N // bm), 2, K))
    tickets = torch.zeros(C * -(-K // TF.DGRAD_TILES[tiling][1]),
                          dtype=torch.int32)
    rc = lib.dense_block_bwd_bf16_launch(
        _ptr(dz), _ptr(r), _ptr(x), _ptr(w), _ptr(stats), _ptr(sums),
        _ptr(in_stats), _ptr(drop.get("seed")), _ptr(drop.get("keep")),
        _ptr(drop.get("mask")), _ptr(dx), _ptr(dw), _ptr(db), _ptr(out_sums),
        _ptr(partial), _ptr(tickets), C, N, K, F, *w.stride()[-2:],
        drop.get("drop_block", -1), tiling, drop.get("row_base", 0),
        n_total or 0, None)
    assert rc == 0 and not tickets.any()
    return dx, dw, db, out_sums


def _close(got, want, rtol=1e-4, scale_atol=1e-5):
    atol = scale_atol * max(float(want.abs().max()), 1e-3)
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


def assert_within_one_bf16_ulp(got, want, share=0.05):
    """Each bf16 element within one bf16 ulp of ``want``'s (the larger
    magnitude's), and at most ``share`` of them apart at all."""
    g, w = got.float(), want.float()
    big = torch.maximum(g.abs(), w.abs())
    ulp = torch.exp2(torch.floor(torch.log2(torch.where(big > 0, big, 1.0)))
                     - 7)
    assert bool(((g - w).abs() <= ulp).all()), float(((g - w).abs()
                                                      / ulp).max())
    assert float((g != w).float().mean()) <= share


def _drop(form, seed, N, K):
    keep = torch.full((1,), 0.5)
    if form == "dropout":
        return dict(seed=seed, keep=keep, drop_block=3)
    if form == "mask":
        return dict(keep=keep, mask=TF.dropout_masks_reference(seed, keep, N,
                                                               K, 3))
    return {}


@pytest.mark.parametrize("N,K,F,form,tiling,linear", [
    (40, 64, 64, "dropout", 0, True),
    (40, 64, 64, "block0", 0, False),
    (17, 64, 32, "dropout", 1, False),
    (123, 128, 64, "affine", 0, True),   # the ragged tail batch's rows
    (33, 40, 56, "dropout", 1, True),    # K and F ragged in every tile
    (70, 96, 96, "mask", 1, True),
])
def test_emulated_bf16_kernels_match_plain(lib, N, K, F, form, tiling,
                                           linear):
    """The bf16 K5f and K5b against their plain versions in the chain's
    block forms, both tilings and both weight layouts: r and dx within one
    bf16 ulp, the statistics, dW, db and the lower block's sums at the f32
    tolerances; dW comes back f32, laid out as w."""
    x, w, (b, gamma, beta), in_stats, dz, seed = _case(N, K, F, N + K)
    if linear:  # a Linear weight's .T, cast to bf16 as the chain does
        w = w.T.contiguous().T
    drop = _drop(form, seed, N, K)
    ins = None if form == "block0" else in_stats
    r, stats = _fwd(lib, x, w, b, gamma, beta, ins, drop, tiling)
    r_p, stats_p = TF.dense_block_fwd_reference(x, w, b, gamma, beta, ins,
                                                **drop)
    assert r.dtype == r_p.dtype == BF16
    assert_within_one_bf16_ulp(r, r_p)
    _close(stats, stats_p, rtol=1e-3, scale_atol=1e-3)
    rf = r_p.float()
    sums = torch.stack([dz.float().sum(0),
                        (dz.float() * (rf - stats_p[0]) * stats_p[2]).sum(0)])
    got = _bwd(lib, dz, r_p, x, w, stats_p, sums, ins, drop, tiling)
    want = TF.dense_block_bwd_reference(dz, r_p, x, w, stats_p, sums, ins,
                                        **drop)
    assert_within_one_bf16_ulp(got[0], want[0])
    assert got[1].dtype == want[1].dtype == torch.float32
    assert got[1].stride() == w.stride()
    for g, v in zip(got[1:], want[1:]):
        if v is None:
            assert g is None
        else:
            _close(g, v)


def test_emulated_bf16_bits_hold_across_layouts_masks_tilings_and_reruns(lib):
    """r, dx and dW have the same bits for either weight layout, for masks
    drawn in the kernels or replayed and fed in, for either tiling (the
    statistics, db and the lower block's sums, summed over other row tiles
    and thread groups, at one tiling) and on a rerun."""
    N, K, F = 50, 64, 128
    x, w, (b, gamma, beta), in_stats, dz, seed = _case(N, K, F, 1)
    keep = torch.full((1,), 0.5)
    drawn = dict(seed=seed, keep=keep, drop_block=2)
    replayed = dict(keep=keep, mask=TF.dropout_masks_reference(
        seed, keep, N, K, 2))
    wt = w.T.contiguous().T
    r, stats = _fwd(lib, x, w, b, gamma, beta, in_stats, drawn, 0)
    sums = torch.stack([dz.float().sum(0), dz.float().sum(0)])
    base = _bwd(lib, dz, r, x, w, stats, sums, in_stats, drawn, 0)
    for wv, drop, tiling in ((w, drawn, 0), (wt, drawn, 0), (w, replayed, 0),
                             (w, drawn, 1), (wt, replayed, 1)):
        r2, stats2 = _fwd(lib, x, wv, b, gamma, beta, in_stats, drop, tiling)
        assert torch.equal(r2, r)
        if tiling == 0:
            assert torch.equal(stats2, stats)
        got = _bwd(lib, dz, r, x, wv, stats, sums, in_stats, drop, tiling)
        assert torch.equal(got[0], base[0]) and torch.equal(got[1], base[1])
        if tiling == 0:
            assert all(torch.equal(g, v) for g, v in zip(got[2:], base[2:]))


def test_emulated_bf16_db_and_sums_take_the_unrounded_gradients(lib):
    """db is the sum of the f32 dy, not of the dyc the GEMMs read; the
    lower block's sums are those of the f32 dh after its dropout, not of
    the stored bf16 dx; dW is f32 and not rounded to bf16. Each held
    against float64 sums of the unrounded values far tighter than the
    rounded ones would give."""
    N, K, F = 70, 64, 64
    x, w, (b, gamma, beta), in_stats, dz, seed = _case(N, K, F, 5)
    drop = dict(seed=seed, keep=torch.full((1,), 0.5), drop_block=3)
    r, stats = _fwd(lib, x, w, b, gamma, beta, in_stats, drop, 0)
    rf = r.float()
    sums = torch.stack([dz.float().sum(0),
                        (dz.float() * (rf - stats[0]) * stats[2]).sum(0)])
    dx, dw, db, out_sums = _bwd(lib, dz, r, x, w, stats, sums, in_stats,
                                drop, 0)
    xn = (rf - stats[0]) * stats[2]
    dy = torch.where(rf > 0, stats[3] * (dz.float() - sums[0] / N
                                         - xn * (sums[1] / N)), 0.0).double()
    exact = dy.sum(0)
    rounded = dy.to(BF16).double().sum(0)
    err = (db.double() - exact).abs().max()
    assert err < 1e-6 * exact.abs().max()
    assert (rounded - exact).abs().max() > 20 * err
    assert not torch.equal(dw, dw.to(BF16).float())
    kept = TF.dropout_masks_reference(seed, drop["keep"], N, K, 3) > 0
    h = torch.where(kept, x.float() * in_stats[3] + in_stats[4], 0.0) / 0.5
    dyc = dy.float().to(BF16).double()
    dh = torch.where(kept, (dyc @ w.double().T) / 0.5, 0.0)
    xn_in = (x.double() - in_stats[0].double()) * in_stats[2].double()
    s_exact = torch.stack([dh.sum(0), (dh * xn_in).sum(0)])
    s_rounded = torch.stack([dx.double().sum(0), (dx.double() * xn_in).sum(0)])
    err = (out_sums.double() - s_exact).abs().max()
    assert err < 1e-5 * s_exact.abs().max()
    assert (s_rounded - s_exact).abs().max() > 20 * err
    torch.testing.assert_close(
        dw.double(), h.to(BF16).double().T @ dyc, rtol=1e-5,
        atol=1e-6 * float(dw.abs().max()))


@pytest.mark.parametrize("form", ["drawn", "mask"])
@pytest.mark.parametrize("N,F", [(328, 512), (123, 512), (5, 36)])
def test_emulated_bf16_tail_matches_plain(lib, N, F, form):
    """The bf16 tail pair against its plain versions at the train step's
    328 rows, the ragged 123 and 5, rate 0.5: h and dz bit for bit (f32
    arithmetic, one rounding to bf16), the sums of the unrounded dz within
    one f32 ulp; the kept elements are the replay's."""
    rng = np.random.default_rng(N + F)
    r = torch.from_numpy(np.maximum(rng.standard_normal((N, F)), 0.0)
                         .astype(np.float32)).to(BF16)
    mean = torch.from_numpy(rng.uniform(0.2, 0.6, F).astype(np.float32))
    var = torch.from_numpy(rng.uniform(0.2, 0.5, F).astype(np.float32))
    rstd = torch.rsqrt(var + 1e-5)
    a = torch.from_numpy(rng.uniform(0.8, 1.2, F).astype(np.float32)) * rstd
    stats = torch.stack([mean, var, rstd, a, 0.1 - mean * a])
    dh = torch.from_numpy(rng.standard_normal((N, F)).astype(np.float32)
                          * 0.01).to(BF16)
    seed = torch.tensor([123, -456], dtype=torch.int32)
    keep = torch.full((1,), 0.5)
    replay = TF.dropout_masks_reference(seed, keep, N, F, 6)
    drop = (dict(seed=seed, keep=keep, drop_block=6) if form == "drawn" else
            dict(keep=keep, mask=replay))
    h = torch.full((N, F), float("nan"), dtype=BF16)
    assert lib.chain_tail_fwd_bf16_launch(
        _ptr(r), _ptr(stats), _ptr(drop.get("seed")), _ptr(keep),
        _ptr(drop.get("mask")), _ptr(h), 1, N, F, drop.get("drop_block", -1),
        0, None) == 0
    assert torch.equal(h, TF.chain_tail_fwd_reference(r, stats, **drop))
    dz = torch.full((N, F), float("nan"), dtype=BF16)
    sums = torch.full((2, F), float("nan"))
    assert lib.chain_tail_bwd_bf16_launch(
        _ptr(dh), _ptr(r), _ptr(stats), _ptr(drop.get("seed")), _ptr(keep),
        _ptr(drop.get("mask")), _ptr(dz), _ptr(sums), 1, N, F,
        drop.get("drop_block", -1), 0, None) == 0
    dz_p, sums_p = TF.chain_tail_bwd_reference(dh, r, stats, **drop)
    assert torch.equal(dz, dz_p)
    ulp = torch.nextafter(sums_p.abs(), torch.tensor(float("inf"))) \
        - sums_p.abs()
    assert bool(((sums - sums_p).abs() <= ulp).all())
    assert torch.equal(dz != 0, (replay > 0) & (dh != 0))


def test_emulated_bf16_launchers_refuse_widths_a_copy_cannot_take(lib):
    """K and F must be multiples of 8 (a copy's 8 bf16 values): 36 is
    refused and nothing is written; 40 runs."""
    x, w, (b, gamma, beta), _, _, _ = _case(8, 40, 32, 2)
    r = torch.full((8, 32), float("nan"), dtype=BF16)
    stats = torch.empty(5, 32)
    partial = torch.empty(1, 2, 32)
    tickets = torch.zeros(4, dtype=torch.int32)

    def launch(K):
        return lib.dense_block_fwd_bf16_launch(
            _ptr(x), _ptr(w), _ptr(b), _ptr(gamma), _ptr(beta), None, None,
            None, None, _ptr(r), _ptr(partial), _ptr(tickets), _ptr(stats),
            1, 8, K, 32, 32, 1, -1, 0, 0, 0, 1e-5, None)

    assert launch(36) != 0
    assert torch.isnan(r.float()).all()
    assert launch(40) == 0 and not torch.isnan(r.float()).any()


def test_emulated_bf16_config_axis_is_each_configs_launch(lib):
    """2 configs of the bf16 K5f, K5b and tail pair in one launch each
    (the grid's config dimension), each its own operands, seed words and
    keep: every output of config c bit-equal to a launch on config c
    alone."""
    C, N, Kw, F = 2, 33, 40, 48
    cases = [_case(N, Kw, F, 200 + c) for c in range(C)]
    x, w, in_stats, dz, seed = (torch.stack([c[j] for c in cases])
                                for j in (0, 1, 3, 4, 5))
    b, gamma, beta = (torch.stack([c[2][j] for c in cases])
                      for j in range(3))
    keep = torch.tensor([0.5, 0.75])
    drop = dict(seed=seed, keep=keep, drop_block=1)
    r, stats = _fwd(lib, x, w, b, gamma, beta, in_stats, drop, 0)
    sums = torch.stack([dz.float().sum(1), dz.float().sum(1) * 0.5], 1)
    got = _bwd(lib, dz, r, x, w, stats, sums, in_stats, drop, 0)
    h = torch.full(r.shape, float("nan"), dtype=BF16)
    tdz = torch.full(r.shape, float("nan"), dtype=BF16)
    tsums = torch.full((C, 2, F), float("nan"))
    tdrop = dict(seed=seed, keep=keep, drop_block=6)
    assert lib.chain_tail_fwd_bf16_launch(
        _ptr(r), _ptr(stats), _ptr(seed), _ptr(keep), None, _ptr(h), C, N, F,
        6, 0, None) == 0
    assert lib.chain_tail_bwd_bf16_launch(
        _ptr(r), _ptr(r), _ptr(stats), _ptr(seed), _ptr(keep), None,
        _ptr(tdz), _ptr(tsums), C, N, F, 6, 0, None) == 0
    assert torch.equal(h, TF.chain_tail_fwd_reference(r, stats, **tdrop))
    for c in range(C):
        one = dict(seed=seed[c], keep=keep[c:c + 1], drop_block=1)
        r1, st1 = _fwd(lib, x[c], w[c], b[c], gamma[c], beta[c], in_stats[c],
                       one, 0)
        assert torch.equal(r[c], r1) and torch.equal(stats[c], st1)
        want = _bwd(lib, dz[c], r[c], x[c], w[c], stats[c], sums[c],
                    in_stats[c], one, 0)
        for g, v in zip(got, want, strict=True):
            assert torch.equal(g[c], v)
        h1 = torch.full((N, F), float("nan"), dtype=BF16)
        dz1 = torch.full((N, F), float("nan"), dtype=BF16)
        s1 = torch.full((2, F), float("nan"))
        assert lib.chain_tail_fwd_bf16_launch(
            _ptr(r[c]), _ptr(stats[c]), _ptr(seed[c]), _ptr(keep[c:c + 1]),
            None, _ptr(h1), 1, N, F, 6, 0, None) == 0
        assert lib.chain_tail_bwd_bf16_launch(
            _ptr(r[c]), _ptr(r[c]), _ptr(stats[c]), _ptr(seed[c]),
            _ptr(keep[c:c + 1]), None, _ptr(dz1), _ptr(s1), 1, N, F, 6, 0,
            None) == 0
        assert torch.equal(h[c], h1) and torch.equal(tdz[c], dz1)
        assert torch.equal(tsums[c], s1)


def test_emulated_bf16_dp_rank_rows_are_the_whole_launch_rows(lib):
    """The bf16 K5f and K5b on a dp rank's rows [lo, N) at row base lo:
    r (sums-only end) and dx (the whole batch's sums, n_total N)
    bit-equal to those rows of the whole batch's launches; the sums-only
    end's r the one-shot r's bits and its sums, from the rounded r, at the
    plain version's statistics tolerance; the rank's dW, db and lower sums
    at the f32 K5b's tolerances against the plain version."""
    N, Kw, F, lo = 41, 40, 48, 17
    x, w, (b, gamma, beta), in_stats, dz, seed = _case(N, Kw, F, 9)
    keep = torch.full((1,), 0.5)
    whole = dict(seed=seed, keep=keep, drop_block=2)
    part = dict(whole, row_base=lo)
    r, stats = _fwd(lib, x, w, b, gamma, beta, in_stats, whole, 0)
    assert torch.equal(_fwd(lib, x, w, b, gamma, beta, in_stats, whole, 0,
                            sums_only=True)[0], r)
    r_lo, sums_lo = _fwd(lib, x[lo:], w, b, gamma, beta, in_stats, part, 0,
                         sums_only=True)
    assert torch.equal(r_lo, r[lo:])
    _, sums_p = TF.dense_block_fwd_reference(x[lo:], w, b, gamma, beta,
                                             in_stats, sums_only=True, **part)
    _close(sums_lo, sums_p, 1e-3, 1e-3)
    rf, dzf = r.float(), dz.float()
    sums = torch.stack([dzf.sum(0), (dzf * (rf - stats[0]) * stats[2]).sum(0)])
    full = _bwd(lib, dz, r, x, w, stats, sums, in_stats, whole, 0)
    got = _bwd(lib, dz[lo:], r[lo:], x[lo:], w, stats, sums, in_stats, part,
               0, n_total=N)
    assert torch.equal(got[0], full[0][lo:])
    want = TF.dense_block_bwd_reference(dz[lo:], r[lo:], x[lo:], w, stats,
                                        sums, in_stats, n_total=N, **part)
    assert_within_one_bf16_ulp(got[0], want[0])
    for g, v in zip(got[1:], want[1:], strict=True):
        _close(g, v)
