"""PyTorch port: the fused chain's dp form (``ops/train_fused.py``:
``DpRows``, the row base of the Philox counters, K5f's sums-only end with
:func:`finish_stats`, K5b's ``n_total``) in one process, on the plain
versions.

The chain over a batch's row halves, each half a "rank" in a thread of
its own whose dp sum is a barrier between the threads (the stand-in for
``sum_flat`` over a process group), is held in float64 against the chain
over the whole batch: values, statistics and gradients, the BatchNorm
affines' among them, which each rank returns for its own rows. The gloo
group's tests of the whole sharded step are ``test_torch_port_parallel.py``.
"""
from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from contrastiveprosthetics_torch.ops import train_fused as TF

torch.set_num_threads(1)


def _seed(rng):
    return torch.tensor([int(v) for v in rng.integers(-2**31, 2**31, 2)],
                        dtype=torch.int32)


@pytest.mark.parametrize("n_rows,width,row_base", [(7, 36, 0), (7, 36, 11),
                                                   (164, 512, 164),
                                                   (82, 37, 246)])
def test_mask_bits_at_a_row_base_are_the_whole_draws_rows(n_rows, width,
                                                          row_base):
    """Row i drawn at row base r is row r + i of the draw from row 0, bit
    for bit, and so is the {0,1} mask."""
    seed = _seed(np.random.default_rng(n_rows + row_base))
    whole = TF.mask_bits(seed, row_base + n_rows, width, 5)
    got = TF.mask_bits(seed, n_rows, width, 5, row_base)
    assert torch.equal(got, whole[row_base:])
    keep = torch.full((1,), 0.5)
    assert torch.equal(
        TF.dropout_masks_reference(seed, keep, n_rows, width, 5, row_base),
        TF.dropout_masks_reference(seed, keep, row_base + n_rows, width,
                                   5)[row_base:])
    if row_base:
        assert not torch.equal(got, whole[:n_rows])


def _block(N, K, F, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.asarray(a)).to(dtype)

    x = t(np.maximum(rng.standard_normal((N, K)), 0.0))
    mean, var = t(rng.uniform(0.2, 0.6, K)), t(rng.uniform(0.2, 0.5, K))
    rstd = torch.rsqrt(var + 1e-5)
    a = t(rng.uniform(0.8, 1.2, K)) * rstd
    in_stats = torch.stack([mean, var, rstd, a,
                            t(rng.normal(0, 0.1, K)) - mean * a])
    w = t(rng.uniform(-1, 1, (K, F)) / np.sqrt(K))
    b, gamma, beta = (t(rng.normal(0, 0.1, F)), t(rng.uniform(0.8, 1.2, F)),
                      t(rng.normal(0, 0.1, F)))
    dz = t(rng.standard_normal((N, F)) * 0.01)
    return x, w, b, gamma, beta, in_stats, dz, _seed(rng)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sums_then_finish_stats_is_the_one_shot_block(dtype):
    """K5f's plain version with ``sums_only`` gives the one-shot r and the
    column sums (sum r, sum r^2) whose :func:`finish_stats` is the
    one-shot statistics: rtol 1e-6 in f32 (1 / sqrt against rsqrt, an ulp
    or two), 1e-14 in float64; the sums of two row halves, each drawn at
    its row base, add up to the whole batch's."""
    N, K, F, lo = 41, 64, 48, 17
    x, w, b, gamma, beta, in_stats, _, seed = _block(N, K, F, 3, dtype)
    drop = dict(seed=seed, keep=torch.full((1,), 0.5), drop_block=2)
    r, stats = TF.dense_block_fwd_reference(x, w, b, gamma, beta, in_stats,
                                            **drop)
    r_s, sums = TF.dense_block_fwd_reference(x, w, b, gamma, beta, in_stats,
                                             sums_only=True, **drop)
    assert torch.equal(r_s, r) and sums.shape == (2, F)
    tol = 1e-6 if dtype == torch.float32 else 1e-14
    torch.testing.assert_close(TF.finish_stats(sums, gamma, beta, N), stats,
                               rtol=tol, atol=tol)
    halves = [TF.dense_block_fwd_reference(
        x[a:z], w, b, gamma, beta, in_stats, sums_only=True, row_base=a,
        **drop) for a, z in ((0, lo), (lo, N))]
    assert torch.equal(torch.cat([h[0] for h in halves]), r)
    torch.testing.assert_close(halves[0][1] + halves[1][1], sums,
                               rtol=10 * tol, atol=10 * tol)


def test_block_backward_at_a_row_base_with_n_total():
    """K5b's plain version on rows [lo, N) at row base lo, given the whole
    batch's sums and n_total N: dx the whole batch's rows; dW, db and the
    lower sums of the two halves adding up to the whole batch's (float64,
    1e-12)."""
    N, K, F, lo = 41, 64, 48, 17
    x, w, b, gamma, beta, in_stats, dz, seed = _block(N, K, F, 4,
                                                      torch.float64)
    drop = dict(seed=seed, keep=torch.full((1,), 0.5), drop_block=2)
    r, stats = TF.dense_block_fwd_reference(x, w, b, gamma, beta, in_stats,
                                            **drop)
    sums = torch.stack([dz.sum(0), (dz * (r - stats[0]) * stats[2]).sum(0)])
    whole = TF.dense_block_bwd_reference(dz, r, x, w, stats, sums, in_stats,
                                         **drop)
    parts = [TF.dense_block_bwd_reference(
        dz[a:z], r[a:z], x[a:z], w, stats, sums, in_stats, row_base=a,
        n_total=N, **drop) for a, z in ((0, lo), (lo, N))]
    torch.testing.assert_close(torch.cat([p[0] for p in parts]), whole[0],
                               rtol=1e-12, atol=1e-12)
    for j in (1, 2, 3):
        torch.testing.assert_close(parts[0][j] + parts[1][j], whole[j],
                                   rtol=1e-12, atol=1e-12)


class ThreadGroup:
    """A dp group of threads for ``sum_flat``'s place: each rank's tensors
    summed in rank order once every rank has brought its own."""

    def __init__(self, n: int):
        self.barrier = threading.Barrier(n)
        self.slots: list = [None] * n

    def sum_flat(self, tensors, group):
        rank = group[1]
        self.slots[rank] = [t.clone() for t in tensors]
        self.barrier.wait()
        out = [sum(parts[1:], parts[0].clone())
               for parts in zip(*self.slots)]
        self.barrier.wait()
        return out


def _chain_case(L, D0, F, N, seed):
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float64))

    ws = [t(rng.standard_normal((D0 if i == 0 else F, F)) * 0.1)
          for i in range(L)]
    bs = [t(rng.standard_normal(F) * 0.1) for _ in range(L)]
    gs = [t(1.0 + 0.1 * rng.standard_normal(F)) for _ in range(L)]
    betas = [t(0.1 * rng.standard_normal(F)) for _ in range(L)]
    x0 = t(rng.standard_normal((N, D0)))
    cot = t(rng.standard_normal((N, F)))
    return x0, ws, bs, gs, betas, cot, _seed(rng)


def _run(x0, params, cot, seed, rate, **kw):
    """The chain's outputs and the gradients of sum(h * cot) as float64
    numpy arrays: h, means, variances, dx0, then each parameter's."""
    leaves = [x0.clone().requires_grad_()] + [
        p.clone().requires_grad_() for p in params]
    L = len(params) // 4
    ws, bs, gs, betas = (leaves[1 + j * L:1 + (j + 1) * L] for j in range(4))
    h, means, variances = TF.fused_dense_chain(leaves[0], ws, bs, gs, betas,
                                               seed, rate, **kw)
    grads = torch.autograd.grad((h * cot).sum(), leaves)
    return [t.detach().numpy() for t in (h, means, variances, *grads)]


@pytest.mark.parametrize("mode", ["prng", "input"])
@pytest.mark.parametrize("L,ranks", [(3, (0, 17, 41)), (5, (0, 9, 25, 41))])
def test_chain_over_row_parts_is_the_whole_chain(monkeypatch, L, ranks,
                                                 mode):
    """The chain over 2 or 3 parts of a 41-row batch (ragged), each a dp
    rank in its own thread, at dropout 0.5 (drawn at each rank's global
    rows, or the whole batch's masks given), against the chain over the
    whole batch, float64 within 1e-9: h and dx0 row for row, the
    statistics on every rank, and each parameter's gradient as the sum of
    the ranks' (dgamma and dbeta too: each rank returns its rows' sums,
    not the global ones it hands to K5b)."""
    N, D0, F = ranks[-1], 24, 32
    x0, ws, bs, gs, betas, cot, seed = _chain_case(L, D0, F, N, L)
    params = [*ws, *bs, *gs, *betas]
    kw = {}
    if mode == "input":
        keep = torch.full((1,), 0.5)
        kw = dict(mask_mode="input", ext_masks=[
            TF.dropout_masks_reference(seed, keep, N, F, block)
            for block in range(max(0, L - 4), L)])
    whole = _run(x0, params, cot, seed, 0.5, **kw)
    group = ThreadGroup(len(ranks) - 1)
    monkeypatch.setattr(TF, "sum_flat", group.sum_flat)
    results: dict = {}

    def rank(i):
        a, z = ranks[i], ranks[i + 1]
        dp = TF.DpRows((group, i), a, N)
        results[i] = _run(x0[a:z], params, cot[a:z], seed, 0.5, dp=dp, **kw)

    threads = [threading.Thread(target=rank, args=(i,))
               for i in range(len(ranks) - 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    parts = [results[i] for i in range(len(ranks) - 1)]

    def close(got, want):
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got - want).max()) <= 1e-9 * scale

    for j in (0, 3):  # h and dx0: the rank's rows
        close(np.concatenate([p[j] for p in parts]), whole[j])
    for p in parts:  # the global statistics on every rank
        close(p[1], whole[1])
        close(p[2], whole[2])
    for j in range(4, len(whole)):
        close(sum(p[j] for p in parts), whole[j])


def test_dp_rows_take_one_configs_chain():
    """A stacked chain (a config axis) has no dp form."""
    x0 = torch.zeros((2, 8, 16))
    with pytest.raises(ValueError, match="one config"):
        TF.fused_dense_chain(x0, [torch.zeros((2, 16, 8))],
                             [torch.zeros((2, 8))], [torch.ones((2, 8))],
                             [torch.zeros((2, 8))],
                             torch.zeros((2, 2), dtype=torch.int32),
                             torch.zeros(2), dp=TF.DpRows(None, 0, 8))
