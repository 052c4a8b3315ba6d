"""PyTorch port: the arithmetic and host logic of the K5 kernels
(``contrastiveprosthetics_torch/csrc/train_fused.cu``), on the CPU.

K5f's GEMM and K5b's dgrad and wgrad run in 3xTF32 on the tensor cores
(``csrc/tf32_mma.cuh``), emulated here with numpy (``tests/tf32_emulation.py``)
at the train step's full width, N = 328 rows (8 items x 41 tasks): each
GEMM against float64 inside the tolerances the card holds the kernels to
against their plain f32 versions, with a wide margin; and the whole 7-block
chain, forward and backward, with masks from the plain Philox, each
gradient tensor no further from float64 (relative 2-norm) than twice the
plain f32 chain's, plus 1e-5. One TF32 pass is reported beside it. The
tile constants of the kernel source, the wrapper's checks and the build
hash over ``csrc/*.cuh`` are plain Python and are tested here too; the
kernels themselves run only on the card (``test_torch_port_cuda.py``,
``chip_smoke.py``).
"""
from __future__ import annotations

import re
import shutil

import numpy as np
import pytest
import torch

from contrastiveprosthetics_torch.ops import _build
from contrastiveprosthetics_torch.ops import train_fused as TF
from tf32_emulation import gemm_tf32

N, F, D0, L = 328, 512, 768, 7  # the fused train step's chain
KEEP, EPS = 0.5, 1e-5


def _tolerance_used(got, want, rtol, scale_atol) -> float:
    """The largest share of the allowed |got - want| <= atol + rtol |want|,
    atol = scale_atol x max |want| (``chip_smoke.py::close``)."""
    atol = scale_atol * max(float(np.abs(want).max()), 1e-3)
    return float((np.abs(got - want) / (atol + rtol * np.abs(want))).max())


def _block_input(rng, n, k, dropped=True):
    """A dense block's input as K5 sees it: the previous block's ReLU
    output through its BatchNorm affine and, for a dropped block, a mask
    drawn by the plain Philox."""
    x = np.maximum(rng.standard_normal((n, k)), 0.0).astype(np.float32)
    a = rng.uniform(0.8, 3.0, k).astype(np.float32)
    c = rng.normal(-0.5, 0.1, k).astype(np.float32)
    h = x * a + c
    if dropped:
        seed = torch.tensor([11, -7], dtype=torch.int32)
        mask = TF.dropout_masks_reference(seed, torch.tensor([KEEP]), n, k,
                                          3).numpy()
        h = np.where(mask > 0, h / np.float32(KEEP), 0.0).astype(np.float32)
    return h


# ----------------------------------------------------------- one GEMM each
@pytest.mark.parametrize("k_in", [D0, F])
def test_k5f_gemm_3xtf32_within_tolerance_of_float64(k_in):
    rng = np.random.default_rng(k_in)
    h = _block_input(rng, N, k_in, dropped=k_in == F)
    w = (rng.uniform(-1, 1, (k_in, F)) / np.sqrt(k_in)).astype(np.float32)
    b = rng.normal(0, 0.1, F).astype(np.float32)
    got = np.maximum(gemm_tf32(h, w, 3) + b, 0.0)
    want = np.maximum(h.astype(np.float64) @ w + b, 0.0)
    # K5f's r is held at rtol 1e-5, atol 1e-5 x max|r| on the card;
    # measured: ~2 % of it, as the plain f32 GEMM; one pass ~27x over
    assert _tolerance_used(got, want, 1e-5, 1e-5) < 0.1
    assert _tolerance_used(np.maximum(gemm_tf32(h, w, 1) + b, 0.0), want,
                           1e-5, 1e-5) > 1.0  # one pass: over it


def _dy(rng, n):
    return (rng.standard_normal((n, F)) * 0.01
            * (rng.random((n, F)) > 0.4)).astype(np.float32)


def test_k5b_dgrad_3xtf32_within_tolerance_of_float64():
    rng = np.random.default_rng(1)
    dy = _dy(rng, N)
    w = (rng.uniform(-1, 1, (F, F)) / np.sqrt(F)).astype(np.float32)
    got = gemm_tf32(dy, np.ascontiguousarray(w.T), 3)
    want = dy.astype(np.float64) @ w.T.astype(np.float64)
    assert _tolerance_used(got, want, 1e-4, 1e-5) < 0.1  # K5b: rtol 1e-4


@pytest.mark.parametrize("n", [N, 123])
def test_k5b_wgrad_3xtf32_over_ragged_row_chunks(n):
    """dW = h^T dy contracts over the rows: 41 k8 chunks at 328, and at 123
    a last chunk of 3 rows zero-filled, as the kernel's ragged k-tile."""
    rng = np.random.default_rng(n)
    h, dy = _block_input(rng, n, F), _dy(rng, n)
    got = gemm_tf32(np.ascontiguousarray(h.T), dy, 3)
    rows = -(-n // 8) * 8
    hp = np.zeros((rows, F), np.float32)
    dp = np.zeros((rows, F), np.float32)
    hp[:n], dp[:n] = h, dy
    assert np.array_equal(got, gemm_tf32(np.ascontiguousarray(hp.T), dp, 3))
    want = h.T.astype(np.float64) @ dy.astype(np.float64)
    assert _tolerance_used(got, want, 1e-4, 1e-5) < 0.1


# -------------------------------------------------------- the whole chain
def _col_sum(t):
    return t.sum(0, dtype=np.float64).astype(t.dtype)


def chain_grads(x0, ws, bs, gammas, betas, masks, dh, gemm, dtype):
    """The fused chain's forward and backward as K5f, K5b and the chain's
    glue compute them (``ops/train_fused.py``), in ``dtype`` with
    ``gemm(a, b)`` for every product; dropout on the last 4 blocks'
    outputs with ``masks``. Returns dW, db, dgamma, dbeta of each block,
    then dx0."""
    cast = [np.asarray(t, dtype) for t in (x0, *ws, *bs, *gammas, *betas)]
    x0, ws = cast[0], cast[1:1 + L]
    bs, gammas, betas = (cast[1 + L * j:1 + L * (j + 1)] for j in (1, 2, 3))
    keep, n = dtype(KEEP), dtype(x0.shape[0])
    dropped = {i: masks[i - (L - 4)] > 0 for i in range(L - 4, L)}

    def dropout(t, i):  # block i's output dropped, as its mask says
        return np.where(dropped[i], t / keep, dtype(0)) if i in dropped else t

    hs, rs, stats = [], [], []
    x = x0
    for i in range(L):
        h = x if i == 0 else dropout(x * stats[-1][3] + stats[-1][4], i - 1)
        r = np.maximum(gemm(h, ws[i]) + bs[i], dtype(0))
        mean = _col_sum(r) / n
        var = np.maximum(_col_sum(r * r) / n - mean * mean, dtype(0))
        rstd = dtype(1) / np.sqrt(var + dtype(EPS))
        a = gammas[i] * rstd
        hs.append(h)
        rs.append(r)
        stats.append((mean, var, rstd, a, betas[i] - mean * a))
        x = r
    dz = dropout(np.asarray(dh, dtype), L - 1)
    xn = (rs[-1] - stats[-1][0]) * stats[-1][2]
    sums = (_col_sum(dz), _col_sum(dz * xn))
    dws, dbs, dgs, dbetas = ([None] * L for _ in range(4))
    for i in range(L - 1, -1, -1):
        mean, _, rstd, a, _ = stats[i]
        dbetas[i], dgs[i] = sums
        xn = (rs[i] - mean) * rstd
        dy = np.where(rs[i] > 0, a * (dz - sums[0] / n - xn * (sums[1] / n)),
                      dtype(0))
        dx = gemm(dy, np.ascontiguousarray(ws[i].T))
        dws[i] = gemm(np.ascontiguousarray(hs[i].T), dy)
        dbs[i] = _col_sum(dy)
        if i > 0:
            dx = dropout(dx, i - 1)
            xn_in = (rs[i - 1] - stats[i - 1][0]) * stats[i - 1][2]
            sums = (_col_sum(dx), _col_sum(dx * xn_in))
        dz = dx
    return [*dws, *dbs, *dgs, *dbetas, dz]


def _chain_case(n, d0, f, seed):
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((n, d0)).astype(np.float32)
    ws = [(rng.uniform(-1, 1, (d0 if i == 0 else f, f))
           / np.sqrt(d0 if i == 0 else f)).astype(np.float32) for i in range(L)]
    bs = [rng.normal(0, 0.1, f).astype(np.float32) for _ in range(L)]
    gammas = [rng.uniform(0.8, 1.2, f).astype(np.float32) for _ in range(L)]
    betas = [rng.normal(0, 0.1, f).astype(np.float32) for _ in range(L)]
    seed_w = torch.tensor([5, -3], dtype=torch.int32)
    masks = [TF.dropout_masks_reference(seed_w, torch.tensor([KEEP]), n, f,
                                        b).numpy() for b in range(L - 4, L)]
    dh = (rng.standard_normal((n, f)) / n).astype(np.float32)
    return x0, ws, bs, gammas, betas, masks, dh


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_explicit_chain_is_autograd_of_the_plain_chain():
    """The emulation's forward and backward, in float64 with plain
    products, against autograd of ``dense_chain_reference``."""
    x0, ws, bs, gammas, betas, masks, dh = _chain_case(40, 48, 32, 3)
    got = chain_grads(x0, ws, bs, gammas, betas, masks, dh, np.matmul,
                      np.float64)
    leaves = [torch.from_numpy(np.asarray(t, np.float64)).requires_grad_()
              for t in (*ws, *bs, *gammas, *betas, x0)]
    h, _, _ = TF.dense_chain_reference(
        leaves[-1], leaves[:L], leaves[L:2 * L], leaves[2 * L:3 * L],
        leaves[3 * L:4 * L], [torch.from_numpy(m).double() for m in masks],
        KEEP, dropout_from=L - 4, eps=EPS)
    want = torch.autograd.grad(h, leaves, torch.from_numpy(dh).double())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w.numpy(), rtol=1e-9, atol=1e-12)


@pytest.fixture(scope="module")
def full_chain_grads():
    case = _chain_case(N, D0, F, 0)
    return {name: chain_grads(*case, gemm, dtype) for name, gemm, dtype in (
        ("f64", np.matmul, np.float64),
        ("plain_f32", np.matmul, np.float32),
        ("3xtf32", lambda a, b: gemm_tf32(a, b, 3), np.float32),
        ("1xtf32", lambda a, b: gemm_tf32(a, b, 1), np.float32))}


def _chain_errors(grads, name):
    return [_rel_l2(g, w) for g, w in zip(grads[name], grads["f64"])]


def test_3xtf32_chain_gradients_within_twice_the_plain_f32_chain(
        full_chain_grads):
    """Each of the 29 gradient tensors of the full-width chain (7 blocks'
    dW, db, dgamma, dbeta and dx0) no further from float64 than twice the
    plain f32 chain's distance, plus 1e-5: the bar ``chip_smoke.py`` sets
    the fused step on the card."""
    kernel = _chain_errors(full_chain_grads, "3xtf32")
    plain = _chain_errors(full_chain_grads, "plain_f32")
    assert len(kernel) == 4 * L + 1
    assert all(np.isfinite(full_chain_grads["3xtf32"][-1]).ravel())
    worse = [(i, k, p) for i, (k, p) in enumerate(zip(kernel, plain))
             if k > 2 * p + 1e-5]
    assert not worse


def test_one_tf32_pass_puts_the_chain_gradients_further_from_float64(
        full_chain_grads):
    """What one TF32 product per MAC would give: its worst gradient tensor
    is many times further from float64 than the 3xTF32 chain's worst, and
    it misses the bar of twice the plain f32 chain (measured: 3xTF32 1.3e-6,
    plain f32 7.4e-3, one pass 7.3e-2 at worst)."""
    three = max(_chain_errors(full_chain_grads, "3xtf32"))
    one = _chain_errors(full_chain_grads, "1xtf32")
    plain = _chain_errors(full_chain_grads, "plain_f32")
    assert max(one) > 10 * three
    assert any(o > 2 * p + 1e-5 for o, p in zip(one, plain))


# ----------------------------------------------------- host-side contract
def _tiles(src: str, kind: str) -> dict:
    return {int(i): tuple(int(v) for v in dims) for i, *dims in re.findall(
        kind + r"Tile(\d) = Tile<(\d+), (\d+), (\d+), (\d+)>;", src)}


def test_the_kernel_source_tiles_as_the_wrapper_sizes_its_buffers():
    """FwdTile* and DgradTile* in the source are the (rows, columns) the
    wrapper sizes the partial sums and tickets by; both kernels launch at
    least 132 CTAs (the card's SMs) at the train step's 328 rows in every
    tiling; the ring has at least 3 slots of 32-deep k-tiles."""
    src = (_build.SRC_DIR / "train_fused.cu").read_text()
    fwd, dgrad, wgrad = (_tiles(src, k) for k in ("Fwd", "Dgrad", "Wgrad"))
    assert [fwd[i][:2] for i in sorted(fwd)] == list(TF.FWD_TILES)
    assert [dgrad[i][:2] for i in sorted(dgrad)] == list(TF.DGRAD_TILES)
    assert sorted(wgrad) == sorted(dgrad)
    assert TF.FWD_TILING in fwd and TF.BWD_TILING in dgrad
    stages = int(re.search(r"constexpr int kStages = (\d+);", src).group(1))
    assert stages >= 3 and "constexpr int kBK = 32;" in src
    assert '#include "tf32_mma.cuh"' in src

    def ctas(rows, cols, tile):
        return -(-rows // tile[0]) * -(-cols // tile[1])

    for K_in in (F, D0):
        for t in fwd.values():
            assert ctas(N, F, t) >= 132
        for i in dgrad:  # one launch, two roles, the same block size
            assert dgrad[i][2] * dgrad[i][3] == wgrad[i][2] * wgrad[i][3]
            assert ctas(N, K_in, dgrad[i]) + ctas(K_in, F, wgrad[i]) >= 132


def test_the_mma_is_3xtf32_with_a_round_to_nearest_add_per_chunk():
    hdr = (_build.SRC_DIR / "tf32_mma.cuh").read_text()
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in hdr
    assert "cvt.rna.tf32.f32" in hdr and "cp.async.cg.shared.global" in hdr
    src = (_build.SRC_DIR / "train_fused.cu").read_text()
    assert "__fadd_rn(acc[mi][ni][q], cs.p[kk][mi][ni][q])" in src


def test_library_path_hashes_the_headers(tmp_path, monkeypatch):
    """An edited ``csrc/*.cuh`` gives a new library name, so no stale
    library is loaded; an unchanged tree gives the same one."""
    src = tmp_path / "csrc"
    shutil.copytree(_build.SRC_DIR, src)
    monkeypatch.setattr(_build, "SRC_DIR", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    names = ("train_fused", "encoder_chain")
    before = {n: _build.library_path(n) for n in names}
    assert all(p.parent == tmp_path / "build" for p in before.values())
    assert {n: _build.library_path(n) for n in names} == before
    header = src / "tf32_mma.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {n: _build.library_path(n) for n in names}
    assert all(after[n] != before[n] for n in names)
    (src / "train_fused.cu").write_bytes(
        (src / "train_fused.cu").read_bytes() + b"\n")
    assert _build.library_path("train_fused") != after["train_fused"]
    assert _build.library_path("encoder_chain") == after["encoder_chain"]


@pytest.mark.parametrize("case,match", [
    ("width", "multiples of 4"),
    ("aligned", "16-byte aligned"),
    ("tiling", "tiling"),
])
def test_the_wrapper_checks_what_the_kernels_copy(case, match):
    """What the kernels' 16-byte copies need is checked before a launch."""
    x = torch.zeros(8, 64)
    K_in, F_out, tiling = 64, 32, 0
    if case == "width":
        K_in = 62
    elif case == "aligned":
        x = torch.zeros(8 * 64 + 1)[1:].view(8, 64)
    else:
        tiling = len(TF.FWD_TILES)
    with pytest.raises(ValueError, match=match):
        TF._check_tiled(K_in, F_out, tiling, x)
