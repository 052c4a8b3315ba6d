"""PyTorch port: the K1 kernels' CUDA source (``csrc/contrastive_loss.cu``)
run on the CPU through ``tests/cuda_emulation.py``, against their plain
versions (``ops/kernels.py``).

The emulation runs the kernels' own staging, 4 x 4 logit tiles, 8-lane
shuffle reductions, first-max rule, in-CTA sums and product tiles, so the
outputs are held to the tolerances the card holds the kernels to
(``chip_smoke.py``): loss rtol 1e-5, correct exact, gradients rtol 1e-4
atol 1e-6 (``test_pallas.py:58-59``). Rows with tied maxima exercise the
first-max rule; a config's bits must not depend on C or on its position.
"""
from __future__ import annotations

import ctypes

import numpy as np
import pytest
import torch

import cuda_emulation
from contrastiveprosthetics_torch.ops import kernels as K

P, I = ctypes.c_void_p, ctypes.c_int
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if cuda_emulation.compiler() is None:
        pytest.skip("needs a host C++ compiler to emulate the kernels")
    lib = cuda_emulation.build("contrastive_loss",
                               tmp_path_factory.mktemp("emu"))
    lib.contrastive_loss_fwd_launch.argtypes = [P] * 3 + [I] * 4 + [P]
    lib.contrastive_loss_bwd_launch.argtypes = [P] * 5 + [I] * 4 + [P]
    lib.contrastive_loss_floor_launch.argtypes = [I] * 5 + [P]
    return lib


def _ptr(t):
    return P(t.data_ptr())


def _case(C, N, T, d, seed):
    """Normalized e, g (C, N, T, d) from a numpy seed. Where T >= 10, rows 3
    and 9 of every item reach their maximum at columns 1, 3 and 9 (g_3 =
    g_9 = g_1 = e_3 = e_9), so their first maximum is column 1 and neither
    counts; columns 1 and 9 fall to one lane of the 8 that reduce a row,
    column 3 to another. Row 1 (e_1 = -g_1) has its minimum there."""
    rng = np.random.default_rng(seed)

    def unit(shape):
        x = rng.standard_normal(shape).astype(np.float32)
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    e, g = unit((C, N, T, d)), unit((C, N, T, d))
    if T >= 10:
        for r in (3, 9):
            g[..., r, :] = e[..., r, :] = g[..., 1, :]
        e[..., 1, :] = -g[..., 1, :]
    return torch.from_numpy(e), torch.from_numpy(g)


def _fwd(lib, e, g):
    C, N, T, d = e.shape
    out = torch.full((2, C), float("nan"))
    assert lib.contrastive_loss_fwd_launch(_ptr(e), _ptr(g), _ptr(out), C, N,
                                           T, d, None) == 0
    return out[0], out[1]


def _bwd(lib, e, g, dloss):
    C, N, T, d = e.shape
    de, dg = torch.full_like(e, float("nan")), torch.full_like(g, float("nan"))
    assert lib.contrastive_loss_bwd_launch(
        _ptr(e), _ptr(g), _ptr(dloss), _ptr(de), _ptr(dg), C, N, T, d,
        None) == 0
    return de, dg


@pytest.mark.parametrize("C,N,T,d", [(1, 8, 41, 16), (1, 3, 41, 16),
                                     (1, 1, 1, 1), (3, 5, 64, 64),
                                     (2, 8, 41, 16), (1, 11, 41, 16),
                                     (2, 3, 19, 7)])
def test_emulated_kernels_match_plain(lib, C, N, T, d):
    """K1f and K1b against their plain versions at the step's shape, a tail
    batch, the smallest shape, the largest T and d, two configs, more items
    than a forward cluster has CTAs (11: ranks 0-2 take two each) and a
    width that is no whole number of float4s (rows staged by plain loads);
    the tied rows count exactly as the plain first-max does."""
    e, g = _case(C, N, T, d, seed=C * 1000 + N * 100 + T + d)
    loss, correct = _fwd(lib, e, g)
    loss_p, correct_p = K.fused_contrastive_reference(e, g)
    torch.testing.assert_close(loss, loss_p, rtol=1e-5, atol=0)
    assert torch.equal(correct, correct_p)
    if T >= 10:  # the plain version sees the ties the test built
        logits = e @ g.transpose(-1, -2)
        for r in (3, 9):
            assert torch.equal(logits[..., r, 1], logits[..., r, r])
            assert bool((logits.argmax(-1)[..., r] == 1).all())
    dloss = torch.linspace(0.5, 2.0, C)
    de, dg = _bwd(lib, e, g, dloss)
    de_p, dg_p = K.contrastive_loss_bwd_reference(e, g, dloss)
    torch.testing.assert_close(de, de_p, **GRAD_TOL)
    torch.testing.assert_close(dg, dg_p, **GRAD_TOL)


def test_emulated_config_bits_do_not_depend_on_batch(lib):
    """Config c's loss, count and gradients have the same bits alone (C =
    1) as at any position inside C = 3, and on a rerun."""
    e, g = _case(3, 8, 41, 16, seed=5)
    dloss = torch.tensor([0.5, 1.5, 1.0])
    loss, correct = _fwd(lib, e, g)
    de, dg = _bwd(lib, e, g, dloss)
    again = _fwd(lib, e, g) + _bwd(lib, e, g, dloss)
    for a, b in zip((loss, correct, de, dg), again):
        assert torch.equal(a, b)
    for c in range(3):
        one = (e[c:c + 1].contiguous(), g[c:c + 1].contiguous())
        l1, c1 = _fwd(lib, *one)
        de1, dg1 = _bwd(lib, *one, dloss[c:c + 1].contiguous())
        assert torch.equal(l1[0], loss[c]) and torch.equal(c1[0], correct[c])
        assert torch.equal(de1[0], de[c]) and torch.equal(dg1[0], dg[c])


def test_emulated_launchers_refuse_what_they_cannot_take(lib):
    """T or d past 64, an empty batch or more than 8,192 items: the
    launcher returns an error and writes nothing; the floor launcher takes the forward's and the
    backward's shapes."""
    e, g = _case(1, 2, 8, 4, seed=1)
    out = torch.full((2, 1), float("nan"))
    for C, N, T, d in ((1, 2, 65, 4), (1, 2, 8, 65), (0, 2, 8, 4),
                       (1, 0, 8, 4), (1, 8193, 8, 4)):
        assert lib.contrastive_loss_fwd_launch(_ptr(e), _ptr(g), _ptr(out),
                                               C, N, T, d, None) != 0
        assert lib.contrastive_loss_floor_launch(0, C, N, T, d, None) != 0
    assert torch.isnan(out).all()
    assert lib.contrastive_loss_floor_launch(0, 1, 8, 41, 16, None) == 0
    assert lib.contrastive_loss_floor_launch(1, 1, 8, 41, 16, None) == 0
