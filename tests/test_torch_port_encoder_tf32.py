"""PyTorch port: the arithmetic and host logic of the ``encoder_chain``
kernels (``contrastiveprosthetics_torch/csrc/encoder_chain.cu``), on the CPU.

The kernels run each layer in 3xTF32 on the tensor cores: every operand
splits as ``x = big + small``, ``big = cvt.rna.tf32.f32(x)``, ``small =
cvt.rna.tf32.f32(x - big)``, and every k8 chunk sums ``small*big``,
``big*small`` and ``big*big`` in the tensor core and adds that sum to an
f32 accumulator, rounded to nearest. Here that arithmetic is emulated with
numpy (``tests/tf32_emulation.py``: TF32 rounding on the f32 bit pattern,
each chunk's products summed exactly in float64 and rounded to f32, then
added to the f32 accumulator) on a seeded full-width chain, and held against float64: it must
sit inside the tolerance the card holds the kernel to against the plain
f32 version (rtol 2e-4, atol 2e-5) with a wide margin, while one TF32 pass
must not. The regime choice, the layer table and its checks are plain
Python and are tested here too; the kernels themselves run only on the
card (``test_torch_port_cuda.py``, ``chip_smoke.py``).
"""
from __future__ import annotations

import gc

import numpy as np
import pytest
import torch

from contrastiveprosthetics_torch.models.clip import ContrastiveModel
from contrastiveprosthetics_torch.ops import kernels as K
from tf32_emulation import gemm_tf32, split_tf32, tf32_rna

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5  # the card's tolerance against the plain version


def chain_tf32(frames, folded, affines, passes: int) -> np.ndarray:
    """The encoder chain with its hidden layers in ``passes``-pass TF32 and
    the head in f32, as ``encoder_chain`` computes it."""
    *ws, gt = [t.numpy() for t in folded]
    h = frames
    for j in range(0, len(ws) - 2, 2):
        h = np.maximum(gemm_tf32(h, ws[j], passes) + ws[j + 1], 0.0)
        a, c = affines[j].numpy(), affines[j + 1].numpy()
        S = a.shape[0]
        h = (h.reshape(-1, S, h.shape[1]) * a + c).reshape(-1, h.shape[1])
    e = h @ ws[-2] + ws[-1]
    e = e / np.linalg.norm(e, axis=-1, keepdims=True)
    return e @ gt


@pytest.fixture(scope="module")
def full_chain():
    """A seeded full-width chain (12 -> 768 -> 768 -> 512 x 7 -> 16 -> 41)
    with per-session affines of 8 sessions and 37 ticks of frames."""
    rng = np.random.default_rng(0)
    model = ContrastiveModel(generator=torch.Generator().manual_seed(0))
    S, ticks = 8, 37
    with torch.no_grad():
        folded = K.fold_encoder_params_shared(model.emg_net,
                                              model.encode_classes())
        stats = [(torch.from_numpy(rng.normal(0, 0.3, (S, bn.num_features))
                                   .astype(np.float32)),
                  torch.from_numpy(rng.uniform(0.3, 3.0, (S, bn.num_features))
                                   .astype(np.float32)))
                 for bn in model.emg_net.norms()]
        affines = K.session_bn_affines(model.emg_net, stats)
    frames = rng.standard_normal((S * ticks, 12)).astype(np.float32)
    want = K.fused_encoder_logits_reference(
        torch.from_numpy(frames).double(), tuple(t.double() for t in folded),
        tuple(t.double() for t in affines)).numpy()
    return frames, folded, affines, want


def _tolerance_used(got, want) -> float:
    """The largest share of the allowed |got - want| <= atol + rtol |want|."""
    return float((np.abs(got - want) / (ATOL + RTOL * np.abs(want))).max())


def test_3xtf32_chain_within_tolerance_of_float64(full_chain):
    frames, folded, affines, want = full_chain
    got = chain_tf32(frames, folded, affines, passes=3)
    assert got.shape == (296, 41) and np.isfinite(got).all()
    # measured: ~1 % of the tolerance; the plain f32 chain uses about as much
    assert _tolerance_used(got, want) < 0.1


def test_one_tf32_pass_misses_the_tolerance(full_chain):
    frames, folded, affines, want = full_chain
    got = chain_tf32(frames, folded, affines, passes=1)
    assert _tolerance_used(got, want) > 1.0  # measured: ~4x over


# ------------------------------------------------------------ tf32 rounding
@pytest.mark.parametrize("bits,want", [
    (0x3F800000, 0x3F800000),  # 1.0 is a TF32 value
    (0x3F800FFF, 0x3F800000),  # below half of a TF32 ulp: down
    (0x3F801000, 0x3F802000),  # exactly half: away from zero, up
    (0xBF801000, 0xBF802000),  # exactly half, negative: away from zero
    (0x3F803000, 0x3F804000),  # half again, from an odd TF32 value: up
    (0x3F801001, 0x3F802000),  # above half: up
    (0x3FFFF000, 0x40000000),  # carry into the exponent
    (0x7F7FF000, 0x7F800000),  # the largest f32 rounds to infinity
    (0x7F800000, 0x7F800000),  # infinity stays
    (0x7FC00001, 0x7FC00001),  # a NaN stays a NaN
    (0x00000000, 0x00000000),
    (0x80000000, 0x80000000),  # -0 keeps its sign
    (0x00001000, 0x00002000),  # subnormal, exactly half: up
    (0x00000FFF, 0x00000000),  # subnormal below half: to zero
])
def test_tf32_rna_rounds_on_the_bit_pattern(bits, want):
    x = np.array([bits], np.uint32).view(np.float32)
    assert int(tf32_rna(x).view(np.uint32)[0]) == want


def test_tf32_split_leaves_under_2_to_minus_21_of_x():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(100_000) * 10.0 ** rng.uniform(-6, 6, 100_000)
         ).astype(np.float32)
    big, small = split_tf32(x)
    for part in (big, small):
        assert not (part.view(np.uint32) & 0x1FFF).any()  # 10 mantissa bits
    rest = x.astype(np.float64) - big - small
    assert (np.abs(rest) <= 2.0 ** -21 * np.abs(x)).all()
    assert (np.abs(x - big) <= 2.0 ** -11 * np.abs(x)).all()


# ------------------------------------------------------ host-side logic
def test_regime_is_chosen_from_the_row_count_alone():
    thr = K.ENCODER_SMALL_ROWS
    assert [K.encoder_regime(M) for M in (1, 16, thr - 1, thr)] == [0] * 4
    assert [K.encoder_regime(M) for M in (thr + 1, 32768, 819200)] == [1] * 3


def test_the_kernel_source_tiles_rows_as_the_regimes_assume():
    """The small tiling's 16-row tiles and the large tiling's 128-row tiles
    both place row r at r % 16 of its MMA tile (the bit-identity across
    regimes rests on it)."""
    src = (K._build.SRC_DIR / "encoder_chain.cu").read_text()
    assert '#include "tf32_mma.cuh"' in src  # the MMA lives in the header
    src += (K._build.SRC_DIR / "tf32_mma.cuh").read_text()
    assert "constexpr int kSM = 16, kSN = 8" in src
    assert "constexpr int kBM = 128, kBN = 128, kBK = 32;" in src
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in src
    assert "kWarpsM" in src and "kBM / kWarpsM / 16" in src


def _model_chain(with_affines: bool, S: int = 3):
    model = ContrastiveModel(generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        emb = model.encode_classes()
        if not with_affines:
            return K.fold_encoder_params(model.emg_net, emb), None
        folded = K.fold_encoder_params_shared(model.emg_net, emb)
        stats = [(bn.running_mean.expand(S, -1), bn.running_var.expand(S, -1))
                 for bn in model.emg_net.norms()]
        return folded, K.session_bn_affines(model.emg_net, stats)


@pytest.mark.parametrize("with_affines", [False, True])
def test_encoder_plan_layer_table(with_affines):
    folded, affines = _model_chain(with_affines)
    plan = K.encoder_plan(folded, affines)
    assert plan.widths == (12, 768, 768, 512, 512, 512, 512, 512, 512, 512,
                           16, 41)
    assert (plan.n_hidden, plan.max_n) == (9, 768)
    assert plan.S == (3 if with_affines else 1)
    assert list(plan.dims) == list(plan.widths)
    want = []
    for j in range(9):
        want += [folded[2 * j].data_ptr(), folded[2 * j + 1].data_ptr()]
        want += ([affines[2 * j].data_ptr(), affines[2 * j + 1].data_ptr()]
                 if with_affines else [None, None])
    want += [t.data_ptr() for t in folded[-3:]]
    assert list(plan.table) == want
    assert plan.serves(folded, affines)
    assert not plan.serves(folded[:-1] + (folded[-1].clone(),), affines)


def _replace(chain, i, t):
    return chain[:i] + (t,) + chain[i + 1:]


@pytest.mark.parametrize("case,match", [
    ("misaligned", "16-byte aligned"),
    ("transposed", "not contiguous"),
    ("float64", "dtype"),
    ("broken chain", "shape"),
    ("odd width", "multiples of 4"),
    ("odd embedding", "embedding width"),
    ("affines", "affines for 9 layers"),
])
def test_encoder_plan_rejects_what_the_kernels_do_not_take(case, match):
    folded, _ = _model_chain(False)
    affines = None
    if case == "misaligned":  # a 4-byte offset into the same storage
        w = folded[2]
        folded = _replace(folded, 2, torch.empty(w.numel() + 1)[1:].view(
            w.shape).copy_(w))
    elif case == "transposed":
        folded = _replace(folded, 2, folded[2].T.contiguous().T)
    elif case == "float64":
        folded = _replace(folded, 4, folded[4].double())
    elif case == "broken chain":
        folded = _replace(folded, 4, folded[4][:-4].contiguous())
    elif case == "odd width":  # 12 -> 766 breaks the 16-byte rows
        folded = _replace(_replace(folded, 0, folded[0][:, :766].contiguous()),
                          1, folded[1][:766].contiguous())
    elif case == "odd embedding":
        folded = (*folded[:-3], folded[-3][:, :15].contiguous(),
                  folded[-2][:15].contiguous(), folded[-1][:15].contiguous())
    else:
        affines = _model_chain(True)[1][:-2]
    with pytest.raises(ValueError, match=match):
        K.encoder_plan(folded, affines)


def test_plans_are_cached_per_chain_and_dropped_with_it():
    folded, affines = _model_chain(True)
    plan = K._plan_for(folded, affines)
    assert K._plan_for(folded, affines) is plan
    other = tuple(t.clone() for t in folded)
    assert K._plan_for(other, affines) is not plan
    del other
    gc.collect()
    # the plan holds weak references only: a new chain, whatever its id,
    # is checked anew
    again = tuple(t.clone() for t in folded)
    assert K._plan_for(again, affines).serves(again, affines)
