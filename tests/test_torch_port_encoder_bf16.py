"""PyTorch port: ``encoder_chain``'s bf16 variant
(``contrastiveprosthetics_torch/csrc/encoder_chain.cu``, "bf16 variant") on
the CPU.

Its arithmetic: each layer rounds its input to bf16 (round to nearest
even), multiplies by the bf16 weights in ``mma.sync`` m16n8k16, each k16
chunk's sixteen exact products summed from zero and added to the f32 row
sum with one round-to-nearest add, then bias, ReLU and affine in f32 and
one rounding to bf16 into the scratch; the head takes ``e`` in f32, its
norm in f32, and ``e`` rounded to bf16 times the bf16 ``Gt``. Here that is
modelled with numpy (:func:`chain_bf16`) on a seeded full-width chain and
held against float64 on the same bf16 operands, inside the tolerance the
card holds the kernel to against its plain version with a wide margin.
Then the CUDA source itself runs through ``tests/cuda_emulation.py`` (its
MMA sums each output's sixteen products in float64, as a chunk's exact
sum): both tilings at ragged row counts, K = 12 padded to 16 inside the
kernels, with and without affines; the last hidden layer's bf16 scratch
equal to the model's bits, the scores against the plain version, and a
row's bits the same in both tilings and at every row count. The wrapper's
refusals of dtypes, shapes and alignment are plain Python.
"""
from __future__ import annotations

import ctypes

import numpy as np
import pytest
import torch

import cuda_emulation
from contrastiveprosthetics_torch.models.clip import ContrastiveModel
from contrastiveprosthetics_torch.ops import kernels as K

torch.set_num_threads(1)

# the card's tolerance for the bf16 kernel against its plain version
# (chip_smoke.py's BF16_ATOL, JAX's absolute bound for bf16 scores): both
# round the activations to bf16 at each dot, but their f32 sums run in
# other orders, and a sum within an f32 rounding of a bf16 rounding
# boundary rounds the other way there, one bf16 ulp (2^-8 of the
# activation); scores are cosines in [-1, 1]
ATOL = 5e-2
BF16 = torch.bfloat16


# ------------------------------------------------ the arithmetic, in numpy
def bf16_rn(x) -> np.ndarray:
    """f32 values rounded to the nearest bf16 (ties to even), as f32."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    r = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    return r.astype(np.uint32).view(np.float32)


def layer_bf16(h, w) -> np.ndarray:
    """``bf16(h) @ w`` as the kernels sum it: per k16 chunk the exact sum
    of the sixteen products (float64 holds each and their sum of 16 here)
    rounded to f32, added to the f32 row sum in chunk order."""
    h = bf16_rn(h).astype(np.float64)
    w = np.asarray(w, np.float64)
    acc = np.zeros((h.shape[0], w.shape[1]), np.float32)
    for k0 in range(0, h.shape[1], 16):
        chunk = np.zeros_like(acc, dtype=np.float64)
        for k in range(k0, min(k0 + 16, h.shape[1])):
            chunk += h[:, k:k + 1] * w[k]
        acc = (acc + chunk.astype(np.float32)).astype(np.float32)
    return acc


def hidden_bf16(frames, folded, affines) -> np.ndarray:
    """The hidden layers as the kernels run them: the last one's bf16
    scratch, as f32 values."""
    *ws, _ = [t.float().numpy() for t in folded]
    h = np.asarray(frames, np.float32)
    for j in range(0, len(ws) - 2, 2):
        h = np.maximum(layer_bf16(h, ws[j]) + ws[j + 1], np.float32(0))
        if affines is not None:
            a, c = affines[j].numpy(), affines[j + 1].numpy()
            S = a.shape[0]
            h = (h.reshape(-1, S, h.shape[1]) * a + c).reshape(h.shape)
        h = bf16_rn(h)
    return h


def chain_bf16(frames, folded, affines) -> np.ndarray:
    """The bf16 chain as the kernels compute it, the head's sums exact."""
    *ws, gt = [t.float().numpy() for t in folded]
    h = hidden_bf16(frames, folded, affines).astype(np.float64)
    e = (h @ ws[-2].astype(np.float64)).astype(np.float32) + ws[-1]
    e = e / np.linalg.norm(e, axis=-1, keepdims=True)
    return (bf16_rn(e).astype(np.float64) @ gt.astype(np.float64)
            ).astype(np.float32)


def f64_chain(frames, folded, affines) -> np.ndarray:
    """float64 on the same bf16 operands: the plain version in float64
    (bf16 weights, activations rounded to bf16 at each dot)."""
    return K.fused_encoder_logits_reference(
        torch.from_numpy(np.asarray(frames)).double(),
        tuple(t.double() if t.dtype == torch.float32 else t for t in folded),
        tuple(t.double() for t in affines) if affines else None).numpy()


@pytest.fixture(scope="module")
def full_chain():
    """A seeded full-width bf16 chain (12 -> 768 -> 768 -> 512 x 7 -> 16
    -> 41) with per-session affines of 8 sessions, 37 ticks of frames."""
    rng = np.random.default_rng(0)
    model = ContrastiveModel(generator=torch.Generator().manual_seed(0))
    S, ticks = 8, 37
    with torch.no_grad():
        emb = model.encode_classes()
        folded = K.fold_encoder_params_shared(model.emg_net, emb, dtype=BF16)
        f32 = K.fold_encoder_params_shared(model.emg_net, emb)
        stats = [(torch.from_numpy(rng.normal(0, 0.3, (S, bn.num_features))
                                   .astype(np.float32)),
                  torch.from_numpy(rng.uniform(0.3, 3.0, (S, bn.num_features))
                                   .astype(np.float32)))
                 for bn in model.emg_net.norms()]
        affines = K.session_bn_affines(model.emg_net, stats)
    frames = rng.standard_normal((S * ticks, 12)).astype(np.float32)
    return frames, folded, f32, affines


def test_bf16_chain_within_tolerance_of_float64(full_chain):
    frames, folded, f32, affines = full_chain
    got = chain_bf16(frames, folded, affines)
    want = f64_chain(frames, folded, affines)
    assert got.shape == (296, 41) and np.isfinite(got).all()
    err = float(np.abs(got - want).max())
    plain = K.fused_encoder_logits_reference(
        torch.from_numpy(frames), folded, affines).numpy()
    # measured: about 1.4e-3 each (a few bf16 roundings flipped by the f32
    # sums' order), a 35th of the card's tolerance
    assert err < 0.1 * ATOL
    assert float(np.abs(plain - want).max()) < 0.1 * ATOL
    # and within JAX's own bound of the f32 fold (test_pallas.py:226)
    ref32 = K.fused_encoder_logits_reference(torch.from_numpy(frames), f32,
                                             affines).numpy()
    np.testing.assert_allclose(got, ref32, rtol=0.1, atol=0.05)


@pytest.mark.parametrize("bits,want", [
    (0x3F800000, 0x3F80),  # 1.0 is a bf16 value
    (0x3F807FFF, 0x3F80),  # below half of a bf16 ulp: down
    (0x3F808000, 0x3F80),  # exactly half, even below: down
    (0x3F818000, 0x3F82),  # exactly half, odd below: up
    (0xBF818000, 0xBF82),  # the same, negative
    (0x3F808001, 0x3F81),  # above half: up
    (0x3FFF8000, 0x4000),  # carry into the exponent
    (0x7F7FFFFF, 0x7F80),  # the largest f32 rounds to infinity
    (0x7F800000, 0x7F80),  # infinity stays
    (0x80000000, 0x8000),  # -0 keeps its sign
    (0x00008000, 0x0000),  # subnormal, half, even below: to zero
    (0x00018000, 0x0002),  # subnormal, half, odd below: up
])
def test_bf16_rounding_is_round_to_nearest_even(bits, want):
    """The model's rounding and torch's conversion (the plain version's)
    agree bit for bit, as ``cvt.rn.bf16x2.f32`` rounds."""
    x = np.array([bits], np.uint32).view(np.float32)
    assert int(bf16_rn(x).view(np.uint32)[0]) >> 16 == want
    got = torch.from_numpy(x).to(BF16).view(torch.int16).item() & 0xFFFF
    assert got == want


def test_bf16_rounding_matches_torch_on_random_values():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(200_000) * 10.0 ** rng.uniform(-30, 30, 200_000)
         ).astype(np.float32)
    want = torch.from_numpy(x).to(BF16).float().numpy()
    np.testing.assert_array_equal(bf16_rn(x), want)


# ---------------------------------------------- the CUDA source, emulated
P, I = ctypes.c_void_p, ctypes.c_int


@pytest.fixture(scope="module")
def launch(tmp_path_factory):
    if cuda_emulation.compiler() is None:
        pytest.skip("needs a host C++ compiler to emulate the kernels")
    lib = cuda_emulation.build("encoder_chain",
                               tmp_path_factory.mktemp("emu"))
    fn = bf16_fn = lib.encoder_chain_bf16_launch
    f32_fn = lib.encoder_chain_launch
    for f in (f32_fn, bf16_fn):
        f.argtypes = ([ctypes.POINTER(P), ctypes.POINTER(I), I] + [P] * 3
                      + [I] * 4 + [P])
        f.restype = I

    def run(frames, folded, affines, regime):
        plan = K.encoder_plan(folded, affines)
        M = frames.shape[0]
        scratch = torch.full((2, M, plan.max_n), float("nan"), dtype=BF16)
        scores = torch.full((M, plan.widths[-1]), float("nan"))
        rc = fn(plan.table, plan.dims, plan.n_hidden, frames.data_ptr(),
                scratch.data_ptr(), scores.data_ptr(), M, 1, plan.S, regime,
                None)
        assert rc == 0
        # layer j writes its (M, N_j) rows densely into buffer j % 2
        N = plan.widths[-3]
        last = scratch[(plan.n_hidden - 1) % 2].reshape(-1)[:M * N]
        return scores, last.view(M, N)

    def stacked(frames, folded, regime):
        """Scores of a call on (M, 12) frames and one chain, or on (C, M,
        12) frames and a stacked fold, through the f32 launcher or the
        bf16 one as the chain's dtype says."""
        plan = K.encoder_plan(folded)
        C = plan.configs[0] if plan.configs else 1
        M = frames.shape[-2]
        scratch = torch.full((2, C, M, plan.max_n), float("nan"),
                             dtype=plan.dtype)
        scores = torch.full((*plan.configs, M, plan.widths[-1]),
                            float("nan"))
        fn = f32_fn if plan.dtype == torch.float32 else bf16_fn
        assert fn(plan.table, plan.dims, plan.n_hidden, frames.data_ptr(),
                  scratch.data_ptr(), scores.data_ptr(), M, C, plan.S,
                  regime, None) == 0
        return scores

    run.stacked = stacked
    return run


def small_chain(widths, S, seed):
    """A bf16 chain of the given hidden widths (the first K = 12), d_e
    16, 41 classes, with per-session affines of S sessions."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    folded = []
    for k, n in zip(widths[:-1], widths[1:]):
        folded += [t(rng.uniform(-1, 1, (k, n)) / np.sqrt(k)).to(BF16),
                   t(rng.normal(0, 0.1, n))]
    folded += [t(rng.uniform(-1, 1, (widths[-1], 16)) / np.sqrt(widths[-1])
                 ).to(BF16), t(rng.normal(0, 0.1, 16)),
               t(rng.standard_normal((16, 41)) / 4).to(BF16)]
    affines = []
    for n in widths[1:]:
        affines += [t(rng.uniform(0.5, 1.5, (S, n))),
                    t(rng.normal(0, 0.2, (S, n)))]
    return tuple(folded), tuple(affines)


# hidden widths: K = 12 (one k16 chunk, 4 of it zero-filled), then widths
# that are ragged against both tilings' 8- and 128-column tiles and the
# large tiling's 32-wide k stages
WIDTHS = (12, 136, 48, 40)


@pytest.mark.parametrize("M,regime,with_affines", [
    (1, 0, False), (13, 0, True), (39, 0, False), (130, 1, True),
    (300, 1, False)])
def test_emulated_kernels_against_the_model_and_plain_version(
        launch, M, regime, with_affines):
    folded, affines = small_chain(WIDTHS, S=13 if M % 13 == 0 else 1,
                                  seed=M)
    affines = affines if with_affines else None
    frames = np.random.default_rng(M + 1).standard_normal((M, 12)).astype(
        np.float32) * 2
    scores, last = launch(torch.from_numpy(frames), folded, affines, regime)
    # the last hidden layer's bf16 scratch: the model's bits (compared as
    # values, so a ReLU's -0 and +0 are equal)
    np.testing.assert_array_equal(last.float().numpy(),
                                  hidden_bf16(frames, folded, affines))
    # the head's f32 sums in the lanes' order against exact ones
    np.testing.assert_allclose(scores.numpy(),
                               chain_bf16(frames, folded, affines),
                               rtol=1e-6, atol=1e-6)
    want = K.fused_encoder_logits_reference(torch.from_numpy(frames), folded,
                                            affines)
    assert float((scores - want).abs().max()) < ATOL


def test_emulated_rows_have_the_same_bits_in_both_tilings_and_at_any_m(
        launch):
    folded, affines = small_chain(WIDTHS, S=1, seed=7)
    frames = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (150, 12)).astype(np.float32))
    full_large, _ = launch(frames, folded, None, 1)
    full_small, _ = launch(frames, folded, None, 0)
    part_small, _ = launch(frames[:21], folded, None, 0)
    part_large, _ = launch(frames[:21], folded, None, 1)
    for got in (full_small, part_small, part_large):
        assert torch.equal(got.view(torch.int32),
                           full_large[:len(got)].view(torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("M,regime", [(21, 0), (150, 1)])
def test_emulated_config_axis_is_each_configs_call(launch, M, regime, dtype):
    """3 configs' chains (stacked folds, no affines) in one call of
    ``encoder_chain_launch`` or its bf16 variant, every layer and the head
    one launch with the grid's config dimension: config c's scores
    bit-equal to a call on its fold alone, and the whole within the
    plain version's tolerance of its config-axis plain version."""
    chains = [small_chain(WIDTHS, S=1, seed=30 + c)[0] for c in range(3)]
    if dtype == torch.float32:
        chains = [tuple(a.float() for a in ch) for ch in chains]
    folded = tuple(torch.stack(parts) for parts in zip(*chains))
    frames = torch.from_numpy(np.random.default_rng(M).standard_normal(
        (3, M, 12)).astype(np.float32) * 2)
    got = launch.stacked(frames, folded, regime)
    assert got.shape == (3, M, 41)
    for c in range(3):
        one = launch.stacked(frames[c], chains[c], regime)
        assert torch.equal(got[c].view(torch.int32), one.view(torch.int32))
    want = K.fused_encoder_logits_reference(frames, folded)
    tol = ATOL if dtype == BF16 else 2e-5
    assert float((got - want).abs().max()) < tol


# ------------------------------------------------------ host-side logic
def test_the_bf16_source_uses_the_bf16_mma_and_the_f32_tiles():
    src = (K._build.SRC_DIR / "encoder_chain.cu").read_text()
    assert '#include "bf16_mma.cuh"' in src
    head = (K._build.SRC_DIR / "bf16_mma.cuh").read_text()
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in head
    assert "cvt.rn.bf16x2.f32" in head
    assert 'extern "C" int encoder_chain_bf16_launch(' in src
    # the same row tiles as the f32 kernels: a row sits at r % 16
    assert "constexpr int kBM = 128, kBN = 128, kBK = 32;" in src
    assert "constexpr int kSM = 16, kSN = 8" in src


def test_bf16_regime_has_its_own_threshold():
    thr = K.ENCODER_SMALL_ROWS_BF16
    assert thr < K.ENCODER_SMALL_ROWS
    assert [K.encoder_regime(M, BF16) for M in (1, 200, thr)] == [0] * 3
    assert [K.encoder_regime(M, BF16) for M in (thr + 1, 640, 32768)] \
        == [1] * 3
    assert K.encoder_regime(640) == 0 and K.encoder_regime(641) == 1


def test_bf16_chain_plan_and_launch_count_name():
    model = ContrastiveModel(generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        folded = K.fold_encoder_params(model.emg_net, model.encode_classes(),
                                       dtype=BF16)
    plan = K.encoder_plan(folded)
    assert plan.dtype == BF16
    assert plan.widths == (12, 768, 768, 512, 512, 512, 512, 512, 512, 512,
                           16, 41)
    assert K.encoder_plan(tuple(t.float() for t in folded)).dtype \
        == torch.float32
    assert "encoder_chain_bf16" in K.launch_counts
    K.reset_launch_counts()
    # on CPU tensors the plain version runs: no launch is counted
    K.fused_encoder_logits(torch.zeros(3, 12), folded)
    assert not any(K.launch_counts.values())


def _replace(chain, i, t):
    return chain[:i] + (t,) + chain[i + 1:]


@pytest.mark.parametrize("case,match", [
    ("f32 weight in a bf16 chain", "w1: dtype torch.float32"),
    ("bf16 bias", "b0: dtype torch.bfloat16"),
    ("f32 Gt in a bf16 chain", "gt: dtype torch.float32"),
    ("float16 chain", "w0: dtype torch.float16"),
    ("width not a multiple of 8", "multiples of 8"),
    ("misaligned", "16-byte aligned"),
    ("f32 affines wanted", "a0: dtype torch.bfloat16"),
])
def test_bf16_plan_rejects_what_the_kernels_do_not_take(case, match):
    folded, affines = small_chain((12, 64, 40), S=2, seed=1)
    if case == "f32 weight in a bf16 chain":
        folded = _replace(folded, 2, folded[2].float())
    elif case == "bf16 bias":
        folded = _replace(folded, 1, folded[1].to(BF16))
    elif case == "f32 Gt in a bf16 chain":
        folded = _replace(folded, len(folded) - 1, folded[-1].float())
    elif case == "float16 chain":
        folded = tuple(t.half() if t.dtype == BF16 else t for t in folded)
    elif case == "width not a multiple of 8":  # 12 -> 60: rows of 120 B
        folded = _replace(_replace(folded, 0, folded[0][:, :60].contiguous()),
                          1, folded[1][:60].contiguous())
        folded = _replace(folded, 2, folded[2][:60].contiguous())
    elif case == "misaligned":  # a 2-byte offset into the same storage
        w = folded[2]
        folded = _replace(folded, 2, torch.empty(w.numel() + 1, dtype=BF16)[
            1:].view(w.shape).copy_(w))
    else:
        affines = (affines[0].to(BF16),) + affines[1:]
    with pytest.raises(ValueError, match=match):
        K.encoder_plan(folded, affines if case.startswith("f32 aff") else None)
