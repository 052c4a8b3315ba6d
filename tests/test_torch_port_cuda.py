"""PyTorch port: each CUDA kernel against its plain PyTorch version, on the
card (``contrastiveprosthetics_torch.ops.kernels``).

Every test here is marked ``cuda`` and skips without a CUDA device. The
file imports neither JAX nor the JAX package, so it also runs on a GPU
machine without them (``--noconftest`` skips the suite's JAX set-up):

    python -m pytest tests/test_torch_port_cuda.py -m cuda --noconftest -q
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from contrastiveprosthetics_torch.models.clip import ContrastiveModel
from contrastiveprosthetics_torch.ops import kernels as K
from contrastiveprosthetics_torch.ops import train_fused as TF
from contrastiveprosthetics_torch.ops.signal import butter_bandpass_sos

torch.set_num_threads(1)

SCORE_TOL = dict(rtol=2e-4, atol=2e-5)  # f32 sums in another order
C, D, W, FACTOR = 41, 12, 25, 20

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _carry(rng, S, device):
    """A carry mid-stream: live IIR registers and tail, a part-full vote
    window."""
    parts = (rng.standard_normal((S, 4, 2, D)).astype(np.float32) * 100,
             rng.standard_normal((S, 10, D)).astype(np.float32) * 300,
             rng.integers(0, C, (S, W)).astype(np.int32),
             rng.integers(0, W, S).astype(np.int32))
    return [torch.from_numpy(p).to(device) for p in parts]


# (K, S) of each serve path: the per-tick step, the 200-tick steps replay,
# the batched replay, and ragged session counts
SERVE_SHAPES = [(1, 1), (200, 1), (25, 32768), (5, 37), (7, 3)]


def _dsp_inputs(rng, n_ticks, S, device):
    iir, tail, _, _ = _carry(rng, S, device)
    blocks = torch.from_numpy((rng.standard_normal(
        (n_ticks, S, FACTOR, D)) * 2).astype(np.float32)).to(device)
    sos = torch.from_numpy(butter_bandpass_sos(20, 450, 2000)).float().to(
        device)
    mean = torch.from_numpy(rng.normal(0, 0.5, D).astype(np.float32))
    std = torch.from_numpy(rng.uniform(0.5, 2.0, D).astype(np.float32))
    return iir, tail, blocks, sos, mean.to(device), std.to(device)


@pytest.mark.parametrize("n_ticks,S", SERVE_SHAPES)
def test_dsp_frames_kernel_matches_plain(cuda, n_ticks, S):
    rng = np.random.default_rng(7 + S)
    args = _dsp_inputs(rng, n_ticks, S, cuda)
    before = K.launch_counts["dsp_frames"]
    got = K.dsp_frames(*args)
    want = K.dsp_frames_reference(*args)
    torch.cuda.synchronize()
    assert K.launch_counts["dsp_frames"] == before + 1
    # the kernel repeats the plain version's operation order, each step
    # rounded, so the two agree bit for bit
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_dsp_frames_refuses_other_shapes_before_launch(cuda):
    """The kernel is compiled for (n_sec, factor, rms_window, D) = (4, 20,
    11, 12) and takes 16-byte aligned blocks: anything else raises before a
    launch, never falls back to the plain version."""
    rng = np.random.default_rng(3)
    iir, tail, blocks, sos, mean, std = _dsp_inputs(rng, 2, 3, cuda)
    before = K.launch_counts["dsp_frames"]
    for bad in ((iir[:, :3].contiguous(), tail, blocks, sos[:3], mean, std),
                (iir, tail, blocks[:, :, :10].contiguous(), sos, mean, std),
                (iir, tail[:, :8].contiguous(), blocks, sos, mean, std)):
        with pytest.raises(ValueError, match="compiled for"):
            K.dsp_frames(*bad)
    misaligned = torch.zeros(blocks.numel() + 1, device=cuda)[1:].view(
        blocks.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        K.dsp_frames(iir, tail, misaligned, sos, mean, std)
    assert K.launch_counts["dsp_frames"] == before


def _encoder_chains(device, width, S):
    """A seeded model's folded chain, its shared chain and per-session
    affines of S sessions, at full width or narrow (2 dense layers of 64)."""
    kw = {} if width == "full" else dict(n_linear=2, hidden=64)
    model = ContrastiveModel(**kw, generator=torch.Generator().manual_seed(1))
    model = model.to(device).eval()
    ramp = torch.arange(S, device=device)[:, None] / S
    with torch.no_grad():
        emb = model.encode_classes()
        stats = [(bn.running_mean.expand(S, -1) * 0.5 + 0.1 * ramp,
                  bn.running_var.expand(S, -1) * (1.5 + ramp))
                 for bn in model.emg_net.norms()]
        return (K.fold_encoder_params(model.emg_net, emb),
                K.fold_encoder_params_shared(model.emg_net, emb),
                K.session_bn_affines(model.emg_net, stats))


def _frames(device, M, seed=0):
    return torch.randn(M, D, device=device,
                       generator=torch.Generator(device).manual_seed(seed))


@pytest.mark.parametrize("width", ["narrow", "full"])
@pytest.mark.parametrize("with_affines", [False, True])
def test_encoder_chain_kernel_matches_plain(cuda, with_affines, width):
    """At M = 1, 16, 200, the regime threshold -+ 1 and 32,768 rows (with
    affines: one tick of M sessions, so S is ragged against both row
    tiles): within the tolerance of the plain version, one launch per
    layer and the head, a rerun bit-identical, and each call's first rows
    bit-identical to the smaller call before it, across the switch from
    the small-row to the large tiling."""
    thr = K.ENCODER_SMALL_ROWS
    ladder = sorted({1, 16, 200, thr - 1, thr + 1, 32768})
    folded, shared, affines = _encoder_chains(cuda, width, ladder[-1])
    frames = _frames(cuda, ladder[-1])
    launches = (len(folded) - 1) // 2  # hidden layers and the head
    prev = None
    for M in ladder:
        chain, aff = ((shared, tuple(a[:M] for a in affines)) if with_affines
                      else (folded, None))
        before = K.launch_counts["encoder_chain"]
        got = K.fused_encoder_logits(frames[:M], chain, aff)
        want = K.fused_encoder_logits_reference(frames[:M], chain, aff)
        torch.cuda.synchronize()
        assert K.launch_counts["encoder_chain"] == before + launches
        torch.testing.assert_close(got, want, **SCORE_TOL)
        assert torch.equal(K.fused_encoder_logits(frames[:M], chain, aff),
                           got)
        if prev is not None:
            assert torch.equal(got[:len(prev)], prev)
        prev = got


@pytest.mark.parametrize("S,ticks", [(37, 3), (37, 11), (6, 11), (256, 2)])
def test_encoder_chain_both_tilings_agree_on_ragged_sessions(cuda, S, ticks):
    """Ticks of S sessions, S ragged against the 16- and 128-row tiles (or
    whole session blocks, 256): both tilings give the plain version's
    scores and the same bits, and the first tick's rows equal a one-tick
    call."""
    _, shared, affines = _encoder_chains(cuda, "narrow", S)
    frames = _frames(cuda, S * ticks, seed=S)
    plan = K.encoder_plan(shared, affines)
    small = K.encoder_chain(frames, plan, 0)
    large = K.encoder_chain(frames, plan, 1)
    want = K.fused_encoder_logits_reference(frames, shared, affines)
    torch.cuda.synchronize()
    torch.testing.assert_close(small, want, **SCORE_TOL)
    assert torch.equal(small, large)
    assert torch.equal(K.fused_encoder_logits(frames[:S], shared, affines),
                       small[:S])


def _bf16(chain):
    """A fold's weights and Gt in bf16 (the biases stay f32)."""
    return tuple(t.to(torch.bfloat16) if i % 2 == 0 or i == len(chain) - 1
                 else t for i, t in enumerate(chain))


@pytest.mark.parametrize("width", ["narrow", "full"])
@pytest.mark.parametrize("with_affines", [False, True])
def test_encoder_chain_bf16_kernel_matches_plain(cuda, with_affines, width):
    """The bf16 variant at M = 1, 16, 200, its regime threshold -+ 1 and
    32,768 rows: within atol 0.05 of the plain bf16 version (chip_smoke.py's
    BF16_ATOL: the same bf16 roundings, f32 sums in another order), only
    the bf16 variant launched, one launch per layer and the head, a rerun
    and each smaller call's rows bit-identical, and both tilings the same
    bits."""
    thr = K.ENCODER_SMALL_ROWS_BF16
    ladder = sorted({1, 16, 200, thr - 1, thr + 1, 32768})
    folded, shared, affines = _encoder_chains(cuda, width, ladder[-1])
    folded, shared = _bf16(folded), _bf16(shared)
    frames = _frames(cuda, ladder[-1])
    launches = (len(folded) - 1) // 2
    prev = None
    for M in ladder:
        chain, aff = ((shared, tuple(a[:M] for a in affines)) if with_affines
                      else (folded, None))
        before = dict(K.launch_counts)
        got = K.fused_encoder_logits(frames[:M], chain, aff)
        want = K.fused_encoder_logits_reference(frames[:M], chain, aff)
        torch.cuda.synchronize()
        assert K.launch_counts["encoder_chain_bf16"] == \
            before["encoder_chain_bf16"] + launches
        assert K.launch_counts["encoder_chain"] == before["encoder_chain"]
        torch.testing.assert_close(got, want, rtol=0, atol=5e-2)
        assert torch.equal(K.fused_encoder_logits(frames[:M], chain, aff),
                           got)
        if prev is not None:
            assert torch.equal(got[:len(prev)], prev)
        prev = got
        plan = K.encoder_plan(chain, aff)
        assert torch.equal(K.encoder_chain(frames[:M], plan, 0),
                           K.encoder_chain(frames[:M], plan, 1))


def test_encoder_chain_rejects_bad_inputs(cuda):
    """A misaligned, non-contiguous or ragged input raises before any
    launch, never faults or falls back."""
    folded, shared, affines = _encoder_chains(cuda, "narrow", 6)
    before = K.launch_counts["encoder_chain"]
    misaligned = torch.zeros(17 * D + 1, device=cuda)[1:].view(17, D)
    with pytest.raises(ValueError, match="16-byte aligned"):
        K.fused_encoder_logits(misaligned, folded)
    with pytest.raises(ValueError, match="contiguous"):
        K.fused_encoder_logits(torch.zeros((D, 17), device=cuda).T, folded)
    with pytest.raises(ValueError, match="whole ticks"):
        K.fused_encoder_logits(_frames(cuda, 13), shared, affines)
    with pytest.raises(ValueError, match="want cpu"):
        K.fused_encoder_logits(_frames(cuda, 6), tuple(t.cpu() for t in folded))
    assert K.launch_counts["encoder_chain"] == before


@pytest.mark.parametrize("n_ticks,S", SERVE_SHAPES + [(30, 300)])
@pytest.mark.parametrize("masked", [False, True])
def test_vote_scan_kernel_matches_plain(cuda, n_ticks, S, masked):
    """Tied scores (a coarse grid), mid-warm-up carries, an all-class and a
    one-class mask: preds, votes, window and n_seen exact, one launch, and
    the masked scores bit for bit where asked."""
    rng = np.random.default_rng(8 + S)
    _, _, votes, n_seen = _carry(rng, S, cuda)
    scores = torch.from_numpy((rng.integers(-8, 9, (n_ticks, S, C)) / 8
                               ).astype(np.float32)).to(cuda)
    masks = rng.random((S, C)) < 0.6
    masks[0] = True
    if S > 1:
        masks[1] = False
        masks[1, 17] = True
    masks = torch.from_numpy(masks).to(cuda)
    before = K.launch_counts["vote_scan"]
    got = K.vote_scan(scores, masks, votes, n_seen, masked=masked)
    want = K.vote_scan_reference(scores, masks, votes, n_seen, masked=masked)
    torch.cuda.synchronize()
    assert K.launch_counts["vote_scan"] == before + 1
    assert len(got) == len(want) == 4 + masked
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    if masked:
        assert torch.equal(got[4].view(torch.int32), want[4].view(torch.int32))


def test_wrappers_reject_bad_inputs(cuda):
    scores = torch.zeros((2, 3, C), device=cuda)
    masks = torch.ones((3, C), dtype=torch.bool, device=cuda)
    votes = torch.zeros((3, W), dtype=torch.int32, device=cuda)
    n_seen = torch.zeros(3, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        K.vote_scan(scores, masks, votes.long(), n_seen)
    with pytest.raises(ValueError, match="contiguous"):
        K.vote_scan(scores.transpose(0, 1).contiguous().transpose(0, 1),
                    masks, votes, n_seen)


def _normalized(rng, shape, device):
    x = rng.standard_normal(shape).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    return torch.from_numpy(x).to(device)


@pytest.mark.parametrize("N", [8, 3])
def test_contrastive_loss_kernels_match_plain(cuda, N):
    """K1f and K1b against their plain versions at the train step's T=41,
    d=16: the canonical batch of 8 and a ragged 3 (a tail batch)."""
    rng = np.random.default_rng(N)
    e = _normalized(rng, (N, 41, 16), cuda).requires_grad_()
    g = _normalized(rng, (N, 41, 16), cuda).requires_grad_()
    before = dict(K.launch_counts)
    loss, correct = K.fused_contrastive_loss(e, g)
    de, dg = torch.autograd.grad(loss * 1.5, (e, g))
    assert K.launch_counts["contrastive_loss_fwd"] == (
        before["contrastive_loss_fwd"] + 1)
    assert K.launch_counts["contrastive_loss_bwd"] == (
        before["contrastive_loss_bwd"] + 1)
    loss_p, correct_p = K.fused_contrastive_reference(e, g)
    de_p, dg_p = torch.autograd.grad(loss_p * 1.5, (e, g))
    torch.testing.assert_close(loss, loss_p, rtol=1e-5, atol=0)
    assert float(correct) == float(correct_p)
    # the tolerance of the JAX package's own VJP test (test_pallas.py)
    torch.testing.assert_close(de, de_p, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(dg, dg_p, rtol=1e-4, atol=1e-6)
    with torch.no_grad():
        up = torch.tensor(1.5, device=cuda)
        de_w, dg_w = K.contrastive_loss_bwd_reference(e, g, up)
        torch.testing.assert_close(de, de_w, rtol=1e-4, atol=1e-6)
        torch.testing.assert_close(dg, dg_w, rtol=1e-4, atol=1e-6)
        # no float atomics: a second run gives the same bits
        again = K.contrastive_loss_fwd(e.detach(), g.detach())
        assert torch.equal(again[0], loss) and torch.equal(again[1], correct)
        de2, dg2 = K.contrastive_loss_bwd(e.detach(), g.detach(), up)
        assert torch.equal(de2, de) and torch.equal(dg2, dg)


def test_contrastive_loss_config_axis(cuda):
    """The sweep's shape, (C, N, T, d) = (150, 8, 41, 16): loss and count
    (C,) against the plain version, gradients with one upstream scalar per
    config; every config has the same bits alone (C = 1) as inside the
    batch of 150, and a rerun has the same bits."""
    rng = np.random.default_rng(150)
    e = _normalized(rng, (150, 8, 41, 16), cuda).requires_grad_()
    g = _normalized(rng, (150, 8, 41, 16), cuda).requires_grad_()
    up = torch.from_numpy(rng.uniform(0.5, 2.0, 150).astype(np.float32)).to(cuda)
    loss, correct = K.fused_contrastive_loss(e, g)
    assert loss.shape == correct.shape == (150,)
    de, dg = torch.autograd.grad((loss * up).sum(), (e, g))
    loss_p, correct_p = K.fused_contrastive_reference(e, g)
    torch.testing.assert_close(loss, loss_p, rtol=1e-5, atol=0)
    assert torch.equal(correct, correct_p)
    with torch.no_grad():
        de_w, dg_w = K.contrastive_loss_bwd_reference(e, g, up)
        torch.testing.assert_close(de, de_w, rtol=1e-4, atol=1e-6)
        torch.testing.assert_close(dg, dg_w, rtol=1e-4, atol=1e-6)
        e, g = e.detach(), g.detach()
        again = K.contrastive_loss_fwd(e, g) + K.contrastive_loss_bwd(e, g, up)
        for a, b in zip((loss, correct, de, dg), again):
            assert torch.equal(a, b)
        for c in range(150):
            l1, c1 = K.contrastive_loss_fwd(e[c:c + 1], g[c:c + 1])
            de1, dg1 = K.contrastive_loss_bwd(e[c:c + 1], g[c:c + 1],
                                              up[c:c + 1])
            assert torch.equal(l1[0], loss[c]) and torch.equal(c1[0],
                                                              correct[c])
            assert torch.equal(de1[0], de[c]) and torch.equal(dg1[0], dg[c])
        # the 3-d call is C = 1 with 0-d results
        l3, c3 = K.contrastive_loss_fwd(e[7], g[7])
        assert l3.shape == c3.shape == ()
        assert torch.equal(l3, loss[7]) and torch.equal(c3, correct[7])


@pytest.fixture(scope="module")
def one_person_store():
    from contrastiveprosthetics_torch.config import DEFAULT_CONFIG
    from contrastiveprosthetics_torch.data.synthetic import (
        make_processed_dataset,
    )

    return make_processed_dataset(DEFAULT_CONFIG, people_positions=[40],
                                  seed=3)


@pytest.mark.parametrize("C", [3, 150])
def test_stacked_step_with_k1_matches_the_plain_loss(cuda, one_person_store,
                                                     monkeypatch, C):
    """One stacked step of C configs at full width (the crossval sweep's
    step, K1 once at (C, 8, 41, 16)) against the same step with the plain
    loss, from the same weights and batch: losses, accuracies and every
    gradient at the K1 tolerances (the forward is the same launches in
    both, so no ReLU mask moves)."""
    import copy

    from contrastiveprosthetics_torch.config import DEFAULT_CONFIG
    from contrastiveprosthetics_torch.data import sampler
    from contrastiveprosthetics_torch.data.store import DeviceStore
    from contrastiveprosthetics_torch.train import engine

    trainer = engine.Trainer(DEFAULT_CONFIG, DeviceStore(
        DEFAULT_CONFIG, *one_person_store, device=cuda), adabn=False)
    gens = [trainer.generator(i) for i in range(C)]
    state = trainer.init_sweep_state(gens)
    v = trainer.view_train
    emg_rand = sampler.stacked_task_permutations(gens, v.n_tasks, v.D)
    batches, _ = sampler.stacked_epoch_batches(gens, v.D, 8)
    emg_b = sampler.stacked_gather_train_batch(v.emg_flat, emg_rand,
                                               batches[:, 0])
    rng = np.random.default_rng(C)
    h = engine.Hyper(*[torch.from_numpy(np.float32(10) ** rng.uniform(
        lo, hi, C).astype(np.float32)).to(cuda) for lo, hi in
        ((-4, -2), (-6, -2), (-9, -8), (-4, -2), (-6, -2), (-9, -8))])
    h = h._replace(dp_emg=torch.zeros(C, device=cuda))
    out = {}
    for name, fn in (("kernel", K.fused_contrastive_loss),
                     ("plain", K.fused_contrastive_reference)):
        monkeypatch.setattr(engine, "fused_contrastive_loss", fn)
        before = dict(K.launch_counts)
        out[name] = trainer.loss_and_grads(
            engine.TrainState.fresh(copy.deepcopy(state.model)), emg_b, h,
            None)
        torch.cuda.synchronize()
        launched = {k: K.launch_counts[k] - before[k] for k in
                    ("contrastive_loss_fwd", "contrastive_loss_bwd")}
        assert set(launched.values()) == {1 if name == "kernel" else 0}
    (loss, acc, grads), (loss_p, acc_p, grads_p) = out["kernel"], out["plain"]
    assert loss.shape == acc.shape == (C,)
    torch.testing.assert_close(loss, loss_p, rtol=1e-5, atol=0)
    assert torch.equal(acc, acc_p)
    for tower in grads:
        for a, b in zip(grads[tower], grads_p[tower]):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


def test_contrastive_loss_rejects_what_it_does_not_take(cuda):
    """The CUDA wrapper raises, never falls back to the plain version."""
    rng = np.random.default_rng(0)
    e = _normalized(rng, (2, 65, 16), cuda)
    with pytest.raises(ValueError, match="T, d in"):
        K.fused_contrastive_loss(e, e)
    e = _normalized(rng, (2, 41, 16), cuda)
    with pytest.raises(ValueError, match="dtype"):
        K.fused_contrastive_loss(e.double(), e.double())
    with pytest.raises(ValueError, match="contiguous"):
        K.fused_contrastive_loss(e.transpose(0, 1).contiguous().transpose(0, 1),
                                 e)
    before = dict(K.launch_counts)
    with pytest.raises(ValueError, match="on cpu"):
        K.fused_contrastive_loss(e, e.cpu())
    with pytest.raises(ValueError, match="want"):
        K.fused_contrastive_loss(e[None, None], e[None, None])
    with pytest.raises(ValueError, match="shape"):
        K.fused_contrastive_loss(e[None], e)
    with pytest.raises(ValueError, match="N in"):
        K.fused_contrastive_loss(e[:0][None], e[:0][None])
    with pytest.raises(ValueError, match="dloss"):
        K.contrastive_loss_bwd(e[None].expand(3, -1, -1, -1).contiguous(),
                               e[None].expand(3, -1, -1, -1).contiguous(),
                               torch.ones(2, device=cuda))
    assert K.launch_counts == before


# ------------------------------------------------- the fused training chain
def _block_case(N, K_in, F=512, seed=0, dev="cuda"):
    """One dense block's inputs at the chain's widths: a ReLU output as
    input, the previous block's statistics, Linear-scaled weights, and the
    gradients arriving from above."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    x = t(np.maximum(rng.standard_normal((N, K_in)), 0.0))
    mean = t(rng.uniform(0.2, 0.6, K_in))
    var = t(rng.uniform(0.2, 0.5, K_in))
    rstd = torch.rsqrt(var + 1e-5)
    a = t(rng.uniform(0.8, 1.2, K_in)) * rstd
    in_stats = torch.stack([mean, var, rstd, a, t(rng.normal(0, 0.1, K_in))
                            - mean * a])
    w = t(rng.uniform(-1, 1, (K_in, F)) / np.sqrt(K_in))
    vecs = [t(rng.normal(0, 0.1, F)), t(rng.uniform(0.8, 1.2, F)),
            t(rng.normal(0, 0.1, F))]
    dz = t(rng.standard_normal((N, F)) * 0.01)
    seed_words = torch.tensor([int(v) for v in rng.integers(-2**31, 2**31,
                                                            2)],
                              dtype=torch.int32, device=dev)
    return x, w, vecs, in_stats, dz, seed_words


def _close(got, want, rtol=1e-4, scale_atol=1e-5):
    atol = scale_atol * max(float(want.abs().max()), 1e-3)
    torch.testing.assert_close(got.to(want.dtype), want, rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("N", [328, 123])
@pytest.mark.parametrize("K_in,inner", [(768, False), (512, True)])
def test_dense_block_kernels_match_plain(cuda, N, K_in, inner):
    """K5f and K5b against their plain versions at the train step's N = 328
    rows and a ragged 123: block 0's form (768 inputs, no affine, no
    dropout) and an inner dropped block's (512 inputs, the previous
    block's affine and drawn dropout at rate 0.5). A rerun gives the same
    bits."""
    x, w, (b, gamma, beta), in_stats, dz, seed = _block_case(N, K_in)
    kw, in_st = {}, None
    if inner:
        kw = dict(seed=seed, keep=torch.full((1,), 0.5, device=cuda),
                  drop_block=3)
        in_st = in_stats
    before = dict(K.launch_counts)
    r, stats = TF.dense_block_fwd(x, w, b, gamma, beta, in_st, **kw)
    r_p, stats_p = TF.dense_block_fwd_reference(x, w, b, gamma, beta, in_st,
                                                **kw)
    sums = torch.stack([dz.sum(0), (dz * (r_p - stats_p[0])
                                    * stats_p[2]).sum(0)])
    got = TF.dense_block_bwd(dz, r_p, x, w, stats_p, sums, in_st, **kw)
    want = TF.dense_block_bwd_reference(dz, r_p, x, w, stats_p, sums, in_st,
                                        **kw)
    torch.cuda.synchronize()
    assert K.launch_counts["dense_block_fwd"] == before["dense_block_fwd"] + 1
    assert K.launch_counts["dense_block_bwd"] == before["dense_block_bwd"] + 1
    # f32 sums over 512-768 products in another order than cuBLAS's
    _close(r, r_p, rtol=1e-5)
    _close(stats, stats_p)
    for g, wnt in zip(got, want):
        if wnt is None:
            assert g is None
        else:
            _close(g, wnt)
    assert torch.equal(TF.dense_block_fwd(x, w, b, gamma, beta, in_st,
                                          **kw)[0], r)
    again = TF.dense_block_bwd(dz, r_p, x, w, stats_p, sums, in_st, **kw)
    for g, a in zip(got, again):
        assert g is None or torch.equal(g, a)


def _max_err(got, want):
    return float((got.double() - want.double()).abs().max())


@pytest.mark.parametrize("tiling", [0, 1])
@pytest.mark.parametrize("K_in", [512, 768])
@pytest.mark.parametrize("N", [17, 123, 328, 1000])
def test_dense_block_kernels_match_float64(cuda, N, K_in, tiling):
    """K5f and K5b in 3xTF32 on an inner dropped block (the previous
    block's affine, drawn dropout at rate 0.5), every tiling, against the
    plain version evaluated in float64, at the tolerances they are held to
    against the plain f32 version, and no further from float64 than twice
    the plain f32 version's distance (plus 1e-6 of the largest value).
    Reruns give the same bits, and so do the drawn masks replayed by
    ``dropout_masks`` and fed back in."""
    x, w, (b, gamma, beta), in_stats, dz, seed = _block_case(N, K_in,
                                                             seed=N + K_in)
    keep = torch.full((1,), 0.5, device=cuda)
    kw = dict(seed=seed, keep=keep, drop_block=3)
    r, stats = TF.dense_block_fwd(x, w, b, gamma, beta, in_stats, tiling=tiling,
                                  **kw)
    r_p, st_p = TF.dense_block_fwd_reference(x, w, b, gamma, beta, in_stats,
                                             **kw)
    d = [t.double() for t in (x, w, b, gamma, beta, in_stats)]
    r64, st64 = TF.dense_block_fwd_reference(*d, seed=seed,
                                             keep=keep.double(), drop_block=3)
    sums = torch.stack([dz.sum(0), (dz * (r_p - st_p[0]) * st_p[2]).sum(0)])
    got = TF.dense_block_bwd(dz, r_p, x, w, st_p, sums, in_stats,
                             tiling=tiling, **kw)
    plain = TF.dense_block_bwd_reference(dz, r_p, x, w, st_p, sums, in_stats,
                                         **kw)
    want = TF.dense_block_bwd_reference(
        dz.double(), r_p.double(), d[0], d[1], st_p.double(), sums.double(),
        d[5], seed=seed, keep=keep.double(), drop_block=3)
    torch.cuda.synchronize()
    _close(r, r64, rtol=1e-5)
    _close(stats, st64)
    for g, wnt in zip(got, want):
        if wnt is not None:
            _close(g, wnt)
    # the GEMM outputs: r, dx, dW (the sums are taken in f32 in row-tile
    # order, the plain version's in float64)
    for g, p, wnt in ((r, r_p, r64), (got[0], plain[0], want[0]),
                      (got[1], plain[1], want[1])):
        bound = 2 * _max_err(p, wnt) + 1e-6 * float(wnt.abs().max())
        assert _max_err(g, wnt) <= bound
    again = (*TF.dense_block_fwd(x, w, b, gamma, beta, in_stats,
                                 tiling=tiling, **kw),
             *TF.dense_block_bwd(dz, r_p, x, w, st_p, sums, in_stats,
                                 tiling=tiling, **kw))
    mask = TF.dropout_masks(seed, keep, N, K_in, 3)
    fed = dict(keep=keep, mask=mask, tiling=tiling)
    replayed = (*TF.dense_block_fwd(x, w, b, gamma, beta, in_stats, **fed),
                *TF.dense_block_bwd(dz, r_p, x, w, st_p, sums, in_stats,
                                    **fed))
    for g, a, m in zip((r, stats, *got), again, replayed):
        assert g is None or (torch.equal(g, a) and torch.equal(g, m))


def test_dense_block_tilings_agree_on_r_dx_and_dw(cuda):
    """Both tilings walk the same k8 chunks in the same order, so r, dx and
    dW have the same bits (the column sums are taken over other row tiles
    and may differ in the last place)."""
    x, w, (b, gamma, beta), in_stats, dz, seed = _block_case(328, 512)
    kw = dict(seed=seed, keep=torch.full((1,), 0.5, device=cuda),
              drop_block=3)
    tilings = range(len(TF.FWD_TILES))
    fwd = [TF.dense_block_fwd(x, w, b, gamma, beta, in_stats, tiling=t, **kw)
           for t in tilings]
    r, st = fwd[0]
    sums = torch.stack([dz.sum(0), dz.sum(0)])
    bwd = [TF.dense_block_bwd(dz, r, x, w, st, sums, in_stats, tiling=t, **kw)
           for t in tilings]
    for t in tilings:
        assert torch.equal(fwd[t][0], r)
        assert torch.equal(bwd[t][0], bwd[0][0])
        assert torch.equal(bwd[t][1], bwd[0][1])


def test_transposed_weight_gives_transposed_gradient(cuda):
    """A Linear weight's ``.T`` goes in without a copy, and dW comes back
    laid out as that weight."""
    x, w, (b, gamma, beta), _, dz, _ = _block_case(64, 512, F=256)
    wt = w.T.contiguous().T
    r, stats = TF.dense_block_fwd(x, wt, b, gamma, beta)
    assert torch.equal(r, TF.dense_block_fwd(x, w, b, gamma, beta)[0])
    sums = torch.stack([dz.sum(0), dz.sum(0)])
    dx, dw, db, _ = TF.dense_block_bwd(dz, r, x, wt, stats, sums)
    dx2, dw2, db2, _ = TF.dense_block_bwd(dz, r, x, w, stats, sums)
    assert dw.stride() == wt.stride() and torch.equal(dw, dw2)
    assert torch.equal(dx, dx2) and torch.equal(db, db2)


@pytest.mark.parametrize("N", [328, 123])
def test_dropout_masks_kernel_matches_plain(cuda, N):
    seed = torch.tensor([123456789, -98765], dtype=torch.int32, device=cuda)
    for keep, block in ((0.5, 6), (0.7, 3), (1.0, 4)):
        kt = torch.full((1,), keep, device=cuda)
        got = TF.dropout_masks(seed, kt, N, 512, block)
        want = TF.dropout_masks_reference(seed, kt, N, 512, block)
        assert torch.equal(got, want)
        if keep == 1.0:
            assert bool((got == 1).all())
        else:
            assert abs(float(got.mean()) - keep) < 0.02


def test_prng_chain_equals_input_chain_fed_replayed_masks(cuda):
    """The masks drawn inside K5f/K5b are the ones ``dropout_masks``
    replays at the dropped block's index: the chain in prng mode and in
    input mode fed those masks give the same bits, forward and backward,
    at the full width and depth."""
    rng = np.random.default_rng(5)
    L, N, F = 7, 328, 512

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(cuda)

    x0 = t(rng.standard_normal((N, 768))).requires_grad_()
    params = ([t(rng.uniform(-1, 1, (768 if i == 0 else F, F))
                 / np.sqrt(768 if i == 0 else F)) for i in range(L)]
              + [t(rng.normal(0, 0.1, F)) for _ in range(L)]
              + [t(rng.uniform(0.8, 1.2, F)) for _ in range(L)]
              + [t(rng.normal(0, 0.1, F)) for _ in range(L)])
    for p in params:
        p.requires_grad_()
    seed = torch.tensor([7, -11], dtype=torch.int32, device=cuda)
    rate = 0.4
    keep = torch.full((1,), 1 - rate, device=cuda)
    masks = [TF.dropout_masks(seed, keep, N, F, b) for b in range(3, L)]
    outs = []
    for mode, ext in (("prng", ()), ("input", masks)):
        h, m, v = TF.fused_dense_chain(x0, params[:L], params[L:2 * L],
                                       params[2 * L:3 * L], params[3 * L:],
                                       seed, rate, mask_mode=mode,
                                       ext_masks=ext)
        grads = torch.autograd.grad((h * h).sum(), [x0, *params])
        outs.append((h, m, v, *grads))
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_philox_matches_curand(cuda):
    """The kernels' Philox4x32-10 against the CUDA toolkit's
    ``curand_Philox4x32_10`` on random counters and keys, and Random123's
    known answer for a zero counter and key."""
    rng = np.random.default_rng(9)
    ctr = torch.from_numpy(rng.integers(-2**31, 2**31, (4096, 4),
                                        dtype=np.int64).astype(np.int32))
    key = torch.from_numpy(rng.integers(-2**31, 2**31, (4096, 2),
                                        dtype=np.int64).astype(np.int32))
    ctr[0], key[0] = 0, 0
    ours, theirs = TF.philox_check(ctr.to(cuda), key.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(ours, theirs)
    assert [v & 0xFFFFFFFF for v in ours[0].tolist()] == [
        0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    # and the plain version on the CPU agrees with both
    words = TF.philox4x32_10(
        [ctr[:64, j].long() & 0xFFFFFFFF for j in range(4)],
        [key[:64, j].long() & 0xFFFFFFFF for j in range(2)])
    plain = torch.stack(words, dim=1)
    assert torch.equal(plain, ours[:64].cpu().long() & 0xFFFFFFFF)


def test_train_fused_wrappers_reject_bad_inputs(cuda):
    """Each K5 wrapper raises on a wrong dtype, device or layout and
    launches nothing."""
    x, w, (b, gamma, beta), in_stats, dz, seed = _block_case(40, 512)
    keep = torch.full((1,), 0.5, device=cuda)
    r, stats = TF.dense_block_fwd(x, w, b, gamma, beta)
    sums = torch.zeros((2, 512), device=cuda)
    before = dict(K.launch_counts)
    with pytest.raises(ValueError, match="dtype"):
        TF.dense_block_fwd(x.double(), w, b, gamma, beta)
    with pytest.raises(ValueError, match="on cpu"):
        TF.dense_block_fwd(x, w, b.cpu(), gamma, beta)
    with pytest.raises(ValueError, match="contiguous"):
        TF.dense_block_fwd(x.T.contiguous().T, w, b, gamma, beta)
    with pytest.raises(ValueError, match="seed or a mask"):
        TF.dense_block_fwd(x, w, b, gamma, beta, in_stats, keep=keep)
    with pytest.raises(ValueError, match="dtype"):
        TF.dense_block_bwd(dz, r, x, w, stats, sums.double())
    with pytest.raises(ValueError, match="on cpu"):
        TF.dense_block_bwd(dz, r.cpu(), x, w, stats, sums)
    with pytest.raises(ValueError, match="contiguous"):
        TF.dense_block_bwd(dz, r, x, torch.empty((512, 1024), device=cuda)
                           [:, ::2], stats, sums)
    with pytest.raises(ValueError, match="dtype"):
        TF.dropout_masks(seed.long(), keep, 40, 512, 3)
    with pytest.raises(ValueError, match="on cpu"):
        TF.dropout_masks(seed, keep.cpu(), 40, 512, 3)
    with pytest.raises(ValueError, match="the kernels take"):
        TF.fused_dense_chain(x.half(), [w], [b], [gamma], [beta], seed, 0.0)
    with pytest.raises(ValueError, match="multiples of 4"):
        TF.dense_block_fwd(x[:, :510].contiguous(), w[:510], b, gamma, beta)
    with pytest.raises(ValueError, match="16-byte aligned"):
        TF.dense_block_fwd(torch.empty(x.numel() + 1, device=cuda)[1:]
                           .view(x.shape), w, b, gamma, beta)
    with pytest.raises(ValueError, match="tiling"):
        TF.dense_block_bwd(dz, r, x, w, stats, sums, tiling=9)
    assert K.launch_counts == before


# ------------------------------------------------------- the chain's tail
def _within_one_ulp(got, want):
    spacing = torch.nextafter(want.abs(), torch.full_like(
        want, float("inf"))) - want.abs()
    assert bool(((got - want).abs() <= spacing).all())


@pytest.mark.parametrize("form", ["drawn", "mask"])
@pytest.mark.parametrize("N", [328, 123, 5])
def test_chain_tail_kernels_match_plain(cuda, N, form):
    """``chain_tail_fwd``/``_bwd`` against their plain versions at the
    chain's width, the step's 328 rows and ragged 123 and 5, dropout 0.5 of
    block 6 drawn or given as the replayed mask: h and dz bit for bit, the
    sums (f64 in another order, rounded once) within one f32 ulp; one
    launch each; a rerun and the replayed mask give the same bits."""
    r, _, _, stats, dh, seed = _block_case(N, 512, seed=N)
    keep = torch.full((1,), 0.5, device=cuda)
    drawn = dict(seed=seed, keep=keep, drop_block=6)
    fed = dict(keep=keep, mask=TF.dropout_masks(seed, keep, N, 512, 6))
    drop = drawn if form == "drawn" else fed
    before = dict(K.launch_counts)
    h = TF.chain_tail_fwd(r, stats, **drop)
    dz, sums = TF.chain_tail_bwd(dh, r, stats, **drop)
    torch.cuda.synchronize()
    assert K.launch_counts["chain_tail_fwd"] == before["chain_tail_fwd"] + 1
    assert K.launch_counts["chain_tail_bwd"] == before["chain_tail_bwd"] + 1
    assert torch.equal(h, TF.chain_tail_fwd_reference(r, stats, **drop))
    dz_p, sums_p = TF.chain_tail_bwd_reference(dh, r, stats, **drop)
    assert torch.equal(dz, dz_p)
    _within_one_ulp(sums, sums_p)
    for other in (drop, fed if form == "drawn" else drawn):
        assert torch.equal(TF.chain_tail_fwd(r, stats, **other), h)
        dz2, sums2 = TF.chain_tail_bwd(dh, r, stats, **other)
        assert torch.equal(dz2, dz) and torch.equal(sums2, sums)


def test_fused_chain_tail_kernels_give_the_plain_tails_gradients(
        cuda, monkeypatch):
    """The chain at full width and depth with the tail kernels, and with
    the plain tail fed the same seeds: the same forward bits, and the same
    gradients up to the one f32 ulp the tail's sums may differ by."""
    rng = np.random.default_rng(8)
    L, N, F = 7, 328, 512

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(cuda)

    x0 = t(rng.standard_normal((N, 768))).requires_grad_()
    params = ([t(rng.uniform(-1, 1, (768 if i == 0 else F, F))
                 / np.sqrt(768 if i == 0 else F)) for i in range(L)]
              + [t(rng.normal(0, 0.1, F)) for _ in range(L)]
              + [t(rng.uniform(0.8, 1.2, F)) for _ in range(L)]
              + [t(rng.normal(0, 0.1, F)) for _ in range(L)])
    for p in params:
        p.requires_grad_()
    seed = torch.tensor([5, -9], dtype=torch.int32, device=cuda)
    outs = []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(TF, "chain_tail_fwd",
                                TF.chain_tail_fwd_reference)
            monkeypatch.setattr(TF, "chain_tail_bwd",
                                TF.chain_tail_bwd_reference)
        before = dict(K.launch_counts)
        h, m, v = TF.fused_dense_chain(x0, params[:L], params[L:2 * L],
                                       params[2 * L:3 * L], params[3 * L:],
                                       seed, 0.5)
        grads = torch.autograd.grad((h * h).sum(), [x0, *params])
        torch.cuda.synchronize()
        tail = [K.launch_counts[k] - before[k]
                for k in ("chain_tail_fwd", "chain_tail_bwd")]
        assert tail == ([0, 0] if plain else [1, 1])
        assert K.launch_counts["dropout_masks"] == before["dropout_masks"]
        outs.append(((h, m, v), grads))
    for a, b in zip(outs[0][0], outs[1][0]):
        assert torch.equal(a, b)
    for a, b in zip(outs[0][1], outs[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-5,
                                   atol=1e-6 * float(b.abs().max()))


@pytest.mark.parametrize("F", [512, 130, 37, 6])
def test_dropout_masks_kernel_at_the_chain_and_ragged_widths(cuda, F):
    """The replay kernel's 16-byte stores (F % 4 == 0) and scalar stores
    (otherwise) give its plain version's bits."""
    seed = torch.tensor([2024, -31], dtype=torch.int32, device=cuda)
    for N in (328, 123):
        kt = torch.full((1,), 0.7, device=cuda)
        assert torch.equal(TF.dropout_masks(seed, kt, N, F, 5),
                           TF.dropout_masks_reference(seed, kt, N, F, 5))


def test_chain_tail_wrappers_reject_bad_inputs(cuda):
    """The tail wrappers raise on a width that is not a multiple of 4, a
    wrong dtype, device or layout, and dropout with neither seed nor mask,
    and launch nothing."""
    r, _, _, stats, dh, seed = _block_case(40, 512)
    keep = torch.full((1,), 0.5, device=cuda)
    kw = dict(seed=seed, keep=keep, drop_block=6)
    before = dict(K.launch_counts)
    with pytest.raises(ValueError, match="multiples of 4"):
        TF.chain_tail_fwd(r[:, :510].contiguous(), stats[:, :510]
                          .contiguous(), **kw)
    with pytest.raises(ValueError, match="dtype"):
        TF.chain_tail_fwd(r.double(), stats, **kw)
    with pytest.raises(ValueError, match="on cpu"):
        TF.chain_tail_fwd(r, stats.cpu(), **kw)
    with pytest.raises(ValueError, match="seed or a mask"):
        TF.chain_tail_fwd(r, stats, keep=keep)
    with pytest.raises(ValueError, match="contiguous"):
        TF.chain_tail_bwd(dh.T.contiguous().T, r, stats, **kw)
    with pytest.raises(ValueError, match="shape"):
        TF.chain_tail_bwd(dh, r[:20].contiguous(), stats, **kw)
    with pytest.raises(ValueError, match="16-byte aligned"):
        TF.chain_tail_bwd(dh, torch.empty(r.numel() + 1, device=cuda)[1:]
                          .view(r.shape), stats, **kw)
    assert K.launch_counts == before


# the bf16 chain against its plain version and float64. Two bf16 chains
# whose f32 GEMMs sum in other orders round some r to the other bf16
# neighbour, and seven blocks carry each flip on, so h and the gradients
# differ by more than JAX's elementwise bf16 tolerance. The bounds are set
# from the plain chain's own twins on an H100 (the same chain with its
# features permuted, and on the CPU; scripts/bf16_chain_f64.py, 8 seeds
# at each N): at most 0.16 % of h outside JAX's rtol/atol 0.05 of the
# plain chain (BF16_FLIP_SHARE), gradients up to 0.162 apart in the
# relative 2-norm (BF16_GRAD), and, against a float64 evaluation of the
# same chain, distances up to 1.17x the plain chain's (h's largest; its
# mean 1.02x, each gradient 1.12x, the elements outside JAX's tolerance
# pooled over the seeds 1.11x) (BF16_F64)
BF16_FLIP_SHARE, BF16_GRAD, BF16_F64 = 0.003, 0.2, 1.25
BF16_CHAIN_SEEDS = 8  # seed 0 the case's own draw (seeded N)


def _within_one_bf16_ulp(got, want):
    """Each element within one bf16 ulp of the larger magnitude's, plus
    2^-16 x the largest |value| where an f32 sum cancels to near 0."""
    g, w = got.double(), want.double()
    big = torch.maximum(g.abs(), w.abs()).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
    floor = 2.0 ** -16 * float(w.abs().max())
    assert bool(((g - w).abs() <= ulp + floor).all())


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("lo", [164, 246])
def test_dp_rank_modes_match_plain(cuda, bf16, lo):
    """A dp rank's launches on rows [lo, 328) of the step's batch at row
    base lo (dp=2's second rank: N=164; dp=4's last: N=82), an inner
    block at dropout 0.5: K5f's sums-only end gives the one-shot r bit for
    bit, and its sums on the whole batch finish (``finish_stats``) into
    the one-shot statistics bit for bit; the rank's r, K5b's dx (given the
    whole batch's sums and n_total 328) and the tail pair's h and dz are
    those rows of the whole batch's launches, bit for bit, and
    ``dropout_masks`` at the row base those rows of the whole mask; each
    against its plain version at the existing tolerances (r rtol 1e-5 in
    f32, one bf16 ulp in bf16; the sums, dW, db and lower sums rtol 1e-4,
    atol 1e-5 x max; the tail bit for bit, its sums within one f32 ulp);
    ``mode_counts`` counts the sums-only, row-base and n_total launches."""
    N, K_in, F = 328, 512, 512
    x, w, (b, gamma, beta), in_stats, dz, seed = _block_case(N, K_in,
                                                             seed=lo)
    if bf16:
        x, w, dz = (t.to(torch.bfloat16) for t in (x, w, dz))
    keep = torch.full((1,), 0.5, device=cuda)
    whole = dict(seed=seed, keep=keep, drop_block=3)
    part = dict(whole, row_base=lo)
    K.reset_launch_counts()
    r, stats = TF.dense_block_fwd(x, w, b, gamma, beta, in_stats, **whole)
    r_all, sums_all = TF.dense_block_fwd(x, w, b, gamma, beta, in_stats,
                                         sums_only=True, **whole)
    assert torch.equal(r_all, r)
    assert torch.equal(TF.finish_stats(sums_all, gamma, beta, N), stats)
    r_lo, sums_lo = TF.dense_block_fwd(x[lo:], w, b, gamma, beta, in_stats,
                                       sums_only=True, **part)
    assert torch.equal(r_lo, r[lo:])
    r_p, sums_p = TF.dense_block_fwd_reference(x[lo:], w, b, gamma, beta,
                                               in_stats, sums_only=True,
                                               **part)
    if bf16:
        _within_one_bf16_ulp(r_lo, r_p)
    else:
        _close(r_lo, r_p, rtol=1e-5)
    _close(sums_lo, sums_p, rtol=1e-3 if bf16 else 1e-4,
           scale_atol=1e-3 if bf16 else 1e-5)
    rf, dzf = r.float(), dz.float()
    sums = torch.stack([dzf.sum(0), (dzf * (rf - stats[0]) * stats[2]).sum(0)])
    dx = TF.dense_block_bwd(dz, r, x, w, stats, sums, in_stats, **whole)[0]
    got = TF.dense_block_bwd(dz[lo:], r[lo:], x[lo:], w, stats, sums,
                             in_stats, n_total=N, **part)
    assert torch.equal(got[0], dx[lo:])
    want = TF.dense_block_bwd_reference(dz[lo:], r[lo:], x[lo:], w, stats,
                                        sums, in_stats, n_total=N, **part)
    if bf16:
        _within_one_bf16_ulp(got[0], want[0])
    else:
        _close(got[0], want[0])
    for g, v in zip(got[1:], want[1:], strict=True):
        _close(g, v)
    tail = dict(seed=seed, keep=keep, drop_block=6)
    h = TF.chain_tail_fwd(r, stats, **tail)
    h_lo = TF.chain_tail_fwd(r[lo:], stats, row_base=lo, **tail)
    assert torch.equal(h_lo, h[lo:])
    assert torch.equal(h_lo, TF.chain_tail_fwd_reference(
        r[lo:], stats, row_base=lo, **tail))
    dz_all = TF.chain_tail_bwd(dz, r, stats, **tail)[0]
    tz, ts = TF.chain_tail_bwd(dz[lo:], r[lo:], stats, row_base=lo, **tail)
    assert torch.equal(tz, dz_all[lo:])
    tz_p, ts_p = TF.chain_tail_bwd_reference(dz[lo:], r[lo:], stats,
                                             row_base=lo, **tail)
    assert torch.equal(tz, tz_p)
    _within_one_ulp(ts, ts_p)
    masks = TF.dropout_masks(seed, keep, N - lo, F, 6, row_base=lo)
    assert torch.equal(masks, TF.dropout_masks(seed, keep, N, F, 6)[lo:])
    assert torch.equal(masks, TF.dropout_masks_reference(seed, keep, N - lo,
                                                         F, 6, lo))
    torch.cuda.synchronize()
    sfx = "_bf16" if bf16 else ""
    assert K.mode_counts == {"dense_block_fwd_sums": 0 if bf16 else 2,
                             "dense_block_fwd_bf16_sums": 2 if bf16 else 0,
                             "row_base": 5, "n_total": 1}
    assert K.launch_counts["dense_block_fwd" + sfx] == 3


@pytest.mark.parametrize("N", [328, 123])
def test_bf16_chain_kernels_match_plain_and_launch(cuda, N):
    """The bf16 chain on the card: ``fused_dense_chain`` on a bf16 input
    runs the four bf16 kernels (7 K5f, 7 K5b, one of each tail kernel) and
    none of the f32 ones, and on each of BF16_CHAIN_SEEDS draws its h_L
    and gradients differ from the plain bf16 chain's no more than other
    summation orders of the plain chain do: h within JAX's bf16 tolerance
    (rtol and atol 0.05) of it at all but BF16_FLIP_SHARE of its
    elements, each gradient within BF16_GRAD of it in the relative
    2-norm. Against a float64 evaluation of the same chain (the same bf16
    input values, weights and masks) the kernel lies no farther than
    BF16_F64 times the plain chain: over all of h (mean and largest),
    for each gradient, and at the elements outside JAX's tolerance,
    summed over the draws (one draw holds 0 to 168 of them: a ratio of
    so few is noise). On an H100 the pooled ratio reads 1.056 at N=328
    and 0.925 at N=123, the kernel the nearer at 291 of 593 and 80 of
    157 elements (``scripts/bf16_chain_f64.py`` prints every reading)."""
    L, D0, F = 7, 768, 512

    def draw(seed):
        rng = np.random.default_rng(N if seed == 0 else (N, seed))
        x0 = rng.standard_normal((N, D0)).astype(np.float32)
        ws = [(rng.uniform(-1, 1, (D0 if i == 0 else F, F)) / np.sqrt(D0))
              .astype(np.float32) for i in range(L)]
        bs = [rng.normal(0, 0.1, F).astype(np.float32) for _ in range(L)]
        masks = [(rng.random((N, F)) < 0.5).astype(np.float32)
                 for _ in range(4)]
        cot = rng.standard_normal((N, F)).astype(np.float32)
        return x0, ws, bs, masks, cot

    def chain(case, dtype, run):
        x0, ws, bs, masks, cot = case

        def t(a):
            return torch.from_numpy(a).to(device=cuda, dtype=dtype)

        x = torch.from_numpy(x0).to(torch.bfloat16).to(cuda)
        w = [t(a).requires_grad_() for a in ws]
        b = [t(a).requires_grad_() for a in bs]
        g = [torch.ones(F, device=cuda, dtype=dtype).requires_grad_()
             for _ in range(L)]
        be = [torch.zeros(F, device=cuda, dtype=dtype).requires_grad_()
              for _ in range(L)]
        h = run(x if dtype == torch.float32 else x.to(dtype), w, b, g, be,
                [t(m) for m in masks])
        return h, torch.autograd.grad((h.to(dtype) * t(cot)).sum(), w + b)

    def kernel(x, w, b, g, be, m):
        return TF.fused_dense_chain(x, w, b, g, be, None, 0.5,
                                    mask_mode="input", ext_masks=m)[0]

    def plain(dtype):
        def run(x, w, b, g, be, m):
            keep = torch.full((1,), 0.5, device=cuda, dtype=w[0].dtype)
            return TF.dense_chain_reference(x, w, b, g, be, m, keep,
                                            dropout_from=L - 4,
                                            compute_dtype=dtype)[0]
        return run

    outside_kernel = outside_plain = 0.0
    for seed in range(BF16_CHAIN_SEEDS):
        case = draw(seed)
        K.reset_launch_counts()
        h, got = chain(case, torch.float32, kernel)
        torch.cuda.synchronize()
        counts = {k: v for k, v in K.launch_counts.items() if v}
        assert counts == {"dense_block_fwd_bf16": L,
                          "dense_block_bwd_bf16": L,
                          "chain_tail_fwd_bf16": 1, "chain_tail_bwd_bf16": 1}
        hp, want = chain(case, torch.float32, plain(torch.bfloat16))
        h64, g64 = chain(case, torch.float64, plain(torch.float32))
        assert h.dtype == hp.dtype == torch.bfloat16
        h, hp = h.double(), hp.double()
        d_kernel, d_plain = (h - h64).abs(), (hp - h64).abs()
        outside = (h - hp).abs() > 0.05 + 0.05 * hp.abs()
        assert outside.double().mean() <= BF16_FLIP_SHARE, seed
        outside_kernel += float(d_kernel[outside].sum())
        outside_plain += float(d_plain[outside].sum())
        assert d_kernel.mean() <= BF16_F64 * d_plain.mean(), seed
        assert d_kernel.max() <= BF16_F64 * d_plain.max(), seed
        for a, b, c in zip(got, want, g64):
            assert a.dtype == torch.float32
            a, b = a.double(), b.double()
            assert (a - b).norm() <= BF16_GRAD * b.norm(), seed
            assert (a - c).norm() <= BF16_F64 * (b - c).norm(), seed
    assert outside_kernel <= BF16_F64 * outside_plain


# ------------------------------------------------------- the config axis
def _stacked_block(C, N, K_in, F, device, seed):
    g = torch.Generator(device).manual_seed(seed)
    x = torch.randn(C, N, K_in, generator=g, device=device).clamp_min_(0)
    w = ((torch.rand(C, F, K_in, generator=g, device=device) * 2 - 1)
         / np.sqrt(K_in)).transpose(1, 2)
    vec = [torch.randn(C, F, generator=g, device=device) * 0.1
           for _ in range(3)]
    mean = torch.rand(C, K_in, generator=g, device=device) * 0.4 + 0.2
    var = torch.rand(C, K_in, generator=g, device=device) * 0.3 + 0.2
    rstd = torch.rsqrt(var + 1e-5)
    in_stats = torch.stack([mean, var, rstd, rstd, 0.1 - mean * rstd], 1)
    dz = torch.randn(C, N, F, generator=g, device=device) * 0.01
    seeds = torch.randint(-2**31, 2**31, (C, 2), dtype=torch.int32,
                          generator=g, device=device)
    keep = torch.rand(C, generator=g, device=device) * 0.2 + 0.4
    return x, w, vec, in_stats, dz, seeds, keep


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("C,N", [(2, 328), (5, 123)])
def test_config_axis_chain_kernels_are_each_configs_launch(cuda, C, N, bf16):
    """K5f, K5b and the tail pair on C configs in one launch each: config
    c bit-equal to a launch on config c alone; the whole against the
    config-axis plain versions (f32 r rtol 1e-5, the rest rtol 1e-4; bf16
    r and dx within 0.05, as JAX's bf16 tolerance; the tail's h and dz bit
    for bit)."""
    x, w, (b, gamma, beta), in_stats, dz, seeds, keep = _stacked_block(
        C, N, 512, 512, cuda, N + C)
    if bf16:
        x, w, dz = (a.to(torch.bfloat16) for a in (x, w, dz))
    kw = dict(seed=seeds, keep=keep, drop_block=3)
    r, st = TF.dense_block_fwd(x, w, b, gamma, beta, in_stats, **kw)
    sums = torch.stack([dz.float().sum(1), dz.float().sum(1) * 0.5], 1)
    bwd = TF.dense_block_bwd(dz, r, x, w, st, sums, in_stats, **kw)
    td = dict(seed=seeds, keep=keep, drop_block=6)
    h = TF.chain_tail_fwd(r, st, **td)
    tz, ts = TF.chain_tail_bwd(dz, r, st, **td)
    for c in range(C):
        one = dict(seed=seeds[c], keep=keep[c:c + 1], drop_block=3)
        r1, st1 = TF.dense_block_fwd(x[c], w[c], b[c], gamma[c], beta[c],
                                     in_stats[c], **one)
        assert torch.equal(r[c], r1) and torch.equal(st[c], st1)
        b1 = TF.dense_block_bwd(dz[c], r[c], x[c], w[c], st[c], sums[c],
                                in_stats[c], **one)
        assert all(torch.equal(g[c], v) for g, v in zip(bwd, b1))
        one["drop_block"] = 6
        assert torch.equal(h[c], TF.chain_tail_fwd(r[c], st[c], **one))
        tz1, ts1 = TF.chain_tail_bwd(dz[c], r[c], st[c], **one)
        assert torch.equal(tz[c], tz1) and torch.equal(ts[c], ts1)
    r_p, st_p = TF.dense_block_fwd_reference(x, w, b, gamma, beta, in_stats,
                                             **kw)
    bwd_p = TF.dense_block_bwd_reference(dz, r, x, w, st, sums, in_stats,
                                         **kw)
    low = dict(rtol=0.05, atol=0.05)
    torch.testing.assert_close(r.float(), r_p.float(),
                               **(low if bf16 else dict(rtol=1e-5,
                                                        atol=1e-5)))
    torch.testing.assert_close(st, st_p, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(bwd[0].float(), bwd_p[0].float(),
                               **(low if bf16 else dict(rtol=1e-4,
                                                        atol=1e-6)))
    for g, v in zip(bwd[1:], bwd_p[1:]):
        torch.testing.assert_close(g, v, rtol=1e-4,
                                   atol=1e-5 * float(v.abs().max()))
    assert torch.equal(h, TF.chain_tail_fwd_reference(r, st, **td))
    assert torch.equal(tz, TF.chain_tail_bwd_reference(dz, r, st, **td)[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_config_axis_encoder_chain_is_each_configs_call(cuda, dtype):
    """``encoder_chain`` on a stacked fold of 3 configs, 8,200 rows each:
    both tilings bit-equal, config c bit-equal to a call on its fold, the
    whole within the plain version's tolerance (f32 rtol 2e-4, atol 2e-5;
    bf16 atol 0.05)."""
    from contrastiveprosthetics_torch.models.stacked import (
        StackedContrastiveModel,
    )

    models = [ContrastiveModel(generator=torch.Generator().manual_seed(c))
              for c in range(3)]
    model = StackedContrastiveModel.from_models(models).to(cuda).eval()
    folded = K.fold_encoder_params(model.emg_net, model.encode_classes(),
                                   dtype=dtype)
    frames = torch.randn(3, 8200, 12, device=cuda)
    plan = K.encoder_plan(folded)
    got = K.encoder_chain(frames, plan, 1)
    assert torch.equal(got, K.encoder_chain(frames, plan, 0))
    for c in range(3):
        one = K.fused_encoder_logits(frames[c], [a[c] for a in folded])
        assert torch.equal(got[c], one)
    want = K.fused_encoder_logits_reference(frames, folded)
    tol = (dict(rtol=0, atol=0.05) if dtype == torch.bfloat16
           else SCORE_TOL)
    torch.testing.assert_close(got, want, **tol)


# ------------------------------------------------------------ adam_stacked
ADAM_KINDS = {"f32": (torch.float32, torch.float32),
              "bf16": (torch.float32, torch.bfloat16),
              "f64": (torch.float64, torch.float64)}
# (shapes, configs): the sweep's chunk at the reference EMG tower's widths,
# a --spmd_crossval rank's 4 configs, one config, and leaves no multiple of
# 4 long (every element alone)
ADAM_CASES = [("model", 150), ("model", 4), ("model", 1), ("ragged", 4)]


def _adam_shapes(case):
    if case == "ragged":
        return [(3,), (5, 7), (1,), (6,), (130,), (2, 3, 3)]
    return [tuple(p.shape) for p in
            ContrastiveModel().towers()["emg_net"].parameters()]


def _adam_bias_corrections(step, b1=0.9, b2=0.999):
    t = np.float32(step)
    return (float(np.float32(1) - np.float32(b1) ** t),
            float(np.float32(1) - np.float32(b2) ** t))


@pytest.mark.parametrize("case,n_cfg,kind", [
    (case, n_cfg, kind) for case, n_cfg in ADAM_CASES for kind in ADAM_KINDS
    if not (kind == "f64" and n_cfg == 150)])
def test_adam_stacked_kernel_matches_plain(cuda, case, n_cfg, kind):
    """Five updates, a distinct lr a config, gradients of another scale
    each step with exact zeros among them: the kernel's parameters, mu and
    nu bit for bit those of its plain version (the tensor ops it replaced)
    on the card; one launch an update, counted as a bf16-mu launch where it
    is one."""
    from contrastiveprosthetics_torch.train.engine import stacked_adam_init

    dtype, mu_dtype = ADAM_KINDS[kind]
    gen = torch.Generator(device=cuda).manual_seed(n_cfg + 7)
    ours = [torch.randn((n_cfg, *s), generator=gen, device=cuda, dtype=dtype)
            for s in _adam_shapes(case)]
    plain = [p.clone() for p in ours]
    st_k, st_p = (stacked_adam_init(x, mu_dtype) for x in (ours, plain))
    (mu_k, nu_k), (mu_p, nu_p) = st_k.flat, st_p.flat
    lr = (torch.linspace(1e-4, 3e-3, n_cfg, dtype=torch.float64,
                         device=cuda) * 0.75).to(dtype)
    for step in range(1, 6):
        grads = []
        for p in ours:
            g = torch.randn(p.shape, generator=gen, device=cuda,
                            dtype=dtype) * 10.0 ** -(step % 3 + 1)
            g.view(-1)[::7] = 0
            grads.append(g)
        bc1, bc2 = _adam_bias_corrections(step)
        launches = K.launch_counts["adam_stacked"]
        low = K.mode_counts["adam_stacked_bf16_mu"]
        K.adam_stacked(ours, grads, st_k, lr, bc1, bc2)
        K.adam_stacked_reference(plain, grads, st_p, lr, bc1, bc2)
        torch.cuda.synchronize()
        assert K.launch_counts["adam_stacked"] == launches + 1
        assert K.mode_counts["adam_stacked_bf16_mu"] == low + (kind == "bf16")
        for a, b in zip(ours + [mu_k, nu_k], plain + [mu_p, nu_p]):
            assert a.dtype == b.dtype and torch.equal(a, b), step


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_adam_stacked_kernel_takes_any_bias_correction_as_torch(cuda, kind):
    """Bias corrections given as float64 numbers that no f32 holds (the
    step's own are f32 values): the kernel's reciprocals are those torch
    multiplies by for ``x / bc``, so the update stays bit for bit."""
    from contrastiveprosthetics_torch.train.engine import stacked_adam_init

    dtype, mu_dtype = ADAM_KINDS[kind]
    n_cfg = 4
    gen = torch.Generator(device=cuda).manual_seed(5)
    ours = [torch.randn((n_cfg, *s), generator=gen, device=cuda)
            for s in _adam_shapes("model")]
    plain = [p.clone() for p in ours]
    st_k, st_p = (stacked_adam_init(x, mu_dtype) for x in (ours, plain))
    (mu_k, nu_k), (mu_p, nu_p) = st_k.flat, st_p.flat
    lr = torch.linspace(1e-4, 3e-3, n_cfg, device=cuda)
    # each pair with a reciprocal that f32 division would round otherwise
    for bc1, bc2 in ((0.19, 0.001999), (0.6123, 0.0123)):
        assert np.float32(1.0 / bc2) != np.float32(1) / np.float32(bc2)
        grads = [torch.randn(p.shape, generator=gen, device=cuda) * 1e-2
                 for p in ours]
        K.adam_stacked(ours, grads, st_k, lr, bc1, bc2)
        K.adam_stacked_reference(plain, grads, st_p, lr, bc1, bc2)
        torch.cuda.synchronize()
        for a, b in zip(ours + [mu_k, nu_k], plain + [mu_p, nu_p]):
            assert torch.equal(a, b), (bc1, bc2)


def test_adam_stacked_kernel_rounds_bf16_ties_as_torch(cuda):
    """A bf16 mu stored from first moments halfway between two bf16 values
    (b1 = 0.5, gradients whose low 16 bits are 0x8000): the kernel's
    rounding to even is torch's conversion, bit for bit, over two steps."""
    from contrastiveprosthetics_torch.train.engine import stacked_adam_init

    b1, n_cfg = 0.5, 4
    gen = torch.Generator(device=cuda).manual_seed(3)
    ours = [torch.randn((n_cfg, *s), generator=gen, device=cuda)
            for s in ((64,), (16, 64), (8,))]
    plain = [p.clone() for p in ours]
    st_k, st_p = (stacked_adam_init(x, torch.bfloat16) for x in (ours, plain))
    (mu_k, nu_k), (mu_p, nu_p) = st_k.flat, st_p.flat
    lr = torch.linspace(1e-4, 3e-3, n_cfg, device=cuda)
    for step in (1, 2):
        grads = []
        for p in ours:
            u = torch.randn(p.shape, generator=gen, device=cuda).view(
                torch.int32)
            grads.append(((u & ~0xFFFF) | 0x8000).view(torch.float32))
        bc1, bc2 = _adam_bias_corrections(step, b1=b1)
        K.adam_stacked(ours, grads, st_k, lr, bc1, bc2, b1=b1)
        K.adam_stacked_reference(plain, grads, st_p, lr, bc1, bc2,
                                 b1=b1)
        torch.cuda.synchronize()
        for a, b in zip(ours + [mu_k, nu_k], plain + [mu_p, nu_p]):
            assert torch.equal(a, b), step


def test_adam_stacked_launches_once_a_live_tower(cuda):
    """``adam_step_`` on a stacked state's two chains, three steps: one
    ``adam_stacked`` launch a live tower a step, none for an idle one (the
    baseline's class tower), whose count still advances."""
    from contrastiveprosthetics_torch.models.stacked import (
        StackedContrastiveModel,
    )
    from contrastiveprosthetics_torch.train.engine import (
        TrainState,
        adam_step_,
    )

    n_cfg = 3
    lr = torch.full((n_cfg,), 1e-3, device=cuda)
    for prediction, live in ((False, 2), (True, 1)):
        model = StackedContrastiveModel.from_models([
            ContrastiveModel(prediction=prediction,
                             generator=torch.Generator().manual_seed(c))
            for c in range(n_cfg)]).to(cuda)
        state = TrainState.fresh(model)
        towers = model.towers()
        for _ in range(3):
            before = K.launch_counts["adam_stacked"]
            for name, opt in (("emg_net", state.opt_emg),
                              ("glove_net", state.opt_glove)):
                params = list(towers[name].parameters())
                adam_step_(params, [torch.randn_like(p) for p in params],
                           opt, lr)
            torch.cuda.synchronize()
            assert K.launch_counts["adam_stacked"] == before + live
        assert state.opt_emg.count == state.opt_glove.count == 3


def test_adam_stacked_refuses_what_it_does_not_take(cuda):
    """float64 parameters with a bf16 mu, an lr of another dtype or shape,
    a gradient of another shape: ``ValueError`` before any launch."""
    from contrastiveprosthetics_torch.train.engine import stacked_adam_init

    params = [torch.randn((2, 8), device=cuda) for _ in range(2)]
    state = stacked_adam_init(params)
    lr = torch.full((2,), 1e-3, device=cuda)
    p64 = [p.double() for p in params]
    state64 = stacked_adam_init(p64, torch.bfloat16)
    before = dict(K.launch_counts)
    bad = [(p64, p64, state64, lr.double()),
           (params, params, state, lr.double()),
           (params, params, state, lr[:1]),
           (params, [params[0], params[1][:, :4]], state, lr)]
    for args in bad:
        with pytest.raises(ValueError):
            K.adam_stacked(*args, 0.1, 0.001)
    assert K.launch_counts == before


# ------------------------------------------------------ the parallel layer
def test_world1_sharded_serving_is_the_unsharded_engine(cuda, tmp_path):
    """A world of one rank over NCCL: ``BatchedStreamingEngine(mesh=)`` at
    4,096 sessions x 5 ticks (the kernels on the rank's shard, every
    output gathered) bit-equal to the unsharded engine: preds and votes
    of ``steps``, preds, votes and scores of ``step``."""
    import torch.distributed as dist

    from contrastiveprosthetics_torch.config import DEFAULT_CONFIG as cfg
    from contrastiveprosthetics_torch.parallel.mesh import make_mesh
    from contrastiveprosthetics_torch.serve.stream import (
        BatchedStreamingEngine,
    )

    S = 4096
    model = ContrastiveModel(generator=torch.Generator().manual_seed(0)).to(
        cuda)
    rng = np.random.default_rng(4)
    mean = rng.normal(0, 0.1, D).astype(np.float32)
    std = rng.uniform(0.8, 1.2, D).astype(np.float32)
    blocks = torch.randn((5, S, FACTOR, D), device=cuda) * 200
    masks = torch.rand((S, C), device=cuda) < 0.5
    masks[:, 0] = True
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        outs = []
        for mesh in (None, make_mesh(1, 1)):
            eng = BatchedStreamingEngine(cfg, model, mean, std, S, mesh=mesh)
            K.reset_launch_counts()
            _, p, v = eng.steps(eng.init_carries(), blocks, masks)
            outs.append((p, v, *eng.step(eng.init_carries(), blocks[0],
                                         masks)[1:]))
            torch.cuda.synchronize()
            assert all(K.launch_counts[k] for k in ("dsp_frames",
                                                    "encoder_chain",
                                                    "vote_scan"))
    finally:
        dist.destroy_process_group()
    assert all(torch.equal(a, b) for a, b in zip(*outs))
