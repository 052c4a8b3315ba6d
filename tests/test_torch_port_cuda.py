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


def test_dsp_frames_kernel_matches_plain(cuda):
    rng = np.random.default_rng(7)
    S, n_ticks = 37, 5
    iir, tail, _, _ = _carry(rng, S, cuda)
    blocks = torch.from_numpy((rng.standard_normal(
        (n_ticks, S, FACTOR, D)) * 2).astype(np.float32)).to(cuda)
    sos = torch.from_numpy(butter_bandpass_sos(20, 450, 2000)).float().to(cuda)
    mean, std = torch.zeros(D, device=cuda), torch.ones(D, device=cuda)
    before = K.launch_counts["dsp_frames"]
    got = K.dsp_frames(iir, tail, blocks, sos, mean, std)
    want = K.dsp_frames_reference(iir, tail, blocks, sos, mean, std)
    torch.cuda.synchronize()
    assert K.launch_counts["dsp_frames"] == before + 1
    # the kernel repeats the plain version's operation order, each step
    # rounded, so the two agree bit for bit
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("with_affines", [False, True])
def test_encoder_chain_kernel_matches_plain(cuda, with_affines):
    model = ContrastiveModel(n_linear=2, hidden=64,
                             generator=torch.Generator().manual_seed(1))
    model = model.to(cuda).eval()
    S, n_ticks = 6, 11
    with torch.no_grad():
        emb = model.encode_classes()
        if with_affines:
            folded = K.fold_encoder_params_shared(model.emg_net, emb)
            stats = [(bn.running_mean.expand(S, -1) * 0.5 + 0.1,
                      bn.running_var.expand(S, -1) * 2.0)
                     for bn in model.emg_net.norms()]
            affines = K.session_bn_affines(model.emg_net, stats)
        else:
            folded = K.fold_encoder_params(model.emg_net, emb)
            affines = None
    frames = torch.randn(n_ticks * S, D, device=cuda,
                         generator=torch.Generator(cuda).manual_seed(0))
    before = K.launch_counts["encoder_chain"]
    got = K.fused_encoder_logits(frames, folded, affines)
    want = K.fused_encoder_logits_reference(frames, folded, affines)
    torch.cuda.synchronize()
    # 2 conv + 2 dense layers, then the head
    assert K.launch_counts["encoder_chain"] == before + 5
    torch.testing.assert_close(got, want, **SCORE_TOL)
    # a row's scores do not depend on how many rows the call has
    first = K.fused_encoder_logits(frames[:S].contiguous(), folded, affines)
    assert torch.equal(first, got[:S])


def test_vote_scan_kernel_matches_plain(cuda):
    rng = np.random.default_rng(8)
    S, n_ticks = 300, 30
    _, _, votes, n_seen = _carry(rng, S, cuda)
    scores = torch.from_numpy(rng.standard_normal(
        (n_ticks, S, C)).astype(np.float32)).to(cuda)
    masks = torch.from_numpy(rng.random((S, C)) < 0.6).to(cuda)
    got = K.vote_scan(scores, masks, votes, n_seen)
    want = K.vote_scan_reference(scores, masks, votes, n_seen)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


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
    before = K.launch_counts["contrastive_loss_fwd"]
    with pytest.raises(ValueError, match="on cpu"):
        K.fused_contrastive_loss(e, e.cpu())
    assert K.launch_counts["contrastive_loss_fwd"] == before
