"""PyTorch port: the evaluation and results slice on the card (the
fused-encoder evaluation through the ``encoder_chain`` kernels, the
set-size sweep on the card against its CPU run).

Every test here is marked ``cuda`` and skips without a CUDA device. The
file imports neither JAX nor the JAX package, so it also runs on a GPU
machine without them:

    python -m pytest tests/test_torch_port_results_cuda.py -m cuda --noconftest -q
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from contrastiveprosthetics_torch.config import DEFAULT_CONFIG as CFG
from contrastiveprosthetics_torch.data.store import DeviceStore
from contrastiveprosthetics_torch.data.synthetic import make_processed_dataset
from contrastiveprosthetics_torch.eval.subset_sweep import subset_size_sweep
from contrastiveprosthetics_torch.ops import kernels as K
from contrastiveprosthetics_torch.train.engine import Trainer

pytestmark = pytest.mark.cuda

SCORE_TOL = dict(rtol=2e-4, atol=2e-5)  # encoder_chain against plain f32


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("n_linear,hidden", [(2, 64), (7, 512)])
def test_fused_eval_launches_encoder_chain_per_batch(cuda, n_linear, hidden):
    """The test split of two people (16 items) in batches of 5: the fused
    evaluation launches the chain once per batch (a launch per layer and
    the head) and agrees with the unfused one."""
    emg, pos, glove = make_processed_dataset(CFG, people_positions=[40, 41],
                                             seed=3)
    store = DeviceStore(CFG, emg, pos, glove, device=cuda)
    kw = dict(adabn=False, batch_size=5, n_linear=n_linear, hidden=hidden)
    fused = Trainer(CFG, store, use_fused_encoder=True, **kw)
    plain = Trainer(CFG, store, **kw)
    state = plain.init_state(plain.generator(0))
    K.reset_launch_counts()
    got = fused.evaluate(state, fused.generator(1), None, "test",
                         batch_size=5)
    torch.cuda.synchronize()
    assert K.launch_counts["encoder_chain"] == (n_linear + 3) * 4
    want = plain.evaluate(state, plain.generator(1), None, "test",
                          batch_size=5)
    torch.testing.assert_close(got.logits, want.logits, **SCORE_TOL)
    assert torch.equal(got.y_true, want.y_true)


@pytest.mark.parametrize("rows", [40, 3000])
def test_subset_size_sweep_on_the_card_is_bit_equal_to_the_cpu(cuda, rows):
    rng = np.random.default_rng(rows)
    x = rng.standard_normal((rows, 41, 41)).astype(np.float32)
    x = np.round(x * 2) / 2  # ties everywhere
    x[0, 3, :4] = np.nan
    got = subset_size_sweep(torch.from_numpy(x).to(cuda), trials=16)
    want = subset_size_sweep(x, trials=16)
    for name in want._fields:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=name)
