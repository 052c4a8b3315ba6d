"""PyTorch port: the stacked Adam update of the crossval sweep
(``ops/kernels.py::adam_stacked``, ``csrc/adam_stacked.cu``) on the CPU.

On CPU tensors the wrapper runs its plain version, the tensor ops the
stacked branch of ``train/engine.py::adam_step_`` ran before the kernel,
bit for bit; the leaf table the wrapper hands the kernel covers every
element of every leaf once, at its column of the flat moments; and the
kernel's CUDA source, run through ``tests/cuda_emulation.py``, gives the
card's tensor ops bit for bit (modelled here in numpy: ``x / bc`` as a
product with the reciprocal of the Python number, taken in float64, as
torch computes a division by a Python number on CUDA). The card's own checks are in
``test_torch_port_cuda.py``.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import pytest
import torch

import cuda_emulation
from contrastiveprosthetics_torch.models.clip import ContrastiveModel
from contrastiveprosthetics_torch.ops import kernels as K
from contrastiveprosthetics_torch.train.engine import (
    adam_step_,
    stacked_adam_init,
)

B1, B2, EPS = 0.9, 0.999, 1e-8
BF16 = torch.bfloat16


def _model_shapes():
    """The reference EMG tower's parameter shapes at full width."""
    return [tuple(p.shape) for p in
            ContrastiveModel().towers()["emg_net"].parameters()]


SHAPES = {
    "model": _model_shapes(),
    # N = 1,112: 16-byte runs in the first and last leaves only
    "mixed": [(64,), (3,), (16, 64), (5,), (4, 4)],
    # N = 193, not a multiple of 4: every leaf element by element
    "ragged": [(3,), (5, 7), (1,), (6,), (130,), (2, 3, 3)],
    # every leaf in 16-byte runs
    "aligned": [(64,), (16, 64), (8,), (4, 4)],
}


def _stacked(shapes, C, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((C, *s), generator=g, dtype=dtype) for s in shapes]


def _grads(params, step, seed):
    """Gradients of another scale each step, a few exact zeros among them."""
    g = torch.Generator().manual_seed(seed + 100 * step)
    out = []
    for p in params:
        x = torch.randn(p.shape, generator=g, dtype=p.dtype) * 10.0 ** -(
            step % 3 + 1)
        x.view(-1)[::7] = 0
        out.append(x)
    return out


def _lr(C, dtype):
    """A distinct lr a config."""
    return (torch.linspace(1e-4, 3e-3, C, dtype=torch.float64) * 0.75).to(
        dtype)


def _bias_corrections(t):
    t = np.float32(t)
    return (float(np.float32(1) - np.float32(B1) ** t),
            float(np.float32(1) - np.float32(B2) ** t))


def flat_branch_before(params, grads, state, lr, b1=B1, b2=B2, eps=EPS):
    """``adam_step_``'s stacked branch as it stood before the kernel."""
    state.count += 1
    t = np.float32(state.count)
    bc1 = float(np.float32(1) - np.float32(b1) ** t)
    bc2 = float(np.float32(1) - np.float32(b2) ** t)
    mu, nu = state.flat
    g = torch.cat([x.reshape(mu.shape[0], -1) for x in grads], 1)
    if mu.dtype == torch.bfloat16:
        m = ((mu.float() * float(torch.tensor(b1, dtype=torch.bfloat16)))
             .to(torch.bfloat16).float() + g * (1 - b1))
        mu.copy_(m)
    else:
        m = mu.mul_(b1).add_(g * (1 - b1))
    nu.mul_(b2).add_(g * g * (1 - b2))
    update = (m / bc1).div_((nu / bc2).sqrt_().add_(eps)).mul_(
        lr.view(-1, 1))
    for p, u in zip(params, update.split([p[0].numel() for p in params],
                                         1)):
        p.sub_(u.view(p.shape))


@pytest.mark.parametrize("mu_dtype", [torch.float32, BF16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shapes", ["model", "mixed", "ragged"])
def test_adam_stacked_on_the_cpu_is_the_flat_branch(shapes, mu_dtype):
    """Five steps of ``adam_step_`` on a stacked state, a distinct lr a
    config: parameters and both moments bit for bit those of the tensor ops
    the stacked branch ran before the kernel."""
    C = 3
    ours = _stacked(SHAPES[shapes], C, torch.float32, 1)
    theirs = [p.clone() for p in ours]
    state = stacked_adam_init(ours, mu_dtype)
    before = stacked_adam_init(theirs, mu_dtype)
    lr = _lr(C, torch.float32)
    for step in range(1, 6):
        grads = _grads(ours, step, 1)
        adam_step_(ours, grads, state, lr)
        flat_branch_before(theirs, grads, before, lr)
        for a, b in zip(ours + list(state.flat), theirs + list(before.flat)):
            assert a.dtype == b.dtype and torch.equal(a, b), step
    assert state.count == before.count == 5
    assert state.flat[0].dtype == mu_dtype


@pytest.mark.parametrize("shapes,C", [("model", 1), ("model", 4),
                                      ("mixed", 150), ("ragged", 1),
                                      ("ragged", 4), ("ragged", 150),
                                      ("aligned", 4)])
def test_adam_stacked_table_covers_every_element_once(shapes, C):
    """The leaf table, read off ``stacked_adam_init``'s per-parameter
    views: leaf i's pointers, its elements a config and the column where
    its view starts, the views together taking every column of every row
    once; 16-byte runs exactly where sizes, columns and N allow."""
    params = _stacked(SHAPES[shapes], C, torch.float32, 2)
    grads = _grads(params, 1, 2)
    state = stacked_adam_init(params)
    mu, nu = state.flat
    N = mu.shape[1]
    leaves = K.adam_stacked_leaves(params, grads, state)
    assert len(leaves) == len(params)
    hits = torch.zeros(N, dtype=torch.int64)
    for leaf, p, g, view in zip(leaves, params, grads, state.mu):
        n = p[0].numel()
        assert (leaf.p, leaf.g, leaf.n) == (p.data_ptr(), g.data_ptr(), n)
        assert view.data_ptr() == mu.data_ptr() + leaf.off * mu.element_size()
        hits[leaf.off:leaf.off + n] += 1
        assert leaf.vec == (n % 4 == 0 and leaf.off % 4 == 0 and N % 4 == 0)
    assert torch.equal(hits, torch.ones_like(hits))


def test_adam_stacked_idle_tower_has_no_table_and_counts_its_step():
    """A tower with no parameters (the baseline's class tower) launches
    nothing and holds no moments; optax counts its step all the same."""
    state = stacked_adam_init([])
    assert state.flat is None and state.mu == state.nu == []
    before = dict(K.launch_counts)
    for _ in range(3):
        adam_step_([], [], state, _lr(4, torch.float32))
    assert state.count == 3
    assert K.launch_counts == before


def test_adam_stacked_table_refuses_moments_of_another_width():
    """Flat moments whose rows hold columns that no parameter's views take
    (the first parameter's views dropped), or fewer views than parameters:
    ``ValueError``."""
    params = _stacked(SHAPES["mixed"], 2, torch.float32, 3)
    state = stacked_adam_init(params)
    narrow = type(state)(0, state.mu[1:], state.nu[1:], state.flat)
    with pytest.raises(ValueError, match="elements a config"):
        K.adam_stacked_leaves(params[1:], params[1:], narrow)
    with pytest.raises(ValueError, match="moments of"):
        K.adam_stacked_leaves(params, params, narrow)


def test_adam_stacked_table_refuses_views_out_of_step():
    """Views that leave the flat moments' layout: a parameter's mu and nu
    at different columns, two parameters on the same columns. Each raises
    ``ValueError`` before a table is built."""
    params = _stacked(SHAPES["mixed"], 3, torch.float32, 7)
    state = stacked_adam_init(params)
    state.nu[0], state.nu[2] = state.nu[2], state.nu[0]
    with pytest.raises(ValueError, match="no columns"):
        K.adam_stacked_leaves(params, params, state)
    twins = [params[0], params[0].clone()]
    state = stacked_adam_init(twins)
    state.mu[1], state.nu[1] = state.mu[0], state.nu[0]
    with pytest.raises(ValueError, match="not each column once"):
        K.adam_stacked_leaves(twins, twins, state)


def test_adam_stacked_takes_one_launch_of_up_to_its_table():
    """A tower's table goes in one launch: ``ADAM_MAX_LEAVES`` parameters
    give one argument tuple of that many leaves; one more raises."""
    for k, ok in ((K.ADAM_MAX_LEAVES, True), (K.ADAM_MAX_LEAVES + 1, False)):
        params = _stacked([(3,)] * k, 2, torch.float32, 8)
        state = stacked_adam_init(params)
        call = functools.partial(K.adam_stacked_args, params, params, state,
                                 _lr(2, torch.float32), 0.1, 0.001, B1, B2,
                                 EPS, 4)
        if ok:
            args = call()
            assert args[5] == k and len(args[0]) == k
        else:
            with pytest.raises(ValueError, match="takes up to"):
                call()


# ------------------------------------------------- the source, emulated
@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if cuda_emulation.compiler() is None:
        pytest.skip("needs a host C++ compiler to emulate the kernel")
    lib = cuda_emulation.build("adam_stacked", tmp_path_factory.mktemp("emu"))
    lib.adam_stacked_launch.argtypes = K._ADAM_ARGTYPES
    lib.adam_stacked_launch.restype = ctypes.c_int
    return lib


def _bf16_round(x: np.ndarray) -> np.ndarray:
    """f32 values rounded to bf16, to nearest even, as f32."""
    u = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    r = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    return r.astype(np.uint32).view(np.float32)


def card_step(P, G, MU, NU, lr, bc1, bc2, bf16_mu, b1=B1, b2=B2):
    """One update as torch's CUDA ops take the plain version, in numpy:
    each operation rounded once in the parameters' precision, each Python
    number cast to it, ``x / bc`` as ``x * (1 / bc)`` with the reciprocal
    taken in float64."""
    T = P.dtype.type
    inv1, inv2 = T(1.0 / bc1), T(1.0 / bc2)
    if bf16_mu:
        decayed = _bf16_round(MU * T(float(torch.tensor(b1, dtype=BF16))))
    else:
        decayed = MU * T(b1)
    m = decayed + G * T(1 - b1)
    NU = NU * T(b2) + (G * G) * T(1 - b2)
    den = np.sqrt(NU * inv2) + T(EPS)
    P = P - ((m * inv1) / den) * lr[:, None]
    return P, G, (_bf16_round(m) if bf16_mu else m), NU


def _flat(tensors, C):
    return torch.cat([t.reshape(C, -1) for t in tensors], 1).numpy()


def _same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    return a.dtype == b.dtype and np.array_equal(
        a.view(f"u{a.itemsize}"), b.view(f"u{b.itemsize}"))


KINDS = {"f32": (torch.float32, torch.float32),
         "bf16": (torch.float32, BF16),
         "f64": (torch.float64, torch.float64)}


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("shapes,C,grid", [("mixed", 3, 5), ("mixed", 1, 1),
                                           ("ragged", 4, 3),
                                           ("aligned", 2, 2)])
def test_adam_stacked_source_emulated_is_the_card_ops(lib, kind, shapes, C,
                                                      grid):
    """``csrc/adam_stacked.cu`` on the CPU: three steps through the
    wrapper's own arguments, with fewer blocks than chunks (a block walks
    chunks of several leaves), f32 with an f32 or bf16 mu and float64:
    parameters and moments bit for bit the card's tensor ops."""
    dtype, mu_dtype = KINDS[kind]
    params = _stacked(SHAPES[shapes], C, dtype, 4)
    state = stacked_adam_init(params, mu_dtype)
    mu, nu = state.flat
    lr = _lr(C, dtype)
    P, MU = _flat(params, C), mu.float().numpy().copy()
    NU = nu.numpy().copy()
    leaves = K.adam_stacked_leaves(params, _grads(params, 1, 4), state)
    assert any(x.vec for x in leaves) == (shapes != "ragged" and kind != "f64")
    for step in range(1, 4):
        grads = _grads(params, step, 4)
        bc1, bc2 = _bias_corrections(step)
        args = K.adam_stacked_args(params, grads, state, lr, bc1, bc2, B1,
                                   B2, EPS, grid)
        assert lib.adam_stacked_launch(*args, None) == 0
        P, _, MU, NU = card_step(P, _flat(grads, C), MU, NU, lr.numpy(), bc1,
                                 bc2, mu_dtype == BF16)
        assert _same_bits(_flat(params, C), P), step
        assert _same_bits(mu.float().numpy() if mu_dtype == BF16
                          else mu.numpy(), MU), step
        assert _same_bits(nu.numpy(), NU), step


def test_adam_stacked_source_emulated_rounds_bf16_ties_to_even(lib):
    """A bf16 mu stored from moments that lie halfway between two bf16
    values (b1 = 0.5, so that the first moment is half the gradient,
    exactly; gradients whose low 16 bits are 0x8000 under both kept bits):
    rounded to even, as torch converts, over two steps."""
    b1, C = 0.5, 2
    params = _stacked(SHAPES["aligned"], C, torch.float32, 6)
    state = stacked_adam_init(params, BF16)
    mu, nu = state.flat
    lr = _lr(C, torch.float32)
    P, MU, NU = _flat(params, C), mu.float().numpy().copy(), nu.numpy().copy()
    for step in (1, 2):
        grads = [_bf16_ties(g) for g in _grads(params, step, 6)]
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(step))
        bc2 = _bias_corrections(step)[1]
        G = _flat(grads, C)
        if step == 1:  # the stored moment is a tie, odd and even kept bits
            kept = (G * np.float32(1 - b1)).view(np.uint32)
            ties = (kept & 0xFFFF) == 0x8000
            odd = ((kept >> 16) & 1)[ties]
            assert ties.mean() > 0.8 and 0.3 < odd.mean() < 0.7
        args = K.adam_stacked_args(params, grads, state, lr, bc1, bc2, b1,
                                   B2, EPS, 3)
        assert lib.adam_stacked_launch(*args, None) == 0
        P, _, MU, NU = card_step(P, G, MU, NU, lr.numpy(), bc1, bc2, True,
                                 b1=b1)
        assert _same_bits(_flat(params, C), P), step
        assert _same_bits(mu.float().numpy(), MU), step
        assert _same_bits(nu.numpy(), NU), step


def _bf16_ties(x: torch.Tensor) -> torch.Tensor:
    """f32 values whose low 16 bits are 0x8000: halfway between two bf16
    values (exact zeros stay zero)."""
    u = x.view(torch.int32)
    tie = (u & ~0xFFFF) | 0x8000
    return torch.where(x == 0, x, tie.view(torch.float32))


def test_adam_stacked_launcher_refuses_a_table_it_cannot_run(lib):
    """The launcher checks the table before a launch: a 16-byte run asked
    where the size is no multiple of 4, or of a float64 state."""
    params = _stacked(SHAPES["aligned"], 2, torch.float32, 5)
    grads = _grads(params, 1, 5)
    args = list(K.adam_stacked_args(params, grads, stacked_adam_init(params),
                                    _lr(2, torch.float32), 0.1, 0.001, B1,
                                    B2, EPS, 4))
    vec = args[4]
    assert list(vec) == [1, 1, 1, 1]
    n = args[3]
    n[0] = 63
    assert lib.adam_stacked_launch(*args, None) != 0
    n[0] = 64
    args[11] = 2  # a float64 kind
    assert lib.adam_stacked_launch(*args, None) != 0
