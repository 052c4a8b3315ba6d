"""The training engine: train steps, epochs and the voted evaluation (the
JAX package's ``train/engine.py:49-831``), in each of its modes.

A step is the reference's (train.py:65-138): gather one window of every
task per item, forward both encoders, the fused contrastive loss (the K1
kernels on CUDA, ``ops/kernels.py``) plus the L2 penalties, backward, then
two Adam chains, one per encoder, with the lr times the epoch's schedule
factor applied outside them. PyTorch runs eagerly, so an epoch is a Python
loop over steps; its losses stay on the device and the host reads them
once per epoch.

``Trainer(use_fused_train=True)`` runs the EMG encoder's dense stack
through the fused training chain instead (``ops/train_fused.py``: the K5
kernels on CUDA), as the JAX package's flag of that name does
(``engine.py:315-357``). Its dropout masks come from two Philox seed words
per step, drawn from the same generator; they differ from the eager
path's masks, equally valid. At rate 0 both paths compute the same step.

``Trainer(remat=True)`` recomputes the step's forward in its backward
instead of keeping its activations, as the JAX package's field of that
name puts ``jax.checkpoint`` over the loss (``engine.py:168,396-410``):
the loss is ``torch.utils.checkpoint.checkpoint``-ed, eager or fused,
single or stacked. Its results are bit-equal to the stored forward's: the
recomputed forward redraws the same dropout bits (each explicit generator
set back to its state at the forward's start, then to where it stood), and
the running statistics move once, written after the backward (the first
forward's, ``layers.deferred_running_stats``). The forward's kernels (K1f,
K5f and the chain's tail forward) launch twice a step, the backward's
once.

Modes (``Trainer(prediction=, glove=, glove_encoding=)``, the JAX
package's switches): the contrastive default with the one-hot class
encoder; ``glove_encoding``, contrastive with class embeddings from an MLP
over each item's glove rows, whose gradient K1's backward carries; and
``prediction``, the reference's softmax baseline (models.py:175-196,
300-309): plain cross-entropy over the l2-normalised class scores of the
EMG tower's prediction head, or with ``glove`` of the glove MLP, with
only that tower trained and penalised. The baseline stays off the
kernels, as in JAX (``engine.py:358-390``): no K1, no fused chain, no
fused encoder; requests for the last two warn and run unfused. The modes
that read glove rows draw a glove task permutation beside the EMG one,
each epoch and evaluation, and gather the items modulo the glove corpus
(``engine.py:440-453``); the one-hot modes skip that draw and gather.

Randomness: every draw (init, task permutations, batch order, dropout)
comes from the ``torch.Generator`` the caller passes, on the store's
device. The ``*_from_indices`` entries take the index matrices instead, so
tests can feed the JAX package's.

The crossval sweep (``sweep_chunk`` and the ``sweep_*_from_indices``
entries; the JAX package's ``_sweep_run``/``_sweep_chunk_at``,
``engine.py:537-596``) trains a chunk of C configs as one stacked model
(``models/stacked.py``): ``loss_and_grads`` and ``_sgd_step`` take its
state as they take one config's, with (C,) hyperparameter tensors, and
launch the same kernels per step whatever C is; K1 runs once per step at
its config axis, (C, N, T, d). Config c's init and index
matrices come from its own generator, so they do not depend on the chunk
width; each dropout layer draws the whole chunk's masks at once from a
chunk generator, so, as in JAX, a config's masks depend on its chunk.
With ``use_fused_train`` the stacked step runs the fused chain at its
config axis (``fused_emg_embed`` on the ``StackedEMGNet``: the K5 kernels
and the tail pair launch once a step for all C, each config's Philox seed
words drawn from the chunk generator), as the JAX sweep vmaps its fused
step (``engine.py:315-357,586-590``).

``Trainer(use_fused_encoder=True)`` runs the voted evaluation's encoder
through the ``encoder_chain`` kernels (``ops/kernels.py``), as the JAX
package's flag of that name runs ``fused_encoder_logits``
(``engine.py:643-685``): the EMG tower and the class head folded once per
evaluation into one chain of GEMMs, with the running statistics absorbed,
and one chain call per batch. Only plain BatchNorm with all the classes
in the split folds so; an explicit request on another config warns and
runs the unfused path, as in JAX. The sweep's validation folds the chunk's
C configs once per pass (``fold_encoder_params`` on the stacked tower) and
runs one ``encoder_chain`` call per batch for all of them, at its config
axis.

Precision: the forward and backward run in f32 with cuDNN's TF32
convolutions off (``device.f32_convolutions``, as calibration does);
matmuls keep PyTorch's f32 default. ``Trainer(compute_dtype="bfloat16")``
(the JAX package's field, ``engine.py:138,252``) runs the EMG tower in
bf16, as ``cptpu-train --bf16`` does: every Conv2d and Linear rounds its
operands and output to bf16 (``models/layers.py``), the fused chain runs
its bf16 kernels, the fused-encoder evaluation folds in bf16 and runs
``encoder_chain``'s bf16 variant; parameters, running statistics,
gradients and the Adam moments stay f32, the class tower computes in f32
and the embeddings reach K1 in f32. A train step refuses a model of
another dtype than the trainer's; an evaluation takes the dtype of the
model it is given (a checkpoint carries none: the CLI loads it in the
trainer's). ``adam_mu_dtype="bfloat16"`` stores Adam's first
moment in bf16 (``engine.py:146-155``), as optax's ``mu_dtype``.

Under a mesh (``loss_and_grads``/``_sgd_step`` with ``mesh=``, as
``parallel/spmd.py::make_sharded_train_step`` calls them on a state from
``parallel/mesh.py::shard_state``) a step is the JAX package's sharded
``_sgd_step`` (``engine.py:392-428``, partitioned by GSPMD), with its
collectives written out: every rank is given the global batch and runs
its own items (dp); K1f/K1b run on them, the local mean loss scaled by
``N_local / N`` (so K1b's upstream is too) and summed over dp, and the
correct count summed; BatchNorm takes the global batch's statistics;
each dropout layer draws the global batch's masks from the step's
generator and keeps its own rows; the L2 penalty of a weight sharded over
mp is the whole weight's; the gradients are summed over dp and both Adam
chains run on the shards. Each path runs so: the fused chain on the
rank's rows (``ops/train_fused.py::DpRows``: K5f's sums summed over dp
and finished between launches, K5b given the global sums, the Philox
counters at the rank's global rows; under mp the chain and the head on
whole weights, gathered over mp), ``remat`` (the recompute repeats the
forward's collectives inside the backward, in the same order on every
rank) and a bf16 tower (its tensor-parallel layers round where the
unsharded ones do). Where dp has one rank no dp collective and no dp mode
of a kernel runs, so a world of one is the unsharded step bit for bit.
The state is one model's, as JAX's ``make_sharded_train_step`` takes;
the sweep shards whole chunks instead (``parallel/spmd.py``).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple

import numpy as np
import torch
import torch.utils.checkpoint

from contrastiveprosthetics_torch.config import Config
from contrastiveprosthetics_torch.data.sampler import (
    epoch_batches,
    epoch_batches_padded,
    gather_eval_batch,
    gather_glove_batch,
    gather_train_batch,
    identity_permutations,
    stacked_epoch_batches,
    stacked_epoch_batches_padded,
    stacked_gather_eval_batch,
    stacked_gather_glove_batch,
    stacked_gather_train_batch,
    stacked_task_permutations,
    task_permutations,
)
from contrastiveprosthetics_torch.data.store import DeviceStore, SplitView
from contrastiveprosthetics_torch.device import f32_convolutions
from contrastiveprosthetics_torch.eval.voting import vote_from_logits
from contrastiveprosthetics_torch.models.clip import (
    ContrastiveModel,
    l2_normalize,
    l2_penalty,
)
from contrastiveprosthetics_torch.models.glove_net import tower_mode
from contrastiveprosthetics_torch.models.layers import (
    deferred_running_stats,
    set_running,
    write_running,
)
from contrastiveprosthetics_torch.models.stacked import (
    StackedContrastiveModel,
    stacked_l2_penalty,
)
from contrastiveprosthetics_torch.ops.kernels import (
    adam_stacked,
    bf16_decay,
    fold_encoder_params,
    fused_contrastive_loss,
    fused_encoder_logits,
)
from contrastiveprosthetics_torch.ops.train_fused import (
    DpRows,
    fused_emg_embed,
)
from contrastiveprosthetics_torch.parallel.collectives import sum_flat
from contrastiveprosthetics_torch.parallel.mesh import (
    local_range,
    set_batch_rows,
)
from contrastiveprosthetics_torch.train.loss import (
    majority_vote,
    prediction_accuracy,
    prediction_loss,
    prediction_loss_per_item,
    symmetric_contrastive_loss,
    symmetric_contrastive_loss_per_item,
)
from contrastiveprosthetics_torch.utils.spans import span


class Hyper(NamedTuple):
    """The reference's ``params`` minus d_e and epochs (train.py:149-153);
    each value is an f32 number held as a Python float."""

    lr_emg: float
    reg_emg: float
    dp_emg: float
    lr_glove: float
    reg_glove: float
    dp_glove: float

    @classmethod
    def single(cls, lr_emg, reg_emg, dp_emg, lr_glove, reg_glove, dp_glove):
        return cls(*[float(np.float32(v)) for v in
                     (lr_emg, reg_emg, dp_emg, lr_glove, reg_glove, dp_glove)])


@dataclasses.dataclass
class AdamState:
    """``optax.scale_by_adam``'s state: the step count and both moments,
    one tensor per parameter, ``mu`` in f32 or bf16 (optax's
    ``mu_dtype``), ``nu`` f32. For stacked parameters
    (:func:`stacked_adam_init`) ``mu`` and ``nu`` are views of two flat
    (C, N) buffers, ``flat``, that the update runs over."""

    count: int
    mu: list
    nu: list
    flat: tuple | None = None


# the JAX Trainer's dtype names (compute_dtype, adam_mu_dtype)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def adam_init(params, mu_dtype: torch.dtype | None = None) -> AdamState:
    """Zeroed moments, ``mu`` in ``mu_dtype`` (None: the parameters' own,
    as optax's default)."""
    params = list(params)
    return AdamState(0, [torch.zeros_like(p, dtype=mu_dtype) for p in params],
                     [torch.zeros_like(p) for p in params])


def stacked_adam_init(params,
                      mu_dtype: torch.dtype | None = None) -> AdamState:
    """Zeroed moments of stacked parameters (C configs on the leading
    axis): each a (C, N) buffer, config c's moments of every parameter in
    row c, and a view of it per parameter; the first moment's in
    ``mu_dtype`` (None: the parameters' own)."""
    params = list(params)
    if not params:  # an idle tower
        return AdamState(0, [], [])
    sizes = [p[0].numel() for p in params]
    flat = tuple(params[0].new_zeros(params[0].shape[0], sum(sizes),
                                     dtype=dtype or params[0].dtype)
                 for dtype in (mu_dtype, None))
    mu, nu = ([part.view(p.shape) for part, p in zip(f.split(sizes, 1),
                                                      params)]
              for f in flat)
    return AdamState(0, mu, nu, flat)


def _f32_product(a: float, b: float) -> float:
    return float(np.float32(a) * np.float32(b))


@torch.no_grad()
def adam_step_(params, grads, state: AdamState, lr: float | torch.Tensor,
               b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> None:
    """One ``optax.scale_by_adam`` update (eps_root 0) followed by
    ``p -= lr * u``, in place over ``params`` and the moments, in optax's
    order of operations: mu = (1-b1) g + b1 mu, nu = (1-b2) g^2 + b2 nu,
    u = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps), with the bias
    corrections taken in f32. (``torch.optim.Adam`` orders the bias
    correction differently.) A bf16 ``mu`` (optax 0.2.6's ``mu_dtype``)
    takes ``b1 mu`` in bf16 and the sum in f32; the update is computed from
    that f32 moment, and only the stored ``mu`` is rounded to bf16.

    Stacked parameters (a state of :func:`stacked_adam_init`) take a (C,)
    ``lr``, one per config; the count and the bias corrections are shared,
    since all configs step together. Their update is one launch of the
    ``adam_stacked`` kernel over the flat (C, N) moments
    (``ops/kernels.py``; its plain version on the CPU): a foreach
    operation splits its work into launches by size, so its launches
    would grow with C."""
    params, grads = list(params), list(grads)
    state.count += 1
    if not params:  # an idle tower: optax counts the step all the same
        return
    t = np.float32(state.count)
    bc1 = float(np.float32(1) - np.float32(b1) ** t)
    bc2 = float(np.float32(1) - np.float32(b2) ** t)
    if state.flat is not None:
        adam_stacked(params, grads, state, lr, bc1, bc2, b1, b2, eps)
        return
    low = state.mu[0].dtype == torch.bfloat16
    if low:
        mu = torch._foreach_add([bf16_decay(m, b1) for m in state.mu],
                                torch._foreach_mul(grads, 1 - b1))
    else:
        mu = state.mu
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - b1))
    torch._foreach_mul_(state.nu, b2)
    torch._foreach_add_(state.nu, torch._foreach_mul(
        torch._foreach_mul(grads, grads), 1 - b2))
    denom = torch._foreach_div(state.nu, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    update = torch._foreach_div(mu, bc1)
    torch._foreach_div_(update, denom)
    torch._foreach_mul_(update, lr)
    torch._foreach_sub_(params, update)
    if low:
        torch._foreach_copy_(state.mu, mu)


def rematerialized(forward, generator: torch.Generator | None):
    """``forward()`` under ``torch.utils.checkpoint`` (non-reentrant): its
    activations are recomputed in the backward. The explicit ``generator``
    the forward draws from (None: none) is set back to its state at the
    forward's start for the recompute, then to where it stood, so the
    recompute draws the forward's bits and the next draw is the one it
    would be without remat (``preserve_rng_state`` covers only the global
    generators). Running statistics are recorded, not written
    (``layers.deferred_running_stats``): returns ``(forward's outputs,
    the first forward's (buffer, value) pairs)`` for the caller to write
    after the backward."""
    gens = [] if generator is None else [generator]
    start: list = []
    records: list = []  # one list of pairs a run of the forward

    def region():
        replay = bool(records)
        if replay:  # the recompute, inside the backward
            now = [g.get_state() for g in gens]
            for g, st in zip(gens, start):
                g.set_state(st)
        else:
            start.extend(g.get_state() for g in gens)
        try:
            with deferred_running_stats() as pending:
                records.append(pending)
                return forward()
        finally:
            if replay:
                for g, st in zip(gens, now):
                    g.set_state(st)

    out = torch.utils.checkpoint.checkpoint(region, use_reentrant=False,
                                            preserve_rng_state=False)
    return out, records[0]


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BatchNorm running statistics, f32; the
    EMG tower's compute dtype is the model's) and the two Adam chains,
    over ``model.towers()``."""

    model: ContrastiveModel
    opt_emg: AdamState
    opt_glove: AdamState

    @classmethod
    def fresh(cls, model: ContrastiveModel,
              mu_dtype: torch.dtype | None = None) -> "TrainState":
        towers = model.towers()
        init = (stacked_adam_init
                if isinstance(model, StackedContrastiveModel) else adam_init)
        return cls(model, init(towers["emg_net"].parameters(), mu_dtype),
                   init(towers["glove_net"].parameters(), mu_dtype))


class EvalResult(NamedTuple):
    loss: torch.Tensor      # scalar mean loss over the split's items
    accuracy: torch.Tensor  # scalar voted accuracy
    curve: torch.Tensor     # (D, n_prefix) voting curves, item order
    y_pred: torch.Tensor    # (D, T)
    y_true: torch.Tensor    # (D, T)
    logits: torch.Tensor    # (D*W, T, T) raw logits, item order


@dataclasses.dataclass
class Trainer:
    """Train steps, epochs and evaluation over one store, in one mode
    (see the module docstring)."""

    cfg: Config
    store: DeviceStore
    db2: bool = False
    adabn: bool = True
    prediction: bool = False
    glove: bool = False            # prediction mode: classify from glove
    glove_encoding: bool = False   # contrastive: encode angles, not one-hot
    d_e: int = 16
    batch_size: int = 8
    n_linear: int = 7
    hidden: int = 512
    conv_features: int = 64
    # the fused training chain for the EMG tower's dense stack; None is
    # off, as in the JAX package, until a benchmark's A/B on the card says
    # otherwise (PERF.md)
    use_fused_train: bool | None = None
    # the voted evaluation's encoder on the encoder_chain kernels; None is
    # off, as in the JAX package, until a benchmark's A/B on the card says
    # otherwise
    use_fused_encoder: bool | None = None
    # the EMG tower's compute dtype, "float32" or "bfloat16" (mixed
    # precision: parameters, statistics and the optimizer stay f32)
    compute_dtype: str = "float32"
    # Adam's first moment stored in "float32" or "bfloat16" (optax's
    # mu_dtype); the second stays f32
    adam_mu_dtype: str = "float32"
    # recompute the step's forward in its backward (jax.checkpoint over the
    # loss); off, as in the JAX package
    remat: bool = False

    def __post_init__(self):
        for name in ("compute_dtype", "adam_mu_dtype"):
            if getattr(self, name) not in DTYPES:
                raise ValueError(f"{name} {getattr(self, name)!r}: want one "
                                 f"of {sorted(DTYPES)}")
        self.dtype = DTYPES[self.compute_dtype]
        # "float32" is optax's default: mu in the parameters' dtype
        self.mu_dtype = (torch.bfloat16 if self.adam_mu_dtype == "bfloat16"
                         else None)
        self.use_fused_train = bool(self.use_fused_train)
        self.use_fused_encoder = bool(self.use_fused_encoder)
        # the modes whose class tower reads glove rows
        self.reads_glove = tower_mode(self.prediction, self.glove,
                                      self.glove_encoding) == "mlp"
        if self.use_fused_train and self.prediction:
            # never let an explicit request silently measure the eager
            # path (engine.py:229-240)
            warnings.warn(
                "use_fused_train requested but prediction mode is "
                "ineligible (the fused chain trains the contrastive "
                "embedding only); falling back to the eager train path.",
                stacklevel=3)
            self.use_fused_train = False
        self.device = self.store.device
        self.view_train = self.store.view("train", db2=self.db2)
        self.view_val = self.store.view("val", db2=self.db2)
        self.view_test = self.store.view("test", db2=self.db2)

    def generator(self, seed: int) -> torch.Generator:
        """A generator on the store's device, seeded ``seed``."""
        return torch.Generator(self.device).manual_seed(seed)

    # ------------------------------------------------------------------ init
    def _model(self, generator: torch.Generator) -> ContrastiveModel:
        return ContrastiveModel(
            d_e=self.d_e, emg_dim=self.cfg.emg_dim,
            n_classes=self.cfg.max_tasks, adabn=self.adabn,
            n_linear=self.n_linear, hidden=self.hidden,
            conv_features=self.conv_features, prediction=self.prediction,
            glove=self.glove, glove_encoding=self.glove_encoding,
            glove_dim=self.cfg.glove_dim,
            generator=generator, device=self.device, dtype=self.dtype)

    def init_state(self, generator: torch.Generator) -> TrainState:
        """A fresh model (torch's default init from ``generator``) in the
        trainer's compute dtype, with zeroed Adam chains."""
        return TrainState.fresh(self._model(generator), self.mu_dtype)

    def init_sweep_state(self, generators) -> TrainState:
        """C fresh models, config c's drawn from ``generators[c]``, as one
        stacked model with zeroed stacked Adam chains."""
        return TrainState.fresh(StackedContrastiveModel.from_models(
            [self._model(g) for g in generators]), self.mu_dtype)

    # ------------------------------------------------------------- train step
    def _embed_fused(self, model: ContrastiveModel, emg_b, dp_emg,
                     generator: torch.Generator | None, ext_masks,
                     glove_b=None, dp_glove=0.0, dp_rows=None):
        """``model.embed`` with the EMG tower's dense stack on the fused
        chain and the class tower through ``model.embed_glove`` (the JAX
        ``engine.py:315-357``); a plain-BatchNorm model's running
        statistics move as in the eager forward, the glove MLP's too.
        ``ext_masks``: explicit dropout masks of the chain (the tests; the
        global batch's under a mesh). ``dp_rows``: the chain's dp form
        (``ops/train_fused.py::DpRows``) on a dp rank's items.

        A stacked model (C configs, ``emg_b`` (C, B, T, emg_dim), the
        rates (C,) tensors) runs the chain at its config axis with one
        pair of seed words a config; with no ``generator`` it drops
        nothing, as the eager stacked tower."""
        stacked = isinstance(model, StackedContrastiveModel)
        lead = emg_b.shape[:1] if stacked else ()
        B, T = emg_b.shape[-3:-1]
        seeds = None
        if ext_masks is None:
            if generator is not None:
                seeds = torch.randint(-2**31, 2**31, (*lead, 2),
                                      dtype=torch.int32, generator=generator,
                                      device=self.device)
            elif stacked or dp_emg == 0.0:  # every mask keeps everything
                seeds = torch.zeros((*lead, 2), dtype=torch.int32,
                                    device=self.device)
                if stacked:
                    dp_emg = torch.zeros_like(dp_emg)
            else:
                raise ValueError("dropout at a nonzero rate needs an explicit "
                                 "torch.Generator for its mask")
        e, stats = fused_emg_embed(
            model.emg_net, emg_b.reshape(*lead, -1, emg_b.shape[-1]), dp_emg,
            seeds, mask_mode="prng" if ext_masks is None else "input",
            ext_masks=ext_masks or (), dp=dp_rows)
        if stats is not None:
            set_running([t for bn in model.emg_net.norms()
                         for t in (bn.running_mean, bn.running_var)],
                        [t for mv in stats for t in mv])
        if stacked:
            g = l2_normalize(model._class_rows(B, T, glove_b, dp_glove,
                                               generator))
            g = g.reshape(*lead, B, T, -1)
        elif glove_b is None:
            g = l2_normalize(model._class_rows(B, T).reshape(B, T, -1))
        else:
            g = model.embed_glove(glove_b, dp_glove, generator)
        return l2_normalize(e.reshape(*lead, B, T, -1)), g

    def _sharded_batch(self, state: TrainState, mesh, emg_b, glove_b):
        """This rank's items of the global batch under ``mesh``, its
        dropout layers set to keep them, their share of the batch, and the
        fused chain's dp form of them (None where dp has one rank)."""
        if isinstance(state.model, StackedContrastiveModel):
            raise ValueError(
                "the sharded step takes one model's state, as JAX's "
                "make_sharded_train_step does; a sweep shards whole chunks "
                "of configs (parallel/spmd.py::make_sharded_crossval_run)")
        B, T = emg_b.shape[:2]
        lo, hi = local_range(B, mesh.n_dp, mesh.dp_rank)
        if hi == lo:
            raise ValueError(f"a batch of {B} items leaves dp rank "
                             f"{mesh.dp_rank} of {mesh.n_dp} none")
        set_batch_rows(state.model, (B, lo, hi))
        rows = None if mesh.n_dp == 1 else DpRows(mesh.dp_group, lo * T,
                                                  B * T)
        return (emg_b[lo:hi], None if glove_b is None else glove_b[lo:hi],
                (hi - lo) / B, rows)

    def loss_and_grads(self, state: TrainState, emg_b: torch.Tensor,
                       hyper: Hyper, generator: torch.Generator | None,
                       ext_masks=None, glove_b: torch.Tensor | None = None,
                       mesh=None):
        """Forward (train mode: batch statistics, which also move the
        running ones), the loss plus ``reg * l2`` of each tower, and the
        gradients of that total. The loss is the fused contrastive loss,
        or in prediction mode the cross-entropy of the normalized scores
        against labels ``arange(T)`` per item (``engine.py:376-384``).
        Returns (loss, accuracy, grads by tower), the first two 0-d
        tensors on the device. ``glove_b`` (B, T, glove_dim): the glove
        rows of the modes that read them. ``ext_masks`` (fused chain
        only) replaces the chain's drawn dropout masks.

        A stacked state (C configs) takes ``emg_b`` (C, B, T, emg_dim) and
        a ``hyper`` of (C,) f32 tensors on the device; its loss and
        accuracy are (C,), and the gradients are those of the sum over
        configs of each config's total, so each config gets its own and
        K1's backward one upstream 1 per config. With no ``generator`` the
        stacked model drops nothing (every rate must be 0).

        With ``remat`` the forward runs again inside the backward (see the
        module docstring); the results are the same bits.

        Under ``mesh`` (a state of ``parallel/mesh.py::shard_state``) the
        step is sharded (see the module docstring): ``emg_b`` and
        ``glove_b`` are the global batch, every rank's the same, and the
        loss, the accuracy and the gradients of this rank's shards come
        back as the unsharded step's."""
        if state.model.dtype != self.dtype:
            # the step runs in the model's dtype: a state of the other one
            # would train in a dtype this trainer was not built for
            raise ValueError(f"a {state.model.dtype} model given to a "
                             f"Trainer of compute_dtype "
                             f"{self.compute_dtype!r}")
        model = state.model.train()
        stacked = isinstance(model, StackedContrastiveModel)
        l2 = stacked_l2_penalty if stacked else l2_penalty
        towers = model.towers()
        params = {k: list(t.parameters()) for k, t in towers.items()}
        share, n_dp, emg_b_rows, dp_rows = 1.0, 1, emg_b.shape[-3], None
        if mesh is not None:
            emg_b, glove_b, share, dp_rows = self._sharded_batch(
                state, mesh, emg_b, glove_b)
            n_dp = mesh.n_dp
        B, T = emg_b.shape[-3:-1]

        def forward():
            if self.prediction:
                scores = model(emg_b, hyper.dp_emg, generator, glove_b,
                               hyper.dp_glove)
                labels = torch.arange(T, device=scores.device).repeat(B)
                loss = prediction_loss(scores, labels)
                acc = prediction_accuracy(scores, labels)
                if mesh is not None:  # the rows right, a count
                    acc = (scores.argmax(-1) == labels).sum().to(loss.dtype)
            else:
                if self.use_fused_train:
                    e, g = self._embed_fused(model, emg_b, hyper.dp_emg,
                                             generator, ext_masks, glove_b,
                                             hyper.dp_glove, dp_rows)
                else:
                    e, g = model.embed(emg_b, hyper.dp_emg, generator,
                                       glove_b, hyper.dp_glove)
                loss, correct = fused_contrastive_loss(e.contiguous(),
                                                       g.contiguous())
                acc = correct / (B * T) if mesh is None else correct
            penalty = (hyper.reg_emg * l2(towers["emg_net"])
                       + hyper.reg_glove * l2(towers["glove_net"]))
            if mesh is None:
                return loss + penalty, loss, acc
            # this rank's share of the global mean, the penalty once over dp
            loss = loss * share
            return loss + penalty / n_dp, loss, acc

        # the spans here, not in forward(): remat replays forward() inside
        # the backward
        with span("cptorch.train.forward", timed=True), f32_convolutions():
            if self.remat:
                (total, loss, acc), running = rematerialized(forward,
                                                             generator)
            else:
                total, loss, acc = forward()
        with span("cptorch.train.backward", timed=True):
            with f32_convolutions():
                flat = torch.autograd.grad(
                    total.sum(), params["emg_net"] + params["glove_net"])
            if self.remat:
                write_running(running)
            loss = loss.detach()
            if mesh is not None:
                flat = sum_flat(flat, mesh.dp_group)
                loss, hits = sum_flat((loss, acc.detach()), mesh.dp_group)
                acc = hits / (emg_b_rows * T)
        n = len(params["emg_net"])
        grads = {"emg_net": list(flat[:n]), "glove_net": list(flat[n:])}
        return loss, acc, grads

    def _sgd_step(self, state: TrainState, emg_b, hyper: Hyper,
                  lr_emg: float | torch.Tensor, lr_glove: float | torch.Tensor,
                  generator: torch.Generator | None, ext_masks=None,
                  glove_b: torch.Tensor | None = None, mesh=None):
        """One optimization step: forward, loss + L2, backward, then the
        two Adam updates. Returns (loss, accuracy) on the device. On a
        stacked state (see :meth:`loss_and_grads`) it is one step of every
        config, with (C,) lr tensors; under ``mesh`` one sharded step,
        each rank's Adam chains on its shards. Under ``torch.profiler`` it
        runs in the span ``cptorch.train.step``, whose children
        ``cptorch.train.forward``, ``.backward`` and ``.adam`` partition
        it (``utils/spans.py``)."""
        with span("cptorch.train.step", timed=True):
            loss, acc, grads = self.loss_and_grads(
                state, emg_b, hyper, generator, ext_masks, glove_b, mesh)
            towers = state.model.towers()
            with span("cptorch.train.adam", timed=True):
                adam_step_(towers["emg_net"].parameters(), grads["emg_net"],
                           state.opt_emg, lr_emg)
                adam_step_(towers["glove_net"].parameters(),
                           grads["glove_net"], state.opt_glove, lr_glove)
            return loss, acc

    # ----------------------------------------------------------------- epoch
    def train_epoch_from_indices(self, state: TrainState, emg_rand, batches,
                                 tail, hyper: Hyper, lr_emg_factor: float,
                                 lr_glove_factor: float,
                                 generator: torch.Generator | None,
                                 ext_masks=None, glove_rand=None):
        """One epoch over given index matrices: ``emg_rand`` (n_tasks, D)
        task permutations, ``batches`` (n_batches, bs) and the (D % bs,)
        ``tail``, which trains as a smaller batch (DataLoader
        ``drop_last=False``, train.py:86), and in the modes that read glove
        rows ``glove_rand`` (n_tasks, D_glove). ``ext_masks``, for the
        fused chain in tests, holds each step's explicit dropout masks.
        Returns the per-step losses and accuracies, on the device."""
        v = self.view_train
        lr_e = _f32_product(hyper.lr_emg, lr_emg_factor)
        lr_g = _f32_product(hyper.lr_glove, lr_glove_factor)
        steps = list(batches) + ([tail] if tail.numel() else [])
        losses, accs = [], []
        for i, items in enumerate(steps):
            emg_b = gather_train_batch(v.emg_flat, emg_rand, items)
            glove_b = None
            if self.reads_glove:
                glove_b = gather_glove_batch(v.glove_flat, glove_rand, items,
                                             v.D_glove)
            loss, acc = self._sgd_step(
                state, emg_b, hyper, lr_e, lr_g, generator,
                None if ext_masks is None else ext_masks[i], glove_b)
            losses.append(loss)
            accs.append(acc)
        return torch.stack(losses), torch.stack(accs)

    def train_epoch(self, state: TrainState, generator: torch.Generator,
                    hyper: Hyper, lr_emg_factor: float = 1.0,
                    lr_glove_factor: float = 1.0):
        """One epoch: task permutations (the glove ones too where the mode
        reads glove rows) and batch order from ``generator``, then every
        step. Returns (state, mean loss, mean accuracy), the last two on
        the device; ``state`` is updated in place."""
        v = self.view_train
        emg_rand, glove_rand = self._permutations(generator, v)
        batches, tail = epoch_batches(generator, v.D, self.batch_size)
        losses, accs = self.train_epoch_from_indices(
            state, emg_rand, batches, tail, hyper, lr_emg_factor,
            lr_glove_factor, generator, glove_rand=glove_rand)
        return state, losses.mean(), accs.mean()

    def train_epochs(self, state: TrainState, generator: torch.Generator,
                     hyper: Hyper, emg_factors, glove_factors):
        """``len(emg_factors)`` epochs, one schedule factor each. Returns
        (state, per-epoch losses, per-epoch accuracies) on the device."""
        losses, accs = [], []
        for f_e, f_g in zip(emg_factors, glove_factors):
            state, loss, acc = self.train_epoch(state, generator, hyper,
                                                float(f_e), float(f_g))
            losses.append(loss)
            accs.append(acc)
        return state, torch.stack(losses), torch.stack(accs)

    def _permutations(self, generator: torch.Generator, view: SplitView):
        """(emg_rand, glove_rand) of one epoch or evaluation; glove_rand
        is None in the modes that read no glove rows (and is not drawn)."""
        emg_rand = task_permutations(generator, view.n_tasks, view.D)
        if not self.reads_glove:
            return emg_rand, None
        return emg_rand, task_permutations(generator, view.n_tasks,
                                           view.D_glove)

    # ------------------------------------------------------------------ eval
    def evaluate(self, state: TrainState, generator: torch.Generator,
                 hyper: Hyper, split: str = "val",
                 batch_size: int | None = None) -> EvalResult:
        """Voted evaluation of a split. Val batches hold ``batch_size``
        items, test ``8 * batch_size`` (train.py:32,51)."""
        if batch_size is None:
            batch_size = self.batch_size * (1 if split == "val" else 8)
        v = {"val": self.view_val, "test": self.view_test}[split]
        emg_rand, glove_rand = self._permutations(generator, v)
        batches, weights, inverse = epoch_batches_padded(generator, v.D,
                                                         batch_size)
        return self.evaluate_from_indices(state, v, emg_rand, batches,
                                          weights, inverse, glove_rand)

    def _fused_encoder_on(self, n_tasks: int) -> bool:
        """Whether a voted evaluation of ``n_tasks`` tasks runs the
        ``encoder_chain`` kernels: on request, contrastive with the one-hot
        class encoder, plain BatchNorm and every class
        (``engine.py:200-203,643-657``). A request on another config warns
        and runs the unfused path."""
        if not self.use_fused_encoder:
            return False
        if (not self.adabn and not self.prediction and not self.glove_encoding
                and n_tasks == self.cfg.max_tasks):
            return True
        warnings.warn(
            "use_fused_encoder requested but this eval config is ineligible "
            "(needs plain-BN contrastive one-hot and n_tasks == "
            f"{self.cfg.max_tasks}); falling back to the unfused path",
            stacklevel=3)
        return False

    def _prediction_items(self, scores: torch.Tensor, bs: int, T: int):
        """The softmax baseline's evaluation of one batch of ``bs`` items
        (``engine.py:686-716``): the (..., bs) per-item mean CE over every
        frame of the item and the (..., bs, T) votes, the majority over
        each row's W frames, or without a vote window (glove prediction)
        one argmax per row. ``scores``: (..., bs*T, W, C), or (...,
        bs*T, C) in glove prediction."""
        labels = torch.arange(T, device=scores.device).repeat(bs)
        if self.glove:
            return (prediction_loss_per_item(scores, labels, bs),
                    scores.argmax(dim=-1).unflatten(-1, (bs, T)))
        W = scores.shape[-2]
        loss = prediction_loss_per_item(scores.flatten(-3, -2),
                                        labels.repeat_interleave(W), bs)
        return loss, majority_vote(scores).unflatten(-1, (bs, T))

    @torch.no_grad()
    def evaluate_from_indices(self, state: TrainState, view: SplitView,
                              emg_rand, batches, weights, inverse,
                              glove_rand=None) -> EvalResult:
        """Every item once: padded batches (``weights`` 0 on the pad
        duplicates, which the loss leaves out), per-item outputs back in
        item order through ``inverse`` (engine.py:624-749); ``glove_rand``
        (n_tasks, D_glove) in the modes that read glove rows. With the
        fused encoder, each batch's frames go through one
        ``encoder_chain`` call in (item, task, frame) row order, and its
        scores are put in the model's (item, frame) vote order
        (``engine.py:671-673``).

        Prediction mode (``engine.py:686-716``): the loss is the per-item
        CE, each item's curve its share of tasks voted right, the same at
        every prefix, ``y_true`` is ``arange(T)`` per item and the logits
        are zeros of the contrastive shape, as the JAX package writes
        them."""
        model = state.model.eval()
        W = self.cfg.prediction_window_size
        n_prefix = self.cfg.n_voting_cols
        T = view.n_tasks
        folded = None
        if self._fused_encoder_on(T):
            # in the model's dtype: a bf16 fold runs encoder_chain's bf16
            # variant (engine.py:671)
            folded = fold_encoder_params(model.emg_net, model.encode_classes(),
                                         dtype=model.dtype)
        loss_sums, curves, y_preds, y_trues, logits_all = [], [], [], [], []
        with f32_convolutions():
            for items, w in zip(batches, weights):
                bs = items.shape[0]
                emg_b = gather_eval_batch(view.emg_groups, emg_rand, items)
                glove_b = None
                if self.reads_glove:
                    glove_b = gather_glove_batch(view.glove_flat, glove_rand,
                                                 items, view.D_glove)
                if self.prediction:
                    item_loss, votes = self._prediction_items(
                        model(emg_b, glove=glove_b), bs, T)
                    tasks = torch.arange(T, device=votes.device)
                    loss_sums.append((item_loss * w).sum())
                    curves.append((votes == tasks).float().mean(-1)[:, None]
                                  .expand(bs, n_prefix))
                    y_preds.append(votes)
                    y_trues.append(tasks.expand(bs, T))
                    logits_all.append(emg_b.new_zeros(bs, W, T, T))
                    continue
                if folded is None:
                    logits = model(emg_b, glove=glove_b)  # (bs*W, T, T)
                else:
                    scores = fused_encoder_logits(
                        emg_b.reshape(-1, emg_b.shape[-1]), folded)
                    logits = scores.reshape(bs, T, W, T).transpose(1, 2) \
                        .reshape(bs * W, T, T)
                item_loss = symmetric_contrastive_loss_per_item(
                    logits).reshape(bs, W).mean(dim=-1)
                res = vote_from_logits(logits, window=W, n_prefix=n_prefix)
                loss_sums.append((item_loss * w).sum())
                curves.append(res.curve)
                y_preds.append(res.y_pred)
                y_trues.append(res.y_true)
                logits_all.append(logits.reshape(bs, W, T, T))
        curve = torch.cat(curves)[inverse]
        return EvalResult(
            loss=torch.stack(loss_sums).sum() / view.D,
            accuracy=curve[:, -1].mean(),
            curve=curve,
            y_pred=torch.cat(y_preds)[inverse],
            y_true=torch.cat(y_trues)[inverse],
            logits=torch.cat(logits_all)[inverse].reshape(-1, T, T))

    @torch.no_grad()
    def evaluate_per_subject(self, state: TrainState,
                             hyper: Hyper | None = None,
                             split: str = "test") -> EvalResult:
        """Each subject's items as one batch (``--per_subject_eval``; the
        JAX package's ``engine.py:758-818``), so that under AdaBN the batch
        statistics come from that subject alone, the reference's stated
        intent (models.py:245). The eval items are (person, rep, group)
        row-major, so a subject's items are one contiguous block, gathered
        through identity task permutations (the glove rows too, in glove
        encoding); the outputs stay in item order. The loss is the mean of
        the subjects' mean losses. Deterministic, so it takes no generator.
        Contrastive modes only, as in the JAX package."""
        if self.prediction:
            raise ValueError("per-subject evaluation scores contrastive "
                             "logits; the softmax baseline has none")
        v = {"val": self.view_val, "test": self.view_test}[split]
        model = state.model.eval()
        W = self.cfg.prediction_window_size
        n_prefix = self.cfg.n_voting_cols
        T = v.n_tasks
        subjects = torch.arange(v.D, device=self.device).reshape(
            v.n_people, v.D // v.n_people)
        emg_rand = identity_permutations(T, v.D, device=self.device)
        glove_rand = identity_permutations(T, v.D_glove, device=self.device)
        losses, curves, y_preds, y_trues, logits_all = [], [], [], [], []
        with f32_convolutions():
            for items in subjects:
                glove_b = None
                if self.reads_glove:
                    glove_b = gather_glove_batch(v.glove_flat, glove_rand,
                                                 items, v.D_glove)
                logits = model(gather_eval_batch(v.emg_groups, emg_rand,
                                                 items), glove=glove_b)
                res = vote_from_logits(logits, window=W, n_prefix=n_prefix)
                losses.append(symmetric_contrastive_loss(logits))
                curves.append(res.curve)
                y_preds.append(res.y_pred)
                y_trues.append(res.y_true)
                logits_all.append(logits)
        curve = torch.cat(curves)
        return EvalResult(
            loss=torch.stack(losses).mean(), accuracy=curve[:, -1].mean(),
            curve=curve, y_pred=torch.cat(y_preds), y_true=torch.cat(y_trues),
            logits=torch.cat(logits_all))

    # ----------------------------------------------------------------- sweep
    def sweep_epoch_from_indices(self, state: TrainState, emg_rand, batches,
                                 tail, hyper: Hyper, lr_emg_factor: float,
                                 lr_glove_factor: float,
                                 generator: torch.Generator | None,
                                 glove_rand=None):
        """One epoch of every config of a stacked state over given index
        matrices, one stacked step per batch: ``emg_rand`` (C, n_tasks, D),
        ``batches`` (C, n_batches, bs) and the (C, D % bs) ``tail``, which
        trains as a smaller batch, and ``glove_rand`` (C, n_tasks,
        D_glove) in the modes that read glove rows. ``hyper`` holds (C,)
        f32 tensors on the device; config c's lr is its lr times the
        factor, in f32.
        ``generator`` draws the dropout masks (None: no dropout, every rate
        0). Returns the (C, steps) losses and accuracies on the device."""
        v = self.view_train
        lr_e = hyper.lr_emg * float(np.float32(lr_emg_factor))
        lr_g = hyper.lr_glove * float(np.float32(lr_glove_factor))
        steps = list(batches.unbind(1)) + ([tail] if tail.shape[1] else [])
        losses, accs = [], []
        for items in steps:
            emg_b = stacked_gather_train_batch(v.emg_flat, emg_rand, items)
            glove_b = None
            if self.reads_glove:
                glove_b = stacked_gather_glove_batch(v.glove_flat, glove_rand,
                                                     items, v.D_glove)
            loss, acc = self._sgd_step(state, emg_b, hyper, lr_e, lr_g,
                                       generator, glove_b=glove_b)
            losses.append(loss)
            accs.append(acc)
        return torch.stack(losses, 1), torch.stack(accs, 1)

    @torch.no_grad()
    def sweep_evaluate_from_indices(self, state: TrainState,
                                    view: SplitView, emg_rand, batches,
                                    weights, inverse, glove_rand=None):
        """The voted evaluation of every config of a stacked state, the
        metrics only (the JAX ``_evaluate_scalars``): ``emg_rand`` (C,
        n_tasks, D), padded ``batches`` and ``weights`` (C, n_batches,
        bs), ``inverse`` (C, D) and ``glove_rand`` (C, n_tasks, D_glove),
        each config's as :meth:`evaluate_from_indices` takes them. Returns
        (C,) mean losses and (C,) voted accuracies on the device. With the
        fused encoder the chunk is folded once (every config's chain,
        stacked) and each batch's (C, bs*T*W) frames go through one
        ``encoder_chain`` call, in (item, task, frame) row order per
        config, as :meth:`evaluate_from_indices` runs one config's."""
        model = state.model.eval()
        W = self.cfg.prediction_window_size
        T = view.n_tasks
        C, _, bs = batches.shape
        folded = None
        if self._fused_encoder_on(T):
            folded = fold_encoder_params(model.emg_net, model.encode_classes(),
                                         dtype=model.dtype)
        loss_sums, voted = [], []
        with f32_convolutions():
            for items, w in zip(batches.unbind(1), weights.unbind(1)):
                emg_b = stacked_gather_eval_batch(view.emg_groups, emg_rand,
                                                  items)
                glove_b = None
                if self.reads_glove:
                    glove_b = stacked_gather_glove_batch(
                        view.glove_flat, glove_rand, items, view.D_glove)
                if self.prediction:
                    item_loss, votes = self._prediction_items(
                        model(emg_b, glove=glove_b), bs, T)
                    loss_sums.append((item_loss * w).sum(1))
                    voted.append((votes == torch.arange(
                        T, device=votes.device)).float().mean(-1))
                    continue
                if folded is None:
                    logits = model(emg_b, glove=glove_b)  # (C, bs*W, T, T)
                else:
                    scores = fused_encoder_logits(
                        emg_b.reshape(C, -1, emg_b.shape[-1]), folded)
                    logits = scores.reshape(C, bs, T, W, T).transpose(2, 3) \
                        .reshape(C, bs * W, T, T)
                item_loss = symmetric_contrastive_loss_per_item(
                    logits).reshape(C, bs, W).mean(dim=-1)
                res = vote_from_logits(logits.reshape(-1, T, T), window=W,
                                       n_prefix=self.cfg.n_voting_cols)
                loss_sums.append((item_loss * w).sum(1))
                voted.append(res.curve[:, -1].reshape(C, bs))
        accuracy = torch.cat(voted, 1).gather(1, inverse).mean(1)
        return torch.stack(loss_sums, 1).sum(1) / view.D, accuracy

    def sweep_chunk(self, hyper: Hyper, generators, emg_factors,
                    glove_factors, generator: torch.Generator | None):
        """One sweep chunk, the JAX ``_sweep_run`` of each of its C configs
        (``engine.py:537-596``): init, one epoch per schedule factor, then
        the voted validation. ``hyper`` holds (C,) f32 numpy arrays (the
        sampler's), ``generators`` one torch generator per config on the
        store's device (init, epochs and val draw from it in turn), and
        ``generator`` the chunk's dropout masks. Returns (C,) val losses and
        accuracies on the device."""
        state, h = self.sweep_start(hyper, generators, generator)
        for f_e, f_g in zip(emg_factors, glove_factors):
            self.sweep_epoch(state, h, generators, f_e, f_g, generator)
        return self.sweep_validate(state, generators)

    def sweep_start(self, hyper: Hyper, generators,
                    generator: torch.Generator | None):
        """A chunk's stacked initial state, config c's drawn from
        ``generators[c]``, and its ``hyper`` as (C,) f32 tensors on the
        device (:meth:`sweep_chunk`)."""
        rates = [hyper.dp_glove] if self.reads_glove else []
        if not (self.prediction and self.glove):
            rates.append(hyper.dp_emg)
        if generator is None and np.any(np.asarray(rates)):
            raise ValueError("dropout at a nonzero rate needs an explicit "
                             "torch.Generator for its masks")
        state = self.init_sweep_state(generators)
        return state, Hyper(*[torch.as_tensor(np.asarray(x, np.float32),
                                              device=self.device)
                              for x in hyper])

    def sweep_epoch(self, state: TrainState, hyper: Hyper, generators,
                    lr_emg_factor: float, lr_glove_factor: float,
                    generator: torch.Generator | None):
        """One epoch of a chunk (:meth:`sweep_chunk`): each config's index
        matrices from its generator, the dropout masks from ``generator``.
        Returns the (C, steps) losses and accuracies on the device."""
        v = self.view_train
        emg_rand, glove_rand = self._stacked_permutations(generators, v)
        batches, tail = stacked_epoch_batches(generators, v.D,
                                              self.batch_size)
        return self.sweep_epoch_from_indices(
            state, emg_rand, batches, tail, hyper, float(lr_emg_factor),
            float(lr_glove_factor), generator, glove_rand)

    def sweep_validate(self, state: TrainState, generators):
        """A chunk's voted validation (:meth:`sweep_chunk`): (C,) losses and
        accuracies on the device."""
        v = self.view_val
        emg_rand, glove_rand = self._stacked_permutations(generators, v)
        return self.sweep_evaluate_from_indices(
            state, v, emg_rand,
            *stacked_epoch_batches_padded(generators, v.D, self.batch_size),
            glove_rand)

    def _stacked_permutations(self, generators, view: SplitView):
        """:meth:`_permutations` of each config's generator, stacked."""
        emg_rand = stacked_task_permutations(generators, view.n_tasks, view.D)
        if not self.reads_glove:
            return emg_rand, None
        return emg_rand, stacked_task_permutations(generators, view.n_tasks,
                                                   view.D_glove)
