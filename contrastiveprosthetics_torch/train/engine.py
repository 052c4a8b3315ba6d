"""The training engine: contrastive train steps, epochs and the voted
evaluation (the JAX package's ``train/engine.py:49-831``, contrastive mode
only).

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
The sweep runs the eager tower only (the fused chain takes no config
axis yet).

``Trainer(use_fused_encoder=True)`` runs the voted evaluation's encoder
through the ``encoder_chain`` kernels (``ops/kernels.py``), as the JAX
package's flag of that name runs ``fused_encoder_logits``
(``engine.py:643-685``): the EMG tower and the class head folded once per
evaluation into one chain of GEMMs, with the running statistics absorbed,
and one chain call per batch. Only plain BatchNorm with all the classes
in the split folds so; an explicit request on another config warns and
runs the unfused path, as in JAX. The sweep's validation would need the
chain once per config, which the kernels cannot take yet, so a sweep on a
trainer that asks for it raises.

Precision: the forward and backward run in f32 with cuDNN's TF32
convolutions off (``device.f32_convolutions``, as calibration does);
matmuls keep PyTorch's f32 default.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple

import numpy as np
import torch

from contrastiveprosthetics_torch.config import Config
from contrastiveprosthetics_torch.data.sampler import (
    epoch_batches,
    epoch_batches_padded,
    gather_eval_batch,
    gather_train_batch,
    identity_permutations,
    stacked_epoch_batches,
    stacked_epoch_batches_padded,
    stacked_gather_eval_batch,
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
from contrastiveprosthetics_torch.models.stacked import (
    StackedContrastiveModel,
    stacked_l2_penalty,
)
from contrastiveprosthetics_torch.ops.kernels import (
    fold_encoder_params,
    fused_contrastive_loss,
    fused_encoder_logits,
)
from contrastiveprosthetics_torch.ops.train_fused import fused_emg_embed
from contrastiveprosthetics_torch.train.loss import (
    symmetric_contrastive_loss,
    symmetric_contrastive_loss_per_item,
)


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
    one tensor per parameter. For stacked parameters
    (:func:`stacked_adam_init`) ``mu`` and ``nu`` are views of two flat
    (C, N) buffers, ``flat``, that the update runs over."""

    count: int
    mu: list
    nu: list
    flat: tuple | None = None


def adam_init(params) -> AdamState:
    params = list(params)
    return AdamState(0, [torch.zeros_like(p) for p in params],
                     [torch.zeros_like(p) for p in params])


def stacked_adam_init(params) -> AdamState:
    """Zeroed moments of stacked parameters (C configs on the leading
    axis): each a (C, N) buffer, config c's moments of every parameter in
    row c, and a view of it per parameter."""
    params = list(params)
    sizes = [p[0].numel() for p in params]
    flat = tuple(params[0].new_zeros(params[0].shape[0], sum(sizes))
                 for _ in range(2))
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
    correction differently.)

    Stacked parameters (a state of :func:`stacked_adam_init`) take a (C,)
    ``lr``, one per config; the count and the bias corrections are shared,
    since all configs step together. Their update runs as plain tensor
    operations over the flat (C, N) gradients and moments: a foreach
    operation splits its work into launches by size, so its launches
    would grow with C."""
    params, grads = list(params), list(grads)
    state.count += 1
    t = np.float32(state.count)
    bc1 = float(np.float32(1) - np.float32(b1) ** t)
    bc2 = float(np.float32(1) - np.float32(b2) ** t)
    if state.flat is not None:
        mu, nu = state.flat
        g = torch.cat([x.reshape(mu.shape[0], -1) for x in grads], 1)
        mu.mul_(b1).add_(g * (1 - b1))
        nu.mul_(b2).add_(g * g * (1 - b2))
        update = (mu / bc1).div_((nu / bc2).sqrt_().add_(eps)).mul_(
            lr.view(-1, 1))
        for p, u in zip(params, update.split([p[0].numel() for p in params],
                                             1)):
            p.sub_(u.view(p.shape))
        return
    torch._foreach_mul_(state.mu, b1)
    torch._foreach_add_(state.mu, torch._foreach_mul(grads, 1 - b1))
    torch._foreach_mul_(state.nu, b2)
    torch._foreach_add_(state.nu, torch._foreach_mul(
        torch._foreach_mul(grads, grads), 1 - b2))
    denom = torch._foreach_div(state.nu, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    update = torch._foreach_div(state.mu, bc1)
    torch._foreach_div_(update, denom)
    torch._foreach_mul_(update, lr)
    torch._foreach_sub_(params, update)


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BatchNorm running statistics) and the two
    Adam chains, over ``model.towers()``."""

    model: ContrastiveModel
    opt_emg: AdamState
    opt_glove: AdamState

    @classmethod
    def fresh(cls, model: ContrastiveModel) -> "TrainState":
        towers = model.towers()
        init = (stacked_adam_init
                if isinstance(model, StackedContrastiveModel) else adam_init)
        return cls(model, init(towers["emg_net"].parameters()),
                   init(towers["glove_net"].parameters()))


class EvalResult(NamedTuple):
    loss: torch.Tensor      # scalar mean loss over the split's items
    accuracy: torch.Tensor  # scalar voted accuracy
    curve: torch.Tensor     # (D, n_prefix) voting curves, item order
    y_pred: torch.Tensor    # (D, T)
    y_true: torch.Tensor    # (D, T)
    logits: torch.Tensor    # (D*W, T, T) raw logits, item order


@dataclasses.dataclass
class Trainer:
    """Train steps, epochs and evaluation over one store, contrastive mode
    with the one-hot class encoder."""

    cfg: Config
    store: DeviceStore
    db2: bool = False
    adabn: bool = True
    d_e: int = 16
    batch_size: int = 8
    n_linear: int = 7
    hidden: int = 512
    # the fused training chain for the EMG tower's dense stack; None is
    # off, as in the JAX package, until a benchmark's A/B on the card says
    # otherwise (PERF.md)
    use_fused_train: bool | None = None
    # the voted evaluation's encoder on the encoder_chain kernels; None is
    # off, as in the JAX package, until a benchmark's A/B on the card says
    # otherwise
    use_fused_encoder: bool | None = None

    def __post_init__(self):
        self.use_fused_train = bool(self.use_fused_train)
        self.use_fused_encoder = bool(self.use_fused_encoder)
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
            n_linear=self.n_linear, hidden=self.hidden, generator=generator,
            device=self.device)

    def init_state(self, generator: torch.Generator) -> TrainState:
        """A fresh model (torch's default init from ``generator``) with
        zeroed Adam chains."""
        return TrainState.fresh(self._model(generator))

    def init_sweep_state(self, generators) -> TrainState:
        """C fresh models, config c's drawn from ``generators[c]``, as one
        stacked model with zeroed stacked Adam chains."""
        return TrainState.fresh(StackedContrastiveModel.from_models(
            [self._model(g) for g in generators]))

    # ------------------------------------------------------------- train step
    def _embed_fused(self, model: ContrastiveModel, emg_b, dp_emg: float,
                     generator: torch.Generator | None, ext_masks):
        """``model.embed`` with the EMG tower's dense stack on the fused
        chain; a plain-BatchNorm model's running statistics move as in the
        eager forward. ``ext_masks``: explicit dropout masks (the tests)."""
        B, T = emg_b.shape[:2]
        seeds = None
        if ext_masks is None:
            if generator is not None:
                seeds = torch.randint(-2**31, 2**31, (2,), dtype=torch.int32,
                                      generator=generator,
                                      device=self.device)
            elif dp_emg == 0.0:  # every mask keeps everything
                seeds = torch.zeros(2, dtype=torch.int32, device=self.device)
            else:
                raise ValueError("dropout at a nonzero rate needs an explicit "
                                 "torch.Generator for its mask")
        e, stats = fused_emg_embed(
            model.emg_net, emg_b.reshape(-1, emg_b.shape[-1]), dp_emg, seeds,
            mask_mode="prng" if ext_masks is None else "input",
            ext_masks=ext_masks or ())
        if stats is not None:
            with torch.no_grad():
                torch._foreach_copy_(
                    [t for bn in model.emg_net.norms()
                     for t in (bn.running_mean, bn.running_var)],
                    [t for mv in stats for t in mv])
        g = model._class_rows(B, T).reshape(B, T, -1)
        return l2_normalize(e.reshape(B, T, -1)), l2_normalize(g)

    def loss_and_grads(self, state: TrainState, emg_b: torch.Tensor,
                       hyper: Hyper, generator: torch.Generator | None,
                       ext_masks=None):
        """Forward (train mode: batch statistics, which also move the
        running ones), the fused loss plus ``reg * l2`` of each tower, and
        the gradients of that total. Returns (loss, accuracy, grads by
        tower), the first two 0-d tensors on the device. ``ext_masks``
        (fused chain only) replaces the drawn dropout masks.

        A stacked state (C configs) takes ``emg_b`` (C, B, T, emg_dim) and
        a ``hyper`` of (C,) f32 tensors on the device; its loss and
        accuracy are (C,), and the gradients are those of the sum over
        configs of each config's total, so each config gets its own and
        K1's backward one upstream 1 per config. With no ``generator`` the
        stacked model drops nothing (every rate must be 0)."""
        model = state.model.train()
        stacked = isinstance(model, StackedContrastiveModel)
        if stacked and self.use_fused_train:
            raise ValueError(
                "the crossval sweep runs on the eager tower only: the fused "
                "training chain takes no config axis yet (ROADMAP.md, queue "
                "1 item 11)")
        l2 = stacked_l2_penalty if stacked else l2_penalty
        towers = model.towers()
        params = {k: list(t.parameters()) for k, t in towers.items()}
        B, T = emg_b.shape[-3:-1]
        with f32_convolutions():
            if self.use_fused_train:
                e, g = self._embed_fused(model, emg_b, hyper.dp_emg,
                                         generator, ext_masks)
            else:
                e, g = model.embed(emg_b, hyper.dp_emg, generator)
            loss, correct = fused_contrastive_loss(e.contiguous(),
                                                   g.contiguous())
            total = (loss
                     + hyper.reg_emg * l2(towers["emg_net"])
                     + hyper.reg_glove * l2(towers["glove_net"]))
            flat = torch.autograd.grad(
                total.sum(), params["emg_net"] + params["glove_net"])
        n = len(params["emg_net"])
        grads = {"emg_net": list(flat[:n]), "glove_net": list(flat[n:])}
        return loss.detach(), correct / (B * T), grads

    def _sgd_step(self, state: TrainState, emg_b, hyper: Hyper,
                  lr_emg: float | torch.Tensor, lr_glove: float | torch.Tensor,
                  generator: torch.Generator | None, ext_masks=None):
        """One optimization step: forward, loss + L2, backward, then the
        two Adam updates. Returns (loss, accuracy) on the device. On a
        stacked state (see :meth:`loss_and_grads`) it is one step of every
        config, with (C,) lr tensors."""
        loss, acc, grads = self.loss_and_grads(state, emg_b, hyper, generator,
                                               ext_masks)
        towers = state.model.towers()
        adam_step_(towers["emg_net"].parameters(), grads["emg_net"],
                   state.opt_emg, lr_emg)
        adam_step_(towers["glove_net"].parameters(), grads["glove_net"],
                   state.opt_glove, lr_glove)
        return loss, acc

    # ----------------------------------------------------------------- epoch
    def train_epoch_from_indices(self, state: TrainState, emg_rand, batches,
                                 tail, hyper: Hyper, lr_emg_factor: float,
                                 lr_glove_factor: float,
                                 generator: torch.Generator | None,
                                 ext_masks=None):
        """One epoch over given index matrices: ``emg_rand`` (n_tasks, D)
        task permutations, ``batches`` (n_batches, bs) and the (D % bs,)
        ``tail``, which trains as a smaller batch (DataLoader
        ``drop_last=False``, train.py:86). ``ext_masks``, for the fused
        chain in tests, holds each step's explicit dropout masks. Returns
        the per-step losses and accuracies, on the device."""
        v = self.view_train
        lr_e = _f32_product(hyper.lr_emg, lr_emg_factor)
        lr_g = _f32_product(hyper.lr_glove, lr_glove_factor)
        steps = list(batches) + ([tail] if tail.numel() else [])
        losses, accs = [], []
        for i, items in enumerate(steps):
            # one-hot contrastive mode: the class encoder never reads glove
            # values, so the glove gather is skipped
            emg_b = gather_train_batch(v.emg_flat, emg_rand, items)
            loss, acc = self._sgd_step(
                state, emg_b, hyper, lr_e, lr_g, generator,
                None if ext_masks is None else ext_masks[i])
            losses.append(loss)
            accs.append(acc)
        return torch.stack(losses), torch.stack(accs)

    def train_epoch(self, state: TrainState, generator: torch.Generator,
                    hyper: Hyper, lr_emg_factor: float = 1.0,
                    lr_glove_factor: float = 1.0):
        """One epoch: task permutations and batch order from
        ``generator``, then every step. Returns (state, mean loss, mean
        accuracy), the last two on the device; ``state`` is updated in
        place."""
        v = self.view_train
        emg_rand = task_permutations(generator, v.n_tasks, v.D)
        batches, tail = epoch_batches(generator, v.D, self.batch_size)
        losses, accs = self.train_epoch_from_indices(
            state, emg_rand, batches, tail, hyper, lr_emg_factor,
            lr_glove_factor, generator)
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

    # ------------------------------------------------------------------ eval
    def evaluate(self, state: TrainState, generator: torch.Generator,
                 hyper: Hyper, split: str = "val",
                 batch_size: int | None = None) -> EvalResult:
        """Voted evaluation of a split. Val batches hold ``batch_size``
        items, test ``8 * batch_size`` (train.py:32,51)."""
        if batch_size is None:
            batch_size = self.batch_size * (1 if split == "val" else 8)
        v = {"val": self.view_val, "test": self.view_test}[split]
        emg_rand = task_permutations(generator, v.n_tasks, v.D)
        batches, weights, inverse = epoch_batches_padded(generator, v.D,
                                                         batch_size)
        return self.evaluate_from_indices(state, v, emg_rand, batches,
                                          weights, inverse)

    def _fused_encoder_on(self, n_tasks: int) -> bool:
        """Whether a voted evaluation of ``n_tasks`` tasks runs the
        ``encoder_chain`` kernels: on request, with plain BatchNorm and
        every class (``engine.py:643-657``). A request on another config
        warns and runs the unfused path."""
        if not self.use_fused_encoder:
            return False
        if not self.adabn and n_tasks == self.cfg.max_tasks:
            return True
        warnings.warn(
            "use_fused_encoder requested but this eval config is ineligible "
            "(needs plain-BN contrastive one-hot and n_tasks == "
            f"{self.cfg.max_tasks}); falling back to the unfused path",
            stacklevel=3)
        return False

    @torch.no_grad()
    def evaluate_from_indices(self, state: TrainState, view: SplitView,
                              emg_rand, batches, weights,
                              inverse) -> EvalResult:
        """Every item once: padded batches (``weights`` 0 on the pad
        duplicates, which the loss leaves out), per-item outputs back in
        item order through ``inverse`` (engine.py:624-749). With the fused
        encoder, each batch's frames go through one ``encoder_chain`` call
        in (item, task, frame) row order, and its scores are put in the
        model's (item, frame) vote order (``engine.py:671-673``)."""
        model = state.model.eval()
        W = self.cfg.prediction_window_size
        n_prefix = self.cfg.n_voting_cols
        T = view.n_tasks
        folded = None
        if self._fused_encoder_on(T):
            folded = fold_encoder_params(model.emg_net, model.encode_classes())
        loss_sums, curves, y_preds, y_trues, logits_all = [], [], [], [], []
        with f32_convolutions():
            for items, w in zip(batches, weights):
                bs = items.shape[0]
                emg_b = gather_eval_batch(view.emg_groups, emg_rand, items)
                if folded is None:
                    logits = model(emg_b)                 # (bs*W, T, T)
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
        through identity task permutations; the outputs stay in item order.
        The loss is the mean of the subjects' mean losses. Deterministic,
        so it takes no generator."""
        v = {"val": self.view_val, "test": self.view_test}[split]
        model = state.model.eval()
        W = self.cfg.prediction_window_size
        n_prefix = self.cfg.n_voting_cols
        T = v.n_tasks
        subjects = torch.arange(v.D, device=self.device).reshape(
            v.n_people, v.D // v.n_people)
        emg_rand = identity_permutations(T, v.D, device=self.device)
        losses, curves, y_preds, y_trues, logits_all = [], [], [], [], []
        with f32_convolutions():
            for items in subjects:
                logits = model(gather_eval_batch(v.emg_groups, emg_rand,
                                                 items))
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
    def _check_sweep_encoder(self) -> None:
        if self._fused_encoder_on(self.view_val.n_tasks):
            raise NotImplementedError(
                "the sweep's validation on the fused encoder: encoder_chain "
                "takes no config axis yet (ROADMAP.md, queue 1 item 12); "
                "use a Trainer without use_fused_encoder for the sweep")

    def sweep_epoch_from_indices(self, state: TrainState, emg_rand, batches,
                                 tail, hyper: Hyper, lr_emg_factor: float,
                                 lr_glove_factor: float,
                                 generator: torch.Generator | None):
        """One epoch of every config of a stacked state over given index
        matrices, one stacked step per batch: ``emg_rand`` (C, n_tasks, D),
        ``batches`` (C, n_batches, bs) and the (C, D % bs) ``tail``, which
        trains as a smaller batch. ``hyper`` holds (C,) f32 tensors on the
        device; config c's lr is its lr times the factor, in f32.
        ``generator`` draws the dropout masks (None: no dropout, every rate
        0). Returns the (C, steps) losses and accuracies on the device."""
        v = self.view_train
        lr_e = hyper.lr_emg * float(np.float32(lr_emg_factor))
        lr_g = hyper.lr_glove * float(np.float32(lr_glove_factor))
        steps = list(batches.unbind(1)) + ([tail] if tail.shape[1] else [])
        losses, accs = [], []
        for items in steps:
            emg_b = stacked_gather_train_batch(v.emg_flat, emg_rand, items)
            loss, acc = self._sgd_step(state, emg_b, hyper, lr_e, lr_g,
                                       generator)
            losses.append(loss)
            accs.append(acc)
        return torch.stack(losses, 1), torch.stack(accs, 1)

    @torch.no_grad()
    def sweep_evaluate_from_indices(self, state: TrainState,
                                    view: SplitView, emg_rand, batches,
                                    weights, inverse):
        """The voted evaluation of every config of a stacked state, the
        metrics only (the JAX ``_evaluate_scalars``): ``emg_rand`` (C,
        n_tasks, D), padded ``batches`` and ``weights`` (C, n_batches,
        bs), ``inverse`` (C, D), each config's as
        :meth:`evaluate_from_indices` takes them. Returns (C,) mean losses
        and (C,) voted accuracies on the device."""
        self._check_sweep_encoder()
        model = state.model.eval()
        W = self.cfg.prediction_window_size
        T = view.n_tasks
        C, _, bs = batches.shape
        loss_sums, voted = [], []
        with f32_convolutions():
            for items, w in zip(batches.unbind(1), weights.unbind(1)):
                emg_b = stacked_gather_eval_batch(view.emg_groups, emg_rand,
                                                  items)
                logits = model(emg_b)                   # (C, bs*W, T, T)
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
        self._check_sweep_encoder()
        if generator is None and np.any(np.asarray(hyper.dp_emg)):
            raise ValueError("dropout at a nonzero rate needs an explicit "
                             "torch.Generator for its masks")
        state = self.init_sweep_state(generators)
        h = Hyper(*[torch.as_tensor(np.asarray(x, np.float32),
                                    device=self.device) for x in hyper])
        v = self.view_train
        for f_e, f_g in zip(emg_factors, glove_factors):
            emg_rand = stacked_task_permutations(generators, v.n_tasks, v.D)
            batches, tail = stacked_epoch_batches(generators, v.D,
                                                  self.batch_size)
            self.sweep_epoch_from_indices(state, emg_rand, batches, tail, h,
                                          float(f_e), float(f_g), generator)
        v = self.view_val
        emg_rand = stacked_task_permutations(generators, v.n_tasks, v.D)
        return self.sweep_evaluate_from_indices(
            state, v, emg_rand,
            *stacked_epoch_batches_padded(generators, v.D, self.batch_size))
