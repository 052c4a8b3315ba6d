"""C configs' contrastive models as one module with a leading config axis:
the port's counterpart of ``jax.vmap`` over the JAX package's
``init_state`` and ``_sgd_step`` in the crossval sweep
(``train/engine.py:537-596``).

Every parameter and buffer of :class:`StackedContrastiveModel` is the
:class:`ContrastiveModel` one of the same name with a leading axis of C
configs, so :meth:`~StackedContrastiveModel.from_models` stacks C
state_dicts and :meth:`~StackedContrastiveModel.unstack` slices one out.
The activations carry the axis too, so one stacked step launches the
same kernels whatever C is:

* dense layers: ``torch.baddbmm`` of (C, rows, in) by (C, in, out);
* the two convolutions: a frame is a 1x12 image, so a 3x3 convolution
  with padding 1 only ever meets its kernel's middle row with data (the
  other two rows meet the zero padding); it is three batched GEMMs over
  the configs, one per tap, on channels-last activations (C, rows, 12,
  channels) whose rows are laid end to end with a zero position around
  each (:class:`StackedConv`). (cuDNN's grouped convolution, ``groups=C``
  with the configs on the channel axis, launched kernels per group on an
  H100, so the launches grew with C; PERF.md, the sweep's findings);
* BatchNorm and AdaBN: batch statistics per (config, channel) in one
  Welford ``var_mean`` and flax's running update, as
  ``models/layers.py`` computes them for one config;
* dropout: one rate per config, a (C,) tensor, and one (C, rows, F) draw
  per layer and step from the caller's generator; a rate of 0 is the
  identity bit for bit;
* :func:`stacked_l2_penalty`: each config's sum of Frobenius norms, (C,).

Every mode of ``ContrastiveModel`` stacks so: the softmax baseline's
prediction head, and the glove-angle MLP of ``--prediction --glove`` and
``--glove_encoding``, whose BatchNorm is per (config, channel) and whose
dropout runs at each config's ``dp_glove``.

Every reduction is per config, so a config that diverges to NaN leaves
the other configs' numbers as they were.

A bf16 EMG tower (``dtype=torch.bfloat16``, the JAX sweep's ``jax.vmap``
of the bf16 model) rounds where one config's bf16 layers do
(``layers.low_precision``): each dense product and each convolution's
three taps summed in f32 from bf16-rounded operands and rounded once to
bf16, then the bias added in bf16 (so not inside ``baddbmm``, and not
tap by tap); the BatchNorm statistics and normalization in f32 from the
bf16 input, returned in bf16. The f32 tower keeps the ``baddbmm`` forms
above.
"""
from __future__ import annotations

import torch
from torch import nn

from contrastiveprosthetics_torch.models.clip import ContrastiveModel, l2_normalize
from contrastiveprosthetics_torch.models.convert import (
    architecture,
    model_from_state_dict,
)
from contrastiveprosthetics_torch.models.glove_net import tower_mode
from contrastiveprosthetics_torch.models.layers import (
    at_least_f32,
    low_product,
    set_running,
    update_running,
)


def _low_linear(x, w_t, bias, dtype):
    """(C, rows, in) by (C, in, out) at compute dtype ``dtype``
    (``layers.low_product``)."""
    return low_product(x, w_t, None if bias is None else bias.unsqueeze(1),
                       dtype, torch.bmm)


def _taps(line: torch.Tensor, taps: torch.Tensor, n: int, out=None):
    """The three taps of a stacked conv summed over strided windows of
    ``line``, onto ``out`` (None: nothing) with ``baddbmm``."""
    for k in range(3):
        win, tap = line[:, k:k + n], taps[..., k]
        out = torch.bmm(win, tap) if out is None else torch.baddbmm(out, win,
                                                                    tap)
    return out


class StackedLinear(nn.Module):
    """C ``nn.Linear`` layers: ``weight`` (C, out, in), ``bias`` (C, out),
    computing in ``dtype`` (f32, or bf16 in a bf16 EMG tower)."""

    def __init__(self, C: int, in_f: int, out_f: int, bias: bool = True,
                 device=None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(C, out_f, in_f, device=device))
        self.bias = (nn.Parameter(torch.empty(C, out_f, device=device))
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(C, rows, in) -> (C, rows, out)."""
        w = self.weight.transpose(1, 2)
        if self.dtype != torch.float32:
            return _low_linear(x, w, self.bias, self.dtype)
        if self.bias is None:
            return torch.bmm(x, w)
        return torch.baddbmm(self.bias.unsqueeze(1), x, w)


class StackedConv(nn.Module):
    """C 3x3 ``nn.Conv2d`` layers with padding 1 over 1-pixel-high
    images: ``weight`` (C, out, in, 3, 3), ``bias`` (C, out). Only the
    kernel's middle row meets data; the other two rows, as in
    ``nn.Conv2d`` at this height, get a gradient from the L2 penalty
    alone."""

    def __init__(self, C: int, in_c: int, out_c: int, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(C, out_c, in_c, 3, 3,
                                               device=device))
        self.bias = nn.Parameter(torch.empty(C, out_c, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(C, rows, P, in) channels-last -> (C, rows, P, out), a view.

        Each config's rows are laid end to end, each row's P positions
        between two zero positions, (C, rows*(P+2) + 2, in); output
        position j of that line is the sum over taps k of line position j
        + k times tap k's (in, out) matrix, one ``baddbmm`` over strided
        windows of the line per tap, and positions P, P+1 of each row,
        which straddle two rows of the same config, are dropped. In bf16
        the three taps are summed in f32 from rounded operands, without the
        bias, then rounded once and the bias added in bf16."""
        C, rows, P, cin = x.shape
        n = rows * (P + 2)
        line = x.new_zeros(C, n + 2, cin)
        line[:, :n].view(C, rows, P + 2, cin)[:, :, 1:P + 1] = x
        taps = self.weight[:, :, :, 1].transpose(1, 2)   # (C, in, out, 3)
        bias = self.bias.unsqueeze(1)
        if self.dtype != torch.float32:
            out = low_product(line, taps, bias, self.dtype,
                              lambda line, taps: _taps(line, taps, n))
        else:
            out = _taps(line, taps, n, bias)
        return out.view(C, rows, P + 2, -1)[:, :, :P]


class StackedBatchNorm(nn.Module):
    """C BatchNorms of F channels each (``weight``, ``bias`` and, with
    running statistics, ``running_mean``, ``running_var`` and
    ``num_batches_tracked``, each with the config axis first). ``conv``:
    the input is a channels-last conv activation (C, rows, P, F), else a
    dense one (C, rows, F)."""

    def __init__(self, C: int, F: int, conv: bool,
                 track_running_stats: bool = True, eps: float = 1e-5,
                 device=None):
        super().__init__()
        self.conv = conv
        self.eps = eps
        self.track_running_stats = track_running_stats
        self.weight = nn.Parameter(torch.ones(C, F, device=device))
        self.bias = nn.Parameter(torch.zeros(C, F, device=device))
        if track_running_stats:
            self.register_buffer("running_mean",
                                 torch.zeros(C, F, device=device))
            self.register_buffer("running_var",
                                 torch.ones(C, F, device=device))
            self.register_buffer("num_batches_tracked",
                                 torch.zeros(C, dtype=torch.int64,
                                             device=device))

    def _dims(self):
        """The axes the statistics take and a (C, F) vector's shape over
        the input."""
        C, F = self.weight.shape
        if self.conv:  # statistics over rows and positions
            return (1, 2), (C, 1, 1, F)
        return (1,), (C, 1, F)  # statistics over rows

    def batch_stats(self, x: torch.Tensor):
        """Per (config, channel) (mean, biased var), (C, F) each, in f32."""
        var, mean = torch.var_mean(at_least_f32(x), dim=self._dims()[0],
                                   correction=0)
        return mean, var

    def normalize(self, x, mean, var) -> torch.Tensor:
        """In f32, returned in ``x``'s dtype (``layers.BatchNorm``)."""
        shape = self._dims()[1]
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean.view(shape)) * mul.view(shape)
                + self.bias.view(shape)).to(x.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training or not self.track_running_stats:
            mean, var = self.batch_stats(x)
            if self.training and self.track_running_stats:
                with torch.no_grad():
                    set_running(
                        (self.running_mean, self.running_var),
                        (update_running(self.running_mean, mean),
                         update_running(self.running_var, var)))
        else:
            mean, var = self.running_mean, self.running_var
        return self.normalize(x, mean, var)


class StackedAdaBN(nn.Module):
    """C AdaBNs: a ``.bn``-wrapped :class:`StackedBatchNorm` without
    running statistics, as ``layers.AdaBN``."""

    def __init__(self, C: int, F: int, conv: bool, device=None):
        super().__init__()
        self.bn = StackedBatchNorm(C, F, conv, track_running_stats=False,
                                   device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(x)


class StackedDropout(nn.Module):
    """Inverted dropout with one rate per config: keep each value of
    config c with probability ``1 - rate[c]`` and scale the kept ones by
    ``1 / (1 - rate[c])``. The identity in eval mode and when no
    generator is given (the caller's statement that every rate is 0; at
    rate 0 a drawn mask keeps everything and divides by exactly 1)."""

    def forward(self, x: torch.Tensor, rate: torch.Tensor,
                generator: torch.Generator | None) -> torch.Tensor:
        if not self.training or generator is None:
            return x
        keep = (1.0 - rate).view(-1, 1, 1)
        mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
        return torch.where(mask, x / keep, 0.0).to(x.dtype)


def _norm(C: int, F: int, adabn: bool, conv: bool, device) -> nn.Module:
    return (StackedAdaBN(C, F, conv, device) if adabn
            else StackedBatchNorm(C, F, conv, device=device))


class StackedEMGNet(nn.Module):
    """C ``EMGNet``s, with the same Sequential indices (so the same
    state_dict keys), the prediction head included."""

    def __init__(self, C: int, d_e: int, emg_dim: int, adabn: bool,
                 n_linear: int, hidden: int, conv_features: int,
                 prediction: bool = False, n_classes: int = 41, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.emg_dim = emg_dim
        self.dtype = dtype
        F = conv_features
        lin = dict(device=device, dtype=dtype)
        self.conv_emg = nn.Sequential(
            StackedConv(C, 1, F, **lin), nn.ReLU(),
            _norm(C, F, adabn, True, device),
            StackedConv(C, F, F, **lin), nn.ReLU(),
            _norm(C, F, adabn, True, device))
        blocks: list[nn.Module] = []
        width = F * emg_dim
        for i in range(n_linear):
            blocks += [StackedLinear(C, width, hidden, **lin),
                       nn.ReLU(), _norm(C, hidden, adabn, False, device)]
            if i >= n_linear - 4:  # dropout on the last 4 blocks
                blocks.append(StackedDropout())
            width = hidden
        self.linear = nn.Sequential(*blocks)
        if prediction:
            self.last = nn.Sequential(
                StackedLinear(C, hidden, 128, **lin), nn.ReLU(),
                _norm(C, 128, adabn, False, device),
                StackedLinear(C, 128, n_classes, bias=False, **lin))
        else:
            self.last = nn.Sequential(
                StackedLinear(C, hidden, d_e, bias=False, **lin))

    def norms(self) -> list[StackedBatchNorm]:
        """Every BatchNorm in forward order (an AdaBN's inner one), as
        ``EMGNet.norms``."""
        return [m for m in self.modules() if isinstance(m, StackedBatchNorm)]

    def forward(self, frames: torch.Tensor, dropout: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """(C, rows, emg_dim) frames -> (C, rows, d_e) unnormalized
        embeddings (the prediction head: (C, rows, n_classes) scores), f32
        in either compute dtype; in train mode with a ``generator`` the
        dropout layers drop config c at rate ``dropout[c]``."""
        C, rows, P = frames.shape
        x = self.conv_emg(frames.unsqueeze(-1))   # (C, rows, P, F)
        x = x.reshape(C, rows, -1)                # p*F + f per row
        first, *rest = self.linear
        # the reference flattens channel-major (f*P + p) and its first
        # dense weight's columns follow, so they are read position-major
        w = first.weight.unflatten(2, (-1, P)).transpose(2, 3).flatten(2)
        if self.dtype != torch.float32:
            x = _low_linear(x, w.transpose(1, 2), first.bias, self.dtype)
        else:
            x = torch.baddbmm(first.bias.unsqueeze(1), x, w.transpose(1, 2))
        for m in rest:
            x = m(x, dropout, generator) if isinstance(m, StackedDropout) \
                else m(x)
        return at_least_f32(self.last(x))


class StackedGloveNet(nn.Module):
    """C class encoders (``GLOVENet``) in one ``mode``, with its keys:
    one-hot (``last`` as dead as there), the baseline's idle reference
    tower, or the glove-angle MLP with one dropout rate per config."""

    def __init__(self, C: int, d_e: int, n_classes: int, mode: str = "onehot",
                 out: int | None = None, glove_dim: int = 20,
                 adabn: bool = False, device=None):
        super().__init__()
        self.mode = mode
        self.n_classes = n_classes
        if mode == "mlp":
            self.mlp = nn.Sequential(
                StackedLinear(C, glove_dim, 128, device=device), nn.ReLU(),
                _norm(C, 128, adabn, False, device), StackedDropout(),
                StackedLinear(C, 128, out, bias=False, device=device))
            return
        self.easy = nn.Sequential(StackedLinear(C, n_classes, d_e,
                                                device=device))
        if mode == "onehot":
            self.last = nn.Sequential(StackedLinear(C, 256, d_e, bias=False,
                                                    device=device))
        else:
            self.last = nn.Sequential(
                StackedLinear(C, 256, 128, device=device), nn.ReLU(),
                _norm(C, 128, adabn, False, device), StackedDropout(),
                StackedLinear(C, 128, n_classes, bias=False, device=device))

    def trained(self) -> nn.Module:
        """As ``GLOVENet.trained``."""
        if self.mode == "reference":
            return nn.Sequential()
        return self.easy if self.mode == "onehot" else self.mlp

    def forward(self, labels: torch.Tensor | None = None,
                glove: torch.Tensor | None = None,
                dropout: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """One-hot: (rows,) class ids -> (C, rows, d_e). MLP: (C, rows,
        glove_dim) glove angles -> (C, rows, out), config c's dropout at
        rate ``dropout[c]`` in train mode with a ``generator``.
        Unnormalized."""
        if self.mode == "mlp":
            x = glove
            for m in self.mlp:
                x = m(x, dropout, generator) \
                    if isinstance(m, StackedDropout) else m(x)
            return x
        lin = self.easy[0]
        hot = nn.functional.one_hot(labels, self.n_classes).to(
            lin.weight.dtype)
        return lin(hot.expand(lin.weight.shape[0], -1, -1))


def stacked_l2_penalty(module: nn.Module) -> torch.Tensor:
    """(C,): each config's ``clip.l2_penalty``, the sum of the Frobenius
    norms of its conv and dense weights (biases and BatchNorms left out,
    selected by module type); 0 for an empty module (an idle tower)."""
    norms = [torch.linalg.vector_norm(m.weight.flatten(1), dim=1)
             for m in module.modules()
             if isinstance(m, (StackedConv, StackedLinear))]
    return torch.stack(norms).sum(0) if norms else torch.zeros(())


class StackedContrastiveModel(nn.Module):
    """C ``ContrastiveModel``s of one architecture and mode. Built empty on
    ``device``; :meth:`from_models` fills it."""

    def __init__(self, n_configs: int, d_e: int = 16, emg_dim: int = 12,
                 n_classes: int = 41, adabn: bool = False, n_linear: int = 7,
                 hidden: int = 512, conv_features: int = 64,
                 prediction: bool = False, glove: bool = False,
                 glove_encoding: bool = False, glove_dim: int = 20,
                 device=None, dtype: torch.dtype = torch.float32):
        super().__init__()
        C = n_configs
        self.prediction = prediction
        self.glove = glove and prediction
        self.glove_encoding = glove_encoding and not prediction
        self.dtype = dtype  # the EMG tower's, as ContrastiveModel's
        self.emg_net = StackedEMGNet(C, d_e, emg_dim, adabn, n_linear, hidden,
                                     conv_features, prediction, n_classes,
                                     device="meta", dtype=dtype)
        mode = tower_mode(prediction, glove, glove_encoding)
        self.glove_net = StackedGloveNet(
            C, d_e, n_classes, mode, n_classes if prediction else d_e,
            glove_dim, adabn, device="meta")
        self.logit_scale = nn.Parameter(torch.zeros(C, device="meta"))
        self.to_empty(device=device or "cpu")

    @classmethod
    def from_models(cls, models: list[ContrastiveModel]
                    ) -> "StackedContrastiveModel":
        """The C models' parameters and buffers stacked, on the first
        model's device, in its compute dtype."""
        sds = [m.state_dict() for m in models]
        stacked = cls(len(models), **architecture(sds[0]),
                      device=models[0].logit_scale.device,
                      dtype=models[0].dtype)
        stacked.load_state_dict({k: torch.stack([sd[k] for sd in sds])
                                 for k in sds[0]}, strict=True)
        return stacked

    def unstack(self, c: int) -> ContrastiveModel:
        """Config ``c`` as a ``ContrastiveModel`` (a copy)."""
        return model_from_state_dict({k: v[c].clone() for k, v in
                                      self.state_dict().items()},
                                     dtype=self.dtype).to(
            self.logit_scale.device)

    def towers(self) -> dict[str, nn.Module]:
        """The two trained parameter groups, as ``ContrastiveModel.towers``."""
        return {"emg_net": nn.Sequential() if self.glove else self.emg_net,
                "glove_net": self.glove_net.trained()}

    def encode_classes(self) -> torch.Tensor:
        """(C, n_classes, d_e) normalized one-hot class embeddings, each
        config's ``ContrastiveModel.encode_classes()`` (what the fused
        encoder folds)."""
        return l2_normalize(self.glove_net(torch.arange(
            self.glove_net.n_classes, device=self.logit_scale.device)))

    def _class_rows(self, B: int, T: int, glove: torch.Tensor | None = None,
                    dp_glove: torch.Tensor | None = None,
                    generator: torch.Generator | None = None) -> torch.Tensor:
        """(C, B*T, d_e) class embeddings of labels ``arange(T)`` per item,
        or in glove-encoding mode of the (C, B, T, glove_dim) ``glove``
        rows."""
        if self.glove_encoding:
            return self.glove_net(glove=glove.reshape(glove.shape[0], B * T,
                                                      -1),
                                  dropout=dp_glove, generator=generator)
        labels = torch.arange(T, device=self.logit_scale.device).repeat(B)
        return self.glove_net(labels)

    def embed(self, emg: torch.Tensor, dp_emg: torch.Tensor | None = None,
              generator: torch.Generator | None = None,
              glove: torch.Tensor | None = None,
              dp_glove: torch.Tensor | None = None):
        """(C, B, T, emg_dim) -> normalized ``(e, g)``, both (C, B, T,
        d_e): the inputs of the fused contrastive loss at its config
        axis. ``glove`` (C, B, T, glove_dim) feeds the glove-encoding
        class tower."""
        C, B, T = emg.shape[:3]
        e = self.emg_net(emg.reshape(C, B * T, -1), dp_emg, generator)
        g = self._class_rows(B, T, glove, dp_glove, generator)
        return (l2_normalize(e).reshape(C, B, T, -1),
                l2_normalize(g).reshape(C, B, T, -1))

    def forward(self, emg: torch.Tensor, dp_emg: torch.Tensor | None = None,
                generator: torch.Generator | None = None,
                glove: torch.Tensor | None = None,
                dp_glove: torch.Tensor | None = None) -> torch.Tensor:
        """Per config, what ``ContrastiveModel.forward`` gives. Contrastive:
        the similarity logits of the vote input without dropout, (C, B, T,
        W, emg_dim) -> (C, B*W, T, T) in (item, frame) row order.
        Prediction: normalized scores, (C, B*T, n_classes) from (C, B, T,
        emg_dim) or from the (C, B, T, glove_dim) ``glove`` rows, (C, B*T,
        W, n_classes) from the vote input."""
        C, B, T = emg.shape[:3]
        if self.glove:
            return l2_normalize(self.glove_net(
                glove=glove.reshape(C, B * T, -1), dropout=dp_glove,
                generator=generator))
        if self.prediction:
            vote = emg.dim() == 5
            e = l2_normalize(self.emg_net(emg.reshape(C, -1, emg.shape[-1]),
                                          dp_emg, generator))
            return e.reshape(C, B * T, -1, e.shape[-1]) if vote else e
        W = emg.shape[3]
        e = l2_normalize(self.emg_net(emg.reshape(C, B * T * W, -1)))
        d = e.shape[-1]
        e = e.reshape(C, B, T, W, d).transpose(2, 3).reshape(C, B * W, T, d)
        g = l2_normalize(self._class_rows(B, T, glove)).reshape(C, B, 1, T, d)
        return e @ g.expand(C, B, W, T, d).reshape(C, B * W, T, d
                                                    ).transpose(-1, -2)
