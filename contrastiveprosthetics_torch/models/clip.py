"""CLIP-style wrapper (reference ``Model``, ``code/models.py:66-228``): the
serving methods ``encode_emg`` and ``encode_classes``, the training
``embed``/``embed_glove`` and the forward, (N, T, T) logits or, in the
softmax baseline, normalized class scores (the JAX package's
``models/clip.py:65-156``), and ``l2_penalty``.

Dead parameters exist only so that reference checkpoints load with
``strict=True``: ``logit_scale`` (initialised to exactly 0, its
multiplication commented out, models.py:81,129), ``glove_net.last`` in
the one-hot layout (constructed, never called, models.py:425-428) and the
whole glove tower of the softmax baseline (models.py:411-428; the
reference trains the EMG tower only, train.py:101). The JAX package has
none of them, so none is trained or penalised: :meth:`towers` names the
two parameter groups that are, an empty module for a tower the mode does
not train. Each holds fixed values (:meth:`dead_modules`).
"""
from __future__ import annotations

import torch
from torch import nn

from contrastiveprosthetics_torch.models.emg_net import EMGNet
from contrastiveprosthetics_torch.models.glove_net import GLOVENet, tower_mode
from contrastiveprosthetics_torch.models.layers import torch_default_init_


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """Plain ``x / ||x||`` along the last axis with no eps
    (reference models.py:123-125)."""
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def l2_penalty(module: nn.Module) -> torch.Tensor:
    """Sum of the Frobenius *norms* (not squared) of the weights of the
    ``Conv2d``/``Linear`` modules in ``module`` (reference
    ``EMGNet.l2``/``GLOVENet.l2``, models.py:344-349,467-472). Biases and
    BatchNorm parameters are left out; the selection is by module type,
    because the port's BatchNorm weights are named like any other. An
    empty module (an idle tower) has penalty 0, as JAX's ``l2_penalty({})``."""
    norms = [torch.linalg.vector_norm(m.weight) for m in module.modules()
             if isinstance(m, (nn.Conv2d, nn.Linear))]
    return torch.stack(norms).sum() if norms else torch.zeros(())


class ContrastiveModel(nn.Module):
    def __init__(self, d_e: int = 16, emg_dim: int = 12, n_classes: int = 41,
                 adabn: bool = False, n_linear: int = 7, hidden: int = 512,
                 conv_features: int = 64, prediction: bool = False,
                 glove: bool = False, glove_encoding: bool = False,
                 glove_dim: int = 20,
                 generator: torch.Generator | None = None, device=None,
                 dtype: torch.dtype = torch.float32):
        """Parameters are made on ``device`` (default the CPU) with
        torch's default init drawn from ``generator``, which must be on the
        same device (a fresh CPU ``torch.Generator`` seeded 0 when None).

        Modes, as the JAX package's switches (``models/clip.py:32-40``):
        ``prediction`` is the softmax baseline, classifying from the EMG
        tower's prediction head, or with ``glove`` from the glove-angle
        MLP; ``glove_encoding`` is contrastive with class embeddings from
        the glove-angle MLP. ``glove`` without ``prediction`` changes
        nothing, as in JAX.

        ``dtype`` is the EMG tower's compute dtype, f32 or bf16
        (``clip.py:39,45-54``); parameters stay f32 and the class tower
        computes in f32, as the JAX ``GLOVENet`` takes no dtype."""
        super().__init__()
        self.adabn = adabn
        self.n_classes = n_classes
        self.prediction = prediction
        self.glove = glove and prediction
        self.glove_encoding = glove_encoding and not prediction
        self.dtype = dtype
        self.emg_net = EMGNet(d_e, emg_dim, adabn, n_linear, hidden,
                              conv_features, prediction, n_classes,
                              device="meta", dtype=dtype)
        mode = tower_mode(prediction, glove, glove_encoding)
        self.glove_net = GLOVENet(
            d_e, n_classes, mode, n_classes if prediction else d_e,
            glove_dim, adabn, device="meta")
        self.logit_scale = nn.Parameter(torch.zeros((), device="meta"))
        self.to_empty(device=device or "cpu")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        torch_default_init_(self, generator)
        with torch.no_grad():
            self.logit_scale.zero_()
            for dead in self.dead_modules():
                for m in dead.modules():
                    if isinstance(m, (nn.Conv2d, nn.Linear)):
                        m.weight.zero_()
                        if m.bias is not None:
                            m.bias.zero_()

    def dead_modules(self) -> list[nn.Module]:
        """The modules that no mode computes with: the one-hot layout's
        ``glove_net.last`` and the idle tower of the baseline modes. They
        hold the values the JAX package's exporter writes for them (zero
        weights and biases, BatchNorm at its init; its
        ``train/torch_export.py:253-290``), drawn and then overwritten, so
        the live parameters' draws are unchanged: the JAX TrainState has
        no place for them, and a trip through it
        (``train/jax_interop.py``) gives them back as they were."""
        if self.glove:
            return [self.emg_net]
        if self.glove_net.mode == "reference":
            return [self.glove_net]
        return [self.glove_net.last] if self.glove_net.mode == "onehot" else []

    def towers(self) -> dict[str, nn.Module]:
        """The two parameter groups, as the JAX TrainState holds them: the
        EMG encoder and the live class encoder. In prediction mode only
        the active tower is trained (JAX ``engine.py:276-279``): the idle
        one is an empty module, so its L2 penalty is 0 and its Adam chain
        holds nothing."""
        idle = nn.Sequential()
        return {"emg_net": idle if self.glove else self.emg_net,
                "glove_net": self.glove_net.trained()}

    def encode_emg(self, frames: torch.Tensor) -> torch.Tensor:
        """(rows, emg_dim) -> (rows, d_e) normalized embeddings."""
        return l2_normalize(self.emg_net(frames))

    def encode_classes(self, glove_rows: torch.Tensor | None = None
                       ) -> torch.Tensor:
        """(n_classes, d_e) normalized class embeddings: one-hot by
        default; in glove-encoding mode from ``glove_rows`` (n_classes,
        glove_dim) glove prototypes, zeros when None (clip.py:70-79)."""
        device = self.logit_scale.device
        if self.glove_encoding:
            if glove_rows is None:
                glove_rows = torch.zeros(self.n_classes,
                                         self.glove_net.glove_dim,
                                         device=device)
            return l2_normalize(self.glove_net(glove=glove_rows))
        return l2_normalize(self.glove_net(torch.arange(self.n_classes,
                                                        device=device)))

    def _class_rows(self, B: int, T: int, glove: torch.Tensor | None = None,
                    dp_glove: float = 0.0,
                    generator: torch.Generator | None = None) -> torch.Tensor:
        """(B*T, d_e) class embeddings of labels ``arange(T)`` per item
        (reference ``TaskWrapper.__getitem__``, utils.py:54), or in
        glove-encoding mode of the (B, T, glove_dim) ``glove`` rows."""
        if self.glove_encoding:
            return self.glove_net(glove=glove, dropout=dp_glove,
                                  generator=generator)
        labels = torch.arange(T, device=self.logit_scale.device).repeat(B)
        return self.glove_net(labels)

    def embed(self, emg: torch.Tensor, dp_emg: float = 0.0,
              generator: torch.Generator | None = None,
              glove: torch.Tensor | None = None, dp_glove: float = 0.0):
        """(B, T, emg_dim) -> normalized ``(e, g)``, both (B, T, d_e): the
        inputs of the fused contrastive loss (clip.py:81-92). ``glove``
        (B, T, glove_dim) feeds the glove-encoding class tower."""
        B, T = emg.shape[:2]
        e = self.emg_net(emg.reshape(-1, emg.shape[-1]), dropout=dp_emg,
                         generator=generator).reshape(B, T, -1)
        g = self._class_rows(B, T, glove, dp_glove, generator)
        return l2_normalize(e), l2_normalize(g.reshape(B, T, -1))

    def embed_glove(self, glove: torch.Tensor, dp_glove: float = 0.0,
                    generator: torch.Generator | None = None) -> torch.Tensor:
        """The class half of :meth:`embed` alone, for the fused training
        chain (clip.py:94-105): normalized (B, T, d_e) class embeddings of
        the (B, T, glove_dim) ``glove`` rows (glove encoding) or of the
        labels (one-hot, where ``glove`` gives only the shape)."""
        B, T = glove.shape[:2]
        g = self._class_rows(B, T, glove, dp_glove, generator)
        return l2_normalize(g.reshape(B, T, -1))

    def forward(self, emg: torch.Tensor, dp_emg: float = 0.0,
                generator: torch.Generator | None = None,
                glove: torch.Tensor | None = None,
                dp_glove: float = 0.0) -> torch.Tensor:
        """Contrastive: similarity logits. ``emg`` (B, T, emg_dim) gives
        (B, T, T); the vote input (B, T, W, emg_dim) gives (B*W, T, T) in
        (item, frame) row order, with each item's class embeddings
        broadcast over its W frames (models.py:337-341,463-464).

        Prediction: normalized class scores (clip.py:124-133), (B*T,
        n_classes) from (B, T, emg_dim) or from the (B, T, glove_dim)
        ``glove`` rows, and (B*T, W, n_classes) from the vote input."""
        vote = emg.dim() == 4
        B, T = emg.shape[:2]
        W = emg.shape[2] if vote else 1
        if self.glove:
            return l2_normalize(self.glove_net(glove=glove, dropout=dp_glove,
                                               generator=generator))
        e = self.emg_net(emg.reshape(-1, emg.shape[-1]), dropout=dp_emg,
                         generator=generator)
        d = e.shape[-1]
        if self.prediction:
            e = l2_normalize(e)
            return e.reshape(B * T, W, d) if vote else e
        if vote:
            e = e.reshape(B, T, W, d).transpose(1, 2).reshape(B * W, T, d)
        else:
            e = e.reshape(B, T, d)
        g = self._class_rows(B, T, glove, dp_glove, generator).reshape(B, T, d)
        if vote:
            g = g[:, None].expand(B, W, T, d).reshape(B * W, T, d)
        return torch.bmm(l2_normalize(e), l2_normalize(g).transpose(1, 2))
