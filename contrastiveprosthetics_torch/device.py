"""Device selection for the port's entry points.

The counterpart of the JAX package's ``utils/platform.py``. The default is
the CUDA device; the CPU runs only when the caller asks for it
(``--platform cpu`` or ``CPTORCH_PLATFORM=cpu``). Without a GPU the default
raises instead of carrying on quietly on the CPU.
"""
from __future__ import annotations

import os

import torch

ENV_VAR = "CPTORCH_PLATFORM"
CHOICES = ("cuda", "cpu")


def select_device(choice: str | None = None) -> torch.device:
    """Resolve ``choice``, then ``$CPTORCH_PLATFORM``, then ``cuda``."""
    resolved = (choice or os.environ.get(ENV_VAR) or "cuda").lower()
    if resolved not in CHOICES:
        raise ValueError(f"platform must be one of {CHOICES}, got {resolved!r}")
    if resolved == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "platform 'cuda' requested but torch finds no CUDA device; "
            "pass --platform cpu (or set CPTORCH_PLATFORM=cpu) to run the "
            "plain PyTorch path on the CPU"
        )
    return torch.device(resolved)


def f32_convolutions():
    """A context with cuDNN's TF32 convolutions off: they default to TF32
    (about three decimal digits), and the port's training, evaluation and
    calibration passes run in f32, as the JAX package's do."""
    return torch.backends.cudnn.flags(enabled=True, allow_tf32=False)


def add_platform_flag(parser) -> None:
    """Attach the shared ``--platform`` flag to a CLI parser."""
    parser.add_argument(
        "--platform",
        choices=list(CHOICES),
        default=None,
        help="device to run on (default: cuda; env CPTORCH_PLATFORM)",
    )
