"""``cptorch-export``: the port's checkpoint as one of the JAX package.

The inverse of ``cptorch-import``: the pair ``contrastive.pt`` /
``contrastive.adam.pt`` that ``cptorch-train`` saves becomes the
``TrainState`` msgpack that ``cptpu-results``, ``cptpu-serve
--checkpoint`` and ``cptpu-train --load_model`` restore::

    cptorch-export checkpoints/contrastive.pt \\
        --out checkpoints/contrastive.msgpack

Depth, widths, mode and BatchNorm come from the state_dict's keys
(``train/jax_interop.py``). Both Adam chains come from the ``.adam.pt``
sibling; without one (a reference checkpoint, which holds the weights
only) the chains are fresh, and the summary says so. A file that is not
a state_dict of the port exits 2.
"""
from __future__ import annotations

import argparse
import os
import pickle
import sys
import zipfile

from contrastiveprosthetics_torch.device import add_platform_flag, select_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cptorch-export", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("src", help="the port's checkpoint "
                               "(checkpoints/contrastive.pt)")
    p.add_argument("--out", default=None,
                   help="output msgpack (default: alongside src, "
                        ".pt -> .msgpack)")
    add_platform_flag(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = select_device(args.platform)

    from contrastiveprosthetics_torch.cli.import_ckpt import describe
    from contrastiveprosthetics_torch.train.checkpoint import (
        adam_path,
        load_checkpoint,
        load_jax_batch_stats,
    )
    from contrastiveprosthetics_torch.train.jax_interop import (
        InteropError,
        write_msgpack,
    )

    out = args.out or os.path.splitext(args.src)[0] + ".msgpack"
    try:
        state = load_checkpoint(args.src, device)
        stats = load_jax_batch_stats(args.src)
        write_msgpack(out, state, stats)
    except (InteropError, ValueError, KeyError, RuntimeError, OSError,
            pickle.UnpicklingError, zipfile.BadZipFile) as e:
        print(f"cptorch-export: cannot express {args.src} as a JAX "
              f"TrainState: {e}", file=sys.stderr)
        return 2
    print(f"exported {args.src} -> {out}")
    print(describe(state))
    if os.path.exists(adam_path(args.src)):
        print(f"  Adam: count {state.opt_emg.count} (emg), "
              f"{state.opt_glove.count} (glove), from {adam_path(args.src)}")
    else:
        print(f"  Adam chains are fresh: {args.src} has no "
              f"{os.path.basename(adam_path(args.src))} beside it (a "
              "reference checkpoint is weights-only, train.py:122-126)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
