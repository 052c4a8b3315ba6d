"""``cptorch-import``: a checkpoint of the JAX package into the port's.

``cptpu-train`` saves its whole ``TrainState`` as
``checkpoints/contrastive.msgpack``; this writes the port's checkpoint
pair from it, ``contrastive.pt`` (the reference state_dict) and
``contrastive.adam.pt`` (both Adam chains, moments permuted as their
parameters, the step count, a bf16 ``mu`` kept bf16), which
``cptorch-results``, ``cptorch-serve --checkpoint`` and ``cptorch-train
--load_model`` read::

    cptorch-import checkpoints/contrastive.msgpack \\
        --out checkpoints/contrastive.pt

Depth, widths and mode come from the tree (``train/jax_interop.py``);
plain BatchNorm is not in it: pass ``--no_adabn`` for a model trained
with ``--no_adabn``, as ``cptpu-export`` asks. A file that is not a
``TrainState`` msgpack, or whose tree no mode explains, exits 2.
"""
from __future__ import annotations

import argparse
import os
import sys

from contrastiveprosthetics_torch.device import add_platform_flag, select_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cptorch-import", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("src", help="JAX TrainState msgpack "
                               "(checkpoints/contrastive.msgpack)")
    p.add_argument("--out", default=None,
                   help="the port's checkpoint (default: alongside src, "
                        ".msgpack -> .pt); its Adam chains go to the "
                        ".adam.pt beside it")
    p.add_argument("--no_adabn", action="store_false", dest="adabn",
                   help="the checkpoint was trained with plain BatchNorm "
                        "(its running statistics are imported)")
    p.add_argument("--d_e", type=int, default=None,
                   help="embedding width of the idle class tower "
                        "(prediction checkpoints carry no d_e; default 16)")
    add_platform_flag(p)
    return p


def describe(state) -> str:
    """The summary line of a state's model: mode, BatchNorm, depth,
    widths and the count of trained parameters (the JAX tree's), as the
    JAX CLIs print it."""
    from contrastiveprosthetics_torch.models.convert import architecture

    arch = architecture(state.model.state_dict())
    mode = ("prediction+glove" if arch["glove"] else "prediction"
            if arch["prediction"] else "glove_encoding"
            if arch["glove_encoding"] else "contrastive")
    bn = "adabn" if arch["adabn"] else "plain-bn (running stats)"
    n_params = sum(p.numel() for tower in state.model.towers().values()
                   for p in tower.parameters())
    return (f"  mode={mode} bn={bn} n_linear={arch['n_linear']} "
            f"hidden={arch['hidden']} d_e={arch.get('d_e', 16)} "
            f"params={n_params:,}")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = select_device(args.platform)

    from contrastiveprosthetics_torch.train.checkpoint import (
        adam_path,
        save_checkpoint,
    )
    from contrastiveprosthetics_torch.train.jax_interop import (
        InteropError,
        read_msgpack,
    )

    out = args.out or os.path.splitext(args.src)[0] + ".pt"
    widths = {} if args.d_e is None else {"d_e": args.d_e}
    try:
        state, stats = read_msgpack(args.src, adabn=args.adabn, **widths)
    except (InteropError, OSError) as e:
        print(f"cptorch-import: cannot read {args.src}: {e}",
              file=sys.stderr)
        return 2
    state.model.to(device)
    for opt in (state.opt_emg, state.opt_glove):
        opt.mu = [t.to(device) for t in opt.mu]
        opt.nu = [t.to(device) for t in opt.nu]
    save_checkpoint(out, state, jax_batch_stats=stats)
    print(f"imported {args.src} -> {out} (Adam chains: {adam_path(out)})")
    print(describe(state))
    mu = (state.opt_emg.mu or state.opt_glove.mu)[0].dtype
    print(f"  Adam: count {state.opt_emg.count} (emg), "
          f"{state.opt_glove.count} (glove); mu {str(mu)[6:]}, nu float32"
          + ("; the AdaBN running statistics, which no layer reads, kept "
             "for cptorch-export" if stats is not None else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
