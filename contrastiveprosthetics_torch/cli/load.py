"""Ingest CLI (``cptorch-load``), the port of ``cptpu-load``.

Keeps the reference's flags (``load.py:300-312``): ``--load`` builds the
EMG tensor, ``--load_glove`` the glove corpus, ``--info`` prints the split
geometry, ``--viz`` plots one (person, task, rep) signal. Adds the JAX
CLI's ``--root`` (the raw ``.mat`` tree), ``--data_dir`` (where the
artifacts go), ``--people`` (a partial ingest), ``--backend``,
``--synthetic_fixture`` (write a fabricated ``.mat`` tree first),
``--compat`` and ``--check_glove``, and ``--platform`` (cuda by default).

``--backend torch`` (the default; ``jax``, the JAX CLI's default, names
the same device backend) preprocesses each subject's segments in one
``iir_rms_frames`` launch on the chosen device; ``--backend scipy`` is the
float64 oracle on the host.
"""
from __future__ import annotations

import argparse

from contrastiveprosthetics_torch.device import add_platform_flag, select_device

# subjects of the glove corpus that --synthetic_fixture writes
FIXTURE_GLOVE_PEOPLE = [28, 29]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Loading ninapro dataset")
    p.add_argument("--task", type=int, default=0)
    p.add_argument("--rep", type=int, default=0)
    p.add_argument("--person", type=int, default=0)
    p.add_argument("--load", action="store_true")
    p.add_argument("--load_glove", action="store_true")
    p.add_argument("--viz", action="store_true")
    p.add_argument("--info", action="store_true")
    p.add_argument("--complete", action="store_true")
    p.add_argument("--no_glove", action="store_true")
    p.add_argument("--root", type=str, default=".")
    p.add_argument("--data_dir", type=str, default="data")
    p.add_argument("--people", type=int, nargs="*", default=None,
                   help="canonical person positions to ingest (default all)")
    p.add_argument("--backend", choices=["torch", "jax", "scipy"],
                   default="torch",
                   help="torch: one kernel launch per subject on --platform "
                        "(jax is another name for it); scipy: the float64 "
                        "oracle on the host")
    p.add_argument("--synthetic_fixture", action="store_true",
                   help="write a fabricated .mat tree under --root first")
    p.add_argument("--compat", action="store_true",
                   help="reproduce every reference quirk (config.py)")
    p.add_argument("--check_glove", action="store_true",
                   help="sanity-check the glove-angle corpus: stimulus "
                        "ranges and NaN columns per subject (reference "
                        "get_calibration.py)")
    add_platform_flag(p)
    return p


def check_glove_corpus(cfg, root, people=None) -> int:
    """Reference ``get_calibration.py:1-20``: per subject, print the
    restimulus range and the NaN columns of the angle recordings. Returns
    the number of issues."""
    import numpy as np
    import scipy.io as sio

    people = people if people is not None else range(
        cfg.glove_people_start, cfg.glove_people_stop)
    issues = 0
    for person in people:
        p_dir = str(person + 1)
        for ex in ("1", "2"):
            path = f"{root}/s_{p_dir}_angles/S{p_dir}_E{ex}_A1.mat"
            try:
                m = sio.loadmat(path)
            except FileNotFoundError:
                print(f"s{p_dir} E{ex}: MISSING")
                issues += 1
                continue
            ang = m["angles"]
            stim = m["restimulus"]
            nan_cols = np.where(np.isnan(ang).any(axis=0))[0]
            print(f"s{p_dir} E{ex}: stim [{stim.min()}, {stim.max()}] "
                  f"angles {ang.shape} nan_cols={nan_cols.tolist() or 'none'}")
            if len(nan_cols):
                issues += 1
    print(f"glove corpus check: {issues} issue(s)")
    return issues


def print_info(cfg, store) -> None:
    """Each split's geometry and value range (reference ``info()``,
    ``load.py:278-291``), reduced on the store's device."""
    print("Tasks (shuffled order):", cfg.tasks())
    for split in ("train", "val", "test"):
        v = store.view(split)
        t = v.emg_flat
        print(f"{split.upper()}: tasks={v.n_tasks} people={v.n_people} "
              f"reps={v.n_reps} D={v.D} total={v.n_tasks * v.D}")
        print(f"\trange [{float(t.min()):.6g}, {float(t.max()):.6g}] "
              f"mean {float(t.mean()):.6g} "
              f"std {float(t.std(correction=0)):.6g}")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = select_device(args.platform)

    from contrastiveprosthetics_torch.config import DEFAULT_CONFIG, compat_config
    from contrastiveprosthetics_torch.data.ingest import ingest_emg, ingest_glove

    cfg = compat_config(DEFAULT_CONFIG) if args.compat else DEFAULT_CONFIG

    if args.synthetic_fixture:
        from contrastiveprosthetics_torch.data.synthetic import (
            write_emg_mat_files,
            write_glove_mat_files,
        )

        positions = args.people if args.people is not None else list(range(2))
        print(f"writing synthetic .mat fixture to {args.root}")
        write_emg_mat_files(args.root, cfg, positions)
        write_glove_mat_files(args.root, cfg, people=FIXTURE_GLOVE_PEOPLE)

    # a synthetic fixture writes glove subjects 28-29 only: every glove
    # step is scoped to them (the full 39-subject corpus is not there)
    glove_people = FIXTURE_GLOVE_PEOPLE if args.synthetic_fixture else None
    if args.check_glove:
        check_glove_corpus(cfg, args.root, people=glove_people)

    if args.load:
        ingest_emg(cfg, args.root, args.data_dir,
                   people_positions=args.people,
                   complete=args.complete or cfg.compat_complete_stats,
                   backend=args.backend, device=device)
        if not args.no_glove and not args.load_glove:
            ingest_glove(cfg, args.root, args.data_dir, people=glove_people)
    if args.load_glove:
        ingest_glove(cfg, args.root, args.data_dir, people=glove_people)

    if args.info or args.viz:
        from contrastiveprosthetics_torch.data.store import DeviceStore

        store = DeviceStore.load(cfg, args.data_dir, device=device)
        if args.info:
            print_info(cfg, store)
        if args.viz:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            dat = store.emg[args.task, args.person, args.rep].cpu().numpy()
            for sensor in range(cfg.emg_dim):
                plt.plot(dat[:, sensor])
            out = "viz_person%d_task%d_rep%d.png" % (
                args.person, args.task, args.rep)
            plt.savefig(out, dpi=110)
            print(f"saved {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
