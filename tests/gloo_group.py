"""A ``torch.distributed`` group of CPU processes for the tests: gloo,
``file://`` rendezvous, one torch thread a rank.

``run_group(fn, world, *args)`` starts ``world`` processes (the spawn
start method), each calls ``fn(rank, world, *args)`` inside the group and
returns its result (numpy arrays and Python values; tensors are not sent
back); the call returns the ranks' results in rank order, or raises with
every failed rank's traceback. ``fn`` is pickled by name, so it is
defined at module level in an importable module (``parallel_ranks.py``).
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import tempfile
import traceback

TIMEOUT_S = 600  # a rank's whole run
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=120)


def _entry(rank, world, path, results, fn, args):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{path}",
                                rank=rank, world_size=world,
                                timeout=COLLECTIVE_TIMEOUT)
        try:
            out = (rank, True, fn(rank, world, *args))
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
    except Exception:  # reported to the parent, which raises
        out = (rank, False, traceback.format_exc())
    results.put(out)


def run_group(fn, world: int, *args):
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_entry, args=(
            r, world, os.path.join(tmp, "rdv"), results, fn, args))
            for r in range(world)]
        for p in procs:
            p.start()
        got = {}
        try:
            for _ in range(world):  # drain before joining
                rank, ok, value = results.get(timeout=TIMEOUT_S)
                got[rank] = (ok, value)
                if not ok:  # the others would wait on it in a collective
                    break
        except queue.Empty:
            raise RuntimeError(f"ranks {sorted(set(range(world)) - set(got))}"
                               f" gave no result in {TIMEOUT_S} s") from None
        finally:
            for p in procs:
                p.join(timeout=30 if len(got) == world else 1)
                if p.is_alive():
                    p.kill()
                    p.join()
    failed = [f"rank {r}:\n{v}" for r, (ok, v) in sorted(got.items())
              if not ok]
    if failed:
        raise RuntimeError("\n".join(failed))
    return [got[r][1] for r in range(world)]
