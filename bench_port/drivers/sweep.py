"""The crossval sweep: ``configs`` configs as one chunk of stacked steps.

Set-up, from the seed: the store of every person (the normalised EMG
tensor, tasks first, one profile a task and an offset a person plus noise),
the configs' hyperparameters (the reference's sampler, ``sample_configs``),
the port's ``Trainer`` (plain BatchNorm, bs 8; ``use_fused_train`` as the
traffic says) and its ``sweep_start``, whose stacked parameters then take
the benchmark's weights (``reference/weights.py``, one draw a config); each
epoch's index matrices (per config: a permutation of each task's D
windows, and the batch order) from the seed; the chunk's dropout
generator. The seed changes values only: C, the store's shape, every
batch's shape and the steps are the same for every seed.

Then the first ``check_steps`` stacked steps through the window's own call
(``Trainer.sweep_epoch_from_indices``), read for the check: each step's
losses, each leaf's gradient from Adam's first moment after step 1, each
leaf's change after the last. The window continues the same state and
epoch in calls of ``block_steps`` steps, one more in flight while the
card runs the last, drawing the next epoch's index matrices at each epoch's
end, and ends with the last step it counts. ``train_windows_per_s``: the
steps' train windows (C configs x bs items x T tasks a step) over the
window's time.

The check, after the window: the plain reference (``train_ref.py``) runs
the same steps in float64 from the same weights, batches and dropout
masks; the numbers compared are the worst config's loss gap, and the
worst leaf's gap in gradient norm and in change norm (against the larger
of that leaf's reference norm and the median leaf's). Leaves whose
reference gradient is under a thousandth of the median leaf's move by
round-off alone and are left out of the change.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from bench_port import harness
from bench_port.reference import train_ref
from bench_port.reference.weights import make_weights, sub_seed
from bench_port.yardstick import counts, trace as tr
from bench_port.yardstick.peaks import PEAK_FLOPS

TRACED_SPAN = "bench_port.traced_steps"
HYPER_KEYS = ("lr_emg", "reg_emg", "dp_emg", "lr_glove", "reg_glove",
              "dp_glove")
NEGLIGIBLE = 1e-3  # a leaf's gradient against the median leaf's


def sample_configs(n: int, seed: int, s: dict) -> dict:
    """The reference's random search (``code/train.py``): log-uniform lr
    and reg, uniform dropout rates; (n,) f32 arrays."""
    rng = np.random.default_rng(sub_seed(seed, "configs"))
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return dict(lr_emg=f32(10 ** rng.uniform(*s["lr_log10"], n)),
                reg_emg=f32(10 ** rng.uniform(*s["reg_log10"], n)),
                dp_emg=f32(rng.uniform(*s["dp_emg"], n)),
                lr_glove=f32(10 ** rng.uniform(*s["lr_log10"], n)),
                reg_glove=f32(10 ** rng.uniform(*s["reg_log10"], n)),
                dp_glove=f32(rng.uniform(*s["dp_glove"], n)))


def make_store_tensor(ctx) -> torch.Tensor:
    """(tasks, people, reps, frames, D) normalised EMG, f32, on the card."""
    cfg = ctx.cell.config
    sp, st = cfg["split"], ctx.param("store")
    n_tasks, D = cfg["model"]["n_classes"], cfg["model"]["emg_dim"]
    gen = torch.Generator(ctx.device).manual_seed(sub_seed(ctx.seed, "store"))
    shape = (n_tasks, sp["n_people"], sp["n_reps"], sp["frames"], D)
    kw = dict(generator=gen, device=ctx.device)
    profile = torch.randn((n_tasks, 1, 1, 1, D), **kw)
    person = torch.randn((1, sp["n_people"], 1, 1, D), **kw)
    return (st["noise_scale"] * torch.randn(shape, **kw)
            + st["profile_scale"] * profile + st["person_scale"] * person)


def train_rows(emg: torch.Tensor, sp: dict) -> torch.Tensor:
    """The train split's windows, (tasks * people * reps * frames, D), in
    the order the index matrices address: tasks in the split's order, the
    view's people, its train reps."""
    dev = emg.device
    t = emg[torch.as_tensor(sp["tasks_mask"], device=dev)]
    t = t[:, torch.as_tensor(sp["people"], device=dev)]
    t = t[:, :, torch.as_tensor(sp["train_reps"], device=dev)]
    return t.reshape(-1, emg.shape[-1])


def draw_plan(seed: int, epoch: int, C: int, n_tasks: int, D: int, bs: int,
              device):
    """An epoch's index matrices: (C, n_tasks, D) rows into the train
    split (row t of config c a permutation of task t's windows) and the
    (C, D // bs, bs) batches of items."""
    gen = torch.Generator(device).manual_seed(sub_seed(seed, "plan", epoch))
    perms = torch.rand((C, n_tasks, D), generator=gen,
                       device=device).argsort(-1)
    perms += torch.arange(n_tasks, device=device)[:, None] * D
    order = torch.rand((C, D), generator=gen, device=device).argsort(-1)
    return perms, order[:, :D // bs * bs].reshape(C, D // bs, bs)


def gather(rows: torch.Tensor, perms, items) -> torch.Tensor:
    """(C, bs * n_tasks, D) frames of a batch, in (item, task) order."""
    C, n_tasks, _ = perms.shape
    idx = perms.gather(2, items[:, None, :].expand(-1, n_tasks, -1))
    return rows[idx.transpose(1, 2).reshape(C, -1)]


def leaf_names(state) -> tuple[list[str], list[str]]:
    names = {id(p): n for n, p in state.model.named_parameters()}
    towers = state.model.towers()
    return ([names[id(p)] for p in towers["emg_net"].parameters()],
            [names[id(p)] for p in towers["glove_net"].parameters()])


def norms(ts) -> torch.Tensor:
    return torch.stack([t.detach().flatten(1).double().norm(dim=1)
                        for t in ts])


def leaf_gaps(prog: torch.Tensor, ref: torch.Tensor, keep=None
              ) -> torch.Tensor:
    """Each (leaf, config)'s gap between norms, against the larger of that
    leaf's reference norm and the median leaf's of its config. ``prog``,
    ``ref`` (leaves, C); ``keep`` (leaves, C) bool or None: the leaves
    compared (the others read 0)."""
    if keep is None:
        keep = torch.ones_like(ref, dtype=torch.bool)
    med = torch.stack([r[k].median() for r, k in zip(ref.T, keep.T)])
    scale = torch.maximum(ref, med[None, :])
    gap = torch.where(keep, (prog - ref).abs() / scale, 0.0)
    return torch.where(torch.isfinite(prog) & torch.isfinite(ref), gap,
                       torch.inf)


def worst(gap: torch.Tensor, names: list[str]) -> dict:
    """Where the largest of (leaves, C) gaps lies."""
    i = int(gap.argmax())
    leaf, c = divmod(i, gap.shape[1])
    return {"leaf": names[leaf], "config": c, "gap": float(gap.max())}


def run(ctx):
    from contrastiveprosthetics_torch.config import Config
    from contrastiveprosthetics_torch.data.store import DeviceStore
    from contrastiveprosthetics_torch.train.engine import Hyper, Trainer

    cfg = ctx.cell.config
    m, sp, tcfg, dtype = cfg["model"], cfg["split"], cfg["train"], cfg["dtype"]
    dev = ctx.device
    cuda = dev.type == "cuda"
    C = ctx.param("configs")
    bs, T, n_check = tcfg["batch_size"], m["n_classes"], ctx.param(
        "check_steps")
    torch.set_num_threads(2)

    stages = harness.Stages(ctx.t_start)
    stages.mark("imports")
    pcfg = Config()
    emg = make_store_tensor(ctx)
    store = DeviceStore(pcfg, emg.cpu().numpy(), range(sp["n_people"]),
                        device=dev)
    del emg
    trainer = Trainer(pcfg, store, adabn=not tcfg["plain_batchnorm"],
                      batch_size=bs, use_fused_train=ctx.param(
                          "use_fused_train"))
    D = trainer.view_train.D
    stages.mark("store")
    steps_per_epoch = D // bs
    hyper = sample_configs(C, ctx.seed, tcfg["sampler"])
    dgen = torch.Generator(dev).manual_seed(sub_seed(ctx.seed, "dropout"))
    gens = [torch.Generator(dev).manual_seed(i) for i in range(C)]
    state, h = trainer.sweep_start(Hyper(*[hyper[k] for k in HYPER_KEYS]),
                                   gens, dgen)
    stages.mark("sweep_start")
    w0 = make_weights(m, ctx.seed, dev, configs=C)
    emg_names, glove_names = leaf_names(state)
    with torch.no_grad():
        for n, p in state.model.named_parameters():
            if n in w0:
                p.copy_(w0[n])
    plan = draw_plan(ctx.seed, 0, C, T, D, bs, dev)
    none = plan[1].new_empty((C, 0))
    lr_f = float(ctx.param("lr_factor"))
    gen_state = dgen.get_state()
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    def steps(lo: int, k: int, perms_batches):
        perms, batches = perms_batches
        return trainer.sweep_epoch_from_indices(
            state, perms, batches[:, lo:lo + k], none, h, lr_f, lr_f, dgen)

    prog_loss = []
    for i in range(n_check):
        prog_loss.append(steps(i, 1, plan)[0][:, 0])
        if i == 0:
            b1 = tcfg["adam"]["b1"]
            g1 = norms(state.opt_emg.mu + state.opt_glove.mu) / (1 - b1)
    params = dict(state.model.named_parameters())
    change = norms([params[n] - w0[n] for n in emg_names + glove_names])
    prog_loss = torch.stack(prog_loss).double().cpu()
    g1, change = g1.cpu(), change.cpu()
    del w0, params
    sync()

    stages.mark("weights_and_check_steps")
    gc.collect()
    gc.disable()
    card_before = harness.card_state() if cuda else []
    pos, epoch = [n_check], [0]

    def enqueue(k: int):
        if pos[0] == steps_per_epoch:
            epoch[0] += 1
            plan[:] = draw_plan(ctx.seed, epoch[0], C, T, D, bs, dev)
            pos[0] = 0
        k = min(k, steps_per_epoch - pos[0])
        steps(pos[0], k, plan)
        pos[0] += k
        ev = torch.cuda.Event() if cuda else None
        if ev is not None:
            ev.record()
        return k, ev

    plan = list(plan)
    block = ctx.param("block_steps")
    start = time.perf_counter()
    setup_s = start - ctx.t_start
    inflight, done = [enqueue(block)], 0
    while inflight:
        if time.perf_counter() - start < ctx.seconds:
            inflight.append(enqueue(block))
        k, ev = inflight.pop(0)
        if ev is not None:
            ev.synchronize()
        done += k
    sync()
    window_s = time.perf_counter() - start
    card_after = harness.card_state() if cuda else []
    gc.enable()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    rows_per_step = bs * T
    obs = {"model": m, "dtype": dtype, "configs": C, "steps": done,
           "window_s": window_s, "trace": None, "traced_steps": 0,
           "fused": bool(ctx.param("use_fused_train")),
           "step_flops": counts.train_step_flops(m, C, rows_per_step, bs),
           "peak_flops": PEAK_FLOPS[dtype],
           "k5_bound_s": counts.k5_step_bound_s(m, C, rows_per_step, dtype)}
    busy_s = traced_s = breakdown = None
    if ctx.trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        n_tr = min(ctx.param("trace_steps"), steps_per_epoch)
        if pos[0] + n_tr > steps_per_epoch:
            epoch[0] += 1
            plan[:] = draw_plan(ctx.seed, epoch[0], C, T, D, bs, dev)
            pos[0] = 0
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        with profile(activities=acts) as prof:
            with record_function(TRACED_SPAN):
                steps(pos[0], n_tr, plan)
                sync()
        trace = tr.collect(prof)
        (lo, hi), = trace.spans(TRACED_SPAN)
        obs.update(trace=trace, traced_steps=n_tr, trace_span=(lo, hi))
        traced_s = hi - lo
        busy_s = tr.overlap(tr.busy(trace), lo, hi)
        breakdown = tr.breakdown(trace, lo, hi)

    # the check: free the port's state, then the reference
    keep_t = h.dp_emg.new_ones(()) - h.dp_emg
    del state, trainer, store, plan, h, dgen, gens
    if cuda:
        torch.cuda.empty_cache()
    rows = train_rows(make_store_tensor(ctx), sp)
    perms, batches = draw_plan(ctx.seed, 0, C, T, D, bs, dev)
    xs = [gather(rows, perms, batches[:, i]) for i in range(n_check)]
    derive = (train_ref.masks_fused if ctx.param("use_fused_train")
              else train_ref.masks_eager)
    extra = ((m["n_linear"] - m["dropout_blocks"],)
             if ctx.param("use_fused_train") else ())
    masks = derive(gen_state, dev, C, rows_per_step, m["hidden"], keep_t,
                   n_check, m["dropout_blocks"], *extra)
    w0 = make_weights(m, ctx.seed, dev, configs=C)
    p0 = {n: w0[n] for n in emg_names + glove_names}
    hyp = {k: torch.as_tensor(v, device=dev) for k, v in hyper.items()}

    def judge(mode: str) -> dict:
        loss, rg1, rchange = train_ref.adam_steps(
            p0, xs, masks, keep_t, hyp, m, bs, tcfg["adam"], mode)
        return {"loss": loss.double().cpu(),
                "g1": torch.stack([rg1[n] for n in p0]).double().cpu(),
                "change": torch.stack([rchange[n] for n in p0]).double().cpu()}

    names = emg_names + glove_names
    want = judge("float64")
    med = want["g1"].median(dim=0).values
    moved = want["g1"] >= NEGLIGIBLE * med[None, :]

    def readings(got: dict) -> dict:
        gap = ((got["loss"] - want["loss"]).abs()
               / want["loss"].abs()).nan_to_num(torch.inf)
        grad = leaf_gaps(got["g1"], want["g1"])
        change = leaf_gaps(got["change"], want["change"], moved)
        return {"loss1_gap": float(gap[0].max()),
                "grad_gap": float(grad.max()),
                "change_gap": float(change.max()),
                "later_loss_gap": float(gap[1:].max()),
                "worst_grad": worst(grad, names),
                "worst_change": worst(change, names)}

    read = readings({"loss": prog_loss, "g1": g1, "change": change})
    limits = ctx.cell.limits
    checks = [(k, read[k], limits[k]) for k in ("loss1_gap", "grad_gap",
                                                 "change_gap")]
    notes = {"card_before": card_before, "card_after": card_after,
             "steps": done, "window_s": window_s, "setup_s": setup_s,
             "setup_stages": stages.seconds,
             "leaves_left_out_of_change": int((~moved).sum()),
             "later_loss_gap": read["later_loss_gap"],
             "worst_grad": read["worst_grad"],
             "worst_change": read["worst_change"]}
    for mode in ctx.overrides.get("controls", ()):
        notes.setdefault("controls", {})[mode] = readings(judge(mode))
    return harness.Outcome(
        e2e={"train_windows_per_s": done * rows_per_step * C / window_s,
             "setup_s": setup_s},
        obs=obs, checks=checks, attempted=done * C, failed=0,
        memory_peak_bytes=peak, busy_s=busy_s, window_s=traced_s,
        breakdown=breakdown, notes=notes)
