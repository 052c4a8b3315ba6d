"""The seed changes values only: two seeds give the same work plan (the
same sessions, shapes, ticks due and subset sizes; the same configs,
store, batches and steps)."""
import torch

from bench_port import harness
from bench_port.drivers import serve_live, sweep
from bench_port.reference.weights import make_weights

SEEDS = (7, 2**31 + 99)


class Ctx:
    def __init__(self, workload, seed, **overrides):
        self.cell = harness.load_cell(workload)
        self.seed = seed
        self.device = torch.device("cpu")
        self.overrides = overrides

    def param(self, key):
        return self.overrides.get(key, self.cell.traffic[key])


def test_serve_plan_same_for_every_seed():
    plans = []
    for seed in SEEDS:
        ctx = Ctx("serve_live.cp_emgnet_f32.s49152", seed, sessions=96,
                  ring_ticks=6)
        ring = serve_live.raw_ring(ctx, 96, ctx.cell.config["signal"])
        masks = serve_live.subset_masks(96, 41, 2, 41, seed, "cpu")
        w = make_weights(ctx.cell.config["model"], seed, "cpu", trained=True)
        plans.append((tuple(ring.shape), masks.sum(1).tolist(),
                      {k: tuple(v.shape) for k, v in w.items()},
                      ctx.param("rate_hz"), ring))
    (a, b) = plans
    assert a[:4] == b[:4]
    assert a[1] == [2 + s % 40 for s in range(96)]
    assert not torch.equal(a[4], b[4])


def test_sweep_plan_same_for_every_seed():
    plans = []
    for seed in SEEDS:
        ctx = Ctx("sweep.cp_emgnet_f32.c150", seed)
        cfg = ctx.cell.config
        hyper = sweep.sample_configs(150, seed, cfg["train"]["sampler"])
        store = sweep.make_store_tensor(ctx)
        perms, batches = sweep.draw_plan(seed, 0, 3, 41, 1800, 8, "cpu")
        plans.append(({k: v.shape for k, v in hyper.items()},
                      tuple(store.shape), tuple(perms.shape),
                      tuple(batches.shape), hyper["lr_emg"]))
        rows = perms - torch.arange(41)[:, None] * 1800
        assert torch.equal(rows.sort(-1).values,
                           torch.arange(1800).expand(3, 41, -1))
        assert torch.equal(batches.flatten(1).sort(-1).values,
                           torch.arange(1800).expand(3, -1))
    (a, b) = plans
    assert a[:4] == b[:4]
    assert a[3] == (3, 225, 8)
    assert (a[4] != b[4]).any()
