"""Faults planted in the port underneath a run, to show that the check
catches them (``tests/test_bench_port_faults.py``, and ``controls.py
--fault`` on the card at a cell's own size).

Each cell can have three of the four kinds: a step that returns its state
unchanged, half of the batch left out (the mean taken over the rest), and
a token or answer altered where it is produced. The fourth, the exchange
between chips left out, has nothing to break in a one-chip cell.
"""
from __future__ import annotations

import contextlib

FAULTS = {"serve_live": ("state_unchanged", "half_batch", "token_altered"),
          "sweep": ("state_unchanged", "half_batch", "token_altered")}
ALTERED_TICK = 100  # the call of the tick chain whose predictions change


@contextlib.contextmanager
def _patched(module, name: str, new):
    old = getattr(module, name)
    setattr(module, name, new(old))
    try:
        yield
    finally:
        setattr(module, name, old)


def _serve(fault: str):
    from contrastiveprosthetics_torch.serve import stream

    calls = [0]

    def wrap(tick_chain):
        def broken(*args, **kwargs):
            carry, preds, votes, masked = tick_chain(*args, **kwargs)
            calls[0] += 1
            if fault == "state_unchanged":
                carry = tuple(args[:4])
            elif fault == "half_batch":
                half = preds.shape[1] // 2
                preds, votes = preds.clone(), votes.clone()
                preds[:, half:] = 0
                votes[:, half:] = 0
            elif calls[0] == ALTERED_TICK:
                preds = (preds + 1) % masked.shape[-1]
            return carry, preds, votes, masked
        return broken

    return _patched(stream, "tick_chain", wrap)


def _sweep(fault: str):
    from contrastiveprosthetics_torch.train import engine

    if fault == "state_unchanged":
        def wrap(_sgd_step):
            def broken(self, state, emg_b, hyper, lr_emg, lr_glove, generator,
                       ext_masks=None, glove_b=None, mesh=None):
                loss, acc, _ = self.loss_and_grads(
                    state, emg_b, hyper, generator, ext_masks, glove_b, mesh)
                return loss, acc
            return broken
        return _patched(engine.Trainer, "_sgd_step", wrap)

    def wrap(loss_fn):
        def broken(e, g):
            if fault == "half_batch":
                n = e.shape[-3] // 2
                return loss_fn(e[..., :n, :, :].contiguous(),
                               g[..., :n, :, :].contiguous())
            loss, correct = loss_fn(e, g)
            return loss * 1.001, correct
        return broken

    return _patched(engine, "fused_contrastive_loss", wrap)


def planted(driver: str, fault: str):
    """A context in which the port runs with ``fault``."""
    if fault not in FAULTS[driver]:
        raise ValueError(f"no fault {fault!r} for {driver}: {FAULTS[driver]}")
    return (_serve if driver == "serve_live" else _sweep)(fault)
