"""Reading a ``torch.profiler`` trace: device intervals, host spans, busy
time as the union of kernel intervals, and the breakdown the result line
carries.

The union matters: ``encoder_chain``'s layers launch with programmatic
dependent launch, so a layer's interval starts before the previous one's
ends, and a plain sum would count the overlap twice (the method of
``chip_smoke.py::device_summary``, frozen here).
"""
from __future__ import annotations

import dataclasses

# the CUDA functions of the port's kernels as a trace names them
# (``chip_smoke.py::DEVICE_FUNCTIONS``), by port kernel
DEVICE_FUNCTIONS = {
    "dsp_frames_kernel": "dsp_frames",
    "encoder_layer_large_kernel": "encoder_chain",
    "encoder_layer_small_kernel": "encoder_chain",
    "encoder_head_kernel": "encoder_chain",
    "encoder_layer_large_bf16_kernel": "encoder_chain",
    "encoder_layer_small_bf16_kernel": "encoder_chain",
    "encoder_head_bf16_kernel": "encoder_chain",
    "vote_scan_kernel": "vote_scan",
    "contrastive_loss_fwd_kernel": "contrastive_loss_fwd",
    "contrastive_loss_bwd_kernel": "contrastive_loss_bwd",
    "dense_block_fwd_kernel": "dense_block_fwd",
    "dense_block_bwd_kernel": "dense_block_bwd",
    "chain_tail_fwd_kernel": "chain_tail_fwd",
    "chain_tail_bwd_kernel": "chain_tail_bwd",
    "dropout_masks_kernel": "dropout_masks",
}
NO_HOST_OP = "host_outside_any_traced_operation"


@dataclasses.dataclass
class Trace:
    """Intervals in seconds on the profiler's clock: ``device`` (name,
    start, end) of every operation on the card, ``host`` (name, start,
    end) of every host operation and span."""

    device: list
    host: list

    def spans(self, name: str) -> list:
        return [(s, e) for n, s, e in self.host if n == name]


def collect(prof) -> Trace:
    """The trace's intervals. A host span (``record_function``) also
    appears on the device's timeline under its own name, covering the
    device work inside it: those copies are no device operation and are
    left out."""
    from torch.autograd import DeviceType

    device, host = [], []
    for ev in prof.events():
        item = (ev.name, ev.time_range.start / 1e6, ev.time_range.end / 1e6)
        (device if ev.device_type == DeviceType.CUDA else host).append(item)
    spans = {n for n, _, _ in host}
    return Trace([d for d in device if d[0] not in spans], host)


def port_kernel(name: str) -> str | None:
    return next((k for f, k in DEVICE_FUNCTIONS.items() if f in name), None)


def union(intervals) -> list:
    """Sorted, merged (start, end) intervals."""
    out: list = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            if end > out[-1][1]:
                out[-1][1] = end
        else:
            out.append([start, end])
    return out


def measure(merged) -> float:
    return sum(e - s for s, e in merged)


def overlap(merged, lo: float, hi: float) -> float:
    """The length of ``merged`` inside [lo, hi]."""
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in merged)


def busy(trace: Trace, kernel: str | None = None) -> list:
    """The merged intervals of every device operation, or of one port
    kernel's."""
    return union((s, e) for n, s, e in trace.device
                 if kernel is None or port_kernel(n) == kernel)


def breakdown(trace: Trace, lo: float, hi: float, top: int = 10) -> dict:
    """The device operations that took most time inside [lo, hi], and the
    longest idle gaps between them summed by what the host was doing at
    each gap's middle (its innermost host operation)."""
    ops: dict = {}
    for n, s, e in trace.device:
        if e > lo and s < hi:
            ops[n[:96]] = ops.get(n[:96], 0.0) + min(e, hi) - max(s, lo)
    merged = [(max(s, lo), min(e, hi)) for s, e in busy(trace)
              if e > lo and s < hi]
    edges = [lo] + [x for iv in merged for x in iv] + [hi]
    gaps: dict = {}
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        inner = [(e - s, n) for n, s, e in trace.host if s <= mid <= e]
        name = min(inner)[1][:96] if inner else NO_HOST_OP
        gaps[name] = gaps.get(name, 0.0) + b - a
    rank = lambda d: sorted(([k, v] for k, v in d.items()),  # noqa: E731
                            key=lambda kv: -kv[1])[:top]
    return {"device_ops": rank(ops), "idle_gaps": rank(gaps)}
