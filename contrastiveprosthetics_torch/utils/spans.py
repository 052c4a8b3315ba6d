"""Named spans at the port's layer boundaries, switched on by the profiler.

``with span("cptorch.serve.step"):`` marks a region of a hot path. With
no ``torch.profiler`` session running, :func:`span` returns the shared
no-op :data:`OFF` and records nothing: one flag read, where a bare
``record_function`` costs a C++ call and an allocation. Under a profiler
it opens a ``RecordFunction`` of its name through the profiler's fast
path (``_RecordFunctionFast``: no dispatcher op at either edge), so the
region lies in the trace on the profiler's clock beside the device's
operations and the host's CUDA calls; and it counts the port's kernel
launches between its edges (the counter ``ops/kernels.py`` hands over
with :func:`count_with`). A ``timed`` span also records a pair of CUDA
timing events on the current stream at its edges, where CUDA is
initialised: they cost a CUDA call each under the profiler, so only
the spans whose device time is read take them.

The newest :data:`KEEP` spans of each name are kept in memory, events
unresolved until read: :func:`device_ms` gives the mean stream time
between a timed span's edges, :func:`launches` the mean launches inside a
span. Neither depends on the trace's device records, which a trace can
drop.

Names start with ``cptorch.`` and hold no CUDA function's name: a reader
that names kernels by substring must not count a span.
"""
from __future__ import annotations

import collections
import contextlib
from typing import Callable, NamedTuple

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

KEEP = 4096  # spans kept a name, the newest
OFF = contextlib.nullcontext()  # what span() returns with no profiler

_store: dict[str, collections.deque] = {}
_launched: Callable[[], int] = lambda: 0  # noqa: E731


def count_with(counter: Callable[[], int]) -> None:
    """Count a span's launches with ``counter``, the launches so far."""
    global _launched
    _launched = counter


class _Record(NamedTuple):
    events: tuple | None  # a timed span's CUDA timing events at its edges
    launches: int         # the port's kernel launches between the edges


def _event():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class _Span:
    __slots__ = ("name", "timed", "_fn", "_n0", "_start")

    def __init__(self, name: str, timed: bool):
        self.name, self.timed = name, timed

    def __enter__(self):
        self._fn = _RecordFunctionFast(self.name)
        self._fn.__enter__()
        self._start = (_event() if self.timed and torch.cuda.is_initialized()
                       else None)
        self._n0 = _launched()
        return self

    def __exit__(self, *exc):
        n = _launched() - self._n0
        events = None if self._start is None else (self._start, _event())
        _store.setdefault(self.name, collections.deque(maxlen=KEEP)).append(
            _Record(events, n))
        self._fn.__exit__(*exc)
        return False


def span(name: str, timed: bool = False):
    """A context marking ``name`` in the profiler's trace and the store;
    :data:`OFF` when no profiler runs. ``timed``: with CUDA timing events
    at its edges under a profiler."""
    if not _profiler._is_profiler_enabled:
        return OFF
    return _Span(name, timed)


def _newest(name: str, last: int | None) -> list:
    kept = list(_store.get(name, ()))
    if last is None:
        return kept
    return kept[-last:] if last > 0 else []


def device_ms(name: str, last: int | None = None) -> float | None:
    """The mean stream time, in ms, between the edges of the newest
    ``last`` (default: every kept) spans ``name``; None without such spans
    or where one has no events (it was not timed, or ran without CUDA).
    Waits for the events."""
    recs = _newest(name, last)
    if not recs or any(r.events is None for r in recs):
        return None
    total = 0.0
    for r in recs:
        start, end = r.events
        end.synchronize()
        total += start.elapsed_time(end)
    return total / len(recs)


def launches(name: str, last: int | None = None) -> float | None:
    """The mean count of the port's kernel launches inside the newest
    ``last`` (default: every kept) spans ``name``; None without such
    spans."""
    recs = _newest(name, last)
    if not recs:
        return None
    return sum(r.launches for r in recs) / len(recs)


def names(prefix: str = "") -> list[str]:
    """The kept spans' names that start with ``prefix``, sorted."""
    return sorted(n for n in _store if n.startswith(prefix))


def clear() -> None:
    """Forget every kept span."""
    _store.clear()
