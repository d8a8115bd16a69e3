"""The port's tracer: named spans and counters, held in memory.

    from repro_torch import telemetry

    with telemetry.span("tuner.decide"):
        ...
    telemetry.count("index.pages_built", pages)

A span records its name, its start and end and its parent, the span
open around it on the same thread.  Its clock is the monotonic
``time.perf_counter_ns()``, stamped on ``time.time_ns()``'s scale by one
offset taken at ``enable()``: the scale ``torch.profiler``'s kineto
events are stamped on, so that ``kernels_under`` (and ``pibench``) can
put device activity under the program's spans.  A counter adds up a
number.  Names are ``layer.what``; ``PERF.md`` lists them and the metric
each one is for.

The tracer is off until a caller turns it on with ``enable()``, and
``drain()`` hands back what was recorded since the last drain and
forgets it.  Nothing is written anywhere.  Off, ``span()`` returns one
shared object whose ``with`` does nothing, and ``count()`` returns at
once: a call and a flag test per site.  Keep sites out of per-row and
per-page Python loops.

``stopwatch()`` is a span that reads the clock even when the tracer is
off, for a caller that needs the time itself (``ExecStats.wall_s``):
one reading then serves both.

``kernels_under`` reads a ``torch.profiler`` trace beside a drained
trace: the device activity whose launch the host made inside the spans
of one name, found by the launch's correlation id.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, NamedTuple

__all__ = ["Span", "Trace", "count", "disable", "drain", "enable",
           "kernels_under", "read_events", "span", "stopwatch"]


class Span(NamedTuple):
    """One recorded span; ``parent`` indexes the same drained list
    (-1: none), ``end_ns`` is None for a span still open at the drain."""

    name: str
    start_ns: int
    end_ns: int | None
    parent: int


class Trace(NamedTuple):
    spans: List[Span]
    counts: Dict[str, int]


_on = False
_spans: list = []           # [name, start, end, parent] records
_counts: Dict[str, int] = {}
_local = threading.local()  # .open: (list, index) of this thread's open spans
_offset = time.time_ns() - time.perf_counter_ns()


def enable() -> None:
    global _on, _offset
    _offset = time.time_ns() - time.perf_counter_ns()
    _on = True


def disable() -> None:
    global _on
    _on = False


def drain() -> Trace:
    """What was recorded since the last drain; the tracer starts
    afresh (on or off as it was)."""
    global _spans, _counts
    spans, counts = _spans, _counts
    _spans, _counts = [], {}
    return Trace([Span(*r) for r in spans], counts)


def count(name: str, n: int = 1) -> None:
    if _on:
        _counts[name] = _counts.get(name, 0) + int(n)


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Span:
    __slots__ = ("name", "start_ns", "end_ns", "_rec", "_open")

    def __init__(self, name: str):
        self.name = name
        self._rec = self.end_ns = None

    def __enter__(self):
        if _on:
            stack = getattr(_local, "open", None)
            if stack is None:
                stack = _local.open = []
            # (list, index) of each open span: one opened before the
            # last drain is no parent of a span in the new list.
            parent = stack[-1][1] if stack and stack[-1][0] is _spans else -1
            self._rec = [self.name, 0, None, parent]
            self._open = stack
            stack.append((_spans, len(_spans)))
            _spans.append(self._rec)
        self.start_ns = time.perf_counter_ns() + _offset
        if self._rec is not None:
            self._rec[1] = self.start_ns
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns() + _offset
        if self._rec is not None:
            self._rec[2] = self.end_ns
            self._open.pop()
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


def span(name: str):
    """A ``with`` block recorded as span ``name`` while the tracer is
    on; the shared no-op while it is off."""
    return _Span(name) if _on else _NOOP


def stopwatch(name: str) -> _Span:
    """A span that always reads the clock: ``.seconds`` after the
    block; recorded as span ``name`` while the tracer is on."""
    return _Span(name)


# -- reading a device trace beside the spans -------------------------------

def read_events(events, t0_ns: int = 0, t1_ns: int = 2**63 - 1):
    """Of kineto events (``prof.profiler.kineto_results.events()``),
    the device activity as (start, end, correlation id, name) clipped to
    [t0_ns, t1_ns), and the CUDA runtime's calls on the host as (start,
    name, correlation id), both in time order."""
    from torch.autograd import DeviceType

    cuda = DeviceType.CUDA
    dev, rt = [], []
    for e in events:
        name = e.name()
        if e.device_type() == cuda:
            if e.is_user_annotation() or name.startswith("aten::"):
                continue
            a = e.start_ns()
            b = a + e.duration_ns()
            if b > t0_ns and a < t1_ns:
                dev.append((max(a, t0_ns), min(b, t1_ns),
                            e.correlation_id(), name))
        elif name.startswith("cu"):
            a = e.start_ns()
            if t0_ns <= a < t1_ns:
                rt.append((a, name, e.correlation_id()))
    dev.sort()
    rt.sort()
    return dev, rt


def kernels_under(trace: Trace, events, name: str, t0_ns: int = 0,
                  t1_ns: int = 2**63 - 1):
    """How many spans named ``name`` ``trace`` holds, and (kernel name,
    device ns) of each device activity that a runtime call made inside
    one of them (at any depth under it) started."""
    import bisect

    dev, rt = read_events(events, t0_ns, t1_ns)
    mine = [s for s in trace.spans if s.name == name]
    starts, ends = [], []
    for s in sorted(mine, key=lambda s: s.start_ns):
        if s.end_ns is None:
            continue
        if ends and s.start_ns <= ends[-1]:
            ends[-1] = max(ends[-1], s.end_ns)
        else:
            starts.append(s.start_ns)
            ends.append(s.end_ns)
    corr = set()
    for t, _, c in rt:
        k = bisect.bisect_right(starts, t) - 1
        if k >= 0 and t < ends[k]:
            corr.add(c)
    return len(mine), [(nm, b - a) for a, b, c, nm in dev if c in corr]
