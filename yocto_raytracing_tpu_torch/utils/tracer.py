"""Spans of the program's own stages, on the profiler's clock.

A span is a named stretch of host time: its start and end, the span open
around it (its parent), the request it belongs to (its root span's id),
and a few numeric attributes (``note``). The program opens spans at its
layer boundaries: the entry points (``render_image``, ``train_step``,
``overlap_scene``), the device loops' stages, the copy to the host.

Spans record only while a ``torch.profiler`` session records, or inside a
``recording()`` block. Otherwise ``begin`` and ``end`` read one flag and
return: no clock read, no allocation, no profiler call, no device op.
While they record, each span is also a profiler user annotation (what
``torch.profiler.record_function`` makes), so the profiler stamps it on
the timeline of the device's events, and an exported Chrome trace shows
the spans over the kernels. The spans' own times are read from the
profiler's clock (``time.time_ns``, the wall clock in ns, on which the
profiler puts host and device events alike), inside the annotation: a
span lies within the profiler's event of its name, up to the profiler's
conversion of its own cycle counter (well under a microsecond).

Spans go into a ring in memory, bounded by requests: the last ``RING``
root spans, each with its children. ``spans()`` reads them; nothing is
written to disk. One thread's spans: the ring and the stack of open spans
are the process's, as the profiler's session is.

The device loops' stages (``Stages``) give both their spans and the loop's
own record (``kernels.last_frame()["host_ms"]``) from the same clock
readings, so the two cannot disagree. While spans do not record, one
reading marks each boundary; while they record, a stage reads the clock
inside its annotation, as every span does, so the record leaves out the
tracer's own work between two stages.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import time

import torch
from torch.autograd import profiler as _profiler

RING = 256          # root spans (requests) kept, each with its children

clock = time.time_ns   # the profiler's clock: wall-clock ns


# torch's own flag of a profiler session (``_is_profiler_enabled``, set
# while one records) and its cheapest user annotation
_session = _profiler
_Annotation = torch._C._profiler._RecordFunctionFast

_forced = 0                               # open recording() blocks
_open: list = []                          # open spans, innermost last
_ring: collections.deque = collections.deque(maxlen=RING)
_ids = itertools.count(1)


class Span:
    """One span: ``name``; ``start_ns`` and ``end_ns`` on ``clock`` (None
    while open); ``id``; ``parent``, the id of the span open around it
    (None for a root); ``request``, its root's id; ``attrs``, its numeric
    attributes by name."""

    __slots__ = ("name", "start_ns", "end_ns", "id", "parent", "request",
                 "attrs", "_annotation", "_spans")

    def __init__(self, name, start_ns, id, parent, request, spans):
        self.name = name
        self.start_ns = start_ns
        self.end_ns = None
        self.id = id
        self.parent = parent
        self.request = request
        self.attrs = {}
        self._annotation = None
        self._spans = spans

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns


def in_recording() -> bool:
    """Whether a ``recording()`` block is open (a profiler session alone
    does not count)."""
    return _forced > 0


def begin(name: str) -> Span | None:
    """Open a span ``name`` inside the innermost open span; None (and
    nothing done) while spans do not record. Close it with ``end``."""
    if not (_forced or _session._is_profiler_enabled):
        return None
    return _begin(name)


def end(span: Span | None) -> None:
    """Close ``span`` (from ``begin``), and any span still open inside it;
    nothing for None or a span already closed."""
    if span is None:
        return
    _end(span)


def note(span: Span | None, key: str, value) -> None:
    """Set the attribute ``key`` of ``span``: a float stays one (a share),
    any other value is taken as an integer; nothing for None."""
    if span is not None:
        span.attrs[key] = value if isinstance(value, float) else int(value)


def _begin(name):
    annotation = _Annotation(name)
    annotation.__enter__()
    t = clock()                     # read inside the annotation
    if _open:
        parent = _open[-1]
        span = Span(name, t, next(_ids), parent.id, parent.request,
                    parent._spans)
    else:
        span_id = next(_ids)
        span = Span(name, t, span_id, None, span_id, [])
        _ring.append(span._spans)
    span._annotation = annotation
    span._spans.append(span)
    _open.append(span)
    return span


def _end(span):
    """Close ``span`` and what is open inside it, on one clock reading
    taken before their annotations close; return the reading it ended on
    (``end_ns``)."""
    if span.end_ns is not None or span not in _open:
        return span.end_ns
    t = clock()
    while True:
        inner = _open.pop()
        inner.end_ns = t
        inner._annotation.__exit__(None, None, None)
        inner._annotation = None
        if inner is span:
            return t


class Stages:
    """The contiguous stages of a device-loop call, each a span inside the
    span open when the first one starts, and their milliseconds for the
    loop's record (``ms``), from the same clock readings. While spans do
    not record, one reading marks each boundary."""

    __slots__ = ("_ns", "_name", "_span", "_t")

    def __init__(self, first: str):
        self._ns = {}
        self._span = None
        self._t = self._start(first, None)

    def _start(self, name, t):
        """Start stage ``name``; return its first reading (``t``, where
        spans do not record and it is given)."""
        self._name = name
        if _forced or _session._is_profiler_enabled:
            self._span = _begin(name)
            return self._span.start_ns
        return clock() if t is None else t

    def _stop(self) -> int:
        """End the current stage; return its last reading."""
        if self._span is not None:
            t = _end(self._span)
            self._span = None
        else:
            t = clock()
        self._ns[self._name] = self._ns.get(self._name, 0) + t - self._t
        return t

    def next(self, name: str) -> Span | None:
        """End the current stage and start ``name``; its span, or None."""
        self._t = self._start(name, self._stop())
        return self._span

    def stop(self) -> None:
        """End the last stage."""
        self._stop()

    def ms(self, *names: str) -> float:
        """The milliseconds of the stages ``names`` (0 for one that did not
        run), summed in ns before the one division."""
        return sum(self._ns.get(n, 0) for n in names) / 1e6


@contextlib.contextmanager
def recording():
    """Record spans inside the block, with or without a profiler."""
    global _forced
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1


def spans() -> list:
    """The closed spans of the ring's requests, oldest request first, each
    request's spans in the order they started."""
    return [s for request in list(_ring) for s in request
            if s.end_ns is not None]


def clear() -> None:
    """Empty the ring (open spans stay open)."""
    _ring.clear()
