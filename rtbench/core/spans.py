"""The program's own spans, read after a traced run.

The port records spans (``yocto_raytracing_tpu_torch/utils/tracer.py``)
while a profiler session records: in a run with ``--trace 1``, in its
traced windows alone, where the harness's profiler is on. The readers
take the requests of the window that the device's metrics come from
(``measured``), and the median over them of one value a request. A span
has ``name``, ``start_ns``, ``end_ns``, ``id``, ``parent`` (its parent's
id, None for a request's root), ``request`` (its root's id) and
``attrs``. A program without the tracer records none, and every reader
then returns None.
"""

from __future__ import annotations

import statistics

from .profile import PAD_S


def program_spans(trace) -> list | None:
    """The port's spans of the requests of ``trace``'s measured window
    (``measured``), or None where the port has no tracer."""
    try:
        from yocto_raytracing_tpu_torch.utils import tracer
    except ImportError:
        return None
    return measured(tracer.spans(), trace.requests)


def measured(spans, requests: int) -> list:
    """The spans of the ``requests`` requests of the window traced on the
    device alone that ``profile.traced`` kept. It profiles in turn an
    unmeasured first window, that window (again with a longer pad where
    it lost events: the last attempt is kept), and a shorter window traced
    on the host too, whose host tracing slows the requests. Each window
    is padded with ``PAD_S`` of idle host time on either side, and the
    requests within one follow each other: the window kept holds the last
    ``requests`` requests before the last gap longer than ``PAD_S``
    between two requests (the last ``requests`` of all where there is no
    such gap)."""
    roots = [s for s in spans if s.parent is None]
    cut = len(roots)
    for i in range(len(roots) - 1, 0, -1):
        if roots[i].start_ns - roots[i - 1].end_ns > PAD_S * 1e9:
            cut = i
            break
    keep = {r.request for r in roots[max(cut - requests, 0):cut]}
    return [s for s in spans if s.request in keep]


def _ns(span) -> int:
    return span.end_ns - span.start_ns


def _roots(spans, name) -> list:
    return [s for s in spans or () if s.parent is None and s.name == name]


def _median_ms(values_ns) -> float | None:
    values_ns = list(values_ns)
    return statistics.median(values_ns) / 1e6 if values_ns else None


def root_ms(spans, root: str) -> float | None:
    """Median milliseconds of the requests whose root span is ``root``."""
    return _median_ms(_ns(r) for r in _roots(spans, root))


def self_ms(spans, root: str) -> float | None:
    """Median, over the requests whose root is ``root``, of the root's
    self time: its duration less its child spans' durations."""
    roots = _roots(spans, root)
    kids: dict = {}
    for s in spans or ():
        if s.parent is not None:
            kids[s.parent] = kids.get(s.parent, 0) + _ns(s)
    return _median_ms(_ns(r) - kids.get(r.id, 0) for r in roots)


def part_ms(spans, root: str, part: str) -> float | None:
    """Median, over the requests whose root is ``root``, of the summed
    milliseconds of their spans named ``part``."""
    roots = {r.id: 0 for r in _roots(spans, root)}
    for s in spans or ():
        if s.name == part and s.request in roots and s.parent is not None:
            roots[s.request] += _ns(s)
    return _median_ms(roots.values())


def miss_percent(spans, loop: str) -> float | None:
    """The share of the spans named ``loop`` whose ``hit`` attribute is 0,
    in %: device-loop calls that built their graph again."""
    calls = [s for s in spans or () if s.name == loop and "hit" in s.attrs]
    if not calls:
        return None
    return 100.0 * sum(s.attrs["hit"] == 0 for s in calls) / len(calls)
