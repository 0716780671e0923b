"""What a traced window hands to the per-layer metrics' readers.

A driver fills one ``TraceData`` per traced window: the profile, the card's
name, the number of requests, and a table of quantities that readers ask
for by name (``get``). A quantity that costs work to find (the plain
walk's counts on a sample of the window's rays) is a function, run on the
first ``get`` and kept, so a reader pays only for what it reads. A reader
that asks for a quantity this kind of traffic does not have gets None.
"""

from __future__ import annotations


class TraceData:
    def __init__(self, profile, device_kind: str, requests: int,
                 quantities: dict):
        self.profile = profile
        self.device_kind = device_kind
        self.requests = requests
        self._quantities = quantities
        self._known: dict = {}

    def get(self, name: str):
        if name not in self._known:
            q = self._quantities.get(name)
            self._known[name] = q() if callable(q) else q
        return self._known[name]


def mean(values) -> float | None:
    values = list(values or ())
    return sum(values) / len(values) if values else None


def idle_percent(trace) -> float:
    """100 x (1 - the device's busy seconds / the traced window's)."""
    p = trace.profile
    return 100.0 * (1.0 - p.busy_s / p.window_s)


def mfu_percent(trace, modules) -> float | None:
    """The operations that the roofline ``modules`` count for the traced
    window, as a percentage of what the card's float32 peak does in the
    window's seconds: the whole request's share of the chip's peak."""
    from rtbench.roofline import peaks

    ops = sum(m.work(trace)[0] for m in modules)
    if ops <= 0:
        return None
    rate = peaks.peak(trace.device_kind)["f32_ops_per_s"]
    return 100.0 * ops / (rate * trace.profile.window_s)
