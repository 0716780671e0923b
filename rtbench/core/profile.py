"""The traced window: ``torch.profiler`` over a run of requests.

The metrics come from a window traced on the device alone
(``ProfilerActivity.CUDA``): tracing the host's operators as well slows a
request whose host path is many small operators (a training step ran at
twice its time), and the device's idle share would read the tracer's
cost. From it: the device's busy seconds (the union of its operations'
intervals), the window's seconds (the host clock around the requests,
which end in a synchronize), each device function's summed seconds and
its launches, and the top device operations. A second, shorter window,
traced on the host too, only names the longest idle gaps by what the host
was doing (``breakdown``).

The padding and the retries follow ``chip_smoke.py::profile_summary``
(the repository's root, commit 2bec3df): the profiled window is padded
with idle host time on each side, so that device events whose converted
timestamps land just outside the requests still fall inside the trace. A
trace that holds fewer launches of a device function than the requests
made (``expect``) lost events: the window is profiled again with a longer
pad, at most ``ATTEMPTS`` times, and if the launches are still missing
the run fails. No share is printed that was not measured.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

PAD_S = 0.05
PAD_GROWTH = 4
PAD_MAX_S = 3.2
ATTEMPTS = 6
TOP = 10            # entries of each breakdown list
GAPS_NAMED = 400    # the longest idle gaps named by the host's activity
WARM_REQUESTS = 2   # requests of the tracer's unmeasured first session


@dataclass
class Profile:
    busy_s: float
    window_s: float
    by_name: dict                 # device op name -> seconds
    launches: dict                # device op name -> events
    device_ops: list              # [[name, seconds]], the top TOP
    idle_gaps: list = field(default_factory=list)  # [[host activity, s]]
    records: list = field(default_factory=list)   # what the window returned

    def kernel_s(self, functions) -> float:
        """Summed device seconds of the device functions ``functions``
        (the profiler names them ``yrt::<function>(<arguments>)``)."""
        prefixes = tuple(f"yrt::{fn}(" for fn in functions)
        return sum(s for name, s in self.by_name.items()
                   if name.startswith(prefixes))

    def kernel_launches(self, function: str) -> int:
        return sum(n for name, n in self.launches.items()
                   if name.startswith(f"yrt::{function}("))


def _union(intervals: np.ndarray) -> np.ndarray:
    """Merged (start, end) intervals, sorted."""
    iv = intervals[intervals[:, 1] > intervals[:, 0]]
    if not len(iv):
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0])]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out)


def _window(run_window, count: int, host: bool, pad: float):
    """One profiled window of ``count`` requests: (profiler, records,
    host-clock seconds)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        time.sleep(pad)
        t0 = time.perf_counter()
        records = run_window(count)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        time.sleep(pad)
    return prof, records, seconds


def _device_events(prof):
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def _name_gaps(prof) -> list:
    """The idle gaps between the device's operations, each named by the
    innermost host event that spans its middle (the shortest one), summed
    by name: [[name, seconds]], largest first."""
    from torch.autograd import DeviceType

    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    host = [e for e in events if e.device_type == DeviceType.CPU]
    if not dev or not host:
        return []
    busy = _union(np.array([[e.time_range.start, e.time_range.end]
                            for e in dev], np.float64))
    gaps = np.stack([busy[:-1, 1], busy[1:, 0]], 1)
    starts = np.array([e.time_range.start for e in host], np.float64)
    ends = np.array([e.time_range.end for e in host], np.float64)
    dur = ends - starts
    out: dict = {}
    for g in gaps[np.argsort(gaps[:, 0] - gaps[:, 1])[:GAPS_NAMED]]:
        mid = 0.5 * (g[0] + g[1])
        cover = np.nonzero((starts <= mid) & (ends >= mid))[0]
        name = (host[cover[np.argmin(dur[cover])]].name if len(cover)
                else "host: no traced operator (Python)")
        out[name] = out.get(name, 0.0) + (g[1] - g[0]) / 1e6
    return sorted(([k, v] for k, v in out.items()), key=lambda kv: -kv[1])


def traced(run_window, count: int, expect, name_count: int) -> Profile:
    """Profile ``run_window(count)`` (it runs ``count`` requests and
    returns their records) on the device; ``expect(records)`` gives the
    launches of device functions that the requests made, each of which
    the trace must hold. Then ``run_window(name_count)`` traced on the host
    too names the idle gaps. A first, unmeasured window of
    ``WARM_REQUESTS`` starts the tracer, whose first session costs tens of
    milliseconds that would read as idle device time."""
    _window(run_window, WARM_REQUESTS, False, PAD_S)
    for attempt in range(1, ATTEMPTS + 1):
        pad = min(PAD_S * PAD_GROWTH ** (attempt - 1), PAD_MAX_S)
        prof, records, seconds = _window(run_window, count, False, pad)
        dev = _device_events(prof)
        by_name: dict = {}
        launches: dict = {}
        for e in dev:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e6)
            launches[e.name] = launches.get(e.name, 0) + 1
        got = Profile(0.0, seconds, by_name, launches, [])
        lost = {fn: (got.kernel_launches(fn), n)
                for fn, n in expect(records).items()
                if got.kernel_launches(fn) != n}
        if dev and not lost:
            break
        print(f"rtbench: trace attempt {attempt} of {ATTEMPTS} (pad {pad} "
              f"s): launches traced / made {lost or 'no device event'}",
              file=sys.stderr, flush=True)
    else:
        raise RuntimeError(f"the trace lost device events in {ATTEMPTS} "
                           f"attempts: launches traced / made {lost}")
    busy = _union(np.array([[e.time_range.start, e.time_range.end]
                            for e in dev], np.float64))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    named, _, _ = _window(run_window, name_count, True, PAD_S)
    return Profile(
        busy_s=float((busy[:, 1] - busy[:, 0]).sum() / 1e6),
        window_s=seconds, by_name=by_name, launches=launches,
        device_ops=[[n, s] for n, s in top],
        idle_gaps=_name_gaps(named)[:TOP], records=records)
