"""One run of one cell: its driver, its metrics, its result line.

A driver (``rtbench/drive/<kind>.py``) has ``run(cell, seed, seconds,
trace, device, t_start, sizes) -> Outcome``: it makes the inputs from the
seed, sets up and warms up, measures the window, and decides ``correct``
by comparing what the window produced with the plain reference; with
``trace`` it also profiles a window of requests and fills a ``TraceData``
for the per-layer readers. ``sizes`` overrides numbers of the
configuration and the mix (the tests' small runs on the CPU); a measured
run passes none.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from . import spec


@dataclass
class Outcome:
    metrics: dict             # end-to-end metric name -> value
    attempted: int
    failed: int
    compared: dict            # number -> (value, limit)
    memory_peak_bytes: int
    trace: object = None      # TraceData of the traced window, or None
    notes: dict = field(default_factory=dict)


def correct(compared: dict) -> bool:
    """Every number at or below its limit (a NaN is above any)."""
    return all(not math.isnan(v) and v <= lim
               for v, lim in compared.values())


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device, t_start: float, sizes: dict | None = None) -> Outcome:
    return cell.driver().run(cell, seed, seconds, trace, device, t_start,
                             sizes or {})


def result(cell: spec.Cell, out: Outcome, trace: bool, device_info: dict
           ) -> dict:
    """The result line's object: the cell's end-to-end metrics, or with
    ``trace`` its per-layer metrics (a reader that finds nothing leaves
    its metric out), and the numbers compared, last."""
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"]).read(out.trace)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": out.metrics[m["name"]],
                                  "unit": m["unit"]}
    device = dict(device_info, memory_peak_bytes=out.memory_peak_bytes)
    line = {"correct": correct(out.compared), "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": device}
    if trace:
        p = out.trace.profile
        device.update(busy_s=p.busy_s, window_s=p.window_s)
        line["breakdown"] = {"device_ops": p.device_ops,
                             "idle_gaps": p.idle_gaps}
    line["compared"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in out.compared.items()}
    return line
