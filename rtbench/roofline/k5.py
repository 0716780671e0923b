"""K5, a bounce's shading reverse (``kernels/csrc/shade_bwd.cu``): its
work and its bound.

Per lane that shades a hit (``chip_smoke.py`` at commit 2bec3df,
PERF.md's K5 bound): the saved ray, hit topology, mask and the cotangents
in, the ray's cotangents out (105 bytes), and 1,100 operations (counted
from the kernel's source); per lane that does not, its mask byte alone;
and the shading leaves and their gradient sums once a request. The lanes
are those of every live bounce's reverse (the program's record), the
hits counted by the benchmark's plain walk on its sample.
"""

from __future__ import annotations

from . import peaks

FUNCTIONS = ("shade_bwd_kernel", "light_sum_kernel")
OPS_PER_HIT = 1100
LANE_BYTES = 24 + 8 + 1 + 48 + 24


def work(trace) -> tuple:
    """(operations, bytes) of the traced steps' reverse shading: the
    trace's ``shade_lanes``, ``hit_counts`` and ``shade_leaves_bytes``
    (twice: the leaves read and their gradients written)."""
    hits = trace.get("hit_counts")["nearest"]["hits"]
    return (OPS_PER_HIT * hits,
            trace.get("shade_lanes") + (LANE_BYTES - 1) * hits
            + 2 * trace.get("shade_leaves_bytes"))


def share(trace) -> float | None:
    ops, nbytes = work(trace)
    return peaks.share_percent(trace.device_kind, ops, nbytes,
                               trace.profile.kernel_s(FUNCTIONS))
