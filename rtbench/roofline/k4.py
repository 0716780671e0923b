"""K4, a bounce's shading (``kernels/csrc/shade.cu``, prep and finish):
its work and its bound.

Per lane that shades a hit (``chip_smoke.py`` at commit 2bec3df,
PERF.md's K4 bound): ro, rd, inst, prim and the mask in, color, kr, p and
the mirror ray out (81 bytes), and 360 operations (counted from the
kernel's source); per lane that does not, its mask byte alone, which is
all such a lane needs; and the shading leaves once a request. The lanes
are those of every live bounce's launch (the program's record of the
bounces that ran), the hits counted by the benchmark's plain walk on its
sample.
"""

from __future__ import annotations

from . import peaks

FUNCTIONS = ("shade_prep_kernel", "shade_finish_kernel")
OPS_PER_HIT = 360
LANE_BYTES = 24 + 8 + 1 + 48


def work(trace) -> tuple:
    """(operations, bytes) of the traced requests' shading launches: the
    trace's ``shade_lanes`` (lanes of live bounces' launches),
    ``hit_counts`` (the nearest queries' hits) and
    ``shade_leaves_bytes``."""
    hits = trace.get("hit_counts")["nearest"]["hits"]
    return (OPS_PER_HIT * hits,
            trace.get("shade_lanes") + (LANE_BYTES - 1) * hits
            + trace.get("shade_leaves_bytes"))


def share(trace) -> float | None:
    ops, nbytes = work(trace)
    return peaks.share_percent(trace.device_kind, ops, nbytes,
                               trace.profile.kernel_s(FUNCTIONS))
