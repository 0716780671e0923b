"""K1, the hit query (``kernels/csrc/hit.cu``): its work and its bound.

Operations per unit of the walk's work, counted from hit.cu and
common.cuh (``chip_smoke.py::HIT_OPS`` at commit 2bec3df): a node visit
(the slab test, 43, and the next-node choice, 10), a change of the ray's
frame, and a prim test of each kind. The units are counted by the
benchmark's own plain walk (``rtbench/ref/walk.py``) on its own BVH, on a
sample of the traced requests' live query lanes (a dead lane asks for no
test), so any implementation of the query is held against the same work.
Bytes: each live lane's ray, tmin and tmax in and its hit, instance, prim
and t out once, and the scene's hit leaves once a request.
"""

from __future__ import annotations

from . import peaks

FUNCTIONS = ("hit_nearest_kernel", "hit_any_kernel")
HIT_OPS = {"nodes": 53, "frames": 47, "point_tests": 35, "line_tests": 80,
           "triangle_tests": 65}
LANE_BYTES = 24 + 8 + 13     # ro, rd; tmin, tmax; hit, inst, prim, t


def work(trace) -> tuple:
    """(operations, bytes) of the traced requests' hit queries, from the
    trace's ``hit_counts`` (per query kind, scaled to every request) and
    ``hit_leaves_bytes``."""
    counts = trace.get("hit_counts")
    ops = sum(HIT_OPS[k] * c[k] for c in counts.values() for k in HIT_OPS)
    lanes = sum(c["rays"] for c in counts.values())
    return ops, LANE_BYTES * lanes + trace.get("hit_leaves_bytes")


def share(trace) -> float | None:
    ops, nbytes = work(trace)
    return peaks.share_percent(trace.device_kind, ops, nbytes,
                               trace.profile.kernel_s(FUNCTIONS))
