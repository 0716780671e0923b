"""K11, the closest-element query (``kernels/csrc/overlap.cu``), with the
refit of its records on every call: their work and their bound.

Operations per unit of the culled walk's work, counted from overlap.cu
(``chip_smoke.py::WALK_OPS`` and ``OVERLAP_OPS_PER_INSTANCE`` at commit
2bec3df): a node visit, a prim test of each kind, and the move of a query
into each instance's frame. The units are counted by the benchmark's own
plain walk (``rtbench/ref/overlap.py``, on records it refits itself) on
a sample of the traced calls' queries. Bytes: each query's point and
``dist_max`` in and found, dist, inst, prim and euv out once, and the
records and instance frames once a call; the refit reads the leaves and
writes the records once a call.
"""

from __future__ import annotations

from . import peaks

FUNCTIONS = ("overlap_kernel", "overlap_parent_kernel",
             "overlap_refit_kernel")
WALK_OPS = {"nodes": 50, "point_tests": 25, "line_tests": 60,
            "triangle_tests": 110}
OPS_PER_INSTANCE = 20
QUERY_BYTES = 16 + 29


def work(trace) -> tuple:
    """(operations, bytes) of the traced calls: the trace's
    ``walk_counts`` (scaled to every query), ``queries``, ``instances``
    and ``call_bytes`` (the records, frames and refit traffic of every
    call)."""
    counts = trace.get("walk_counts")
    ops = (OPS_PER_INSTANCE * trace.get("instances") * trace.get("queries")
           + sum(WALK_OPS[k] * counts[k] for k in WALK_OPS))
    return ops, QUERY_BYTES * trace.get("queries") + trace.get("call_bytes")


def share(trace) -> float | None:
    ops, nbytes = work(trace)
    return peaks.share_percent(trace.device_kind, ops, nbytes,
                               trace.profile.kernel_s(FUNCTIONS))
