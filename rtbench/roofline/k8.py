"""K8, the area lights' sample points (``kernels/csrc/lights.cu``): its
work and its bound.

Counted from lights.cu and common.cuh at commit ad7840c (a square root or
a conversion counts as one operation), per primary ray and per (light,
ray), whatever the implementation:

* per ray, its three variates ``pcg(id ^ h_k)``: the xor, a hash of 9
  operations, the top 24 bits converted and scaled, 13 each, 39 (the
  seed's own hashes h_k are the launch's, not the ray's);
* per (light, ray): the pick's target r0 * total, 1; the search for the
  element, a compare and a select for each of ceil(log2 n) halvings of
  the light's n elements and a last compare and add, 2 ceil(log2 n) + 2;
  the prim, a min, an add and two clamps, 4; the point, 20 on a triangle
  (the square root, a = 1 - sq, b = r2 sq, w0 = 1 - a - b, nine products
  and six sums), 10 on a line (1 - r1, six products, three sums), none on
  a point, weighted by the odds of the CDF's pick; a light with no element
  keeps its place and counts none of these.

Bytes: the ray id in (4) and one point out on each light (12), and the
light tables once a frame (negligible). At 28 bytes and 89 operations a
ray on the area hair scene's two lights K8 is bound by memory: 4.38 us a
524,288-ray chunk, the kernel table's bound (PERF.md).
"""

from __future__ import annotations

import math

import numpy as np

from . import peaks

FUNCTIONS = ("light_points_kernel",)
PRIM_LINE, PRIM_TRIANGLE = 1, 2
OPS_PER_RAY = 3 * 13
POINT_OPS = {PRIM_TRIANGLE: 20, PRIM_LINE: 10}
RAY_BYTES, POINT_BYTES = 4, 12


def ops_per_light_ray(tables) -> list:
    """The operations of each light's point for one ray, from the light
    tables (``cdf`` (L, E), ``n``, ``prim_lo``, ``deg`` and the scene's
    ``prim_type``, arrays or tensors)."""
    cdf = np.asarray(tables["cdf"], np.float64)
    out = []
    for l in range(cdf.shape[0]):
        if bool(tables["deg"][l]):
            out.append(0.0)
            continue
        n = int(tables["n"][l])
        lo = int(tables["prim_lo"][l])
        w = np.diff(cdf[l, :n], prepend=0.0)
        kinds = np.asarray(tables["prim_type"])[lo:lo + n]
        point = sum(wi * POINT_OPS.get(int(k), 0)
                    for wi, k in zip(w, kinds)) / cdf[l, n - 1]
        out.append(1 + 2 * math.ceil(math.log2(n)) + 2 + 4 + point)
    return out


def work(trace) -> tuple:
    """(operations, bytes) of the traced requests' light points: the
    trace's ``light_rays`` (every primary ray of every traced frame) over
    the lights of its ``light_tables``."""
    tables = trace.get("light_tables")
    rays = trace.get("light_rays") or 0
    if not tables or not rays:
        return 0, 0
    per = ops_per_light_ray(tables)
    return (rays * (OPS_PER_RAY + sum(per)),
            rays * (RAY_BYTES + POINT_BYTES * len(per)))


def share(trace) -> float | None:
    ops, nbytes = work(trace)
    return peaks.share_percent(trace.device_kind, ops, nbytes,
                               trace.profile.kernel_s(FUNCTIONS))
