"""K7, the stochastic camera rays (``kernels/csrc/stochastic.cu``): its work
and its bound.

Per primary ray, counted from stochastic.cu and common.cuh at commit
ad7840c (a divide, a square root, a conversion and each of sin and cos
count as one operation), whatever the implementation:

* the four variates, jitter (2) and lens (2): each ``pcg(id ^ pcg(seed +
  k))`` (the seed's add, two hashes of 9 operations, the xor), the top 24
  bits converted and scaled, 23 operations; the lens seed's xor, 2;
* the ray id's pixel, sample, row and column: three quotients (a
  multiply-high and two shifts) and three remainders (a multiply and a
  subtract), 15;
* the jittered uv: 8 for u, 7 for v;
* the lens sample on the unit disk: a square root, 2 pi r0, sin and cos,
  two products, 6;
* the camera frame: y = -axes[1] and aperture / 2, 4;
* the thin-lens ray: the pinhole target q, 22; the origin on the lens,
  15; d = q - origin, 3; its length, 6; rd = d / |d|, 3.

Bytes: the ray id in, the uv, origin and direction out (4 + 8 + 12 + 12),
and the camera's leaves once a frame (negligible: 64 bytes). At 36 bytes
and 183 operations a ray K7 is bound by memory: 5.63 us a 524,288-ray
chunk, the kernel table's bound (PERF.md).
"""

from __future__ import annotations

from . import peaks

FUNCTIONS = ("camera_rays_stochastic_kernel",)
OPS = {"variates": 4 * 23 + 2, "divisions": 15, "uv": 15, "disk": 6,
       "frame": 4, "ray": 22 + 15 + 3 + 6 + 3}
OPS_PER_RAY = sum(OPS.values())
RAY_BYTES = 4 + 8 + 12 + 12


def work(trace) -> tuple:
    """(operations, bytes) of the traced requests' stochastic camera rays:
    the trace's ``camera_rays``, every primary ray of every traced frame
    (not the lanes past the last pixel that the last chunk repeats)."""
    rays = trace.get("camera_rays") or 0
    return OPS_PER_RAY * rays, RAY_BYTES * rays


def share(trace) -> float | None:
    ops, nbytes = work(trace)
    return peaks.share_percent(trace.device_kind, ops, nbytes,
                               trace.profile.kernel_s(FUNCTIONS))
