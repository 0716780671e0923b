"""Brute-force scene intersection: the correctness oracle for the BVH walk.

Port of ``yocto_raytracing_tpu/ops/brute.py``. The reference keeps its own
linear-scan oracle (intersect_ray, src/scene.cpp:311-367) that the BVH path
superseded; the tests hold ``traverse.intersect_scene_plain`` to this one on
random rays. Every (ray, instance-prim pair) is tested at once: O(N * Q)
memory, so small scenes and small batches only. Plain torch on any device;
it has no kernel.
"""

from __future__ import annotations

import torch

from ..scene import PRIM_LINE, PRIM_TRIANGLE
from . import intersect as isect
from .overlap import instance_prim_ranges

FLT_MAX = isect.FLT_MAX


def _pairs(scene, meta):
    """All (instance, prim) candidate pairs as two (Q,) i64 tensors."""
    lo, hi = instance_prim_ranges(scene, meta)
    pi, pp = [], []
    for ii, (a, b) in enumerate(zip(lo.tolist(), hi.tolist())):
        pp.extend(range(a, b))
        pi.extend([ii] * (b - a))
    dev = scene.inst_shape_root.device
    return (torch.tensor(pi, dtype=torch.int64, device=dev),
            torch.tensor(pp, dtype=torch.int64, device=dev))


def intersect_scene_brute(scene, meta, ro, rd, tmin, tmax) -> dict:
    """Nearest hit by testing every (instance, prim) pair at once.

    Same contract as ``traverse.intersect_scene_plain``. Tie semantics
    differ from the sequential walk: here the highest pair index wins among
    equal t, which is the walk's order for instances scanned in order.
    """
    pair_inst, pair_prim = _pairs(scene, meta)
    axes = scene.inst_axes[pair_inst]          # (Q, 3, 3)
    io = scene.inst_o[pair_inst]               # (Q, 3)
    pv = scene.prim_v[pair_prim]               # (Q, 3)
    ptype = scene.prim_type[pair_prim]         # (Q,)
    v0 = scene.pos[pv[:, 0]]
    v1 = scene.pos[pv[:, 1]]
    v2 = scene.pos[pv[:, 2]]
    r0 = scene.radius[pv[:, 0]]
    r1 = scene.radius[pv[:, 1]]

    # rays (N, 1, 3) against pairs (1, Q, ...)
    lo, ld = isect.transform_ray_inverse(axes[None], io[None],
                                         ro[:, None, :], rd[:, None, :])
    tmin_b = tmin[:, None]
    tmax_b = tmax[:, None]
    th, tt, _, _ = isect.intersect_triangle(lo, ld, tmin_b, tmax_b, v0[None],
                                            v1[None], v2[None])
    lh, lt, _ = isect.intersect_line(lo, ld, tmin_b, tmax_b, v0[None],
                                     v1[None], r0[None], r1[None])
    ph, pt = isect.intersect_point(lo, ld, tmin_b, tmax_b, v0[None],
                                   r0[None])
    is_tri = ptype == PRIM_TRIANGLE
    is_line = ptype == PRIM_LINE
    hit = torch.where(is_tri, th, torch.where(is_line, lh, ph))
    t = torch.where(hit, torch.where(is_tri, tt, torch.where(is_line, lt, pt)),
                    FLT_MAX)

    # nearest with the last equal t winning: argmin over the flipped pairs
    q = t.shape[1]
    best = q - 1 - torch.argmin(t.flip(1), dim=1)
    best_t = t.gather(1, best[:, None])[:, 0]
    any_hit = hit.any(dim=1)
    i32 = torch.int32
    return dict(hit=any_hit,
                inst=torch.where(any_hit, pair_inst[best].to(i32), -1),
                prim=torch.where(any_hit, pair_prim[best].to(i32), -1),
                t=torch.where(any_hit, best_t, tmax))
