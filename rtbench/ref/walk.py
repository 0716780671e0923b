"""The two-level BVH walk, plain torch: the benchmark's frozen copy.

Copied from yocto_raytracing_tpu_torch/ops/traverse.py at commit 2bec3df
(``_leaf_prims_hit``, ``intersect_scene_plain``), code unchanged but for
the identity frame, which takes the rays' dtype. The walk is threaded
with skip pointers; equal-t ties go to the last accepted hit; ``any_hit``
retires a ray after the leaf where it first hit. ``stats`` counts the work
a walk does for its rays: node visits, changes of frame, prim tests by
kind. It reads the leaves of ``ref.flat`` (any object with those
attributes).
"""

from __future__ import annotations

import torch

from .flat import PRIM_LINE, PRIM_TRIANGLE
from . import intersect as isect

# prim kinds in PRIM_* order (point, line, triangle), as ``stats`` counts them
PRIM_TESTS = ("point_tests", "line_tests", "triangle_tests")


def _leaf_prims_hit(scene, lo, ld, tmin, t_best, nstart, ncount, inst,
                    hit_inst, hit_prim, stats=None):
    """Test up to 4 prims of a shape leaf (forward order, last tie wins)."""
    got_hit = torch.zeros_like(tmin, dtype=torch.bool)
    for k in range(4):
        pk = k < ncount
        # masked lanes read slot 0 (a scene-leaf item) and use prim 0
        prim = torch.where(pk, scene.leaf_items[torch.where(pk, nstart + k, 0)],
                           0)
        pv = scene.prim_v[prim]
        ptype = scene.prim_type[prim]
        if stats is not None:
            for kind, name in enumerate(PRIM_TESTS):
                stats[name] += int((pk & (ptype == kind)).sum())
        v0 = scene.pos[pv[:, 0]]
        v1 = scene.pos[pv[:, 1]]
        v2 = scene.pos[pv[:, 2]]
        r0 = scene.radius[pv[:, 0]]
        r1 = scene.radius[pv[:, 1]]

        th, tt, _, _ = isect.intersect_triangle(lo, ld, tmin, t_best,
                                                v0, v1, v2)
        lh, lt, _ = isect.intersect_line(lo, ld, tmin, t_best, v0, v1,
                                         r0, r1)
        ph, pt = isect.intersect_point(lo, ld, tmin, t_best, v0, r0)

        is_tri = ptype == PRIM_TRIANGLE
        is_line = ptype == PRIM_LINE
        hit_k = torch.where(is_tri, th, torch.where(is_line, lh, ph)) & pk
        t_k = torch.where(is_tri, tt, torch.where(is_line, lt, pt))

        t_best = torch.where(hit_k, t_k, t_best)
        hit_inst = torch.where(hit_k, inst, hit_inst)
        hit_prim = torch.where(hit_k, prim, hit_prim)
        got_hit = got_hit | hit_k
    return t_best, hit_inst, hit_prim, got_hit


def intersect_scene_plain(scene, ro, rd, tmin, tmax,
                          any_hit: bool = False, stats=None) -> dict:
    """Plain torch hit query (the reference for K1) on any device.

    ro, rd (N, 3) f32 world rays; tmin, tmax (N,) f32. Returns dict with
    'hit' (N,) bool, 'inst' (N,) i32, 'prim' (N,) i32 (global prim id) and
    't' (N,) f32 (= tmax where nothing was hit).

    ``stats``, when given (a dict), gains the work that K1's walk does for
    these rays: ``nodes`` (node visits, one slab test each), ``frames``
    (changes of the ray's frame, into or out of an instance) and one count
    of prim tests per kind in ``PRIM_TESTS``.
    """
    if stats is not None:
        for key in ("nodes", "frames") + PRIM_TESTS:
            stats.setdefault(key, 0)
    n = ro.shape[0]
    dev = ro.device
    i32 = torch.int32
    node = torch.zeros(n, dtype=i32, device=dev)
    inst = torch.full((n,), -1, dtype=i32, device=dev)
    sleaf = torch.full((n,), -1, dtype=i32, device=dev)
    slot = torch.zeros(n, dtype=i32, device=dev)
    t = tmax.clone()
    hit_inst = torch.full((n,), -1, dtype=i32, device=dev)
    hit_prim = torch.full((n,), -1, dtype=i32, device=dev)
    ident = torch.eye(3, dtype=ro.dtype, device=dev)

    while True:
        idx = torch.nonzero(node >= 0).squeeze(1)
        if idx.numel() == 0:
            break
        nd = node[idx]
        ins = inst[idx]
        ro_l, rd_l, tmin_l, t_l = ro[idx], rd[idx], tmin[idx], t[idx]

        # instance-local ray (identity at scene level)
        has_inst = ins >= 0
        safe_inst = ins.clamp(min=0)
        axes = torch.where(has_inst[:, None, None],
                           scene.inst_axes[safe_inst], ident)
        io = torch.where(has_inst[:, None], scene.inst_o[safe_inst], 0.0)
        lo, ld = isect.transform_ray_inverse(axes, io, ro_l, rd_l)
        if stats is not None:
            stats["nodes"] += idx.numel()

        bhit = isect.intersect_bbox(lo, ld, tmin_l, t_l,
                                    scene.node_bbox_min[nd],
                                    scene.node_bbox_max[nd])
        nstart = scene.node_start[nd]
        nleaf = scene.node_isleaf[nd] == 1
        nkind = scene.node_kind[nd]
        nskip = scene.node_skip[nd]

        # shape leaf: only the rays that reached one test prims
        hi_l, hp_l = hit_inst[idx], hit_prim[idx]
        got_hit = torch.zeros_like(bhit)
        pl = torch.nonzero(bhit & nleaf & (nkind == 1)).squeeze(1)
        if pl.numel():
            t_pl, hi_pl, hp_pl, got_pl = _leaf_prims_hit(
                scene, lo[pl], ld[pl], tmin_l[pl], t_l[pl], nstart[pl],
                scene.node_count[nd[pl]], ins[pl], hi_l[pl], hp_l[pl],
                stats)
            t_l[pl] = t_pl
            hi_l[pl] = hi_pl
            hp_l[pl] = hp_pl
            got_hit[pl] = got_pl

        # next node: internal hit -> second child; scene-leaf hit -> first
        # instance's shape root; else the skip pointer
        scene_enter = bhit & nleaf & (nkind == 0)
        item0 = scene.leaf_items[torch.where(scene_enter, nstart, 0)]
        root0 = scene.inst_shape_root[torch.where(scene_enter, item0, 0)]
        descend = bhit & ~nleaf
        nxt = torch.where(descend, nstart + 1,
                          torch.where(scene_enter, root0, nskip))
        new_inst = torch.where(scene_enter, item0, ins)
        new_sleaf = torch.where(scene_enter, nd, sleaf[idx])
        new_slot = torch.where(scene_enter, 0, slot[idx])

        # shape tree exhausted inside an instance: the scene leaf's next
        # instance, else resume at the scene leaf's skip pointer
        exhausted = (nxt < 0) & (new_inst >= 0)
        sleaf_s = new_sleaf.clamp(min=0)
        next_slot = new_slot + 1
        more = exhausted & (next_slot < scene.node_count[sleaf_s])
        item_n = scene.leaf_items[torch.where(
            more, scene.node_start[sleaf_s] + next_slot, 0)]
        root_n = scene.inst_shape_root[torch.where(more, item_n, 0)]
        nxt = torch.where(more, root_n,
                          torch.where(exhausted, scene.node_skip[sleaf_s],
                                      nxt))
        new_inst = torch.where(more, item_n,
                               torch.where(exhausted, -1, new_inst))
        new_slot = torch.where(more, next_slot, new_slot)
        new_sleaf = torch.where(exhausted & ~more, -1, new_sleaf)
        if any_hit:
            nxt = torch.where(got_hit, -1, nxt)
        if stats is not None:
            stats["frames"] += int(((new_inst != ins) & (nxt >= 0)).sum())

        node[idx] = nxt.to(i32)
        inst[idx] = new_inst.to(i32)
        sleaf[idx] = new_sleaf.to(i32)
        slot[idx] = new_slot.to(i32)
        t[idx] = t_l
        hit_inst[idx] = hi_l
        hit_prim[idx] = hp_l

    return dict(hit=hit_prim >= 0, inst=hit_inst, prim=hit_prim, t=t)


