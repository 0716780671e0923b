"""Point-overlap / closest-point queries: plain torch and the K11 CUDA kernel.

Port of ``yocto_raytracing_tpu/ops/overlap.py``: the ym overlap API
(src/ext/yocto_math.h:5836-6017) and its scene-level wrapper
(src/ext/yocto_scn.cpp:1920-1985). Given query points, find the closest
scene element within ``dist_max`` (plus the element's radius) and its
element uv. The render path never calls it; it serves geometry tooling
(collision proxies, closest-surface projection).

Every helper repeats the JAX function's operations in its order (explicit
dots, the ``safe`` 0 -> 1 divisors, ``safe_sqrt``), so the plain versions
are bit-equal to JAX run op by op. Distances are instance-local, like the
reference's.

Two forms of the scene query give the same answers bit for bit:

* ``overlap_scene_plain``, the brute force: every prim of every instance,
  JAX's work; the oracle;
* the culled walk: per instance, each query walks the instance's shape
  BVH and skips a subtree that cannot hold the answer (the bound and its
  slack: ``kernels/csrc/overlap.cu``'s header), on records refit from the
  current ``pos`` and ``radius`` (``refit``).

``overlap_scene`` runs the walk: ``overlap_scene_walk_plain`` for CPU
tensors; for CUDA tensors the refit kernel and K11 (one thread per query),
with no host synchronisation.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..kernels import _build
from ..scene import PRIM_LINE, PRIM_POINT, PRIM_TRIANGLE
from . import intersect as isect

FLT_MAX = isect.FLT_MAX
# (query, prim) pairs per dense block of the plain scene query
PAIRS_PER_BLOCK = 1 << 22


def _safe(x):
    return torch.where(x == 0, 1.0, x)


def closestuv_line(pos, v0, v1):
    """Closest point on a segment, as (1-u, u) (yocto_math.h:5846-5855)."""
    ab = v1 - v0
    d = isect.dot(ab, ab)
    u = isect.dot(pos - v0, ab) / _safe(d)
    u = torch.clamp(u, 0.0, 1.0)
    return torch.stack([1.0 - u, u], dim=-1)


def closestuv_triangle(pos, v0, v1, v2):
    """Closest point on a triangle, barycentric (w0, w1, w2)
    (yocto_math.h:5877-5915): the corner / edge / face case cascade with the
    reference's priority, the first true case winning."""
    ab = v1 - v0
    ac = v2 - v0
    ap = pos - v0
    d1 = isect.dot(ab, ap)
    d2 = isect.dot(ac, ap)
    bp = pos - v1
    d3 = isect.dot(ab, bp)
    d4 = isect.dot(ac, bp)
    cp = pos - v2
    d5 = isect.dot(ab, cp)
    d6 = isect.dot(ac, cp)
    vc = d1 * d4 - d3 * d2
    vb = d5 * d2 - d1 * d6
    va = d3 * d6 - d5 * d4

    t_ab = d1 / _safe(d1 - d3)
    t_ac = d2 / _safe(d2 - d6)
    w_bc = (d4 - d3) / _safe((d4 - d3) + (d5 - d6))
    denom = torch.reciprocal(_safe(va + vb + vc))
    fv = vb * denom
    fw = vc * denom

    conds = [
        (d1 <= 0) & (d2 <= 0),
        (d3 >= 0) & (d4 <= d3),
        (vc <= 0) & (d1 >= 0) & (d3 <= 0),
        (d6 >= 0) & (d5 <= d6),
        (vb <= 0) & (d2 >= 0) & (d6 <= 0),
        (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0),
    ]
    zeros = torch.zeros_like(t_ab)
    ones = torch.ones_like(t_ab)
    cases = [
        (ones, zeros, zeros),
        (zeros, ones, zeros),
        (1.0 - t_ab, t_ab, zeros),
        (zeros, zeros, ones),
        (1.0 - t_ac, zeros, t_ac),
        (zeros, 1.0 - w_bc, w_bc),
    ]
    uvw = (1.0 - fv - fw, fv, fw)  # face case (fall-through)
    for cond, case in zip(reversed(conds), reversed(cases)):
        uvw = tuple(torch.where(cond, c, u) for c, u in zip(case, uvw))
    return torch.stack(uvw, dim=-1)


def _accept(d, dist_max, r):
    d2 = isect.dot(d, d)
    ok = d2 <= (dist_max + r) * (dist_max + r)
    return ok, torch.where(ok, isect.safe_sqrt(d2), FLT_MAX)


def overlap_point(pos, dist_max, p, r):
    """Point-vs-point (yocto_math.h:5836-5842). Returns (ok, dist)."""
    return _accept(pos - p, dist_max, r)


def overlap_line(pos, dist_max, v0, v1, r0, r1):
    """Point-vs-capsule-segment (yocto_math.h:5858-5871).
    Returns (ok, dist, euv (..., 2))."""
    uv = closestuv_line(pos, v0, v1)
    u = uv[..., 1:2]
    p = v0 * (1.0 - u) + v1 * u
    r = r0 * (1.0 - uv[..., 1]) + r1 * uv[..., 1]
    return (*_accept(pos - p, dist_max, r), uv)


def overlap_triangle(pos, dist_max, v0, v1, v2, r0, r1, r2):
    """Point-vs-triangle-with-vertex-radii (yocto_math.h:5918-5929).
    Returns (ok, dist, euv (..., 3))."""
    uv = closestuv_triangle(pos, v0, v1, v2)
    p = v0 * uv[..., 0:1] + v1 * uv[..., 1:2] + v2 * uv[..., 2:3]
    r = r0 * uv[..., 0] + r1 * uv[..., 1] + r2 * uv[..., 2]
    return (*_accept(pos - p, dist_max, r), uv)


def overlap_quad(pos, dist_max, v0, v1, v2, v3, r0, r1, r2, r3):
    """Point-vs-quad as two triangles with the reference's sequential
    dist_max shrink and euv remap (yocto_math.h:5932-5950).
    Returns (ok, dist, euv (..., 4))."""
    ok1, d1, uv1 = overlap_triangle(pos, dist_max, v0, v1, v3, r0, r1, r3)
    e1 = torch.cat([uv1[..., 0:1], uv1[..., 1:2],
                    torch.zeros_like(uv1[..., 0:1]), uv1[..., 2:3]], dim=-1)
    cap = torch.where(ok1, d1, dist_max)
    ok2, d2, uv2 = overlap_triangle(pos, cap, v2, v3, v1, r2, r3, r1)
    y = uv2[..., 1]
    z = uv2[..., 2]
    e2 = torch.stack([torch.zeros_like(y), 1.0 - y, y + z - 1.0, 1.0 - z],
                     dim=-1)
    ok = ok1 | ok2
    dist = torch.where(ok2, d2, d1)
    euv = torch.where(ok2[..., None], e2, e1)
    return ok, torch.where(ok, dist, FLT_MAX), euv


def overlap_tetrahedron(pos, dist_max, v0, v1, v2, v3, r0, r1, r2, r3):
    """Point-vs-tetrahedron surface: interior -> dist 0, else the nearest
    of the four faces with the sequential dist_max shrink
    (yocto_math.h:5969-6001). The interior test uses the signed-volume
    barycentrics the reference intended (its own computes the same
    expression for u, v and w), as the JAX function does. Returns
    (ok, dist)."""
    vol = isect.dot(v3 - v0, isect.cross(v1 - v0, v2 - v0))
    sv = _safe(vol)
    u = isect.dot(v3 - pos, isect.cross(v1 - pos, v2 - pos)) / sv
    v = isect.dot(v3 - pos, isect.cross(v2 - pos, v0 - pos)) / sv
    w = isect.dot(v3 - pos, isect.cross(v0 - pos, v1 - pos)) / sv
    s = u + v + w
    inside = ((vol != 0) & (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1)
              & (w >= 0) & (w <= 1) & (s <= 1))

    ok = torch.zeros(u.shape, dtype=torch.bool, device=u.device)
    dist = torch.broadcast_to(torch.as_tensor(dist_max, dtype=torch.float32,
                                              device=u.device), ok.shape)
    found_dist = torch.full(ok.shape, FLT_MAX, dtype=torch.float32,
                            device=u.device)
    for (a, b, c, ra, rb, rc) in ((v0, v1, v2, r0, r1, r2),
                                  (v0, v1, v3, r0, r1, r3),
                                  (v0, v2, v3, r0, r2, r3),
                                  (v1, v2, v3, r1, r2, r3)):
        okf, df, _ = overlap_triangle(pos, dist, a, b, c, ra, rb, rc)
        ok = ok | okf
        dist = torch.where(okf, df, dist)
        found_dist = torch.where(okf, df, found_dist)
    ok = ok | inside
    found_dist = torch.where(inside, 0.0, found_dist)
    return ok, torch.where(ok, found_dist, FLT_MAX)


def distance_check_bbox(pos, dist_max, bmin, bmax):
    """Point-to-bbox distance test (yocto_math.h:6004-6017)."""
    lo = torch.clamp(bmin - pos, min=0.0)
    hi = torch.clamp(pos - bmax, min=0.0)
    dd = isect.dot(lo, lo) + isect.dot(hi, hi)
    return dd < dist_max * dist_max


def overlap_bbox(b1_min, b1_max, b2_min, b2_max):
    """Bbox-vs-bbox overlap (yocto_math.h:6020-6026)."""
    return torch.all((b1_max >= b2_min) & (b1_min <= b2_max), dim=-1)


# --------------------------------------------------------------------------
# scene query
# --------------------------------------------------------------------------


def instance_prim_ranges(scene, meta):
    """Per instance, the [lo, hi) range of its shape's prims in the pool,
    as two (I,) i32 tensors on the scene's device (inst -> shape through
    the shape roots, then ``meta.shape_prim_offset``)."""
    root_to_shape = {int(r): i for i, r in enumerate(meta.shape_node_root)}
    offs = list(meta.shape_prim_offset) + [int(meta.num_prims)]
    shapes = [root_to_shape[int(r)] for r in scene.inst_shape_root.tolist()]
    dev = scene.inst_shape_root.device
    lo = torch.tensor([offs[s] for s in shapes], dtype=torch.int32,
                      device=dev)
    hi = torch.tensor([offs[s + 1] for s in shapes], dtype=torch.int32,
                      device=dev)
    return lo, hi


def _closest_in_range(scene, lp, dist_max, lo: int, hi: int):
    """The winner among prims [lo, hi) for instance-local queries lp (Q, 3):
    (dmin (Q,), prim (Q,) i32 or -1, euv (Q, 4)), smallest d, last prim on
    ties, euv plus 0.0 (JAX sums a one-hot row, which turns -0 into +0)."""
    pid = torch.arange(lo, hi, dtype=torch.int32, device=lp.device)
    pv = scene.prim_v[pid]
    ptype = scene.prim_type[pid][None]
    v0 = scene.pos[pv[:, 0]][None]
    v1 = scene.pos[pv[:, 1]][None]
    v2 = scene.pos[pv[:, 2]][None]
    r0 = scene.radius[pv[:, 0]][None]
    r1 = scene.radius[pv[:, 1]][None]
    r2 = scene.radius[pv[:, 2]][None]
    lpb = lp[:, None, :]
    curb = dist_max[:, None]
    okt, dt, uvt = overlap_triangle(lpb, curb, v0, v1, v2, r0, r1, r2)
    okl, dl, uvl = overlap_line(lpb, curb, v0, v1, r0, r1)
    okp, dp = overlap_point(lpb, curb, v0, r0)
    is_tri = ptype == PRIM_TRIANGLE
    is_line = ptype == PRIM_LINE
    ok = torch.where(is_tri, okt, torch.where(
        is_line, okl, (ptype == PRIM_POINT) & okp))
    d = torch.where(ok, torch.where(is_tri, dt, torch.where(is_line, dl, dp)),
                    FLT_MAX)
    z = torch.zeros_like(dt)
    one = torch.ones_like(dt)
    ev = torch.where(is_tri[..., None], torch.cat([uvt, z[..., None]], -1),
                     torch.where(is_line[..., None],
                                 torch.stack([uvl[..., 0], uvl[..., 1], z, z],
                                             -1),
                                 torch.stack([one, z, z, z], -1)))
    dmin = d.amin(dim=1)
    is_win = ok & (d == dmin[:, None])
    k = torch.where(is_win, pid[None], -1).amax(dim=1)
    kl = (k - lo).clamp(min=0).long()
    ev_win = ev[torch.arange(lp.shape[0], device=lp.device), kl] + 0.0
    return dmin, k, ev_win


def overlap_scene_plain(scene, meta, pos, dist_max) -> dict:
    """Plain torch scene query (the reference for K11) on any device; same
    contract as ``overlap_scene``. Each instance tests its own prim range,
    in dense blocks of at most PAIRS_PER_BLOCK (query, prim) pairs."""
    n = pos.shape[0]
    dev = pos.device
    dist_max = torch.broadcast_to(
        torch.as_tensor(dist_max, dtype=torch.float32, device=dev), (n,))
    lo, hi = (x.tolist() for x in instance_prim_ranges(scene, meta))
    found = torch.zeros(n, dtype=torch.bool, device=dev)
    dist = torch.full((n,), FLT_MAX, dtype=torch.float32, device=dev)
    inst = torch.full((n,), -1, dtype=torch.int32, device=dev)
    prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    euv = torch.zeros((n, 4), dtype=torch.float32, device=dev)
    for ii, (a, b) in enumerate(zip(lo, hi)):
        if a >= b:
            continue
        lp = isect.transform_vector_inverse(scene.inst_axes[ii],
                                            pos - scene.inst_o[ii])
        step = max(1, PAIRS_PER_BLOCK // (b - a))
        for s in range(0, n, step):
            sl = slice(s, s + step)
            dmin, k, ev = _closest_in_range(scene, lp[sl], dist_max[sl], a, b)
            # fold across instances: accept <= (the last instance wins ties)
            accept = (k >= 0) & (dmin <= torch.where(found[sl], dist[sl],
                                                     dist_max[sl]))
            found[sl] = found[sl] | accept
            dist[sl] = torch.where(accept, dmin, dist[sl])
            inst[sl] = torch.where(accept, ii, inst[sl])
            prim[sl] = torch.where(accept, k, prim[sl])
            euv[sl] = torch.where(accept[:, None], ev, euv[sl])
    return dict(found=found, dist=torch.where(found, dist, FLT_MAX),
                inst=inst, prim=prim, euv=euv)


# --------------------------------------------------------------------------
# K11's culled walk: records, refit, plain walk, kernel
# --------------------------------------------------------------------------

# the records of kernels/csrc/overlap.cu (its header gives the layouts)
NODE_WORDS = 8
PRIM_WORDS = 16
COUNT_SAT = 15           # a node's packed count saturates here (4 bits)
MAX_INDEX = 1 << 27      # node, slot and prim ids stay below
# the skip test, overlap.cu's header: skip a node when
# lb * CULL_REL - CULL_ABS * (sum of |box coordinates|) > L
CULL_REL = 1.0 - 2.0 ** -12
CULL_ABS = 2.0 ** -16
# a triangle with |ab x ac|^2 <= THIN_TRIANGLE * (longest edge^2)^2 and
# distinct vertices is never culled: every node above it is entered, and its
# record's tag carries THIN_BIT
THIN_TRIANGLE = 2.0 ** -14
THIN_BIT = 1 << 30
# the plain walk's ``stats``: node visits and prim tests by kind
WALK_STATS = ("nodes", "point_tests", "line_tests", "triangle_tests")


class OverlapRecords(NamedTuple):
    nodes: torch.Tensor       # (M, NODE_WORDS) f32 words
    prims: torch.Tensor       # (K - I, PRIM_WORDS) f32
    node_count: torch.Tensor  # (M,) i32, the scene's own


def _min_sel(a, b):
    return torch.where(b < a, b, a)


def _max_sel(a, b):
    return torch.where(b > a, b, a)


def _slot_boxes(scene, prim):
    """For the prims ``prim`` (S,): their boxes as the BVH build computes
    them (``bvh._shape_prim_bounds``: points p -/+ r, lines
    min/max(p0 -/+ r0, p1 -/+ r1), triangles the vertices' min/max), the
    thin-triangle flag, and the vertex data of their records."""
    pv = scene.prim_v[prim]
    t = scene.prim_type[prim]
    v0, v1, v2 = (scene.pos[pv[:, k]] for k in range(3))
    r0, r1, r2 = (scene.radius[pv[:, k]] for k in range(3))
    is_pt = (t == PRIM_POINT)[:, None]
    is_line = (t == PRIM_LINE)[:, None]
    a0, a1 = r0[:, None], r1[:, None]
    lo = torch.where(is_pt, v0 - a0, torch.where(
        is_line, _min_sel(v0 - a0, v1 - a1), _min_sel(_min_sel(v0, v1), v2)))
    hi = torch.where(is_pt, v0 + a0, torch.where(
        is_line, _max_sel(v0 + a0, v1 + a1), _max_sel(_max_sel(v0, v1), v2)))
    ab, ac, bc = v1 - v0, v2 - v0, v2 - v1
    nrm = isect.cross(ab, ac)
    a2 = isect.dot(nrm, nrm)
    e2 = _max_sel(_max_sel(isect.dot(ab, ab), isect.dot(ac, ac)),
                  isect.dot(bc, bc))
    thin = ~(a2 > THIN_TRIANGLE * (e2 * e2))
    distinct = (ab != 0).any(-1) & (ac != 0).any(-1) & (bc != 0).any(-1)
    nocull = (t == PRIM_TRIANGLE) & thin & distinct
    return lo, hi, nocull, (v0, r0, v1, r1, v2, r2, t, prim)


def _check_sizes(scene):
    m, k = scene.node_start.shape[0], scene.leaf_items.shape[0]
    if max(m, k, scene.prim_v.shape[0]) >= MAX_INDEX:
        raise ValueError(f"BVH too large for K11's records: {m} nodes, {k} "
                         f"slots")


def refit_plain(scene) -> OverlapRecords:
    """K11's records from the scene's current ``pos`` and ``radius`` (the
    plain version of ``refit_cuda``, the same words): each shape leaf's box
    folds its prims' boxes in slot order, each internal node its two
    children's (repeated until nothing changes: height + 1 rounds), the
    scene tree's rows copy the build's boxes. Min and max are exact, so on
    an unmoved scene the boxes equal ``node_bbox_min/max``."""
    _check_sizes(scene)
    i32, f32 = torch.int32, torch.float32
    dev = scene.device
    m, ni = scene.node_start.shape[0], scene.inst_axes.shape[0]
    with torch.no_grad():
        slots = scene.leaf_items[ni:]
        plo, phi, pflag, (v0, r0, v1, r1, v2, r2, t, prim) = _slot_boxes(
            scene, slots)
        tag = (prim * 4 + t + pflag.to(i32) * THIN_BIT).to(i32)
        tag = tag.view(f32)[:, None]
        prims = torch.cat([v0, r0[:, None], v1, r1[:, None], v2,
                           r2[:, None], tag,
                           torch.zeros((tag.shape[0], 3), dtype=f32,
                                       device=dev)], 1)

        kind, isleaf = scene.node_kind, scene.node_isleaf != 0
        start, count = scene.node_start, scene.node_count
        lo = scene.node_bbox_min.detach().clone()
        hi = scene.node_bbox_max.detach().clone()
        flag = torch.zeros(m, dtype=torch.bool, device=dev)
        leaves = torch.nonzero((kind == 1) & isleaf).squeeze(1)
        lstart, lcount = start[leaves], count[leaves]
        llo = torch.full((leaves.shape[0], 3), FLT_MAX, device=dev)
        lhi = torch.full((leaves.shape[0], 3), -FLT_MAX, device=dev)
        lflag = torch.zeros(leaves.shape[0], dtype=torch.bool, device=dev)
        for j in range(int(lcount.max()) if leaves.numel() else 0):
            act = j < lcount
            row = torch.where(act, lstart + j - ni, 0).long()
            first = (j == 0) & act
            llo = torch.where(first[:, None], plo[row], torch.where(
                act[:, None], _min_sel(llo, plo[row]), llo))
            lhi = torch.where(first[:, None], phi[row], torch.where(
                act[:, None], _max_sel(lhi, phi[row]), lhi))
            lflag = lflag | (act & pflag[row])
        lo[leaves], hi[leaves], flag[leaves] = llo, lhi, lflag

        inner = torch.nonzero((kind == 1) & ~isleaf).squeeze(1)
        c0 = start[inner].long()
        lo[inner] = FLT_MAX
        hi[inner] = -FLT_MAX
        while inner.numel():
            nlo = _min_sel(lo[c0], lo[c0 + 1])
            nhi = _max_sel(hi[c0], hi[c0 + 1])
            nflag = flag[c0] | flag[c0 + 1]
            same = (torch.equal(nlo.view(i32), lo[inner].view(i32))
                    and torch.equal(nhi.view(i32), hi[inner].view(i32))
                    and torch.equal(nflag, flag[inner]))
            lo[inner], hi[inner], flag[inner] = nlo, nhi, nflag
            if same:
                break

        w6 = start * 16 + count.clamp(max=COUNT_SAT)
        w7 = scene.node_skip * 4 + flag.to(i32) * 2 + isleaf.to(i32)
        nodes = torch.cat([lo.view(i32), hi.view(i32), w6[:, None],
                           w7[:, None]], 1).view(f32)
    return OverlapRecords(nodes.contiguous(), prims.contiguous(),
                          scene.node_count)


# the leaves the refit reads, in yrt_overlap_refit's argument order
REFIT_LEAVES = (
    ("node_start", torch.int32, (-1,)), ("node_count", torch.int32, (-1,)),
    ("node_isleaf", torch.int32, (-1,)), ("node_kind", torch.int32, (-1,)),
    ("node_skip", torch.int32, (-1,)),
    ("node_bbox_min", torch.float32, (-1, 3)),
    ("node_bbox_max", torch.float32, (-1, 3)),
    ("leaf_items", torch.int32, (-1,)), ("prim_v", torch.int32, (-1, 3)),
    ("prim_type", torch.int32, (-1,)), ("pos", torch.float32, (-1, 3)),
    ("radius", torch.float32, (-1,)))


def refit_cuda(scene) -> OverlapRecords:
    """The records of ``refit_plain`` from the refit kernel
    (``yrt_overlap_refit``: parent pointers, then one thread per shape leaf
    that climbs while it is the second child to arrive), CUDA only; no
    host synchronisation."""
    _check_sizes(scene)
    dev = scene.device
    f32, i32 = torch.float32, torch.int32
    m, k, ni = (scene.node_start.shape[0], scene.leaf_items.shape[0],
                scene.inst_axes.shape[0])
    check = _build.check_tensor
    for name, dtype, shape in REFIT_LEAVES:
        check(name, getattr(scene, name), dtype, shape, dev)
    parent = torch.empty(m, dtype=i32, device=dev)
    arrivals = torch.empty(m, dtype=i32, device=dev)
    nodes = torch.empty((m, NODE_WORDS), dtype=f32, device=dev)
    prims = torch.empty((k - ni, PRIM_WORDS), dtype=f32, device=dev)
    ptr = _build.ptr
    err = _build.library().yrt_overlap_refit(
        *(ptr(getattr(scene, name)) for name, _, _ in REFIT_LEAVES), m, ni,
        ptr(parent), ptr(arrivals), ptr(nodes), ptr(prims),
        _build.current_stream())
    _build.check_launch(err, "yrt_overlap_refit")
    _build.launches["overlap_refit"] += 1
    return OverlapRecords(nodes, prims, scene.node_count)


def cull_box(lp, lo, hi, limit):
    """The walk's skip test (overlap.cu ``cull_box``), op for op: True where
    nothing under the box (lo, hi) can lie within ``limit`` of ``lp``."""
    g = lo - lp
    t = lp - hi
    g = torch.where(t > g, t, g)
    g = torch.where(g > 0, g, 0.0)
    lb = isect.sqrt(isect.dot(g, g))
    a = torch.cat([lo, hi], -1).abs()
    m = a[..., 0] + a[..., 1] + a[..., 2] + a[..., 3] + a[..., 4] + a[..., 5]
    return lb * CULL_REL - CULL_ABS * m > limit


def _broadcast_dist_max(dist_max, n: int, dev) -> torch.Tensor:
    """(n,) f32 on ``dev``; a scalar is filled on the device (no copy)."""
    if isinstance(dist_max, torch.Tensor):
        return torch.broadcast_to(dist_max.to(dev, torch.float32),
                                  (n,)).contiguous()
    if np.ndim(dist_max) == 0:
        return torch.full((n,), float(dist_max), dtype=torch.float32,
                          device=dev)
    return torch.broadcast_to(torch.as_tensor(
        np.asarray(dist_max, np.float32), device=dev), (n,)).contiguous()


def _test_leaf_prims(rec, slot0, lp, dist_max, dmin, win, ev, lanes,
                     start, cnt, out, stats):
    """The prims of the leaves that ``lanes`` reached (slots ``start`` ..
    ``start + cnt``; only the thin ones where the leaf is ``out`` of reach),
    in slot order, into the instance winner (dmin, win, ev): smallest d, the
    largest prim index on ties."""
    for j in range(int(cnt.max())):
        rows = torch.where(j < cnt, start + j - slot0, 0).long()
        tag = rec.prims.view(torch.int32)[rows, 12]
        a = torch.nonzero((j < cnt) & ~(out & ((tag & THIN_BIT) == 0)))
        a = a.squeeze(1)
        q = lanes[a]
        r = rec.prims[rows[a]]
        ptype, pid = tag[a] & 3, (tag[a] & ~THIN_BIT) >> 2
        v0, r0, v1, r1 = r[:, 0:3], r[:, 3], r[:, 4:7], r[:, 7]
        v2, r2 = r[:, 8:11], r[:, 11]
        if stats is not None:
            for kind, name in enumerate(WALK_STATS[1:]):
                stats[name] += int((ptype == kind).sum())
        lq, dq = lp[q], dist_max[q]
        okt, dt, uvt = overlap_triangle(lq, dq, v0, v1, v2, r0, r1, r2)
        okl, dl, uvl = overlap_line(lq, dq, v0, v1, r0, r1)
        okp, dp = overlap_point(lq, dq, v0, r0)
        is_tri = ptype == PRIM_TRIANGLE
        is_line = ptype == PRIM_LINE
        ok = torch.where(is_tri, okt, torch.where(
            is_line, okl, (ptype == PRIM_POINT) & okp))
        d = torch.where(is_tri, dt, torch.where(is_line, dl, dp))
        z = torch.zeros_like(dt)
        one = torch.ones_like(dt)
        evk = torch.where(is_tri[:, None], torch.cat([uvt, z[:, None]], -1),
                          torch.where(is_line[:, None],
                                      torch.stack([uvl[:, 0], uvl[:, 1], z, z],
                                                  -1),
                                      torch.stack([one, z, z, z], -1)))
        dm, wn = dmin[q], win[q]
        better = ok & ((d < dm) | ((d == dm) & (pid > wn)))
        dmin[q] = torch.where(better, d, dm)
        win[q] = torch.where(better, pid, wn)
        ev[q] = torch.where(better[:, None], evk, ev[q])


def overlap_scene_walk_plain(scene, meta, pos, dist_max,
                             stats=None) -> dict:
    """K11's culled walk in plain torch, vectorized over the queries (the
    CPU path of ``overlap_scene``; same contract). Per instance, in order,
    every query walks the instance's shape BVH from its root in the
    threaded order, skipping a node by ``cull_box`` against
    min(found ? dist : dist_max, the instance's best so far) unless the
    node is flagged, and testing the prims of the leaves it reaches (of a
    flagged leaf out of reach, only the thin ones); then the fold across
    instances of ``overlap_scene_plain``. The answers are
    the brute force's, bit for bit (overlap.cu's header says why).

    The records are ``refit_plain(scene)``, refit on every call. stats,
    when given (a dict), gains the walk's work: ``nodes`` (visits, one skip test each)
    and the prim tests by kind (WALK_STATS)."""
    if stats is not None:
        for key in WALK_STATS:
            stats.setdefault(key, 0)
    n = pos.shape[0]
    dev = pos.device
    i32 = torch.int32
    dist_max = _broadcast_dist_max(dist_max, n, dev)
    rec = refit_plain(scene)
    words = rec.nodes.view(i32)
    slot0 = scene.inst_axes.shape[0]
    found = torch.zeros(n, dtype=torch.bool, device=dev)
    dist = torch.full((n,), FLT_MAX, dtype=torch.float32, device=dev)
    inst = torch.full((n,), -1, dtype=i32, device=dev)
    prim = torch.full((n,), -1, dtype=i32, device=dev)
    euv = torch.zeros((n, 4), dtype=torch.float32, device=dev)
    for ii, root in enumerate(scene.inst_shape_root.tolist()):
        lp = isect.transform_vector_inverse(scene.inst_axes[ii],
                                            pos - scene.inst_o[ii])
        fold = torch.where(found, dist, dist_max)
        dmin = torch.full((n,), FLT_MAX, dtype=torch.float32, device=dev)
        win = torch.full((n,), -1, dtype=i32, device=dev)
        ev = torch.zeros((n, 4), dtype=torch.float32, device=dev)
        node = torch.full((n,), root, dtype=i32, device=dev)
        while True:
            idx = torch.nonzero(node >= 0).squeeze(1)
            if idx.numel() == 0:
                break
            nd = node[idx].long()
            box, w = rec.nodes[nd], words[nd]
            w6, w7 = w[:, 6], w[:, 7]
            dm, fo = dmin[idx], fold[idx]
            limit = torch.where(dm < fo, dm, fo)
            out = cull_box(lp[idx], box[:, 0:3], box[:, 3:6], limit)
            cull = out & ((w7 & 2) == 0)
            leaf = ~cull & ((w7 & 1) == 1)
            if stats is not None:
                stats["nodes"] += idx.numel()
            li = torch.nonzero(leaf).squeeze(1)
            if li.numel():
                cnt = w6[li] & COUNT_SAT
                cnt = torch.where(cnt == COUNT_SAT,
                                  rec.node_count[nd[li]], cnt)
                _test_leaf_prims(rec, slot0, lp, dist_max, dmin, win,
                                 ev, idx[li], w6[li] >> 4, cnt, out[li],
                                 stats)
            node[idx] = torch.where(cull | leaf, w7 >> 2, (w6 >> 4) + 1)
        # fold across instances: accept <= (the last instance wins ties)
        accept = (win >= 0) & (dmin <= fold)
        found = found | accept
        dist = torch.where(accept, dmin, dist)
        inst = torch.where(accept, ii, inst)
        prim = torch.where(accept, win, prim)
        euv = torch.where(accept[:, None], ev + 0.0, euv)
    return dict(found=found, dist=torch.where(found, dist, FLT_MAX),
                inst=inst, prim=prim, euv=euv)


def empty_result(n: int, dev) -> dict:
    """Uninitialised outputs of a K11 launch for n queries."""
    f32, i32 = torch.float32, torch.int32
    return dict(found=torch.empty(n, dtype=torch.bool, device=dev),
                dist=torch.empty(n, dtype=f32, device=dev),
                inst=torch.empty(n, dtype=i32, device=dev),
                prim=torch.empty(n, dtype=i32, device=dev),
                euv=torch.empty((n, 4), dtype=f32, device=dev))


def overlap_scene_cuda(scene, meta, pos, dist_max) -> dict:
    """K11 launch: same contract as ``overlap_scene_plain``, CUDA only. The
    records are refit from the current ``pos`` and ``radius`` on every call
    (``refit_cuda``); thread k of K11 takes query k. No host
    synchronisation."""
    dev = pos.device
    n = pos.shape[0]
    f32, i32 = torch.float32, torch.int32
    check = _build.check_tensor
    check("pos (queries)", pos, f32, (n, 3), dev)
    leaves = (("inst_axes", f32, (-1, 3, 3)), ("inst_o", f32, (-1, 3)),
              ("inst_shape_root", i32, (-1,)))
    for name, dtype, shape in leaves:
        check(name, getattr(scene, name), dtype, shape, dev)
    dist_max = _broadcast_dist_max(dist_max, n, dev)
    records = refit_cuda(scene)
    ni = scene.inst_axes.shape[0]
    out = empty_result(n, dev)
    ptr = _build.ptr
    err = _build.library().yrt_overlap(
        ptr(pos), ptr(dist_max), n, ptr(scene.inst_axes), ptr(scene.inst_o),
        ptr(scene.inst_shape_root), ni, ptr(records.nodes),
        ptr(records.node_count), ptr(records.prims), ni,
        *(ptr(out[k]) for k in ("found", "dist", "inst", "prim", "euv")),
        _build.current_stream())
    _build.check_launch(err, "yrt_overlap")
    _build.launches["overlap"] += 1
    return out


def overlap_scene(scene, meta, pos, dist_max) -> dict:
    """Closest scene element within ``dist_max`` per query point.

    Capability parity with yscn::overlap_point at scene level
    (yocto_scn.cpp:1966-1982) and with the JAX ``overlap_scene``: each
    query is moved into every instance's frame and tested against that
    instance's shape elements; distances are local-space. An element is
    accepted when its distance is within ``dist_max`` plus its radius; the
    winner is the smallest distance, the last (instance, prim) on exact
    ties (the JAX function's documented semantics).

    scene: TorchScene; meta: SceneMeta; pos: (N, 3) f32 world queries on
    the scene's device; dist_max: scalar or (N,). Returns dict(found (N,)
    bool, dist (N,) f32 (FLT_MAX where not found), inst (N,) i32, prim (N,)
    i32 (-1 where not found), euv (N, 4) f32: (w0, w1, w2, 0) for
    triangles, (1-u, u, 0, 0) for lines, (1, 0, 0, 0) for points, zeros
    where not found).

    CPU tensors take the plain culled walk
    (``overlap_scene_walk_plain``); CUDA tensors the refit kernel and K11
    (or raise). K11 runs fastest on queries in spatially coherent order
    (neighbouring queries in neighbouring rows): a warp of queries runs as
    long as its longest walk.
    """
    if _build.device_kind(pos) == "cpu":
        return overlap_scene_walk_plain(scene, meta, pos, dist_max)
    return overlap_scene_cuda(scene, meta, pos, dist_max)
