"""Point-overlap / closest-point queries: plain torch and the K11 CUDA kernel.

Port of ``yocto_raytracing_tpu/ops/overlap.py``: the ym overlap API
(src/ext/yocto_math.h:5836-6017) and its scene-level wrapper
(src/ext/yocto_scn.cpp:1920-1985). Given query points, find the closest
scene element within ``dist_max`` (plus the element's radius) and its
element uv. The render path never calls it; it serves geometry tooling
(collision proxies, closest-surface projection).

Every helper repeats the JAX function's operations in its order (explicit
dots, the ``safe`` 0 -> 1 divisors, ``safe_sqrt``), so the plain versions
are bit-equal to JAX run op by op. ``overlap_scene`` runs
``overlap_scene_plain`` for CPU tensors and launches K11
(``kernels/csrc/overlap.cu``, one thread per query, the same math) for CUDA
tensors. Distances are instance-local, like the reference's.
"""

from __future__ import annotations

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


def overlap_scene_cuda(scene, meta, pos, dist_max) -> dict:
    """K11 launch: same contract as ``overlap_scene_plain``, CUDA only."""
    dev = pos.device
    n = pos.shape[0]
    f32, i32 = torch.float32, torch.int32
    dist_max = torch.broadcast_to(
        torch.as_tensor(dist_max, dtype=f32, device=dev), (n,)).contiguous()
    lo, hi = instance_prim_ranges(scene, meta)
    check = _build.check_tensor
    check("pos (queries)", pos, f32, (n, 3), dev)
    leaves = (("inst_axes", f32, (-1, 3, 3)), ("inst_o", f32, (-1, 3)),
              ("prim_v", i32, (-1, 3)), ("prim_type", i32, (-1,)),
              ("pos", f32, (-1, 3)), ("radius", f32, (-1,)))
    for name, dtype, shape in leaves:
        check(name, getattr(scene, name), dtype, shape, dev)
    out = dict(found=torch.empty(n, dtype=torch.bool, device=dev),
               dist=torch.empty(n, dtype=f32, device=dev),
               inst=torch.empty(n, dtype=i32, device=dev),
               prim=torch.empty(n, dtype=i32, device=dev),
               euv=torch.empty((n, 4), dtype=f32, device=dev))
    ptr = _build.ptr
    err = _build.library().yrt_overlap(
        ptr(pos), ptr(dist_max), n, ptr(scene.inst_axes), ptr(scene.inst_o),
        ptr(lo), ptr(hi), lo.shape[0], ptr(scene.prim_v),
        ptr(scene.prim_type), ptr(scene.pos), ptr(scene.radius),
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

    CPU tensors take the plain version; CUDA tensors launch K11 (or
    raise).
    """
    if _build.device_kind(pos) == "cpu":
        return overlap_scene_plain(scene, meta, pos, dist_max)
    return overlap_scene_cuda(scene, meta, pos, dist_max)
