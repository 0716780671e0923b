"""Area-light sampling: element CDFs and per-ray light points (K8).

Port of ``yocto_raytracing_tpu/render/lights.py``. The reference builds
per-element CDFs for area sampling (yscn::update_lights,
src/ext/yocto_scn.cpp:1748-1779: point counts, line lengths, triangle areas)
and never uses them: its renderer puts point lights at ``shp->pos.front()``
(src/raytrace.cpp:121-130). The stochastic soft-shadow mode samples ONE
point on each emissive shape per ray (element by inverse CDF, position
uniform within the element, ym::sample_triangle semantics) and shades with
the same ke/r^2 point-light model, so an emissive shape whose geometry is a
single point gives the deterministic frame bit for bit.

Sampling is in SHAPE SPACE, as the reference's light convention (the light
position is a shape-space pos, moved by the light frame at shading time,
raytrace.cpp:129-130).

* ``build_light_sampler``: the host tables (numpy, as in JAX), as tensors
  on the scene's device;
* ``sample_light_points``: (L, N, 3) points for a batch of ray ids; the
  plain version for CPU tensors (differentiable by torch autograd), K8
  (``kernels/csrc/lights.cu``) for CUDA tensors, with K10, its reverse, in
  the backward (``LightPointsFn``): the points' gradient goes to ``pos``
  and, for a light whose shape has no element, to ``light_pos``;
* ``cdf_search_plain``: K8's binary-search element pick, written out, and
  ``light_points_bwd_plain``: K10's explicit f64 reverse, as references
  for the two kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import _build
from ..ops import intersect as isect, sampling
from ..scene import PRIM_LINE, PRIM_TRIANGLE
from . import camera as camera_mod

LIGHT_SEED_XOR = 0x85EBCA6B   # light variates: seed ^ this (renderer.py:271)


def build_light_sampler(host, leaves, meta, device="cuda"):
    """Per-light element CDF tables -> dict of tensors on ``device`` (None
    if the scene has no light).

    For each light instance (every component of ke positive, the shading
    rule), the unnormalized running-sum CDF over the emissive shape's
    elements in POOL ORDER (points, then lines, then triangles), padded to
    the largest element count with its last value. Returns dict(cdf (L, E)
    f32, n (L,) i32, prim_lo (L,) i32, deg (L,) bool). ``leaves`` is not
    read (the JAX function's device-scene argument).

    An emissive shape with no element adds nothing to the prim pool, so its
    pool offset is the NEXT shape's first prim: it is marked ``deg`` and
    keeps its deterministic position (pos[0]).
    """
    del leaves
    pool_off = list(meta.shape_prim_offset)
    lights = []
    for ist in host.instances:
        mat = host.materials[ist.material] if ist.material >= 0 else None
        if mat is None or not (mat.ke > 0).all():
            continue
        shp = host.shapes[ist.shape]
        weights = []
        if len(shp.points):
            weights.append(np.ones(len(shp.points), np.float32))
        if len(shp.lines):
            d = shp.pos[shp.lines[:, 1]] - shp.pos[shp.lines[:, 0]]
            weights.append(np.linalg.norm(d, axis=-1).astype(np.float32))
        if len(shp.triangles):
            c = np.cross(shp.pos[shp.triangles[:, 1]]
                         - shp.pos[shp.triangles[:, 0]],
                         shp.pos[shp.triangles[:, 2]]
                         - shp.pos[shp.triangles[:, 0]])
            weights.append(
                (0.5 * np.linalg.norm(c, axis=-1)).astype(np.float32))
        degenerate = not weights
        w = (np.concatenate(weights) if weights
             else np.ones(1, np.float32))
        lights.append((np.cumsum(w).astype(np.float32),
                       pool_off[ist.shape], degenerate))
    if not lights:
        return None
    emax = max(len(c) for c, _, _ in lights)
    cdf = np.stack([np.pad(c, (0, emax - len(c)), mode="edge")
                    for c, _, _ in lights])
    device = torch.device(device)

    def put(a, dtype):
        return torch.from_numpy(np.asarray(a, dtype)).to(device)

    return dict(cdf=put(cdf, np.float32),
                n=put([len(c) for c, _, _ in lights], np.int32),
                prim_lo=put([lo for _, lo, _ in lights], np.int32),
                deg=put([d for _, _, d in lights], np.bool_))


def _pick(scene, sampler, ids, seed: int):
    """The plain pick: the (N, 3) variates of ``seed ^ 0x85EBCA6B`` and the
    (L, N) prim each light samples (inverse CDF by the dense count of
    strictly smaller entries, so a tie picks what the JAX function
    picks)."""
    ruv = camera_mod.per_ray_uniform((seed & camera_mod.U32)
                                     ^ LIGHT_SEED_XOR, ids, 3)
    cdf = sampler["cdf"]                      # (L, E)
    x = ruv[None, :, 0] * cdf[:, -1:]         # (L, N)
    idx = (cdf[:, None, :] < x[..., None]).sum(dim=-1)
    idx = torch.minimum(idx, (sampler["n"] - 1)[:, None].to(idx.dtype))
    prim = torch.clamp(sampler["prim_lo"][:, None] + idx, 0,
                       scene.prim_v.shape[0] - 1)
    return ruv, prim


def cdf_search_plain(cdf, x):
    """K8's element pick as ``lights.cu::cdf_count`` runs it: per row of
    ``cdf`` (L, E) and value of ``x`` (L, N), the lower bound of the
    predicate ``cdf[m] < x`` by binary search, with the kernel's steps.
    On every row that ``build_light_sampler`` makes it equals the dense
    count ``(cdf[:, None, :] < x[..., None]).sum(-1)`` (the kernel's
    header gives the argument; the CPU tests check it)."""
    lo = torch.zeros(x.shape, dtype=torch.int64, device=x.device)
    e = cdf.shape[1]
    while e > 1:
        half = e >> 1
        lo = torch.where(torch.gather(cdf, 1, lo + half) < x, lo + half, lo)
        e -= half
    return lo + (torch.gather(cdf, 1, lo) < x).to(torch.int64)


def sample_light_points_plain(scene, sampler, ids, seed: int):
    """Plain torch light points: ids (N,) i32 -> (L, N, 3) shape-space
    positions, from ``per_ray_uniform(seed ^ 0x85EBCA6B, ids, 3)`` (element
    pick, then the element's own one or two coordinates)."""
    ruv, prim = _pick(scene, sampler, ids, seed)
    pv = scene.prim_v[prim]                   # (L, N, 3)
    ptype = scene.prim_type[prim]             # (L, N)
    v0 = scene.pos[pv[..., 0]]
    v1 = scene.pos[pv[..., 1]]
    v2 = scene.pos[pv[..., 2]]
    u = ruv[None, :, 1:2]
    v = ruv[None, :, 2:3]
    tri = sampling.sample_triangle(
        torch.cat([u, v], dim=-1).expand(v0.shape[:-1] + (2,)), v0, v1, v2)
    line = v0 * (1.0 - u) + v1 * u
    out = torch.where((ptype == PRIM_TRIANGLE)[..., None], tri,
                      torch.where((ptype == PRIM_LINE)[..., None], line, v0))
    return torch.where(sampler["deg"][:, None, None],
                       scene.light_pos[:, None, :], out)


def light_points_bwd_plain(scene, sampler, ids, seed: int, g,
                           num_verts: int):
    """K10's explicit reverse: the (L, N, 3) cotangent ``g`` of the light
    points -> (d_pos (V, 3), d_light_pos (L, 3)). Each term ``g * w`` is
    formed in f32 (a triangle's weights (1 - a - b, a, b), a line's
    (1 - u, u), a point's 1), added into f64 sums with ``index_add_``, and
    every sum is rounded to f32 once; a light whose shape has no element
    sums its ``g`` into ``d_light_pos``."""
    ruv, prim = _pick(scene, sampler, ids, seed)
    deg = sampler["deg"][:, None].expand(prim.shape)
    ptype = scene.prim_type[prim]
    pv = scene.prim_v[prim]
    u = ruv[None, :, 1].expand(prim.shape)
    v = ruv[None, :, 2].expand(prim.shape)
    sq = isect.sqrt(u)
    a = 1.0 - sq
    b = v * sq
    tri = ptype == PRIM_TRIANGLE
    line = ptype == PRIM_LINE
    one = torch.ones_like(u)
    weights = (torch.where(tri, 1.0 - a - b, torch.where(line, 1.0 - u, one)),
               torch.where(tri, a, u), b)
    counts = torch.where(tri, 3, torch.where(line, 2, 1))
    d_pos = torch.zeros((num_verts, 3), dtype=torch.float64,
                        device=g.device)
    for j, w in enumerate(weights):
        sel = ~deg & (counts > j)
        d_pos.index_add_(0, pv[..., j][sel],
                         (g * w[..., None])[sel].to(torch.float64))
    d_light_pos = torch.where(sampler["deg"][:, None],
                              g.to(torch.float64).sum(dim=1), 0.0)
    return d_pos.to(torch.float32), d_light_pos.to(torch.float32)


def _launch(name, scene, sampler, ids, seed, *tail):
    """Check the tables and topology, then launch ``name`` (K8 or K10,
    which share their leading arguments: ids, seed, the tables, prim_v,
    prim_type); ``tail`` holds the tensors (and ints) that differ."""
    dev = ids.device
    n = ids.shape[0]
    cdf = sampler["cdf"]
    nl, ne = cdf.shape
    check = _build.check_tensor
    check("ids", ids, torch.int32, (n,), dev)
    check("cdf", cdf, torch.float32, (nl, ne), dev)
    check("n", sampler["n"], torch.int32, (nl,), dev)
    check("prim_lo", sampler["prim_lo"], torch.int32, (nl,), dev)
    check("deg", sampler["deg"], torch.bool, (nl,), dev)
    check("prim_v", scene.prim_v, torch.int32, (-1, 3), dev)
    check("prim_type", scene.prim_type, torch.int32, (-1,), dev)
    if ne < 1 or scene.prim_v.shape[0] < 1:
        raise ValueError("light sampler without elements or scene without "
                         "prims")
    ptr = _build.ptr
    err = getattr(_build.library(), name)(
        ptr(ids), n, seed & camera_mod.U32, ptr(cdf), nl, ne,
        ptr(sampler["n"]), ptr(sampler["prim_lo"]), ptr(sampler["deg"]),
        ptr(scene.prim_v), ptr(scene.prim_type), scene.prim_v.shape[0],
        *(ptr(t) if isinstance(t, torch.Tensor) else t for t in tail),
        _build.current_stream())
    _build.check_launch(err, name)


class LightPointsFn(torch.autograd.Function):
    """K8 forward, K10 backward: ``forward(ctx, scene, sampler, ids, seed,
    pos, light_pos)`` -> (L, N, 3) points, differentiable in ``pos`` and
    ``light_pos`` (the same tensors as ``scene.pos`` / ``scene.light_pos``;
    the tables and topology come from ``sampler`` and ``scene``)."""

    @staticmethod
    def forward(ctx, scene, sampler, ids, seed, pos, light_pos):
        out = light_points_launch(scene, sampler, ids, seed, pos, light_pos)
        ctx.scene, ctx.sampler, ctx.seed = scene, sampler, seed
        ctx.save_for_backward(ids, pos)
        return out

    @staticmethod
    def backward(ctx, g):
        ids, pos = ctx.saved_tensors
        d_pos, d_light_pos = light_points_bwd(ctx.scene, ctx.sampler, ids,
                                              ctx.seed, g.contiguous(),
                                              pos.shape[0])
        return None, None, None, None, d_pos, d_light_pos


def light_points_launch(scene, sampler, ids, seed, pos, light_pos,
                        out=None):
    """K8 launch, no autograd: the (L, N, 3) points, written into ``out``
    when given. CUDA only. ``seed`` is an int, or a (1,) i32 device tensor
    holding the seed's 32 bits (a seed word), which K8 reads when it runs:
    a captured graph's launch then follows the word."""
    dev = ids.device
    shape = (sampler["cdf"].shape[0], ids.shape[0], 3)
    _build.check_tensor("pos", pos, torch.float32, (-1, 3), dev)
    _build.check_tensor("light_pos", light_pos, torch.float32,
                        (shape[0], 3), dev)
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=dev)
    _build.check_tensor("out", out, torch.float32, shape, dev)
    value, word = camera_mod._seed_args(seed, dev)
    _launch("yrt_light_points", scene, sampler, ids, value, pos, light_pos,
            word, out)
    _build.launches["light_points"] += 1
    return out


def light_points_bwd(scene, sampler, ids, seed: int, g, num_verts: int):
    """K10 launch: the (L, N, 3) cotangent ``g`` of the light points ->
    (d_pos (V, 3), d_light_pos (L, 3)), f64 sums rounded to f32 once; the
    kernel writes every word, and its scratch is allocated here. CUDA
    only."""
    dev = ids.device
    nl = sampler["cdf"].shape[0]
    n = ids.shape[0]
    _build.check_tensor("g", g, torch.float32, (nl, n, 3), dev)
    d_pos = torch.empty((num_verts, 3), dtype=torch.float32, device=dev)
    d_light_pos = torch.empty((nl, 3), dtype=torch.float32, device=dev)
    scratch = torch.empty(
        (_build.library().yrt_light_points_bwd_scratch(n, nl, num_verts),),
        dtype=torch.uint8, device=dev)
    _launch("yrt_light_points_bwd", scene, sampler, ids, seed, g, num_verts,
            scratch, d_pos, d_light_pos)
    _build.launches["light_points_bwd"] += 1
    return d_pos, d_light_pos


def sample_light_points_cuda(scene, sampler, ids, seed: int):
    """K8 launch (K10 in the backward): same contract as
    ``sample_light_points_plain``, CUDA only."""
    return LightPointsFn.apply(scene, sampler, ids, seed, scene.pos,
                               scene.light_pos)


def sample_light_points(scene, sampler, ids, seed: int):
    """Per-ray shape-space sample point on each light: (L, N, 3).

    CPU tensors take the plain version (differentiable by torch autograd
    in ``pos`` and ``light_pos``); CUDA tensors launch K8 (or raise), and
    K10 in the backward.
    """
    if _build.device_kind(ids) == "cpu":
        return sample_light_points_plain(scene, sampler, ids, seed)
    return sample_light_points_cuda(scene, sampler, ids, seed)
