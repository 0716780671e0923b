"""Area-light sample points, plain torch: the benchmark's frozen copy.

Copied from yocto_raytracing_tpu_torch/render/lights.py
(``build_light_sampler``, ``_pick``, ``sample_light_points_plain``) and
ops/sampling.py (``sample_triangle``) at commit ad7840c, code unchanged
but for the dtype of the pick and the points, which follows the leaves'.
The tables are built from the reference's own scene (``flat.as_loaded``
and the ``shape_prim_offset`` of ``flat.build_device_scene``), never from
the program's.

Yocto/GL's element-CDF area lights (yscn::update_lights,
src/ext/yocto_scn.cpp:1748-1779): for each light instance (every component
of ke positive), the unnormalized running-sum CDF over its shape's elements
in pool order (points weigh 1, lines their length, triangles their area).
A ray samples ONE shape-space point on each light: an element by inverse
CDF, then a point uniform within it, from ``per_ray_uniform(seed ^
0x85EBCA6B, ids, 3)``; a light whose shape has no element keeps its
``light_pos``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import intersect as isect
from .flat import PRIM_LINE, PRIM_TRIANGLE
from .stochastic import U32, per_ray_uniform

LIGHT_SEED_XOR = 0x85EBCA6B   # light variates: seed ^ this


def build_light_sampler(host, meta, device):
    """Per-light element CDF tables of ``host`` (the reference's scene,
    ``flat.as_loaded``; ``meta`` its ``flat.build_device_scene`` meta) ->
    dict(cdf (L, E) f32, n (L,) i32, prim_lo (L,) i32, deg (L,) bool) on
    ``device``, or None without a light. Rows are padded to the largest
    element count with their last value."""
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


def sample_triangle(ruv, v0, v1, v2):
    """The point of uniform barycentrics: uv = (1 - sqrt(r0), r1 *
    sqrt(r0)), point = v0 * (1 - u - v) + v1 * u + v2 * v
    (yocto_math.h:3304-3315)."""
    sq = isect.sqrt(ruv[..., 0])
    uv = torch.stack([1.0 - sq, ruv[..., 1] * sq], dim=-1)
    u = uv[..., 0:1]
    v = uv[..., 1:2]
    return v0 * (1.0 - u - v) + v1 * u + v2 * v


def _pick(scene, sampler, ids, seed: int):
    """The (N, 3) variates of ``seed ^ 0x85EBCA6B`` in the leaves' dtype
    and the (L, N) prim each light samples (inverse CDF by the dense count
    of strictly smaller entries)."""
    dt = scene.pos.dtype
    ruv = per_ray_uniform((seed & U32) ^ LIGHT_SEED_XOR, ids, 3).to(dt)
    cdf = sampler["cdf"].to(dt)               # (L, E)
    x = ruv[None, :, 0] * cdf[:, -1:]         # (L, N)
    idx = (cdf[:, None, :] < x[..., None]).sum(dim=-1)
    idx = torch.minimum(idx, (sampler["n"] - 1)[:, None].to(idx.dtype))
    prim = torch.clamp(sampler["prim_lo"][:, None] + idx, 0,
                       scene.prim_v.shape[0] - 1)
    return ruv, prim


def sample_light_points_plain(scene, sampler, ids, seed: int):
    """Plain torch light points: ids (N,) i32 -> (L, N, 3) shape-space
    positions, in the leaves' dtype (element pick, then the element's own
    one or two coordinates)."""
    ruv, prim = _pick(scene, sampler, ids, seed)
    pv = scene.prim_v[prim]                   # (L, N, 3)
    ptype = scene.prim_type[prim]             # (L, N)
    v0 = scene.pos[pv[..., 0]]
    v1 = scene.pos[pv[..., 1]]
    v2 = scene.pos[pv[..., 2]]
    u = ruv[None, :, 1:2]
    v = ruv[None, :, 2:3]
    tri = sample_triangle(
        torch.cat([u, v], dim=-1).expand(v0.shape[:-1] + (2,)), v0, v1, v2)
    line = v0 * (1.0 - u) + v1 * u
    out = torch.where((ptype == PRIM_TRIANGLE)[..., None], tri,
                      torch.where((ptype == PRIM_LINE)[..., None], line, v0))
    return torch.where(sampler["deg"][:, None, None],
                       scene.light_pos[:, None, :], out)
