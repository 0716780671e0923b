"""The sampled frame's depth loop, plain torch: the benchmark's frozen copy.

``radiance`` of ``ref/render.py`` (the depth loop of the port's
``trace_rays`` with ``plain=True`` at commit 2bec3df) with area lights:
each ray carries ONE shape-space point on each light (``ref/lights.py``),
the same for every bounce, which ``ref/shade.py::shade_step_plain`` shades
in place of the lights' fixed positions (``light_pos=``). The code is
``radiance``'s but for that argument, so the walk's work on the sampled
shadow rays is counted as there (``stats``).
"""

from __future__ import annotations

import torch

from . import shade as shade_mod
from . import walk
from .render import FLT_MAX, RAY_EPS, bounce_update_plain, detached, \
    make_occluder


def radiance(scene, ro, rd, light_pos, ambient, max_depth: int,
             has_kd_textures: bool = True, has_ks_textures: bool = True,
             stats=None):
    """Radiance (N, 3) of rays (ro, rd) whose light points are
    ``light_pos`` (L, N, 3), in the scene's float dtype. The loop stops at
    the first bounce with no active ray. ``stats``, when given (a dict),
    gains under "nearest" and "any" the walk's work on the live lanes of
    every nearest-hit and every shadow query, their live lanes ("rays")
    and their hits ("hits"), as ``render.radiance`` counts them."""

    def isect_fn(sc, ro, rd, tmin, tmax, any_hit=False):
        if stats is None:
            return walk.intersect_scene_plain(sc, ro, rd, tmin, tmax, any_hit)
        live = tmax >= tmin
        counts = stats.setdefault("any" if any_hit else "nearest", {})
        out = walk.intersect_scene_plain(
            sc, ro[live], rd[live], tmin[live], tmax[live], any_hit,
            stats=counts)
        counts["rays"] = counts.get("rays", 0) + int(live.sum())
        counts["hits"] = counts.get("hits", 0) + int(out["hit"].sum())
        none = torch.full(live.shape, -1, dtype=torch.int32,
                          device=live.device)
        full = dict(hit=torch.zeros_like(live), inst=none,
                    prim=none.clone(), t=tmax.clone())
        for k, v in out.items():
            full[k][live] = v
        return full

    with torch.no_grad():
        fixed = detached(scene)
        occluder = make_occluder(fixed, isect_fn)
        n = ro.shape[0]
        dev = ro.device
        dt = scene.pos.dtype
        tmin = torch.full((n,), RAY_EPS, dtype=dt, device=dev)
        acc = torch.zeros((n, 3), dtype=dt, device=dev)
        thr = torch.ones((n, 3), dtype=dt, device=dev)
        active = torch.ones(n, dtype=torch.bool, device=dev)
        for _ in range(max_depth):
            if not bool(active.any()):
                break
            hits = isect_fn(fixed, ro, rd, tmin,
                            torch.where(active, FLT_MAX, -FLT_MAX).to(dt))
            color, kr, p, refl_dir, mask = shade_mod.shade_step_plain(
                scene, ro, rd, hits, ambient, active, occluder,
                has_kd_textures=has_kd_textures,
                has_ks_textures=has_ks_textures, light_pos=light_pos)
            acc, thr, ro, rd, active = bounce_update_plain(
                acc, thr, color, kr, p, refl_dir, mask)
        return acc
