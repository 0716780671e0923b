"""The frame and the training loss, plain torch: the benchmark's frozen copy.

Copied from yocto_raytracing_tpu_torch/render/renderer.py at commit
2bec3df (``image_width``, ``pixel_finish_plain``,
``bounce_update_plain``, ``make_occluder`` and ``trace_rays`` with
``plain=True``, deterministic camera and point lights) and
parallel/mesh.py (``render_loss``), code unchanged but for the buffers'
float dtype, which follows the scene leaves', and for ``trace_rays``'
depth loop, which is ``radiance`` of rays given, so that rays of many
camera poses share one loop. Every stage is the reference's plain
version: camera rays (``ref.camera``), the BVH walk (``ref.walk``, with
``stats`` to count its work), shading (``ref.shade``), the bounce
update, the per-pixel sum and tonemap.
"""

from __future__ import annotations

import math

import torch

from . import camera as camera_mod
from . import intersect as isect
from . import shade as shade_mod
from . import walk

RAY_EPS = 1e-4
FLT_MAX = isect.FLT_MAX
INV_GAMMA = 1 / 2.2


def image_width(aspect: float, resolution: int) -> int:
    """round(aspect * resolution), half away from zero (raytrace.cpp:216)."""
    return int(math.floor(aspect * resolution + 0.5))


def pixel_finish_plain(rgb, spp: int, ldr: bool):
    """(npix*spp, 3) per-ray radiance -> (npix, 3) per-pixel sums, or with
    ``ldr`` the tonemapped u8: sum/spp, pow(max(x, 0), 1/2.2), clip to
    [0, 1], * 255, truncate (image.tonemap, exposure 0)."""
    per = rgb.reshape(-1, spp, 3)
    acc = per[:, 0]
    for k in range(1, spp):      # sample order, as the reference accumulates
        acc = acc + per[:, k]
    if not ldr:
        return acc
    x = acc / isect.device_scalar(spp, rgb.device)
    x = torch.pow(torch.clamp(x, min=0.0), INV_GAMMA)
    return (torch.clamp(x, 0.0, 1.0) * 255.0).to(torch.uint8)


def bounce_update_plain(acc, thr, color, kr, p, refl_dir, mask):
    """The depth loop's state after a bounce: (acc, thr, ro, rd, cont).
    ``cont``, the lanes that go on (a hit and some ``kr > 0``), is the next
    bounce's ``active``; dead lanes get a constant ray (0, 1)."""
    acc = acc + thr * color
    cont = mask & (kr > 0).any(dim=-1)
    thr = torch.where(cont[:, None], thr * kr, thr)
    ro = torch.where(cont[:, None], p, 0.0).contiguous()
    rd = torch.where(cont[:, None], refl_dir, 1.0).contiguous()
    return acc, thr, ro, rd, cont


def make_occluder(fixed, isect_fn):
    """The shading's shadow query: stacked (L, N) shadow rays -> (L, N)
    bool occlusion, one flat any-hit query of ``isect_fn`` on the detached
    scene ``fixed``. Inputs are detached: visibility carries no gradient."""

    def occluder(p, d, tmin, tmax, mask):
        shape = p.shape[:-1]
        p, d, tmin, tmax = (x.detach() for x in (p, d, tmin, tmax))
        res = isect_fn(fixed, p.reshape(-1, 3).contiguous(),
                       d.reshape(-1, 3).contiguous(), tmin.reshape(-1),
                       torch.where(mask, tmax, -isect.far(tmax)).reshape(-1),
                       any_hit=True)
        return res["hit"].reshape(shape)

    return occluder


def detached(scene):
    """The same leaves, detached from any autograd graph: what the hit
    queries see (detached-traversal gradients)."""
    return type(scene)(**{k: v.detach() for k, v in vars(scene).items()})


def trace_rays(scene, ray_ids, ambient, width: int, height: int,
               samples: int, max_depth: int, has_kd_textures: bool = True,
               has_ks_textures: bool = True, differentiable: bool = False,
               stats=None):
    """Radiance (N, 3) for a batch of flat ray ids (N,) i32, in the scene's
    float dtype: the camera's rays, then ``radiance``."""
    with torch.set_grad_enabled(differentiable and torch.is_grad_enabled()):
        _, ro, rd = camera_mod.camera_rays_plain(scene, ray_ids, width,
                                                 height, samples)
        return radiance(scene, ro, rd, ambient, max_depth, has_kd_textures,
                        has_ks_textures, differentiable, stats)


def radiance(scene, ro, rd, ambient, max_depth: int,
             has_kd_textures: bool = True, has_ks_textures: bool = True,
             differentiable: bool = False, stats=None):
    """Radiance (N, 3) of rays (ro, rd), in the scene's float dtype: the
    depth loop of ``trace_rays``, which the frames of many camera poses
    share. Detached-traversal gradients: the hit queries see a detached
    scene and return topology; shading recomputes every differentiable
    quantity from the leaves. The loop stops at the first bounce with no
    active ray.

    ``stats``, when given (a dict), gains under "nearest" and "any" the
    walk's work on the live lanes of every nearest-hit and every shadow
    query (``walk.intersect_scene_plain``'s counts), their live lanes
    ("rays") and their hits ("hits"): a dead lane asks for no test."""

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

    with torch.set_grad_enabled(differentiable and torch.is_grad_enabled()):
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
            hits = isect_fn(fixed, ro.detach(), rd.detach(), tmin,
                            torch.where(active, FLT_MAX, -FLT_MAX).to(dt))
            color, kr, p, refl_dir, mask = shade_mod.shade_step_plain(
                scene, ro, rd, hits, ambient, active, occluder,
                has_kd_textures=has_kd_textures,
                has_ks_textures=has_ks_textures)
            acc, thr, ro, rd, active = bounce_update_plain(
                acc, thr, color, kr, p, refl_dir, mask)
        return acc


def render_loss(scene, ray_ids, target_rgb, ambient, *, width: int,
                height: int, samples: int, max_depth: int,
                has_kd_textures: bool = True, has_ks_textures: bool = True):
    """Mean-squared error between the rendered radiance of ``ray_ids`` and
    ``target_rgb`` (N, 3), differentiable in every float leaf."""
    rgb = trace_rays(scene, ray_ids, ambient, width, height, samples,
                     max_depth, has_kd_textures, has_ks_textures,
                     differentiable=True)
    return torch.mean((rgb - target_rgb) ** 2)
