"""Frame renderer: camera rays, depth loop, per-pixel finish.

Port of ``yocto_raytracing_tpu/render/renderer.py``. The reference's
per-pixel recursion (src/raytrace.cpp:213-254) becomes, per chunk of
pixels:

* flat ray ids -> stratified camera rays (``camera.camera_rays``, K2), or
  with ``stochastic`` jittered thin-lens rays
  (``camera.camera_rays_stochastic``, K7);
* with a light sampler (area lights), one shape-space point per (light,
  ray) for the whole path (``lights.sample_light_points``, K8), which K4
  shades with in place of the lights' fixed positions;
* a host loop over depth: nearest hit (``traverse.intersect_scene``, K1),
  shading (``shade.shade_step``, K4) with stacked shadow rays (K1
  any-hit), mirror rays with ``kr`` throughput; it stops at ``max_depth`` or
  when no ray is active. With ``differentiable=True`` the loop keeps the
  autograd graph (K5 and K6 in the backward; K9 and K10 with the
  stochastic modes);
* per-pixel spp sums, or the tonemap to u8 (``pixel_finish``, K3).

Pixels go in scanline order. Each wrapper runs its plain torch version on
CPU tensors and its kernel on CUDA tensors; ``trace_rays(plain=True)`` runs
every stage through its plain version on any device, the reference that the
kernel path is compared with.
"""

from __future__ import annotations

import functools
import math
import os

import numpy as np
import torch

from .. import image as image_mod
from .. import scene as scene_lib
from ..kernels import _build
from ..ops import hit_records
from ..ops import intersect as isect
from ..ops import traverse
from . import camera as camera_mod
from . import lights as lights_mod
from . import shade as shade_mod

RAY_EPS = 1e-4
FLT_MAX = isect.FLT_MAX
INV_GAMMA = 1 / 2.2


def image_width(aspect: float, resolution: int) -> int:
    """round(aspect * resolution), half away from zero (raytrace.cpp:216)."""
    return int(math.floor(aspect * resolution + 0.5))


# --------------------------------------------------------------------------
# K3: per-pixel finish
# --------------------------------------------------------------------------


def pixel_finish_plain(rgb, spp: int, ldr: bool):
    """(npix*spp, 3) f32 per-ray radiance -> (npix, 3) per-pixel sums (f32),
    or with ``ldr`` the tonemapped u8: sum/spp, pow(max(x, 0), 1/2.2), clip
    to [0, 1], * 255, truncate (image.tonemap, exposure 0)."""
    per = rgb.reshape(-1, spp, 3)
    acc = per[:, 0]
    for k in range(1, spp):      # sample order, as the reference accumulates
        acc = acc + per[:, k]
    if not ldr:
        return acc
    x = acc / isect.device_scalar(spp, rgb.device)
    x = torch.pow(torch.clamp(x, min=0.0), INV_GAMMA)
    return (torch.clamp(x, 0.0, 1.0) * 255.0).to(torch.uint8)


def pixel_finish_cuda(rgb, spp: int, ldr: bool):
    """K3 launch: same contract as ``pixel_finish_plain``, CUDA only."""
    dev = rgb.device
    _build.check_tensor("rgb", rgb, torch.float32, (-1, 3), dev)
    if spp < 1 or rgb.shape[0] % spp:
        raise ValueError(f"{rgb.shape[0]} rays are not whole pixels of "
                         f"{spp} samples")
    npix = rgb.shape[0] // spp
    out_sum = torch.empty((0 if ldr else npix, 3), dtype=torch.float32,
                          device=dev)
    out_u8 = torch.empty((npix if ldr else 0, 3), dtype=torch.uint8,
                         device=dev)
    err = _build.library().yrt_pixel_finish(
        _build.ptr(rgb), npix, spp, int(ldr), _build.ptr(out_sum),
        _build.ptr(out_u8), _build.current_stream())
    _build.check_launch(err, "yrt_pixel_finish")
    _build.launches["pixel_finish"] += 1
    return out_u8 if ldr else out_sum


def pixel_finish(rgb, spp: int, ldr: bool):
    """Per-pixel spp sum (and tonemap with ``ldr``). CPU tensors take the
    plain version; CUDA tensors launch K3 (or raise)."""
    if _build.device_kind(rgb) == "cpu":
        return pixel_finish_plain(rgb, spp, ldr)
    return pixel_finish_cuda(rgb, spp, ldr)


# --------------------------------------------------------------------------
# depth loop
# --------------------------------------------------------------------------


def make_occluder(fixed, isect_fn):
    """The shading's shadow query: stacked (L, N) shadow rays -> (L, N)
    bool occlusion, as one flat any-hit query of ``isect_fn`` on the
    detached scene ``fixed``. Inputs are detached: visibility carries no
    gradient."""

    def occluder(p, d, tmin, tmax, mask):
        shape = p.shape[:-1]
        p, d, tmin, tmax = (x.detach() for x in (p, d, tmin, tmax))
        res = isect_fn(fixed, p.reshape(-1, 3).contiguous(),
                       d.reshape(-1, 3).contiguous(), tmin.reshape(-1),
                       torch.where(mask, tmax, -FLT_MAX).reshape(-1),
                       any_hit=True)
        return res["hit"].reshape(shape)

    return occluder


def trace_rays(scene, ray_ids, ambient, width: int, height: int,
               samples: int, max_depth: int, has_kd_textures: bool = True,
               has_ks_textures: bool = True, plain: bool = False,
               differentiable: bool = False, intersect=None,
               stochastic: bool = False, seed: int = 0,
               light_sampler=None):
    """Radiance (N, 3) for a batch of flat ray ids (N,) i32; f32, or the
    scene's float dtype on the plain path.

    Detached-traversal gradients, as in the JAX package: the hit queries
    (nearest and shadow) see a detached scene and detached rays and return
    topology without a graph; shading recomputes every differentiable
    quantity from the scene leaves. With ``differentiable`` the depth loop
    keeps the autograd graph through shading (K5 in the backward on CUDA,
    torch autograd of the plain version on the CPU) and through the loop's
    glue; without it the loop runs under ``torch.no_grad``. The radiance is
    the same bits either way. A step whose batch has no active ray is an
    identity, so the loop stops there (the JAX scan's batch-dead skip).

    ``intersect``, when given, replaces the path's hit query for both the
    nearest and the shadow rays (the signature of
    ``traverse.intersect_scene``): ``kernels.parity`` replays recorded hits
    through it, so that an f64 reference shades the same topology. Without
    it, the CUDA path packs K1's records (``hit_records.pack``) once per
    call, from the leaves as they are now, for both queries.

    ``stochastic``: jittered antialiasing and, where the camera has an
    aperture, thin-lens depth of field, from variates keyed by ray id and
    ``seed`` (so the radiance does not depend on how ids are batched).
    ``light_sampler`` (``lights.build_light_sampler``): area lights, one
    sample point per (light, ray) under ``seed``. Both are differentiable,
    as in the JAX package: through the thin-lens camera into every camera
    leaf and ``cam_aperture`` (K9 on CUDA), and through the light points
    into ``pos`` and ``light_pos`` (K5 with per-ray lights, then K10); the
    per-ray light positions' gradient is summed over the bounces by
    autograd.
    """
    if plain:
        cam_fn = (camera_mod.camera_rays_stochastic_plain if stochastic
                  else camera_mod.camera_rays_plain)
        light_fn = lights_mod.sample_light_points_plain
        isect_fn = traverse.intersect_scene_plain
        shade_fn = shade_mod.shade_step_plain
    else:
        cam_fn = (camera_mod.camera_rays_stochastic if stochastic
                  else camera_mod.camera_rays)
        light_fn = lights_mod.sample_light_points
        isect_fn = traverse.intersect_scene
        shade_fn = shade_mod.shade_step
    if stochastic:
        cam_fn = functools.partial(cam_fn, seed=seed)
    # under no_grad unless differentiable (and grad mode is on)
    with torch.set_grad_enabled(differentiable and torch.is_grad_enabled()):
        _, ro, rd = cam_fn(scene, ray_ids, width, height, samples)
        fixed = scene_lib.detached(scene)
        if intersect is not None:
            isect_fn = intersect
        elif not plain and _build.device_kind(ro) == "cuda":
            # K1's packed records, once for the nearest and shadow queries
            isect_fn = functools.partial(traverse.intersect_scene,
                                         records=hit_records.pack(fixed))
        occluder = make_occluder(fixed, isect_fn)
        n = ro.shape[0]
        dev = ro.device
        tmin = torch.full((n,), RAY_EPS, dtype=torch.float32, device=dev)
        acc = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        thr = torch.ones((n, 3), dtype=torch.float32, device=dev)
        active = torch.ones(n, dtype=torch.bool, device=dev)
        # area lights: ONE sample per (light, ray) for the whole path, as
        # in JAX. The loop never compacts lanes, so lane i of this (L, N, 3)
        # buffer stays ray i at every bounce; a loop that compacts live
        # lanes must carry the buffer along with the rays.
        light_pos = (None if light_sampler is None
                     else light_fn(scene, light_sampler, ray_ids, seed))
        for _ in range(max_depth):
            if not bool(active.any()):
                break
            hits = isect_fn(fixed, ro.detach(), rd.detach(), tmin,
                            torch.where(active, FLT_MAX, -FLT_MAX))
            color, kr, p, refl_dir, mask = shade_fn(
                scene, ro, rd, hits, ambient, active, occluder,
                has_kd_textures=has_kd_textures,
                has_ks_textures=has_ks_textures, light_pos=light_pos)
            acc = acc + thr * color
            cont = mask & (kr > 0).any(dim=-1)
            thr = torch.where(cont[:, None], thr * kr, thr)
            # dead lanes get a constant ray; their shading is masked out
            ro = torch.where(cont[:, None], p, 0.0).contiguous()
            rd = torch.where(cont[:, None], refl_dir, 1.0).contiguous()
            active = cont
        return acc


# --------------------------------------------------------------------------
# frame
# --------------------------------------------------------------------------


def render_image(scene, meta, width: int, height: int, samples: int,
                 ambient: float = 0.1, max_depth: int = 8,
                 chunk_pixels: int = 1 << 15,
                 ldr: bool = False, stochastic: bool = False, seed: int = 0,
                 light_sampler=None, checkpoint: str | None = None
                 ) -> np.ndarray:
    """Full frame -> (height, width, 4) f32 linear with alpha 1, or with
    ``ldr`` the tonemapped (height, width, 4) u8 with alpha 255.

    Pixels are rendered in scanline order, ``chunk_pixels`` at a time, on
    the scene's device; the tail chunk's extra lanes repeat the last ray
    and are dropped. ``stochastic``, ``seed`` and ``light_sampler`` as in
    ``trace_rays``: the frame is a function of the seed, the same for any
    ``chunk_pixels``.

    ``checkpoint``: path of a snapshot of the per-pixel sums, written after
    every chunk (write, then rename). If it exists and was written under
    the same configuration (every knob that changes pixels), its pixels are
    kept and the render resumes after them. With ``ldr`` the checkpointed
    path tonemaps on the host (``image.tonemap``), so a frame resumed from
    any snapshot is the uninterrupted one bit for bit; without a
    checkpoint, K3 tonemaps on the device (within 1 u8 step of the host).
    """
    spp = samples * samples
    npix = width * height
    dev = scene.device
    amb = torch.full((3,), ambient, dtype=torch.float32, device=dev)
    chunk_pixels = min(chunk_pixels, npix)
    device_ldr = ldr and not checkpoint
    # the scene does not change during the frame: K1's records once for all
    # its chunks (trace_rays would pack them per chunk)
    isect = (functools.partial(
        traverse.intersect_scene,
        records=hit_records.pack(scene_lib.detached(scene)))
        if dev.type == "cuda" else None)
    out = np.empty((npix, 3), np.uint8 if device_ldr else np.float32)
    done = 0
    if checkpoint:
        # every knob that changes per-chunk pixel values is in the key, or
        # a resume mixes chunks rendered under different settings (ambient
        # is f32; its bit pattern keys exactly)
        cfg_key = np.asarray(
            [width, height, samples, max_depth, chunk_pixels,
             int(stochastic), seed, int(light_sampler is not None),
             int(np.float32(ambient).view(np.int32))], np.int64)
        if os.path.exists(checkpoint):
            with np.load(checkpoint) as snap:
                if (snap["key"].shape == cfg_key.shape
                        and (snap["key"] == cfg_key).all()):
                    done = int(snap["done"])
                    out[:done] = snap["acc"]
    for start in range(done, npix, chunk_pixels):
        stop = min(start + chunk_pixels, npix)
        ids = torch.arange(start * spp, (start + chunk_pixels) * spp,
                           dtype=torch.int32, device=dev)
        ids = torch.clamp(ids, max=npix * spp - 1)
        rgb = trace_rays(scene, ids, amb, width, height, samples, max_depth,
                         has_kd_textures=meta.has_kd_textures,
                         has_ks_textures=meta.has_ks_textures,
                         intersect=isect, stochastic=stochastic, seed=seed,
                         light_sampler=light_sampler)
        px = pixel_finish(rgb.contiguous(), spp, device_ldr)
        out[start:stop] = px[:stop - start].cpu().numpy()
        if checkpoint:
            _atomic_savez(checkpoint, key=cfg_key, done=stop, acc=out[:stop])
    if device_ldr:
        img = np.full((npix, 4), 255, np.uint8)
        img[:, :3] = out
        return img.reshape(height, width, 4)
    img = np.ones((npix, 4), np.float32)
    img[:, :3] = out / np.float32(spp)
    img = img.reshape(height, width, 4)
    if ldr:
        return image_mod.tonemap(img)
    return img


def _atomic_savez(path: str, **arrays) -> None:
    """Write-then-rename, so a killed render never leaves a torn snapshot."""
    tmp = path + ".tmp.npz"   # the .npz suffix stops np.savez renaming it
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


INTERSECTORS = ("stream", "bvh")


def check_intersector(name: str) -> None:
    """Raise ValueError unless ``name`` is one of the JAX package's hit
    queries, "stream" (its cluster scan) or "bvh" (its BVH walk). The two
    give the same answers, and both run K1 here."""
    if name not in INTERSECTORS:
        raise ValueError(f"intersector must be one of {INTERSECTORS}, not "
                         f"{name!r}")


def render_scene_file(path: str, resolution: int = 720, samples: int = 1,
                      ambient: float = 0.1, camera: int = 0,
                      max_depth: int = 8, chunk_pixels: int = 1 << 15,
                      intersector: str = "stream",
                      stochastic: bool = False, seed: int = 0,
                      area_lights: bool = False, *, device="cuda",
                      ldr: bool = False):
    """Load + render, mirroring the reference main() (raytrace.cpp:256-287).

    ``device`` is where the scene lives and the frame is rendered: the card
    unless the caller asks for "cpu"; "cuda" raises when no card is
    present. ``intersector``: "stream" or "bvh" (``check_intersector``).
    ``stochastic`` (jittered AA + thin-lens DOF), ``seed`` and
    ``area_lights`` (soft shadows from the emissive shapes' elements) are
    the JAX package's stochastic modes.
    Returns (image, host scene, TorchScene, meta); the image is f32 HDR, or
    u8 with ``ldr``.
    """
    check_intersector(intersector)
    host = scene_lib.load_scene(path)
    leaves, meta = scene_lib.build_device_scene(host, camera=camera)
    tscene = scene_lib.to_torch(leaves, device)
    sampler = (lights_mod.build_light_sampler(host, leaves, meta, device)
               if area_lights else None)
    width = image_width(host.cameras[camera].aspect, resolution)
    img = render_image(tscene, meta, width, resolution, samples,
                       ambient=ambient, max_depth=max_depth,
                       chunk_pixels=chunk_pixels, ldr=ldr,
                       stochastic=stochastic, seed=seed,
                       light_sampler=sampler)
    return img, host, tscene, meta
