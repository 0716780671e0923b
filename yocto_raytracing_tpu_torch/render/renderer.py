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
* a loop over depth: nearest hit (``traverse.intersect_scene``, K1),
  shading (``shade.shade_step``, K4) with stacked shadow rays (K1
  any-hit), mirror rays with ``kr`` throughput (``bounce_update_plain``);
  it stops at ``max_depth`` or when no ray is active. With
  ``differentiable=True`` the loop keeps the autograd graph (K5 and K6 in
  the backward; K9 and K10 with the stochastic modes);
* per-pixel spp sums, or the tonemap to u8 (``pixel_finish``, K3).

Two loops run the frame. ``frame_eager`` runs ``trace_rays`` chunk by
chunk with the depth loop on the host (a sync a bounce, a copy to the host
a chunk): the checkpointed frame, ``trace_rays`` itself and the sharded
paths. ``frame_device``, the port of the JAX package's
``_render_chunks_fused`` and its device loop over depth, runs a frame on
the card without a host sync: ray ids from a device chunk index, a fixed
``max_depth`` of bounces whose launches read a device alive word and
return at once when no ray is active (K12, ``bounce_update``, sets it),
each chunk's pixels written in place into one frame buffer by K3, and one
CUDA graph of a chunk replayed over the frame; ``render_image`` takes it
without ``checkpoint`` (on the CPU through the plain versions, a chunk at a
time). The frames are the same bits.

Pixels go in scanline order. Each wrapper runs its plain torch version on
CPU tensors and its kernel on CUDA tensors; ``trace_rays(plain=True)`` runs
every stage through its plain version on any device, the reference that the
kernel path is compared with.
"""

from __future__ import annotations

import functools
import math
import os
import time

import numpy as np
import torch

from .. import image as image_mod
from .. import scene as scene_lib
from ..kernels import _build
from ..ops import hit_records
from ..ops import intersect as isect
from ..ops import shade_records as shade_records_lib
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


def pixel_finish_cuda(rgb, spp: int, ldr: bool, out=None, chunk=None):
    """K3 launch: same contract as ``pixel_finish_plain``, CUDA only.

    With ``out`` (a frame buffer of (rows, 3), u8 with ``ldr``, else f32)
    and ``chunk`` (a (1,) i32 device chunk index), K3 writes the npix
    pixels into ``out``'s rows chunk * npix.., reading the index on the
    card, and returns ``out``."""
    dev = rgb.device
    _build.check_tensor("rgb", rgb, torch.float32, (-1, 3), dev)
    if spp < 1 or rgb.shape[0] % spp:
        raise ValueError(f"{rgb.shape[0]} rays are not whole pixels of "
                         f"{spp} samples")
    npix = rgb.shape[0] // spp
    if (out is None) != (chunk is None):
        raise ValueError("out and chunk go together")
    dtype = torch.uint8 if ldr else torch.float32
    if out is None:
        out = torch.empty((npix, 3), dtype=dtype, device=dev)
    else:
        _build.check_tensor("out", out, dtype, (-1, 3), dev)
        _build.check_tensor("chunk", chunk, torch.int32, (1,), dev)
        if out.shape[0] % npix:
            raise ValueError(f"out: {out.shape[0]} rows are not whole "
                             f"chunks of {npix} pixels")
    ptr = _build.ptr
    err = _build.library().yrt_pixel_finish(
        ptr(rgb), npix, spp, int(ldr), None if ldr else ptr(out),
        ptr(out) if ldr else None, None if chunk is None else ptr(chunk),
        _build.current_stream())
    _build.check_launch(err, "yrt_pixel_finish")
    _build.launches["pixel_finish"] += 1
    return out


def pixel_finish(rgb, spp: int, ldr: bool, out=None, chunk=None):
    """Per-pixel spp sum (and tonemap with ``ldr``); with ``out`` and
    ``chunk`` written into a frame buffer at the chunk's rows, as
    ``pixel_finish_cuda`` says. CPU tensors take the plain version; CUDA
    tensors launch K3 (or raise)."""
    if _build.device_kind(rgb) == "cuda":
        return pixel_finish_cuda(rgb, spp, ldr, out, chunk)
    px = pixel_finish_plain(rgb, spp, ldr)
    if out is None:
        return px
    row = int(chunk) * px.shape[0]
    out[row:row + px.shape[0]] = px
    return out


# --------------------------------------------------------------------------
# K12: a bounce's state update
# --------------------------------------------------------------------------


def bounce_update_plain(acc, thr, color, kr, p, refl_dir, mask):
    """The depth loop's state after a bounce (the JAX body's update,
    renderer.py:297-304): (acc, thr, ro, rd, cont). ``cont``, the lanes
    that go on (a hit and some ``kr > 0``), is the next bounce's
    ``active``; dead lanes get a constant ray (0, 1), as their shading is
    masked out."""
    acc = acc + thr * color
    cont = mask & (kr > 0).any(dim=-1)
    thr = torch.where(cont[:, None], thr * kr, thr)
    ro = torch.where(cont[:, None], p, 0.0).contiguous()
    rd = torch.where(cont[:, None], refl_dir, 1.0).contiguous()
    return acc, thr, ro, rd, cont


def bounce_update_cuda(acc, thr, ro, rd, tmax, color, kr, p, refl_dir, mask,
                       alive_in=None, alive_out=None) -> None:
    """K12 launch, CUDA only: ``bounce_update`` in place."""
    n = acc.shape[0]
    dev = acc.device
    f32 = torch.float32
    check = _build.check_tensor
    for name, t in (("acc", acc), ("thr", thr), ("ro", ro), ("rd", rd),
                    ("color", color), ("kr", kr), ("p", p),
                    ("refl_dir", refl_dir)):
        check(name, t, f32, (n, 3), dev)
    check("tmax", tmax, f32, (n,), dev)
    check("mask", mask, torch.bool, (n,), dev)
    for name, t in (("alive_in", alive_in), ("alive_out", alive_out)):
        if t is not None:
            check(name, t, torch.int32, (1,), dev)
    ptr = _build.ptr
    err = _build.library().yrt_bounce(
        ptr(color), ptr(kr), ptr(p), ptr(refl_dir), ptr(mask), n, ptr(acc),
        ptr(thr), ptr(ro), ptr(rd), ptr(tmax),
        None if alive_in is None else ptr(alive_in),
        None if alive_out is None else ptr(alive_out),
        _build.current_stream())
    _build.check_launch(err, "yrt_bounce")
    _build.launches["bounce"] += 1


def bounce_update(acc, thr, ro, rd, tmax, color, kr, p, refl_dir, mask,
                  alive_in=None, alive_out=None) -> None:
    """``bounce_update_plain`` in place on the device loop's state (acc,
    thr, ro, rd (N, 3) f32; tmax (N,) f32, the next nearest-hit query's:
    FLT_MAX on the lanes that go on, else -FLT_MAX), from one bounce's
    shading (color, kr, p, refl_dir (N, 3) f32, mask (N,) bool).

    ``alive_in`` and ``alive_out`` are (1,) i32 words (or None): where
    ``alive_in`` is 0 nothing is written (the bounce is dead), else
    ``alive_out`` is set to 1 if any lane goes on. CPU tensors take the
    plain version; CUDA tensors launch K12 (or raise)."""
    if _build.device_kind(acc) == "cuda":
        bounce_update_cuda(acc, thr, ro, rd, tmax, color, kr, p, refl_dir,
                           mask, alive_in, alive_out)
        return
    if alive_in is not None and not bool(alive_in):
        return
    new = bounce_update_plain(acc, thr, color, kr, p, refl_dir, mask)
    cont = new[-1]
    for dst, src in zip((acc, thr, ro, rd), new):
        dst.copy_(src)
    tmax.copy_(torch.where(cont, FLT_MAX, -FLT_MAX))
    if alive_out is not None and bool(cont.any()):
        alive_out.fill_(1)


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
               light_sampler=None, shade_records=None):
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
    call, from the leaves as they are now, for both queries. Likewise the
    shading's records (``shade_records.pack``, K4 and K5), unless the caller
    gives ``shade_records`` packed from the same leaves.

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
        if not plain and _build.device_kind(ro) == "cuda":
            # K4's and K5's records, once for every bounce
            shade_fn = functools.partial(
                shade_fn, records=(shade_records_lib.pack(scene)
                                   if shade_records is None
                                   else shade_records))
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
            acc, thr, ro, rd, active = bounce_update_plain(
                acc, thr, color, kr, p, refl_dir, mask)
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

    Without ``checkpoint`` the frame runs as ``frame_device``: on CUDA a
    CUDA graph of a chunk, replayed over the frame, with no host sync and
    one copy to the host. With ``checkpoint`` it runs as ``frame_eager``;
    the pixels are the same bits.

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
    device_ldr = ldr and not checkpoint
    args = (scene, meta, width, height, samples, ambient, max_depth,
            chunk_pixels, device_ldr, stochastic, seed, light_sampler)
    if not checkpoint:
        out = to_host(frame_device(*args)[:npix])
    else:
        out = frame_eager(*args, checkpoint=checkpoint)
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


def frame_eager(scene, meta, width: int, height: int, samples: int,
                ambient: float = 0.1, max_depth: int = 8,
                chunk_pixels: int = 1 << 15, ldr: bool = False,
                stochastic: bool = False, seed: int = 0, light_sampler=None,
                checkpoint: str | None = None) -> np.ndarray:
    """The frame's (npix, 3) per-pixel sums (f32), or with ``ldr`` K3's u8
    tonemap, on the host: ``trace_rays`` and ``pixel_finish`` chunk by
    chunk, each chunk copied to the host, with ``render_image``'s
    ``checkpoint`` (which resumes after a snapshot's pixels)."""
    spp = samples * samples
    npix = width * height
    dev = scene.device
    amb = torch.full((3,), ambient, dtype=torch.float32, device=dev)
    chunk_pixels = min(chunk_pixels, npix)
    # the scene does not change during the frame: K1's and K4's records once
    # for all its chunks (trace_rays would pack them per chunk)
    isect = (functools.partial(
        traverse.intersect_scene,
        records=hit_records.pack(scene_lib.detached(scene)))
        if dev.type == "cuda" else None)
    srec = shade_records_lib.pack(scene) if dev.type == "cuda" else None
    out = np.empty((npix, 3), np.uint8 if ldr else np.float32)
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
                         light_sampler=light_sampler, shade_records=srec)
        px = pixel_finish(rgb.contiguous(), spp, ldr)
        out[start:stop] = px[:stop - start].cpu().numpy()
        if checkpoint:
            _atomic_savez(checkpoint, key=cfg_key, done=stop, acc=out[:stop])
    return out


def frame_device(scene, meta, width: int, height: int, samples: int,
                 ambient: float = 0.1, max_depth: int = 8,
                 chunk_pixels: int = 1 << 15, ldr: bool = False,
                 stochastic: bool = False, seed: int = 0,
                 light_sampler=None) -> torch.Tensor:
    """The frame's per-pixel sums (f32), or with ``ldr`` K3's u8 tonemap,
    as a (chunks * chunk_pixels, 3) tensor on the scene's device: rows past
    width * height repeat the last pixel (the caller drops them). The same
    bits as ``frame_eager``.

    The port of the JAX package's ``_render_chunks_fused`` (its
    ``lax.map`` over chunks, ray ids from ``lax.iota``) and of
    ``trace_rays``' device loop over depth (renderer.py:113-163, 337-353).
    A chunk is: ray ids from a device chunk index (clamped to the last
    ray); camera rays (K2, or K7 with ``stochastic``); with a light sampler
    the light points (K8), one set for every bounce; ``max_depth`` bounces,
    each K1 nearest, K4 prep, K1 any hit, K4 finish and K12, every launch
    reading the bounce's alive word and writing nothing when it is 0
    (``bounce_update``), so a bounce with no active ray is the identity and
    the fixed depth gives the bits of ``trace_rays``' early break; K3 into
    the chunk's rows; the chunk index advanced. Nothing in it waits on the
    host, and on CUDA nothing in it allocates: every buffer is made once,
    before chunk 0, and written in place. On CUDA chunk 0 runs eagerly (it
    loads every kernel), the next is captured into a CUDA graph
    (``torch.cuda.CUDAGraph``, for this call only), and the graph is
    replayed for every chunk after the first; the launch counts gain the
    captured launches once per replay. On the CPU the chunks run one after
    another through the plain versions, a dead bounce skipped whole on the
    host.

    Each chunk copies its alive words into a row of a (chunks, max_depth +
    1) record, which the frame leaves with ``kernels._build.note_frame``
    (``kernels.last_frame``), with the host's milliseconds in the set-up,
    chunk 0, the capture and the replays (enqueue time: nothing here waits
    for the card); on CUDA the frame's dead bounces join the device tally
    that ``kernels.skipped_launches`` reads.
    """
    t0 = time.perf_counter()
    spp = samples * samples
    npix = width * height
    dev = scene.device
    cuda = dev.type == "cuda"
    chunk_pixels = min(chunk_pixels, npix)
    n_chunks = -(-npix // chunk_pixels)
    n = chunk_pixels * spp
    i32, f32 = torch.int32, torch.float32
    kd_tex, ks_tex = meta.has_kd_textures, meta.has_ks_textures
    nl = scene.light_ke.shape[0]
    fixed = scene_lib.detached(scene)
    # what the chunks share, made before the first: the graph bakes their
    # pointers in, and a capture that allocates nothing takes no memory of
    # its own
    amb = torch.full((3,), ambient, dtype=f32, device=dev)
    lane = torch.arange(n, dtype=i32, device=dev)
    tmin = torch.full((n,), RAY_EPS, dtype=f32, device=dev)
    chunk = torch.zeros((1,), dtype=i32, device=dev)
    out = torch.empty((n_chunks * chunk_pixels, 3),
                      dtype=torch.uint8 if ldr else f32, device=dev)
    ids = torch.empty((n,), dtype=i32, device=dev)
    acc = torch.empty((n, 3), dtype=f32, device=dev)
    thr = torch.empty((n, 3), dtype=f32, device=dev)
    tmax = torch.empty((n,), dtype=f32, device=dev)
    alive = torch.empty((max_depth + 1,), dtype=i32, device=dev)
    ran = torch.empty((n_chunks, max_depth + 1), dtype=i32, device=dev)
    row = torch.zeros((1,), dtype=torch.int64, device=dev)   # ran's index
    if cuda:
        hrec = hit_records.pack(fixed)
        srec = shade_records_lib.pack(scene)
        h, w = camera_mod.camera_frame(scene)
        rays = [torch.empty((n, k), dtype=f32, device=dev) for k in (2, 3, 3)]
        points = (None if light_sampler is None else
                  torch.empty((nl, n, 3), dtype=f32, device=dev))
        bufs = shade_mod.forward_buffers(nl, n, dev)

        def hit_buffers(m):
            return dict(hit=torch.empty(m, dtype=torch.bool, device=dev),
                        inst=torch.empty(m, dtype=i32, device=dev),
                        prim=torch.empty(m, dtype=i32, device=dev),
                        t=torch.empty(m, dtype=f32, device=dev))

        hits_near, hits_any = hit_buffers(n), hit_buffers(nl * n)
    else:
        cam_fn = (camera_mod.camera_rays_stochastic_plain if stochastic
                  else camera_mod.camera_rays_plain)
        if stochastic:
            cam_fn = functools.partial(cam_fn, seed=seed)
        plain_occluder = make_occluder(fixed, traverse.intersect_scene_plain)

    def device_occluder(word):
        # K4 prep writes tmax = -FLT_MAX on the masked lanes' shadow rays,
        # so make_occluder's where(mask, tmax, -FLT_MAX) is the identity here
        def occluder(p, d, tmin_, tmax_, mask):
            res = traverse.intersect_scene_cuda(
                fixed, p.reshape(-1, 3), d.reshape(-1, 3), tmin_.reshape(-1),
                tmax_.reshape(-1), any_hit=True, records=hrec, alive=word,
                out=hits_any)
            return res["hit"].reshape(p.shape[:-1])
        return occluder

    def camera_cuda():
        if stochastic:
            return camera_mod.camera_rays_stochastic_launch(
                ids, scene.cam_axes, scene.cam_o, h, w, scene.cam_focus,
                scene.cam_aperture, width, height, samples, seed, out=rays)
        return camera_mod.camera_rays_launch(
            ids, scene.cam_axes, scene.cam_o, h, w, scene.cam_focus, width,
            height, samples, out=rays)

    def run_chunk():
        torch.add(lane, chunk, alpha=n, out=ids).clamp_(max=npix * spp - 1)
        if cuda:
            _, ro, rd = camera_cuda()
            light_pos = points
            if light_sampler is not None:
                lights_mod.light_points_launch(scene, light_sampler, ids,
                                               seed, scene.pos,
                                               scene.light_pos, light_pos)
        else:
            _, ro, rd = cam_fn(scene, ids, width, height, samples)
            ro, rd = ro.contiguous(), rd.contiguous()
            light_pos = (None if light_sampler is None else
                         lights_mod.sample_light_points_plain(
                             scene, light_sampler, ids, seed))
        acc.zero_()
        thr.fill_(1.0)
        tmax.fill_(FLT_MAX)
        alive.zero_()
        alive[:1].fill_(1)
        for k in range(max_depth):
            word = alive[k:k + 1]
            if cuda:
                # the mask is the hit flag: dead lanes ask with tmax < tmin
                hits = traverse.intersect_scene_cuda(
                    fixed, ro, rd, tmin, tmax, records=hrec, alive=word,
                    out=hits_near)
                color, kr, p, refl = shade_mod.shade_bounce_cuda(
                    scene, ro, rd, hits, amb, device_occluder(word), word,
                    kd_tex, ks_tex, light_pos, srec, bufs)
            else:
                if not bool(word):   # the card reads the word per launch
                    continue
                hits = traverse.intersect_scene_plain(fixed, ro, rd, tmin,
                                                      tmax)
                color, kr, p, refl, _ = shade_mod.shade_step_plain(
                    scene, ro, rd, hits, amb, hits["hit"], plain_occluder,
                    kd_tex, ks_tex, light_pos)
            bounce_update(acc, thr, ro, rd, tmax, color, kr, p, refl,
                          hits["hit"], word, alive[k + 1:k + 2])
        ran.index_copy_(0, row, alive[None])
        row.add_(1)
        pixel_finish(acc, spp, ldr, out=out, chunk=chunk)
        chunk.add_(1)

    marks = [t0, time.perf_counter()]
    with torch.no_grad():
        run_chunk()
        marks.append(time.perf_counter())
        if n_chunks > 1 and cuda:
            marks.append(_replay(run_chunk, n_chunks - 1))
        else:
            marks.append(marks[-1])   # no capture
            for _ in range(n_chunks - 1):
                run_chunk()
    marks.append(time.perf_counter())
    _build.note_frame(ran, nl > 0, dict(zip(
        ("setup", "chunk0", "capture", "replay"), np.diff(marks) * 1e3)))
    return out


def to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor on the host as numpy; from the card in one copy into
    page-locked memory (torch caches it): a fresh pageable buffer pays its
    page faults in the copy."""
    if t.device.type == "cpu":
        return t.numpy()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return out.copy_(t).numpy()


def _replay(run_chunk, times: int) -> float:
    """Capture one call of ``run_chunk`` into a CUDA graph and replay it
    ``times`` times on the current stream. The capture runs on a stream of
    its own and waits for nothing: it only records. The launch counts gain
    the captured launches once per replay. Returns the host clock at the
    end of the capture."""
    before = dict(_build.launches)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(torch.cuda.Stream()):
        graph.capture_begin()
        try:
            run_chunk()
        finally:
            graph.capture_end()
    captured = {k: v - before[k] for k, v in _build.launches.items()}
    done = time.perf_counter()
    for _ in range(times):
        graph.replay()
    for k, v in captured.items():   # the capture counted one
        _build.launches[k] += v * (times - 1)
    return done


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
