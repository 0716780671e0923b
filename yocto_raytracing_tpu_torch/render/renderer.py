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
``max_depth`` of bounces, each after the first in a conditional IF node
that K12 (``bounce_update``) sets where a ray goes on, so a bounce with no
active ray launches nothing, each chunk's pixels written in place into one
frame buffer by K3, and one CUDA graph of a chunk, kept across calls of
one configuration and replayed over the frame; ``render_image`` takes it
without ``checkpoint`` (on the CPU through the plain versions, a chunk at a
time). The frames are the same bits.

Pixels go in scanline order. Each wrapper runs its plain torch version on
CPU tensors and its kernel on CUDA tensors; ``trace_rays(plain=True)`` runs
every stage through its plain version on any device, the reference that the
kernel path is compared with.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
import os
import time

import numpy as np
import torch

from .. import image as image_mod
from .. import scene as scene_lib
from ..kernels import _build
from ..ops import hit_records, records as records_mod
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
                       alive_in=None, alive_out=None, next_if=None) -> None:
    """K12 launch, CUDA only: ``bounce_update`` in place. ``next_if``: the
    handle of the next bounce's IF node in a graph being captured
    (``yrt_if_handle``), which the launch sets where it sets
    ``alive_out``; None outside a graph."""
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
    if next_if is not None and alive_out is None:
        raise ValueError("next_if: the IF node is set with alive_out")
    ptr = _build.ptr
    err = _build.library().yrt_bounce(
        ptr(color), ptr(kr), ptr(p), ptr(refl_dir), ptr(mask), n, ptr(acc),
        ptr(thr), ptr(ro), ptr(rd), ptr(tmax),
        None if alive_in is None else ptr(alive_in),
        None if alive_out is None else ptr(alive_out),
        next_if or 0, int(next_if is not None), _build.current_stream())
    _build.check_launch(err, "yrt_bounce")
    _build.launches["bounce"] += 1


def bounce_update(acc, thr, ro, rd, tmax, color, kr, p, refl_dir, mask,
                  alive_in=None, alive_out=None, next_if=None) -> None:
    """``bounce_update_plain`` in place on the device loop's state (acc,
    thr, ro, rd (N, 3) f32; tmax (N,) f32, the next nearest-hit query's:
    FLT_MAX on the lanes that go on, else -FLT_MAX), from one bounce's
    shading (color, kr, p, refl_dir (N, 3) f32, mask (N,) bool).

    ``alive_in`` and ``alive_out`` are (1,) i32 words (or None): where
    ``alive_in`` is 0 nothing is written (the bounce is dead), else
    ``alive_out`` is set to 1 if any lane goes on, and with it, on the
    card, the IF node ``next_if`` of a graph being captured (the CPU has
    none). CPU tensors take the plain version; CUDA tensors launch K12 (or
    raise)."""
    if _build.device_kind(acc) == "cuda":
        bounce_update_cuda(acc, thr, ro, rd, tmax, color, kr, p, refl_dir,
                           mask, alive_in, alive_out, next_if)
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


# the device loop's kept state: at most one entry, the last configuration's
# (``frame_key`` -> ``_FrameState``); a new key frees the old entry's graph
# and buffers before it makes its own
_frames: dict = {}


def frame_device(scene, meta, width: int, height: int, samples: int,
                 ambient: float = 0.1, max_depth: int = 8,
                 chunk_pixels: int = 1 << 15, ldr: bool = False,
                 stochastic: bool = False, seed: int = 0,
                 light_sampler=None) -> torch.Tensor:
    """The frame's per-pixel sums (f32), or with ``ldr`` K3's u8 tonemap,
    as a (chunks * chunk_pixels, 3) tensor on the scene's device: rows past
    width * height repeat the last pixel (the caller drops them). The same
    bits as ``frame_eager``. The tensor is the loop's own frame buffer,
    valid until the next ``frame_device`` call: copy it to keep it.

    The port of the JAX package's ``_render_chunks_fused`` (its
    ``lax.map`` over chunks, ray ids from ``lax.iota``) and of
    ``trace_rays``' device loop over depth (renderer.py:113-163, 337-353).
    A chunk is: ray ids from a device chunk index (clamped to the last
    ray); camera rays (K2, or K7 with ``stochastic``); with a light sampler
    the light points (K8), one set for every bounce; ``max_depth`` bounces,
    each K1 nearest, K4 prep, K1 any hit, K4 finish and K12
    (``bounce_update``), which sets the next bounce's alive word where a
    lane goes on; K3 into the chunk's rows; the chunk index advanced.
    Nothing in it waits on the host or allocates.

    On CUDA the chunk is one CUDA graph, replayed for every chunk. Bounce 0
    always runs; each later bounce sits in a conditional IF node of the
    graph that K12 of the bounce before sets, so a bounce with no active
    ray launches nothing, and the fixed depth gives the bits of
    ``trace_rays``' early break. The graph, its buffers and the records it
    reads are kept across calls for one configuration (``frame_key``).

    Every call first brings the graph's inputs up to date
    (``_FrameState.stage``): the caller's leaves and the sampler's tables
    copied into the entry's, K1's and K4's records packed from the copies
    into the entry's record tensors by one launch of K13
    (``ops/records.py``), the camera's frame written by five small ops,
    ``ambient`` written. A call with a new key (a miss) first frees the
    last entry and makes its own, then captures the chunk before chunk 0
    and replays the graph for every chunk; a call with the key of the last
    one (a hit) replays it for every chunk: no capture, no eager chunk, no
    allocation. So a leaf edited in place, or a new scene of the same
    shapes, gives its own frame, never the last one's. If the IF nodes
    cannot be made (a runtime older than CUDA 12.4), the call raises. On
    the CPU the chunks run one after another through the plain versions,
    a dead bounce skipped on the host.

    Each chunk copies its alive words into a row of a (chunks, max_depth +
    1) record, which the frame leaves with ``kernels._build.note_frame``
    (``kernels.last_frame``), with the host's milliseconds in the set-up
    (the key, the entry on a miss, the staging), chunk 0 (0: no chunk runs
    eagerly), the chunk graph's capture (0 on a hit) and the replays
    (enqueue time: nothing here waits for the card), and whether the call
    hit the cache; on CUDA the frame's dead bounces join the device tally
    that ``kernels.skipped_launches`` reads. One frame at a time: the
    entry is the module's, not the caller's.
    """
    t0 = time.perf_counter()
    key = frame_key(scene, meta, width, height, samples, max_depth,
                    chunk_pixels, ldr, stochastic, seed, light_sampler)
    state = _frames.get(key)
    hit = state is not None
    if not hit:
        _frames.clear()
        state = _FrameState(scene, meta, width, height, samples, max_depth,
                            chunk_pixels, ldr, stochastic, seed,
                            light_sampler)
    capture = 0.0
    try:
        with torch.no_grad():
            state.stage(scene, light_sampler, ambient)
            t_stage = time.perf_counter()
            if state.cuda:
                if not hit:
                    state.capture(if_nodes=True)
                    capture = time.perf_counter() - t_stage
                t_replay = time.perf_counter()
                state.replay(state.n_chunks)
                replay = time.perf_counter() - t_replay
            else:
                for _ in range(state.n_chunks):
                    state.run_chunk()
                replay = time.perf_counter() - t_stage
    except BaseException:
        _frames.clear()   # nothing half made is kept
        raise
    _frames[key] = state
    _build.note_frame(state.ran, state.nl > 0, dict(
        setup=(t_stage - t0) * 1e3, chunk0=0.0, capture=capture * 1e3,
        replay=replay * 1e3), hit)
    return state.out


def frame_key(scene, meta, width: int, height: int, samples: int,
              max_depth: int, chunk_pixels: int, ldr: bool,
              stochastic: bool, seed: int, light_sampler) -> tuple:
    """What a device-loop frame's graph and buffers are made for: the
    device; the frame's size, samples, depth, chunk and ``ldr``; the
    sampled modes and the seed where they read it (K7 and K8 take it as a
    launch argument); whether there is a light sampler, and the number of
    lights; the texture flags; the shape and dtype of every scene leaf and
    sampler table. Not their values, which ``_FrameState.stage`` copies in
    on every call, and not ``ambient``, which it writes."""
    sampled = stochastic or light_sampler is not None
    tables = (None if light_sampler is None else tuple(
        (k, tuple(v.shape), v.dtype)
        for k, v in sorted(light_sampler.items())))
    leaves = tuple((tuple(t.shape), t.dtype) for t in (
        getattr(scene, k) for k in scene_lib.LEAF_NAMES))
    return (scene.device, width, height, samples, max_depth,
            min(chunk_pixels, width * height), bool(ldr), bool(stochastic),
            seed if sampled else 0, light_sampler is not None,
            scene.light_ke.shape[0], bool(meta.has_kd_textures),
            bool(meta.has_ks_textures), leaves, tables)


def _frame_device_first(scene, meta, width: int, height: int, samples: int,
                        ambient: float = 0.1, max_depth: int = 8,
                        chunk_pixels: int = 1 << 15, ldr: bool = False,
                        stochastic: bool = False, seed: int = 0,
                        light_sampler=None) -> torch.Tensor:
    """The device loop's first form, kept to time ``frame_device`` against
    in turns (only ``chip_smoke.py`` and the tests call it): everything is
    made for this call and thrown away after it; the frame reads the
    caller's leaves and tables, and K1's and K4's records packed from them
    eagerly; chunk 0 runs eagerly (it loads every kernel); on CUDA the next
    chunk is captured into a CUDA graph with every bounce launched, the
    launches of a dead bounce reading its alive word and returning at once,
    and the graph is replayed for every chunk after the first. The same
    bits and record as ``frame_device`` (never a cache hit)."""
    t0 = time.perf_counter()
    state = _FrameState(scene, meta, width, height, samples, max_depth,
                        chunk_pixels, ldr, stochastic, seed, light_sampler,
                        own_inputs=False)
    with torch.no_grad():
        state.stage(scene, light_sampler, ambient)
        marks = [t0, time.perf_counter()]
        state.run_chunk()
        marks.append(time.perf_counter())
        if state.cuda and state.n_chunks > 1:
            state.capture(if_nodes=False)
            marks.append(time.perf_counter())
            state.replay(state.n_chunks - 1)
        else:
            marks.append(marks[-1])   # no capture
            for _ in range(state.n_chunks - 1):
                state.run_chunk()
    marks.append(time.perf_counter())
    _build.note_frame(state.ran, state.nl > 0, dict(zip(
        ("setup", "chunk0", "capture", "replay"), np.diff(marks) * 1e3)),
        dead_launched=True)
    return state.out


class _FrameState:
    """One device-loop configuration's inputs, buffers and graph.

    With ``own_inputs`` (``frame_device``) the frame reads copies of the
    caller's scene leaves and sampler tables, and on CUDA the records and
    camera frame packed from them, all of which ``stage`` brings up to date
    in place on every call; without (the first form) it reads the caller's
    own leaves and tables and records that ``stage`` packs anew. Every
    buffer of ``frame_device`` is made here, once: the graph bakes its
    pointers in.
    """

    def __init__(self, scene, meta, width, height, samples, max_depth,
                 chunk_pixels, ldr, stochastic, seed, light_sampler,
                 own_inputs=True):
        self.dev = dev = scene.device
        self.cuda = dev.type == "cuda"
        i32, f32 = torch.int32, torch.float32
        self.width, self.height, self.samples = width, height, samples
        self.spp = samples * samples
        npix = width * height
        self.chunk_pixels = min(chunk_pixels, npix)
        self.n_chunks = -(-npix // self.chunk_pixels)
        self.n = n = self.chunk_pixels * self.spp
        self.last_id = npix * self.spp - 1
        self.max_depth, self.ldr = max_depth, ldr
        self.stochastic, self.seed = stochastic, seed
        self.kd_tex, self.ks_tex = meta.has_kd_textures, meta.has_ks_textures
        self.nl = nl = scene.light_ke.shape[0]
        self.own_inputs = own_inputs
        if own_inputs:
            self.scene = scene_lib.TorchScene(*(
                torch.empty_like(getattr(scene, k))
                for k in scene_lib.LEAF_NAMES))
            self.sampler = (None if light_sampler is None else
                            {k: torch.empty_like(v)
                             for k, v in light_sampler.items()})
        else:
            self.scene, self.sampler = scene_lib.detached(scene), light_sampler
        self.fixed = scene_lib.detached(self.scene)
        self.amb = torch.empty((3,), dtype=f32, device=dev)
        self.lane = torch.arange(n, dtype=i32, device=dev)
        self.tmin = torch.full((n,), RAY_EPS, dtype=f32, device=dev)
        self.chunk = torch.zeros((1,), dtype=i32, device=dev)
        self.out = torch.empty((self.n_chunks * self.chunk_pixels, 3),
                               dtype=torch.uint8 if ldr else f32, device=dev)
        self.ids = torch.empty((n,), dtype=i32, device=dev)
        self.acc = torch.empty((n, 3), dtype=f32, device=dev)
        self.thr = torch.empty((n, 3), dtype=f32, device=dev)
        self.tmax = torch.empty((n,), dtype=f32, device=dev)
        self.alive = torch.empty((max_depth + 1,), dtype=i32, device=dev)
        self.ran = torch.empty((self.n_chunks, max_depth + 1), dtype=i32,
                               device=dev)
        self.row = torch.zeros((1,), dtype=torch.int64, device=dev)
        # K1's and K4's records and the camera's (h, w), packed by stage
        self.hrec = self.srec = self.cam = None
        self.graph = None
        self.captured = {}   # the chunk graph's launches, by count key
        if not self.cuda:
            self.plain_occluder = make_occluder(
                self.fixed, traverse.intersect_scene_plain)
            return
        self.rays = [torch.empty((n, k), dtype=f32, device=dev)
                     for k in (2, 3, 3)]
        self.points = (None if light_sampler is None else
                       torch.empty((nl, n, 3), dtype=f32, device=dev))
        self.bufs = shade_mod.forward_buffers(nl, n, dev)

        def hit_buffers(m):
            return dict(hit=torch.empty(m, dtype=torch.bool, device=dev),
                        inst=torch.empty(m, dtype=i32, device=dev),
                        prim=torch.empty(m, dtype=i32, device=dev),
                        t=torch.empty(m, dtype=f32, device=dev))

        self.hits_near, self.hits_any = hit_buffers(n), hit_buffers(nl * n)
        if own_inputs:
            self.hrec, self.srec = records_mod.empty(self.fixed)
            self.pack_records = records_mod.prepare(self.fixed, self.hrec,
                                                    self.srec)
            self.cam = (torch.empty((), dtype=f32, device=dev),
                        torch.empty((), dtype=f32, device=dev))

    def stage(self, scene, light_sampler, ambient) -> None:
        """Bring the frame's inputs up to date before its chunks: the
        caller's leaves and sampler tables copied into this state's (one
        ``_foreach_copy_`` a dtype), ``ambient`` written, the chunk index
        and the record's row set to 0, and on CUDA the records and camera
        frame packed from the copies: in place, K1's and K4's records by
        one launch of K13 and the frame by ``camera.camera_frame``'s ops
        with ``out=``; the first form packs new ones with the packers'
        torch ops. Nothing here waits for the card or allocates (but in the
        first form)."""
        if self.own_inputs:
            pairs = [(getattr(self.scene, k), getattr(scene, k))
                     for k in scene_lib.LEAF_NAMES]
            if light_sampler is not None:
                pairs += [(t, light_sampler[k])
                          for k, t in self.sampler.items()]
            by_dtype = {}
            for dst, src in pairs:
                by_dtype.setdefault(dst.dtype, []).append((dst, src.detach()))
            for group in by_dtype.values():
                torch._foreach_copy_([d for d, _ in group],
                                     [s for _, s in group])
        self.amb.fill_(ambient)
        self.chunk.zero_()
        self.row.zero_()
        if not self.cuda:
            return
        if not self.own_inputs:
            self.hrec = hit_records.pack(self.fixed)
            self.srec = shade_records_lib.pack(self.scene)
            self.cam = camera_mod.camera_frame(self.scene)
            return
        self.pack_records()
        # camera_frame's h = 2 * focus * tan(fovy / 2), w = h * aspect, op
        # for op (the same bits), w first holding tan(fovy / 2)
        sc, (h, w) = self.scene, self.cam
        torch.tan(torch.div(sc.cam_fovy, 2.0, out=w), out=w)
        torch.mul(sc.cam_focus, 2.0, out=h).mul_(w)
        torch.mul(h, sc.cam_aspect, out=w)

    def capture(self, if_nodes: bool) -> None:
        """Capture one chunk into the chunk graph, its bounces after the
        first in IF nodes that K12 sets (``if_nodes``; else every bounce
        launched). The capture runs on a stream of its own and only
        records. The launch counts it made are kept in ``captured`` and
        taken back out of ``_build.launches``: every replay adds them, those
        inside an IF node too, whether or not the node runs its body
        (``_build.skipped_launches`` tallies those of the bounces it did
        not run)."""
        before = dict(_build.launches)
        self.graph = _capture(self.dev, lambda: self.run_chunk(if_nodes))
        self.captured = {k: v - before[k] for k, v in _build.launches.items()}
        _build.launches.update(before)

    def replay(self, times: int) -> None:
        """Replay the chunk graph ``times`` times on the current stream."""
        for _ in range(times):
            self.graph.replay()
        for k, v in self.captured.items():
            _build.launches[k] += v * times

    def run_chunk(self, if_nodes: bool = False) -> None:
        """One chunk: eagerly, or into a graph being captured, where
        ``if_nodes`` puts bounces 1.. into IF nodes. The IF nodes sit one
        after another at the graph's top level; K12 of bounce k sets node
        k + 1 where it sets alive[k + 1] (a bounce is alive only where the
        one before it was)."""
        sc = self.scene
        torch.add(self.lane, self.chunk, alpha=self.n,
                  out=self.ids).clamp_(max=self.last_id)
        if self.cuda:
            _, ro, rd = self.camera_rays()
            light_pos = self.points
            if self.sampler is not None:
                lights_mod.light_points_launch(sc, self.sampler, self.ids,
                                               self.seed, sc.pos,
                                               sc.light_pos, light_pos)
        else:
            _, ro, rd = self.camera_rays()
            ro, rd = ro.contiguous(), rd.contiguous()
            light_pos = (None if self.sampler is None else
                         lights_mod.sample_light_points_plain(
                             sc, self.sampler, self.ids, self.seed))
        self.acc.zero_()
        self.thr.fill_(1.0)
        self.tmax.fill_(FLT_MAX)
        self.alive.zero_()
        self.alive[:1].fill_(1)
        handles = [None] * (self.max_depth + 1)
        if if_nodes:
            body = torch.cuda.Stream(self.dev)
            handles[1:self.max_depth] = [_if_handle()
                                         for _ in range(1, self.max_depth)]
        for k in range(self.max_depth):
            if handles[k] is None:
                self.bounce(k, ro, rd, light_pos, handles[k + 1])
                continue
            with _if_node(handles[k], body):
                self.bounce(k, ro, rd, light_pos, handles[k + 1])
        self.ran.index_copy_(0, self.row, self.alive[None])
        self.row.add_(1)
        pixel_finish(self.acc, self.spp, self.ldr, out=self.out,
                     chunk=self.chunk)
        self.chunk.add_(1)

    def camera_rays(self):
        sc = self.scene
        if not self.cuda:
            if self.stochastic:
                return camera_mod.camera_rays_stochastic_plain(
                    sc, self.ids, self.width, self.height, self.samples,
                    seed=self.seed)
            return camera_mod.camera_rays_plain(sc, self.ids, self.width,
                                                self.height, self.samples)
        h, w = self.cam
        if self.stochastic:
            return camera_mod.camera_rays_stochastic_launch(
                self.ids, sc.cam_axes, sc.cam_o, h, w, sc.cam_focus,
                sc.cam_aperture, self.width, self.height, self.samples,
                self.seed, out=self.rays)
        return camera_mod.camera_rays_launch(
            self.ids, sc.cam_axes, sc.cam_o, h, w, sc.cam_focus, self.width,
            self.height, self.samples, out=self.rays)

    def bounce(self, k, ro, rd, light_pos, next_if) -> None:
        """Bounce ``k``: every launch reads its alive word (the mask is
        K1's hit flag, since dead lanes ask with tmax < tmin); K12 sets the
        next word and, in a graph with IF nodes, the next node
        (``next_if``)."""
        word, nxt = self.alive[k:k + 1], self.alive[k + 1:k + 2]
        sc = self.scene
        if self.cuda:
            hits = traverse.intersect_scene_cuda(
                self.fixed, ro, rd, self.tmin, self.tmax, records=self.hrec,
                alive=word, out=self.hits_near)
            color, kr, p, refl = shade_mod.shade_bounce_cuda(
                sc, ro, rd, hits, self.amb, self.occluder(word), word,
                self.kd_tex, self.ks_tex, light_pos, self.srec, self.bufs)
        else:
            if not bool(word):   # the card's graph skips it whole
                return
            hits = traverse.intersect_scene_plain(self.fixed, ro, rd,
                                                  self.tmin, self.tmax)
            color, kr, p, refl, _ = shade_mod.shade_step_plain(
                sc, ro, rd, hits, self.amb, hits["hit"], self.plain_occluder,
                self.kd_tex, self.ks_tex, light_pos)
        bounce_update(self.acc, self.thr, ro, rd, self.tmax, color, kr, p,
                      refl, hits["hit"], word, nxt, next_if)

    def occluder(self, word):
        # K4 prep writes tmax = -FLT_MAX on the masked lanes' shadow rays,
        # so make_occluder's where(mask, tmax, -FLT_MAX) is the identity here
        def occluder(p, d, tmin, tmax, mask):
            res = traverse.intersect_scene_cuda(
                self.fixed, p.reshape(-1, 3), d.reshape(-1, 3),
                tmin.reshape(-1), tmax.reshape(-1), any_hit=True,
                records=self.hrec, alive=word, out=self.hits_any)
            return res["hit"].reshape(p.shape[:-1])
        return occluder


def _capture(dev, fn) -> torch.cuda.CUDAGraph:
    """A CUDA graph of one call of ``fn``, captured on a stream of its own
    (a capture only records, and waits for nothing)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(torch.cuda.Stream(dev)):
        graph.capture_begin()
        try:
            fn()
        finally:
            graph.capture_end()
    return graph


def _if_handle() -> int:
    """A new IF node handle in the graph that the current stream captures
    into: 0 at each of the graph's launches until a kernel sets it."""
    handle = ctypes.c_ulonglong()
    _build.check_launch(_build.library().yrt_if_handle(
        _build.current_stream(), ctypes.byref(handle)), "yrt_if_handle")
    return handle.value


@contextlib.contextmanager
def _if_node(handle, body):
    """Capture the block's launches, on the stream ``body``, into an IF
    node on ``handle`` after what the current stream captured so far: the
    card runs them only where K12 of the bounce before set the handle at
    that point of a launch of the graph."""
    lib = _build.library()
    body_ptr = ctypes.c_void_p(body.cuda_stream)
    _build.check_launch(lib.yrt_if_begin(_build.current_stream(), handle,
                                         body_ptr), "yrt_if_begin")
    try:
        with torch.cuda.stream(body):
            yield
    finally:
        _build.check_launch(lib.yrt_if_end(body_ptr), "yrt_if_end")


def to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor on the host as numpy; from the card in one copy into
    page-locked memory (torch caches it): a fresh pageable buffer pays its
    page faults in the copy."""
    if t.device.type == "cpu":
        return t.numpy()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return out.copy_(t).numpy()


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
