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

The training step's loss and gradients run as a device loop too,
``loss_grads_device``, the port of the JAX package's differentiable depth
loop (its ``lax.scan`` with a batch-dead ``lax.cond``) and its transpose:
one CUDA graph of the whole step, kept across calls of one configuration,
its forward bounces writing each bounce's state into slots of their own
(K12 out of place), its reverse bounces K14 (``bounce_update_bwd``) and
K5, each bounce after the first and its reverse in IF nodes that K12
sets. ``trace_rays(differentiable=True)`` keeps the eager loop under
autograd, for the callers that run autograd themselves.

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
from ..utils import tracer
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
    or with ``ldr`` the (npix, 4) u8 RGBA: each channel sum/spp, pow(max(x,
    0), 1/2.2), clip to [0, 1], * 255, truncate (image.tonemap, exposure
    0), and alpha 255."""
    per = rgb.reshape(-1, spp, 3)
    acc = per[:, 0]
    for k in range(1, spp):      # sample order, as the reference accumulates
        acc = acc + per[:, k]
    if not ldr:
        return acc
    x = acc / isect.device_scalar(spp, rgb.device)
    x = torch.pow(torch.clamp(x, min=0.0), INV_GAMMA)
    out = torch.full((acc.shape[0], 4), 255, dtype=torch.uint8,
                     device=rgb.device)
    out[:, :3] = (torch.clamp(x, 0.0, 1.0) * 255.0).to(torch.uint8)
    return out


def pixel_finish_cuda(rgb, spp: int, ldr: bool, out=None, chunk=None):
    """K3 launch: same contract as ``pixel_finish_plain``, CUDA only: one
    thread a pixel, (npix, 3) f32 sums, or with ``ldr`` (npix, 4) u8 RGBA
    written as one 4-byte store a pixel.

    With ``out`` (a frame buffer of (rows, 4) u8 with ``ldr``, else (rows,
    3) f32) and ``chunk`` (a (1,) i32 device chunk index), K3 writes the
    npix pixels into ``out``'s rows chunk * npix.., reading the index on the
    card, and returns ``out``."""
    dev = rgb.device
    _build.check_tensor("rgb", rgb, torch.float32, (-1, 3), dev)
    if spp < 1 or rgb.shape[0] % spp:
        raise ValueError(f"{rgb.shape[0]} rays are not whole pixels of "
                         f"{spp} samples")
    npix = rgb.shape[0] // spp
    if (out is None) != (chunk is None):
        raise ValueError("out and chunk go together")
    dtype, cols = (torch.uint8, 4) if ldr else (torch.float32, 3)
    if out is None:
        out = torch.empty((npix, cols), dtype=dtype, device=dev)
    else:
        _build.check_tensor("out", out, dtype, (-1, cols), dev)
        _build.check_tensor("chunk", chunk, torch.int32, (1,), dev)
        if out.shape[0] % npix:
            raise ValueError(f"out: {out.shape[0]} rows are not whole "
                             f"chunks of {npix} pixels")
        if out.data_ptr() % 4:
            raise ValueError("out: not 4-byte aligned")
    ptr = _build.ptr
    err = _build.library().yrt_pixel_finish(
        ptr(rgb), npix, spp, int(ldr), None if ldr else ptr(out),
        ptr(out) if ldr else None, None if chunk is None else ptr(chunk),
        _build.current_stream())
    _build.check_launch(err, "yrt_pixel_finish")
    _build.launches["pixel_finish"] += 1
    return out


def pixel_finish(rgb, spp: int, ldr: bool, out=None, chunk=None):
    """Per-pixel spp sums, (npix, 3) f32, or with ``ldr`` the tonemapped
    (npix, 4) u8 RGBA, alpha 255; with ``out`` and ``chunk`` written into a
    frame buffer at the chunk's rows, as ``pixel_finish_cuda`` says. CPU
    tensors take the plain version; CUDA tensors launch K3 (or raise)."""
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


def _check_bounce(acc, thr_in, thr, ro, rd, tmax, color, kr, p, refl_dir,
                  mask, alive_in, alive_out, handles) -> None:
    """Validate a K12 launch's arguments; ``handles``: its IF node handles,
    set with ``alive_out``."""
    n = acc.shape[0]
    dev = acc.device
    f32 = torch.float32
    check = _build.check_tensor
    for name, t in (("acc", acc), ("thr_in", thr_in), ("thr", thr),
                    ("ro", ro), ("rd", rd), ("color", color), ("kr", kr),
                    ("p", p), ("refl_dir", refl_dir)):
        check(name, t, f32, (n, 3), dev)
    check("tmax", tmax, f32, (n,), dev)
    check("mask", mask, torch.bool, (n,), dev)
    for name, t in (("alive_in", alive_in), ("alive_out", alive_out)):
        if t is not None:
            check(name, t, torch.int32, (1,), dev)
    if any(h is not None for h in handles) and alive_out is None:
        raise ValueError("next_if, rev_if: the IF nodes are set with "
                         "alive_out")


def _words(alive_in, alive_out):
    ptr = _build.ptr
    return (None if alive_in is None else ptr(alive_in),
            None if alive_out is None else ptr(alive_out))


def bounce_update_cuda(acc, thr, ro, rd, tmax, color, kr, p, refl_dir, mask,
                       alive_in=None, alive_out=None, next_if=None) -> None:
    """K12 launch, CUDA only: ``bounce_update`` in place. ``next_if``: the
    handle of the next bounce's IF node in a graph being captured
    (``yrt_if_handle``), which the launch sets where it sets
    ``alive_out``; None outside a graph."""
    _check_bounce(acc, thr, thr, ro, rd, tmax, color, kr, p, refl_dir, mask,
                  alive_in, alive_out, (next_if,))
    ptr = _build.ptr
    err = _build.library().yrt_bounce(
        ptr(color), ptr(kr), ptr(p), ptr(refl_dir), ptr(mask), acc.shape[0],
        ptr(acc), ptr(thr), ptr(ro), ptr(rd), ptr(tmax),
        *_words(alive_in, alive_out), next_if or 0, int(next_if is not None),
        _build.current_stream())
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
    _bounce_update_host(acc, thr, thr, ro, rd, tmax, color, kr, p, refl_dir,
                        mask, alive_in, alive_out)


def _bounce_update_host(acc, thr_in, thr, ro, rd, tmax, color, kr, p,
                        refl_dir, mask, alive_in, alive_out) -> None:
    """K12's plain version on host tensors, in place or out of place."""
    if alive_in is not None and not bool(alive_in):
        return
    new = bounce_update_plain(acc, thr_in, color, kr, p, refl_dir, mask)
    cont = new[-1]
    for dst, src in zip((acc, thr, ro, rd), new):
        dst.copy_(src)
    tmax.copy_(torch.where(cont, FLT_MAX, -FLT_MAX))
    if alive_out is not None and bool(cont.any()):
        alive_out.fill_(1)


def bounce_update_out_cuda(acc, thr_in, thr, ro, rd, tmax, color, kr, p,
                           refl_dir, mask, alive_in=None, alive_out=None,
                           next_if=None, rev_if=None) -> None:
    """K12's out-of-place launch, CUDA only: ``bounce_update_out``.
    ``next_if`` and ``rev_if``: the handles of the next bounce's IF nodes
    in a graph being captured, its forward's and its reverse's, which the
    launch sets where it sets ``alive_out``; None outside a graph."""
    _check_bounce(acc, thr_in, thr, ro, rd, tmax, color, kr, p, refl_dir,
                  mask, alive_in, alive_out, (next_if, rev_if))
    if thr_in.data_ptr() == thr.data_ptr():
        raise ValueError("thr_in and thr: the out-of-place form writes "
                         "another slot")
    ptr = _build.ptr
    err = _build.library().yrt_bounce_out(
        ptr(color), ptr(kr), ptr(p), ptr(refl_dir), ptr(mask), acc.shape[0],
        ptr(acc), ptr(thr_in), ptr(thr), ptr(ro), ptr(rd), ptr(tmax),
        *_words(alive_in, alive_out), next_if or 0, rev_if or 0,
        int(next_if is not None) | 2 * int(rev_if is not None),
        _build.current_stream())
    _build.check_launch(err, "yrt_bounce_out")
    _build.launches["bounce"] += 1


def bounce_update_out(acc, thr_in, thr, ro, rd, tmax, color, kr, p,
                      refl_dir, mask, alive_in=None, alive_out=None,
                      next_if=None, rev_if=None) -> None:
    """``bounce_update`` out of place, for the training step's loop, whose
    reverse reads every bounce's state: the throughput read from bounce
    k's slot ``thr_in``, the next throughput and ray written into bounce k
    + 1's ``thr``, ``ro`` and ``rd``; acc and tmax in place. The same bits
    as the in-place form. ``alive_in``, ``alive_out`` and ``next_if`` as
    in ``bounce_update``; ``rev_if``, on the card, the handle of the next
    bounce's reverse's IF node, set with ``next_if``. CPU tensors take the
    plain version; CUDA tensors launch K12 (or raise)."""
    if _build.device_kind(acc) == "cuda":
        bounce_update_out_cuda(acc, thr_in, thr, ro, rd, tmax, color, kr, p,
                               refl_dir, mask, alive_in, alive_out, next_if,
                               rev_if)
        return
    _bounce_update_host(acc, thr_in, thr, ro, rd, tmax, color, kr, p,
                        refl_dir, mask, alive_in, alive_out)


# --------------------------------------------------------------------------
# K14: the reverse of a bounce's state update
# --------------------------------------------------------------------------


def bounce_update_bwd_plain(g_acc, g_thr, g_ro, g_rd, thr, color, kr, mask):
    """The reverse of ``bounce_update_plain`` (K14's plain version): from
    the cotangents of the next state (``g_acc``, the loss's, the same at
    every bounce; ``g_thr``, ``g_ro``, ``g_rd`` of the next thr, ro, rd)
    and the bounce's own thr, color, kr and mask, the cotangents of the
    bounce's shading (g_color, g_kr, g_p, g_refl) and of its throughput
    (g_thr). As JAX transposes ``thr' = where(cont, thr * kr, thr)``
    (JAX ``render/renderer.py:297-304``): the cotangent selected first,
    ``where(cont, g, 0)``, then multiplied by thr and by kr, so a lane
    that does not go on with an infinite thr or a NaN kr gets NaN there,
    as in ``jax.vjp`` and torch autograd of ``bounce_update_plain``; the
    other branch adds ``where(cont, 0, g)``."""
    cont = (mask & (kr > 0).any(dim=-1))[:, None]
    g_sel = torch.where(cont, g_thr, 0.0)
    g_color = g_acc * thr
    g_kr = g_sel * thr
    g_p = torch.where(cont, g_ro, 0.0)
    g_refl = torch.where(cont, g_rd, 0.0)
    g_thr = g_acc * color + (g_sel * kr + torch.where(cont, 0.0, g_thr))
    return g_color, g_kr, g_p, g_refl, g_thr


def bounce_update_bwd_cuda(g_acc, g_thr, g_ro, g_rd, thr, color, kr, mask,
                           out) -> None:
    """K14 launch, CUDA only: ``bounce_update_bwd``."""
    n = g_acc.shape[0]
    dev = g_acc.device
    check = _build.check_tensor
    for name, t in (("g_acc", g_acc), ("g_thr", g_thr), ("g_ro", g_ro),
                    ("g_rd", g_rd), ("thr", thr), ("color", color),
                    ("kr", kr), *zip(("g_color", "g_kr", "g_p", "g_refl"),
                                     out)):
        check(name, t, torch.float32, (n, 3), dev)
    check("mask", mask, torch.bool, (n,), dev)
    ptr = _build.ptr
    err = _build.library().yrt_bounce_bwd(
        ptr(g_acc), ptr(thr), ptr(color), ptr(kr), ptr(mask), ptr(g_ro),
        ptr(g_rd), ptr(g_thr), *(ptr(t) for t in out), n,
        _build.current_stream())
    _build.check_launch(err, "yrt_bounce_bwd")
    _build.launches["bounce_bwd"] += 1


def bounce_update_bwd(g_acc, g_thr, g_ro, g_rd, thr, color, kr, mask,
                      out) -> None:
    """``bounce_update_bwd_plain`` into the training step's buffers: the
    four shading cotangents written into ``out`` ([g_color, g_kr, g_p,
    g_refl], (N, 3) f32), and ``g_thr``, the next throughput's cotangent,
    overwritten with the bounce's own. CPU tensors take the plain version;
    CUDA tensors launch K14 (or raise)."""
    if _build.device_kind(g_acc) == "cuda":
        bounce_update_bwd_cuda(g_acc, g_thr, g_ro, g_rd, thr, color, kr,
                               mask, out)
        return
    got = bounce_update_bwd_plain(g_acc, g_thr, g_ro, g_rd, thr, color, kr,
                                  mask)
    for dst, src in zip((*out, g_thr), got):
        dst.copy_(src)


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
    ``ldr`` the tonemapped (height, width, 4) u8 with alpha 255, C-contiguous
    either way.

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
    checkpoint, K3 tonemaps on the device (within 1 u8 step of the host)
    into the image's own layout, RGBA with alpha 255, and the image is the
    host buffer that the frame was copied into, reshaped: the host makes no
    pass over its pixels. That buffer is the call's own (on the card a
    fresh page-locked tensor from torch's caching host allocator, kept
    alive by the returned array), so the next frame never overwrites an
    image returned before it.

    Spans (``utils/tracer.py``): ``render_image`` around ``frame_device``
    (``frame_eager`` has no span of its own), ``to_host`` (``pinned``, the
    page-locked buffer; ``copy``, which waits for the frame's kernels) and
    ``image``, the image made from the host rows (a reshape where K3
    tonemapped). ``render_image``'s attribute ``host_rgba`` is 1 where the
    host made a pass over the pixels (f32, or the checkpointed path), 0
    where the image is the copied buffer.
    """
    sp = tracer.begin("render_image")
    try:
        npix = width * height
        device_ldr = ldr and not checkpoint
        tracer.note(sp, "host_rgba", not device_ldr)
        args = (scene, meta, width, height, samples, ambient, max_depth,
                chunk_pixels, device_ldr, stochastic, seed, light_sampler)
        if not checkpoint:
            out = to_host(frame_device(*args)[:npix])
        else:
            out = frame_eager(*args, checkpoint=checkpoint)
        s = tracer.begin("image")
        if device_ldr:
            img = out.reshape(height, width, 4)
        else:
            img = _rgba(out, width, height, samples * samples, ldr)
        tracer.end(s)
        return img
    finally:
        tracer.end(sp)


def _rgba(out, width, height, spp, ldr) -> np.ndarray:
    """``render_image``'s image from the frame's (npix, 3) f32 host sums:
    divided by spp, alpha 1, and with ``ldr`` tonemapped on the host."""
    npix = width * height
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
    """The frame's (npix, 3) per-pixel sums (f32), or with ``ldr`` K3's
    (npix, 4) u8 RGBA tonemap, on the host: ``trace_rays`` and
    ``pixel_finish`` chunk by chunk, each chunk copied to the host, with
    ``render_image``'s ``checkpoint`` (which resumes after a snapshot's
    pixels)."""
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
    out = (np.empty((npix, 4), np.uint8) if ldr
           else np.empty((npix, 3), np.float32))
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
    """The frame's per-pixel sums, a (chunks * chunk_pixels, 3) f32 tensor
    on the scene's device, or with ``ldr`` K3's tonemap, a (chunks *
    chunk_pixels, 4) u8 RGBA tensor with alpha 255: rows past width *
    height repeat the last pixel (the caller drops them). The same
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
    ``ambient`` and, in a sampled mode, the seed's 32 bits written into the
    entry's seed word, which K7 and K8 read on the card (and the CPU's
    plain versions on the host). A call with a new key (a miss) first frees
    the last entry and makes its own, then captures the chunk before chunk
    0 and replays the graph for every chunk; a call with the key of the
    last one (a hit) replays it for every chunk: no capture, no eager
    chunk, no allocation. So a leaf edited in place, a new scene of the
    same shapes, a new pose or a new seed is a hit and gives its own
    frame, never the last one's. If the IF nodes
    cannot be made (a runtime older than CUDA 12.4), the call raises. On
    the CPU the chunks run one after another through the plain versions,
    a dead bounce skipped on the host.

    Each chunk copies its alive words into a row of a (chunks, max_depth +
    1) record, which the frame leaves with ``kernels._build.note_frame``
    (``kernels.last_frame``), with the host's milliseconds in the set-up
    (the key, the entry on a miss, the staging), chunk 0 (0: no chunk runs
    eagerly), the chunk graph's capture (0 on a hit) and the replays
    (enqueue time: nothing here waits for the card), and whether the call
    hit the cache; on CUDA, inside ``tracer.recording()``, the frame's
    dead bounces join the device tally that ``kernels.skipped_launches``
    reads. One frame at a time: the entry is the module's, not the
    caller's.

    Spans (``utils/tracer.py``): ``frame_device``, with attributes ``hit``,
    ``seed_new`` (1 where a hit's seed differs from the last call's on
    the same entry; 0 on a miss, which has no last call) and ``k1_ident``
    (the entry's share of identity instances, counted on the host when
    the entry is built: a hit reads nothing from the card for it; an
    instance frame edited in place after that is not seen), around the stages
    ``key``, ``entry`` (a miss), ``stage``, ``capture`` (a miss on CUDA)
    and ``replay``, whose clock readings also give the record's
    milliseconds: setup is key, entry and stage.
    """
    sp = tracer.begin("frame_device")
    try:
        st = tracer.Stages("key")
        key = frame_key(scene, meta, width, height, samples, max_depth,
                        chunk_pixels, ldr, stochastic, seed, light_sampler)
        state = _frames.get(key)
        hit = state is not None
        tracer.note(sp, "hit", hit)
        tracer.note(sp, "seed_new",
                    hit and state.last_seed != seed & camera_mod.U32)
        if not hit:
            st.next("entry")
            _frames.clear()
            state = _FrameState(scene, meta, width, height, samples,
                                max_depth, chunk_pixels, ldr, stochastic,
                                light_sampler)
        tracer.note(sp, "k1_ident", state.k1_ident)
        try:
            with torch.no_grad():
                st.next("stage")
                state.stage(scene, light_sampler, ambient, seed)
                if state.cuda and not hit:
                    st.next("capture")
                    state.capture(if_nodes=True)
                st.next("replay")
                if state.cuda:
                    state.replay(state.n_chunks)
                else:
                    for _ in range(state.n_chunks):
                        state.run_chunk()
                st.stop()
        except BaseException:
            _frames.clear()   # nothing half made is kept
            raise
        _frames[key] = state
        _build.note_frame(state.ran, state.nl > 0, dict(
            setup=st.ms("key", "entry", "stage"), chunk0=0.0,
            capture=st.ms("capture"), replay=st.ms("replay")), hit)
        return state.out
    finally:
        tracer.end(sp)


def frame_key(scene, meta, width: int, height: int, samples: int,
              max_depth: int, chunk_pixels: int, ldr: bool,
              stochastic: bool, seed: int, light_sampler) -> tuple:
    """What a device-loop frame's graph and buffers are made for: the
    device; the frame's size, samples, depth, chunk and ``ldr``; the
    sampled modes; whether there is a light sampler, and the number of
    lights; the texture flags; the shape and dtype of every scene leaf and
    sampler table. Not their values, which ``_FrameState.stage`` copies in
    on every call, not ``ambient``, and not ``seed``, which it writes: K7
    and K8 read the seed from the entry's seed word, so every seed is
    served by one graph."""
    del seed
    tables = (None if light_sampler is None else tuple(
        (k, tuple(v.shape), v.dtype)
        for k, v in sorted(light_sampler.items())))
    leaves = tuple((tuple(t.shape), t.dtype) for t in (
        getattr(scene, k) for k in scene_lib.LEAF_NAMES))
    return (scene.device, width, height, samples, max_depth,
            min(chunk_pixels, width * height), bool(ldr), bool(stochastic),
            light_sampler is not None,
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
                        chunk_pixels, ldr, stochastic, light_sampler,
                        own_inputs=False)
    with torch.no_grad():
        state.stage(scene, light_sampler, ambient, seed)
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
    pointers in. One of them is the seed word, a (1,) i32 tensor holding
    the seed's 32 bits, which ``stage`` writes in a sampled mode and K7
    and K8 read when they run (the CPU's plain versions read it on the
    host), so the graph serves every seed; ``last_seed`` is the seed of
    the last call staged, on the host. ``k1_ident`` is the share of the
    scene's instances that K1 enters on the world ray
    (``hit_records.identity_share``), read from the leaves the state was
    built from.
    """

    def __init__(self, scene, meta, width, height, samples, max_depth,
                 chunk_pixels, ldr, stochastic, light_sampler,
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
        self.stochastic = stochastic
        self.kd_tex, self.ks_tex = meta.has_kd_textures, meta.has_ks_textures
        self.nl = nl = scene.light_ke.shape[0]
        self.k1_ident = hit_records.identity_share(scene)
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
        self.seed_word = torch.zeros((1,), dtype=i32, device=dev)
        self.last_seed = None
        self.lane = torch.arange(n, dtype=i32, device=dev)
        self.tmin = torch.full((n,), RAY_EPS, dtype=f32, device=dev)
        self.chunk = torch.zeros((1,), dtype=i32, device=dev)
        rows = self.n_chunks * self.chunk_pixels
        self.out = (torch.empty((rows, 4), dtype=torch.uint8, device=dev)
                    if ldr else torch.empty((rows, 3), dtype=f32, device=dev))
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

    def stage(self, scene, light_sampler, ambient, seed) -> None:
        """Bring the frame's inputs up to date before its chunks: the
        caller's leaves and sampler tables copied into this state's (one
        ``_foreach_copy_`` a dtype), ``ambient`` written, in a sampled mode
        the seed's 32 bits written into the seed word (``fill_``), the
        chunk index and the record's row set to 0, and on CUDA the records
        and camera frame packed from the copies: in place, K1's and K4's
        records by one launch of K13 and the frame by
        ``camera.camera_frame``'s ops with ``out=``; the first form packs
        new ones with the packers' torch ops. Nothing here waits for the
        card or allocates (but in the first form)."""
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
        if self.stochastic or self.sampler is not None:
            self.seed_word.fill_(camera_mod.seed_word_value(seed))
        self.last_seed = seed & camera_mod.U32
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
                                               self.seed_word, sc.pos,
                                               sc.light_pos, light_pos)
        else:
            _, ro, rd = self.camera_rays()
            ro, rd = ro.contiguous(), rd.contiguous()
            light_pos = (None if self.sampler is None else
                         lights_mod.sample_light_points_plain(
                             sc, self.sampler, self.ids, self.host_seed()))
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

    def host_seed(self) -> int:
        """The seed word's 32 bits, read on the host (the CPU's chunks)."""
        return int(self.seed_word) & camera_mod.U32

    def camera_rays(self):
        sc = self.scene
        if not self.cuda:
            if self.stochastic:
                return camera_mod.camera_rays_stochastic_plain(
                    sc, self.ids, self.width, self.height, self.samples,
                    seed=self.host_seed())
            return camera_mod.camera_rays_plain(sc, self.ids, self.width,
                                                self.height, self.samples)
        h, w = self.cam
        if self.stochastic:
            return camera_mod.camera_rays_stochastic_launch(
                self.ids, sc.cam_axes, sc.cam_o, h, w, sc.cam_focus,
                sc.cam_aperture, self.width, self.height, self.samples,
                self.seed_word, out=self.rays)
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


# --------------------------------------------------------------------------
# the training step's device loop
# --------------------------------------------------------------------------

# the leaves that the camera reverse (K6 and the frame chain) gives
CAMERA_LEAVES = ("cam_axes", "cam_o", "cam_fovy", "cam_aspect", "cam_focus")

# the training step's kept state: at most one entry, the last
# configuration's (``step_key`` -> ``_StepState``), beside the frame's
_steps: dict = {}


def trained_leaves(scene, trainable=None) -> tuple:
    """The leaves a step trains, in LEAF_NAMES order: the float leaves, as
    the JAX package's ``partition_scene`` picks them, restricted to the
    names in ``trainable`` when it is given."""
    return tuple(k for k in scene_lib.LEAF_NAMES
                 if getattr(scene, k).is_floating_point()
                 and (trainable is None or k in trainable))


def step_key(scene, n: int, width: int, height: int, samples: int,
             max_depth: int, has_kd_textures: bool, has_ks_textures: bool,
             trainable, update: bool) -> tuple:
    """What a training step's graph and buffers are made for: the device;
    the batch's ray count; the frame's size and samples; the depth; the
    texture flags; the trained leaves (``trained_leaves``); whether the
    update runs in the graph; every leaf's shape and dtype. Not the leaf
    values, ``lr``, the ray ids, the target or ``ambient``, which
    ``_StepState.stage`` copies in on every call."""
    leaves = tuple((tuple(t.shape), t.dtype) for t in (
        getattr(scene, k) for k in scene_lib.LEAF_NAMES))
    return (scene.device, n, width, height, samples, max_depth,
            bool(has_kd_textures), bool(has_ks_textures),
            trained_leaves(scene, trainable), bool(update), leaves)


def loss_grads_device(scene, ids, target, ambient, width: int, height: int,
                      samples: int, max_depth: int,
                      has_kd_textures: bool = True,
                      has_ks_textures: bool = True, trainable=None,
                      lr=None):
    """The MSE render loss of ``ids`` (N,) i32 against ``target`` (N, 3)
    f32 and its gradient in every trained leaf (``trained_leaves``), as a
    device loop over depth, forward and reverse: the port of the JAX
    package's differentiable ``trace_rays`` (its ``lax.scan`` of the
    checkpointed bounce with a batch-dead ``lax.cond``, renderer.py:
    323-342) and of its transpose under ``jax.value_and_grad``
    (``mesh.train_step``). Returns (loss, out): ``out`` is a list in
    LEAF_NAMES order, None for the leaves not trained, else the leaf's
    gradient (zeros where the loss does not reach it), or with ``lr`` the
    updated leaf ``d - lr * g``. Every returned tensor is the caller's
    own: the next call does not change it.

    The step runs the camera rays (K2), ``max_depth`` bounces of K1
    nearest, K4 prep, K1 any hit, K4 finish and K12 out of place (so every
    bounce's thr, ro and rd stay), each saving what the JAX package's
    remat policy saves: the ray, the hit topology and mask, the occlusion,
    and thr, color and kr for K14; the loss and its cotangent with
    ``render_loss``'s ops (the loss is the eager step's bits); then the
    bounces in reverse, each K14 (the glue's adjoint) and K5 (the
    shading's, recomputing the bounce from what was saved, its leaf
    gradients added into one f64 sum for all bounces, rounded once); K6
    and the camera frame's chain where a camera leaf is trained; the
    update with ``lr``.

    On CUDA the step is one CUDA graph, kept across calls of one
    configuration (``step_key``). Bounce 0 and its reverse always run; each
    later bounce and its reverse sit in conditional IF nodes of their own,
    both set by K12 of the bounce before, so a bounce with no active ray
    launches nothing either way, and its reverse leaves the cotangents of
    the state it would have read at the zeros they start from (a dead
    bounce is the identity, and every bounce after it is dead). Every call
    first copies the caller's leaves, ``ids``, ``target``, ``ambient`` and
    ``lr`` into the entry's (``_StepState.stage``) and packs K1's and K4's
    records from the copies by one launch of K13. A call with a new key (a
    miss) frees the last entry, makes its own and captures the step; a
    call with the key of the last one (a hit) replays it: no capture, no
    allocation but the returned tensors, no host sync. Without IF nodes (a
    runtime older than CUDA 12.4) the call raises. On the CPU the same
    forward and reverse run bounce by bounce through the plain versions
    (K5's by torch autograd of the recomputed shading), a dead bounce
    skipped on the host, on the same kept entry.

    Each step leaves a record (``kernels.last_step()``: "ran", the alive
    words; "host_ms" of its set-up, capture and replay; "cache_hit"); on
    CUDA, inside ``tracer.recording()``, its dead bounces join the tally of
    ``kernels.skipped_launches``. One step at a time: the entry is the
    module's. Spans as ``frame_device``'s (``k1_ident`` too, not
    ``seed_new``), the outer one ``loss_grads_device``; the replay stage is
    the CPU's bounce loop there.
    """
    sp = tracer.begin("loss_grads_device")
    try:
        st = tracer.Stages("key")
        n = ids.shape[0]
        if ids.shape != (n,) or target.shape != (n, 3):
            raise ValueError(f"ids {tuple(ids.shape)} and target "
                             f"{tuple(target.shape)}: want (N,) and (N, 3)")
        key = step_key(scene, n, width, height, samples, max_depth,
                       has_kd_textures, has_ks_textures, trainable,
                       lr is not None)
        state = _steps.get(key)
        hit = state is not None
        tracer.note(sp, "hit", hit)
        if not hit:
            st.next("entry")
            _steps.clear()
            state = _StepState(scene, n, width, height, samples, max_depth,
                               has_kd_textures, has_ks_textures, key[8],
                               lr is not None)
        tracer.note(sp, "k1_ident", state.k1_ident)
        try:
            with torch.no_grad():
                st.next("stage")
                state.stage(scene, ids, target, ambient, lr)
                if state.cuda and not hit:
                    st.next("capture")
                    state.capture()
                st.next("replay")
                if state.cuda:
                    state.replay()
                else:
                    state.run()
                st.stop()
                out = state.results()
        except BaseException:
            _steps.clear()   # nothing half made is kept
            raise
        _steps[key] = state
        _build.note_step(state.alive, state.nl > 0, dict(
            setup=st.ms("key", "entry", "stage"), capture=st.ms("capture"),
            replay=st.ms("replay")), hit)
        return out
    finally:
        tracer.end(sp)


class _StepState:
    """One training-step configuration's inputs, saved state, buffers and
    graph (``loss_grads_device``).

    The step reads copies of the caller's leaves, ray ids, target,
    ``ambient`` and ``lr``, and on CUDA K1's and K4's records packed from
    the copies, all of which ``stage`` brings up to date in place on every
    call. Every buffer is made here, once (the graph bakes its pointers
    in): per bounce k the slots of its inputs thr, ro and rd (k = 0 ..
    max_depth; K2 writes ro and rd of bounce 0, K12 of bounce k those of
    k + 1), and what the reverse reads: the hit mask, instance and prim,
    the (L, N) occlusion, color and kr; the loss, the cotangents carried
    from bounce to bounce (of thr, ro and rd), K14's four outputs, K5's
    f64 leaf sums and scratch, K6's sums, and the returned leaves.
    ``k1_ident`` as ``_FrameState``'s.
    """

    def __init__(self, scene, n, width, height, samples, max_depth,
                 kd_tex, ks_tex, trained, update):
        self.dev = dev = scene.device
        self.cuda = dev.type == "cuda"
        f32, i32 = torch.float32, torch.int32
        self.n, self.width, self.height = n, width, height
        self.samples, self.max_depth = samples, max_depth
        self.kd_tex, self.ks_tex = kd_tex, ks_tex
        self.trained, self.update = trained, update
        self.nl = nl = scene.light_ke.shape[0]
        self.k1_ident = hit_records.identity_share(scene)
        self.scene = sc = scene_lib.TorchScene(*(
            torch.empty_like(getattr(scene, k))
            for k in scene_lib.LEAF_NAMES))
        self.ids = torch.empty((n,), dtype=i32, device=dev)
        self.target = torch.empty((n, 3), dtype=f32, device=dev)
        self.amb = torch.empty((3,), dtype=f32, device=dev)
        self.lr = torch.empty((), dtype=f32, device=dev) if self.cuda else 0.0
        self.tmin = torch.full((n,), RAY_EPS, dtype=f32, device=dev)
        self.acc = torch.empty((n, 3), dtype=f32, device=dev)
        self.tmax = torch.empty((n,), dtype=f32, device=dev)
        self.alive = torch.empty((max_depth + 1,), dtype=i32, device=dev)
        self.loss = torch.empty((), dtype=f32, device=dev)

        def rows3(count):
            return [torch.empty((n, 3), dtype=f32, device=dev)
                    for _ in range(count)]

        self.uv = torch.empty((n, 2), dtype=f32, device=dev)
        self.thr, self.ro, self.rd = (rows3(max_depth + 1) for _ in range(3))
        self.color, self.kr = rows3(max_depth), rows3(max_depth)
        self.mask = [torch.empty((n,), dtype=torch.bool, device=dev)
                     for _ in range(max_depth)]
        self.inst, self.prim = ([torch.empty((n,), dtype=i32, device=dev)
                                 for _ in range(max_depth)]
                                for _ in range(2))
        self.occ = [torch.empty((nl, n), dtype=torch.bool, device=dev)
                    for _ in range(max_depth)]
        # the cotangents of the next bounce's acc, thr, ro, rd, and K14's
        self.g_acc, self.g_thr, self.g_ro, self.g_rd = rows3(4)
        self.g_shade = rows3(4)
        self.rev = shade_mod.reverse_buffers(sc, n)
        self.cam_sums, self.cam_partials = camera_mod.camera_bwd_buffers(
            n, dev)
        self.camera = any(k in CAMERA_LEAVES for k in trained)
        self.out = {k: torch.empty_like(getattr(sc, k)) for k in trained}
        self.zeros = {k: torch.zeros_like(getattr(sc, k)) for k in trained
                      if k not in shade_mod.GRAD_LEAVES + CAMERA_LEAVES}
        self.graph = None
        self.captured = {}   # the graph's launches, by count key
        if not self.cuda:
            self.plain_occluder = make_occluder(
                sc, traverse.intersect_scene_plain)
            return
        self.p, self.refl = rows3(2)
        self.t = torch.empty((n,), dtype=f32, device=dev)
        self.any_hits = dict(
            inst=torch.empty((nl * n,), dtype=i32, device=dev),
            prim=torch.empty((nl * n,), dtype=i32, device=dev),
            t=torch.empty((nl * n,), dtype=f32, device=dev))
        # K4's shadow rays; its outputs are each bounce's slots
        self.fwd = shade_mod.forward_buffers(nl, n, dev)
        del self.fwd["outs"]
        camera_mod.device_counters(dev)   # K6's, before any capture
        self.hrec, self.srec = records_mod.empty(sc)
        self.pack_records = records_mod.prepare(sc, self.hrec, self.srec)
        self.args = shade_mod.shade_args(sc, self.amb, self.srec, kd_tex,
                                         ks_tex)

    def stage(self, scene, ids, target, ambient, lr) -> None:
        """Bring the step's inputs up to date: the caller's leaves, ids,
        target and ``ambient`` copied into this state's (one
        ``_foreach_copy_`` a dtype), ``lr`` written, and on CUDA K1's and
        K4's records packed from the copies in place by one launch of K13.
        Nothing here waits for the card or allocates."""
        pairs = [(getattr(self.scene, k), getattr(scene, k))
                 for k in scene_lib.LEAF_NAMES]
        pairs += [(self.ids, ids), (self.target, target)]
        if torch.is_tensor(ambient):
            pairs.append((self.amb, ambient))
        else:
            self.amb.fill_(ambient)
        by_dtype = {}
        for dst, src in pairs:
            by_dtype.setdefault(dst.dtype, []).append((dst, src.detach()))
        for group in by_dtype.values():
            torch._foreach_copy_([d for d, _ in group],
                                 [s for _, s in group])
        if self.update:
            if self.cuda:
                self.lr.fill_(lr)
            else:
                self.lr = lr
        if self.cuda:
            self.pack_records()

    def capture(self) -> None:
        """Capture the step into its graph (``run`` with IF nodes), on a
        stream of its own; the capture only records. The launch counts it
        made are kept in ``captured`` and taken back out of
        ``_build.launches``: every replay adds them, those inside an IF
        node too, whether or not the node runs its body
        (``_build.skipped_launches`` tallies those of the bounces it did
        not run)."""
        before = dict(_build.launches)
        self.graph = _capture(self.dev, lambda: self.run(if_nodes=True))
        self.captured = {k: v - before[k] for k, v in _build.launches.items()}
        _build.launches.update(before)

    def replay(self) -> None:
        self.graph.replay()
        for k, v in self.captured.items():
            _build.launches[k] += v

    def run(self, if_nodes: bool = False) -> None:
        """The step: eagerly through the plain versions (the CPU), or into
        a graph being captured with IF nodes. The forward's IF nodes and
        the reverse's sit at the graph's top level; K12 of bounce k sets
        node k + 1 of both where it sets alive[k + 1]."""
        depth = self.max_depth
        sc = self.scene
        h, w = camera_mod.camera_frame(sc)
        self.camera_rays(h, w)
        self.acc.zero_()
        self.thr[0].fill_(1.0)
        self.tmax.fill_(FLT_MAX)
        self.alive.zero_()
        self.alive[:1].fill_(1)
        fwd = [None] * (depth + 1)
        rev = [None] * (depth + 1)
        if if_nodes:
            body = torch.cuda.Stream(self.dev)
            fwd[1:depth] = [_if_handle() for _ in range(1, depth)]
            rev[1:depth] = [_if_handle() for _ in range(1, depth)]
        for k in range(depth):
            with (contextlib.nullcontext() if fwd[k] is None
                  else _if_node(fwd[k], body)):
                self.forward(k, fwd[k + 1], rev[k + 1])
        # render_loss's ops, so the loss is the eager step's bits; its
        # cotangent (1 / M) * 2 (rgb - target), M = 3N, is one rounding
        diff = self.acc - self.target
        self.loss.copy_(torch.mean(diff ** 2))
        torch.mul(diff, 2.0 / diff.numel(), out=self.g_acc)
        for t in (self.g_thr, self.g_ro, self.g_rd, self.rev["sums"]):
            t.zero_()
        for k in reversed(range(depth)):
            with (contextlib.nullcontext() if rev[k] is None
                  else _if_node(rev[k], body)):
                self.reverse(k)
        self.leaf_grads(h, w)

    def camera_rays(self, h, w) -> None:
        sc = self.scene
        if self.cuda:
            camera_mod.camera_rays_launch(
                self.ids, sc.cam_axes, sc.cam_o, h, w, sc.cam_focus,
                self.width, self.height, self.samples,
                out=(self.uv, self.ro[0], self.rd[0]))
            return
        uv, ro, rd = camera_mod.camera_rays_plain(sc, self.ids, self.width,
                                                  self.height, self.samples)
        for dst, src in zip((self.uv, self.ro[0], self.rd[0]), (uv, ro, rd)):
            dst.copy_(src)

    def forward(self, k, next_if, rev_if) -> None:
        """Bounce ``k``, saving what its reverse reads; K12 writes bounce
        k + 1's slots, sets its alive word and, in the graph, both its IF
        nodes (``next_if``, ``rev_if``)."""
        sc = self.scene
        ro, rd = self.ro[k], self.rd[k]
        word, nxt = self.alive[k:k + 1], self.alive[k + 1:k + 2]
        if self.cuda:
            hits = traverse.intersect_scene_cuda(
                sc, ro, rd, self.tmin, self.tmax, records=self.hrec,
                alive=word, out=dict(hit=self.mask[k], inst=self.inst[k],
                                     prim=self.prim[k], t=self.t))
            color, kr, p, refl = shade_mod.shade_bounce_cuda(
                sc, ro, rd, hits, self.amb, self.occluder(word, k), word,
                self.kd_tex, self.ks_tex, None, self.srec,
                dict(self.fwd, outs=[self.color[k], self.kr[k], self.p,
                                     self.refl]))
        else:
            if not bool(word):   # the card's graph skips it whole
                return
            hits = traverse.intersect_scene_plain(sc, ro, rd, self.tmin,
                                                  self.tmax)
            for name, dst in (("hit", self.mask[k]), ("inst", self.inst[k]),
                              ("prim", self.prim[k])):
                dst.copy_(hits[name])

            def occluder(*args):
                return self.occ[k].copy_(self.plain_occluder(*args))

            color, kr, p, refl, _ = shade_mod.shade_step_plain(
                sc, ro, rd, hits, self.amb, hits["hit"], occluder,
                self.kd_tex, self.ks_tex)
            self.color[k].copy_(color)
            self.kr[k].copy_(kr)
        bounce_update_out(self.acc, self.thr[k], self.thr[k + 1],
                          self.ro[k + 1], self.rd[k + 1], self.tmax, color,
                          kr, p, refl, self.mask[k], word, nxt, next_if,
                          rev_if)

    def occluder(self, word, k):
        # K4 prep writes tmax = -FLT_MAX on the masked lanes' shadow rays
        # (see _FrameState.occluder); the hit flags land in bounce k's
        # occlusion slot, the rest in shared scratch
        out = dict(self.any_hits, hit=self.occ[k].view(-1))

        def occluder(p, d, tmin, tmax, mask):
            res = traverse.intersect_scene_cuda(
                self.scene, p.reshape(-1, 3), d.reshape(-1, 3),
                tmin.reshape(-1), tmax.reshape(-1), any_hit=True,
                records=self.hrec, alive=word, out=out)
            return res["hit"].reshape(p.shape[:-1])
        return occluder

    def reverse(self, k) -> None:
        """Bounce ``k``'s reverse: K14 from the carried cotangents (of
        bounce k + 1's thr, ro, rd) to the shading's and to thr's, then K5
        from the saved bounce to ro's and rd's, its leaf gradients added
        into the f64 sums."""
        if not self.cuda and not bool(self.alive[k]):
            return   # the card's graph skips it whole
        bounce_update_bwd(self.g_acc, self.g_thr, self.g_ro, self.g_rd,
                          self.thr[k], self.color[k], self.kr[k],
                          self.mask[k], self.g_shade)
        shade_mod.shade_bwd_into(
            self.scene, self.amb, self.ro[k], self.rd[k], self.inst[k],
            self.prim[k], self.mask[k], self.occ[k], self.g_shade,
            self.g_ro, self.g_rd, self.rev,
            self.args if self.cuda else None, self.kd_tex, self.ks_tex)

    def leaf_grads(self, h, w) -> None:
        """Every trained leaf's gradient, or with ``update`` its new value
        ``d - lr * g``, into ``out``: K5's sums rounded to f32 once, the
        camera's from K6 (bounce 0's d_ro, d_rd) and the frame chain,
        zeros where the loss does not reach."""
        sc = self.scene
        grads = dict(self.zeros)
        if any(k in shade_mod.GRAD_LEAVES for k in self.trained):
            grads.update(shade_mod.reverse_grads(self.rev, sc))
        if self.camera:
            cam = camera_mod.camera_rays_bwd(
                self.uv, self.g_ro, self.g_rd, sc.cam_axes, sc.cam_o, h, w,
                sc.cam_focus, out=self.cam_sums, partials=self.cam_partials)
            grads.update(zip(("cam_fovy", "cam_focus", "cam_aspect"),
                             camera_mod.camera_frame_bwd(sc, cam[12],
                                                         cam[13], cam[14])))
            grads.update(cam_axes=cam[0:9].view(3, 3), cam_o=cam[9:12])
        for k in self.trained:
            if self.update:
                torch.sub(getattr(sc, k), grads[k] * self.lr, out=self.out[k])
            else:
                self.out[k].copy_(grads[k])

    def results(self):
        """(loss, the out list of ``loss_grads_device``): clones, so that
        the next call leaves them as they are."""
        out = [None] * len(scene_lib.LEAF_NAMES)
        for k in self.trained:
            out[scene_lib.LEAF_NAMES.index(k)] = self.out[k].clone()
        return self.loss.clone(), out


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
    """A tensor on the host as numpy, in a buffer of its own (never a view
    of ``t``); from the card in one copy into page-locked memory (torch
    caches it): a fresh pageable buffer pays its page faults in the
    copy."""
    sp = tracer.begin("to_host")
    try:
        if t.device.type == "cpu":
            return t.numpy().copy()
        s = tracer.begin("pinned")
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        tracer.end(s)
        s = tracer.begin("copy")
        out = out.copy_(t).numpy()
        tracer.end(s)
        return out
    finally:
        tracer.end(sp)


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
    Returns (image, host scene, TorchScene, meta); the image is
    ``render_image``'s: (height, width, 4) f32 HDR, or u8 RGBA with ``ldr``.
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
