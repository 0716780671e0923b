"""Stochastic camera rays, plain torch: the benchmark's frozen copy.

Copied from yocto_raytracing_tpu_torch/render/camera.py (``pcg_hash``,
``per_ray_uniform``, ``pixel_uv_jittered``, ``eval_camera_dof``,
``camera_rays_stochastic_plain``) and ops/sampling.py (``sample_disk``) at
commit ad7840c, code unchanged but for the dtype of the uv, the lens
sample and the rays, which follows the camera leaves'. The variates are
exact in float32 in any case: the top 24 bits of a PCG hash of the ray id
under the seed, times 2^-24. Jitter variates come from ``seed``, lens
variates from ``seed ^ 0x9E3779B9``; the lens radius is aperture / 2, and
the origin moves across the aperture disk while the ray aims at the
pinhole target on the focus plane.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import intersect as isect
from .camera import camera_frame

U32 = 0xFFFFFFFF
LENS_SEED_XOR = 0x9E3779B9   # lens variates: seed ^ this
TWO_PIF = float(np.float32(2.0) * np.float32(math.pi))


def pcg_hash(x):
    """PCG output permutation (Jarzynski & Olano, "Hash Functions for GPU
    Rendering", JCGT 2020) on u32 values held in int64 tensors (or Python
    ints): every multiply and add is masked back to 32 bits, as u32
    arithmetic wraps."""
    x = (x * 747796405 + 2891336453) & U32
    w = (((x >> ((x >> 28) + 4)) ^ x) * 277803737) & U32
    return (w >> 22) ^ w


def per_ray_uniform(seed: int, ray_ids, n: int):
    """(N, n) f32 variates in [0, 1) keyed by ray id, not lane position:
    column k is the top 24 bits of ``pcg(id ^ pcg(seed + k))`` times
    2^-24 (exact in f32). ``seed`` is taken as u32."""
    base = ray_ids.to(torch.int64) & U32
    cols = []
    for k in range(n):
        h = pcg_hash(base ^ pcg_hash((seed + k) & U32))
        cols.append((h >> 8).to(torch.float32) * 2.0 ** -24)
    return torch.stack(cols, dim=-1)


def pixel_uv_jittered(width: int, height: int, samples: int, ray_ids,
                      seed: int, dtype=torch.float32):
    """Stratified-jittered sub-pixel uv: offsets ``(k + u01) / s`` instead
    of ``(k + 0.5) / s``, the same stratification cells, uniform within
    each; the variates are ``per_ray_uniform(seed, ids, 2)``. Runtime
    divisors, as in ``camera.pixel_uv``."""
    dev = ray_ids.device
    spp = samples * samples
    pix = ray_ids // spp
    sub = ray_ids % spp
    jj = sub // samples
    ii = sub % samples
    i = (pix % width).to(dtype)
    j = (pix // width).to(dtype)
    s = isect.device_scalar(samples, dev)
    r = per_ray_uniform(seed, ray_ids, 2).to(dtype)
    u = (i + (ii.to(dtype) + r[:, 0]) / s) / isect.device_scalar(width, dev)
    v = (j + (jj.to(dtype) + r[:, 1]) / s) / isect.device_scalar(height,
                                                                 dev)
    return pix, torch.stack([u, v], dim=-1)


def sample_disk(ruv):
    """Uniform unit disk (z = 0). yocto_math.h:3285-3289."""
    r = isect.sqrt(ruv[..., 1])
    phi = TWO_PIF * ruv[..., 0]
    return torch.stack([torch.cos(phi) * r, torch.sin(phi) * r,
                        torch.zeros_like(r)], dim=-1)


def eval_camera_dof(scene, uv, lens_uv, frame=None):
    """Thin-lens camera: uv (N, 2) and unit-disk lens samples (N, 2) ->
    (ro (N, 3), rd (N, 3)). With aperture 0 the rays are
    ``camera.eval_camera``'s."""
    h, w = camera_frame(scene) if frame is None else frame
    u = uv[:, 0:1]
    v = uv[:, 1:2]
    x = scene.cam_axes[0]
    y = -scene.cam_axes[1]
    z = scene.cam_axes[2]
    o = scene.cam_o
    q = o + (u - 0.5) * w * x + (v - 0.5) * h * y - scene.cam_focus * z
    lens = scene.cam_aperture / 2.0
    ro = o + lens * (lens_uv[:, 0:1] * x + lens_uv[:, 1:2] * y)
    d = q - ro
    d = d / isect.sqrt(isect.dot(d, d))[:, None]
    return ro, d


def camera_rays_stochastic_plain(scene, ids, width: int, height: int,
                                 samples: int, seed: int):
    """Plain torch stochastic rays: ids (N,) i32 -> (uv, ro, rd), in the
    camera leaves' dtype."""
    dt = scene.cam_o.dtype
    _, uv = pixel_uv_jittered(width, height, samples, ids, seed, dt)
    ruv = per_ray_uniform((seed & U32) ^ LENS_SEED_XOR, ids, 2).to(dt)
    lens = sample_disk(ruv)[:, :2]
    ro, rd = eval_camera_dof(scene, uv, lens)
    return uv, ro, rd
