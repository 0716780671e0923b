"""Pinhole camera rays, plain torch: the benchmark's frozen copy.

Copied from yocto_raytracing_tpu_torch/render/camera.py at commit 2bec3df
(``pixel_uv``, ``camera_frame``, ``eval_camera``, ``camera_rays_plain``),
code unchanged but for the dtype of the uv, which follows the camera
leaves'. Flat ray ids are pixel-major, sample-minor; sub-sample offsets
``((ii + 0.5) / s, (jj + 0.5) / s)``; the image plane at ``focus``.
"""

from __future__ import annotations

import torch

from . import intersect as isect


def pixel_uv(width: int, height: int, samples: int, ray_ids,
             dtype=torch.float32):
    """Flat ray id -> (pixel id, stratified uv (N, 2)).

    Sub-sample offsets ``((ii+0.5)/s, (jj+0.5)/s)``, jj-major, as in the
    reference loop (raytrace.cpp:228-239). Width, height and samples are
    runtime divisors: dividing by a literal may become a multiplication by
    its reciprocal, which is not the reference's IEEE quotient.
    """
    dev = ray_ids.device
    spp = samples * samples
    pix = ray_ids // spp
    sub = ray_ids % spp
    jj = sub // samples
    ii = sub % samples
    i = (pix % width).to(dtype)
    j = (pix // width).to(dtype)
    s = isect.device_scalar(samples, dev)
    u = (i + (ii.to(dtype) + 0.5) / s) / isect.device_scalar(width, dev)
    v = (j + (jj.to(dtype) + 0.5) / s) / isect.device_scalar(height, dev)
    return pix, torch.stack([u, v], dim=-1)


def camera_frame(scene):
    """The image-plane scalars (h, w) as 0-dim tensors:
    h = 2 * focus * tan(fovy / 2), w = h * aspect."""
    h = 2.0 * scene.cam_focus * torch.tan(scene.cam_fovy / 2.0)
    return h, h * scene.cam_aspect


def eval_camera(scene, uv, frame=None):
    """uv (N, 2) -> (ro (N, 3), rd (N, 3)), pinhole camera."""
    h, w = camera_frame(scene) if frame is None else frame
    u = uv[:, 0:1]
    v = uv[:, 1:2]
    x = scene.cam_axes[0]
    y = -scene.cam_axes[1]
    z = scene.cam_axes[2]
    o = scene.cam_o
    q = o + (u - 0.5) * w * x + (v - 0.5) * h * y - scene.cam_focus * z
    d = q - o
    d = d / isect.sqrt(isect.dot(d, d))[:, None]
    return o.expand(d.shape), d


def camera_rays_plain(scene, ids, width: int, height: int,
                      samples: int):
    """Plain torch ray generation: ids (N,) i32 -> (uv (N, 2), ro, rd)."""
    _, uv = pixel_uv(width, height, samples, ids, scene.cam_o.dtype)
    ro, rd = eval_camera(scene, uv)
    return uv, ro, rd
