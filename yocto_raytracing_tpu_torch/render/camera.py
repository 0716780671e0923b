"""Camera ray generation: plain torch versions and the K2 CUDA kernel.

Port of ``yocto_raytracing_tpu/render/camera.py`` (deterministic path):
pinhole camera with the image plane at ``focus`` distance, plane height
``2*focus*tan(fovy/2)``, width ``h*aspect``, y axis negated, uv in [0, 1]^2
with v growing downward (src/raytrace.cpp:6-37, 228-239).

``camera_rays`` maps flat ray ids (pixel-major, sample-minor) to rays: the
plain version for CPU tensors (differentiable by torch autograd), K2
(``kernels/csrc/camera.cu``) for CUDA tensors, with K6 as its backward
(``CameraRaysFn``). Both take the frame scalars from ``camera_frame``.
"""

from __future__ import annotations

import torch

from ..kernels import _build
from ..ops import intersect as isect
from ..scene import TorchScene


def pixel_uv(width: int, height: int, samples: int, ray_ids):
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
    i = (pix % width).to(torch.float32)
    j = (pix // width).to(torch.float32)
    s = isect.device_scalar(samples, dev)
    u = (i + (ii.to(torch.float32) + 0.5) / s) / isect.device_scalar(width, dev)
    v = (j + (jj.to(torch.float32) + 0.5) / s) / isect.device_scalar(height, dev)
    return pix, torch.stack([u, v], dim=-1)


def camera_frame(scene: TorchScene):
    """The image-plane scalars (h, w) as 0-dim tensors:
    h = 2 * focus * tan(fovy / 2), w = h * aspect."""
    h = 2.0 * scene.cam_focus * torch.tan(scene.cam_fovy / 2.0)
    return h, h * scene.cam_aspect


def eval_camera(scene: TorchScene, uv, frame=None):
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


def camera_rays_plain(scene: TorchScene, ids, width: int, height: int,
                      samples: int):
    """Plain torch ray generation: ids (N,) i32 -> (uv (N, 2), ro, rd)."""
    _, uv = pixel_uv(width, height, samples, ids)
    ro, rd = eval_camera(scene, uv)
    return uv, ro, rd


class CameraRaysFn(torch.autograd.Function):
    """K2 forward, K6 backward.

    Inputs that carry gradients: ``cam_axes`` (3, 3), ``cam_o`` (3) and the
    0-dim frame scalars ``h``, ``w``, ``focus``; the frame scalars come from
    ``camera_frame``, so d_fovy and d_aspect follow by torch autograd.
    """

    @staticmethod
    def forward(ctx, ids, cam_axes, cam_o, h, w, focus, width, height,
                samples):
        dev = ids.device
        n = ids.shape[0]
        f32 = torch.float32
        check = _build.check_tensor
        check("ids", ids, torch.int32, (n,), dev)
        check("cam_axes", cam_axes, f32, (3, 3), dev)
        check("cam_o", cam_o, f32, (3,), dev)
        for name, t in (("h", h), ("w", w), ("focus", focus)):
            check(name, t, f32, (), dev)
        if min(width, height, samples) < 1:
            raise ValueError(f"bad frame {width}x{height}, samples {samples}")
        uv = torch.empty((n, 2), dtype=f32, device=dev)
        ro = torch.empty((n, 3), dtype=f32, device=dev)
        rd = torch.empty((n, 3), dtype=f32, device=dev)
        ptr = _build.ptr
        err = _build.library().yrt_camera_rays(
            ptr(ids), n, width, height, samples, ptr(cam_axes), ptr(cam_o),
            ptr(h), ptr(w), ptr(focus), ptr(uv), ptr(ro), ptr(rd),
            _build.current_stream())
        _build.check_launch(err, "yrt_camera_rays")
        _build.launches["camera_rays"] += 1
        ctx.mark_non_differentiable(uv)
        ctx.save_for_backward(uv, cam_axes, cam_o, h, w, focus)
        return uv, ro, rd

    @staticmethod
    def backward(ctx, _g_uv, g_ro, g_rd):
        uv, cam_axes, cam_o, h, w, focus = ctx.saved_tensors
        out = camera_rays_bwd(uv, g_ro.contiguous(), g_rd.contiguous(),
                              cam_axes, cam_o, h, w, focus)
        return (None, out[0:9].reshape(3, 3), out[9:12], out[12], out[13],
                out[14], None, None, None)


def camera_rays_bwd(uv, g_ro, g_rd, cam_axes, cam_o, h, w, focus):
    """K6 launch: (15,) f32 = [d_cam_axes (9), d_cam_o (3), d_h, d_w,
    d_focus], summed over the batch in a fixed order. CUDA only."""
    dev = uv.device
    n = uv.shape[0]
    f32 = torch.float32
    check = _build.check_tensor
    check("uv", uv, f32, (n, 2), dev)
    check("g_ro", g_ro, f32, (n, 3), dev)
    check("g_rd", g_rd, f32, (n, 3), dev)
    lib = _build.library()
    partials = torch.empty(lib.yrt_camera_bwd_scratch(n), dtype=f32,
                           device=dev)
    out = torch.empty(15, dtype=f32, device=dev)
    ptr = _build.ptr
    err = lib.yrt_camera_bwd(
        ptr(uv), ptr(g_ro), ptr(g_rd), n, ptr(cam_axes), ptr(cam_o), ptr(h),
        ptr(w), ptr(focus), ptr(partials), ptr(out), _build.current_stream())
    _build.check_launch(err, "yrt_camera_bwd")
    _build.launches["camera_bwd"] += 1
    return out


def camera_rays_cuda(scene: TorchScene, ids, width: int, height: int,
                     samples: int):
    """K2 launch (K6 in the backward): same contract as
    ``camera_rays_plain``, CUDA only. No host sync: the frame scalars go to
    the kernel by device pointer."""
    h, w = camera_frame(scene)
    return CameraRaysFn.apply(ids, scene.cam_axes, scene.cam_o, h, w,
                              scene.cam_focus, width, height, samples)


def camera_rays(scene: TorchScene, ids, width: int, height: int,
                samples: int):
    """Camera rays for flat ray ids: (uv (N, 2), ro (N, 3), rd (N, 3)).

    CPU tensors take the plain version; CUDA tensors launch K2 (or raise),
    and K6 in the backward. ``uv`` carries no gradient.
    """
    if _build.device_kind(ids) == "cpu":
        return camera_rays_plain(scene, ids, width, height, samples)
    return camera_rays_cuda(scene, ids, width, height, samples)
