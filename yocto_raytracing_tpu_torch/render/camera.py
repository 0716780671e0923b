"""Camera ray generation: plain torch versions and the K2/K7 CUDA kernels.

Port of ``yocto_raytracing_tpu/render/camera.py``: pinhole camera with the
image plane at ``focus`` distance, plane height ``2*focus*tan(fovy/2)``,
width ``h*aspect``, y axis negated, uv in [0, 1]^2 with v growing downward
(src/raytrace.cpp:6-37, 228-239).

``camera_rays`` maps flat ray ids (pixel-major, sample-minor) to rays: the
plain version for CPU tensors (differentiable by torch autograd), K2
(``kernels/csrc/camera.cu``) for CUDA tensors, with K6 as its backward
(``CameraRaysFn``). Both take the frame scalars from ``camera_frame``.

The stochastic mode (jittered antialiasing and thin-lens depth of field)
is ``camera_rays_stochastic``: stateless PCG variates keyed by ray id
(``pcg_hash``, ``per_ray_uniform``), ``pixel_uv_jittered``, a unit-disk
lens sample and ``eval_camera_dof``; the plain chain for CPU tensors, K7
(``kernels/csrc/stochastic.cu``) for CUDA tensors, with K9 as its backward
(``CameraRaysStochasticFn``). K7 and K9 divide ray ids by the frame's spp,
samples and width with ``magic_divisor``'s multipliers.

K6 and K9 sum their per-ray terms in one launch, in an order that depends
on the batch size alone (``kernels/csrc/common.cuh``, ``camera_block_sums``).
``camera_bwd_terms_plain``, ``camera_stochastic_bwd_terms_plain`` and
``ordered_camera_sums`` repeat their terms and that order with torch ops, so
the kernels are held to them bit for bit; no path of the package calls
them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..kernels import _build
from ..ops import intersect as isect
from ..ops import sampling
from ..scene import TorchScene

U32 = 0xFFFFFFFF
LENS_SEED_XOR = 0x9E3779B9   # lens variates: seed ^ this (renderer.py:224)
# K6's and K9's sums (kernels/csrc/common.cuh): slots a ray, threads a
# block, rays a thread
CAM_SLOTS = 16
CAM_THREADS = 256
CAM_RAYS = 8


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
        uv, ro, rd = camera_rays_launch(ids, cam_axes, cam_o, h, w, focus,
                                        width, height, samples)
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


def camera_rays_launch(ids, cam_axes, cam_o, h, w, focus, width, height,
                       samples, out=None):
    """K2 launch, no autograd: (uv, ro, rd), written into ``out`` (three
    tensors of those shapes) when given. CUDA only."""
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
    uv, ro, rd = _outputs(out, n, dev)
    ptr = _build.ptr
    err = _build.library().yrt_camera_rays(
        ptr(ids), n, width, height, samples, ptr(cam_axes), ptr(cam_o),
        ptr(h), ptr(w), ptr(focus), ptr(uv), ptr(ro), ptr(rd),
        _build.current_stream())
    _build.check_launch(err, "yrt_camera_rays")
    _build.launches["camera_rays"] += 1
    return uv, ro, rd


def _outputs(out, n, dev):
    """The (uv (n, 2), ro (n, 3), rd (n, 3)) f32 outputs of a camera
    launch: ``out``, checked, or new tensors."""
    shapes = ((n, 2), (n, 3), (n, 3))
    if out is None:
        return [torch.empty(sh, dtype=torch.float32, device=dev)
                for sh in shapes]
    for name, t, sh in zip(("uv", "ro", "rd"), out, shapes):
        _build.check_tensor(name, t, torch.float32, sh, dev)
    return list(out)


def camera_rays_bwd(uv, g_ro, g_rd, cam_axes, cam_o, h, w, focus,
                    out=None, partials=None):
    """K6 launch: (15,) f32 = [d_cam_axes (9), d_cam_o (3), d_h, d_w,
    d_focus], summed over the batch in one launch, in the order of
    ``ordered_camera_sums``. With ``out`` and ``partials``
    (``camera_bwd_buffers``) the sums go into ``out`` (its first 15 slots
    are returned) and nothing is allocated. CUDA tensors launch K6 (or
    raise); CPU tensors take its plain version, ``ordered_camera_sums`` of
    ``camera_bwd_terms_plain``."""
    dev = uv.device
    n = uv.shape[0]
    f32 = torch.float32
    check = _build.check_tensor
    check("uv", uv, f32, (n, 2), dev)
    check("g_ro", g_ro, f32, (n, 3), dev)
    check("g_rd", g_rd, f32, (n, 3), dev)
    if (out is None) != (partials is None):
        raise ValueError("out and partials go together")
    if out is not None:
        check("out", out, f32, (CAM_SLOTS,), dev)
    if _build.device_kind(uv) == "cpu":
        sums = ordered_camera_sums(camera_bwd_terms_plain(
            uv, g_ro, g_rd, cam_axes, cam_o, h, w, focus))
        if out is None:
            return sums[:15]
        return out.copy_(sums)[:15]
    lib = _build.library()
    if out is None:
        out, partials = camera_bwd_buffers(n, dev)
    else:
        check("partials", partials, f32, (lib.yrt_camera_bwd_scratch(n),),
              dev)
    ptr = _build.ptr
    err = lib.yrt_camera_bwd(
        ptr(uv), ptr(g_ro), ptr(g_rd), n, ptr(cam_axes), ptr(cam_o), ptr(h),
        ptr(w), ptr(focus), ptr(partials), ptr(out), _counter(dev, 0),
        _build.current_stream())
    _build.check_launch(err, "yrt_camera_bwd")
    _build.launches["camera_bwd"] += 1
    return out[:15]


def camera_bwd_buffers(n: int, dev):
    """K6's output and scratch for ``n`` rays, made once by a caller that
    launches it many times: ((CAM_SLOTS,) f32 sums, f32 block partials; on
    the CPU an empty partials tensor, which the plain version does not
    read)."""
    f32 = torch.float32
    dev = torch.device(dev)
    size = _build.library().yrt_camera_bwd_scratch(n) if (
        dev.type == "cuda") else 0
    return (torch.empty(CAM_SLOTS, dtype=f32, device=dev),
            torch.empty(size, dtype=f32, device=dev))


def camera_frame_bwd(scene: TorchScene, d_h, d_w, d_focus):
    """The reverse of ``camera_frame`` (h = 2 * focus * tan(fovy / 2),
    w = h * aspect) as explicit ops, in torch autograd's order: from the
    cotangents of h and w and focus's own term (K6's d_focus) to
    (d cam_fovy, d cam_focus, d cam_aspect), 0-dim tensors."""
    t = torch.tan(scene.cam_fovy / 2.0)
    a = 2.0 * scene.cam_focus
    g_h = d_h + d_w * scene.cam_aspect
    g_aspect = d_w * (a * t)
    g_focus = d_focus + (g_h * t) * 2.0
    g_fovy = (g_h * a) * (1.0 + t * t) / 2.0
    return g_fovy, g_focus, g_aspect


# device -> (2,) i32: K6's and K9's counters of finished blocks
_counters: dict = {}


def device_counters(device) -> torch.Tensor:
    """K6's and K9's counters on ``device`` (``_counter``), made on first
    use: a caller that captures a launch into a CUDA graph makes them
    first, so that they are not the graph's memory."""
    c = _counters.get(device)
    if c is None:
        c = _counters[device] = torch.zeros(2, dtype=torch.int32,
                                            device=device)
    return c


def _counter(device, which: int) -> ctypes.c_void_p:
    """The counter of K6 (``which`` 0) or K9 (1) on ``device``: an i32 at
    0, which each launch's last block sets back to 0, allocated once per
    device. Launches of one kernel on one device share it, so they must not
    overlap: the wrappers launch on the current stream."""
    return ctypes.c_void_p(device_counters(device).data_ptr() + 4 * which)


def camera_bwd_terms_plain(uv, g_ro, g_rd, cam_axes, cam_o, h, w, focus):
    """K6's per-ray terms, (N, 16) f32 (slot 15 is 0): the adjoint of
    ``eval_camera`` for the cotangents (g_ro, g_rd), op for op as
    ``camera.cu::camera_bwd_kernel`` computes them."""
    x, y, z, o = cam_axes[0], -cam_axes[1], cam_axes[2], cam_o
    u, v = uv[:, 0:1], uv[:, 1:2]
    cu = (u - 0.5) * w
    cv = (v - 0.5) * h
    q = o + x * cu + y * cv - z * focus
    d = q - o
    nrm = isect.sqrt(isect.dot(d, d))[:, None]
    rd = d / nrm
    c = isect.dot(g_rd, rd)[:, None]
    gq = (g_rd - rd * c) / nrm
    return torch.cat([gq * cu, -gq * cv, -gq * focus, g_ro,
                      (v - 0.5) * isect.dot(gq, y)[:, None],
                      (u - 0.5) * isect.dot(gq, x)[:, None],
                      -isect.dot(gq, z)[:, None], torch.zeros_like(u)],
                     dim=1)


def _lanes_sum(x):
    """x (..., 32, S) -> (..., S): the sum over a warp's lanes in the
    kernels' tree, lane + (lane ^ 16), then ^ 8, ^ 4, ^ 2, ^ 1."""
    for half in (16, 8, 4, 2, 1):
        x = x.reshape(*x.shape[:-2], 2, half, x.shape[-1])
        x = x[..., 0, :, :] + x[..., 1, :, :]
    return x[..., 0, :]


def ordered_camera_sums(terms):
    """(N, 16) per-ray terms -> (16,) sums in K6's and K9's order
    (``common.cuh``, ``camera_block_sums``), with elementwise adds: a tile
    of CAM_THREADS * CAM_RAYS rays a block, a thread's rays added in turn,
    its warp's lanes in the tree of ``_lanes_sum``, the block's warps in
    order, then lane l of the last block the blocks l, l + 32, ... and the
    lanes' tree. Padding with zeros adds nothing: each sum starts at +0, so
    it is never -0."""
    n = terms.shape[0]
    tile = CAM_THREADS * CAM_RAYS
    nb = max(1, -(-n // tile))
    kw = dict(dtype=terms.dtype, device=terms.device)
    t = torch.zeros((nb * tile, CAM_SLOTS), **kw)
    t[:n] = terms
    t = t.view(nb, CAM_RAYS, CAM_THREADS, CAM_SLOTS)
    acc = torch.zeros((nb, CAM_THREADS, CAM_SLOTS), **kw)
    for r in range(CAM_RAYS):
        acc = acc + t[:, r]
    warps = _lanes_sum(acc.view(nb, CAM_THREADS // 32, 32, CAM_SLOTS))
    part = torch.zeros((nb, CAM_SLOTS), **kw)
    for wi in range(CAM_THREADS // 32):
        part = part + warps[:, wi]
    rows = -(-nb // 32)
    p = torch.zeros((rows * 32, CAM_SLOTS), **kw)
    p[:nb] = part
    p = p.view(rows, 32, CAM_SLOTS)
    lanes = torch.zeros((32, CAM_SLOTS), **kw)
    for row in range(rows):
        lanes = lanes + p[row]
    return _lanes_sum(lanes)


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


# --------------------------------------------------------------------------
# stochastic mode: PCG variates, jittered uv, thin lens (K7)
# --------------------------------------------------------------------------


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
    2^-24 (exact in f32). The same ray gets the same variates however the
    batch is chunked. ``seed`` is taken as u32."""
    base = ray_ids.to(torch.int64) & U32
    cols = []
    for k in range(n):
        h = pcg_hash(base ^ pcg_hash((seed + k) & U32))
        cols.append((h >> 8).to(torch.float32) * 2.0 ** -24)
    return torch.stack(cols, dim=-1)


def magic_divisor(d: int) -> tuple:
    """(m, l) with n // d == (m * n) >> (31 + l) for every n in [0, 2^31):
    l = ceil(log2 d) and m = ceil(2^(31 + l) / d) < 2^32, the round-up
    method of Granlund and Montgomery ("Division by invariant integers
    using multiplication", PLDI 1994, section 4). K7 and K9 divide by d as
    ``__umulhi(m, 2 n) >> l``, the same quotient."""
    if not 1 <= d < 2 ** 31:
        raise ValueError(f"divisor {d} not in [1, 2^31)")
    l = (d - 1).bit_length()
    return -(-(1 << (31 + l)) // d), l


@functools.lru_cache(maxsize=64)
def _frame_magic(width: int, samples: int) -> tuple:
    if samples * samples >= 2 ** 31:
        raise ValueError(f"samples {samples}: spp not below 2^31")
    return (*magic_divisor(samples * samples), *magic_divisor(samples),
            *magic_divisor(width))


def _magic_arg(width: int, samples: int):
    """K7's and K9's divisors of a frame, [m, l] of spp, samples and width,
    as the u32 array their entry points take."""
    return (ctypes.c_uint32 * 6)(*_frame_magic(width, samples))


def pixel_uv_jittered(width: int, height: int, samples: int, ray_ids,
                      seed: int):
    """Stratified-jittered sub-pixel uv: offsets ``(k + u01) / s`` instead
    of ``(k + 0.5) / s``, the same stratification cells, uniform within
    each; the variates are ``per_ray_uniform(seed, ids, 2)``. Runtime
    divisors, as in ``pixel_uv``."""
    dev = ray_ids.device
    spp = samples * samples
    pix = ray_ids // spp
    sub = ray_ids % spp
    jj = sub // samples
    ii = sub % samples
    i = (pix % width).to(torch.float32)
    j = (pix // width).to(torch.float32)
    s = isect.device_scalar(samples, dev)
    r = per_ray_uniform(seed, ray_ids, 2)
    u = (i + (ii.to(torch.float32) + r[:, 0]) / s) / isect.device_scalar(
        width, dev)
    v = (j + (jj.to(torch.float32) + r[:, 1]) / s) / isect.device_scalar(
        height, dev)
    return pix, torch.stack([u, v], dim=-1)


def eval_camera_dof(scene: TorchScene, uv, lens_uv, frame=None):
    """Thin-lens camera: uv (N, 2) and unit-disk lens samples (N, 2) ->
    (ro (N, 3), rd (N, 3)).

    The pinhole target q already lies on the focus plane, so the origin
    moves across the aperture disk (radius aperture / 2 in the camera's
    x/y plane) and the ray aims at q: points on the focus plane stay sharp.
    With aperture 0 the rays are ``eval_camera``'s.
    """
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


def camera_rays_stochastic_plain(scene: TorchScene, ids, width: int,
                                 height: int, samples: int, seed: int):
    """Plain torch stochastic rays: ids (N,) i32 -> (uv, ro, rd). Jitter
    variates from ``seed``, lens variates from ``seed ^ 0x9E3779B9``
    (the JAX renderer's chain, renderer.py:214-227)."""
    _, uv = pixel_uv_jittered(width, height, samples, ids, seed)
    ruv = per_ray_uniform((seed & U32) ^ LENS_SEED_XOR, ids, 2)
    lens = sampling.sample_disk(ruv)[:, :2]
    ro, rd = eval_camera_dof(scene, uv, lens)
    return uv, ro, rd


def seed_word_value(seed: int) -> int:
    """The i32 whose bits are the seed's 32 (``seed & 0xFFFFFFFF``): what a
    seed word holds, and what K7 and K8 read from it as u32."""
    v = seed & U32
    return v - (1 << 32) if v >> 31 else v


def _seed_args(seed, device) -> tuple:
    """(u32 seed, seed word pointer or None) of a K7 or K8 launch: an int
    seed is passed by value; a (1,) i32 tensor on the launch's device is
    the word the kernel reads instead."""
    if isinstance(seed, torch.Tensor):
        _build.check_tensor("seed_word", seed, torch.int32, (1,), device)
        return 0, _build.ptr(seed)
    return seed & U32, None


def _check_stochastic_args(ids, cam_axes, cam_o, h, w, focus, aperture,
                           width, height, samples):
    dev = ids.device
    f32 = torch.float32
    check = _build.check_tensor
    check("ids", ids, torch.int32, (ids.shape[0],), dev)
    check("cam_axes", cam_axes, f32, (3, 3), dev)
    check("cam_o", cam_o, f32, (3,), dev)
    for name, t in (("h", h), ("w", w), ("cam_focus", focus),
                    ("cam_aperture", aperture)):
        check(name, t, f32, (), dev)
    if min(width, height, samples) < 1:
        raise ValueError(f"bad frame {width}x{height}, samples {samples}")


class CameraRaysStochasticFn(torch.autograd.Function):
    """K7 forward, K9 backward.

    Inputs that carry gradients: ``cam_axes`` (3, 3), ``cam_o`` (3) and the
    0-dim ``h``, ``w``, ``focus`` and ``aperture``; ``h`` and ``w`` come
    from ``camera_frame``, so d_fovy and d_aspect follow by torch autograd.
    The backward recomputes the uv and lens samples from the ids and the
    seed, so it saves no per-ray tensor but the ids.
    """

    @staticmethod
    def forward(ctx, ids, cam_axes, cam_o, h, w, focus, aperture, width,
                height, samples, seed):
        uv, ro, rd = camera_rays_stochastic_launch(
            ids, cam_axes, cam_o, h, w, focus, aperture, width, height,
            samples, seed)
        ctx.mark_non_differentiable(uv)
        ctx.frame = (width, height, samples, seed)
        ctx.save_for_backward(ids, cam_axes, cam_o, h, w, focus, aperture)
        return uv, ro, rd

    @staticmethod
    def backward(ctx, _g_uv, g_ro, g_rd):
        out = camera_rays_stochastic_bwd(*ctx.saved_tensors, *ctx.frame,
                                         g_ro.contiguous(), g_rd.contiguous())
        return (None, out[0:9].reshape(3, 3), out[9:12], out[12], out[13],
                out[14], out[15], None, None, None, None)


def camera_rays_stochastic_launch(ids, cam_axes, cam_o, h, w, focus,
                                  aperture, width, height, samples, seed,
                                  out=None):
    """K7 launch, no autograd: (uv, ro, rd), written into ``out`` when
    given. CUDA only. ``seed`` is an int, or a (1,) i32 device tensor
    holding the seed's 32 bits (``seed_word``), which K7 reads when it runs:
    a captured graph's launch then follows the word."""
    _check_stochastic_args(ids, cam_axes, cam_o, h, w, focus, aperture,
                           width, height, samples)
    uv, ro, rd = _outputs(out, ids.shape[0], ids.device)
    value, word = _seed_args(seed, ids.device)
    ptr = _build.ptr
    err = _build.library().yrt_camera_rays_stochastic(
        ptr(ids), ids.shape[0], width, height, samples,
        _magic_arg(width, samples), value, word,
        ptr(cam_axes), ptr(cam_o), ptr(h), ptr(w), ptr(focus), ptr(aperture),
        ptr(uv), ptr(ro), ptr(rd), _build.current_stream())
    _build.check_launch(err, "yrt_camera_rays_stochastic")
    _build.launches["camera_rays_stochastic"] += 1
    return uv, ro, rd


def camera_rays_stochastic_bwd(ids, cam_axes, cam_o, h, w, focus, aperture,
                               width, height, samples, seed, g_ro, g_rd):
    """K9 launch: (16,) f32 = [d_cam_axes (9), d_cam_o (3), d_h, d_w,
    d_focus, d_aperture], summed over the batch in one launch, in the order
    of ``ordered_camera_sums``, for the cotangents of K7's (ro, rd). CUDA
    only."""
    _check_stochastic_args(ids, cam_axes, cam_o, h, w, focus, aperture,
                           width, height, samples)
    dev = ids.device
    n = ids.shape[0]
    f32 = torch.float32
    _build.check_tensor("g_ro", g_ro, f32, (n, 3), dev)
    _build.check_tensor("g_rd", g_rd, f32, (n, 3), dev)
    lib = _build.library()
    partials = torch.empty(lib.yrt_camera_bwd_scratch(n), dtype=f32,
                           device=dev)
    out = torch.empty(CAM_SLOTS, dtype=f32, device=dev)
    ptr = _build.ptr
    err = lib.yrt_camera_stochastic_bwd(
        ptr(ids), n, width, height, samples, _magic_arg(width, samples),
        seed & U32, ptr(g_ro), ptr(g_rd), ptr(cam_axes), ptr(cam_o), ptr(h),
        ptr(w), ptr(focus), ptr(aperture), ptr(partials), ptr(out),
        _counter(dev, 1), _build.current_stream())
    _build.check_launch(err, "yrt_camera_stochastic_bwd")
    _build.launches["camera_bwd_stochastic"] += 1
    return out


def camera_stochastic_bwd_terms_plain(ids, cam_axes, cam_o, h, w, focus,
                                      aperture, width, height, samples, seed,
                                      g_ro, g_rd):
    """K9's per-ray terms, (N, 16) f32: the jittered uv and lens sample of
    the plain chain, then the adjoint of ``eval_camera_dof`` for the
    cotangents (g_ro, g_rd), op for op as
    ``stochastic.cu::camera_stochastic_bwd_kernel`` computes them."""
    _, uv = pixel_uv_jittered(width, height, samples, ids, seed)
    lens_uv = sampling.sample_disk(per_ray_uniform(
        (seed & U32) ^ LENS_SEED_XOR, ids, 2))
    x, y, z, o = cam_axes[0], -cam_axes[1], cam_axes[2], cam_o
    u, v = uv[:, 0:1], uv[:, 1:2]
    dx, dy = lens_uv[:, 0:1], lens_uv[:, 1:2]
    lens = aperture / 2.0
    q = o + x * ((u - 0.5) * w) + y * ((v - 0.5) * h) - z * focus
    e = o + (x * dx + y * dy) * lens
    d = q - e
    nrm = isect.sqrt(isect.dot(d, d))[:, None]
    rdn = d / nrm
    cg = isect.dot(g_rd, rdn)[:, None]
    gq = (g_rd - rdn * cg) / nrm
    ge = g_ro - gq
    cu = (u - 0.5) * w
    cv = (v - 0.5) * h
    gel = ge * lens
    gx = gq * cu + gel * dx
    gy = gq * cv + gel * dy
    return torch.cat([gx, -gy, -gq * focus, g_ro,
                      (v - 0.5) * isect.dot(gq, y)[:, None],
                      (u - 0.5) * isect.dot(gq, x)[:, None],
                      -isect.dot(gq, z)[:, None],
                      isect.dot(ge, x * dx + y * dy)[:, None] / 2.0], dim=1)


def camera_rays_stochastic_cuda(scene: TorchScene, ids, width: int,
                                height: int, samples: int, seed: int):
    """K7 launch (K9 in the backward): same contract as
    ``camera_rays_stochastic_plain``, CUDA only, no host sync."""
    h, w = camera_frame(scene)
    return CameraRaysStochasticFn.apply(
        ids, scene.cam_axes, scene.cam_o, h, w, scene.cam_focus,
        scene.cam_aperture, width, height, samples, seed)


def camera_rays_stochastic(scene: TorchScene, ids, width: int, height: int,
                           samples: int, seed: int):
    """Jittered, thin-lens camera rays for flat ray ids: (uv, ro, rd).

    CPU tensors take the plain chain (differentiable by torch autograd);
    CUDA tensors launch K7 (or raise), and K9 in the backward. ``uv``
    carries no gradient.
    """
    if _build.device_kind(ids) == "cpu":
        return camera_rays_stochastic_plain(scene, ids, width, height,
                                            samples, seed)
    return camera_rays_stochastic_cuda(scene, ids, width, height, samples,
                                       seed)
