"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from this checkout and holds each against its
plain torch version on the card: K1 hit, K2 camera rays, K3 pixel finish,
K4 shading (bit-equal), K5 shading backward and K6 camera backward (relative
L2 error <= 1e-4 per gradient leaf). Then it drives the port's two paths
through their user entry points:

* rendering, ``render_scene_file(..., device="cuda")``: the hair scene
  (lines + triangles + two point lights; the stand-in for the reference's
  lines/refl scenes) at 910x512 with 4x4 samples, depth 4, and the mirror
  scene (``make_grad_scene``, a kr=0.5 mirror) at 512x512, 4x4 samples,
  depth 4;
* training, ``parallel.mesh.train_step`` on 2**20 rays per step (the JAX
  bench's training batch) of the same two frames, towards a target rendered
  with perturbed ``mat_kd`` and ``light_ke``: step 1 with every float leaf
  trainable, its loss against the plain path and its gradient against an
  f64 reference, then 5 steps on the materials and lights with a strictly
  falling loss.

Each path runs with the launch counts set to 0 just before it and read just
after, and fails if a kernel of the path never launched.

Every phase raises on failure, so the exit code is non-zero unless all of
them pass. Without a CUDA device it exits non-zero before printing any
result. The line before the last is the per-kernel JSON record
(``{"kernels": [...]}``); the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

FLT_MAX = np.float32(3.4028235e38)
CHUNK_PIXELS = 1 << 15
COMPARE_PIXELS = 1 << 18
GRAD_RAYS = 1 << 16          # K5/K6 comparisons per scene
TRAIN_RAYS = 1 << 20         # rays per training step (bench.py:242)
GRAD_RTOL = 1e-4             # K5/K6 relative L2 error per leaf
# gradient of render_loss on the kernel path against its f64 reference (the
# plain path in f64 on the kernel path's hits), relative L2 per leaf: 1e-4,
# the K5 bound; where f32 arithmetic alone misses it (the plain f32 path is
# as far from the reference: hair cam_fovy 6.4e-4, cam_aspect 2.5e-4, norm
# 1.4e-4 at 2**20 rays on an H100), 1.25x the plain path's own error
TRAIN_GRAD_RTOL = 1e-4
TRAIN_PLAIN_FACTOR = 1.25
TRAIN_LR = 1.0
TRAIN_SUBSET = ("mat_kd", "mat_ks", "light_ke")
SAMPLES, DEPTH, RES = 4, 4, 512


def log(*args):
    print(*args, flush=True)


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` warm calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def profile_summary(fn, label: str) -> dict:
    """One call of ``fn`` under torch.profiler: wall ms (host clock, ends in
    a synchronize), device busy ms (sum of the trace's device events), the
    idle share of the wall, the number of device ops and the top ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not evs:
        raise AssertionError(f"profile {label}: the trace holds no device "
                             f"event")
    busy = sum(e.time_range.elapsed_us() for e in evs) / 1e3
    by_name = {}
    for e in evs:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    out = dict(wall_ms=wall, busy_ms=busy, idle=1.0 - busy / wall,
               ops=len(evs))
    log(f"profile {label}: wall {wall:.2f} ms, device busy {busy:.2f} ms, "
        f"idle share {out['idle']:.3f}, device ops {len(evs)}; top: "
        + "; ".join(f"{n[:48]} {t / 1e3:.2f} ms" for n, t in top))
    return out


def ordered(x: np.ndarray) -> np.ndarray:
    """f32 -> int64 whose differences count ULPs across zero."""
    i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
    return np.where(i < 0, -(i & 0x7FFFFFFF), i)


def assert_hits_equal(a: dict, b: dict, what: str) -> int:
    """``hit`` equal, ``t`` within 1 ULP, ``inst``/``prim`` equal where
    ``t`` is bit-equal. Returns the number of bit-equal t."""
    a = {k: v.cpu().numpy() for k, v in a.items()}
    b = {k: v.cpu().numpy() for k, v in b.items()}
    if not np.array_equal(a["hit"], b["hit"]):
        raise AssertionError(f"{what}: hit differs on "
                             f"{int((a['hit'] != b['hit']).sum())} rays")
    ulp = np.abs(ordered(a["t"]) - ordered(b["t"]))
    if ulp.max() > 1:
        raise AssertionError(f"{what}: t differs by {ulp.max()} ULP")
    exact = a["t"] == b["t"]
    for k in ("inst", "prim"):
        if not np.array_equal(a[k][exact], b[k][exact]):
            raise AssertionError(f"{what}: {k} differs")
    return int(exact.sum())


def random_rays(seed: int, n: int, device):
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-4, 4, size=(n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return (torch.from_numpy(ro).to(device), torch.from_numpy(rd).to(device),
            torch.full((n,), 1e-4, device=device),
            torch.full((n,), float(FLT_MAX), device=device))


def scene_on(host, device):
    from yocto_raytracing_tpu_torch import scene as scene_lib

    leaves, meta = scene_lib.build_device_scene(host)
    return scene_lib.to_torch(leaves, device), meta


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this run needs an NVIDIA GPU")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    log(f"device: {kind} (count {count}); torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log("nvidia-smi name, power.limit:")
    log(smi)
    return dict(kind=kind, count=count, smi=smi)


def phase_build():
    from yocto_raytracing_tpu_torch import kernels

    info = kernels.build()
    log(f"build: {info.seconds:.1f} s -> {info.path.name}")
    for line in info.log.splitlines():
        if ("registers" in line or "spill" in line
                or "Compiling entry" in line):
            log("  ptxas:", line.strip())


def phase_hit_kernel(device):
    """K1 against the plain walk, nearest and any-hit."""
    from yocto_raytracing_tpu_torch import testscenes
    from yocto_raytracing_tpu_torch.ops import traverse

    cases = [(f"random seed {s}", lambda s=s: testscenes.make_random_scene(
        seed=s), 1 << 16, 100 + s) for s in range(4)]
    cases.append(("hair 256", lambda: testscenes.make_hair_scene(256),
                  1 << 16, 200))
    cases.append(("random 10004 instances", lambda: testscenes.
                  make_random_scene(n_instances=10004), 1 << 16, 300))
    for name, make, n, seed in cases:
        scene, _ = scene_on(make(), device)
        rays = random_rays(seed, n, device)
        n = rays[0].shape[0]
        for any_hit in (False, True):
            t0 = time.perf_counter()
            plain = traverse.intersect_scene_plain(scene, *rays, any_hit)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            kern = traverse.intersect_scene(scene, *rays, any_hit)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            what = f"K1 {name} {'any' if any_hit else 'nearest'}-hit"
            exact = assert_hits_equal(plain, kern, what)
            log(f"{what}: {n} rays, {int(kern['hit'].sum())} hits, "
                f"t bit-equal {exact}/{n} (tolerance: hit equal, t within "
                f"1 ULP); plain {t1 - t0:.2f} s, kernel {t2 - t1:.4f} s")


def phase_frame_kernels(scene, width, height, samples, device) -> dict:
    """K2, K1 and K3 on the middle chunk of the hair frame (the rows that
    cross the hair ball): kernel against plain, values and CUDA-event
    times."""
    from yocto_raytracing_tpu_torch.ops import traverse
    from yocto_raytracing_tpu_torch.render import camera, renderer

    spp = samples * samples
    n = CHUNK_PIXELS * spp
    first = (width * height // 2 // CHUNK_PIXELS) * CHUNK_PIXELS
    ids = torch.arange(first * spp, first * spp + n, dtype=torch.int32,
                       device=device)
    rec = {}

    a = camera.camera_rays_plain(scene, ids, width, height, samples)
    b = camera.camera_rays(scene, ids, width, height, samples)
    for x, y, what in zip(a, b, ("uv", "ro", "rd")):
        ulp = np.abs(ordered(x.cpu().numpy()) - ordered(y.cpu().numpy()))
        if ulp.max() > 1:
            raise AssertionError(f"K2 {what}: {ulp.max()} ULP")
    err = max(float((x - y).abs().max()) for x, y in zip(a, b))
    rec["camera_rays"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: camera.camera_rays(scene, ids, width, height,
                                              samples), 20),
        plain_ms=cuda_ms(lambda: camera.camera_rays_plain(
            scene, ids, width, height, samples), 5))
    log(f"K2 camera rays: {n} rays, max |kernel - plain| {err} "
        f"(tolerance 1 ULP)")

    _, ro, rd = b
    tmin = torch.full((n,), 1e-4, device=device)
    tmax = torch.full((n,), float(FLT_MAX), device=device)
    plain = traverse.intersect_scene_plain(scene, ro, rd, tmin, tmax)
    kern = traverse.intersect_scene(scene, ro, rd, tmin, tmax)
    exact = assert_hits_equal(plain, kern, "K1 hair primary rays")
    both = plain["hit"] & kern["hit"]
    err = float((plain["t"][both] - kern["t"][both]).abs().max()) \
        if bool(both.any()) else 0.0
    rec["hit"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: traverse.intersect_scene(scene, ro, rd, tmin,
                                                     tmax), 10),
        plain_ms=cuda_ms(lambda: traverse.intersect_scene_plain(
            scene, ro, rd, tmin, tmax), 1))
    log(f"K1 hair primary rays: {n} rays, {int(kern['hit'].sum())} hits, "
        f"t bit-equal {exact}/{n} (tolerance: hit equal, t within 1 ULP)")

    rgb = renderer.trace_rays(scene, ids, torch.full((3,), 0.1,
                                                     device=device),
                              width, height, samples, 4).contiguous()
    errs = []
    for ldr in (False, True):
        x = renderer.pixel_finish_plain(rgb, spp, ldr)
        y = renderer.pixel_finish(rgb, spp, ldr)
        if ldr:
            d = (x.int() - y.int()).abs().max().item()
            if d > 1:
                raise AssertionError(f"K3 ldr: {d} u8 steps")
        else:
            d = (x - y).abs().max().item()
            if not bool(((x - y).abs() <= 1e-6 * x.abs()).all()):
                raise AssertionError(f"K3 sums: max abs diff {d}")
        errs.append(float(d))
    rec["pixel_finish"] = dict(
        max_abs_err=max(errs),
        ms=cuda_ms(lambda: renderer.pixel_finish(rgb, spp, True), 20),
        plain_ms=cuda_ms(lambda: renderer.pixel_finish_plain(rgb, spp, True),
                         5))
    log(f"K3 pixel finish: {CHUNK_PIXELS} pixels x {spp} spp, "
        f"max |kernel - plain| sums {errs[0]}, u8 {errs[1]} (tolerance: "
        f"sums 1e-6 relative, u8 1 step)")
    return rec


FRAME_KERNELS = ("hit", "camera_rays", "pixel_finish", "shade")
TRAIN_KERNELS = ("hit", "camera_rays", "shade", "shade_bwd", "camera_bwd")


def phase_frame(path, resolution, samples, max_depth, device, dev_info,
                name) -> dict:
    """One frame through render_scene_file on the card, its launch counts,
    and the first COMPARE_PIXELS pixels against the all-plain path."""
    from yocto_raytracing_tpu_torch import kernels
    from yocto_raytracing_tpu_torch.render import renderer

    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    img, host, scene, meta = renderer.render_scene_file(
        path, resolution, samples, max_depth=max_depth,
        chunk_pixels=CHUNK_PIXELS, device=device, ldr=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kernels.launches)
    height, width = img.shape[:2]
    spp = samples * samples
    rays = width * height * spp
    log(f"frame {name}: {width}x{height} x {spp} spp = {rays} primary rays, "
        f"depth {max_depth}: {wall:.3f} s wall, {rays / wall / 1e6:.3f} "
        f"Mrays/s on {dev_info['smi']}; launches {counts}")
    if img.shape != (resolution, width, 4) or img.dtype != np.uint8:
        raise AssertionError(f"frame {name}: bad image {img.shape} "
                             f"{img.dtype}")
    if not (img[..., 3] == 255).all() or img[..., :3].max() == 0:
        raise AssertionError(f"frame {name}: alpha or black frame")
    for k in FRAME_KERNELS:
        if counts[k] <= 0:
            raise AssertionError(f"frame {name}: kernel {k} never launched")
    prof = profile_summary(lambda: renderer.render_scene_file(
        path, resolution, samples, max_depth=max_depth,
        chunk_pixels=CHUNK_PIXELS, device=device, ldr=True),
        f"warm frame {name}")

    # all-plain path on the card, first COMPARE_PIXELS pixels
    npix = min(COMPARE_PIXELS, width * height)
    amb = torch.full((3,), 0.1, dtype=torch.float32, device=scene.device)
    parts = []
    t0 = time.perf_counter()
    for start in range(0, npix, CHUNK_PIXELS):
        stop = min(start + CHUNK_PIXELS, npix)
        ids = torch.arange(start * spp, stop * spp, dtype=torch.int32,
                           device=scene.device)
        rgb = renderer.trace_rays(scene, ids, amb, width, height, samples,
                                  max_depth, meta.has_kd_textures,
                                  meta.has_ks_textures, plain=True)
        parts.append(renderer.pixel_finish_plain(rgb, spp, True))
    plain = torch.cat(parts).cpu().numpy()
    got = img.reshape(-1, 4)[:npix, :3]
    d = np.abs(plain.astype(np.int32) - got)
    log(f"frame {name}: kernel vs all-plain on {npix} pixels: max "
        f"{d.max()} u8 steps, {int((d > 0).any(axis=1).sum())} pixels "
        f"differ ({time.perf_counter() - t0:.1f} s)")
    if d.max() > 1:
        raise AssertionError(f"frame {name}: {d.max()} u8 steps off plain")
    return dict(counts=counts, wall=wall, rays=rays, image=img, prof=prof)


def phase_small_reference(path, device):
    """The port on the card against the port on the CPU (plain torch, held
    to the JAX package and the reference golden by the CPU tests): the hair
    scene at 96p, HDR within 1e-5 and device tonemap within 1 u8 step."""
    from yocto_raytracing_tpu_torch.render import renderer

    for ldr in (False, True):
        gpu, *_ = renderer.render_scene_file(path, 96, 1, device=device,
                                             ldr=ldr)
        cpu, *_ = renderer.render_scene_file(path, 96, 1, device="cpu",
                                             ldr=ldr)
        if not np.isfinite(gpu.astype(np.float32)).all():
            raise AssertionError("small reference: non-finite pixels")
        d = np.abs(gpu.astype(np.float64) - cpu).max()
        limit = 1.0 if ldr else 1e-5
        log(f"small reference (hair 96p, {'ldr' if ldr else 'hdr'}): "
            f"max |cuda - cpu| {d}")
        if d > limit:
            raise AssertionError(f"small reference: {d} > {limit}")


def middle_ids(width, height, samples, n, device, last=False):
    """``n`` consecutive ray ids (scanline order) from the middle of the
    frame, or its end with ``last``."""
    total = width * height * samples * samples
    first = total - n if last else (total // 2 - n // 2)
    return torch.arange(first, first + n, dtype=torch.int32, device=device)


def phase_shade_kernel(cases, device) -> dict:
    """K4 against the plain shading on the same K1 hits and the same K1
    shadow query: bit-equal outputs (ULP gap 0) and equal masks. The first
    case is timed (CUDA events, both with the K1 shadow query)."""
    from yocto_raytracing_tpu_torch.kernels import parity
    from yocto_raytracing_tpu_torch.render import shade

    amb = torch.full((3,), 0.1, device=device)
    rec = None
    for name, scene, meta, w, h, bounce, last in cases:
        ids = middle_ids(w, h, SAMPLES, CHUNK_PIXELS * SAMPLES * SAMPLES,
                         device, last)
        inputs = parity.shade_inputs(scene, ids, w, h, SAMPLES, bounce, amb)
        rep = parity.compare_shade(scene, inputs, amb, meta.has_kd_textures,
                                   meta.has_ks_textures)
        gaps = {k: rep[k] for k in parity.SHADE_OUTPUTS}
        log(f"K4 shade {name}: {ids.shape[0]} rays, bounce {bounce}, "
            f"{rep['hits']} hits; ULP gap kernel vs plain {gaps}, mask equal "
            f"{rep['mask_equal']} (tolerance: bit-equal)")
        if not rep["mask_equal"] or any(gaps.values()):
            raise AssertionError(f"K4 {name}: {rep}")
        if rec is None:
            occ = parity.occluder(scene)
            ro, rd, hits, active = inputs

            def run(fn):
                with torch.no_grad():
                    fn(scene, ro, rd, hits, amb, active, occ,
                       meta.has_kd_textures, meta.has_ks_textures)

            rec = dict(max_abs_err=rep["max_abs_err"],
                       ms=cuda_ms(lambda: run(shade.shade_step_cuda), 10),
                       plain_ms=cuda_ms(lambda: run(shade.shade_step_plain),
                                        3))
            log(f"K4 shade {name}: kernel {rec['ms']:.3f} ms, plain "
                f"{rec['plain_ms']:.3f} ms per bounce (both with the K1 "
                f"shadow query)")
    return rec


def _backward_ms(outs, wrt, cots, reps):
    return cuda_ms(lambda: torch.autograd.grad(outs, wrt, cots,
                                               retain_graph=True), reps)


def phase_grad_kernels(cases, device) -> dict:
    """K5 and K6 against torch autograd of the plain versions for seeded
    cotangents: GRAD_RAYS rays per scene, then the training batch
    (TRAIN_RAYS) of the first case, which is also timed."""
    from yocto_raytracing_tpu_torch.kernels import parity
    from yocto_raytracing_tpu_torch.render import camera, shade

    amb = torch.full((3,), 0.1, device=device)
    gen = torch.Generator(device=device)
    rec = {}
    for k, (name, scene, meta, w, h, bounce, last) in enumerate(cases):
        for n in ((GRAD_RAYS, TRAIN_RAYS) if k == 0 else (GRAD_RAYS,)):
            ids = middle_ids(w, h, SAMPLES, n, device, last)
            inputs = parity.shade_inputs(scene, ids, w, h, SAMPLES, bounce,
                                         amb)
            gen.manual_seed(100 + k)
            rep = parity.compare_shade_grads(
                scene, inputs, amb, gen, meta.has_kd_textures,
                meta.has_ks_textures)
            worst = parity.check_grads(rep, GRAD_RTOL, f"K5 {name}")
            nonzero = sorted(x for x, r in rep.items() if r["norm"] > 0)
            log(f"K5 shade_bwd {name}: {n} rays, bounce {bounce}: largest "
                f"relative L2 error {worst:.3e} over ro, rd and "
                f"{len(rep) - 2} scene leaves (tolerance {GRAD_RTOL}); "
                f"plain zeros kept; non-zero: {', '.join(nonzero)}")
            gen.manual_seed(200 + k)
            crep = parity.compare_camera_grads(scene, ids, w, h, SAMPLES,
                                               gen)
            focus = crep.pop("cam_focus")
            cworst = parity.check_grads(crep, GRAD_RTOL, f"K6 {name}")
            if focus["max_abs"] > 1e-5 * crep["cam_axes"]["norm"]:
                raise AssertionError(f"K6 {name} cam_focus: {focus}")
            log(f"K6 camera_bwd {name}: {n} rays: largest relative L2 "
                f"error {cworst:.3e} (tolerance {GRAD_RTOL}); d_focus "
                f"{focus['norm']:.3e} kernel-plain {focus['max_abs']:.3e} "
                f"(zero up to rounding)")
            if n != TRAIN_RAYS:
                continue
            # time both backwards at the training batch
            ro, _, hits, active = inputs
            cots = [torch.randn(ro.shape, device=device, generator=gen)
                    * (active & hits["hit"])[:, None] for _ in range(4)]
            times = {}
            for which, fn, reps in (("ms", shade.shade_step_cuda, 10),
                                    ("plain_ms", shade.shade_step_plain, 3)):
                outs, wrt = parity.shade_graph(fn, scene, inputs, amb,
                                               meta.has_kd_textures,
                                               meta.has_ks_textures)
                times[which] = _backward_ms(outs, list(wrt.values()), cots,
                                            reps)
                del outs
            rec["shade_bwd"] = dict(
                max_abs_err=max(r["max_abs"] for r in rep.values()), **times)
            log(f"K5 shade_bwd {name}: backward of one bounce at {n} rays: "
                f"kernel {times['ms']:.3f} ms, plain autograd "
                f"{times['plain_ms']:.3f} ms")
            cam_cots = [torch.randn((n, 3), device=device, generator=gen)
                        for _ in range(2)]
            times = {}
            for which, fn, reps in (("ms", camera.camera_rays_cuda, 20),
                                    ("plain_ms", camera.camera_rays_plain,
                                     5)):
                outs, leaves = parity.camera_graph(fn, scene, ids, w, h,
                                                   SAMPLES)
                times[which] = _backward_ms(outs, list(leaves.values()),
                                            cam_cots, reps)
            rec["camera_bwd"] = dict(
                max_abs_err=max(r["max_abs"] for r in crep.values()),
                **times)
            log(f"K6 camera_bwd {name}: backward at {n} rays: kernel "
                f"{times['ms']:.3f} ms, plain autograd "
                f"{times['plain_ms']:.3f} ms (the kernel's include the "
                f"fovy/aspect chain in torch)")
    return rec


def perturbed(scene, seed):
    """The scene with mat_kd and light_ke scaled by 1 + 0.2 N(0, 1)
    (seeded numpy): what the training target is rendered from."""
    import dataclasses

    rng = np.random.default_rng(seed)
    out = {}
    for name in ("mat_kd", "light_ke"):
        x = getattr(scene, name)
        f = 1 + 0.2 * rng.standard_normal(tuple(x.shape))
        out[name] = x * torch.from_numpy(f.astype(np.float32)).to(x.device)
    return dataclasses.replace(scene, **out)


def phase_train(name, scene, w, h, last, device, dev_info) -> dict:
    """``train_step`` on TRAIN_RAYS rays. Step 1 with every float leaf
    trainable: its loss equal to the plain path's, the kernel path's
    gradient within TRAIN_GRAD_RTOL of the f64 reference
    (``parity.compare_loss_grads``, the plain path's own error printed
    beside it), and the step's update ``d - lr * g`` of that gradient.
    Then 5 steps on TRAIN_SUBSET with a strictly falling loss; wall times,
    memory and one profiled warm step."""
    from yocto_raytracing_tpu_torch import kernels
    from yocto_raytracing_tpu_torch.kernels import parity
    from yocto_raytracing_tpu_torch.parallel import mesh
    from yocto_raytracing_tpu_torch.render import renderer

    amb = torch.full((3,), 0.1, device=device)
    ids = middle_ids(w, h, SAMPLES, TRAIN_RAYS, device, last)
    kw = dict(width=w, height=h, samples=SAMPLES, max_depth=DEPTH)
    target = renderer.trace_rays(perturbed(scene, 7), ids, amb, w, h,
                                 SAMPLES, DEPTH)

    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    new_k, loss_k = mesh.train_step(scene, ids, target, amb, TRAIN_LR, **kw)
    torch.cuda.synchronize()
    wall1 = time.perf_counter() - t0
    counts = dict(kernels.launches)
    for k in TRAIN_KERNELS:
        if counts[k] <= 0:
            raise AssertionError(f"train {name}: kernel {k} never launched")

    t0 = time.perf_counter()
    rep = parity.compare_loss_grads(scene, ids, target, amb, **kw)
    torch.cuda.synchronize()
    compare_s = time.perf_counter() - t0
    lk = float(loss_k)
    for what in ("loss", "plain_loss"):
        if not abs(rep[what] - lk) <= 1e-5 * abs(lk):
            raise AssertionError(f"train {name}: step loss {lk} vs {what} "
                                 f"{rep[what]}")
    bounds = parity.loss_grad_bounds(rep, TRAIN_GRAD_RTOL,
                                     TRAIN_PLAIN_FACTOR)
    worst = parity.check_grads(rep["kernel"], bounds,
                               f"train {name} gradient")
    worst_leaf = max(rep["kernel"], key=lambda k: rep["kernel"][k]["rel"])
    focus = float(rep["grads"]["cam_focus"].abs())
    if focus > 1e-5 * rep["kernel"]["cam_axes"]["norm"]:
        raise AssertionError(f"train {name}: d cam_focus {focus}")
    parity.check_update(scene, new_k, rep["grads"], TRAIN_LR,
                        f"train {name}")
    moved = sorted(k for k, r in rep["kernel"].items() if r["norm"] > 0)
    wide = sorted(k for k, b in bounds.items() if b > TRAIN_GRAD_RTOL)
    log(f"train {name}: step 1, all float leaves trainable, {TRAIN_RAYS} "
        f"rays: loss {lk!r} (kernel render_loss {rep['loss']!r}, plain "
        f"path {rep['plain_loss']!r}, f64 reference {rep['ref_loss']!r}); "
        f"gradient vs the f64 reference: largest relative L2 error "
        f"{worst:.3e} ({worst_leaf}; tolerance {TRAIN_GRAD_RTOL} per leaf, "
        f"{TRAIN_PLAIN_FACTOR}x the plain f32 path's own error on "
        f"{', '.join(wide) or 'no leaf'}), the plain f32 path's largest "
        f"{max(r['rel'] for r in rep['plain'].values()):.3e}"
        f"; d cam_focus {focus:.3e} (zero up to rounding); update = d - lr "
        f"* g on every float leaf; kernel step {wall1:.3f} s, the three "
        f"gradients {compare_s:.1f} s; launches {counts}")
    log(f"train {name}: per leaf, relative L2 error vs the f64 reference, "
        f"kernel path / plain path: " + ", ".join(
            f"{k} {rep['kernel'][k]['rel']:.2e}/{rep['plain'][k]['rel']:.2e}"
            for k in moved))
    if name == "mirror" and rep["kernel"]["mat_kr"]["norm"] == 0:
        raise AssertionError("train mirror: no gradient through the bounce")

    cur = scene
    losses, walls = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cur, loss = mesh.train_step(cur, ids, target, amb, TRAIN_LR,
                                    trainable=TRAIN_SUBSET, **kw)
        losses.append(float(loss))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    log(f"train {name}: 5 steps on {', '.join(TRAIN_SUBSET)}, lr "
        f"{TRAIN_LR}: losses {[repr(x) for x in losses]}; step wall "
        f"{', '.join(f'{x:.4f}' for x in walls)} s = "
        f"{', '.join(f'{TRAIN_RAYS / x / 1e6:.2f}' for x in walls)} Mrays/s "
        f"on {dev_info['smi']}; peak memory {peak / 2**30:.2f} GiB")
    if not all(np.isfinite(losses)) or not all(
            b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"train {name}: loss not strictly falling "
                             f"{losses}")
    prof = profile_summary(lambda: mesh.train_step(
        cur, ids, target, amb, TRAIN_LR, trainable=TRAIN_SUBSET, **kw),
        f"warm train step {name}")
    return dict(counts=counts, walls=walls, peak=peak, prof=prof)


def main() -> None:
    dev_info = phase_device()
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from yocto_raytracing_tpu_torch import scene as scene_lib, testscenes
    from yocto_raytracing_tpu_torch.render import renderer

    phase_build()
    phase_hit_kernel(device)

    with tempfile.TemporaryDirectory() as tmp:
        hair_obj = os.path.join(tmp, "hair.obj")
        scene_lib.save_scene(testscenes.make_hair_scene(256), hair_obj)
        grad_obj = os.path.join(tmp, "mirror.obj")
        scene_lib.save_scene(testscenes.make_grad_scene(), grad_obj)

        hair = scene_lib.load_scene(hair_obj)
        hscene, hmeta = scene_on(hair, device)
        mscene, mmeta = scene_on(scene_lib.load_scene(grad_obj), device)
        tscene, tmeta = scene_on(testscenes.make_textured_hair_scene(256),
                                 device)
        width = renderer.image_width(hair.cameras[0].aspect, RES)
        rec = phase_frame_kernels(hscene, width, RES, SAMPLES, device)
        # (name, scene, meta, width, height, bounce, rays from the end)
        cases = [("hair", hscene, hmeta, width, RES, 1, False),
                 ("mirror", mscene, mmeta, RES, RES, 2, True),
                 ("textured hair", tscene, tmeta, width, RES, 1, False)]
        rec["shade"] = phase_shade_kernel(cases, device)
        rec.update(phase_grad_kernels(cases, device))

        main_frame = phase_frame(hair_obj, RES, SAMPLES, DEPTH, device,
                                 dev_info, "hair")
        phase_frame(grad_obj, RES, SAMPLES, DEPTH, device, dev_info,
                    "mirror")
        phase_small_reference(hair_obj, device)
        main_train = phase_train("hair", hscene, width, RES, False, device,
                                 dev_info)
        phase_train("mirror", mscene, RES, RES, True, device, dev_info)

    src = "yocto_raytracing_tpu_torch/kernels/csrc/"
    table = {  # name: (source, replaces, path that runs it)
        "hit": ("hit.cu", "yocto_raytracing_tpu/ops/traverse.py:82",
                main_frame),
        "camera_rays": ("camera.cu",
                        "yocto_raytracing_tpu/render/camera.py:124",
                        main_frame),
        "pixel_finish": ("pixel.cu",
                         "yocto_raytracing_tpu/render/renderer.py:106",
                         main_frame),
        "shade": ("shade.cu", "yocto_raytracing_tpu/render/shade.py:159",
                  main_frame),
        "shade_bwd": ("shade_bwd.cu",
                      "yocto_raytracing_tpu/render/shade.py:159",
                      main_train),
        "camera_bwd": ("camera.cu",
                       "yocto_raytracing_tpu/render/camera.py:27",
                       main_train),
    }
    kernels_rec = [dict(name=k, route="cuda", source=src + f, replaces=r,
                        launches=path["counts"][k], **rec[k])
                   for k, (f, r, path) in table.items()]
    print(json.dumps({"kernels": kernels_rec}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_info["kind"],
        "count": dev_info["count"]}}))


if __name__ == "__main__":
    sys.exit(main())
