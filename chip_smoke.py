"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from this checkout, holds each against its
plain torch version on the card, then renders the port's main path twice
through the user entry point ``render_scene_file(..., device="cuda")``:

* the hair scene (lines + triangles + two point lights; the stand-in for
  the reference's lines/refl scenes) at 910x512 with 4x4 samples, depth 4;
* the mirror scene (``make_grad_scene``, a kr=0.5 mirror) at 512x512, 4x4
  samples, depth 4.

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
                  make_random_scene(n_instances=10004), 1 << 18, 300))
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
    for k, v in counts.items():
        if v <= 0:
            raise AssertionError(f"frame {name}: kernel {k} never launched")

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
    return dict(counts=counts, wall=wall, rays=rays, image=img)


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


def main() -> None:
    dev_info = phase_device()
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from yocto_raytracing_tpu_torch import scene as scene_lib, testscenes

    phase_build()
    phase_hit_kernel(device)

    with tempfile.TemporaryDirectory() as tmp:
        hair_obj = os.path.join(tmp, "hair.obj")
        scene_lib.save_scene(testscenes.make_hair_scene(256), hair_obj)
        grad_obj = os.path.join(tmp, "mirror.obj")
        scene_lib.save_scene(testscenes.make_grad_scene(), grad_obj)

        hair = scene_lib.load_scene(hair_obj)
        hscene, _ = scene_on(hair, device)
        from yocto_raytracing_tpu_torch.render import renderer

        width = renderer.image_width(hair.cameras[0].aspect, 512)
        rec = phase_frame_kernels(hscene, width, 512, 4, device)

        main_frame = phase_frame(hair_obj, 512, 4, 4, device, dev_info,
                                 "hair")
        phase_frame(grad_obj, 512, 4, 4, device, dev_info, "mirror")
        phase_small_reference(hair_obj, device)

    src = "yocto_raytracing_tpu_torch/kernels/csrc/"
    replaces = {
        "hit": "yocto_raytracing_tpu/ops/traverse.py:82",
        "camera_rays": "yocto_raytracing_tpu/render/camera.py:124",
        "pixel_finish": "yocto_raytracing_tpu/render/renderer.py:106",
    }
    files = {"hit": "hit.cu", "camera_rays": "camera.cu",
             "pixel_finish": "pixel.cu"}
    kernels_rec = [dict(name=k, route="cuda", source=src + files[k],
                        replaces=replaces[k],
                        launches=main_frame["counts"][k], **rec[k])
                   for k in ("hit", "camera_rays", "pixel_finish")]
    print(json.dumps({"kernels": kernels_rec}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_info["kind"],
        "count": dev_info["count"]}}))


if __name__ == "__main__":
    sys.exit(main())
