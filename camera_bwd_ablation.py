"""Rays per thread and other choices of K6 and K9, the camera reverses
(``kernels/csrc/camera.cu``, ``stochastic.cu``, ``common.cuh``), on one
NVIDIA GPU.

    python3 camera_bwd_ablation.py [--rounds 3] [--reps 20] [--first-forms]
        [--sass PATH]

The inputs are ``chip_smoke.py``'s at the training batch: K6 on the middle
2**20 ray ids of the hair frame (910x512, 4x4 samples; uv from K2), K9 on
those of the area hair frame (aperture 0.1, seed 7), each with seeded
normal cotangents of (ro, rd). Device us per launch come from
torch.profiler, ``--reps`` launches a profile, summed over a variant's
kernel functions and each function apart, the variants in one order and
then the reverse, ``--rounds`` times (``chip_smoke.launch_us``: the mean
of the launches the trace kept).

``--first-forms`` times the first forms alone (``camera_bwd_simple.cu``,
its stage 1 and stage 2 apart). Either way the SASS of the package's camera
kernels (``cuobjdump -sass``) goes to ``--sass`` (by default
``camera_bwd_sass.txt`` in the package's git-ignored build directory).

Otherwise it also times the package's K6 and K9 and copies of them, each
with one thing changed (``kernel_variants``; the copies hold K2, K6, K7 and
K9):

* ``r1``, ``r2``, ``r4``, ``r16``: kCamRays rays a thread (the package: 8);
  their sums are held bit for bit to ``camera.ordered_camera_sums`` at that
  kCamRays; ``min1``, ``min3``: kCamMinBlocks blocks an SM in
  ``__launch_bounds__`` (the package: 4, at most 64 registers);
  ``r4_min6``: 4 rays a thread, 6 blocks an SM (42 registers);
* ``prefetch``: the next ray's inputs loaded before this ray's terms are
  computed (the package loads a ray's when it computes them);
  ``unrolled``: the loop over a thread's rays unrolled (the package keeps
  it rolled); both held bit-equal to the package;
* ``cosf_sinf``: the lens sample's sincosf as cosf and sinf, K7 and K9
  held bit-equal to the package; with it, ``lens`` and ``lens_cosf_sinf``
  write K7's lens sample (dx, dy) where K7 writes uv, and the two are
  compared bit for bit on every ray id of the area hair and area mirror
  frames;
* ``diag_no_tail`` (diagnostic, outputs not checked): the last block adds
  nothing, so the launch's time less this one's is what the fused column
  sums cost.

Nothing here changes the repository. The numbers are the card's, printed
beside its name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import subprocess
import tempfile

import torch

import chip_smoke as cs
import kernel_variants

_RAYS = "constexpr int kCamRays = 8;"
_MIN = "constexpr int kCamMinBlocks = 4;"
_ROLLED = "#pragma unroll 1\n  for (int ray = 0;"
_SINCOS = ("float sin_phi, cos_phi;\n  sincosf(phi, &sin_phi, &cos_phi);\n"
           "  return StochasticSample{u, v, cos_phi * r, sin_phi * r};")
_TRIG = "return StochasticSample{u, v, cosf(phi) * r, sinf(phi) * r};"
_UV_OUT = "uv[2 * k] = sm.u;\n  uv[2 * k + 1] = sm.v;"
_LENS_OUT = "uv[2 * k] = sm.dx;\n  uv[2 * k + 1] = sm.dy;"
_TAIL = "  if (!last) return;"
_LOOP6 = """    const int k = camera_ray(ray);
    if (k >= n) break;   // the rays of a thread go up with ray
    // the ray's inputs, all loaded before its terms: one wait a ray
    const float u = uv[2 * k], v = uv[2 * k + 1];
    const V3 g = load3(g_rd, k);
    const V3 gro = load3(g_ro, k);"""
_LOAD6 = """if (nk < n) {
      nu = uv[2 * nk];
      nv = uv[2 * nk + 1];
      ng = load3(g_rd, nk);
      ngro = load3(g_ro, nk);
    }"""
_LOOP9 = """    const int k = camera_ray(ray);
    if (k >= n) break;   // the rays of a thread go up with ray
    // the ray's inputs, all loaded before its terms: one wait a ray
    const int id = ids[k];
    const V3 g = load3(g_rd, k);
    const V3 gro = load3(g_ro, k);"""
_LOAD9 = """if (nk < n) {
      nid = ids[nk];
      ng = load3(g_rd, nk);
      ngro = load3(g_ro, nk);
    }"""
# the next ray's inputs (nu, nv or nid, ng, ngro, loaded for nk before the
# loop) kept in registers while this ray's terms are computed
_PREFETCH6 = f"""    const int k = nk;
    if (k >= n) break;
    const float u = nu, v = nv;
    const V3 g = ng, gro = ngro;
    nk = ray + 1 < kCamRays ? camera_ray(ray + 1) : n;
    {_LOAD6}"""
_PREFETCH9 = f"""    const int k = nk;
    if (k >= n) break;
    const int id = nid;
    const V3 g = ng, gro = ngro;
    nk = ray + 1 < kCamRays ? camera_ray(ray + 1) : n;
    {_LOAD9}"""
_HEAD = "#pragma unroll 1\n  for (int ray = 0; ray < kCamRays; ++ray) {\n"
_INIT6 = f"""  float nu = 0.0f, nv = 0.0f;
  V3 ng = make(0.0f, 0.0f, 0.0f), ngro = ng;
  int nk = camera_ray(0);
  {_LOAD6}
"""
_INIT9 = f"""  int nid = 0;
  V3 ng = make(0.0f, 0.0f, 0.0f), ngro = ng;
  int nk = camera_ray(0);
  {_LOAD9}
"""


def _rays(r: int) -> list:
    return [(_RAYS, _RAYS.replace("8", str(r)))]


def _min(b: int) -> list:
    return [(_MIN, _MIN.replace("4", str(b)))]


# variant: [(text in common.cuh + camera.cu + stochastic.cu, replacement)]
VARIANTS = {
    "r1": _rays(1),
    "r2": _rays(2),
    "r4": _rays(4),
    "r16": _rays(16),
    "min1": _min(1),
    "min3": _min(3),
    "r4_min6": _rays(4) + _min(6),
    "prefetch": [(_HEAD + _LOOP6, _INIT6 + _HEAD + _PREFETCH6),
                 (_HEAD + _LOOP9, _INIT9 + _HEAD + _PREFETCH9)],
    "unrolled": [(_ROLLED, _ROLLED.replace(" 1\n", "\n"))],
    "cosf_sinf": [(_SINCOS, _TRIG)],
    "lens": [(_UV_OUT, _LENS_OUT)],
    "lens_cosf_sinf": [(_SINCOS, _TRIG), (_UV_OUT, _LENS_OUT)],
    "diag_no_tail": [(_TAIL, "  if (threadIdx.x == 0) atomicSub(counter, 1);"
                      "\n  return;")],
}
ENTRY_POINTS = ("yrt_camera_rays", "yrt_camera_bwd_scratch", "yrt_camera_bwd",
                "yrt_camera_rays_stochastic", "yrt_camera_stochastic_bwd",
                "yrt_error_string")
_ERROR_STRING = ('\nextern "C" const char* yrt_error_string(int e) { return '
                 'cudaGetErrorString(static_cast<cudaError_t>(e)); }\n')


def combined_source() -> str:
    """common.cuh, camera.cu and stochastic.cu as one translation unit."""
    from yocto_raytracing_tpu_torch.kernels import _build

    text = "\n".join((_build.CSRC / f).read_text() for f in (
        "common.cuh", "camera.cu", "stochastic.cu"))
    return text.replace('#include "common.cuh"', "").replace(
        "#pragma once", "")


def build_variants(tmp: str) -> dict:
    base = combined_source()
    built = kernel_variants.build(tmp, {
        name: kernel_variants.edited(base, edits, name) + _ERROR_STRING
        for name, edits in VARIANTS.items()})
    return {name: (kernel_variants.load(so, ENTRY_POINTS), ptxas)
            for name, (so, ptxas) in built.items()}


def write_sass(path: str) -> None:
    """The SASS of the package library's camera kernels, to ``path``."""
    from yocto_raytracing_tpu_torch.kernels import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(_build.build().path)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    funcs = cs.sass_functions(text)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for name, lines in funcs.items():
            if "camera" in name:
                f.write(f"Function : {name}\n" + "\n".join(lines) + "\n\n")
                cs.log(f"SASS {name}: {cs.sass_count(lines)} instructions")
    cs.log(f"SASS written to {path}")


def inputs(device):
    """(K6 args, K9 args): the hair frame's middle 2**20 rays with their uv
    and cotangents; the area hair frame's middle 2**20 ids, its frame and
    cotangents."""
    from yocto_raytracing_tpu_torch import testscenes
    from yocto_raytracing_tpu_torch.render import camera, renderer

    gen = torch.Generator(device=device).manual_seed(11)
    n = cs.TRAIN_RAYS
    out = []
    for host in (testscenes.make_hair_scene(256), cs.area_hair_scene()):
        scene, _ = cs.scene_on(host, device)
        width = renderer.image_width(host.cameras[0].aspect, cs.RES)
        ids = cs.middle_ids(width, cs.RES, cs.SAMPLES, n, device)
        h, w = camera.camera_frame(scene)
        g = [torch.randn((n, 3), device=device, generator=gen)
             for _ in range(2)]
        out.append((scene, width, ids, h, w, g))
    (hs, hw, hids, hh, hwid, hg), (a, aw, aids, ah, awid, ag) = out
    with torch.no_grad():
        uv = camera.camera_rays_cuda(hs, hids, hw, cs.RES, cs.SAMPLES)[0]
    k6 = (uv, *hg, hs.cam_axes, hs.cam_o, hh, hwid, hs.cam_focus)
    k9 = (aids, a.cam_axes, a.cam_o, ah, awid, a.cam_focus, a.cam_aperture,
          aw, cs.RES, cs.SAMPLES, cs.SEED, *ag)
    return k6, k9


def profile(runs, rounds, reps) -> None:
    """Device us per launch of each run [(name, library or None, fn,
    DEVICE_FUNCTIONS key)], in turns, printed as RESULT lines."""
    us = {name: [] for name, *_ in runs}
    parts = {name: {} for name, *_ in runs}
    for r in range(rounds):
        for name, lib, fn, kind in (runs if r % 2 == 0 else runs[::-1]):
            with (kernel_variants.in_package(lib) if lib
                  else contextlib.nullcontext()):
                prof = cs.profile_summary(
                    lambda: [fn() for _ in range(reps)], name, (kind,))
            total, by_fn, kept = cs.launch_us(prof, kind)
            us[name].append(total)
            for fn_name, t in by_fn.items():
                parts[name].setdefault(fn_name, []).append(t)
            if kept < reps:
                cs.log(f"{name}: the trace kept {kept} of {reps} launches")
    smi = cs.nvidia_smi_line()
    for name, vals in us.items():
        cs.log(f"RESULT {name}: device us per launch "
               + ", ".join(f"{v:.2f}" for v in vals)
               + f" (mean {sum(vals) / len(vals):.2f}); by kernel "
               + ", ".join(f"{k} {sum(v) / len(v):.2f}"
                           for k, v in parts[name].items())
               + f"; on {smi}")


def check_variants(libs, k6, k9, device) -> None:
    """Each variant's outputs against the package's or the order of sums
    at its kCamRays; the lens samples of ``lens`` and ``lens_cosf_sinf`` on
    every ray id of the area hair and area mirror frames."""
    from yocto_raytracing_tpu_torch.kernels import parity
    from yocto_raytracing_tpu_torch.render import camera, renderer

    want6, want9 = camera.camera_rays_bwd(*k6), \
        camera.camera_rays_stochastic_bwd(*k9)
    terms6 = camera.camera_bwd_terms_plain(*k6)
    terms9 = camera.camera_stochastic_bwd_terms_plain(*k9)
    for name, (lib, _) in libs.items():
        if name.startswith("diag") or name.startswith("lens"):
            continue
        with kernel_variants.in_package(lib):
            got6 = camera.camera_rays_bwd(*k6)
            got9 = camera.camera_rays_stochastic_bwd(*k9)
        if name.startswith("r"):
            rays = camera.CAM_RAYS
            camera.CAM_RAYS = int(name[1:].split("_")[0])
            try:
                ok = (torch.equal(got6, camera.ordered_camera_sums(terms6)[:15])
                      and torch.equal(got9, camera.ordered_camera_sums(terms9)))
            finally:
                camera.CAM_RAYS = rays
        else:
            ok = torch.equal(got6, want6) and torch.equal(got9, want9)
        rep6 = parity.compare_camera_sums(got6, want6, terms6)
        rep9 = parity.compare_camera_sums(got9, want9, terms9)
        cs.log(f"{name}: sums as required {ok}; against the f64 sum K6 "
               f"{rep6['rel']:.3e}, K9 {rep9['rel']:.3e} (package "
               f"{rep6['simple_rel']:.3e}, {rep9['simple_rel']:.3e})")
        if not ok:
            raise AssertionError(f"{name}: sums differ")
    for host in (cs.area_hair_scene(), cs.area_mirror_scene()):
        scene, _ = cs.scene_on(host, device)
        width = renderer.image_width(host.cameras[0].aspect, cs.RES)
        ids = torch.arange(width * cs.RES * cs.SAMPLES ** 2,
                           dtype=torch.int32, device=device)
        lens = {}
        for name in ("lens", "lens_cosf_sinf"):
            with kernel_variants.in_package(libs[name][0]), torch.no_grad():
                lens[name] = camera.camera_rays_stochastic_cuda(
                    scene, ids, width, cs.RES, cs.SAMPLES, cs.SEED)[0]
        a, b = lens["lens"], lens["lens_cosf_sinf"]
        same = torch.equal(a.view(torch.int32), b.view(torch.int32))
        cs.log(f"lens samples of {ids.shape[0]} ray ids ({width}x{cs.RES}, "
               f"{cs.SAMPLES}x{cs.SAMPLES}): sincosf bit-equal to cosf, "
               f"sinf: {same} ({int((a != b).sum())} values differ)")
        if not same:
            raise AssertionError("sincosf differs from cosf, sinf")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--first-forms", action="store_true")
    ap.add_argument("--sass", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from yocto_raytracing_tpu_torch.kernels import _build, parity
    from yocto_raytracing_tpu_torch.render import camera

    device = torch.device("cuda")
    cs.log(f"device: {cs.nvidia_smi_line()}")
    info = _build.build()
    for line in info.log.splitlines():
        if "camera" in line or "Used" in line:
            cs.log("ptxas:", line.strip())
    write_sass(args.sass or str(_build.BUILD_DIR / "camera_bwd_sass.txt"))
    k6, k9 = inputs(device)
    runs = [("k6_simple", None, lambda: parity.camera_bwd_simple(*k6),
             "camera_bwd_simple"),
            ("k9_simple", None,
             lambda: parity.camera_stochastic_bwd_simple(*k9),
             "camera_bwd_stochastic_simple")]
    if args.first_forms:
        profile(runs, args.rounds, args.reps)
        return

    def k6_fn():
        return camera.camera_rays_bwd(*k6)

    def k9_fn():
        return camera.camera_rays_stochastic_bwd(*k9)

    def k7_fn():
        return camera.camera_rays_stochastic_launch(*k9[:11])

    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(tmp)
        for name, (_, ptxas) in libs.items():
            cs.log(f"{name}: ptxas " + "; ".join(ptxas))
        check_variants(libs, k6, k9, device)
        runs += [("k6", None, k6_fn, "camera_bwd"),
                 ("k9", None, k9_fn, "camera_bwd_stochastic"),
                 ("k7", None, k7_fn, "camera_rays_stochastic")]
        for name, (lib, _) in libs.items():
            if name.startswith("lens"):
                continue
            if name == "cosf_sinf":
                runs.append((f"k7_{name}", lib, k7_fn,
                             "camera_rays_stochastic"))
            else:
                runs.append((f"k6_{name}", lib, k6_fn, "camera_bwd"))
            runs.append((f"k9_{name}", lib, k9_fn, "camera_bwd_stochastic"))
        profile(runs, args.rounds, args.reps)
        camera._counters.clear()


if __name__ == "__main__":
    main()
