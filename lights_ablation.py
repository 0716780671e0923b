"""Block sizes and rays per thread of K8 and K10 (``kernels/csrc/lights.cu``)
on one NVIDIA GPU.

    python3 lights_ablation.py [--rounds 3] [--reps 20]

Builds copies of ``lights.cu`` into a temporary directory, each with a
constant changed, and profiles them in turns with the package's build and
the first forms (``lights_simple.cu``): device us per launch from
torch.profiler, summed over each variant's kernels (and each kernel
function apart), ``--reps`` launches per profile, the variants in one
order and then the reverse, ``--rounds`` times. The cases are
``chip_smoke.py``'s: (a) the area hair frame's lights, a quad and a
4-segment polyline, (b) the area mirror frame's quad, (c) the area hair
frame with light1 a lamp panel of 32 x 32 cells (2,048 triangles, 1,089
vertices), and (c8) one of 8 x 8 cells (128 triangles, 81 vertices: K10's
shared-row path). K8 runs on the middle 524,288 ray ids of the frame, K10
on the middle 2**20 with a seeded normal cotangent, and on (a) also with
the cotangent that a stochastic training step hands it
(``chip_smoke.stochastic_loss_step`` and ``step_light_cotangent``; unlit
and dead rays give zero rows). Every variant's outputs are
checked against the package's: K8 bit for bit, K10 within 1e-6 relative
L2 (another partition of the rays adds the f64 sums in another order).

The variants:

* ``k8_128``, ``k8_512``: K8 with 128 or 512 threads a block (the
  package: 256); ``k8_unstaged``: K8 reading its tables from global
  memory on every case; ``k8_1ray``, ``k8_4rays``: K8 with 1 or 4 rays a
  thread (the package: 2);
* ``k10_256x4``, ``k10_256x8``, ``k10_128x8``, ``k10_128x16``,
  ``k10_512x8``: K10 with that many threads a block and rays a thread (the
  package: 256 x 16); ``k10_all_rays``: K10 listing every ray of a block,
  those with a zero cotangent too; ``k10_min3``: K10 with
  ``__launch_bounds__`` asking for 3 blocks an SM (fewer registers);
  ``k10_global``: K10 summing every span above 8 vertices with global f64
  atomics (the package sums spans of 9 to 256 in a shared f64 row first);
* diagnostics, whose outputs are not checked: ``k10_diag_no_sums`` (one
  add per term in place of the register slots' adds),
  ``k10_diag_loads_only`` (the cotangent loads and the list of live rays
  alone) and ``k10_diag_no_pick`` (the element pick, r0's hash and the
  search, left out).

The copies are built and swapped in by ``kernel_variants``; nothing here
changes the repository. The numbers are the card's, printed beside its
name and power limit.
"""

from __future__ import annotations

import argparse
import tempfile

import torch

import chip_smoke as cs
import kernel_variants

_K8_THREADS = "constexpr int kPointsThreads = 256;"
_K8_RAYS = "constexpr int kPointsRays = 2;"
_K10_THREADS = "constexpr int kBwdThreads = 256;"
_K10_RAYS = "constexpr int kBwdRaysPerThread = 16;"
_STAGED = "const bool staged = t.num_lights * (e + 1) <= kStageSlots;"


def _k8_rays(rays: int) -> list:
    return [(_K8_RAYS, _K8_RAYS.replace("2", str(rays)))]


def _k10(threads: int, rays: int) -> list:
    return [(_K10_THREADS, _K10_THREADS.replace("256", str(threads))),
            (_K10_RAYS, _K10_RAYS.replace("16", str(rays)))]


# (variant, kernel, [(text in lights.cu, replacement)]); kStageSlots stays
# 256, so K8's block of 128 threads stages in two passes
VARIANTS = {
    "k8_128": ("k8", [(_K8_THREADS, _K8_THREADS.replace("256", "128")),
                      ('static_assert(kStageSlots <= kPointsThreads, '
                       '"staging is one pass");', "")]),
    "k8_512": ("k8", [(_K8_THREADS, _K8_THREADS.replace("256", "512"))]),
    "k8_unstaged": ("k8", [(_STAGED, "const bool staged = false;")]),
    "k8_1ray": ("k8", _k8_rays(1)),
    "k8_4rays": ("k8", _k8_rays(4)),
    "k10_256x4": ("k10", _k10(256, 4)),
    "k10_256x8": ("k10", _k10(256, 8)),
    "k10_128x8": ("k10", _k10(128, 8)),
    "k10_128x16": ("k10", _k10(128, 16)),
    "k10_512x8": ("k10", _k10(512, 8)),
    "k10_all_rays": ("k10", [(
        "live = gi.x != 0.0f || gi.y != 0.0f || gi.z != 0.0f;",
        "live = true;")]),
    "k10_min3": ("k10", [(
        "__launch_bounds__(kBwdThreads) light_points_bwd_kernel",
        "__launch_bounds__(kBwdThreads, 3) light_points_bwd_kernel")]),
    "k10_global": ("k10", [(
        "(sp.span <= kAccVerts ? kSpanShared : kSpanGlobal)",
        "kSpanGlobal")]),
    # diagnostics, outputs not checked: one add per term in place of the
    # slot sums; the cotangents and the list alone; the element pick (r0's
    # hash and the search) left out
    "k10_diag_no_sums": ("k10", [(
        "    if (q == k) {\n      acc[3 * k] += x;\n"
        "      acc[3 * k + 1] += y;\n      acc[3 * k + 2] += z;\n    }",
        "    if (k == 0) acc[0] += x + y + z + q;")]),
    "k10_diag_loads_only": ("k10", [(
        "s_live[k];\n    const V3 gi = load3(gl, i);\n",
        "s_live[k];\n    const V3 gi = load3(gl, i);\n"
        "    acc[0] += gi.x + gi.y + gi.z;\n    continue;\n")]),
    "k10_diag_no_pick": ("k10", [(
        "const int slot = cdf_count(row, e, variate(ls.h[0], id) * total);",
        "const int slot = id & 1;")]),
}
ENTRY_POINTS = ("yrt_light_points", "yrt_light_points_bwd",
                "yrt_light_points_bwd_scratch", "yrt_error_string")
# the error strings the package's wrappers read from the library they launch
_ERROR_STRING = ('\nextern "C" const char* yrt_error_string(int e) { return '
                 'cudaGetErrorString(static_cast<cudaError_t>(e)); }\n')


def build_variants(tmp: str) -> dict:
    """{variant: (library, ptxas lines)}: each variant's lights.cu with the
    error strings, built in parallel (``kernel_variants``)."""
    from yocto_raytracing_tpu_torch.kernels import _build

    base = (_build.CSRC / "lights.cu").read_text()
    built = kernel_variants.build(tmp, {
        name: kernel_variants.edited(base, edits, name) + _ERROR_STRING
        for name, (_, edits) in VARIANTS.items()})
    return {name: (kernel_variants.load(so, ENTRY_POINTS), ptxas)
            for name, (so, ptxas) in built.items()}


def cases(device):
    """[(name, scene, sampler, K8 ids, K10 ids, K10 cotangent)]: seeded
    normal cotangents, and the area hair frame's step cotangent."""
    from yocto_raytracing_tpu_torch import scene as scene_lib
    from yocto_raytracing_tpu_torch.render import lights, renderer

    gen = torch.Generator(device=device)
    out = []
    for name, host in (("area hair", cs.area_hair_scene()),
                       ("area mirror", cs.area_mirror_scene()),
                       ("lamp panel", cs.area_hair_scene(cs.PANEL_CELLS)),
                       ("lamp panel 8 x 8", cs.area_hair_scene(8))):
        leaves, meta = scene_lib.build_device_scene(host)
        scene = scene_lib.to_torch(leaves, device)
        sampler = lights.build_light_sampler(host, leaves, meta, device)
        width = renderer.image_width(host.cameras[0].aspect, cs.RES)
        ids8 = cs.middle_ids(width, cs.RES, cs.SAMPLES,
                             cs.CHUNK_PIXELS * cs.SAMPLES ** 2, device)
        ids10 = cs.middle_ids(width, cs.RES, cs.SAMPLES, cs.TRAIN_RAYS,
                              device)
        gen.manual_seed(7)
        g = torch.randn((sampler["cdf"].shape[0], cs.TRAIN_RAYS, 3),
                        device=device, generator=gen)
        out.append((name, scene, sampler, ids8, ids10, g))
        if name == "area hair":
            step = cs.stochastic_loss_step(host, meta, scene, sampler,
                                           ids10)[0]
            out.append(("area hair, step cotangent", scene, sampler, ids8,
                        ids10, cs.step_light_cotangent(step)))
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from yocto_raytracing_tpu_torch.kernels import _build, parity
    from yocto_raytracing_tpu_torch.render import lights

    device = torch.device("cuda")
    cs.log(f"device: {cs.nvidia_smi_line()}")
    ref = _build.library()
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(tmp)
        for name, (_, ptxas) in libs.items():
            cs.log(f"{name}: ptxas " + "; ".join(ptxas))
        for cname, scene, sampler, ids8, ids10, g in cases(device):
            nv = scene.pos.shape[0]
            cs.log(f"{cname}: K10 cotangent rows non-zero "
                   f"{float((g != 0).any(-1).float().mean()):.4f}")

            def k8():
                with torch.no_grad():
                    return lights.sample_light_points_cuda(
                        scene, sampler, ids8, cs.SEED)

            def k10():
                return lights.light_points_bwd(scene, sampler, ids10,
                                               cs.SEED, g, nv)

            # (variant, library, function, profiled kernel)
            runs = [("k8", ref, k8, "light_points"),
                    ("k8_simple", ref, lambda: parity.light_points_simple(
                        scene, sampler, ids8, cs.SEED),
                     "light_points_simple"),
                    ("k10", ref, k10, "light_points_bwd"),
                    ("k10_simple", ref, lambda: parity.light_points_bwd_simple(
                        scene, sampler, ids10, cs.SEED, g, nv),
                     "light_points_bwd_simple")]
            runs += [(name, libs[name][0], k8 if kind == "k8" else k10,
                      "light_points" if kind == "k8" else "light_points_bwd")
                     for name, (kind, _) in VARIANTS.items()]
            want = {"k8": k8(), "k10": k10()}
            for name, lib, fn, _ in runs[4:]:
                if "_diag_" in name:
                    continue
                with kernel_variants.in_package(lib):
                    got = fn()
                if name.startswith("k8"):
                    if not torch.equal(got, want["k8"]):
                        raise AssertionError(f"{cname} {name}: K8 differs")
                else:
                    rep = parity.relative_errors(
                        dict(zip("ab", got)), dict(zip("ab", want["k10"])))
                    if max(r["rel"] for r in rep.values()) > 1e-6:
                        raise AssertionError(f"{cname} {name}: {rep}")
            us = {name: [] for name, *_ in runs}
            parts = {name: {} for name, *_ in runs}
            for r in range(args.rounds):
                for name, lib, fn, kind in (runs if r % 2 == 0
                                            else runs[::-1]):
                    with kernel_variants.in_package(lib):
                        prof = cs.profile_summary(
                            lambda: [fn() for _ in range(args.reps)],
                            f"{cname} {name}", (kind,))
                    us[name].append(cs.device_us(prof["by_name"], kind)
                                    / args.reps)
                    for fn_name in cs.DEVICE_FUNCTIONS[kind]:
                        part = parts[name].setdefault(fn_name, [])
                        part.append(cs.device_us(
                            {k: v for k, v in prof["by_name"].items()
                             if k.startswith(f"yrt::{fn_name}(")},
                            kind) / args.reps)
            for name, vals in us.items():
                cs.log(f"RESULT {cname} {name}: device us per launch "
                       + ", ".join(f"{v:.2f}" for v in vals)
                       + f" (mean {sum(vals) / len(vals):.2f}); by "
                       "kernel " + ", ".join(
                           f"{k} {sum(v) / len(v):.2f}"
                           for k, v in parts[name].items())
                       + f"; on {cs.nvidia_smi_line()}")


if __name__ == "__main__":
    main()
