"""Ablations of K5's first form (``kernels/csrc/shade_bwd_simple.cu``) on
one NVIDIA GPU.

    python3 shade_bwd_ablation.py [--reps 10] [--new]

Builds copies of the simple K5 into a temporary directory, each with a part
compiled out, and times them in turns (CUDA events, device time per launch)
on the training batch of ``chip_smoke.py``'s ``phase_grad_kernels``: 2**20
middle ray ids of the hair frame (910x512, 4x4 samples, camera bounce) and
the last 2**20 ids of the mirror frame (512x512, bounce 2), with seeded
cotangents that are zero on masked lanes. The variants:

* ``simple``: the kernel as it is;
* ``no_vertex``: the vertex scatter (pos, norm, texcoord) compiled out;
* ``no_light_mat_inst``: the light sums and the material and instance
  scatters compiled out;
* ``no_scatter``: every scatter and sum compiled out (recompute, adjoint
  and the d_ro / d_rd stores left);
* ``recompute``: the forward recompute alone (hit, material, lights), no
  adjoint and no scatter; it stores a checksum in d_ro so nothing is dead.

With ``--new`` the copies are of the redesigned K5
(``kernels/csrc/shade_bwd.cu``), beside the simple one: ``new`` as it is;
``new_no_vertex``, ``new_no_rows`` (material and instance rows),
``new_no_light_sums`` and ``new_no_sums`` with those sums compiled out;
``new_uncapped`` without the ``__launch_bounds__`` minimum of 4 blocks of
128 threads an SM (that caps the registers at 128 a thread), ``new_64``
and ``new_256`` with 64 and 256 threads a block. With ``--fresh`` every timed launch
starts from a zeroed gradient buffer (one memset, timed alone too), as the
package's wrapper does; by default it keeps accumulating.

It also prints each variant's ptxas registers and spills, and per case the
share of 32-ray warps with no live lane and, over the live warps, the mean
number of distinct materials, instances, prims and first vertices a warp
touches. Nothing here changes the repository: the copies live in a
temporary directory. The numbers are the card's, printed beside its name and
power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

import kernel_variants

SAMPLES, RES, RAYS = 4, 512, 1 << 20

# (variant, [(text in shade_bwd_simple.cu, replacement)])
_SCATTER_MAT_INST = [
    ("const Scatter sc = scatter_plan(live_bits, live, g.mat);",
     "const Scatter sc{true, 0};"),
    ("const Scatter sc = scatter_plan(live_bits, live, inst);",
     "const Scatter sc{true, 0};"),
    ("scatter3(G.mat_", "if (0) scatter3(G.mat_"),
    ("scatter_add(G.mat_rs", "if (0) scatter_add(G.mat_rs"),
    ("scatter3(G.inst_", "if (0) scatter3(G.inst_"),
    ("warp_add3(G.", "if (0) warp_add3(G."),
]
_SCATTER_VERTEX = [("for (int j = 0; j < 3; ++j) {",
                    "for (int j = 0; j < 0; ++j) {")]
VARIANTS = {
    "simple": [],
    "no_vertex": _SCATTER_VERTEX,
    "no_light_mat_inst": _SCATTER_MAT_INST,
    "no_scatter": _SCATTER_VERTEX + _SCATTER_MAT_INST,
}
_THREADS = "constexpr int kBwdThreads = 128;"
# variants of the redesigned K5 (shade_bwd.cu)
_NEW_ROWS = [("    warp_rows(G, ", "    if (0) warp_rows(G, "),
             ("    block_add_rows(G, ", "    if (0) block_add_rows(G, ")]
_NEW_VERTEX = [("  unsigned peers[3];", "  if (0) {\n  unsigned peers[3];"),
               ("  // the block's material and instance rows",
                "  }\n  // the block's material and instance rows")]
_NEW_LIGHTS = [("if (__any_sync(kFull, lit)) {", "if (false) {")]
NEW_VARIANTS = {
    "new": [],
    "new_no_vertex": _NEW_VERTEX,
    "new_no_rows": _NEW_ROWS,
    "new_no_light_sums": _NEW_LIGHTS,
    "new_no_sums": _NEW_VERTEX + _NEW_ROWS + _NEW_LIGHTS,
    "new_uncapped": [("constexpr int kBwdMinBlocks = 4;",
                      "constexpr int kBwdMinBlocks = 1;")],
    "new_64": [(_THREADS, _THREADS.replace("128", "64"))],
    "new_256": [(_THREADS, _THREADS.replace("128", "256"))],
}

# the forward recompute of K5 alone, with the simple kernel's entry point
RECOMPUTE_SRC = r'''
#include <cstdint>
#include "shade.cuh"
namespace yrt::ablation {
struct ShadeGrads { double* p[13]; float* light_pos_ray; };
__global__ void __launch_bounds__(128) recompute_kernel(
    ShadeScene s, const float* __restrict__ ro_p,
    const float* __restrict__ rd_p, const int* __restrict__ inst_p,
    const int* __restrict__ prim_p, const uint8_t* __restrict__ mask_p,
    const uint8_t* __restrict__ occ, int n, float* __restrict__ d_ro) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bool live = mask_p[i] != 0;
  const V3 ro = live ? load3(ro_p, i) : zero3();
  const V3 rd = live ? load3(rd_p, i) : make(0.0f, 0.0f, 1.0f);
  HitGeom g;
  eval_hit(s, ro, rd, live ? inst_p[i] : 0, live ? prim_p[i] : 0, g);
  MatEval m;
  eval_material(s, g, m);
  const V3 vvec = safe_normalize(sub(ro, g.p));
  V3 acc = add(g.p, g.n);
  for (int l = 0; l < s.num_lights; ++l) {
    if (live && occ[static_cast<long long>(l) * n + i] == 0) {
      LightGeom lg;
      light_geom(s, l, light_position(s, l, i, n), g.p, lg);
      acc = add(acc, light_contrib(s, l, lg, g.n, vvec, m, g.is_lines));
    }
  }
  d_ro[3 * i] = acc.x;
  d_ro[3 * i + 1] = acc.y;
  d_ro[3 * i + 2] = acc.z;
}
}  // namespace yrt::ablation
extern "C" int yrt_shade_bwd_simple(
    const yrt::ShadeScene* s, const yrt::ablation::ShadeGrads* grads,
    const float* ro, const float* rd, const int* inst, const int* prim,
    const uint8_t* mask, const uint8_t* occ, int n, const float* g_color,
    const float* g_kr, const float* g_p, const float* g_refl, float* d_ro,
    float* d_rd, void* stream) {
  if (n > 0)
    yrt::ablation::recompute_kernel<<<yrt::blocks_for(n, 128), 128, 0,
        static_cast<cudaStream_t>(stream)>>>(*s, ro, rd, inst, prim, mask,
                                             occ, n, d_ro);
  return static_cast<int>(cudaGetLastError());
}
'''


def build_variants(tmp: str, new: bool) -> dict:
    """{variant: (shared library path, ptxas lines)}, nvcc in parallel."""
    from yocto_raytracing_tpu_torch.kernels import _build

    sources = {}
    for src, variants in ((("shade_bwd_simple.cu", {"simple": []}),
                           ("shade_bwd.cu", NEW_VARIANTS)) if new else
                          (("shade_bwd_simple.cu", VARIANTS),)):
        base = (_build.CSRC / src).read_text()
        for name, edits in variants.items():
            sources[name] = kernel_variants.edited(base, edits, name)
    if not new:
        sources["recompute"] = RECOMPUTE_SRC
    return kernel_variants.build(tmp, sources)


def load(name: str, so: str):
    """(the variant's K5 entry point, its scratch-size function or None
    for the first form)."""
    if not name.startswith("new"):
        return kernel_variants.load(so, ["yrt_shade_bwd_simple"]) \
            .yrt_shade_bwd_simple, None
    lib = kernel_variants.load(so, ["yrt_shade_bwd", "yrt_shade_bwd_scratch"])
    return lib.yrt_shade_bwd, lib.yrt_shade_bwd_scratch


def case_inputs(scene, meta, width, height, bounce, last, seed, fresh):
    """(launch((fn, scratch)): one K5 launch of a ``load``ed variant on the
    case, statistics)."""
    from yocto_raytracing_tpu_torch.kernels import _build, parity
    from yocto_raytracing_tpu_torch.ops import shade_records
    from yocto_raytracing_tpu_torch.render import shade

    dev = scene.device
    amb = torch.full((3,), 0.1, device=dev)
    total = width * height * SAMPLES * SAMPLES
    first = total - RAYS if last else total // 2 - RAYS // 2
    ids = torch.arange(first, first + RAYS, dtype=torch.int32, device=dev)
    ro, rd, hits, active = parity.shade_inputs(scene, ids, width, height,
                                               SAMPLES, bounce, amb)
    mask = (active & hits["hit"]).contiguous()
    gen = torch.Generator(device=dev).manual_seed(seed)
    cots = [torch.randn((RAYS, 3), device=dev, generator=gen)
            * mask[:, None] for _ in range(4)]
    leaves = {k: getattr(scene, k) for k in shade.GRAD_LEAVES}
    recs = shade_records.pack(scene)
    args = shade._shade_args(scene, leaves, amb, meta.has_kd_textures,
                             meta.has_ks_textures, records=recs)
    occ_mask = _occlusion(scene, meta, ro, rd, hits, amb, mask)
    # the package's own buffers: one f64 buffer for the 13 leaves' sums
    cots, sums, _, gstruct, d_ro, d_rd = shade.bwd_buffers(
        args, leaves, cots, RAYS, dev, False)
    inst = hits["inst"].contiguous()
    prim = hits["prim"].contiguous()
    ptr = _build.ptr

    scratch = {}

    def launch(variant):
        # the gradient buffers keep accumulating: only the time is read
        fn, size = variant
        extra = []
        if fresh:
            sums.zero_()
        if fn is None:
            return
        if size is not None:
            key = id(fn)
            if key not in scratch:
                scratch[key] = torch.empty(size(RAYS, args.num_lights),
                                           dtype=torch.float64, device=dev)
            extra = [ptr(scratch[key])]
        err = fn(ctypes.byref(args), ctypes.byref(gstruct), ptr(ro), ptr(rd),
                 ptr(inst), ptr(prim), ptr(mask), ptr(occ_mask), RAYS,
                 *(ptr(c) for c in cots), ptr(d_ro), ptr(d_rd), *extra,
                 _build.current_stream())
        if err:
            raise RuntimeError(f"launch failed: {err}")

    # args holds raw pointers: keep what they point to alive with launch
    launch.keep = (scene, leaves, amb, recs, cots, occ_mask, sums)

    live = mask[: RAYS // 32 * 32].view(-1, 32)
    warp_live = live.any(1)
    stats = dict(live_lanes=float(mask.float().mean()),
                 dead_warps=float(1 - warp_live.float().mean()))
    inst_m = torch.where(mask, inst, -1)[: RAYS // 32 * 32].view(-1, 32)
    prim_m = torch.where(mask, prim, -1)[: RAYS // 32 * 32].view(-1, 32)
    mat = torch.where(mask, scene.inst_mat[inst.clamp(min=0)], -1)
    vert0 = torch.where(mask, scene.prim_v[prim.clamp(min=0), 0], -1)
    for key, x in (("mats", mat), ("insts", inst_m), ("prims", prim_m),
                   ("vertex0", vert0)):
        x = x.reshape(-1, 32)[warp_live]
        xs = x.sort(dim=1).values
        distinct = ((xs[:, 1:] != xs[:, :-1]) & (xs[:, 1:] >= 0)).sum(1) + (
            xs[:, 0] >= 0).long()
        stats[f"distinct_{key}"] = float(distinct.float().mean())
    return launch, stats


def _occlusion(scene, meta, ro, rd, hits, amb, mask):
    """The (L, N) occlusion that K4's forward saves for K5."""
    from yocto_raytracing_tpu_torch.kernels import parity
    from yocto_raytracing_tpu_torch.render import shade

    saved = {}
    occ_fn = parity.occluder(scene)

    def occluder(*a):
        saved["occ"] = occ_fn(*a).contiguous()
        return saved["occ"]

    with torch.no_grad():
        shade.shade_step_cuda(scene, ro, rd, hits, amb, mask, occluder,
                              meta.has_kd_textures, meta.has_ks_textures)
    return saved.get("occ", torch.zeros(
        (scene.light_ke.shape[0], ro.shape[0]), dtype=torch.bool,
        device=ro.device))


def cuda_us(fn, reps):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps * 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--new", action="store_true",
                    help="time variants of the redesigned K5")
    ap.add_argument("--fresh", action="store_true",
                    help="zero the gradient buffers before every launch")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("shade_bwd_ablation: no CUDA device", file=sys.stderr)
        return 1
    from yocto_raytracing_tpu_torch import scene as scene_lib, testscenes
    from yocto_raytracing_tpu_torch.kernels import _build
    from yocto_raytracing_tpu_torch.render import renderer

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    info = _build.build()
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  library ptxas:", line.strip())
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(tmp, opts.new)
        for name, (_, ptxas) in libs.items():
            print(f"ptxas {name}: " + " | ".join(ptxas))
        fns = {name: load(name, so) for name, (so, _) in libs.items()}
        cases = []
        for name, make, bounce, last in (
                ("hair", lambda: testscenes.make_hair_scene(256), 1, False),
                ("mirror", testscenes.make_grad_scene, 2, True)):
            obj = os.path.join(tmp, f"{name}.obj")
            scene_lib.save_scene(make(), obj)
            host = scene_lib.load_scene(obj)
            leaves, meta = scene_lib.build_device_scene(host)
            scene = scene_lib.to_torch(leaves, dev)
            width = renderer.image_width(host.cameras[0].aspect, RES)
            cases.append((name, *case_inputs(scene, meta, width, RES, bounce,
                                             last, 100, opts.fresh)))
        for name, launch, stats in cases:
            print(f"case {name}: {RAYS} rays; " + ", ".join(
                f"{k} {v:.4f}" for k, v in stats.items()))
            order = list(fns) + list(fns)[::-1]
            times = {k: [] for k in fns}
            for v in order:
                times[v].append(cuda_us(lambda v=v: launch(fns[v]),
                                        opts.reps))
            if opts.fresh:
                print(f"  {name} zeroing the gradient buffer alone: "
                      f"{cuda_us(lambda: launch((None, None)), opts.reps):.1f}"
                      f" us")
            base = np.mean(times["simple"])
            for v, ts in times.items():
                print(f"  {name} {v}: device us per launch (CUDA events, "
                      f"in turns) "
                      f"{', '.join(f'{t:.1f}' for t in ts)}; mean "
                      f"{np.mean(ts):.1f}, {np.mean(ts) / base:.3f} of "
                      f"simple")
    print(f"on {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
