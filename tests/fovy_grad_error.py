"""The f32 gradient of the training loss against its f64 reference, JAX's
and the port's, on the CPU: how far each package's f32 arithmetic alone
takes ``cam_fovy`` (and every other float leaf) from the same reference.

    JAX_PLATFORMS=cpu python tests/fovy_grad_error.py [--rays N ...]

The hair training step of ``chip_smoke.py``'s ``phase_train`` at a CPU's
size: ``make_hair_scene(256)`` written to OBJ and loaded back, 910x512 at
4 x 4 spp, depth 4, ambient 0.1, N ray ids evenly strided over the middle
2**20 ids of the frame (the card's training step takes them all; the
middle rows alone hold little hair), the target rendered from the scene
with ``mat_kd`` and ``light_ke`` scaled by 1 + 0.2 N(0, 1) (numpy seed
7). For each N (default 2**12 to 2**19):

* the reference: the port's plain path in f64 on the hits of its f32 walk
  (``kernels.parity``: ``loss_grads`` with ``recorder`` and ``replayer``,
  as ``compare_loss_grads`` makes it), the gradient of the MSE
  ``mean((trace_rays(differentiable=True) - target) ** 2)``;
* the port's plain f32 gradient (``loss_grads(plain=True)``);
* JAX's f32 gradient: ``jax.value_and_grad`` of the JAX package's
  ``mesh.render_loss``, jitted in the no-FMA child (``jax_nofma``), on the
  same leaves, ids, target and ambient.

Prints, per N and leaf, |g - ref| / |ref| (relative L2 over the leaf) for
both (``cam_focus`` left out: zero up to rounding), with the seconds each
side took. The two walks give the same hits (K1's plain walk is held
bit-equal to JAX's), so the reference serves both.
"""

import argparse
import dataclasses
import os
import sys
import tempfile
import time

import numpy as np
import torch

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [TESTS, os.path.dirname(TESTS)]

import jax_nofma  # noqa: E402
from yocto_raytracing_tpu_torch import scene as scene_lib  # noqa: E402
from yocto_raytracing_tpu_torch import testscenes  # noqa: E402
from yocto_raytracing_tpu_torch.kernels import parity  # noqa: E402
from yocto_raytracing_tpu_torch.ops import traverse  # noqa: E402
from yocto_raytracing_tpu_torch.render import renderer  # noqa: E402

RES, SAMPLES, DEPTH, SEED = 512, 4, 4, 7   # chip_smoke.py's hair step
TRAIN_RAYS = 1 << 20


def hair_scene():
    """The hair scene through an OBJ round trip, as ``chip_smoke.py``
    loads it: (torch scene on the CPU, numpy leaves, width)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "hair.obj")
        scene_lib.save_scene(testscenes.make_hair_scene(256), path)
        host = scene_lib.load_scene(path)
    leaves, _ = scene_lib.build_device_scene(host)
    width = renderer.image_width(host.cameras[0].aspect, RES)
    return scene_lib.to_torch(leaves, "cpu"), leaves, width


def perturbed(scene, seed):
    """``chip_smoke.perturbed`` without moved vertices: mat_kd and light_ke
    scaled by 1 + 0.2 N(0, 1)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name in ("mat_kd", "light_ke"):
        x = getattr(scene, name)
        f = 1 + 0.2 * rng.standard_normal(tuple(x.shape))
        out[name] = x * torch.from_numpy(f.astype(np.float32))
    return dataclasses.replace(scene, **out)


def rel(g, ref) -> float:
    g, ref = np.asarray(g, np.float64), np.asarray(ref, np.float64)
    den = np.linalg.norm(ref)
    return float(np.linalg.norm(g - ref) / den) if den > 0 else float("nan")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rays", type=int, nargs="+",
                    default=[1 << 12, 1 << 14, 1 << 16, 1 << 18, 1 << 19])
    args = ap.parse_args()
    scene, leaves, width = hair_scene()
    amb = torch.full((3,), 0.1)
    kw = dict(width=width, height=RES, samples=SAMPLES, max_depth=DEPTH)
    total = width * RES * SAMPLES * SAMPLES
    for n in args.rays:
        first, stride = total // 2 - TRAIN_RAYS // 2, TRAIN_RAYS // n
        ids = torch.arange(first, first + TRAIN_RAYS, stride,
                           dtype=torch.int32)
        target = renderer.trace_rays(perturbed(scene, SEED), ids, amb, width,
                                     RES, SAMPLES, DEPTH)
        t0 = time.perf_counter()
        hits = []
        parity.loss_grads(scene, ids, target, amb,
                          intersect=parity.recorder(traverse.intersect_scene,
                                                    hits), **kw)
        _, ref = parity.loss_grads(
            parity.as_dtype(scene, torch.float64), ids, target.double(),
            amb.double(), plain=True, intersect=parity.replayer(hits), **kw)
        _, port = parity.loss_grads(scene, ids, target, amb, plain=True,
                                    **kw)
        t_port = time.perf_counter() - t0
        t0 = time.perf_counter()
        jax_out = jax_nofma.loss_grads(leaves, ids.numpy(), target.numpy(),
                                       amb.numpy(), **kw)
        t_jax = time.perf_counter() - t0
        print(f"{n} rays (ids {first} + {stride} k): port {t_port:.1f} s"
              f" (f32 and f64), JAX {t_jax:.1f} s; relative L2 error "
              f"against the f64 reference, JAX f32 / port f32:", flush=True)
        for k in sorted(ref):
            # cam_focus moves no pinhole ray: its gradient is zero up to
            # rounding (``compare_loss_grads`` leaves it out the same way)
            if k == "cam_focus" or not float(ref[k].abs().max()) > 0:
                continue
            r = ref[k].numpy()
            print(f"  {k}: {rel(jax_out[k], r):.3e} / "
                  f"{rel(port[k].numpy(), r):.3e}", flush=True)


if __name__ == "__main__":
    main()
