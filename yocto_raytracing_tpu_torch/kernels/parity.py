"""K4, K5 and K6 against their plain torch versions, on a card.

The comparisons that ``chip_smoke.py`` and the card tests
(``tests/test_torch_kernels.py``) make, kept in one place:

* ``shade_inputs``: the rays, hits and active mask of a given bounce of a
  batch of camera rays, from the kernel path (K2, K1, K4);
* ``compare_shade``: K4 and the plain ``shade_step`` on the same inputs and
  the same K1 shadow query; per output the largest ULP gap;
* ``compare_shade_grads``: K5 and torch autograd of the plain version, for
  the same seeded cotangents (zero on masked lanes, whose gradient K5
  defines as zero); per leaf the relative L2 error;
* ``compare_camera_grads``: K6 and torch autograd of ``camera_rays_plain``;
* ``shade_graph`` / ``camera_graph``: the autograd graphs both compare
  (and ``chip_smoke.py`` times);
* ``compare_loss_grads`` (from ``loss_grads``, ``recorder``,
  ``replayer`` and ``as_dtype``): the gradient of ``mesh.render_loss`` on
  the kernel path and on the plain path against its f64 reference, the
  plain path in f64 on the hits that the kernel path recorded.

Launches made here count in ``_build.launches`` like any other: a caller
that reads the counts of a main path resets them after these comparisons.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import traverse
from ..parallel import mesh as mesh_mod
from ..render import camera as camera_mod
from ..render import renderer as renderer_mod
from ..render import shade as shade_mod
from .. import scene as scene_lib

SHADE_OUTPUTS = ("color", "kr", "p", "refl_dir")
CAMERA_LEAVES = ("cam_axes", "cam_o", "cam_fovy", "cam_aspect", "cam_focus")


def ulp_gap(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in f32 ULPs between two tensors; two NaNs are 0
    apart, a NaN and a number 2**32."""
    x = a.detach().float().cpu().numpy().view(np.int32).astype(np.int64)
    y = b.detach().float().cpu().numpy().view(np.int32).astype(np.int64)
    x = np.where(x < 0, -(x & 0x7FFFFFFF), x)
    y = np.where(y < 0, -(y & 0x7FFFFFFF), y)
    gap = np.abs(x - y)
    na = np.isnan(a.detach().cpu().numpy())
    nb = np.isnan(b.detach().cpu().numpy())
    gap = np.where(na & nb, 0, np.where(na | nb, 1 << 32, gap))
    return int(gap.max(initial=0))


def occluder(scene):
    """The K1 any-hit shadow query the renderer uses."""
    return renderer_mod.make_occluder(scene_lib.detached(scene),
                                      traverse.intersect_scene)


def shade_inputs(scene, ids, width, height, samples, bounce, amb):
    """(ro, rd, hits, active) of bounce ``bounce`` (1 = camera rays) of
    the rays ``ids``, run through K2, K1 and K4."""
    with torch.no_grad():
        _, ro, rd = camera_mod.camera_rays(scene, ids, width, height,
                                           samples)
        occ = occluder(scene)
        n = ro.shape[0]
        tmin = torch.full((n,), renderer_mod.RAY_EPS, device=ro.device)
        active = torch.ones(n, dtype=torch.bool, device=ro.device)
        for b in range(bounce):
            hits = traverse.intersect_scene(
                scene, ro, rd, tmin,
                torch.where(active, renderer_mod.FLT_MAX,
                            -renderer_mod.FLT_MAX))
            if b == bounce - 1:
                return ro, rd, hits, active
            _, kr, p, refl, mask = shade_mod.shade_step(
                scene, ro, rd, hits, amb, active, occ)
            active = mask & (kr > 0).any(dim=-1)
            ro = torch.where(active[:, None], p, 0.0).contiguous()
            rd = torch.where(active[:, None], refl, 1.0).contiguous()
    raise ValueError(f"bounce {bounce} < 1")


def compare_shade(scene, inputs, amb, has_kd_textures=True,
                  has_ks_textures=True) -> dict:
    """K4 and plain shading on the same inputs: {output: ULP gap}, plus
    'mask_equal' and 'max_abs_err' (over the four float outputs)."""
    ro, rd, hits, active = inputs
    occ = occluder(scene)
    with torch.no_grad():
        kern = shade_mod.shade_step_cuda(scene, ro, rd, hits, amb, active,
                                         occ, has_kd_textures,
                                         has_ks_textures)
        plain = shade_mod.shade_step_plain(scene, ro, rd, hits, amb, active,
                                           occ, has_kd_textures,
                                           has_ks_textures)
    out = {name: ulp_gap(k, p)
           for name, k, p in zip(SHADE_OUTPUTS, kern[:4], plain[:4])}
    out["mask_equal"] = bool(torch.equal(kern[4], plain[4]))
    out["max_abs_err"] = max(
        float(torch.nan_to_num((k - p).abs()).max()) if k.numel() else 0.0
        for k, p in zip(kern[:4], plain[:4]))
    out["hits"] = int(kern[4].sum())
    return out


def relative_errors(got: dict, ref: dict, per_element: bool = True) -> dict:
    """{name: {"rel": relative L2 error, "norm": |ref|, "max_abs": largest
    difference, "zeros_kept": exact zeros of ref are exact zeros of got,
    "finite": got is finite}}.

    With ``per_element=False`` "zeros_kept" asks it only of a ref that is
    zero as a whole: against an f64 reference an element can cancel to an
    exact 0 that f32 rounding leaves at 1e-9, which the relative error
    already bounds."""
    out = {}
    for name, r in ref.items():
        g = got[name]
        norm = float(torch.linalg.vector_norm(r))
        err = float(torch.linalg.vector_norm(g - r))
        zeros = r == 0 if per_element else torch.full_like(r, norm == 0,
                                                           dtype=torch.bool)
        out[name] = dict(
            rel=err / norm if norm else err, norm=norm,
            max_abs=float((g - r).abs().max()) if r.numel() else 0.0,
            zeros_kept=bool((g[zeros] == 0).all()),
            finite=bool(torch.isfinite(g).all()))
    return out


def check_grads(report: dict, rtol, what: str) -> float:
    """Raise unless every entry of a ``compare_*_grads`` report is finite,
    keeps the reference's exact zeros and is within ``rtol`` relative L2
    error (one bound, or a bound per entry). Returns the largest relative
    error."""
    for name, r in report.items():
        tol = rtol[name] if isinstance(rtol, dict) else rtol
        if not (r["finite"] and r["zeros_kept"] and r["rel"] <= tol):
            raise AssertionError(f"{what} {name}: {r} (rtol {tol})")
    return max(r["rel"] for r in report.values())


def loss_grad_bounds(report: dict, rtol: float,
                     plain_factor: float) -> dict:
    """Per-leaf bounds for a ``compare_loss_grads`` report: ``rtol``, or,
    where the plain f32 path is itself further than ``rtol`` from the f64
    reference (f32 rounding of the per-ray terms, which cancel in the
    leaf's sum), ``plain_factor`` times the plain path's error."""
    return {k: max(rtol, plain_factor * r["rel"])
            for k, r in report["plain"].items()}


def check_update(old, new, grads: dict, lr: float, what: str) -> None:
    """Raise unless each leaf of ``grads`` went from ``old`` to ``new`` as
    ``d - lr * g``, up to one rounding of the step and one in g (a scatter
    sum may round differently in another run)."""
    for leaf, g in grads.items():
        d = getattr(old, leaf)
        tol = 2.0 ** -22 * (d.abs() + (lr * g).abs())
        if not bool(((getattr(new, leaf) - (d - lr * g)).abs()
                     <= tol).all()):
            raise AssertionError(f"{what}: the update of {leaf} is not "
                                 f"d - lr * g")


def shade_graph(fn, scene, inputs, amb, has_kd_textures=True,
                has_ks_textures=True):
    """One bounce through ``fn`` (``shade_step_cuda`` or
    ``shade_step_plain``) with fresh leaves that require grad: returns
    (outputs (color, kr, p, refl_dir), {name: input}) for ro, rd and the
    ``shade.GRAD_LEAVES``."""
    ro, rd, hits, active = inputs
    wrt = {"ro": ro.detach().requires_grad_(True),
           "rd": rd.detach().requires_grad_(True)}
    leaves = {k: getattr(scene, k).detach().requires_grad_(True)
              for k in shade_mod.GRAD_LEAVES}
    wrt.update(leaves)
    outs = fn(dataclasses.replace(scene, **leaves), wrt["ro"], wrt["rd"],
              hits, amb, active, occluder(scene), has_kd_textures,
              has_ks_textures)[:4]
    return outs, wrt


def camera_graph(fn, scene, ids, width, height, samples):
    """Camera rays through ``fn`` (``camera_rays_cuda`` or
    ``camera_rays_plain``) with fresh camera leaves that require grad:
    returns ((ro, rd), {name: leaf})."""
    leaves = {k: getattr(scene, k).detach().requires_grad_(True)
              for k in CAMERA_LEAVES}
    _, ro, rd = fn(dataclasses.replace(scene, **leaves), ids, width, height,
                   samples)
    return (ro, rd), leaves


def _grads(outs, wrt, cots):
    got = torch.autograd.grad(outs, list(wrt.values()), cots,
                              allow_unused=True)
    return {k: torch.zeros_like(x) if g is None else g
            for (k, x), g in zip(wrt.items(), got)}


def compare_shade_grads(scene, inputs, amb, generator,
                        has_kd_textures=True, has_ks_textures=True) -> dict:
    """K5 against torch autograd of the plain shading for seeded cotangents
    of (color, kr, p, refl_dir): a ``relative_errors`` report per leaf, and
    for ro and rd."""
    ro, _, hits, active = inputs
    mask = active & hits["hit"]
    cots = [torch.randn(ro.shape, device=ro.device, generator=generator)
            * mask[:, None] for _ in SHADE_OUTPUTS]
    kern = _grads(*shade_graph(shade_mod.shade_step_cuda, scene, inputs, amb,
                               has_kd_textures, has_ks_textures), cots)
    plain = _grads(*shade_graph(shade_mod.shade_step_plain, scene, inputs,
                                amb, has_kd_textures, has_ks_textures), cots)
    # masked lanes: K5 returns exact zeros; the plain rows there are the
    # (discarded) rays of inst 0 / prim 0
    for k in ("ro", "rd"):
        plain[k] = torch.where(mask[:, None], plain[k], 0.0)
    return relative_errors(kern, plain)


def compare_camera_grads(scene, ids, width, height, samples,
                         generator) -> dict:
    """K6 against torch autograd of ``camera_rays_plain`` for seeded
    cotangents of (ro, rd): per camera leaf as in ``compare_shade_grads``."""
    n = ids.shape[0]
    cots = [torch.randn((n, 3), device=ids.device, generator=generator)
            for _ in range(2)]
    return relative_errors(*(
        _grads(*camera_graph(fn, scene, ids, width, height, samples), cots)
        for fn in (camera_mod.camera_rays_cuda,
                   camera_mod.camera_rays_plain)))


def recorder(isect_fn, log: list):
    """``isect_fn`` (a hit query) that also appends each answer to
    ``log``."""

    def run(scene, ro, rd, tmin, tmax, any_hit=False):
        out = isect_fn(scene, ro, rd, tmin, tmax, any_hit)
        log.append(out)
        return out

    return run


def replayer(log: list):
    """A hit query that returns the answers of ``log`` in order, whatever
    rays it is given: a run through it shades the recorded topology."""
    answers = iter(log)

    def run(scene, ro, rd, tmin, tmax, any_hit=False):
        out = next(answers, None)
        if out is None or out["hit"].shape != tmin.shape:
            raise ValueError("replayed hit query out of step with the "
                             "recorded run")
        return out

    return run


def as_dtype(scene, dtype):
    """The scene with every float leaf cast to ``dtype``."""
    return dataclasses.replace(scene, **{
        k: getattr(scene, k).to(dtype) for k in scene_lib.LEAF_NAMES
        if getattr(scene, k).is_floating_point()})


def loss_grads(scene, ray_ids, target, amb, **kw):
    """(loss, {leaf: d loss / d leaf}) of ``mesh.render_loss`` for every
    float leaf of ``scene``, in the scene's dtype; ``kw`` goes to
    ``render_loss`` (frame, ``plain``, ``intersect``)."""
    leaves = {k: getattr(scene, k).detach().requires_grad_(True)
              for k in scene_lib.LEAF_NAMES
              if getattr(scene, k).is_floating_point()}
    loss = mesh_mod.render_loss(dataclasses.replace(scene, **leaves),
                                ray_ids, target, amb, **kw)
    return loss.detach(), _grads([loss], leaves, None)


def compare_loss_grads(scene, ray_ids, target, amb, **kw) -> dict:
    """The gradient of ``render_loss`` three ways: the kernel path (which
    records its hits), the plain path (its own walk), and the f64
    reference, the plain path in f64 on the recorded hits, so that rounding
    is all that separates the three. Returns the three losses ('loss',
    'plain_loss', 'ref_loss'), the kernel path's gradients ('grads') and
    the ``relative_errors`` reports (zeros of whole leaves) of the kernel
    ('kernel') and the plain path ('plain') against the reference,
    ``cam_focus`` apart: its gradient is zero up to rounding."""
    hits = []
    loss, grads = loss_grads(
        scene, ray_ids, target, amb,
        intersect=recorder(traverse.intersect_scene, hits), **kw)
    plain_loss, plain = loss_grads(scene, ray_ids, target, amb, plain=True,
                                   **kw)
    ref_loss, ref = loss_grads(
        as_dtype(scene, torch.float64), ray_ids, target.double(),
        amb.double(), plain=True, intersect=replayer(hits), **kw)
    ref.pop("cam_focus")
    return dict(
        loss=float(loss), plain_loss=float(plain_loss),
        ref_loss=float(ref_loss), grads=grads,
        **{what: relative_errors({k: g[k].double() for k in ref}, ref,
                                 per_element=False)
           for what, g in (("kernel", grads), ("plain", plain))})
