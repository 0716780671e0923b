"""K4-K11 against their plain torch versions, on a card.

The comparisons that ``chip_smoke.py`` and the card tests
(``tests/test_torch_kernels.py``) make, kept in one place:

* ``shade_inputs``: the rays, hits and active mask of a given bounce of a
  batch of camera rays, from the kernel path (K2, K1, K4);
* ``compare_shade``: K4 and the plain ``shade_step`` on the same inputs and
  the same K1 shadow query, optionally with per-ray light positions; per
  output the largest ULP gap;
* ``compare_camera_stochastic``: K7 and the plain stochastic ray chain;
  ``compare_light_points``: K8 and the plain light sampling; per output
  the largest ULP gap;
* ``compare_shade_grads``: K5 and torch autograd of the plain version, for
  the same seeded cotangents (zero on masked lanes, whose gradient K5
  defines as zero), optionally with per-ray light positions; per leaf the
  relative L2 error; ``compare_shade_bwd``: K5 and its plain version
  (``shade.shade_step_bwd_plain``) on the same saved bounce
  (``shade_bwd_inputs``);
* ``compare_camera_grads``: K6 and torch autograd of ``camera_rays_plain``;
  ``compare_camera_stochastic_grads``: K9 and torch autograd of the plain
  stochastic chain; ``compare_light_points_grads``: K10 and torch autograd
  of the plain light sampling; ``compare_light_points_bwd``: K10 on one
  cotangent against the explicit f64 reverse (per output the ULP gap) and
  a second run of itself;
* ``shade_graph`` / ``camera_graph`` / ``light_points_graph``: the
  autograd graphs those compare (and ``chip_smoke.py`` times);
* ``overlap_gaps``: K11 and the plain overlap query on the same queries,
  per output; ``overlap_identical``: two overlap results bit for bit;
* ``compare_camera_sums``: K6 or K9 against ``camera.ordered_camera_sums``
  of the plain per-ray terms (bit for bit) and against the f64 sum of
  those terms;
* ``compare_loss_grads`` (from ``loss_grads``, ``recorder``,
  ``replayer`` and ``as_dtype``): the gradient of the MSE render loss of
  ``mesh.render_loss`` (with the stochastic modes, if asked) on the kernel
  path and on the plain path against its f64 reference, the plain path in
  f64 on the hits that the kernel path recorded.

Launches made here count in ``_build.launches`` like any other: a caller
that reads the counts of a main path resets them after these comparisons.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..ops import shade_records
from ..ops import traverse
from ..render import camera as camera_mod
from ..render import lights as lights_mod
from ..render import renderer as renderer_mod
from ..render import shade as shade_mod
from .. import scene as scene_lib

SHADE_OUTPUTS = ("color", "kr", "p", "refl_dir")
CAMERA_LEAVES = ("cam_axes", "cam_o", "cam_fovy", "cam_aspect", "cam_focus")
STOCHASTIC_CAMERA_LEAVES = CAMERA_LEAVES + ("cam_aperture",)
LIGHT_POINT_LEAVES = ("pos", "light_pos")


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


def _gaps(names, kern, plain) -> dict:
    """{name: ULP gap} and 'max_abs_err' over pairs of float outputs."""
    out = {name: ulp_gap(k, p) for name, k, p in zip(names, kern, plain)}
    out["max_abs_err"] = max(
        float(torch.nan_to_num((k - p).abs()).max()) if k.numel() else 0.0
        for k, p in zip(kern, plain))
    return out


def compare_shade(scene, inputs, amb, has_kd_textures=True,
                  has_ks_textures=True, light_pos=None) -> dict:
    """K4 and plain shading on the same inputs (and the same per-ray light
    positions, if given): {output: ULP gap} of K4 against plain, plus
    'mask_equal', 'max_abs_err' (over the four float outputs) and
    'hits'."""
    ro, rd, hits, active = inputs
    occ = occluder(scene)
    args = (scene, ro, rd, hits, amb, active, occ, has_kd_textures,
            has_ks_textures, light_pos)
    with torch.no_grad():
        kern = shade_mod.shade_step_cuda(*args)
        plain = shade_mod.shade_step_plain(*args)
    out = _gaps(SHADE_OUTPUTS, kern[:4], plain[:4])
    out["mask_equal"] = bool(torch.equal(kern[4], plain[4]))
    out["hits"] = int(kern[4].sum())
    return out


def compare_camera_stochastic(scene, ids, width, height, samples,
                              seed) -> dict:
    """K7 and the plain stochastic ray chain on the same ids: {'uv', 'ro',
    'rd': ULP gap} and 'max_abs_err'."""
    with torch.no_grad():
        kern = camera_mod.camera_rays_stochastic_cuda(scene, ids, width,
                                                      height, samples, seed)
        plain = camera_mod.camera_rays_stochastic_plain(scene, ids, width,
                                                        height, samples, seed)
    return _gaps(("uv", "ro", "rd"), kern, plain)


def compare_light_points(scene, sampler, ids, seed) -> dict:
    """K8 and the plain light sampling on the same ids: {'points': ULP gap
    to plain}, 'max_abs_err' and 'equal' (bit for bit to plain)."""
    with torch.no_grad():
        kern = lights_mod.sample_light_points_cuda(scene, sampler, ids, seed)
        plain = lights_mod.sample_light_points_plain(scene, sampler, ids,
                                                     seed)
    out = _gaps(("points",), (kern,), (plain,))
    out["equal"] = bool(torch.equal(kern, plain))
    return out


# K10 against the f64 reverse: entries at most this share of the output's
# largest may be off by more than 1 ULP (a sum that cancels keeps the f64
# rounding of its terms, which the summation order moves)
LIGHT_BWD_FLOOR = 1e-9


def compare_light_points_bwd(scene, sampler, ids, seed, g) -> dict:
    """K10 on the (L, N, 3) cotangent ``g``, per output (d_pos,
    d_light_pos): against ``light_points_bwd_plain`` (both f64 sums
    rounded once), 'ulp' the largest ULP gap over the entries above
    LIGHT_BWD_FLOOR times the largest and 'small_abs' the largest
    difference on the others; 'repeat' (a second run of K10 bit for bit
    equal)."""
    nv = scene.pos.shape[0]
    args = (scene, sampler, ids, seed, g, nv)
    with torch.no_grad():
        kern = lights_mod.light_points_bwd(*args)
        again = lights_mod.light_points_bwd(*args)
        plain = lights_mod.light_points_bwd_plain(*args)
    out = {}
    for k, (a, p) in enumerate(zip(kern, plain)):
        floor = LIGHT_BWD_FLOOR * float(p.abs().max()) if p.numel() else 0.0
        big = p.abs() > floor
        diff = (a - p).abs()
        out[("d_pos", "d_light_pos")[k]] = dict(
            ulp=ulp_gap(a[big], p[big]),
            small_abs=float(diff[~big].max()) if (~big).any() else 0.0,
            floor=floor, max_abs=float(diff.max()) if diff.numel() else 0.0)
    out["repeat"] = all(bool(torch.equal(a, b)) for a, b in zip(kern, again))
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
                has_ks_textures=True, light_pos=None):
    """One bounce through ``fn`` (``shade_step_cuda`` or
    ``shade_step_plain``) with fresh leaves that require grad: returns
    (outputs (color, kr, p, refl_dir), {name: input}) for ro, rd, the
    ``shade.GRAD_LEAVES`` and, when per-ray light positions are given,
    ``light_pos_ray``."""
    ro, rd, hits, active = inputs
    wrt = {"ro": ro.detach().requires_grad_(True),
           "rd": rd.detach().requires_grad_(True)}
    leaves = {k: getattr(scene, k).detach().requires_grad_(True)
              for k in shade_mod.GRAD_LEAVES}
    wrt.update(leaves)
    if light_pos is not None:
        wrt["light_pos_ray"] = light_pos.detach().requires_grad_(True)
    outs = fn(dataclasses.replace(scene, **leaves), wrt["ro"], wrt["rd"],
              hits, amb, active, occluder(scene), has_kd_textures,
              has_ks_textures, wrt.get("light_pos_ray"))[:4]
    return outs, wrt


def camera_graph(fn, scene, ids, width, height, samples,
                 names=CAMERA_LEAVES):
    """Camera rays through ``fn`` (``camera_rays_cuda`` or
    ``camera_rays_plain``, or a stochastic one with its seed bound) with
    fresh camera leaves ``names`` that require grad: returns ((ro, rd),
    {name: leaf})."""
    leaves = {k: getattr(scene, k).detach().requires_grad_(True)
              for k in names}
    _, ro, rd = fn(dataclasses.replace(scene, **leaves), ids, width, height,
                   samples)
    return (ro, rd), leaves


def light_points_graph(fn, scene, sampler, ids, seed):
    """Light points through ``fn`` (``sample_light_points_cuda`` or
    ``sample_light_points_plain``) with fresh ``pos`` and ``light_pos``
    that require grad: returns ((points,), {name: leaf})."""
    leaves = {k: getattr(scene, k).detach().requires_grad_(True)
              for k in LIGHT_POINT_LEAVES}
    return (fn(dataclasses.replace(scene, **leaves), sampler, ids, seed),), \
        leaves


def _grads(outs, wrt, cots):
    got = torch.autograd.grad(outs, list(wrt.values()), cots,
                              allow_unused=True)
    return {k: torch.zeros_like(x) if g is None else g
            for (k, x), g in zip(wrt.items(), got)}


def compare_shade_grads(scene, inputs, amb, generator,
                        has_kd_textures=True, has_ks_textures=True,
                        light_pos=None) -> dict:
    """K5 against torch autograd of the plain shading for seeded cotangents
    of (color, kr, p, refl_dir): a ``relative_errors`` report per leaf, and
    for ro and rd (and ``light_pos_ray`` with per-ray light positions)."""
    ro, _, hits, active = inputs
    mask = active & hits["hit"]
    cots = [torch.randn(ro.shape, device=ro.device, generator=generator)
            * mask[:, None] for _ in SHADE_OUTPUTS]
    kern, plain = (_grads(*shade_graph(fn, scene, inputs, amb,
                                       has_kd_textures, has_ks_textures,
                                       light_pos), cots)
                   for fn in (shade_mod.shade_step_cuda,
                              shade_mod.shade_step_plain))
    # masked lanes: K5 returns exact zeros; the plain rows there are the
    # (discarded) rays of inst 0 / prim 0
    for k in ("ro", "rd"):
        plain[k] = torch.where(mask[:, None], plain[k], 0.0)
    return relative_errors(kern, plain)


def shade_bwd_inputs(scene, inputs, amb, has_kd_textures=True,
                     has_ks_textures=True, light_pos=None) -> dict:
    """What K4's forward saves for K5 on ``inputs``: the keyword arguments
    of ``shade_step_bwd`` but the cotangents (the rays, hit topology, mask,
    the (L, N) occlusion of its K1 shadow query, the per-ray light
    positions, the shade records)."""
    ro, rd, hits, active = inputs
    saved = {}
    occ_fn = occluder(scene)

    def capture(*a):
        saved["occ"] = occ_fn(*a)
        return saved["occ"]

    with torch.no_grad():
        mask = shade_mod.shade_step_cuda(
            scene, ro, rd, hits, amb, active, capture, has_kd_textures,
            has_ks_textures, light_pos)[4]
    nl = scene.light_ke.shape[0]
    occ = saved.get("occ", torch.zeros((nl, ro.shape[0]), dtype=torch.bool,
                                       device=ro.device)).contiguous()
    return dict(amb=amb, ro=ro, rd=rd, inst=hits["inst"], prim=hits["prim"],
                mask=mask, occ=occ, has_kd_textures=has_kd_textures,
                has_ks_textures=has_ks_textures, light_pos_ray=light_pos,
                records=shade_records.pack(scene))


def shade_bwd_cotangents(saved: dict, generator) -> list:
    """Seeded cotangents of (color, kr, p, refl_dir), zero on masked
    lanes."""
    ro, mask = saved["ro"], saved["mask"]
    return [torch.randn(ro.shape, device=ro.device, generator=generator)
            * mask[:, None] for _ in SHADE_OUTPUTS]


def bwd_grads(scene, saved: dict, cots) -> dict:
    """{name: gradient} of one K5 launch (``shade_mod.shade_step_bwd``) on
    a saved bounce: ro, rd, the leaves and, with per-ray light positions,
    ``light_pos_ray``."""
    leaves = {k: getattr(scene, k) for k in shade_mod.GRAD_LEAVES}
    d_ro, d_rd, grads = shade_mod.shade_step_bwd(
        scene, leaves, saved["amb"], saved["ro"], saved["rd"],
        saved["inst"], saved["prim"], saved["mask"], saved["occ"], cots,
        saved["has_kd_textures"], saved["has_ks_textures"],
        light_pos_ray=saved["light_pos_ray"], records=saved["records"])
    return dict(ro=d_ro, rd=d_rd, **grads)


def compare_shade_bwd(scene, saved: dict, generator) -> dict:
    """K5 against its plain version (``shade.shade_step_bwd_plain``, which
    recomputes the saved bounce's shading and runs torch autograd) on the
    same saved bounce, with fixed lights, and seeded cotangents: a
    ``relative_errors`` report per leaf, ro and rd."""
    if saved["light_pos_ray"] is not None:
        raise ValueError("the plain reverse of a saved bounce takes fixed "
                         "lights: compare_shade_grads takes per-ray ones")
    cots = shade_bwd_cotangents(saved, generator)
    mask = saved["mask"]
    d_ro, d_rd, grads = shade_mod.shade_step_bwd_plain(
        scene, saved["amb"], saved["ro"], saved["rd"], saved["inst"],
        saved["prim"], mask, saved["occ"], cots, saved["has_kd_textures"],
        saved["has_ks_textures"])
    # masked lanes: K5 returns exact zeros, as in compare_shade_grads
    plain = dict(ro=torch.where(mask[:, None], d_ro, 0.0),
                 rd=torch.where(mask[:, None], d_rd, 0.0), **grads)
    return relative_errors(bwd_grads(scene, saved, cots), plain)


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


def compare_camera_stochastic_grads(scene, ids, width, height, samples,
                                    seed, generator) -> dict:
    """K9 against torch autograd of ``camera_rays_stochastic_plain`` for
    seeded cotangents of (ro, rd): per camera leaf, ``cam_aperture``
    included, as in ``compare_shade_grads``."""
    n = ids.shape[0]
    cots = [torch.randn((n, 3), device=ids.device, generator=generator)
            for _ in range(2)]
    return relative_errors(*(
        _grads(*camera_graph(functools.partial(fn, seed=seed), scene, ids,
                             width, height, samples,
                             STOCHASTIC_CAMERA_LEAVES), cots)
        for fn in (camera_mod.camera_rays_stochastic_cuda,
                   camera_mod.camera_rays_stochastic_plain)))


def compare_light_points_grads(scene, sampler, ids, seed,
                               generator) -> dict:
    """K10 against torch autograd of ``sample_light_points_plain`` for a
    seeded (L, N, 3) cotangent: for ``pos`` and ``light_pos``, as in
    ``compare_shade_grads``."""
    shape = (sampler["cdf"].shape[0], ids.shape[0], 3)
    cots = [torch.randn(shape, device=ids.device, generator=generator)]
    return relative_errors(*(
        _grads(*light_points_graph(fn, scene, sampler, ids, seed), cots)
        for fn in (lights_mod.sample_light_points_cuda,
                   lights_mod.sample_light_points_plain)))


def overlap_gaps(kern: dict, plain: dict) -> dict:
    """Two overlap query results: 'equal' (found, inst and prim equal), the
    largest ULP gap of 'dist' and 'euv' over the queries the plain query
    found, 'found' (their count) and 'max_abs_err'."""
    out = dict(equal=all(bool(torch.equal(kern[k], plain[k]))
                         for k in ("found", "inst", "prim")),
               found=int(plain["found"].sum()))
    sel = plain["found"]
    out.update(_gaps(("dist", "euv"), (kern["dist"][sel], kern["euv"][sel]),
                     (plain["dist"][sel], plain["euv"][sel])))
    return out


def overlap_identical(a: dict, b: dict) -> bool:
    """Two overlap query results bit for bit on every query: found, inst
    and prim equal, dist and euv equal as int32 views."""
    return (all(torch.equal(a[k], b[k]) for k in ("found", "inst", "prim"))
            and all(torch.equal(a[k].view(torch.int32),
                                b[k].view(torch.int32))
                    for k in ("dist", "euv")))


def compare_camera_sums(kern, terms) -> dict:
    """K6's or K9's sums ``kern`` for the per-ray terms ``terms`` (N, 16)
    of the plain version on the same inputs: 'equal' (``kern`` bit for bit
    ``ordered_camera_sums(terms)``), and its relative L2 error against the
    f64 sum of the terms ('rel') and largest gap ('max_abs')."""
    k = kern.shape[0]
    ordered = camera_mod.ordered_camera_sums(terms)[:k]
    ref = terms.double().sum(0)[:k]
    gap = kern.double() - ref
    return dict(equal=bool(torch.equal(kern, ordered)),
                rel=float(torch.linalg.vector_norm(gap))
                / float(torch.linalg.vector_norm(ref)),
                max_abs=float(gap.abs().max()))


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


def loss_grads(scene, ray_ids, target, amb, *, width, height, samples,
               max_depth, **kw):
    """(loss, {leaf: d loss / d leaf}) of the MSE render loss of
    ``mesh.render_loss``, ``mean((trace_rays(..., differentiable=True) -
    target) ** 2)``, for every float leaf of ``scene``, in the scene's
    dtype. ``kw`` goes to ``trace_rays``: ``plain``, ``intersect`` and the
    stochastic modes (``stochastic``, ``seed``, ``light_sampler``), which
    ``render_loss`` does not take, as in the JAX package."""
    leaves = {k: getattr(scene, k).detach().requires_grad_(True)
              for k in scene_lib.LEAF_NAMES
              if getattr(scene, k).is_floating_point()}
    rgb = renderer_mod.trace_rays(dataclasses.replace(scene, **leaves),
                                  ray_ids, amb, width, height, samples,
                                  max_depth, differentiable=True, **kw)
    loss = torch.mean((rgb - target) ** 2)
    return loss.detach(), _grads([loss], leaves, None)


def compare_loss_grads(scene, ray_ids, target, amb, also=None,
                       **kw) -> dict:
    """The gradient of the render loss three ways: the kernel path (which
    records its hits), the plain path (its own walk), and the f64
    reference, the plain path in f64 on the recorded hits, so that rounding
    is all that separates the three. Returns the three losses ('loss',
    'plain_loss', 'ref_loss'), the kernel path's gradients ('grads') and
    the ``relative_errors`` reports (zeros of whole leaves) of the kernel
    ('kernel') and the plain path ('plain') against the reference, and of
    each of ``also`` ({name: {leaf: gradient}}, gradients of the same loss
    on the same hits, such as the training step's device loop's) under
    its name.
    Leaves whose gradient is zero up to rounding are left out of the
    reports: ``cam_focus`` unless thin-lens rays (``stochastic`` and a
    non-zero aperture) make it move the rays, and with ``stochastic`` at
    aperture 0, ``cam_aperture``, whose first-order term averages out over
    the symmetric lens samples."""
    hits = []
    loss, grads = loss_grads(
        scene, ray_ids, target, amb,
        intersect=recorder(traverse.intersect_scene, hits), **kw)
    plain_loss, plain = loss_grads(scene, ray_ids, target, amb, plain=True,
                                   **kw)
    ref_loss, ref = loss_grads(
        as_dtype(scene, torch.float64), ray_ids, target.double(),
        amb.double(), plain=True, intersect=replayer(hits), **kw)
    lens = float(scene.cam_aperture) != 0.0
    if not (kw.get("stochastic") and lens):
        ref.pop("cam_focus")
    if kw.get("stochastic") and not lens:
        ref.pop("cam_aperture")
    return dict(
        loss=float(loss), plain_loss=float(plain_loss),
        ref_loss=float(ref_loss), grads=grads,
        **{what: relative_errors({k: g[k].double() for k in ref}, ref,
                                 per_element=False)
           for what, g in (("kernel", grads), ("plain", plain),
                           *(also or {}).items())})
