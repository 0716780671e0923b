"""Hit attributes and Blinn-Phong/hair shading: plain torch and K4/K5.

Port of ``yocto_raytracing_tpu/render/shade.py`` (packed-gather path), the
reference's shade() body (src/raytrace.cpp:88-211) as one batched bounce:

* ``eval_hit`` recomputes barycentrics and hit attributes from the hit
  topology (instance id, prim id) with one packed instance row and one
  packed (P, 25) prim row per ray;
* all lights' shadow rays are stacked into one (L*N) any-hit query, through
  the injected ``occluder``;
* point lights keep the reference's light vector
  ``transform_point(light_frame, light_pos - p)`` (raytrace.cpp:129-130);
  with area lights a per-ray (L, N, 3) ``light_pos`` (``render/lights.py``)
  takes the place of the per-light position;
* hair uses the ``sqrt(1 - |n.l|)`` pseudo-sine (raytrace.cpp:164-174),
  Blinn-Phong the exponent ``ns = rs ? 2/rs^4 - 2 : 1e6`` (raytrace.cpp:144);
* ambient ``amb * kd * kd_txt`` is added once per shade, shadowed or not.

Frame transforms are explicit multiply-adds (ops/intersect.py).

``shade_step`` runs ``shade_step_plain`` for CPU tensors (differentiable by
torch autograd) and ``ShadeStepFn`` for CUDA tensors: the fused forward
kernel K4 (``kernels/csrc/shade.cu``, around K1's any-hit) and, in the
backward, the hand-written adjoint K5 (``kernels/csrc/shade_bwd.cu``). Like
the JAX package's remat policy, the forward saves only the rays, the hit
topology, the mask and the shadow visibility; K5 recomputes the bounce.
With per-ray light positions K5 also writes their (L, N, 3) gradient, which
autograd carries back to the light samples (``render/lights.py``, K10).
K4 and K5 read the hit, material and vertex leaves through the packed shade
records (``ops/shade_records.py``), which ``shade_step`` takes from its
caller or packs itself.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..kernels import _build
from ..ops import intersect as isect
from ..ops import shade_records
from ..scene import PRIM_LINE, PRIM_TRIANGLE
from . import texture as texture_mod

_normalize = isect.safe_normalize


def eval_hit(scene, ro, rd, inst, prim):
    """Hit attributes from (inst, prim) topology.

    Returns dict with world-space p, n, texcoord uv, barycentrics ew (N, 3),
    material id and hair flag. Lanes with inst/prim < 0 produce garbage the
    caller must mask.
    """
    inst_s = inst.clamp(min=0)
    prim_s = prim.clamp(min=0)
    f32 = torch.float32
    ipk = torch.cat(
        [scene.inst_axes.reshape(-1, 9), scene.inst_o,
         scene.inst_mat[:, None].to(f32),
         scene.inst_is_lines[:, None].to(f32)], dim=1)[inst_s]   # (N, 14)
    axes = ipk[:, 0:9].reshape(-1, 3, 3)
    io = ipk[:, 9:12]
    lo, ld = isect.transform_ray_inverse(axes, io, ro, rd)

    vert = torch.cat([scene.pos, scene.norm, scene.texcoord], dim=1)  # (V, 8)
    prim_tab = torch.cat(
        [vert[scene.prim_v[:, 0]], vert[scene.prim_v[:, 1]],
         vert[scene.prim_v[:, 2]], scene.prim_type[:, None].to(f32)],
        dim=1)                                                # (P, 25)
    row = prim_tab[prim_s]                                    # (N, 25)
    a0, a1, a2 = row[:, 0:8], row[:, 8:16], row[:, 16:24]
    ptype = row[:, 24]
    v0, n0, t0 = a0[:, 0:3], a0[:, 3:6], a0[:, 6:8]
    v1, n1, t1 = a1[:, 0:3], a1[:, 3:6], a1[:, 6:8]
    v2, n2, t2 = a2[:, 0:3], a2[:, 3:6], a2[:, 6:8]

    # triangle barycentrics (Möller-Trumbore solve, scene.cpp:229-263)
    e1 = v1 - v0
    e2 = v2 - v0
    r = isect.cross(ld, e2)
    den = isect.dot(r, e1)
    inv_den = torch.reciprocal(torch.where(den == 0, 1.0, den))
    cvec = lo - v0
    w1 = isect.dot(r, cvec) * inv_den
    svec = isect.cross(cvec, e1)
    w2 = isect.dot(svec, ld) * inv_den

    # line parameter s (scene.cpp:285-307)
    v = v1 - v0
    w = lo - v0
    a = isect.dot(ld, ld)
    b = isect.dot(ld, v)
    c = isect.dot(v, v)
    d = isect.dot(ld, w)
    e = isect.dot(v, w)
    det = a * c - b * b
    s_line = torch.clamp((a * e - b * d) / torch.where(det == 0, 1.0, det),
                         0.0, 1.0)

    is_tri = ptype == PRIM_TRIANGLE
    is_line = ptype == PRIM_LINE
    ew0 = torch.where(is_tri, 1.0 - w1 - w2,
                      torch.where(is_line, 1.0 - s_line, 1.0))
    ew1 = torch.where(is_tri, w1, torch.where(is_line, s_line, 0.0))
    ew2 = torch.where(is_tri, w2, 0.0)
    ew = torch.stack([ew0, ew1, ew2], dim=-1)

    def lerp3(x0, x1, x2):
        return x0 * ew0[:, None] + x1 * ew1[:, None] + x2 * ew2[:, None]

    p_local = lerp3(v0, v1, v2)
    n_local = lerp3(n0, n1, n2)
    uv = lerp3(t0, t1, t2)

    # instance-space eval (src/scene.h:210-218)
    p_world = isect.transform_point(axes, io, p_local)
    n_world = _normalize(isect.transform_vector(axes, n_local))

    return dict(p=p_world, n=n_world, uv=uv, ew=ew,
                mat=ipk[:, 12].to(torch.int32), is_lines=ipk[:, 13] == 1.0)


def shade_step_plain(scene, ro, rd, hits, amb, active, occluder,
                     has_kd_textures=True, has_ks_textures=True,
                     light_pos=None):
    """One bounce of the reference shade() body, plain torch (any device).

    ``occluder(p, d, tmin, tmax, mask)`` takes (L, N, ...) stacked shadow
    rays and returns (L, N) bool occlusion (the any-hit query).
    ``has_kd_textures``/``has_ks_textures`` (SceneMeta) skip the texel
    fetches of a slot no material uses. ``light_pos``, when given, is a
    per-ray (L, N, 3) shape-space light position (area-light samples) in
    place of ``scene.light_pos`` (JAX render/shade.py:242-243).

    Returns (color, kr, p, refl_dir, hit_mask): this bounce's direct +
    ambient colour, the reflection throughput factor, and the next ray.
    """
    mask = active & hits["hit"]
    inst = torch.where(mask, hits["inst"], 0)
    prim = torch.where(mask, hits["prim"], 0)

    at = eval_hit(scene, ro, rd, inst, prim)
    p = at["p"]
    n = at["n"]
    uv = at["uv"]

    # one (N, 16) material row per ray; texture ids and dims ride as f32
    f32 = torch.float32
    kd_tid = scene.mat_kd_txt.clamp(min=0)
    ks_tid = scene.mat_ks_txt.clamp(min=0)
    mpk = torch.cat(
        [scene.mat_kd, scene.mat_ks, scene.mat_kr, scene.mat_rs[:, None],
         scene.mat_kd_txt[:, None].to(f32),
         scene.mat_ks_txt[:, None].to(f32),
         scene.tex_w[kd_tid][:, None].to(f32),
         scene.tex_h[kd_tid][:, None].to(f32),
         scene.tex_w[ks_tid][:, None].to(f32),
         scene.tex_h[ks_tid][:, None].to(f32)], dim=1)[at["mat"]]
    kd = mpk[:, 0:3]
    ks = mpk[:, 3:6]
    kr = mpk[:, 6:9]
    rs = mpk[:, 9]
    kd_txt = mpk[:, 10].to(torch.int32)
    ks_txt = mpk[:, 11].to(torch.int32)

    # textures (always repeat-wrap sRGB for kd/ks, raytrace.cpp:153-157)
    if has_kd_textures:
        kd_tex = texture_mod.eval_texture(scene, kd_txt.clamp(min=0), uv,
                                          True, wh=(mpk[:, 12], mpk[:, 13]))
        kd_eff = torch.where((kd_txt >= 0)[:, None], kd * kd_tex, kd)
    else:
        kd_eff = kd
    if has_ks_textures:
        ks_tex = texture_mod.eval_texture(scene, ks_txt.clamp(min=0), uv,
                                          True, wh=(mpk[:, 14], mpk[:, 15]))
        ks_eff = torch.where((ks_txt >= 0)[:, None], ks * ks_tex, ks)
    else:
        ks_eff = ks

    la = amb[None, :] * kd_eff

    rs_nz = rs != 0
    two = torch.full_like(rs, 2.0)
    ns = torch.where(
        rs_nz, two / torch.pow(torch.where(rs_nz, rs, 1.0), 4.0) - 2.0, 1e6)
    vvec = _normalize(ro - p)

    color = torch.zeros_like(p)
    if scene.light_ke.shape[0]:
        # quirk-exact light vector: transform_point(light_frame, lpos - p)
        lpos = (scene.light_pos[:, None, :] if light_pos is None
                else light_pos)
        diff = lpos - p[None, :, :]                               # (L, N, 3)
        lvec = isect.transform_point(scene.light_axes[:, None, :, :],
                                     scene.light_o[:, None, :], diff)
        rdist = isect.safe_sqrt(isect.dot(lvec, lvec))            # (L, N)
        ldir = _normalize(lvec)

        # shadow ray (p, l, tmin=0.01, tmax=r-0.01), raytrace.cpp:131-133
        occ = occluder(p[None].expand(ldir.shape), ldir,
                       torch.full_like(rdist, 0.01), rdist - 0.01,
                       mask[None].expand(rdist.shape))
        lit = mask[None, :] & ~occ                                # (L, N)

        ke_r2 = (scene.light_ke[:, None, :]
                 / torch.clamp(rdist * rdist, min=1e-38)[..., None])
        h = _normalize(vvec[None] + ldir)
        ndl = isect.dot(n[None], ldir)
        ndh = isect.dot(n[None], h)
        # hair BRDF (raytrace.cpp:162-175) vs Blinn-Phong (177-180)
        sinnl = isect.safe_sqrt(torch.clamp(1.0 - torch.abs(ndl), min=0.0))
        sinnh = isect.safe_sqrt(torch.clamp(1.0 - torch.abs(ndh), min=0.0))
        is_lines = at["is_lines"][None]
        diff_w = torch.where(is_lines, sinnl, torch.clamp(ndl, min=0.0))
        spec_w = torch.where(
            is_lines, isect.safe_pow(sinnh, ns[None]),
            isect.safe_pow(torch.clamp(ndh, min=0.0), ns[None]))
        contrib = (kd_eff[None] * ke_r2 * diff_w[..., None]
                   + ks_eff[None] * ke_r2 * spec_w[..., None])
        contrib = torch.where(lit[..., None], contrib, 0.0)
        # per-pixel accumulation in light order (raytrace.cpp:121-185)
        for k in range(contrib.shape[0]):
            color = color + contrib[k]

    color = color + la
    color = torch.where(mask[:, None], color, 0.0)

    # mirror reflection ray (raytrace.cpp:187-204)
    refl_dir = n * (2.0 * isect.dot(n, vvec))[:, None] - vvec
    kr = torch.where(mask[:, None], kr, 0.0)
    return color, kr, p, refl_dir, mask


# --------------------------------------------------------------------------
# K4 (forward) and K5 (backward)
# --------------------------------------------------------------------------

# scene leaves K5 returns gradients for, in ShadeStepFn's argument order
GRAD_LEAVES = ("pos", "norm", "texcoord", "inst_axes", "inst_o", "mat_kd",
               "mat_ks", "mat_kr", "mat_rs", "light_pos", "light_axes",
               "light_o", "light_ke")
_INT_LEAVES = ("prim_v", "prim_type", "inst_mat", "inst_is_lines",
               "mat_kd_txt", "mat_ks_txt", "tex_quad", "tex_w", "tex_h")


def _shade_args(scene, leaves, amb, has_kd_textures, has_ks_textures,
                light_pos_ray=None, n=0, records=None):
    """The ``ShadeScene`` struct of a launch, after checking every array.

    ``leaves`` maps the GRAD_LEAVES names to the tensors to shade with (the
    autograd inputs); the integer leaves come from ``scene``.
    ``light_pos_ray`` is the optional per-ray (L, n, 3) light position.
    ``records`` (``shade_records.pack`` of those leaves) is what K4 and K5
    read; without it the struct serves the first forms only.
    """
    dev = amb.device
    f32, i32 = torch.float32, torch.int32
    check = _build.check_tensor
    shapes = dict(pos=(-1, 3), norm=(-1, 3), texcoord=(-1, 2),
                  inst_axes=(-1, 3, 3), inst_o=(-1, 3), mat_kd=(-1, 3),
                  mat_ks=(-1, 3), mat_kr=(-1, 3), mat_rs=(-1,),
                  light_pos=(-1, 3), light_axes=(-1, 3, 3), light_o=(-1, 3),
                  light_ke=(-1, 3), prim_v=(-1, 3), prim_type=(-1,),
                  inst_mat=(-1,), inst_is_lines=(-1,), mat_kd_txt=(-1,),
                  mat_ks_txt=(-1,), tex_quad=(-1, -1, -1, 4), tex_w=(-1,),
                  tex_h=(-1,))
    arrays = dict(leaves)
    arrays.update((k, getattr(scene, k)) for k in _INT_LEAVES)
    for name, t in arrays.items():
        check(name, t, f32 if name in GRAD_LEAVES else i32, shapes[name],
              dev)
    check("amb", amb, f32, (3,), dev)
    if light_pos_ray is not None:
        check("light_pos (per ray)", light_pos_ray, f32,
              (leaves["light_ke"].shape[0], n, 3), dev)
    rec_ptrs = {}
    if records is not None:
        for name, t, rows, words in (
                ("prim records", records.prims, arrays["prim_v"].shape[0],
                 shade_records.PRIM_WORDS),
                ("instance records", records.insts,
                 arrays["inst_axes"].shape[0], shade_records.INST_WORDS),
                ("material records", records.mats,
                 arrays["mat_kd"].shape[0], shade_records.MAT_WORDS)):
            check(name, t, f32, (rows, words), dev)
            if t.data_ptr() % 16:
                raise ValueError(f"{name}: not 16-byte aligned")
        rec_ptrs = dict(prim_rec=records.prims.data_ptr(),
                        inst_rec=records.insts.data_ptr(),
                        mat_rec=records.mats.data_ptr())
    args = _build.ShadeScene(
        **{k: t.data_ptr() for k, t in arrays.items()}, amb=amb.data_ptr(),
        light_pos_ray=(None if light_pos_ray is None
                       else light_pos_ray.data_ptr()), **rec_ptrs,
        tex_th=scene.tex_quad.shape[1], tex_tw=scene.tex_quad.shape[2],
        num_lights=leaves["light_ke"].shape[0],
        has_kd_tex=int(has_kd_textures), has_ks_tex=int(has_ks_textures),
        gamma=2.2, rs_exp=4.0, texel_scale=255.0)
    return args


def forward_launches(prep, finish, args, ro, rd, inst, prim, mask,
                     occluder):
    """One bounce's forward on the card: ``prep`` (the shadow rays), the
    ``occluder``'s any-hit query (K1), ``finish``; ``prep`` and ``finish``
    are the library's K4 entry points (or its first form's, which
    ``kernels.parity`` passes). Returns (the (L, N) occlusion, [color, kr,
    p, refl_dir])."""
    n = ro.shape[0]
    dev = ro.device
    f32 = torch.float32
    ptr = _build.ptr
    stream = _build.current_stream()
    nl = args.num_lights
    if not (nl and n):
        occ = torch.zeros((nl, n), dtype=torch.bool, device=dev)
    else:
        sh_o = torch.empty((nl, n, 3), dtype=f32, device=dev)
        sh_d = torch.empty((nl, n, 3), dtype=f32, device=dev)
        sh_tmin = torch.empty((nl, n), dtype=f32, device=dev)
        sh_tmax = torch.empty((nl, n), dtype=f32, device=dev)
        err = prep(ctypes.byref(args), ptr(ro), ptr(rd), ptr(inst), ptr(prim),
                   ptr(mask), n, ptr(sh_o), ptr(sh_d), ptr(sh_tmin),
                   ptr(sh_tmax), stream)
        _build.check_launch(err, prep.__name__)
        occ = occluder(sh_o, sh_d, sh_tmin, sh_tmax,
                       mask[None].expand(nl, n)).contiguous()
        _build.check_tensor("occluder result", occ, torch.bool, (nl, n), dev)
    outs = [torch.empty((n, 3), dtype=f32, device=dev) for _ in range(4)]
    err = finish(ctypes.byref(args), ptr(ro), ptr(rd), ptr(inst), ptr(prim),
                 ptr(mask), ptr(occ), n, *(ptr(o) for o in outs), stream)
    _build.check_launch(err, finish.__name__)
    return occ, outs


def check_rays(ro, rd, inst, prim, mask):
    """Validate one bounce's rays, hit topology and mask (n rays)."""
    n = ro.shape[0]
    dev = ro.device
    check = _build.check_tensor
    check("ro", ro, torch.float32, (n, 3), dev)
    check("rd", rd, torch.float32, (n, 3), dev)
    check("inst", inst, torch.int32, (n,), dev)
    check("prim", prim, torch.int32, (n,), dev)
    check("mask", mask, torch.bool, (n,), dev)


class ShadeStepFn(torch.autograd.Function):
    """One bounce on the card: K4 forward, K5 backward.

    ``forward(ctx, scene, occluder, has_kd_textures, has_ks_textures,
    records, ro, rd, inst, prim, mask, amb, light_pos_ray, *leaves)`` with
    ``leaves`` the GRAD_LEAVES tensors, ``records`` None or
    ``shade_records.pack`` of those leaves (packed here when None) and
    ``light_pos_ray`` None or the per-ray (L, N, 3) light positions;
    returns (color, kr, p, refl_dir). Saved for the backward: ro, rd, inst,
    prim, mask, the (L, N) occlusion, the per-ray light positions and the
    records. Masked lanes get exactly zero gradient, and so do the light
    positions of unlit lanes. ``amb`` takes no gradient.
    """

    @staticmethod
    def forward(ctx, scene, occluder, has_kd_textures, has_ks_textures,
                records, ro, rd, inst, prim, mask, amb, light_pos_ray,
                *leaves):
        check_rays(ro, rd, inst, prim, mask)
        named = dict(zip(GRAD_LEAVES, leaves))
        if records is None:
            records = shade_records.pack(dataclasses.replace(scene, **named))
        args = _shade_args(scene, named, amb, has_kd_textures,
                           has_ks_textures, light_pos_ray, ro.shape[0],
                           records)
        lib = _build.library()
        occ, outs = forward_launches(lib.yrt_shade_prep,
                                     lib.yrt_shade_finish, args, ro, rd,
                                     inst, prim, mask, occluder)
        _build.launches["shade"] += 1
        ctx.scene = scene
        ctx.records = records
        ctx.tex = (has_kd_textures, has_ks_textures)
        ctx.save_for_backward(ro, rd, inst, prim, mask, occ, amb,
                              light_pos_ray, *leaves)
        return tuple(outs)

    @staticmethod
    def backward(ctx, g_color, g_kr, g_p, g_refl):
        (ro, rd, inst, prim, mask, occ, amb, light_pos_ray,
         *leaves) = ctx.saved_tensors
        if ctx.needs_input_grad[10]:
            raise NotImplementedError("the ambient term takes no gradient "
                                      "on the CUDA path")
        d_ro, d_rd, grads = shade_step_bwd(
            ctx.scene, dict(zip(GRAD_LEAVES, leaves)), amb, ro, rd, inst,
            prim, mask, occ, (g_color, g_kr, g_p, g_refl), *ctx.tex,
            light_pos_ray=light_pos_ray, records=ctx.records)
        return (None, None, None, None, None, d_ro, d_rd, None, None, None,
                None, grads.get("light_pos_ray"),
                *(grads[k] for k in GRAD_LEAVES))


def bwd_buffers(args, leaves, cotangents, n, dev, per_ray):
    """A K5 launch's checked cotangents, its f64 leaf sums (one zeroed
    buffer, every leaf's a slice: one memset, not 13), the dense per-ray
    light-position gradient (or None), their ``ShadeGrads`` struct, and
    d_ro / d_rd."""
    f32 = torch.float32
    cots = []
    for name, g in zip(("g_color", "g_kr", "g_p", "g_refl"), cotangents):
        g = g.contiguous()
        _build.check_tensor(name, g, f32, (n, 3), dev)
        cots.append(g)
    sums = torch.zeros(sum(leaves[k].numel() for k in GRAD_LEAVES),
                       dtype=torch.float64, device=dev)
    d_lpr = (torch.empty((args.num_lights, n, 3), dtype=f32, device=dev)
             if per_ray else None)
    gstruct = _build.ShadeGrads(
        **{k: v.data_ptr() for k, v in _leaf_views(sums, leaves).items()},
        light_pos_ray=None if d_lpr is None else d_lpr.data_ptr())
    d_ro = torch.empty((n, 3), dtype=f32, device=dev)
    d_rd = torch.empty((n, 3), dtype=f32, device=dev)
    return cots, sums, d_lpr, gstruct, d_ro, d_rd


def _leaf_views(flat, leaves):
    """{leaf: its slice of ``flat``, in the leaf's shape}, GRAD_LEAVES
    order."""
    parts = flat.split([leaves[k].numel() for k in GRAD_LEAVES])
    return {k: p.view(leaves[k].shape) for k, p in zip(GRAD_LEAVES, parts)}


def bwd_results(sums, leaves, d_lpr):
    """The f32 leaf gradients, rounded from ``bwd_buffers``' f64 sums in one
    launch (views of one buffer), and the per-ray light positions'."""
    grads = _leaf_views(sums.to(torch.float32), leaves)
    if d_lpr is not None:
        grads["light_pos_ray"] = d_lpr
    return grads


def shade_step_bwd(scene, leaves, amb, ro, rd, inst, prim, mask, occ,
                   cotangents, has_kd_textures=True, has_ks_textures=True,
                   light_pos_ray=None, records=None):
    """K5 launch: (d_ro, d_rd, {leaf name: gradient}) of one bounce for the
    cotangents of (color, kr, p, refl_dir). CUDA only. With per-ray light
    positions (L, N, 3) the dict also holds their dense gradient under
    ``"light_pos_ray"`` (and ``light_pos``'s is zero). ``records``:
    ``shade_records.pack`` of ``leaves``, packed here when None.

    The leaf gradients are f64 sums rounded to f32. The light leaves' sums
    run in a fixed order, so they are the same bits on every run; the
    material, instance and vertex leaves' are atomic, and their last bit
    can change from run to run (see ``kernels/csrc/shade_bwd.cu``). The per-ray gradients have no sum and
    are deterministic.
    """
    n = ro.shape[0]
    dev = ro.device
    if records is None:
        records = shade_records.pack(dataclasses.replace(scene, **leaves))
    args = _shade_args(scene, leaves, amb, has_kd_textures, has_ks_textures,
                       light_pos_ray, n, records)
    cots, sums, d_lpr, gstruct, d_ro, d_rd = bwd_buffers(
        args, leaves, cotangents, n, dev, light_pos_ray is not None)
    lib = _build.library()
    # f64 block partials of the light leaves, summed in a fixed order
    scratch = torch.empty(lib.yrt_shade_bwd_scratch(n, args.num_lights),
                          dtype=torch.float64, device=dev)
    ptr = _build.ptr
    err = lib.yrt_shade_bwd(
        ctypes.byref(args), ctypes.byref(gstruct), ptr(ro), ptr(rd),
        ptr(inst), ptr(prim), ptr(mask), ptr(occ), n, *(ptr(g) for g in cots),
        ptr(d_ro), ptr(d_rd), ptr(scratch), _build.current_stream())
    _build.check_launch(err, "yrt_shade_bwd")
    _build.launches["shade_bwd" if d_lpr is None else "shade_bwd_lights"] += 1
    return d_ro, d_rd, bwd_results(sums, leaves, d_lpr)


def shade_step_cuda(scene, ro, rd, hits, amb, active, occluder,
                    has_kd_textures=True, has_ks_textures=True,
                    light_pos=None, records=None):
    """K4 launch (K5 in the backward): same contract as
    ``shade_step_plain``, CUDA only; ``records`` as in ``shade_step``."""
    mask = active & hits["hit"]
    color, kr, p, refl_dir = ShadeStepFn.apply(
        scene, occluder, has_kd_textures, has_ks_textures, records, ro, rd,
        hits["inst"], hits["prim"], mask, amb, light_pos,
        *(getattr(scene, k) for k in GRAD_LEAVES))
    return color, kr, p, refl_dir, mask


def shade_step(scene, ro, rd, hits, amb, active, occluder,
               has_kd_textures=True, has_ks_textures=True, light_pos=None,
               records=None):
    """One bounce of the reference shade() body: (color, kr, p, refl_dir,
    hit_mask); ``light_pos`` as in ``shade_step_plain``.

    CPU tensors take the plain version; CUDA tensors launch K4 (or raise),
    and K5 in the backward, on ``records`` (``shade_records.pack(scene)``,
    packed here when not given; the plain version needs none).
    """
    if _build.device_kind(ro) == "cpu":
        return shade_step_plain(scene, ro, rd, hits, amb, active, occluder,
                                has_kd_textures, has_ks_textures, light_pos)
    return shade_step_cuda(scene, ro, rd, hits, amb, active, occluder,
                           has_kd_textures, has_ks_textures, light_pos,
                           records)
