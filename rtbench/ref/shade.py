"""Hit attributes and Blinn-Phong/hair shading, plain torch: the
benchmark's frozen copy.

Copied from yocto_raytracing_tpu_torch/render/shade.py (``eval_hit``,
``shade_step_plain``) and render/texture.py (``eval_texture``) at commit
2bec3df, code unchanged but for the float dtype of the packed rows, which
follows the scene leaves'. One batched bounce of the reference's shade()
body (src/raytrace.cpp:88-211): barycentrics and attributes from the hit
topology, every light's shadow ray through the injected ``occluder``, the
hair pseudo-sine BRDF or Blinn-Phong, ambient once, the mirror ray.
Differentiable by torch autograd.
"""

from __future__ import annotations

import torch

from .flat import PRIM_LINE, PRIM_TRIANGLE
from . import intersect as isect


def _unpack(packed, dtype):
    """(N,) i32 r|g<<8|b<<16 -> (N, 3) in [0, 255], in ``dtype``."""
    return torch.stack([(packed & 0xFF).to(dtype),
                        ((packed >> 8) & 0xFF).to(dtype),
                        ((packed >> 16) & 0xFF).to(dtype)], dim=-1)


def eval_texture(scene, tid, uv, srgb: bool, wh=None):
    """Bilinear sample; tid (N,) i32 (>= 0), uv (N, 2) -> (N, 3).

    ``wh``: optional per-ray (w, h) f32 pair already at hand (e.g. from the
    packed material row), instead of gathering tex_w/tex_h.
    """
    dtype = uv.dtype
    if wh is None:
        w = scene.tex_w[tid].to(dtype)
        h = scene.tex_h[tid].to(dtype)
    else:
        w, h = wh
    s = torch.fmod(uv[:, 0], 1.0) * w
    t = torch.fmod(uv[:, 1], 1.0) * h
    i = torch.floor(s)
    j = torch.floor(t)
    wi = (s - i)[:, None]
    wj = (t - j)[:, None]
    i = i.to(torch.int32)
    j = j.to(torch.int32)
    wi32 = w.to(torch.int32)
    h32 = h.to(torch.int32)
    flat = torch.minimum(torch.clamp(j * wi32 + i, min=0), wi32 * h32 - 1)
    wsafe = torch.clamp(wi32, min=1)
    jj = torch.div(flat, wsafe, rounding_mode="floor")
    ii = flat % wsafe
    quad = scene.tex_quad[tid, jj, ii]            # (N, 4) i32
    gamma = 2.2 if srgb else 1.0
    scale = torch.full_like(w, 255.0)[:, None]

    def texel(k):
        return torch.clamp(torch.pow(_unpack(quad[:, k], dtype) / scale, gamma),
                           max=1.0)

    return (texel(0) * (1 - wi) * (1 - wj)
            + texel(1) * wi * (1 - wj)
            + texel(2) * (1 - wi) * wj
            + texel(3) * wi * wj)


_normalize = isect.safe_normalize


def eval_hit(scene, ro, rd, inst, prim):
    """Hit attributes from (inst, prim) topology.

    Returns dict with world-space p, n, texcoord uv, barycentrics ew (N, 3),
    material id and hair flag. Lanes with inst/prim < 0 produce garbage the
    caller must mask.
    """
    inst_s = inst.clamp(min=0)
    prim_s = prim.clamp(min=0)
    f32 = scene.pos.dtype
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
    f32 = scene.pos.dtype
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
        kd_tex = eval_texture(scene, kd_txt.clamp(min=0), uv,
                                          True, wh=(mpk[:, 12], mpk[:, 13]))
        kd_eff = torch.where((kd_txt >= 0)[:, None], kd * kd_tex, kd)
    else:
        kd_eff = kd
    if has_ks_textures:
        ks_tex = eval_texture(scene, ks_txt.clamp(min=0), uv,
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
