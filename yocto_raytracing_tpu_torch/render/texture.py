"""Texture sampling, plain torch.

Port of ``yocto_raytracing_tpu/render/texture.py`` (lookup_texture +
eval_texture, src/raytrace.cpp:39-86): u8 texel -> ``min(1, (p/255)^2.2)``
when sRGB, repeat wrap with C ``fmod``, bilinear filter over the pre-baked
2x2 neighbourhood ``scene.tex_quad``. The base tap uses the reference's
flat ``pixels[j*w + i]`` addressing, clamped into the image.
"""

from __future__ import annotations

import torch


def _unpack(packed):
    """(N,) i32 r|g<<8|b<<16 -> (N, 3) f32 in [0, 255]."""
    return torch.stack([(packed & 0xFF).to(torch.float32),
                        ((packed >> 8) & 0xFF).to(torch.float32),
                        ((packed >> 16) & 0xFF).to(torch.float32)], dim=-1)


def eval_texture(scene, tid, uv, srgb: bool, wh=None):
    """Bilinear sample; tid (N,) i32 (>= 0), uv (N, 2) -> (N, 3).

    ``wh``: optional per-ray (w, h) f32 pair already at hand (e.g. from the
    packed material row), instead of gathering tex_w/tex_h.
    """
    if wh is None:
        w = scene.tex_w[tid].to(torch.float32)
        h = scene.tex_h[tid].to(torch.float32)
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
        return torch.clamp(torch.pow(_unpack(quad[:, k]) / scale, gamma),
                           max=1.0)

    return (texel(0) * (1 - wi) * (1 - wj)
            + texel(1) * wi * (1 - wj)
            + texel(2) * (1 - wi) * wj
            + texel(3) * wi * wj)
