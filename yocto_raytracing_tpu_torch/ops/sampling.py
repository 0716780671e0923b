"""Monte-Carlo sampling toolkit, batched plain torch.

Port of ``yocto_raytracing_tpu/ops/sampling.py``: the reference's ym::
sampling section (src/ext/yocto_math.h:3229-3418) plus the element-CDF
builders of yscn::update_lights (src/ext/yocto_scn.cpp:1748-1779,
ym::sample_*_cdf). Every sampler takes a batch of uniform variates ``ruv``
of shape (..., 2) (or (...,) for scalars) and returns batched results, in
the JAX module's operation order. Square roots go through
``intersect.sqrt`` (correctly rounded on every device); ``2 * pi`` is the
f32 product the JAX module forms, exact in f32.

On the render path only ``sample_disk`` (the thin-lens sample, in kernel K7)
and ``sample_triangle`` (the area-light point, in kernel K8) run; the rest
is here for the same capability as the JAX module.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import intersect as isect

PIF = float(np.float32(math.pi))
TWO_PIF = float(np.float32(2.0) * np.float32(math.pi))


def _polar(ruv, z):
    r = isect.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = TWO_PIF * ruv[..., 0]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def sample_hemisphere(ruv):
    """Uniform hemisphere (z up). yocto_math.h:3234-3240."""
    return _polar(ruv, ruv[..., 1])


def sample_hemisphere_pdf(w):
    return torch.where(w[..., 2] <= 0, 0.0, 1.0 / (2.0 * PIF))


def sample_sphere(ruv):
    """Uniform sphere. yocto_math.h:3248-3253."""
    return _polar(ruv, 2.0 * ruv[..., 1] - 1.0)


def sample_sphere_pdf(w):
    return torch.full(w.shape[:-1], 1.0 / (4.0 * PIF), dtype=w.dtype,
                      device=w.device)


def sample_hemisphere_cosine(ruv):
    """Cosine-weighted hemisphere. yocto_math.h:3259-3264."""
    return _polar(ruv, isect.sqrt(ruv[..., 1]))


def sample_hemisphere_cosine_pdf(w):
    return torch.where(w[..., 2] <= 0, 0.0, w[..., 2] / PIF)


def sample_hemisphere_cospower(ruv, n):
    """Phong-lobe (cos^n) hemisphere. yocto_math.h:3272-3277."""
    return _polar(ruv, torch.pow(ruv[..., 1], 1.0 / (n + 1.0)))


def sample_hemisphere_cospower_pdf(w, n):
    z = w[..., 2]
    return torch.where(z <= 0, 0.0,
                       torch.pow(torch.clamp(z, min=0.0), n) * (n + 1.0)
                       / (2.0 * PIF))


def sample_disk(ruv):
    """Uniform unit disk (z = 0). yocto_math.h:3285-3289."""
    r = isect.sqrt(ruv[..., 1])
    phi = TWO_PIF * ruv[..., 0]
    return torch.stack([torch.cos(phi) * r, torch.sin(phi) * r,
                        torch.zeros_like(r)], dim=-1)


def sample_disk_pdf():
    return 1.0 / math.pi


def sample_cylinder(ruv):
    """Uniform unit cylinder side. yocto_math.h:3295-3298."""
    phi = TWO_PIF * ruv[..., 0]
    return torch.stack([torch.sin(phi), torch.cos(phi),
                        ruv[..., 1] * 2.0 - 1.0], dim=-1)


def sample_cylinder_pdf():
    return 1.0 / math.pi


def sample_triangle(ruv, v0=None, v1=None, v2=None):
    """Uniform triangle barycentrics (w1, w2); with vertices, the point.

    yocto_math.h:3304-3315: uv = (1 - sqrt(r0), r1 * sqrt(r0)), point =
    v0 * (1 - u - v) + v1 * u + v2 * v.
    """
    sq = isect.sqrt(ruv[..., 0])
    uv = torch.stack([1.0 - sq, ruv[..., 1] * sq], dim=-1)
    if v0 is None:
        return uv
    u = uv[..., 0:1]
    v = uv[..., 1:2]
    return v0 * (1.0 - u - v) + v1 * u + v2 * v


def sample_triangle_pdf(v0, v1, v2):
    """1 / area (yocto_math.h:3318-3321)."""
    c = isect.cross(v1 - v0, v2 - v0)
    return 2.0 / isect.sqrt(isect.dot(c, c))


def sample_index(r, size: int):
    """Uniform index in [0, size). yocto_math.h:3324-3326."""
    return torch.clamp((r * size).to(torch.int32), 0, size - 1)


def sample_index_pdf(size: int):
    return 1.0 / float(size)


# ---------------------------------------------------------------------------
# element CDFs for area sampling (ym::sample_points/lines/triangles_cdf,
# consumed by yscn::update_lights, yocto_scn.cpp:1759-1766); host numpy
# ---------------------------------------------------------------------------


def sample_points_cdf(n: int) -> np.ndarray:
    """Running count CDF: every point weighted 1."""
    return np.arange(1, n + 1, dtype=np.float32)


def sample_lines_cdf(lines: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """Cumulative segment lengths."""
    d = pos[lines[:, 1]] - pos[lines[:, 0]]
    return np.cumsum(np.linalg.norm(d, axis=-1)).astype(np.float32)


def sample_triangles_cdf(tris: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """Cumulative triangle areas."""
    c = np.cross(pos[tris[:, 1]] - pos[tris[:, 0]],
                 pos[tris[:, 2]] - pos[tris[:, 0]])
    return np.cumsum(0.5 * np.linalg.norm(c, axis=-1)).astype(np.float32)


def sample_discrete(cdf, r):
    """Element index by inverse-CDF lookup (batched).

    ``cdf`` is an unnormalized running sum (the ym convention above);
    returns indices with P(i) proportional to cdf[i] - cdf[i-1].
    """
    cdf = torch.as_tensor(cdf)
    x = r * cdf[-1]
    idx = torch.searchsorted(cdf, x, right=True)
    return torch.clamp(idx, 0, cdf.shape[0] - 1)
