"""Ray-primitive intersection math, plain torch: the benchmark's frozen copy.

Copied from yocto_raytracing_tpu_torch/ops/intersect.py at commit 2bec3df,
code unchanged but for ``far``, the "nothing hit" distance in the
inputs' dtype. The parity notes of that file hold here: dots are
left-associative, frame transforms explicit multiply-adds, every division
tensor by tensor, square roots correctly rounded. Every function works in
the dtype of its inputs (the control runs it in bfloat16).
"""
from __future__ import annotations

import torch

FLT_MAX = 3.4028234663852886e38  # float32 max
BBOX_SLACK = 1.00000024          # intersect_check_bbox, src/scene.cpp:370-382


def far(x) -> float:
    """FLT_MAX, the "nothing hit" distance, or the largest number of
    ``x``'s dtype where that is below float32's (the control's bfloat16
    has no FLT_MAX); FLT_MAX itself for float32."""
    return min(FLT_MAX, torch.finfo(x.dtype).max)


def device_scalar(x, device) -> torch.Tensor:
    """A 0-dim f32 tensor on ``device``: a divisor that stays an IEEE
    division on CUDA (a host scalar divisor becomes a reciprocal multiply)."""
    return torch.tensor(x, dtype=torch.float32, device=device)


def dot(a, b):
    """3-vector dot as explicit left-associative adds."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def cross(a, b):
    """Cross product in jnp.cross's operation order."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def sqrt(x):
    """Correctly rounded sqrt in the dtype of ``x``: for f32 as IEEE sqrtf
    and CUDA's sqrtf give it.

    The f64 root of an f32 rounds to the f32 root exactly; PyTorch's
    vectorized f32 CPU sqrt can be off by an ULP.
    """
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def safe_sqrt(x):
    """sqrt with 0 for x <= 0."""
    gt = x > 0
    return torch.where(gt, sqrt(torch.where(gt, x, 1.0)), 0.0)


def safe_normalize(v):
    """Normalize the last axis with the reference's 0 -> 0 convention
    (src/vmath.h:118-122)."""
    n2 = dot(v, v)[..., None]
    gt = n2 > 0
    inv = torch.reciprocal(sqrt(torch.where(gt, n2, 1.0)))
    return torch.where(gt, v * inv, v)


def safe_pow(base, exp):
    """base**exp for base >= 0, 0 where base <= 0."""
    gt = base > 0
    return torch.where(gt, torch.pow(torch.where(gt, base, 1.0), exp), 0.0)


def intersect_triangle(ro, rd, tmin, tmax, v0, v1, v2):
    """Batched Möller-Trumbore (parity: src/scene.cpp:229-263).

    Returns (hit, t, w1, w2); non-hit t = FLT_MAX.
    """
    e1 = v1 - v0
    e2 = v2 - v0
    r = cross(rd, e2)
    den = dot(r, e1)
    inv_den = torch.reciprocal(torch.where(den == 0, 1.0, den))
    c = ro - v0
    w1 = dot(r, c) * inv_den
    s = cross(c, e1)
    w2 = dot(s, rd) * inv_den
    t = dot(s, e2) * inv_den
    hit = ((den != 0)
           & (w1 >= 0) & (w1 <= 1)
           & (w2 >= 0) & (w1 + w2 <= 1)
           & (t >= tmin) & (t <= tmax))
    return hit, torch.where(hit, t, far(t)), w1, w2


def intersect_point(ro, rd, tmin, tmax, p, r):
    """Batched point-as-disk (parity: src/scene.cpp:267-281). -> (hit, t)."""
    w = p - ro
    t = dot(w, rd) / dot(rd, rd)
    rp = ro + rd * t[..., None]
    prp = p - rp
    hit = (t >= tmin) & (t <= tmax) & (dot(prp, prp) <= r * r)
    return hit, torch.where(hit, t, far(t))


def intersect_line(ro, rd, tmin, tmax, v0, v1, r0, r1):
    """Batched capsule segment (parity: src/scene.cpp:285-307).

    Returns (hit, t, s) with s the segment parameter for ew = (1-s, s, 0, 0).
    """
    u = rd
    v = v1 - v0
    w = ro - v0
    a = dot(u, u)
    b = dot(u, v)
    c = dot(v, v)
    d = dot(u, w)
    e = dot(v, w)
    det = a * c - b * b
    safe_det = torch.where(det == 0, 1.0, det)
    t = (b * e - c * d) / safe_det
    s = torch.clamp((a * e - b * d) / safe_det, 0.0, 1.0)
    p0 = ro + rd * t[..., None]
    p1 = v0 + v * s[..., None]
    p01 = p0 - p1
    r = r0 * (1 - s) + r1 * s
    hit = (det != 0) & (t >= tmin) & (t <= tmax) & (dot(p01, p01) <= r * r)
    return hit, torch.where(hit, t, far(t)), s


def intersect_bbox(ro, rd, tmin, tmax, bmin, bmax):
    """Batched slab test with the reference's robustness factor.

    Parity: intersect_check_bbox (src/scene.cpp:370-382): swap by inv-dir
    sign, ``(x > y) ? x : y`` reduces that DROP a NaN constraint (an
    axis-parallel ray whose origin lies on a slab plane gives 0 * inf), and
    ``tmax *= 1.00000024`` after the min.
    """
    invd = torch.reciprocal(rd)
    t0 = (bmin - ro) * invd
    t1 = (bmax - ro) * invd
    neg = invd < 0
    tl = torch.where(neg, t1, t0)
    th = torch.where(neg, t0, t1)
    tl = torch.where(torch.isnan(tl), -torch.inf, tl)
    th = torch.where(torch.isnan(th), torch.inf, th)
    lo = torch.maximum(tl.amax(dim=-1), tmin)
    hi = torch.minimum(th.amin(dim=-1), tmax) * BBOX_SLACK
    return lo <= hi


def transform_vector(axes, v):
    """``v @ axes`` as explicit multiply-adds (src/vmath.h:161-163)."""
    return (v[..., 0:1] * axes[..., 0, :] + v[..., 1:2] * axes[..., 1, :]
            + v[..., 2:3] * axes[..., 2, :])


def transform_vector_inverse(axes, v):
    """``v @ axes.T`` = (dot(x,v), dot(y,v), dot(z,v)) (src/vmath.h:165-167)."""
    return torch.stack([dot(axes[..., 0, :], v), dot(axes[..., 1, :], v),
                        dot(axes[..., 2, :], v)], dim=-1)


def transform_point(axes, o, p):
    """transform_point (src/vmath.h:152-154)."""
    return transform_vector(axes, p) + o


def transform_ray_inverse(axes, o, ro, rd):
    """World ray -> instance-local ray (parity: src/vmath.h:275-278); the
    direction is re-normalized (transform_direction_inverse)."""
    lo = transform_vector_inverse(axes, ro - o)
    ld = safe_normalize(transform_vector_inverse(axes, rd))
    return lo, ld
