"""Procedural test images (capability parity: src/ext/yocto_math.h:6482-6698).

This package's own copy of ``yocto_raytracing_tpu/procedural.py`` (numpy
only, byte-equal results).

Vectorized numpy re-implementations of the ym:: procedural image makers —
grid, checker, bump/dimple, ramps, uv debug grids — plus the bump→normal
converter. All return (h, w, 4) u8 arrays in this package's row-major image
convention (image.py: img[j, i] == reference at(i, j)). Integer math
follows the C++ exactly (u8 truncation, integer shifts) so outputs are
byte-identical where the reference is well-defined.

The reference's make_grid_image loops ``j < width, i < height``
(yocto_math.h:6486-6487) while indexing ``at(i, j)`` — out-of-bounds for
non-square sizes (UB). We implement the intended symmetric grid, which is
byte-identical to the C++ for square images (its only use).
"""

from __future__ import annotations

import numpy as np


def _ij(width: int, height: int):
    """Column index i and row index j grids, each (h, w)."""
    j, i = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    return i, j


def _float_to_byte(x: np.ndarray) -> np.ndarray:
    """ym::float_to_byte: clamp(int(v * 256), 0, 255) (yocto_math.h)."""
    return np.clip((x * 256.0).astype(np.int32), 0, 255).astype(np.uint8)


def _rgba(mask: np.ndarray, c0, c1) -> np.ndarray:
    out = np.where(mask[..., None], np.asarray(c0, np.uint8),
                   np.asarray(c1, np.uint8))
    return out.astype(np.uint8)


def make_grid_image(width: int, height: int, tile: int = 64,
                    c0=(90, 90, 90, 255), c1=(128, 128, 128, 255)):
    """Tile-edge grid (yocto_math.h:6482-6494)."""
    i, j = _ij(width, height)
    edge = ((i % tile == 0) | (i % tile == tile - 1)
            | (j % tile == 0) | (j % tile == tile - 1))
    return _rgba(edge, c0, c1)


def make_checker_image(width: int, height: int, tile: int = 64,
                       c0=(90, 90, 90, 255), c1=(128, 128, 128, 255)):
    """Checkerboard (yocto_math.h:6499-6510)."""
    i, j = _ij(width, height)
    return _rgba((i // tile + j // tile) % 2 == 0, c0, c1)


def make_bumpdimple_image(width: int, height: int, tile: int = 64):
    """Alternating bumps and dimples heightfield (yocto_math.h:6515-6532)."""
    i, j = _ij(width, height)
    c = (i // tile + j // tile) % 2 == 0
    ii = i % tile - tile // 2
    jj = j % tile - tile // 2
    r = (np.sqrt((ii * ii + jj * jj).astype(np.float32))
         / np.sqrt(np.float32(tile * tile) / 4))
    h = 0.5 + np.where(r < 0.5, np.where(c, 0.5 - r, -(0.5 - r)), 0.0)
    g = _float_to_byte(h.astype(np.float32))
    out = np.empty((height, width, 4), np.uint8)
    out[..., 0] = out[..., 1] = out[..., 2] = g
    out[..., 3] = 255
    return out


def make_ramp_image(width: int, height: int, c0, c1, srgb: bool = False):
    """Horizontal ramp c0→c1, optionally blended in linear-of-sRGB space
    (yocto_math.h:6537-6552)."""
    u = (np.arange(width, dtype=np.float32) / np.float32(width))[None, :, None]
    c0 = np.asarray(c0, np.float32)
    c1 = np.asarray(c1, np.float32)
    if srgb:
        lin0 = (c0 / 255.0) ** 2.2
        lin1 = (c1 / 255.0) ** 2.2
        mix = lin0 * (1 - u) + lin1 * u
        row = _float_to_byte(mix ** (1 / 2.2))
    else:
        row = _float_to_byte((c0 / 255.0) * (1 - u) + (c1 / 255.0) * u)
    # alpha blends like the color channels in the reference
    return np.broadcast_to(row, (height, width, 4)).copy()


def _gammaramp_u(width: int, height: int) -> np.ndarray:
    u = (np.arange(height, dtype=np.float32)
         / np.float32(height - 1))[:, None]
    u = np.broadcast_to(u, (height, width)).copy()
    i = np.arange(width)[None, :]
    u = np.where(i < width // 3, u ** np.float32(2.2), u)
    u = np.where(i > (width * 2) // 3, u ** np.float32(1 / 2.2), u)
    return u


def make_gammaramp_image(width: int, height: int):
    """Three-band gamma ramp, u8 (yocto_math.h:6557-6569; note the
    reference's ``(byte)(u * 255)`` truncating cast, not float_to_byte)."""
    g = (_gammaramp_u(width, height) * 255).astype(np.uint8)
    out = np.empty((height, width, 4), np.uint8)
    out[..., 0] = out[..., 1] = out[..., 2] = g
    out[..., 3] = 255
    return out


def make_gammaramp_imagef(width: int, height: int):
    """Float variant (yocto_math.h:6574-6586)."""
    u = _gammaramp_u(width, height)
    out = np.empty((height, width, 4), np.float32)
    out[..., 0] = out[..., 1] = out[..., 2] = u
    out[..., 3] = 1.0
    return out


def make_uv_image(width: int, height: int):
    """R = u, G = v debug image (yocto_math.h:6591-6601)."""
    i, j = _ij(width, height)
    out = np.zeros((height, width, 4), np.uint8)
    out[..., 0] = _float_to_byte(i / np.float32(width - 1))
    out[..., 1] = _float_to_byte(j / np.float32(height - 1))
    out[..., 3] = 255
    return out


def _hsv_to_rgb_u8(h, s, v):
    """ym::hsv_to_rgb integer math (yocto_math.h:6419-6460), vectorized."""
    h = h.astype(np.int32)
    s = s.astype(np.int32)
    v = v.astype(np.int32)
    region = h // 43
    remainder = (h - region * 43) * 6
    p = (v * (255 - s)) >> 8
    q = (v * (255 - ((s * remainder) >> 8))) >> 8
    t = (v * (255 - ((s * (255 - remainder)) >> 8))) >> 8
    lut = [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)]
    r = np.select([region == k for k in range(6)], [c[0] for c in lut])
    g = np.select([region == k for k in range(6)], [c[1] for c in lut])
    b = np.select([region == k for k in range(6)], [c[2] for c in lut])
    gray = s == 0
    r = np.where(gray, v, r)
    g = np.where(gray, v, g)
    b = np.where(gray, v, b)
    return (r.astype(np.uint8), g.astype(np.uint8), b.astype(np.uint8))


def _uvgrid_common(width, height, tile, colored, recursive):
    i, j = _ij(width, height)
    ph = (32 * (i // (height // 8))).astype(np.uint8)
    pv = np.full((height, width), 128, np.int32)
    ps = (64 + 16 * (7 - j // (height // 8))).astype(np.int32)
    interior = (i % (tile // 2) != 0) & (j % (tile // 2) != 0)
    pv += np.where((i // tile + j // tile) % 2 != 0, 16, -16)
    if recursive:
        pv += np.where((i // (tile // 4) + j // (tile // 4)) % 2 != 0, 4, -4)
        pv += np.where((i // (tile // 8) + j // (tile // 8)) % 2 != 0, 1, -1)
    pv = np.where(interior, pv, 196).astype(np.uint8)
    ps = np.where(interior, ps, 32).astype(np.uint8)
    out = np.empty((height, width, 4), np.uint8)
    if colored:
        r, g, b = _hsv_to_rgb_u8(ph, ps, pv)
        out[..., 0], out[..., 1], out[..., 2] = r, g, b
    else:
        out[..., 0] = out[..., 1] = out[..., 2] = pv
    out[..., 3] = 255
    return out


def make_uvgrid_image(width: int, height: int, tile: int = 64,
                      colored: bool = True):
    """HSV-striped uv grid (yocto_math.h:6606-6630)."""
    return _uvgrid_common(width, height, tile, colored, recursive=False)


def make_recuvgrid_image(width: int, height: int, tile: int = 64,
                         colored: bool = True):
    """Recursive uv grid with 3 nesting levels (yocto_math.h:6635-6667)."""
    return _uvgrid_common(width, height, tile, colored, recursive=True)


def bump_to_normal_map(img: np.ndarray, scale: float = 1.0) -> np.ndarray:
    """Heightfield → tangent-space normal map (yocto_math.h:6672-6694).

    Forward differences with wrap-around, gray = channel mean / 255,
    normal = normalize(scale*(g00-g10), scale*(g00-g01), 1) * 0.5 + 0.5,
    stored with the reference's truncating ``byte(n * 255)`` cast.
    """
    h, w = img.shape[:2]
    g = (img[..., 0].astype(np.float32) + img[..., 1] + img[..., 2]) / (3 * 255)
    g10 = np.roll(g, -1, axis=1)   # at(i+1 mod w, j)
    g01 = np.roll(g, -1, axis=0)   # at(i, j+1 mod h)
    n = np.stack([scale * (g - g10), scale * (g - g01),
                  np.ones_like(g)], axis=-1)
    n = n / np.linalg.norm(n, axis=-1, keepdims=True)
    n = n * 0.5 + 0.5
    out = np.empty((h, w, 4), np.uint8)
    out[..., :3] = (n * 255).astype(np.uint8)
    out[..., 3] = 255
    return out
