"""Image types, tonemapping and PNG/HDR I/O.

Behavioral parity with the reference app image layer (src/image.{h,cpp}):

* images are row-major ``(height, width, 4)`` arrays; the reference's
  ``at(i, j)`` is ``img[j, i]`` here (src/image.h:15).
* ``tonemap`` applies ``2^exposure`` scaling, an optional filmic curve, sRGB
  gamma ``1/2.2``, then clamps to [0,1] and converts to u8 with C's
  *truncating* ``(unsigned char)`` cast (src/image.cpp:55-77).
* ``save_hdr_or_ldr`` writes Radiance .hdr for ``*.hdr`` paths, else
  tonemap(exposure=0, filmic=off) + PNG (src/image.cpp:81-89).

LDR decode/encode uses PIL (the renderer needs no native stb port: PNG
decode is host-side and PIL produces byte-identical RGBA to stb_image for the
formats in use). Radiance .hdr uses our own RGBE codec (io/hdr.py) since the
renderer must round-trip float images like stbi_write_hdr/stbi_loadf
(src/image.cpp:13-23,39-42).

This package's own copy of ``yocto_raytracing_tpu/image.py``, code and
results unchanged.
"""

from __future__ import annotations

import numpy as np


def load_image4b(path: str) -> np.ndarray:
    """Load an LDR image as u8 RGBA, shape (h, w, 4).

    Parity: load_image4b (src/image.cpp:25-35) = stbi_load with 4 forced
    components (palette/gray/RGB all expanded to RGBA, alpha=255).
    """
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA"), dtype=np.uint8)


def load_image4f(path: str) -> np.ndarray:
    """Load an HDR image as f32 RGBA, shape (h, w, 4).

    Parity: load_image4f (src/image.cpp:13-23) = stbi_loadf; for .hdr files
    this decodes Radiance RGBE to linear float with alpha=1.
    """
    if path.lower().endswith(".hdr"):
        from .io import hdr

        rgb = hdr.read_hdr(path)
        out = np.ones(rgb.shape[:2] + (4,), dtype=np.float32)
        out[..., :3] = rgb
        return out
    # stbi_loadf on an LDR file applies gamma 2.2 / scale 1: ldr^2.2
    ldr = load_image4b(path).astype(np.float32) / 255.0
    out = ldr.copy()
    out[..., :3] = ldr[..., :3] ** 2.2
    return out


def save_image_png(path: str, img_u8: np.ndarray) -> None:
    """Save u8 RGBA (h, w, 4) as PNG (parity: src/image.cpp:44-47)."""
    from PIL import Image

    Image.fromarray(np.ascontiguousarray(img_u8), mode="RGBA").save(path)


def save_image_hdr(path: str, img_f32: np.ndarray) -> None:
    """Save f32 RGBA (h, w, 4) as Radiance .hdr (parity: src/image.cpp:39-42).

    Alpha is dropped; Radiance stores RGB only (as stbi_write_hdr does).
    """
    from .io import hdr

    hdr.write_hdr(path, np.asarray(img_f32[..., :3], dtype=np.float32))


def filmic(h: np.ndarray) -> np.ndarray:
    """Filmic curve (parity: src/image.cpp:51-53)."""
    return (10.55 * h * h + 0.06 * h) / (10.21 * h * h + 1.21 * h + 0.14)


def tonemap(
    hdr: np.ndarray,
    exposure: float = 0.0,
    use_filmic: bool = False,
    no_srgb: bool = False,
) -> np.ndarray:
    """HDR (h, w, 4) f32 -> LDR (h, w, 4) u8.

    Parity: tonemap (src/image.cpp:55-77). Alpha passes through the same
    clamp/cast. The final u8 conversion truncates (C cast semantics), it does
    not round.
    """
    h = np.asarray(hdr, dtype=np.float32)
    rgb = h[..., :3] * np.float32(2.0 ** exposure)
    a = h[..., 3:4]
    out = np.concatenate([rgb, a], axis=-1)
    if use_filmic:
        out = np.concatenate([filmic(out[..., :3]), out[..., 3:4]], axis=-1)
    if not no_srgb:
        out = np.concatenate(
            [np.power(np.maximum(out[..., :3], 0.0), np.float32(1 / 2.2)),
             out[..., 3:4]],
            axis=-1,
        )
    out = np.clip(out, 0.0, 1.0) * 255.0
    return out.astype(np.uint8)  # truncation, as the C (unsigned char) cast


def save_hdr_or_ldr(path: str, hdr: np.ndarray) -> None:
    """Extension switch save (parity: src/image.cpp:81-89)."""
    if path.endswith(".hdr"):
        save_image_hdr(path, hdr)
    else:
        save_image_png(path, tonemap(hdr, 0.0, False))
