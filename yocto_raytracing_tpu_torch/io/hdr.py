"""Radiance RGBE (.hdr) codec.

The reference round-trips float renders through stb's Radiance codec
(stbi_write_hdr / stbi_loadf, src/image.cpp:13-23,39-42). This is a
from-scratch implementation of the same file format: RLE-compressed RGBE
scanlines, ``-Y h +X w`` layout, shared-exponent mantissa encoding.

This package's own copy of ``yocto_raytracing_tpu/io/hdr.py``, code and
results unchanged.
"""

from __future__ import annotations

import numpy as np


def _rgbe_encode(rgb: np.ndarray) -> np.ndarray:
    """f32 (..., 3) -> u8 (..., 4) RGBE (matches stb's encoding choices)."""
    maxcomp = rgb.max(axis=-1)
    out = np.zeros(rgb.shape[:-1] + (4,), dtype=np.uint8)
    valid = maxcomp >= 1e-32
    # frexp: maxcomp = m * 2^e with m in [0.5, 1)
    m, e = np.frexp(np.where(valid, maxcomp, 1.0))
    scale = np.where(valid, m * 256.0 / np.maximum(maxcomp, 1e-38), 0.0)
    mant = np.clip(rgb * scale[..., None], 0, 255).astype(np.uint8)
    out[..., :3] = np.where(valid[..., None], mant, 0)
    out[..., 3] = np.where(valid, (e + 128).astype(np.uint8), 0)
    return out


def _rgbe_decode(rgbe: np.ndarray) -> np.ndarray:
    """u8 (..., 4) RGBE -> f32 (..., 3)."""
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(1.0, e - 136), 0.0).astype(np.float32)
    return (rgbe[..., :3].astype(np.float32) + 0.5) * scale[..., None]


def write_hdr(path: str, rgb: np.ndarray) -> None:
    """Write f32 RGB (h, w, 3) as a Radiance .hdr file (RLE scanlines)."""
    rgb = np.asarray(rgb, dtype=np.float32)
    h, w = rgb.shape[:2]
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\n")
        f.write(b"FORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        rgbe = _rgbe_encode(rgb)
        if w < 8 or w > 32767:
            f.write(rgbe.tobytes())
            return
        for j in range(h):
            f.write(bytes([2, 2, (w >> 8) & 0xFF, w & 0xFF]))
            for c in range(4):
                f.write(_rle_encode(rgbe[j, :, c]))


def _rle_encode(row: np.ndarray) -> bytes:
    """Radiance new-style RLE for one channel of one scanline."""
    out = bytearray()
    n = len(row)
    i = 0
    while i < n:
        # find a run of equal bytes
        run_len = 1
        while i + run_len < n and run_len < 127 and row[i + run_len] == row[i]:
            run_len += 1
        if run_len >= 4:
            out.append(128 + run_len)
            out.append(int(row[i]))
            i += run_len
        else:
            # literal segment: up to 128 bytes, stop early at a >=4 run
            start = i
            i += run_len
            while i < n and i - start < 128:
                run_len = 1
                while (i + run_len < n and run_len < 4
                       and row[i + run_len] == row[i]):
                    run_len += 1
                if run_len >= 4:
                    break
                i += run_len
            seg = row[start:i]
            out.append(len(seg))
            out.extend(seg.tobytes())
    return bytes(out)


def read_hdr(path: str) -> np.ndarray:
    """Read a Radiance .hdr file into f32 RGB (h, w, 3)."""
    with open(path, "rb") as f:
        data = f.read()
    # header: lines until blank line, then resolution line
    pos = 0
    if not data.startswith(b"#?"):
        raise ValueError(f"{path}: not a Radiance file")
    while True:
        eol = data.index(b"\n", pos)
        line = data[pos:eol]
        pos = eol + 1
        if line == b"":
            break
    eol = data.index(b"\n", pos)
    res = data[pos:eol].decode().split()
    pos = eol + 1
    if len(res) != 4 or res[0] != "-Y" or res[2] != "+X":
        raise ValueError(f"{path}: unsupported layout {res}")
    h, w = int(res[1]), int(res[3])

    rgbe = np.zeros((h, w, 4), dtype=np.uint8)
    buf = memoryview(data)
    for j in range(h):
        if w < 8 or w > 32767 or buf[pos] != 2 or buf[pos + 1] != 2:
            # flat (old-style) scanlines
            flat = np.frombuffer(buf[pos:pos + w * 4], dtype=np.uint8)
            rgbe[j] = flat.reshape(w, 4)
            pos += w * 4
            continue
        if ((buf[pos + 2] << 8) | buf[pos + 3]) != w:
            raise ValueError(f"{path}: scanline width mismatch")
        pos += 4
        for c in range(4):
            x = 0
            while x < w:
                count = buf[pos]
                pos += 1
                if count > 128:  # run
                    rgbe[j, x:x + count - 128, c] = buf[pos]
                    x += count - 128
                    pos += 1
                else:  # literal
                    seg = np.frombuffer(buf[pos:pos + count], dtype=np.uint8)
                    rgbe[j, x:x + count, c] = seg
                    x += count
                    pos += count
    return _rgbe_decode(rgbe)
