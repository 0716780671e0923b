"""Shape and camera builders of the benchmark's scene generators: the
benchmark's frozen copy.

Copied from yocto_raytracing_tpu_torch/testscenes.py at commit 2bec3df
(``_shape``, ``lookat_camera``, ``uv_sphere``, ``quad_floor``,
``point_light_shape``, ``hair_strands``, ``assemble``), code unchanged, on
the containers of ``ref.flat``. The same seeds and float arithmetic, so
every scene equals the port's fixture of the same name.
"""

from __future__ import annotations

import numpy as np

from .flat import (DEFAULT_POINTLINE_RADIUS, HostCamera, HostInstance,
                   HostScene, HostShape, compute_smooth_normals)


def _shape(name, pos, points=None, lines=None, triangles=None, radius=None,
           texcoord=None) -> HostShape:
    pos = np.asarray(pos, np.float32)
    nv = len(pos)
    shp = HostShape(
        name=name,
        pos=pos,
        norm=np.zeros((0, 3), np.float32),
        texcoord=(np.asarray(texcoord, np.float32) if texcoord is not None
                  else np.zeros((nv, 2), np.float32)),
        radius=(np.asarray(radius, np.float32) if radius is not None
                else np.zeros(0, np.float32)),
        points=(np.asarray(points, np.int32) if points is not None
                else np.zeros(0, np.int32)),
        lines=(np.asarray(lines, np.int32).reshape(-1, 2)
               if lines is not None else np.zeros((0, 2), np.int32)),
        triangles=(np.asarray(triangles, np.int32).reshape(-1, 3)
                   if triangles is not None else np.zeros((0, 3), np.int32)),
    )
    if len(shp.radius) == 0:
        if len(shp.points) or len(shp.lines):
            shp.radius = np.full(nv, DEFAULT_POINTLINE_RADIUS, np.float32)
        else:
            shp.radius = np.zeros(nv, np.float32)
    shp.norm = compute_smooth_normals(shp)
    return shp


def lookat_camera(name, eye, target, up=(0, 1, 0), yfov=2 * np.arctan(0.5),
                  aspect=16 / 9, focus=None) -> HostCamera:
    """lookat frame (parity: lookat_frame3f, src/vmath.h:206-213)."""
    eye = np.asarray(eye, np.float32)
    target = np.asarray(target, np.float32)
    z = eye - target
    z = z / np.linalg.norm(z)
    x = np.cross(np.asarray(up, np.float32), z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    return HostCamera(
        name=name, axes=np.stack([x, y, z]).astype(np.float32), o=eye,
        yfov=float(yfov), aspect=float(aspect), aperture=0.0,
        focus=float(focus if focus is not None
                    else np.linalg.norm(eye - target)),
    )


def uv_sphere(name, center=(0, 0, 0), rad=1.0, nu=16, nv=8) -> HostShape:
    """Lat-long triangulated sphere."""
    center = np.asarray(center, np.float32)
    us = np.linspace(0, 2 * np.pi, nu + 1)
    vs = np.linspace(0, np.pi, nv + 1)
    uu, vv = np.meshgrid(us, vs, indexing="ij")  # (nu+1, nv+1)
    pos = np.stack([
        np.cos(uu) * np.sin(vv),
        np.cos(vv),
        np.sin(uu) * np.sin(vv),
    ], axis=-1).reshape(-1, 3) * rad + center
    tc = np.stack([uu / (2 * np.pi), vv / np.pi], axis=-1).reshape(-1, 2)

    def vid(i, j):
        return i * (nv + 1) + j

    tris = []
    for i in range(nu):
        for j in range(nv):
            a, b = vid(i, j), vid(i + 1, j)
            c, d = vid(i + 1, j + 1), vid(i, j + 1)
            tris.append((a, b, c))
            tris.append((a, c, d))
    return _shape(name, pos, triangles=np.asarray(tris, np.int32),
                  texcoord=tc)


def quad_floor(name, half=4.0, y=0.0) -> HostShape:
    pos = np.array([[-half, y, -half], [half, y, -half],
                    [half, y, half], [-half, y, half]], np.float32)
    tc = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    tris = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    return _shape(name, pos, triangles=tris, texcoord=tc)


def point_light_shape(name, p) -> HostShape:
    return _shape(name, np.asarray([p], np.float32), points=[0])


def hair_strands(name, center=(0, 1, 0), rad=0.5, n_strands=128, n_segs=4,
                 length=0.3, root_radius=0.004, tip_radius=0.001,
                 seed=7) -> HostShape:
    """Line strands sprouting radially from a sphere surface."""
    rng = np.random.default_rng(seed)
    center = np.asarray(center, np.float32)
    # deterministic fibonacci-ish sphere points
    k = np.arange(n_strands, dtype=np.float64)
    phi = np.arccos(1 - 2 * (k + 0.5) / n_strands)
    theta = np.pi * (1 + 5**0.5) * k
    dirs = np.stack([np.sin(phi) * np.cos(theta), np.cos(phi),
                     np.sin(phi) * np.sin(theta)], axis=-1)
    bend = rng.normal(scale=0.15, size=(n_strands, 3))

    pos, rads, lines = [], [], []
    for s in range(n_strands):
        base = len(pos)
        d = dirs[s]
        for t in range(n_segs + 1):
            f = t / n_segs
            p = center + d * (rad + length * f) + bend[s] * (length * f * f)
            pos.append(p)
            rads.append(root_radius * (1 - f) + tip_radius * f)
            if t > 0:
                lines.append((base + t - 1, base + t))
    return _shape(name, np.asarray(pos, np.float32),
                  lines=np.asarray(lines, np.int32),
                  radius=np.asarray(rads, np.float32))


def assemble(shapes, materials, shape_mat, cameras,
             instances=None) -> HostScene:
    """Identity-instanced scene from parallel shape/material lists."""
    if instances is None:
        instances = [
            HostInstance(name=s.name, axes=np.eye(3, dtype=np.float32),
                         o=np.zeros(3, np.float32), shape=i,
                         material=shape_mat[i])
            for i, s in enumerate(shapes)
        ]
    return HostScene(cameras=cameras, shapes=shapes, textures=[],
                     materials=materials, instances=instances,
                     environments=[])
