"""Procedural scenes: test fixtures and the synthesized hair scene.

Port of ``yocto_raytracing_tpu/testscenes.py`` on this package's ``Host*``
classes, so scenes can be built where JAX is not installed. Same seeds and
the same float arithmetic, so every scene equals the JAX package's.

* ``make_hair_scene``: the lines_pointlight stand-in (line strands over a
  sphere, a floor, two point lights);
* ``make_textured_hair_scene``: the hair scene with kd and ks checker
  textures (floor and sphere), for the texture branch of shading and d_uv;
* ``make_grad_scene``: one triangle over a ``kr=0.5`` mirror, one light;
* ``make_random_scene``: random mixed-primitive multi-instance scenes;
* ``panel_grid``: the vertices and triangles of a square lamp panel as a
  grid of cells, for mesh area lights (the port's own; no JAX
  counterpart);
* ``make_mirror_pair_scene``: two facing ``kr=0.8`` mirrors with the
  camera between them, where a ray goes on for several bounces (the
  port's own, a fixture of the device loop; no JAX counterpart).
"""

from __future__ import annotations

import numpy as np

from .scene import (
    HostCamera,
    HostInstance,
    HostMaterial,
    HostScene,
    HostShape,
    HostTexture,
    compute_smooth_normals,
    DEFAULT_POINTLINE_RADIUS,
)


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


def panel_grid(center, size=1.0, cells=32):
    """A ``size`` square around ``center`` in its horizontal plane as a
    grid of ``cells`` x ``cells`` cells, two triangles each, facing down:
    (pos ((cells + 1)^2, 3) f32, triangles (2 cells^2, 3) i32). At
    ``cells=1`` it is the four-vertex, two-triangle quad."""
    c = np.asarray(center, np.float32)
    t = np.linspace(-0.5 * size, 0.5 * size, cells + 1, dtype=np.float32)
    z, x = np.meshgrid(t, t, indexing="ij")
    pos = np.stack([x, np.zeros_like(x), z], axis=-1).reshape(-1, 3) + c
    k = np.arange(cells + 1) * (cells + 1)
    v00 = (k[:-1, None] + np.arange(cells)[None, :]).reshape(-1)
    v10, v01, v11 = v00 + 1, v00 + cells + 1, v00 + cells + 2
    tris = np.stack([np.stack([v00, v10, v11], -1),
                     np.stack([v00, v11, v01], -1)], axis=1).reshape(-1, 3)
    return pos.astype(np.float32), tris.astype(np.int32)


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


def make_hair_scene(n_strands=256) -> HostScene:
    """The synthesized lines_pointlight stand-in (see module docstring)."""
    interior = uv_sphere("interior", center=(0, 1, 0), rad=0.5, nu=24, nv=12)
    hair = hair_strands("lines", center=(0, 1, 0), rad=0.5,
                        n_strands=n_strands)
    floor = quad_floor("floor", half=6.0, y=0.0)
    l1 = point_light_shape("light1", (2.0, 4.0, 3.0))
    l2 = point_light_shape("light2", (-2.5, 3.5, -1.0))
    shapes = [floor, interior, hair, l1, l2]
    materials = [
        HostMaterial(name="floor", kd=np.full(3, 0.3, np.float32),
                     ks=np.zeros(3, np.float32), rs=0.1),
        HostMaterial(name="interior",
                     kd=np.asarray([0.3, 0.2, 0.1], np.float32),
                     ks=np.full(3, 0.02, np.float32), rs=0.2),
        HostMaterial(name="lines",
                     kd=np.asarray([0.6, 0.4, 0.2], np.float32),
                     ks=np.full(3, 0.08, np.float32), rs=0.15),
        HostMaterial(name="pointlight", ke=np.full(3, 40.0, np.float32),
                     kd=np.zeros(3, np.float32), ks=np.zeros(3, np.float32)),
    ]
    shape_mat = [0, 1, 2, 3, 3]
    cam = lookat_camera("cam", eye=(0.0, 1.8, 3.2), target=(0, 0.9, 0))
    return assemble(shapes, materials, shape_mat, [cam])


def checker_image(width, height, tile, c0, c1) -> np.ndarray:
    """(height, width, 4) u8 checkerboard, ``c0`` where
    ``(i // tile + j // tile)`` is even (the JAX package's
    ``procedural.make_checker_image``)."""
    j, i = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    even = (i // tile + j // tile) % 2 == 0
    return np.where(even[..., None], np.asarray(c0, np.uint8),
                    np.asarray(c1, np.uint8)).astype(np.uint8)


def make_textured_hair_scene(n_strands=64) -> HostScene:
    """``make_hair_scene`` with a kd checker on the floor and a ks checker
    (ks 0.5) on the sphere."""
    host = make_hair_scene(n_strands)
    host.textures = [
        HostTexture("checker_kd.png", ldr=checker_image(
            64, 48, 8, (200, 60, 30, 255), (40, 120, 220, 255))),
        HostTexture("checker_ks.png", ldr=checker_image(
            32, 32, 4, (250, 250, 250, 255), (10, 80, 10, 255))),
    ]
    host.materials[0].kd_txt = 0      # floor
    host.materials[1].ks_txt = 1      # interior sphere
    host.materials[1].ks = np.full(3, 0.5, np.float32)
    return host


def make_grad_scene() -> HostScene:
    """Tiny analytic scene for finite-difference gradient checks.

    One large triangle facing the camera, one point light off-axis — every
    shading term (diffuse, specular, ambient, 1/r^2 falloff) active, no
    occlusion boundaries near the sample rays so pixel gradients are smooth.
    """
    tri = _shape("tri",
                 [[-2.0, -1.5, 0.0], [2.0, -1.5, 0.0], [0.0, 2.0, 0.0]],
                 triangles=[[0, 1, 2]])
    light = point_light_shape("light", (1.5, 2.0, 3.0))
    mirror = _shape("mirror",
                    [[-3.0, -1.6, -1.0], [3.0, -1.6, -1.0], [3.0, -1.6, 4.0],
                     [-3.0, -1.6, 4.0]],
                    triangles=[[0, 1, 2], [0, 2, 3]])
    shapes = [tri, mirror, light]
    materials = [
        HostMaterial(name="mat",
                     kd=np.asarray([0.4, 0.5, 0.6], np.float32),
                     ks=np.full(3, 0.06, np.float32), rs=0.25),
        HostMaterial(name="mirror", kd=np.full(3, 0.1, np.float32),
                     ks=np.zeros(3, np.float32), rs=0.0,
                     kr=np.full(3, 0.5, np.float32)),
        HostMaterial(name="light", ke=np.full(3, 30.0, np.float32),
                     kd=np.zeros(3, np.float32), ks=np.zeros(3, np.float32)),
    ]
    cam = lookat_camera("cam", eye=(0.0, 0.0, 4.0), target=(0, 0, 0),
                        aspect=1.0)
    return assemble(shapes, materials, [0, 1, 2], [cam])


def make_mirror_pair_scene() -> HostScene:
    """Two parallel 8 x 6 mirrors (``kr=0.8``) facing each other at z = -1
    and z = 6, the camera at z = 4 looking down -z, a triangle between
    them and one point light: the rays near the view axis go from mirror
    to mirror, so bounces 2, 3 and later run in the middle of the frame
    and not at its edges."""
    front = _shape("front", [[-4.0, -3.0, -1.0], [4.0, -3.0, -1.0],
                             [4.0, 3.0, -1.0], [-4.0, 3.0, -1.0]],
                   triangles=[[0, 1, 2], [0, 2, 3]])
    back = _shape("back", [[-4.0, -3.0, 6.0], [-4.0, 3.0, 6.0],
                           [4.0, 3.0, 6.0], [4.0, -3.0, 6.0]],
                  triangles=[[0, 1, 2], [0, 2, 3]])
    tri = _shape("tri", [[-1.0, -0.75, 1.0], [1.0, -0.75, 1.0],
                         [0.0, 1.0, 1.0]], triangles=[[0, 1, 2]])
    light = point_light_shape("light", (1.5, 2.0, 2.5))
    shapes = [front, back, tri, light]
    mirror = HostMaterial(name="mirror", kd=np.full(3, 0.1, np.float32),
                          ks=np.zeros(3, np.float32), rs=0.0,
                          kr=np.full(3, 0.8, np.float32))
    materials = [
        mirror,
        HostMaterial(name="mat", kd=np.asarray([0.6, 0.3, 0.2], np.float32),
                     ks=np.full(3, 0.06, np.float32), rs=0.25),
        HostMaterial(name="light", ke=np.full(3, 30.0, np.float32),
                     kd=np.zeros(3, np.float32), ks=np.zeros(3, np.float32)),
    ]
    cam = lookat_camera("cam", eye=(0.0, 0.0, 4.0), target=(0.2, 0.1, 0.0),
                        aspect=1.0)
    return assemble(shapes, materials, [0, 0, 1, 2], [cam])


def make_random_scene(seed=0, n_shapes=3, n_tris=40, n_lines=12, n_points=6,
                      n_instances=8) -> HostScene:
    """Random mixed-primitive multi-instance scene for BVH property tests."""
    rng = np.random.default_rng(seed)
    shapes = []
    for s in range(n_shapes):
        nv = n_tris + 2 + n_lines + 1 + n_points
        pos = rng.uniform(-1, 1, size=(nv, 3)).astype(np.float32)
        tris = rng.integers(0, n_tris + 2, size=(n_tris, 3))
        lines = np.stack([np.arange(n_tris + 1, n_tris + 1 + n_lines),
                          np.arange(n_tris + 2, n_tris + 2 + n_lines)],
                         axis=1)
        points = np.arange(n_tris + 2 + n_lines,
                           n_tris + 2 + n_lines + n_points)
        radius = rng.uniform(0.01, 0.08, size=nv).astype(np.float32)
        shapes.append(_shape(f"shape{s}", pos, points=points, lines=lines,
                             triangles=tris, radius=radius))
    materials = [HostMaterial(name="mat")]
    instances = []
    for i in range(n_instances):
        # random rigid frame: rotation about a random axis + translation
        ang = rng.uniform(0, 2 * np.pi)
        ax = rng.normal(size=3)
        ax /= np.linalg.norm(ax)
        c, si = np.cos(ang), np.sin(ang)
        K = np.array([[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]],
                      [-ax[1], ax[0], 0]])
        rot = (np.eye(3) + si * K + (1 - c) * K @ K).astype(np.float32)
        instances.append(HostInstance(
            name=f"inst{i}", axes=rot,
            o=rng.uniform(-3, 3, size=3).astype(np.float32),
            shape=int(rng.integers(0, n_shapes)), material=0))
    cam = lookat_camera("cam", eye=(0, 0, 8), target=(0, 0, 0))
    return HostScene(cameras=[cam], shapes=shapes, textures=[],
                     materials=materials, instances=instances,
                     environments=[])


def make_mixed_frame_scene(seed=0) -> HostScene:
    """``make_random_scene``'s shapes under 12 instances whose frames mix
    the identity's bits with frames a bit away from them: instances 0-4
    identity (axes rows 1 0 0, 0 1 0, 0 0 1, origin +0 +0 +0); 5 with an
    origin of (-0.0, +0, +0); 6 with an axis word 1 ulp above 1.0; 7 with
    one 1 ulp above +0.0 (the smallest subnormal); 8 with one -0.0; 9-11
    rotated and moved. Shares of identity frames: 5 / 12."""
    host = make_random_scene(seed=seed, n_instances=12)
    one_up = np.nextafter(np.float32(1), np.float32(2))
    zero_up = np.nextafter(np.float32(0), np.float32(1))
    for k, ist in enumerate(host.instances[:9]):
        ist.axes = np.eye(3, dtype=np.float32)
        ist.o = np.zeros(3, np.float32)
        ist.shape = k % len(host.shapes)
    host.instances[5].o[0] = np.float32(-0.0)
    host.instances[6].axes[1, 1] = one_up
    host.instances[7].axes[2, 0] = zero_up
    host.instances[8].axes[0, 2] = np.float32(-0.0)
    return host
