"""Scene model: host-side assembly, flat SoA arrays and the torch scene.

Port of ``yocto_raytracing_tpu/scene.py`` without its JAX pytree:

* ``Host*`` dataclasses, smooth normals, ``finalize_scene``
  and the framing default camera, with the same loader semantics;
* ``load_scene`` / ``save_scene`` for ``.obj`` through this package's
  copies of the JAX package's numpy-only OBJ parser and writer, and for
  ``.gltf`` / ``.glb`` through its copy of the glTF importer and exporter
  (``io/gltf.py``);
* ``compute_tangent_space`` for normal-mapped shapes;
* ``build_device_scene`` -> ``({leaf name: numpy array}, SceneMeta)``, leaf
  for leaf the JAX ``DeviceScene``. The BVH comes from ``bvh.build_scene_bvh``,
  this package's copy of the JAX package's builder with its native fast
  path: the same builder, because its partition order decides which prim
  wins an equal-t tie;
* ``TorchScene``: the same leaves as tensors on one device, made by
  ``to_torch`` (from this package's arrays) or ``from_jax_arrays`` (from the
  leaves of a JAX ``DeviceScene``, so both packages compute on identical
  inputs); ``detached`` gives the view the hit queries take.

Frames are ``axes`` (3, 3) with rows = x/y/z axis vectors plus origin ``o``.
"""

from __future__ import annotations

import os
from collections.abc import Mapping
from dataclasses import dataclass, field, fields

import numpy as np
import torch

from . import bvh as bvh_mod
from . import image as image_mod
from .io import objparser, objwriter

# primitive type tags in the unified prim pool
PRIM_POINT = 0
PRIM_LINE = 1
PRIM_TRIANGLE = 2

DEFAULT_POINTLINE_RADIUS = 0.001  # src/scene.cpp:128


class SceneLoadError(ValueError):
    """Scene cannot be loaded (missing file, bad format, unknown extension)."""


# --------------------------------------------------------------------------
# host-side containers
# --------------------------------------------------------------------------


@dataclass
class HostShape:
    name: str
    pos: np.ndarray          # (V, 3) f32
    norm: np.ndarray         # (V, 3) f32
    texcoord: np.ndarray     # (V, 2) f32 (zeros if absent)
    radius: np.ndarray       # (V,)  f32 (zeros if absent)
    points: np.ndarray       # (P,)  i32
    lines: np.ndarray        # (L, 2) i32
    triangles: np.ndarray    # (T, 3) i32
    # (Q, 4) i32 tetrahedra (src/scene.h:44), parsed from OBJ 't' lines;
    # no render path reads them, as in the reference
    tetrahedra: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 4), np.int32))
    # (V, 4) tangent space: xyz tangent, w bitangent sign (src/scene.h:36);
    # empty until finalize_scene computes it for a normal-mapped shape
    tangsp: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 4), np.float32))

    @property
    def num_prims(self) -> int:
        return len(self.points) + len(self.lines) + len(self.triangles)


@dataclass
class HostMaterial:
    """App material (src/scene.h:62-86); defaults kd=0.5, ks=0.04."""

    name: str = ""
    ke: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    kd: np.ndarray = field(default_factory=lambda: np.full(3, 0.5, np.float32))
    ks: np.ndarray = field(default_factory=lambda: np.full(3, 0.04, np.float32))
    rs: float = 0.0
    kr: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    ke_txt: int = -1
    kd_txt: int = -1
    ks_txt: int = -1
    kr_txt: int = -1
    norm_txt: int = -1
    disp_txt: int = -1


@dataclass
class HostTexture:
    name: str
    ldr: np.ndarray | None = None  # (h, w, 4) u8
    hdr: np.ndarray | None = None  # (h, w, 4) f32


@dataclass
class HostInstance:
    name: str
    axes: np.ndarray  # (3, 3) f32
    o: np.ndarray     # (3,) f32
    shape: int
    material: int


@dataclass
class HostCamera:
    name: str
    axes: np.ndarray  # (3, 3)
    o: np.ndarray     # (3,)
    yfov: float
    aspect: float
    aperture: float
    focus: float


@dataclass
class HostEnvironment:
    name: str
    axes: np.ndarray
    o: np.ndarray
    ke: np.ndarray
    ke_txt: int


@dataclass
class HostScene:
    cameras: list
    shapes: list
    textures: list
    materials: list
    instances: list
    environments: list
    dirname: str = ""


# --------------------------------------------------------------------------
# normals and tangent space (src/scene.cpp:11-31, 57-104)
# --------------------------------------------------------------------------


def compute_smooth_normals(shp: HostShape) -> np.ndarray:
    """Area/length-weighted smooth normals (parity: src/scene.cpp:11-31)."""
    norm = np.zeros_like(shp.pos)
    if len(shp.lines):
        v0 = shp.pos[shp.lines[:, 0]]
        v1 = shp.pos[shp.lines[:, 1]]
        d = v1 - v0
        w = np.linalg.norm(d, axis=-1, keepdims=True)
        n = np.where(w > 0, d / np.maximum(w, 1e-38), d)
        np.add.at(norm, shp.lines[:, 0], n * w)
        np.add.at(norm, shp.lines[:, 1], n * w)
    if len(shp.triangles):
        v0 = shp.pos[shp.triangles[:, 0]]
        v1 = shp.pos[shp.triangles[:, 1]]
        v2 = shp.pos[shp.triangles[:, 2]]
        c = np.cross(v1 - v0, v2 - v0)
        clen = np.linalg.norm(c, axis=-1, keepdims=True)
        n = np.where(clen > 0, c / np.maximum(clen, 1e-38), c)
        w = clen / 2.0
        for k in range(3):
            np.add.at(norm, shp.triangles[:, k], n * w)
    length = np.linalg.norm(norm, axis=-1, keepdims=True)
    return np.where(length > 0, norm / np.maximum(length, 1e-38), norm)


def compute_tangent_space(shp: HostShape) -> np.ndarray:
    """Area-weighted per-vertex tangent space (parity: src/scene.cpp:80-104).

    Per triangle, tangent and bitangent from the uv deltas (the canonical
    frame where the uv determinant is <= 0, src/scene.cpp:57-78), summed in
    f64 with triangle-area weights in corner order, then orthonormalized
    against the vertex normal, with the bitangent's handedness in w.
    """
    nv = len(shp.pos)
    tangu = np.zeros((nv, 3), np.float64)
    tangv = np.zeros((nv, 3), np.float64)
    tri = shp.triangles
    if len(tri):
        v0, v1, v2 = (shp.pos[tri[:, k]].astype(np.float64) for k in range(3))
        uv0, uv1, uv2 = (shp.texcoord[tri[:, k]].astype(np.float64)
                         for k in range(3))
        p = v1 - v0
        q = v2 - v0
        s = np.stack([uv1[:, 0] - uv0[:, 0], uv2[:, 0] - uv0[:, 0]], -1)
        t = np.stack([uv1[:, 1] - uv0[:, 1], uv2[:, 1] - uv0[:, 1]], -1)
        div = s[:, 0] * t[:, 1] - s[:, 1] * t[:, 0]
        ok = div > 0
        divs = np.where(ok, div, 1.0)[:, None]
        tu = np.where(ok[:, None],
                      (t[:, 1:2] * p - t[:, 0:1] * q) / divs,
                      np.array([1.0, 0.0, 0.0]))
        tv = np.where(ok[:, None],
                      (s[:, 0:1] * q - s[:, 1:2] * p) / divs,
                      np.array([0.0, 1.0, 0.0]))
        w = 0.5 * np.linalg.norm(np.cross(p, q), axis=-1)[:, None]
        for k in range(3):
            np.add.at(tangu, tri[:, k], tu * w)
            np.add.at(tangv, tri[:, k], tv * w)
    norm = shp.norm.astype(np.float64)
    # orthonormalize(a, b) = normalize(a - b * dot(a, b)) (src/vmath.h)
    tangu -= norm * np.sum(tangu * norm, axis=-1, keepdims=True)
    ln = np.linalg.norm(tangu, axis=-1, keepdims=True)
    tangu = np.where(ln > 0, tangu / np.maximum(ln, 1e-38), tangu)
    sign = np.where(
        np.sum(np.cross(norm, tangu) * tangv, axis=-1) < 0, -1.0, 1.0)
    return np.concatenate([tangu, sign[:, None]], -1).astype(np.float32)


def finalize_scene(host: HostScene) -> HostScene:
    """Shared add_elements tail: point/line radius defaults, smooth normals
    and, for normal-mapped shapes with texcoords, the tangent space of
    instanced shapes, and a framing default camera when the file has none
    (src/scene.cpp:217-222, yocto_scn.cpp:1561-1668).
    """
    for shp in host.shapes:
        if (len(shp.points) or len(shp.lines)) and len(shp.radius) == 0:
            shp.radius = np.full(len(shp.pos), DEFAULT_POINTLINE_RADIUS,
                                 np.float32)
        elif len(shp.radius) == 0:
            shp.radius = np.zeros(len(shp.pos), np.float32)

    done = set()
    for ist in host.instances:
        if ist.shape in done:
            continue
        done.add(ist.shape)
        shp = host.shapes[ist.shape]
        if len(shp.norm) == 0:
            shp.norm = compute_smooth_normals(shp)
        has_norm_txt = (0 <= ist.material < len(host.materials)
                        and host.materials[ist.material].norm_txt >= 0)
        if len(shp.tangsp) == 0 and has_norm_txt and len(shp.texcoord):
            shp.tangsp = compute_tangent_space(shp)

    if not host.cameras:
        host.cameras.append(_default_camera(host.shapes, host.instances))
    return host


# --------------------------------------------------------------------------
# loading (src/scene.cpp:113-225)
# --------------------------------------------------------------------------


def load_scene(filename: str) -> HostScene:
    """Load a scene by extension (yscn::load_scene,
    src/ext/yocto_scn.cpp:1497-1504): ``.obj`` -> the OBJ pipeline,
    ``.gltf`` / ``.glb`` -> the glTF importer, anything else ->
    SceneLoadError."""
    if not os.path.exists(filename):
        raise SceneLoadError(f"scene file not found: {filename}")
    ext = os.path.splitext(filename)[1].lower()
    if ext == ".obj":
        return _load_obj_scene(filename)
    if ext in (".gltf", ".glb"):
        from .io import gltf

        return gltf.load_gltf(filename)
    raise SceneLoadError(f"unsupported scene format: {ext or filename}")


def save_scene(host: HostScene, filename: str) -> None:
    """Save a scene by extension (yscn::save_scene,
    src/ext/yocto_scn.h:447-455): ``.obj`` -> OBJ/MTL (``io.objwriter``),
    ``.gltf`` -> glTF + ``.bin``, ``.glb`` -> the binary container
    (``io.gltf.save_gltf``), with texture files beside them; anything else
    -> SceneLoadError."""
    ext = os.path.splitext(filename)[1].lower()
    if ext == ".obj":
        return objwriter.save_obj(host, filename)
    if ext in (".gltf", ".glb"):
        from .io import gltf

        return gltf.save_gltf(host, filename)
    raise SceneLoadError(f"unsupported scene format: {ext or filename}")


def _load_obj_scene(filename: str) -> HostScene:
    """OBJ scene with the reference app's load pipeline
    (src/scene.cpp:113-225): parse, materials and textures, one identity
    instance per shape when the file has no ``i`` lines, then
    ``finalize_scene``."""
    try:
        obj = objparser.load_obj(filename)
    except OSError as e:
        raise SceneLoadError(f"cannot load OBJ scene: {e}") from e
    dirname = os.path.dirname(filename)

    tex_index = {p: i for i, p in enumerate(obj.textures)}

    def tex_id(path: str) -> int:
        return tex_index.get(path, -1) if path else -1

    materials = []
    mat_index = {}
    for m in obj.materials:
        materials.append(HostMaterial(
            name=m.name,
            ke=np.asarray(m.ke, np.float32),
            kd=np.asarray(m.kd, np.float32),
            ks=np.asarray(m.ks, np.float32),
            rs=m.rs,
            kr=np.asarray(m.kr, np.float32),
            ke_txt=tex_id(m.ke_txt),
            kd_txt=tex_id(m.kd_txt),
            ks_txt=tex_id(m.ks_txt),
            kr_txt=tex_id(m.kr_txt),
            norm_txt=tex_id(m.norm_txt),
            disp_txt=tex_id(m.disp_txt),
        ))
        mat_index[m.name] = len(materials) - 1

    # textures: .hdr extension -> float, else LDR u8 (src/scene.cpp:150-160)
    textures = []
    for path in obj.textures:
        full = os.path.join(dirname, path)
        try:
            if path.endswith(".hdr"):
                textures.append(HostTexture(name=path,
                                            hdr=image_mod.load_image4f(full)))
            else:
                textures.append(HostTexture(name=path,
                                            ldr=image_mod.load_image4b(full)))
        except OSError as e:
            raise SceneLoadError(f"cannot load texture {path!r}: {e}") from e

    shapes = []
    shape_mat = []
    for s in obj.shapes:
        if s.pos is None:
            raise SceneLoadError(f"shape {s.name!r} has no positions")
        nverts = len(s.pos)
        shapes.append(HostShape(
            name=s.name,
            pos=s.pos,
            norm=s.norm if s.norm is not None else np.zeros((0, 3), np.float32),
            texcoord=(s.texcoord if s.texcoord is not None
                      else np.zeros((nverts, 2), np.float32)),
            radius=(s.radius if s.radius is not None
                    else np.zeros(0, np.float32)),
            points=s.points,
            lines=s.lines,
            triangles=s.triangles,
            tetrahedra=s.tetrahedra,
        ))
        shape_mat.append(mat_index.get(s.matname, -1))

    instances = []
    if obj.instances:
        for oist in obj.instances:
            for sid in obj.object_shapes.get(oist.objname, []):
                instances.append(HostInstance(
                    name=oist.name,
                    axes=oist.frame[:3].astype(np.float32),
                    o=oist.frame[3].astype(np.float32),
                    shape=sid,
                    material=shape_mat[sid],
                ))
    else:
        for sid, shp in enumerate(shapes):
            instances.append(HostInstance(
                name=shp.name,
                axes=np.eye(3, dtype=np.float32),
                o=np.zeros(3, np.float32),
                shape=sid,
                material=shape_mat[sid],
            ))

    cameras = [HostCamera(name=c.name, axes=c.frame[:3].astype(np.float32),
                          o=c.frame[3].astype(np.float32), yfov=c.yfov,
                          aspect=c.aspect, aperture=c.aperture, focus=c.focus)
               for c in obj.cameras]

    environments = []
    for e in obj.environments:
        mid = mat_index.get(e.matname, -1)
        ke = materials[mid].ke if mid >= 0 else np.zeros(3, np.float32)
        ke_txt = materials[mid].ke_txt if mid >= 0 else -1
        environments.append(HostEnvironment(
            name=e.name, axes=e.frame[:3].astype(np.float32),
            o=e.frame[3].astype(np.float32), ke=ke, ke_txt=ke_txt,
        ))

    return finalize_scene(HostScene(
        cameras=cameras, shapes=shapes, textures=textures,
        materials=materials, instances=instances,
        environments=environments, dirname=dirname,
    ))


def _default_camera(shapes: list, instances: list) -> HostCamera:
    """Framing default camera (parity: yscn add_elements yocto_scn.cpp:1643-1668)."""
    lo = np.full(3, np.inf, np.float32)
    hi = np.full(3, -np.inf, np.float32)
    for ist in instances:
        shp = shapes[ist.shape]
        p = shp.pos @ ist.axes + ist.o
        lo = np.minimum(lo, p.min(axis=0))
        hi = np.maximum(hi, p.max(axis=0))
    center = (lo + hi) / 2
    msize = float((hi - lo).max())
    cam_dir = np.array([1.0, 0.4, 1.0], np.float32)
    frm = cam_dir * msize + center
    z = frm - center
    z = z / np.linalg.norm(z)
    up = np.array([0.0, 1.0, 0.0], np.float32)
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    return HostCamera(
        name="default_camera",
        axes=np.stack([x, y, z]).astype(np.float32),
        o=frm.astype(np.float32),
        yfov=2 * np.arctan(0.5), aspect=16.0 / 9.0,
        aperture=0.0, focus=float(np.linalg.norm(frm - center)),
    )


# --------------------------------------------------------------------------
# flat scene arrays
# --------------------------------------------------------------------------


@dataclass
class SceneMeta:
    """Static facts about a built scene."""

    max_stack: int
    num_instances: int
    num_prims: int
    num_nodes: int
    num_lights: int
    shape_prim_offset: list
    shape_vert_offset: list
    shape_node_root: list
    name: str = ""
    # whether any material references a kd/ks texture: shading skips the
    # texel fetches for a slot no material uses
    has_kd_textures: bool = True
    has_ks_textures: bool = True


def pack_texels(ldr: np.ndarray) -> np.ndarray:
    """(h, w, >=3) u8 -> (h, w) i32 packed r | g<<8 | b<<16."""
    l = ldr.astype(np.int32)
    return l[..., 0] | (l[..., 1] << 8) | (l[..., 2] << 16)


def pack_texel_quads(ldr: np.ndarray) -> np.ndarray:
    """(h, w, >=3) u8 -> (h, w, 4) i32 packed 2x2 bilinear neighbourhoods
    [p(i,j), p(i1,j), p(i,j1), p(i1,j1)], i1 = (i+1) % w, j1 = (j+1) % h:
    the reference's repeat-wrap neighbour rule (src/raytrace.cpp:58-86)."""
    p = pack_texels(ldr)
    px = np.roll(p, -1, axis=1)
    py = np.roll(p, -1, axis=0)
    pxy = np.roll(px, -1, axis=0)
    return np.stack([p, px, py, pxy], axis=-1)


def build_device_scene(host: HostScene, camera: int = 0):
    """HostScene -> ({leaf name: numpy array}, SceneMeta), BVH included.

    The leaves are those of the JAX package's ``DeviceScene``, equal
    array for array; ``to_torch`` moves them to a device."""
    vert_off = []
    prim_off = []
    pos_l, norm_l, tc_l, rad_l = [], [], [], []
    primv_l, primt_l = [], []
    voff = 0
    poff = 0
    for shp in host.shapes:
        vert_off.append(voff)
        prim_off.append(poff)
        nv = len(shp.pos)
        pos_l.append(shp.pos)
        norm_l.append(shp.norm if len(shp.norm) else np.zeros((nv, 3), np.float32))
        tc_l.append(shp.texcoord if len(shp.texcoord) else np.zeros((nv, 2), np.float32))
        rad_l.append(shp.radius if len(shp.radius) else np.zeros(nv, np.float32))
        # prim order = the reference BVH build order: points, lines,
        # triangles (src/scene.cpp:525-547)
        if len(shp.points):
            pv = np.stack([shp.points, shp.points, shp.points], axis=1)
            primv_l.append(pv + voff)
            primt_l.append(np.full(len(shp.points), PRIM_POINT, np.int32))
        if len(shp.lines):
            lv = np.concatenate([shp.lines, shp.lines[:, :1]], axis=1)
            primv_l.append(lv + voff)
            primt_l.append(np.full(len(shp.lines), PRIM_LINE, np.int32))
        if len(shp.triangles):
            primv_l.append(shp.triangles + voff)
            primt_l.append(np.full(len(shp.triangles), PRIM_TRIANGLE, np.int32))
        voff += nv
        poff += shp.num_prims

    pos = np.concatenate(pos_l) if pos_l else np.zeros((0, 3), np.float32)
    norm = np.concatenate(norm_l) if norm_l else np.zeros((0, 3), np.float32)
    texcoord = np.concatenate(tc_l) if tc_l else np.zeros((0, 2), np.float32)
    radius = np.concatenate(rad_l) if rad_l else np.zeros(0, np.float32)
    prim_v = (np.concatenate(primv_l).astype(np.int32)
              if primv_l else np.zeros((0, 3), np.int32))
    prim_type = (np.concatenate(primt_l).astype(np.int32)
                 if primt_l else np.zeros(0, np.int32))

    flat = bvh_mod.build_scene_bvh(host, prim_off)

    inst_axes = np.stack([i.axes for i in host.instances]).astype(np.float32)
    inst_o = np.stack([i.o for i in host.instances]).astype(np.float32)
    inst_shape_root = np.array(
        [flat.shape_node_root[i.shape] for i in host.instances], np.int32)
    inst_mat = np.array([i.material for i in host.instances], np.int32)
    inst_is_lines = np.array(
        [1 if len(host.shapes[i.shape].lines) else 0 for i in host.instances],
        np.int32)

    nm = max(1, len(host.materials))
    mat_ke = np.zeros((nm, 3), np.float32)
    mat_kd = np.full((nm, 3), 0.5, np.float32)
    mat_ks = np.full((nm, 3), 0.04, np.float32)
    mat_kr = np.zeros((nm, 3), np.float32)
    mat_rs = np.zeros(nm, np.float32)
    mat_kd_txt = np.full(nm, -1, np.int32)
    mat_ks_txt = np.full(nm, -1, np.int32)
    for i, m in enumerate(host.materials):
        mat_ke[i] = m.ke
        mat_kd[i] = m.kd
        mat_ks[i] = m.ks
        mat_kr[i] = m.kr
        mat_rs[i] = m.rs
        mat_kd_txt[i] = m.kd_txt
        mat_ks_txt[i] = m.ks_txt

    # textures padded to the largest extent; LDR only (the shading path
    # samples ldr exclusively, src/raytrace.cpp:39-56)
    ldrs = [t.ldr for t in host.textures]
    if any(l is not None for l in ldrs):
        th = max(l.shape[0] for l in ldrs if l is not None)
        tw = max(l.shape[1] for l in ldrs if l is not None)
        tex_quad = np.zeros((len(ldrs), th, tw, 4), np.int32)
        tex_w = np.zeros(len(ldrs), np.int32)
        tex_h = np.zeros(len(ldrs), np.int32)
        for i, l in enumerate(ldrs):
            if l is None:
                continue
            tex_quad[i, :l.shape[0], :l.shape[1]] = pack_texel_quads(l)
            tex_h[i], tex_w[i] = l.shape[0], l.shape[1]
    else:
        tex_quad = np.zeros((1, 1, 1, 4), np.int32)
        tex_w = np.ones(1, np.int32)
        tex_h = np.ones(1, np.int32)

    # lights: every instance whose material has all ke > 0
    # (src/raytrace.cpp:121-130); position = shape pos[0]
    lp, lax, lo, lke = [], [], [], []
    for ist in host.instances:
        if ist.material < 0:
            continue
        ke = host.materials[ist.material].ke
        if (ke > 0).all():
            shp = host.shapes[ist.shape]
            lp.append(shp.pos[0])
            lax.append(ist.axes)
            lo.append(ist.o)
            lke.append(ke)
    if lp:
        light_pos = np.stack(lp).astype(np.float32)
        light_axes = np.stack(lax).astype(np.float32)
        light_o = np.stack(lo).astype(np.float32)
        light_ke = np.stack(lke).astype(np.float32)
    else:
        light_pos = np.zeros((0, 3), np.float32)
        light_axes = np.zeros((0, 3, 3), np.float32)
        light_o = np.zeros((0, 3), np.float32)
        light_ke = np.zeros((0, 3), np.float32)

    cam = host.cameras[camera]
    leaves = dict(
        pos=pos, norm=norm, texcoord=texcoord, radius=radius,
        prim_v=prim_v, prim_type=prim_type,
        node_bbox_min=flat.bbox_min, node_bbox_max=flat.bbox_max,
        node_start=flat.start, node_count=flat.count,
        node_isleaf=flat.isleaf, node_kind=flat.kind,
        node_skip=flat.skip,
        leaf_items=flat.leaf_items,
        inst_axes=inst_axes, inst_o=inst_o,
        inst_shape_root=inst_shape_root, inst_mat=inst_mat,
        inst_is_lines=inst_is_lines,
        mat_ke=mat_ke, mat_kd=mat_kd, mat_ks=mat_ks, mat_kr=mat_kr,
        mat_rs=mat_rs, mat_kd_txt=mat_kd_txt, mat_ks_txt=mat_ks_txt,
        tex_quad=tex_quad, tex_w=tex_w, tex_h=tex_h,
        light_pos=light_pos, light_axes=light_axes,
        light_o=light_o, light_ke=light_ke,
        cam_axes=cam.axes, cam_o=cam.o,
        cam_fovy=np.float32(cam.yfov), cam_aspect=np.float32(cam.aspect),
        cam_focus=np.float32(cam.focus),
        cam_aperture=np.float32(cam.aperture),
    )
    meta = SceneMeta(
        max_stack=flat.max_stack,
        num_instances=len(host.instances),
        num_prims=len(prim_type),
        num_nodes=len(flat.start),
        num_lights=len(light_pos),
        shape_prim_offset=prim_off,
        shape_vert_offset=vert_off,
        shape_node_root=flat.shape_node_root,
        has_kd_textures=bool((mat_kd_txt >= 0).any()),
        has_ks_textures=bool((mat_ks_txt >= 0).any()),
    )
    return leaves, meta


# --------------------------------------------------------------------------
# torch scene
# --------------------------------------------------------------------------


@dataclass
class TorchScene:
    """The flat SoA scene as tensors on one device (f32 and i32 leaves).

    Field for field the JAX ``DeviceScene``. BVH layout: one node pool,
    scene tree first (root = node 0), then every shape tree at
    ``inst_shape_root``; scene leaves index instances through
    ``leaf_items``, shape leaves index the prim pool; ``node_skip`` threads
    the trees for stackless traversal.
    """

    pos: torch.Tensor            # (V, 3) f32
    norm: torch.Tensor           # (V, 3) f32
    texcoord: torch.Tensor       # (V, 2) f32
    radius: torch.Tensor         # (V,) f32
    prim_v: torch.Tensor         # (P, 3) i32 global vertex ids
    prim_type: torch.Tensor      # (P,) i32 PRIM_*
    node_bbox_min: torch.Tensor  # (M, 3) f32
    node_bbox_max: torch.Tensor  # (M, 3) f32
    node_start: torch.Tensor     # (M,) i32 first child / leaf_items slot
    node_count: torch.Tensor     # (M,) i32
    node_isleaf: torch.Tensor    # (M,) i32
    node_kind: torch.Tensor      # (M,) i32 0: instances, 1: prims
    node_skip: torch.Tensor      # (M,) i32 threaded skip (-1 = done)
    leaf_items: torch.Tensor     # (K,) i32
    inst_axes: torch.Tensor      # (I, 3, 3) f32
    inst_o: torch.Tensor         # (I, 3) f32
    inst_shape_root: torch.Tensor  # (I,) i32
    inst_mat: torch.Tensor       # (I,) i32
    inst_is_lines: torch.Tensor  # (I,) i32 hair BRDF flag
    mat_ke: torch.Tensor         # (Mt, 3) f32
    mat_kd: torch.Tensor         # (Mt, 3) f32
    mat_ks: torch.Tensor         # (Mt, 3) f32
    mat_kr: torch.Tensor         # (Mt, 3) f32
    mat_rs: torch.Tensor         # (Mt,) f32
    mat_kd_txt: torch.Tensor     # (Mt,) i32, -1 = none
    mat_ks_txt: torch.Tensor     # (Mt,) i32
    tex_quad: torch.Tensor       # (T, th, tw, 4) i32 packed 2x2 texels
    tex_w: torch.Tensor          # (T,) i32
    tex_h: torch.Tensor          # (T,) i32
    light_pos: torch.Tensor      # (L, 3) f32
    light_axes: torch.Tensor     # (L, 3, 3) f32
    light_o: torch.Tensor        # (L, 3) f32
    light_ke: torch.Tensor       # (L, 3) f32
    cam_axes: torch.Tensor       # (3, 3) f32
    cam_o: torch.Tensor          # (3,) f32
    cam_fovy: torch.Tensor       # () f32
    cam_aspect: torch.Tensor     # () f32
    cam_focus: torch.Tensor      # () f32
    cam_aperture: torch.Tensor   # () f32

    @property
    def device(self) -> torch.device:
        return self.pos.device


LEAF_NAMES = tuple(f.name for f in fields(TorchScene))


def detached(scene: TorchScene) -> TorchScene:
    """The same leaves, detached from any autograd graph (no copy): what the
    hit queries see, so the traversal records no graph (detached-traversal
    gradients)."""
    return TorchScene(*(getattr(scene, n).detach() for n in LEAF_NAMES))


def to_torch(np_scene: Mapping[str, np.ndarray],
             device="cuda") -> TorchScene:
    """{leaf name: numpy array} -> TorchScene on ``device`` (the card unless
    the caller asks for the CPU).

    Float leaves become f32 and integer leaves i32, values and shapes
    unchanged (the camera scalars are 0-dim).
    Raises if a leaf is missing or unknown, or if ``device`` is a CUDA
    device and no card is present.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    names = set(np_scene)
    if names != set(LEAF_NAMES):
        raise ValueError(f"scene leaves differ: missing "
                         f"{sorted(set(LEAF_NAMES) - names)}, unknown "
                         f"{sorted(names - set(LEAF_NAMES))}")
    out = {}
    for name in LEAF_NAMES:
        a = np.asarray(np_scene[name])
        dtype = np.float32 if np.issubdtype(a.dtype, np.floating) else np.int32
        # np.array keeps 0-dim leaves 0-dim (ascontiguousarray would not)
        out[name] = torch.from_numpy(
            np.array(a, dtype, order="C")).to(device)
    return TorchScene(**out)


def from_jax_arrays(leaves: Mapping[str, np.ndarray], device) -> TorchScene:
    """TorchScene from the leaves of a JAX ``DeviceScene`` given as
    ``{field name: np.asarray(leaf)}``, so that both packages compute on
    identical inputs."""
    return to_torch({k: np.asarray(v) for k, v in leaves.items()}, device)
