"""Scene arrays for the plain reference: the benchmark's frozen copy.

Copied from yocto_raytracing_tpu_torch/scene.py at commit 2bec3df: the
``Host*`` containers (without textures, environments, tetrahedra and
tangent spaces, which no generator of the benchmark makes),
``compute_smooth_normals``, ``SceneMeta`` and ``build_device_scene`` (flat
leaves and the BVH of ``ref.bvh``), code unchanged. Added here: ``as_loaded``, which works out from a generator's
scene what the OBJ round trip makes of it (the scene the program loads),
and ``to_device``, the leaves as tensors on a device in a chosen float
dtype.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from types import SimpleNamespace

import numpy as np
import torch

from . import bvh as bvh_mod

# primitive type tags in the unified prim pool
PRIM_POINT = 0
PRIM_LINE = 1
PRIM_TRIANGLE = 2

DEFAULT_POINTLINE_RADIUS = 0.001  # src/scene.cpp:128


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


def _f32(x: float) -> float:
    """A number as the OBJ writer prints it and the parser reads it back:
    the repr of its float32, which round-trips exactly."""
    return float(np.float32(x))


def as_loaded(host: HostScene) -> HostScene:
    """The scene the program gets from ``save_obj`` then ``load_scene``,
    worked out from the generator's own: every float leaf goes through
    float32 (exact), texcoord v through the writer's ``1 - v`` and the
    parser's ``1 - v`` in double, roughness through ``Ns = 2 / rs^4 - 2``
    and back through ``rs = (2 / (Ns + 2))^(1/4)``, and one identity
    instance per shape (the generators' instances)."""
    shapes = []
    for shp in host.shapes:
        tris = np.asarray(shp.triangles, np.int32).reshape(-1, 3)
        lines = np.asarray(shp.lines, np.int32).reshape(-1, 2)
        points = np.asarray(shp.points, np.int32).reshape(-1)
        # the parser numbers a shape's vertices in the order the elements
        # (written triangles, lines, points) first use them
        used = np.concatenate([tris.reshape(-1), lines.reshape(-1), points])
        _, first = np.unique(used, return_index=True)
        order = used[np.sort(first)]
        new_id = np.full(len(shp.pos), -1, np.int32)
        new_id[order] = np.arange(len(order), dtype=np.int32)
        tc = np.asarray(shp.texcoord, np.float32)[order]
        v = np.array([_f32(1.0 - float(_f32(1.0 - float(t))))
                      for t in tc[:, 1]], np.float32)
        has_radius = len(shp.radius) and (len(points) or len(lines))
        shapes.append(HostShape(
            name=shp.name, pos=np.asarray(shp.pos, np.float32)[order],
            norm=np.asarray(shp.norm, np.float32)[order],
            texcoord=np.stack([tc[:, 0], v], -1).astype(np.float32),
            radius=(np.asarray(shp.radius, np.float32)[order] if has_radius
                    else np.zeros(len(order), np.float32)),
            points=new_id[points], lines=new_id[lines],
            triangles=new_id[tris]))
    materials = []
    for m in host.materials:
        ns = _f32(2.0 / float(m.rs) ** 4 - 2.0 if m.rs else 1e6)
        materials.append(HostMaterial(
            name=m.name, ke=np.asarray(m.ke, np.float32),
            kd=np.asarray(m.kd, np.float32), ks=np.asarray(m.ks, np.float32),
            rs=float((2.0 / (ns + 2.0)) ** 0.25),
            kr=np.asarray(m.kr, np.float32)))
    cams = [HostCamera(name=c.name, axes=np.asarray(c.axes, np.float32),
                       o=np.asarray(c.o, np.float32), yfov=_f32(c.yfov),
                       aspect=_f32(c.aspect), aperture=_f32(c.aperture),
                       focus=_f32(c.focus)) for c in host.cameras]
    return HostScene(cameras=cams, shapes=shapes, textures=[],
                     materials=materials, instances=list(host.instances),
                     environments=[])


class Leaves(SimpleNamespace):
    """The scene's leaves as attributes, like the port's ``TorchScene``."""

    @property
    def device(self) -> torch.device:
        return self.pos.device


def to_device(leaves: dict, device, dtype=torch.float32) -> Leaves:
    """The leaves as tensors on ``device``: float leaves in ``dtype``,
    integer leaves i32 (0-dim camera scalars stay 0-dim)."""
    out = {}
    for name, a in leaves.items():
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.floating):
            t = torch.from_numpy(np.array(a, np.float32)).to(device, dtype)
        else:
            t = torch.from_numpy(np.array(a, np.int32)).to(device)
        out[name] = t
    return Leaves(**out)


def lowered(scene: Leaves, dtype) -> Leaves:
    """The same leaves with the float ones in ``dtype`` (the control)."""
    return Leaves(**{k: v.to(dtype) if v.is_floating_point() else v
                     for k, v in vars(scene).items()})
