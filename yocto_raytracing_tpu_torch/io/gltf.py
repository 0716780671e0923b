"""glTF 2.0 scene import/export (JSON ``.gltf`` + GLB ``.glb``).

This package's own copy of ``yocto_raytracing_tpu/io/gltf.py``: numpy on
the host, the same arithmetic in the same order, so both packages load the
same host scene from a file and write the same bytes for a host scene.
``skin_vertices`` is torch, on the card unless the caller asks for the CPU.

Importer with the capability set of the reference's glTF path
(src/ext/yocto_gltf.{h,cpp} low-level parse + yscn gltf_to_scene,
src/ext/yocto_scn.cpp:697-1099), flattened straight into ``HostScene``
arrays:

* buffers: external ``.bin`` URIs, base64 ``data:`` URIs, GLB BIN chunk.
* accessors: all five component types, SCALAR/VEC2/VEC3/VEC4, interleaved
  bufferView byteStride, ``normalized`` integer attributes, sparse.
* meshes: POSITION/NORMAL/TEXCOORD_0/RADIUS attributes and every primitive
  mode (points, lines, line loop/strip, triangles, triangle strip/fan),
  indexed or not, with the index-expansion rules of yocto_scn.cpp:925-1030.
* node hierarchy: per-node transform ``T * R * S * matrix``
  (src/ext/yocto_gltf.cpp:2586-2590), flattened so each node with a mesh
  becomes one instance per primitive and each node with a camera a camera
  (yocto_scn.cpp:697-718); default scene, else root-node detection
  (yocto_scn.cpp:1060-1078).
* materials: emissiveFactor -> ke; pbrMetallicRoughness -> kd/ks by the
  reference's metallic->specular mapping (yocto_scn.cpp:545-556);
  KHR_materials_pbrSpecularGlossiness -> kd/ks/rs exactly
  (yocto_scn.cpp:865-875, applied after MR like the reference).
* images: file URIs (decoded by extension like the app layer,
  src/scene.cpp:150-160), ``data:`` URIs, and bufferView-embedded images,
  through PIL.
* with ``return_graph``: the node graph, animation channels (STEP, LINEAR,
  CUBICSPLINE), skins and morph targets, for keyframe playback.

The exporter writes a ``.gltf`` + sidecar ``.bin``, or a binary ``.glb``
container (JSON + BIN chunks, the reference's ``save_binary_gltf``,
src/ext/yocto_gltf.h:651), plus texture image files, that round-trips
through the importer: materials carry both the MR approximation and the
exact spec-gloss extension, so kd/ks/rs survive bit for bit; ``kr`` (no
glTF equivalent) goes to ``extras``.
"""

from __future__ import annotations

import base64
import io as _io
import json
import os
import struct

import numpy as np
import torch

from .. import image as image_mod
from .. import scene as scene_mod

# componentType -> numpy dtype (glTF 2.0 spec table; yocto_gltf accessor_view)
_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
                "MAT2": 4, "MAT3": 9, "MAT4": 16}

# primitive modes (glTF spec / ygltf::glTFMeshPrimitiveMode)
MODE_POINTS = 0
MODE_LINES = 1
MODE_LINE_LOOP = 2
MODE_LINE_STRIP = 3
MODE_TRIANGLES = 4
MODE_TRIANGLE_STRIP = 5
MODE_TRIANGLE_FAN = 6

_SPECGLOSS = "KHR_materials_pbrSpecularGlossiness"


class GltfError(ValueError):
    """Malformed or unsupported glTF content."""


# --------------------------------------------------------------------------
# low-level parse: buffers and accessors
# --------------------------------------------------------------------------


def _read_glb(data: bytes):
    """GLB container -> (json dict, BIN chunk bytes or None)."""
    magic, version, _length = struct.unpack_from("<III", data, 0)
    if magic != 0x46546C67:  # 'glTF'
        raise GltfError("not a GLB file (bad magic)")
    if version != 2:
        raise GltfError(f"unsupported GLB version {version}")
    off = 12
    gltf_json = None
    bin_chunk = None
    while off + 8 <= len(data):
        clen, ctype = struct.unpack_from("<II", data, off)
        chunk = data[off + 8:off + 8 + clen]
        if ctype == 0x4E4F534A:  # 'JSON'
            gltf_json = json.loads(chunk.decode("utf-8"))
        elif ctype == 0x004E4942:  # 'BIN'
            bin_chunk = chunk
        off += 8 + clen + (-clen % 4)
    if gltf_json is None:
        raise GltfError("GLB file has no JSON chunk")
    return gltf_json, bin_chunk


def _decode_uri(uri: str, dirname: str) -> bytes:
    if uri.startswith("data:"):
        header, _, payload = uri.partition(",")
        if ";base64" not in header:
            raise GltfError("only base64 data: URIs are supported")
        return base64.b64decode(payload)
    path = os.path.join(dirname, uri)
    with open(path, "rb") as f:
        return f.read()


def _load_buffers(g: dict, dirname: str, bin_chunk: bytes | None) -> list:
    out = []
    for i, buf in enumerate(g.get("buffers", [])):
        if "uri" in buf:
            out.append(_decode_uri(buf["uri"], dirname))
        elif bin_chunk is not None and i == 0:
            out.append(bin_chunk)
        else:
            raise GltfError(f"buffer {i} has no uri and no GLB BIN chunk")
    return out


def _accessor(g: dict, buffers: list, idx: int) -> np.ndarray:
    """Accessor -> (count, ncomp) array; ints normalized if flagged.

    Mirrors ygltf::accessor_view (yocto_gltf.h:1602-1708): dense reads with
    byteStride, float conversion of normalized ints.
    """
    acc = g["accessors"][idx]
    dtype = _COMPONENT_DTYPES.get(acc["componentType"])
    if dtype is None:
        raise GltfError(f"unknown componentType {acc['componentType']}")
    ncomp = _TYPE_COUNTS[acc["type"]]
    count = acc["count"]
    itemsize = np.dtype(dtype).itemsize * ncomp

    if "bufferView" not in acc:  # spec: all zeros (sparse base)
        arr = np.zeros((count, ncomp), dtype=dtype)
    else:
        bv = g["bufferViews"][acc["bufferView"]]
        data = buffers[bv["buffer"]]
        start = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
        stride = bv.get("byteStride", 0) or itemsize
        if stride == itemsize:
            arr = np.frombuffer(
                data, dtype=dtype, count=count * ncomp, offset=start
            ).reshape(count, ncomp)
        else:  # interleaved
            raw = np.frombuffer(
                data, dtype=np.uint8,
                count=stride * (count - 1) + itemsize, offset=start)
            rows = np.lib.stride_tricks.as_strided(
                raw, shape=(count, itemsize), strides=(stride, 1))
            arr = rows.copy().view(dtype).reshape(count, ncomp)

    if acc.get("sparse"):
        sp = acc["sparse"]
        n = sp["count"]
        ibv = g["bufferViews"][sp["indices"]["bufferView"]]
        idt = _COMPONENT_DTYPES[sp["indices"]["componentType"]]
        ioff = ibv.get("byteOffset", 0) + sp["indices"].get("byteOffset", 0)
        sidx = np.frombuffer(buffers[ibv["buffer"]], dtype=idt, count=n,
                             offset=ioff).astype(np.int64)
        vbv = g["bufferViews"][sp["values"]["bufferView"]]
        voff = vbv.get("byteOffset", 0) + sp["values"].get("byteOffset", 0)
        vals = np.frombuffer(buffers[vbv["buffer"]], dtype=dtype,
                             count=n * ncomp, offset=voff).reshape(n, ncomp)
        arr = arr.copy()
        arr[sidx] = vals

    if acc.get("normalized") and np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        arr = arr.astype(np.float32) / float(info.max)
        if info.min < 0:
            arr = np.maximum(arr, -1.0)
    return arr


def _accessor_f32(g, buffers, idx, want_comp, fill=0.0):
    arr = _accessor(g, buffers, idx).astype(np.float32)
    if arr.shape[1] < want_comp:
        pad = np.full((arr.shape[0], want_comp - arr.shape[1]), fill,
                      np.float32)
        arr = np.concatenate([arr, pad], axis=1)
    return arr[:, :want_comp]


# --------------------------------------------------------------------------
# index expansion (parity: yocto_scn.cpp:925-1030)
# --------------------------------------------------------------------------


def _expand_indices(mode: int, idx: np.ndarray | None, nverts: int):
    """-> (points (P,), lines (L,2), triangles (T,3)) int32 arrays."""
    if idx is None:
        idx = np.arange(nverts, dtype=np.int64)
    idx = idx.astype(np.int64).reshape(-1)
    n = len(idx)
    pts = np.zeros(0, np.int32)
    lins = np.zeros((0, 2), np.int32)
    tris = np.zeros((0, 3), np.int32)
    if mode == MODE_TRIANGLES:
        tris = idx[: (n // 3) * 3].reshape(-1, 3).astype(np.int32)
    elif mode == MODE_TRIANGLE_FAN:
        if n >= 3:
            tris = np.stack([np.full(n - 2, idx[0]), idx[1:-1], idx[2:]],
                            axis=1).astype(np.int32)
    elif mode == MODE_TRIANGLE_STRIP:
        if n >= 3:
            tris = np.stack([idx[:-2], idx[1:-1], idx[2:]],
                            axis=1).astype(np.int32)
    elif mode == MODE_LINES:
        lins = idx[: (n // 2) * 2].reshape(-1, 2).astype(np.int32)
    elif mode == MODE_LINE_STRIP:
        if n >= 2:
            lins = np.stack([idx[:-1], idx[1:]], axis=1).astype(np.int32)
    elif mode == MODE_LINE_LOOP:
        # the reference builds the strip then REWRITES the last segment to
        # wrap (yocto_scn.cpp:955-961: lines.back() = {last, first})
        if n >= 2:
            lins = np.stack([idx[:-1], idx[1:]], axis=1).astype(np.int32)
            lins[-1] = (idx[-1], idx[0])
    else:  # Points / NotSet
        pts = idx.astype(np.int32)
    return pts, lins, tris


# --------------------------------------------------------------------------
# node transforms (parity: yocto_gltf.cpp:2586-2590)
# --------------------------------------------------------------------------


def _quat_to_mat3(q) -> np.ndarray:
    x, y, z, w = [float(v) for v in q]
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y + z * w), 2 * (z * x - y * w)],
        [2 * (x * y - z * w), 1 - 2 * (x * x + z * z), 2 * (y * z + x * w)],
        [2 * (z * x + y * w), 2 * (y * z - x * w), 1 - 2 * (x * x + y * y)],
    ], np.float32).T  # column-vector convention


def _node_transform(node: dict) -> np.ndarray:
    """T * R * S * matrix as a column-vector 4x4 (yocto_gltf.cpp:2586)."""
    m = np.eye(4, dtype=np.float32)
    if "matrix" in node:
        m = np.asarray(node["matrix"], np.float32).reshape(4, 4, order="F")
    s = np.diag(list(node.get("scale", (1, 1, 1))) + [1.0]).astype(np.float32)
    r = np.eye(4, dtype=np.float32)
    r[:3, :3] = _quat_to_mat3(node.get("rotation", (0, 0, 0, 1)))
    t = np.eye(4, dtype=np.float32)
    t[:3, 3] = node.get("translation", (0, 0, 0))
    return t @ r @ s @ m


def _to_frame(m: np.ndarray):
    """Column-vector 4x4 -> (axes rows-are-basis (3,3), origin (3,)).

    Our frame applies as ``p @ axes + o`` (scene.py header), i.e.
    ``axes = M[:3,:3].T``.
    """
    return np.ascontiguousarray(m[:3, :3].T, np.float32), \
        np.ascontiguousarray(m[:3, 3], np.float32)


# --------------------------------------------------------------------------
# images
# --------------------------------------------------------------------------


def _decode_image_bytes(data: bytes):
    """-> (ldr u8 RGBA or None, hdr f32 RGBA or None)."""
    from PIL import Image

    with Image.open(_io.BytesIO(data)) as im:
        if im.mode in ("F", "I"):
            arr = np.asarray(im, np.float32)
            hdr = np.stack([arr] * 3 + [np.ones_like(arr)], -1)
            return None, hdr
        rgba = np.asarray(im.convert("RGBA"), np.uint8)
        return rgba, None


def _load_image(g, buffers, dirname, img: dict):
    if "uri" in img:
        uri = img["uri"]
        if uri.startswith("data:"):
            return _decode_image_bytes(_decode_uri(uri, dirname))
        path = os.path.join(dirname, uri)
        # decode by extension like the app layer (src/scene.cpp:150-160)
        if uri.endswith(".hdr"):
            return None, image_mod.load_image4f(path)
        return image_mod.load_image4b(path), None
    if "bufferView" in img:
        bv = g["bufferViews"][img["bufferView"]]
        start = bv.get("byteOffset", 0)
        data = buffers[bv["buffer"]][start:start + bv["byteLength"]]
        return _decode_image_bytes(data)
    return None, None


# --------------------------------------------------------------------------
# import
# --------------------------------------------------------------------------


def load_gltf(filename: str, return_graph: bool = False):
    """Load a .gltf/.glb file into a ``HostScene``.

    Equivalent of load_gltf_scene + gltf_to_scene + the app-layer
    conversion (yocto_scn.cpp:1085-1099, 697-1082; src/scene.cpp:113-225).

    ``return_graph=True`` additionally returns a :class:`GltfGraph` — the
    retained node hierarchy plus animation channels, skins and morph
    targets (the reference's ygltf scene_group animation layer,
    src/ext/yocto_gltf.h:528-636) — for keyframe playback via
    :func:`update_animated_transforms` / :func:`apply_graph_transforms`.
    """
    dirname = os.path.dirname(filename)
    try:
        with open(filename, "rb") as f:
            raw = f.read()
    except OSError as e:
        raise scene_mod.SceneLoadError(f"cannot open scene: {e}") from e

    if filename.endswith(".glb") or raw[:4] == b"glTF":
        g, bin_chunk = _read_glb(raw)
    else:
        try:
            g = json.loads(raw.decode("utf-8"))
        except ValueError as e:
            raise GltfError(f"malformed glTF JSON: {e}") from e
        bin_chunk = None
    buffers = _load_buffers(g, dirname, bin_chunk)

    # textures: glTF texture -> image source (samplers: lookup is always
    # bilinear repeat in the renderer, matching raytrace.cpp:66-67)
    textures = []
    for i, img in enumerate(g.get("images", [])):
        ldr, hdr = _load_image(g, buffers, dirname, img)
        name = img.get("uri", img.get("name", f"image{i}"))
        textures.append(scene_mod.HostTexture(name=name, ldr=ldr, hdr=hdr))

    def tex_id(tinfo) -> int:
        # texture info -> image index (add_texture, yocto_scn.cpp:819-834)
        if not tinfo:
            return -1
        tex = g.get("textures", [])
        t = tinfo.get("index", -1)
        if t < 0 or t >= len(tex):
            return -1
        return tex[t].get("source", -1)

    # materials (yocto_scn.cpp:843-880 + the app/scene_to_obj MR mapping)
    materials = []
    for gmat in g.get("materials", []):
        mat = scene_mod.HostMaterial(name=gmat.get("name", ""))
        mat.ke = np.asarray(gmat.get("emissiveFactor", (0, 0, 0)),
                            np.float32)
        mat.ke_txt = tex_id(gmat.get("emissiveTexture"))
        mat.norm_txt = tex_id(gmat.get("normalTexture"))
        mr = gmat.get("pbrMetallicRoughness")
        if mr is not None:
            base = np.asarray(mr.get("baseColorFactor", (1, 1, 1, 1)),
                              np.float32)
            km = float(mr.get("metallicFactor", 1.0))
            rs = float(mr.get("roughnessFactor", 1.0))
            # metallic-roughness -> specular-roughness, the mapping the
            # reference itself uses (yocto_scn.cpp:545-556)
            if rs == 1.0 and km == 0.0:
                mat.kd = base[:3].copy()
                mat.ks = np.zeros(3, np.float32)
                mat.rs = 1.0
            else:
                mat.kd = base[:3] * (1 - 0.04) * (1 - km)
                mat.ks = base[:3] * km + 0.04 * (1 - km)
                mat.rs = rs
            bc_txt = tex_id(mr.get("baseColorTexture"))
            if km < 0.5:
                mat.kd_txt = bc_txt
            else:
                mat.ks_txt = bc_txt
        sg = gmat.get("extensions", {}).get(_SPECGLOSS)
        if sg is not None:  # exact kd/ks/rs (yocto_scn.cpp:865-875)
            diff = np.asarray(sg.get("diffuseFactor", (1, 1, 1, 1)),
                              np.float32)
            mat.kd = diff[:3].copy()
            mat.ks = np.asarray(sg.get("specularFactor", (1, 1, 1)),
                                np.float32)
            mat.rs = float(sg.get("glossinessFactor", 1.0))
            mat.kd_txt = tex_id(sg.get("diffuseTexture"))
            mat.ks_txt = tex_id(sg.get("specularGlossinessTexture"))
        ext = gmat.get("extras", {})
        if "kr" in ext:  # our exporter's mirror-term sidecar
            mat.kr = np.asarray(ext["kr"], np.float32)
        materials.append(mat)

    # meshes -> shapes; remember (mesh id -> [(shape id, material id)])
    shapes = []
    mesh_shapes = []
    shape_morphs = {}      # shape id -> [morph target dicts] (gltf.h:609-619)
    shape_skin_attrs = {}  # shape id -> (joints (V,4) i32, weights (V,4) f32)
    for gmesh in g.get("meshes", []):
        ids = []
        for gprim in gmesh.get("primitives", []):
            attrs = gprim.get("attributes", {})
            if "POSITION" not in attrs:
                continue
            pos = _accessor_f32(g, buffers, attrs["POSITION"], 3)
            nv = len(pos)
            norm = (_accessor_f32(g, buffers, attrs["NORMAL"], 3)
                    if "NORMAL" in attrs else np.zeros((0, 3), np.float32))
            tc_key = ("TEXCOORD_0" if "TEXCOORD_0" in attrs
                      else "TEXCOORD" if "TEXCOORD" in attrs else None)
            texcoord = (_accessor_f32(g, buffers, attrs[tc_key], 2)
                        if tc_key else np.zeros((nv, 2), np.float32))
            radius = (_accessor_f32(g, buffers, attrs["RADIUS"], 1)[:, 0]
                      if "RADIUS" in attrs else np.zeros(0, np.float32))
            idx = (_accessor(g, buffers, gprim["indices"]).reshape(-1)
                   if "indices" in gprim else None)
            pts, lins, tris = _expand_indices(
                gprim.get("mode", MODE_TRIANGLES), idx, nv)
            shp = scene_mod.HostShape(
                name=gmesh.get("name", f"mesh{len(mesh_shapes)}"),
                pos=pos, norm=norm, texcoord=texcoord, radius=radius,
                points=pts, lines=lins, triangles=tris)
            sid = len(shapes)
            ids.append((sid, gprim.get("material", -1)))
            shapes.append(shp)
            if return_graph:
                # morph targets (glTF targets -> ygltf shape_morph,
                # yocto_gltf.h:609-619, conversion yocto_gltf.cpp:2995-3005)
                targets = []
                base_weights = gmesh.get("weights", [])
                for ti, tgt in enumerate(gprim.get("targets", [])):
                    targets.append(dict(
                        pos=(_accessor_f32(g, buffers, tgt["POSITION"], 3)
                             if "POSITION" in tgt else None),
                        norm=(_accessor_f32(g, buffers, tgt["NORMAL"], 3)
                              if "NORMAL" in tgt else None),
                        tangsp=(_accessor_f32(g, buffers, tgt["TANGENT"], 3)
                                if "TANGENT" in tgt else None),
                        weight=(float(base_weights[ti])
                                if ti < len(base_weights) else 0.0)))
                if targets:
                    shape_morphs[sid] = targets
                # skinning vertex attributes (JOINTS_0 / WEIGHTS_0)
                if "JOINTS_0" in attrs and "WEIGHTS_0" in attrs:
                    joints = _accessor(g, buffers,
                                       attrs["JOINTS_0"]).astype(np.int32)
                    weights = _accessor_f32(g, buffers, attrs["WEIGHTS_0"], 4)
                    shape_skin_attrs[sid] = (joints.reshape(nv, -1)[:, :4],
                                             weights)
        mesh_shapes.append(ids)

    # cameras (yocto_scn.cpp:1036-1058); glTF has no aperture/focus ->
    # reference yscn camera defaults aperture=0 focus=1, unless our
    # exporter's extras carry the exact values
    proto_cameras = []
    for gcam in g.get("cameras", []):
        extras = gcam.get("extras", {})
        focus = float(extras.get("focus", 1.0))
        aperture = float(extras.get("aperture", 0.0))
        if gcam.get("type") == "orthographic":
            o = gcam.get("orthographic", {})
            ymag = float(o.get("ymag", 1.0))
            proto_cameras.append(dict(
                name=gcam.get("name", ""), yfov=ymag,
                aspect=float(o.get("xmag", ymag)) / ymag,
                focus=focus, aperture=aperture))
        else:
            p = gcam.get("perspective", {})
            proto_cameras.append(dict(
                name=gcam.get("name", ""),
                yfov=float(p.get("yfov", 2 * np.arctan(0.5))),
                aspect=float(p.get("aspectRatio") or (16.0 / 9.0)),
                focus=focus, aperture=aperture))

    # flatten node hierarchy (gltf_node_to_instances, yocto_scn.cpp:697-718)
    nodes = g.get("nodes", [])
    cameras = []
    instances = []
    instance_nodes = []   # node id per created instance (graph playback)
    camera_nodes = []

    def visit(nid: int, parent: np.ndarray):
        node = nodes[nid]
        xform = parent @ _node_transform(node)
        axes, o = _to_frame(xform)
        if "camera" in node and 0 <= node["camera"] < len(proto_cameras):
            pc = proto_cameras[node["camera"]]
            camera_nodes.append(nid)
            cameras.append(scene_mod.HostCamera(
                name=pc["name"], axes=axes, o=o, yfov=pc["yfov"],
                aspect=pc["aspect"], aperture=pc["aperture"],
                focus=pc["focus"]))
        if "mesh" in node and 0 <= node["mesh"] < len(mesh_shapes):
            for sid, mid in mesh_shapes[node["mesh"]]:
                instance_nodes.append(nid)
                instances.append(scene_mod.HostInstance(
                    name=node.get("name", f"node{nid}"),
                    axes=axes, o=o, shape=sid, material=mid))
        for cid in node.get("children", []):
            visit(cid, xform)

    ident = np.eye(4, dtype=np.float32)
    roots = []
    if "scene" in g and g.get("scenes"):
        roots = list(g["scenes"][g["scene"]].get("nodes", []))
    elif nodes:
        is_root = [True] * len(nodes)
        for node in nodes:
            for cid in node.get("children", []):
                is_root[cid] = False
        roots = [nid for nid, root in enumerate(is_root) if root]
    for nid in roots:
        visit(nid, ident)

    host = scene_mod.HostScene(
        cameras=cameras, shapes=shapes, textures=textures,
        materials=materials, instances=instances, environments=[],
        dirname=dirname)
    scene_mod.finalize_scene(host)
    if not return_graph:
        return host

    graph = GltfGraph(
        nodes=[dict(n) for n in nodes], roots=roots,
        instance_nodes=instance_nodes, camera_nodes=camera_nodes,
        channels=_load_animation_channels(g, buffers),
        skins=_load_skins(g, buffers),
        shape_morphs=shape_morphs, shape_skin_attrs=shape_skin_attrs)
    return host, graph


# --------------------------------------------------------------------------
# animation / skinning / morphing (ygltf scene_group animation layer,
# src/ext/yocto_gltf.h:528-636; eval yocto_gltf.cpp:3988-4160)
# --------------------------------------------------------------------------


class GltfGraph:
    """Retained glTF node graph for keyframe playback.

    * ``nodes``: raw glTF node dicts (translation/rotation/scale/matrix/
      children/mesh/camera/skin/weights), mutated by animation playback;
    * ``instance_nodes``/``camera_nodes``: node id per HostScene
      instance/camera (same order), so new world transforms flow back;
    * ``channels``: animation channels (see _load_animation_channels);
    * ``skins``: skin dicts {joints, inverse_bind, skeleton};
    * ``shape_morphs``: shape id -> morph target list;
    * ``shape_skin_attrs``: shape id -> (joints (V, 4), weights (V, 4)).
    """

    def __init__(self, nodes, roots, instance_nodes, camera_nodes, channels,
                 skins, shape_morphs, shape_skin_attrs):
        self.nodes = nodes
        self.roots = roots
        self.instance_nodes = instance_nodes
        self.camera_nodes = camera_nodes
        self.channels = channels
        self.skins = skins
        self.shape_morphs = shape_morphs
        self.shape_skin_attrs = shape_skin_attrs


def _load_animation_channels(g: dict, buffers: list) -> list:
    """glTF animations -> channel records.

    Mirrors the reference's conversion (yocto_gltf.cpp:3067-3143): one
    record per (sampler, path) with the list of target nodes; times from
    the sampler input accessor, values from the output accessor.
    ``interp`` keeps the glTF string ("LINEAR"/"STEP"/"CUBICSPLINE");
    CUBICSPLINE values stay in glTF's (in-tangent, value, out-tangent)
    triplet layout, reshaped to (K, 3, C).
    """
    channels = []
    for ai, ganim in enumerate(g.get("animations", [])):
        samplers = ganim.get("samplers", [])
        seen = {}
        for ch in ganim.get("channels", []):
            tgt = ch.get("target", {})
            path = tgt.get("path")
            node = tgt.get("node")
            si = ch.get("sampler")
            if path is None or node is None or si is None:
                continue
            key = (si, path)
            if key in seen:
                seen[key]["nodes"].append(node)
                continue
            smp = samplers[si]
            times = _accessor_f32(g, buffers, smp["input"], 1)[:, 0]
            interp = smp.get("interpolation", "LINEAR")
            ncomp = {"translation": 3, "scale": 3, "rotation": 4}.get(path)
            vals = _accessor(g, buffers, smp["output"]).astype(np.float32)
            if ncomp is None:  # weights: infer per-key count
                per_key = vals.size // max(1, len(times))
                if interp == "CUBICSPLINE":
                    per_key //= 3
                    vals = vals.reshape(len(times), 3, per_key)
                else:
                    vals = vals.reshape(len(times), per_key)
            else:
                if interp == "CUBICSPLINE":
                    vals = vals.reshape(len(times), 3, ncomp)
                else:
                    vals = vals.reshape(len(times), ncomp)
            rec = dict(name=ganim.get("name", f"anim{ai}"), path=path,
                       interp=interp, nodes=[node], times=times,
                       values=vals)
            seen[key] = rec
            channels.append(rec)
    return channels


def _load_skins(g: dict, buffers: list) -> list:
    """glTF skins -> {joints, inverse_bind (J, 4, 4) column-vector,
    skeleton} (ygltf skin, yocto_gltf.h:596-607)."""
    skins = []
    for gskin in g.get("skins", []):
        joints = list(gskin.get("joints", []))
        ib = None
        if "inverseBindMatrices" in gskin:
            flat = _accessor_f32(g, buffers, gskin["inverseBindMatrices"], 16)
            # glTF matrices are column-major; keep column-vector convention
            ib = np.ascontiguousarray(
                flat.reshape(-1, 4, 4).transpose(0, 2, 1), np.float32)
        skins.append(dict(name=gskin.get("name", ""), joints=joints,
                          inverse_bind=ib,
                          skeleton=gskin.get("skeleton")))
    return skins


def sample_channel(ch: dict, time: float):
    """Evaluate one animation channel at ``time``.

    Reference eval semantics (update_animated_node_transforms,
    yocto_gltf.cpp:3990-4078): clamp to step before the first / after the
    last keyframe; LINEAR lerps (slerp for rotations); STEP holds the left
    key. CUBICSPLINE is evaluated per the glTF spec's cubic hermite — the
    reference declares the enum and then leaves both spline cases as empty
    switch arms (its own "TODO: spline animation", yocto_gltf.cpp:63), so
    the spec behavior here is a strict superset.
    """
    times = ch["times"]
    vals = ch["values"]
    cubic = ch["interp"] == "CUBICSPLINE"

    def value(i):
        return vals[i, 1] if cubic else vals[i]

    if len(times) == 1 or time <= times[0]:
        return np.asarray(value(0), np.float32)
    if time >= times[-1]:
        return np.asarray(value(len(times) - 1), np.float32)
    i2 = int(np.searchsorted(times, time, side="right"))
    i2 = min(max(i2, 1), len(times) - 1)
    i1 = i2 - 1
    dt = float(times[i2] - times[i1])
    t = (time - float(times[i1])) / dt if dt > 0 else 0.0
    if ch["interp"] == "STEP":
        return np.asarray(value(i1), np.float32)
    if cubic:
        # glTF spec: p(t) = (2t³-3t²+1)p0 + dt(t³-2t²+t)m0
        #                 + (-2t³+3t²)p1 + dt(t³-t²)m1
        p0, p1 = vals[i1, 1], vals[i2, 1]
        m0, m1 = vals[i1, 2], vals[i2, 0]
        t2, t3 = t * t, t * t * t
        out = ((2 * t3 - 3 * t2 + 1) * p0 + dt * (t3 - 2 * t2 + t) * m0
               + (-2 * t3 + 3 * t2) * p1 + dt * (t3 - t2) * m1)
        if ch["path"] == "rotation":
            out = out / max(float(np.linalg.norm(out)), 1e-12)
        return np.asarray(out, np.float32)
    a, b = np.asarray(value(i1), np.float32), np.asarray(value(i2),
                                                         np.float32)
    if ch["path"] == "rotation":
        return _slerp(a, b, t)
    return a * (1.0 - t) + b * t


def _slerp(qa: np.ndarray, qb: np.ndarray, t: float) -> np.ndarray:
    """Quaternion slerp (ym::slerp equivalent), shortest arc."""
    d = float(np.dot(qa, qb))
    if d < 0:
        qb = -qb
        d = -d
    if d > 0.9995:  # nearly parallel: nlerp
        out = qa * (1.0 - t) + qb * t
        return (out / np.linalg.norm(out)).astype(np.float32)
    th = np.arccos(np.clip(d, -1.0, 1.0))
    sa = np.sin((1.0 - t) * th) / np.sin(th)
    sb = np.sin(t * th) / np.sin(th)
    return (qa * sa + qb * sb).astype(np.float32)


def update_animated_transforms(graph: GltfGraph, time: float) -> None:
    """Write every channel's value at ``time`` into its target nodes
    (update_animated_transforms, yocto_gltf.cpp:4081-4092). Mutates
    ``graph.nodes`` TRS / weights fields; call
    :func:`apply_graph_transforms` to propagate to a HostScene."""
    for ch in graph.channels:
        v = sample_channel(ch, time)
        for nid in ch["nodes"]:
            node = graph.nodes[nid]
            if ch["path"] == "weights":
                node["weights"] = [float(x) for x in np.atleast_1d(v)]
            else:
                node[ch["path"]] = [float(x) for x in v]


def node_world_transforms(graph: GltfGraph) -> dict:
    """node id -> world 4x4 (column-vector), recomputed from current TRS
    (update_transforms, yocto_gltf.cpp:3969-3992)."""
    out = {}

    def visit(nid, parent):
        xform = parent @ _node_transform(graph.nodes[nid])
        out[nid] = xform
        for cid in graph.nodes[nid].get("children", []):
            visit(cid, xform)

    ident = np.eye(4, dtype=np.float32)
    for nid in graph.roots:
        visit(nid, ident)
    return out


def apply_graph_transforms(graph: GltfGraph, host) -> None:
    """Propagate current node transforms into the HostScene's instance and
    camera frames (the flatten step of gltf_node_to_instances re-run after
    animation). The caller rebuilds the device scene
    (``scene.build_device_scene``) afterwards."""
    world = node_world_transforms(graph)
    for k, nid in enumerate(graph.instance_nodes):
        if nid in world:
            axes, o = _to_frame(world[nid])
            host.instances[k].axes = axes
            host.instances[k].o = o
    for k, nid in enumerate(graph.camera_nodes):
        if nid in world:
            axes, o = _to_frame(world[nid])
            host.cameras[k].axes = axes
            host.cameras[k].o = o


def animation_bounds(graph: GltfGraph):
    """(t_min, t_max) over all channels (get_animation_bounds,
    yocto_gltf.cpp:4148-4158)."""
    lo, hi = 0.0, 0.0
    for ch in graph.channels:
        lo = min(lo, float(ch["times"][0]))
        hi = max(hi, float(ch["times"][-1]))
    return lo, hi


def get_skin_transforms(graph: GltfGraph, skin_id: int,
                        xform: np.ndarray) -> np.ndarray:
    """Per-joint local-to-object matrices (J, 4, 4): ``inv(xform) @
    joint_world @ inverse_bind`` (get_skin_transforms,
    yocto_gltf.cpp:4101-4117)."""
    sk = graph.skins[skin_id]
    world = node_world_transforms(graph)
    inv_root = np.linalg.inv(xform).astype(np.float32)
    out = []
    for j, nid in enumerate(sk["joints"]):
        jw = world.get(nid, np.eye(4, dtype=np.float32))
        m = inv_root @ jw
        if sk["inverse_bind"] is not None:
            m = m @ sk["inverse_bind"][j]
        out.append(m)
    return np.stack(out).astype(np.float32)


def skin_vertices(pos, joints, weights, xforms,
                  device="cuda") -> torch.Tensor:
    """Linear-blend skinning: (V, 3) positions deformed by 4 (joint,
    weight) slots per vertex against (J, 4, 4) column-vector joint matrices,
    as a (V, 3) f32 tensor on ``device`` (the card unless the caller asks
    for "cpu"; "cuda" raises when no card is present).

    The JAX package computes this with an ``einsum``; here every output
    coordinate is ``m[.., i, 0] * x + m[.., i, 1] * y + m[.., i, 2] * z +
    m[.., i, 3]`` in that order, and the 4 slots are summed in slot order,
    as separate multiplies and adds (no matmul, einsum or fused
    multiply-add), so the card and the CPU give the same bits.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    p = f32(pos)
    w = f32(weights)
    idx = torch.as_tensor(joints, device=device).long()
    m = f32(xforms)[idx]                                  # (V, 4, 4, 4)
    x, y, z = p[:, None, 0], p[:, None, 1], p[:, None, 2]
    out = torch.stack([m[:, :, i, 0] * x + m[:, :, i, 1] * y
                       + m[:, :, i, 2] * z + m[:, :, i, 3]
                       for i in range(3)], dim=-1)        # (V, 4, 3)
    out = out * w[:, :, None]
    return out[:, 0] + out[:, 1] + out[:, 2] + out[:, 3]


def morph_vertices(shape, targets: list, weights) -> tuple:
    """Morph-target deformation (compute_morphing_deformation,
    yocto_gltf.cpp:4119-4160): pos/norm/tangsp += weight * delta per
    target; a target with no animated weight uses its rest weight."""
    pos = np.array(shape.pos, np.float32)
    norm = np.array(shape.norm, np.float32)
    tangsp = np.array(shape.tangsp, np.float32)
    for idx, tgt in enumerate(targets):
        wgt = (float(weights[idx]) if idx < len(weights)
               else float(tgt.get("weight", 0.0)))
        if wgt == 0:
            continue
        if tgt.get("pos") is not None and len(pos):
            pos += wgt * tgt["pos"]
        if tgt.get("norm") is not None and len(norm):
            norm += wgt * tgt["norm"]
        if tgt.get("tangsp") is not None and len(tangsp):
            tangsp[:, :3] += wgt * tgt["tangsp"]
    return pos, norm, tangsp


# --------------------------------------------------------------------------
# export
# --------------------------------------------------------------------------


def save_gltf(host, filename: str) -> None:
    """Write ``HostScene`` as .gltf + sidecar .bin, or as a binary .glb
    container when the filename ends in ``.glb`` (+ texture files either
    way).

    save_scene-for-glTF equivalent (yocto_scn.h:447-455 dispatch,
    scene_to_gltf yocto_scn.cpp:1140-1300; GLB container =
    save_binary_gltf, yocto_gltf.h:651). Materials are written as both
    pbrMetallicRoughness (approximate inverse of the import mapping) and
    the exact spec-gloss extension so kd/ks/rs round-trip losslessly; kr
    goes to ``extras`` (no glTF equivalent).
    """
    dirname = os.path.dirname(filename) or "."
    stem = os.path.splitext(os.path.basename(filename))[0]
    os.makedirs(dirname, exist_ok=True)

    blob = bytearray()
    buffer_views = []
    accessors = []

    def add_accessor(arr: np.ndarray, ctype: int, type_: str,
                     with_minmax=False) -> int:
        data = np.ascontiguousarray(arr).tobytes()
        pad = -len(blob) % 4
        blob.extend(b"\0" * pad)
        buffer_views.append({
            "buffer": 0, "byteOffset": len(blob), "byteLength": len(data)})
        blob.extend(data)
        acc = {"bufferView": len(buffer_views) - 1, "componentType": ctype,
               "count": int(arr.shape[0]), "type": type_}
        if with_minmax:
            acc["min"] = [float(v) for v in arr.min(axis=0)]
            acc["max"] = [float(v) for v in arr.max(axis=0)]
        accessors.append(acc)
        return len(accessors) - 1

    # textures -> image files next to the .gltf
    images = []
    for i, tex in enumerate(host.textures):
        name = tex.name or f"texture{i}.png"
        if tex.hdr is not None and not name.endswith(".hdr"):
            name = os.path.splitext(name)[0] + ".hdr"
        out_path = os.path.join(dirname, name)
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        if tex.hdr is not None:
            image_mod.save_image_hdr(out_path, tex.hdr)
        else:
            image_mod.save_image_png(out_path, tex.ldr)
        images.append({"uri": name})
    gtextures = [{"source": i} for i in range(len(images))]

    def tex_info(tid: int):
        return {"index": int(tid)} if tid >= 0 else None

    materials = []
    for m in host.materials:
        kd = np.asarray(m.kd, np.float32)
        ks = np.asarray(m.ks, np.float32)
        # approximate inverse of the import mapping: metallic from the
        # specular level, base color recovering kd+ks energy
        km = float(np.clip((ks.max() - 0.04) / 0.96, 0.0, 1.0))
        base = kd / max(1e-6, (1 - 0.04) * (1 - km)) if km < 1 else ks
        mr = {
            "baseColorFactor": [float(v) for v in np.clip(base, 0, 1)] + [1.0],
            "metallicFactor": km,
            "roughnessFactor": float(np.clip(m.rs, 0, 1)),
        }
        sg = {
            "diffuseFactor": [float(v) for v in kd] + [1.0],
            "specularFactor": [float(v) for v in ks],
            "glossinessFactor": float(m.rs),
        }
        if m.kd_txt >= 0:
            sg["diffuseTexture"] = tex_info(m.kd_txt)
            if km < 0.5:
                mr["baseColorTexture"] = tex_info(m.kd_txt)
        if m.ks_txt >= 0:
            sg["specularGlossinessTexture"] = tex_info(m.ks_txt)
            if km >= 0.5:
                mr["baseColorTexture"] = tex_info(m.ks_txt)
        gmat = {
            "name": m.name,
            "emissiveFactor": [float(v) for v in m.ke],
            "pbrMetallicRoughness": mr,
            "extensions": {_SPECGLOSS: sg},
        }
        if m.ke_txt >= 0:
            gmat["emissiveTexture"] = tex_info(m.ke_txt)
        if m.norm_txt >= 0:
            gmat["normalTexture"] = tex_info(m.norm_txt)
        if float(np.max(m.kr)) > 0:
            gmat["extras"] = {"kr": [float(v) for v in m.kr]}
        materials.append(gmat)

    # one glTF mesh per (shape, material) pair actually instanced
    pair_mesh: dict = {}
    meshes = []
    for ist in host.instances:
        key = (ist.shape, ist.material)
        if key in pair_mesh:
            continue
        shp = host.shapes[ist.shape]
        attrs = {"POSITION": add_accessor(
            shp.pos.astype(np.float32), 5126, "VEC3", with_minmax=True)}
        if len(shp.norm):
            attrs["NORMAL"] = add_accessor(
                shp.norm.astype(np.float32), 5126, "VEC3")
        if len(shp.texcoord) and np.any(shp.texcoord):
            attrs["TEXCOORD_0"] = add_accessor(
                shp.texcoord.astype(np.float32), 5126, "VEC2")
        if len(shp.radius) and np.any(shp.radius):
            attrs["RADIUS"] = add_accessor(
                shp.radius.astype(np.float32).reshape(-1, 1), 5126, "SCALAR")
        prims = []
        for idx, mode in ((shp.triangles, MODE_TRIANGLES),
                          (shp.lines, MODE_LINES),
                          (shp.points, MODE_POINTS)):
            if not len(idx):
                continue
            prim = {
                "attributes": attrs,
                "mode": mode,
                "indices": add_accessor(
                    np.asarray(idx, np.uint32).reshape(-1, 1), 5125,
                    "SCALAR"),
            }
            if ist.material >= 0:
                prim["material"] = int(ist.material)
            prims.append(prim)
        pair_mesh[key] = len(meshes)
        meshes.append({"name": shp.name, "primitives": prims})

    def frame_to_matrix(axes: np.ndarray, o: np.ndarray) -> list:
        m = np.eye(4, dtype=np.float64)
        m[:3, :3] = np.asarray(axes, np.float64).T
        m[:3, 3] = np.asarray(o, np.float64)
        return [float(v) for v in m.flatten(order="F")]

    nodes = []
    for ist in host.instances:
        nodes.append({
            "name": ist.name,
            "matrix": frame_to_matrix(ist.axes, ist.o),
            "mesh": pair_mesh[(ist.shape, ist.material)],
        })
    gcameras = []
    for cam in host.cameras:
        gcameras.append({
            "name": cam.name,
            "type": "perspective",
            "perspective": {"yfov": float(cam.yfov),
                            "aspectRatio": float(cam.aspect),
                            "znear": 1e-4},
            # glTF has no lens model; keep the exact focus/aperture so the
            # camera round-trips bit-for-bit (focus scales the image plane,
            # raytrace.cpp:14-31, and perturbs f32 ray rounding)
            "extras": {"focus": float(cam.focus),
                       "aperture": float(cam.aperture)},
        })
        nodes.append({
            "name": cam.name,
            "matrix": frame_to_matrix(cam.axes, cam.o),
            "camera": len(gcameras) - 1,
        })

    binary = os.path.splitext(filename)[1].lower() == ".glb"
    g = {
        # the JAX package's generator name: both write the same bytes
        "asset": {"version": "2.0", "generator": "yocto_raytracing_tpu"},
        "extensionsUsed": [_SPECGLOSS],
        "bufferViews": buffer_views,
        "accessors": accessors,
        "meshes": meshes,
        "nodes": nodes,
        "scenes": [{"nodes": list(range(len(nodes)))}],
        "scene": 0,
    }
    if binary:
        # GLB embeds the buffer as the BIN chunk: buffer 0 has no uri
        # (save_binary_gltf, src/ext/yocto_gltf.h:651)
        g["buffers"] = [{"byteLength": len(blob)}]
    else:
        bin_name = stem + ".bin"
        with open(os.path.join(dirname, bin_name), "wb") as f:
            f.write(bytes(blob))
        g["buffers"] = [{"uri": bin_name, "byteLength": len(blob)}]
    if images:
        g["images"] = images
        g["textures"] = gtextures
    if materials:
        g["materials"] = materials
    if gcameras:
        g["cameras"] = gcameras
    if binary:
        with open(filename, "wb") as f:
            f.write(_write_glb(g, bytes(blob)))
    else:
        with open(filename, "wt") as f:
            json.dump(g, f, indent=1)


def _write_glb(g: dict, blob: bytes) -> bytes:
    """GLB 2.0 container bytes: 12-byte header + JSON chunk (space-padded
    to 4) + BIN chunk (zero-padded to 4) — the inverse of ``_read_glb``
    and the rebuild of the reference's ``save_binary_gltf``
    (src/ext/yocto_gltf.h:651, yocto_gltf.cpp). Texture images stay
    external file URIs next to the .glb (the importer resolves them
    relative to the file, like the reference's image loader)."""
    json_bytes = json.dumps(g, separators=(",", ":")).encode("utf-8")
    json_bytes += b" " * (-len(json_bytes) % 4)
    chunks = [struct.pack("<II", len(json_bytes), 0x4E4F534A), json_bytes]
    bin_bytes = blob + b"\0" * (-len(blob) % 4)
    if bin_bytes:
        chunks += [struct.pack("<II", len(bin_bytes), 0x004E4942),
                   bin_bytes]
    body = b"".join(chunks)
    return struct.pack("<III", 0x46546C67, 2, 12 + len(body)) + body
