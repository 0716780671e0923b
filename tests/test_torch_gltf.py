"""The port's glTF/GLB import and export equal the JAX package's.

Both packages run the same cases side by side, on the CPU:

* host scenes ``array_equal`` field by field (shapes with ``tangsp`` and
  ``tetrahedra``, materials, textures, instances, cameras), and the
  ``GltfGraph`` of ``return_graph=True`` (nodes, channels, skins, morph
  targets, skin attributes);
* files written by either package load in the other to the same host
  scene, and for the same host scene the port writes the same ``.gltf``,
  ``.bin``, ``.glb`` and texture bytes as JAX;
* the hair scene's ``.gltf``/``.glb`` round trips render on the CPU bit for
  bit as the in-memory scene (tests/test_io.py:132-165);
* primitive modes, node TRS, the GLB container, every component type
  (interleaved, normalized, sparse), the tangent space
  (tests/test_io.py:167-318) and a normal-mapped OBJ made with the port's
  ``procedural`` and ``geometry`` (the stand-in for the reference-scene
  case at tests/test_io.py:320);
* every case of tests/test_gltf_animation.py, and a skinned mesh;
* ``skin_vertices`` (torch, explicit multiply-adds) exact on the cases of
  tests/test_gltf_animation.py:166-182 and within 2 ULP of its terms'
  magnitude of JAX's ``einsum`` on 1,000 seeded vertices;
* the load and save errors raise what JAX's raise.
"""

import base64
import dataclasses
import inspect
import json
import os
import struct

import numpy as np
import pytest
import torch

from host_compare import assert_same
from yocto_raytracing_tpu import scene as jscene
from yocto_raytracing_tpu.io import gltf as jgltf
from yocto_raytracing_tpu_torch import geometry as tgeo
from yocto_raytracing_tpu_torch import procedural as tproc
from yocto_raytracing_tpu_torch import scene as tscene, testscenes as tts
from yocto_raytracing_tpu_torch.io import gltf as tgltf
from yocto_raytracing_tpu_torch.render import renderer as tren

HOST_LISTS = ("cameras", "shapes", "textures", "materials", "instances",
              "environments")


def _host_equal(a, b):
    for name in HOST_LISTS:
        assert_same(getattr(a, name), getattr(b, name), name)
    assert a.dirname == b.dirname


def _graph_equal(a, b):
    for name in ("nodes", "roots", "instance_nodes", "camera_nodes",
                 "channels", "skins", "shape_morphs", "shape_skin_attrs"):
        assert_same(getattr(a, name), getattr(b, name), name)


def _convert(host, mod):
    """A host scene of one package as the other package's classes (the
    same arrays)."""
    def conv(obj):
        return getattr(mod, type(obj).__name__)(**{
            f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)})
    return mod.HostScene(**{name: [conv(x) for x in getattr(host, name)]
                            for name in HOST_LISTS}, dirname=host.dirname)


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


def _render(host):
    cam = host.cameras[0]
    width = tren.image_width(cam.aspect, 64)
    leaves, meta = tscene.build_device_scene(host)
    return tren.render_image(tscene.to_torch(leaves, "cpu"), meta, width,
                             64, samples=1, ambient=0.1, max_depth=4)


# --------------------------------------------------------------------------
# round trips: bytes, cross-package loads, frames
# --------------------------------------------------------------------------


SCENES = {"hair": lambda: tts.make_hair_scene(16),
          "textured_hair": lambda: tts.make_textured_hair_scene(16)}


@pytest.fixture(scope="module")
def memory_frames():
    return {name: _render(make()) for name, make in SCENES.items()}


@pytest.mark.parametrize("ext", [".gltf", ".glb"])
@pytest.mark.parametrize("name", list(SCENES))
def test_roundtrip_matches_jax(tmp_path, memory_frames, name, ext):
    host = SCENES[name]()
    pdir, jdir = tmp_path / "port", tmp_path / "jax"
    ppath, jpath = str(pdir / f"scene{ext}"), str(jdir / f"scene{ext}")
    tscene.save_scene(host, ppath)
    jscene.save_scene(_convert(SCENES[name](), jscene), jpath)
    # the same bytes, file for file (textures and the .bin included)
    pfiles, jfiles = _files(pdir), _files(jdir)
    assert list(pfiles) == list(jfiles)
    for f in pfiles:
        assert pfiles[f] == jfiles[f], f
    if ext == ".glb":
        data = pfiles[f"scene{ext}"]
        magic, version, length = struct.unpack_from("<III", data, 0)
        assert (magic, version, length) == (0x46546C67, 2, len(data))
        assert "scene.bin" not in pfiles
    # each package's file loads in the other to the same host scene
    for path in (ppath, jpath):
        again = tscene.load_scene(path)
        _host_equal(again, jscene.load_scene(path))
    # and renders as the in-memory scene, bit for bit
    np.testing.assert_array_equal(_render(again), memory_frames[name])


def test_save_load_dispatch_reaches_gltf(tmp_path):
    """``load_scene``/``save_scene`` dispatch ``.gltf``/``.glb`` (any case)
    to ``io.gltf``, as JAX's do."""
    host = tts.make_hair_scene(4)
    path = str(tmp_path / "hair.GLB")
    tscene.save_scene(host, path)
    got = tscene.load_scene(path)
    _host_equal(got, tgltf.load_gltf(path))
    _host_equal(got, jscene.load_scene(path))


# --------------------------------------------------------------------------
# primitive modes, node TRS, the GLB container, accessors
# --------------------------------------------------------------------------


def test_gltf_primitive_mode_expansion():
    idx = np.arange(5)
    _, _, fan = tgltf._expand_indices(tgltf.MODE_TRIANGLE_FAN, idx, 5)
    np.testing.assert_array_equal(fan, [[0, 1, 2], [0, 2, 3], [0, 3, 4]])
    _, _, strip = tgltf._expand_indices(tgltf.MODE_TRIANGLE_STRIP, idx, 5)
    np.testing.assert_array_equal(strip, [[0, 1, 2], [1, 2, 3], [2, 3, 4]])
    _, loop, _ = tgltf._expand_indices(tgltf.MODE_LINE_LOOP, idx, 5)
    np.testing.assert_array_equal(loop, [[0, 1], [1, 2], [2, 3], [4, 0]])
    _, lstrip, _ = tgltf._expand_indices(tgltf.MODE_LINE_STRIP, idx, 5)
    np.testing.assert_array_equal(lstrip, [[0, 1], [1, 2], [2, 3], [3, 4]])
    pts, _, _ = tgltf._expand_indices(tgltf.MODE_POINTS, None, 3)
    np.testing.assert_array_equal(pts, [0, 1, 2])
    rng = np.random.default_rng(0)
    for mode in range(8):   # 7: not a mode, read as points like JAX
        for idx in (None, np.arange(1), np.arange(2), np.arange(7),
                    rng.integers(0, 50, 11).astype(np.uint16)):
            assert_same(tgltf._expand_indices(mode, idx, 6),
                   jgltf._expand_indices(mode, idx, 6), f"mode {mode}")


def _b64(arr) -> str:
    raw = np.ascontiguousarray(arr).tobytes()
    return ("data:application/octet-stream;base64,"
            + base64.b64encode(raw).decode())


def _write(path, g):
    path.write_text(json.dumps(g))
    return str(path)


def _both_load(path, **kw):
    got = tgltf.load_gltf(path, **kw)
    want = jgltf.load_gltf(path, **kw)
    if kw.get("return_graph"):
        _host_equal(got[0], want[0])
        _graph_equal(got[1], want[1])
    else:
        _host_equal(got, want)
    return got


TRI = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)


def test_gltf_node_hierarchy_and_trs(tmp_path):
    blob = TRI.tobytes()
    g = {
        "asset": {"version": "2.0"},
        "buffers": [{"uri": _b64(TRI), "byteLength": len(blob)}],
        "bufferViews": [{"buffer": 0, "byteOffset": 0,
                         "byteLength": len(blob)}],
        "accessors": [{"bufferView": 0, "componentType": 5126,
                       "count": 3, "type": "VEC3"}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0}}]}],
        "cameras": [{"type": "perspective",
                     "perspective": {"yfov": 0.7, "aspectRatio": 1.5}},
                    {"type": "orthographic",
                     "orthographic": {"xmag": 2.0, "ymag": 1.0}}],
        "nodes": [
            {"children": [1, 2], "translation": [1, 2, 3]},
            {"mesh": 0, "scale": [2, 2, 2],
             "rotation": [0, 0, 0.7071068, 0.7071068]},
            {"camera": 0, "matrix": [1, 0, 0, 0, 0, 0.8, 0.6, 0,
                                     0, -0.6, 0.8, 0, 4, 5, 6, 1],
             "children": [3]},
            {"camera": 1, "mesh": 0, "rotation": [0.1, 0.2, 0.3, 0.927]},
        ],
        "scenes": [{"nodes": [0]}],
        "scene": 0,
    }
    host = _both_load(_write(tmp_path / "trs.gltf", g))
    ist = host.instances[0]
    p = TRI[1] @ ist.axes + ist.o
    np.testing.assert_allclose(p, [1, 4, 3], atol=1e-5)
    assert len(host.instances) == 2 and len(host.cameras) == 2
    # no default scene: the roots are the nodes nobody points to
    del g["scene"], g["scenes"]
    _both_load(_write(tmp_path / "roots.gltf", g))


def _glb(g, blob):
    js = json.dumps(g).encode()
    js += b" " * (-len(js) % 4)
    bin_chunk = blob + b"\0" * (-len(blob) % 4)
    payload = (struct.pack("<II", len(js), 0x4E4F534A) + js
               + struct.pack("<II", len(bin_chunk), 0x004E4942) + bin_chunk)
    return struct.pack("<III", 0x46546C67, 2, 12 + len(payload)) + payload


def _tri_gltf(**buffer):
    blob = TRI.tobytes()
    return {
        "asset": {"version": "2.0"},
        "buffers": [dict(byteLength=len(blob), **buffer)],
        "bufferViews": [{"buffer": 0, "byteOffset": 0,
                         "byteLength": len(blob)}],
        "accessors": [{"bufferView": 0, "componentType": 5126,
                       "count": 3, "type": "VEC3"}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0}}]}],
        "nodes": [{"mesh": 0}],
        "scenes": [{"nodes": [0]}],
        "scene": 0,
    }


def test_glb_container(tmp_path):
    path = tmp_path / "tri.glb"
    path.write_bytes(_glb(_tri_gltf(), TRI.tobytes()))
    host = _both_load(str(path))
    assert len(host.shapes) == 1
    np.testing.assert_array_equal(host.shapes[0].pos, TRI)
    np.testing.assert_array_equal(host.shapes[0].triangles, [[0, 1, 2]])
    # a .gltf name holding GLB bytes is read as GLB (the magic decides)
    other = tmp_path / "tri_glb.gltf"
    other.write_bytes(path.read_bytes())
    _both_load(str(other))


COMPONENTS = [5120, 5121, 5122, 5123, 5125, 5126]


@pytest.mark.parametrize("interleaved", [False, True],
                         ids=["dense", "interleaved"])
@pytest.mark.parametrize("normalized", [False, True],
                         ids=["raw", "normalized"])
@pytest.mark.parametrize("ctype", COMPONENTS)
def test_accessor_component_types(ctype, normalized, interleaved):
    """Every component type, dense or interleaved (byteStride), raw or
    normalized: ``_accessor`` and ``_accessor_f32`` equal JAX's."""
    dtype = np.dtype(tgltf._COMPONENT_DTYPES[ctype])
    rng = np.random.default_rng(ctype)
    if dtype.kind == "f":
        vals = rng.normal(size=(5, 3)).astype(dtype)
    else:
        info = np.iinfo(dtype)
        vals = rng.integers(info.min, int(info.max) + 1, (5, 3),
                            dtype=np.int64).astype(dtype)
        vals[0] = [info.min, info.max, 0]
    item = vals[0].nbytes
    if interleaved:
        stride = item + 4 + (-item % 4)
        raw = bytearray(4 + stride * 5)
        for i, row in enumerate(vals):
            raw[4 + i * stride:4 + i * stride + item] = row.tobytes()
        view = {"buffer": 0, "byteOffset": 4, "byteLength": stride * 5,
                "byteStride": stride}
    else:
        raw = bytearray(8) + vals.tobytes()
        view = {"buffer": 0, "byteOffset": 8, "byteLength": vals.nbytes}
    acc = {"bufferView": 0, "componentType": ctype, "count": 5,
           "type": "VEC3"}
    if normalized:
        acc["normalized"] = True
    g = {"bufferViews": [view], "accessors": [acc]}
    buffers = [bytes(raw)]
    got = tgltf._accessor(g, buffers, 0)
    assert_same(got, jgltf._accessor(g, buffers, 0))
    if not normalized or dtype.kind == "f":
        np.testing.assert_array_equal(got, vals)
    for want_comp in (2, 3, 4):
        assert_same(tgltf._accessor_f32(g, buffers, 0, want_comp, fill=0.5),
               jgltf._accessor_f32(g, buffers, 0, want_comp, fill=0.5))


def test_accessor_sparse_and_no_view():
    base = np.arange(12, dtype=np.float32).reshape(4, 3)
    sidx = np.array([1, 3], np.uint16)
    svals = np.array([[9, 9, 9], [7, 7, 7]], np.float32)
    buffers = [base.tobytes() + sidx.tobytes() + svals.tobytes()]
    g = {"bufferViews": [
        {"buffer": 0, "byteOffset": 0, "byteLength": base.nbytes},
        {"buffer": 0, "byteOffset": base.nbytes, "byteLength": 4},
        {"buffer": 0, "byteOffset": base.nbytes + 4, "byteLength": 24}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 4,
             "type": "VEC3", "sparse": {
                 "count": 2,
                 "indices": {"bufferView": 1, "componentType": 5123},
                 "values": {"bufferView": 2}}},
            {"componentType": 5126, "count": 4, "type": "VEC3",
             "sparse": {"count": 2,
                        "indices": {"bufferView": 1, "componentType": 5123},
                        "values": {"bufferView": 2}}}]}
    for i in (0, 1):
        got = tgltf._accessor(g, buffers, i)
        assert_same(got, jgltf._accessor(g, buffers, i))
        np.testing.assert_array_equal(got[[1, 3]], svals)


def test_gltf_interleaved_and_normalized(tmp_path):
    """A mesh whose POSITION is interleaved (byteStride 16), TEXCOORD_0 is
    normalized u8, RADIUS normalized i16 and indices u8, and a second
    primitive with u16 indices in LINE_STRIP mode."""
    inter = np.concatenate([TRI, np.zeros((3, 1), np.float32)], 1).tobytes()
    uv = np.array([[0, 0], [255, 0], [0, 255]], np.uint8)
    rad = np.array([-32768, 16384, 32767], np.int16)
    idx8 = np.array([0, 1, 2], np.uint8)
    idx16 = np.array([2, 0, 1], np.uint16)
    blobs = [inter, uv.tobytes(), rad.tobytes(), idx8.tobytes(),
             idx16.tobytes()]
    g = {
        "asset": {"version": "2.0"},
        "buffers": [{"uri": _b64(np.frombuffer(b, np.uint8)),
                     "byteLength": len(b)} for b in blobs],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": len(inter),
             "byteStride": 16}] + [
            {"buffer": i, "byteOffset": 0, "byteLength": len(blobs[i])}
            for i in range(1, 5)],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 3,
             "type": "VEC3"},
            {"bufferView": 1, "componentType": 5121, "count": 3,
             "type": "VEC2", "normalized": True},
            {"bufferView": 2, "componentType": 5122, "count": 3,
             "type": "SCALAR", "normalized": True},
            {"bufferView": 3, "componentType": 5121, "count": 3,
             "type": "SCALAR"},
            {"bufferView": 4, "componentType": 5123, "count": 3,
             "type": "SCALAR"}],
        "meshes": [{"primitives": [
            {"attributes": {"POSITION": 0, "TEXCOORD_0": 1, "RADIUS": 2},
             "indices": 3},
            {"attributes": {"POSITION": 0}, "indices": 4, "mode": 3}]}],
        "nodes": [{"mesh": 0}],
        "scenes": [{"nodes": [0]}],
        "scene": 0,
    }
    host = _both_load(_write(tmp_path / "inter.gltf", g))
    np.testing.assert_array_equal(host.shapes[0].pos, TRI)
    np.testing.assert_array_equal(host.shapes[0].texcoord,
                                  [[0, 0], [1, 0], [0, 1]])
    np.testing.assert_array_equal(host.shapes[1].lines, [[2, 0], [0, 1]])
    assert host.shapes[0].radius[0] == -1.0


def test_gltf_materials_and_embedded_images(tmp_path):
    """Metallic-roughness (both branches of the mapping), spec-gloss,
    emissive, normal and ``extras.kr`` materials; a ``data:`` image and a
    bufferView-embedded image (decoded through PIL); an 'F'-mode float
    image read as HDR."""
    from PIL import Image
    import io

    def png_bytes(arr, fmt="PNG"):
        out = io.BytesIO()
        Image.fromarray(arr).save(out, format=fmt)
        return out.getvalue()

    ldr = tproc.make_uvgrid_image(16, 8, 4)
    embedded = png_bytes(tproc.make_checker_image(8, 8, 2))
    gray = png_bytes(np.linspace(0, 2, 12, dtype=np.float32).reshape(3, 4),
                     "TIFF")
    g = json.loads(json.dumps(_tri_gltf(uri=_b64(
        np.frombuffer(TRI.tobytes() + embedded, np.uint8)))))
    g["buffers"][0]["byteLength"] = TRI.nbytes + len(embedded)
    g["bufferViews"].append({"buffer": 0, "byteOffset": TRI.nbytes,
                             "byteLength": len(embedded)})
    g["images"] = [{"uri": _b64(np.frombuffer(png_bytes(ldr), np.uint8))},
                   {"bufferView": 1, "mimeType": "image/png"},
                   {"uri": _b64(np.frombuffer(gray, np.uint8))}, {}]
    g["textures"] = [{"source": i} for i in range(4)]
    g["materials"] = [
        {"name": "mr", "emissiveFactor": [0.1, 0.2, 0.3],
         "emissiveTexture": {"index": 2}, "normalTexture": {"index": 1},
         "pbrMetallicRoughness": {"baseColorFactor": [0.5, 0.6, 0.7, 1],
                                  "metallicFactor": 0.3,
                                  "roughnessFactor": 0.4,
                                  "baseColorTexture": {"index": 0}}},
        {"name": "metal", "pbrMetallicRoughness": {
            "metallicFactor": 0.9, "baseColorTexture": {"index": 1}}},
        {"name": "rough", "pbrMetallicRoughness": {"metallicFactor": 0.0}},
        {"name": "sg", "extras": {"kr": [0.5, 0.5, 0.5]},
         "pbrMetallicRoughness": {},
         "extensions": {"KHR_materials_pbrSpecularGlossiness": {
             "diffuseFactor": [0.2, 0.3, 0.4, 1],
             "specularFactor": [0.05, 0.06, 0.07],
             "glossinessFactor": 0.25,
             "diffuseTexture": {"index": 9},
             "specularGlossinessTexture": {"index": 0}}}},
    ]
    g["meshes"][0]["primitives"] = [
        {"attributes": {"POSITION": 0}, "material": m} for m in range(4)]
    host = _both_load(_write(tmp_path / "mats.gltf", g))
    np.testing.assert_array_equal(host.textures[0].ldr, ldr)
    assert host.textures[2].hdr is not None
    assert host.textures[3].ldr is None and host.textures[3].hdr is None
    assert [m.kd_txt for m in host.materials] == [0, -1, -1, -1]
    # zero texcoords (the file has none) still give the normal-mapped
    # shape a tangent space, the canonical frame
    assert len(host.shapes[0].tangsp) == 3
    assert all(len(s.tangsp) == 0 for s in host.shapes[1:])


# --------------------------------------------------------------------------
# tangent space (tests/test_io.py:280-318, and the stand-in for 320)
# --------------------------------------------------------------------------


def _shape(mod, pos, norm, texcoord, triangles):
    n = len(pos)
    return mod.HostShape(
        name="s", pos=np.asarray(pos, np.float32),
        norm=np.asarray(norm, np.float32),
        texcoord=np.asarray(texcoord, np.float32),
        radius=np.zeros(n, np.float32), points=np.zeros(0, np.int32),
        lines=np.zeros((0, 2), np.int32),
        triangles=np.asarray(triangles, np.int32))


def _tangsp_both(*args):
    got = tscene.compute_tangent_space(_shape(tscene, *args))
    assert_same(got, jscene.compute_tangent_space(_shape(jscene, *args)))
    return got


def test_tangent_space_axis_aligned_quad():
    up = np.tile(np.array([0, 0, 1], np.float32), (4, 1))
    tangsp = _tangsp_both(
        [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], up,
        [[0, 0], [1, 0], [1, 1], [0, 1]], [[0, 1, 2], [0, 2, 3]])
    assert tangsp.shape == (4, 4)
    np.testing.assert_allclose(tangsp[:, :3], np.tile([1, 0, 0], (4, 1)),
                               atol=1e-6)
    np.testing.assert_allclose(tangsp[:, 3], 1.0)
    assert np.abs((tangsp[:, :3] * up).sum(-1)).max() < 1e-6


def test_tangent_space_degenerate_uv_fallback():
    tangsp = _tangsp_both(
        [[0, 0, 0], [1, 0, 0], [0, 1, 0]],
        np.tile(np.array([0, 0, 1], np.float32), (3, 1)),
        np.zeros((3, 2), np.float32), [[0, 1, 2]])
    np.testing.assert_allclose(tangsp[:, :3], np.tile([1, 0, 0], (3, 1)),
                               atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tangent_space_seeded_mesh(seed):
    """Random shared-vertex meshes with mirrored uvs (both handedness
    signs, degenerate and folded triangles): the f64 sums in corner order
    give JAX's bits."""
    rng = np.random.default_rng(seed)
    nv = 200
    pos = rng.normal(size=(nv, 3))
    norm = rng.normal(size=(nv, 3))
    norm /= np.linalg.norm(norm, axis=1, keepdims=True)
    uv = rng.uniform(-1, 1, (nv, 2))
    tris = rng.integers(0, nv, (600, 3))
    tangsp = _tangsp_both(pos, norm, uv, tris)
    assert set(np.unique(tangsp[:, 3])) == {-1.0, 1.0}


def _normal_mapped_scene():
    """A 16 x 8 grid made with the port's ``geometry.make_faces``, normal
    mapped with ``bump_to_normal_map`` of the port's bump-dimple image, and
    a second, plain grid."""
    def pos_fn(uv):
        return np.stack([uv[:, 0] * 4 - 2, np.sin(uv[:, 1] * 3),
                         uv[:, 1] * 2], axis=1)

    tris, pos, _, tc = tgeo.make_faces(16, 8, pos_fn)
    shapes = [tts._shape(name, pos + off, triangles=tris)
              for name, off in (("bumpy", 0.0), ("plain", 3.0))]
    for s in shapes:
        s.texcoord = tc
    materials = [tscene.HostMaterial(name="bumpy", norm_txt=0),
                 tscene.HostMaterial(name="plain")]
    host = tts.assemble(shapes, materials, [0, 1], [tts.lookat_camera(
        "cam", eye=(0, 3, 6), target=(0, 0, 1))])
    host.textures = [tscene.HostTexture("bump_normal.png", ldr=(
        tproc.bump_to_normal_map(tproc.make_bumpdimple_image(32, 32, 8),
                                 4.0)))]
    return host


def test_tangent_space_normal_mapped_obj(tmp_path):
    """``finalize_scene`` computes ``tangsp`` for the normal-mapped shape
    only (src/scene.cpp:217-222), equal to JAX's through OBJ and glTF."""
    obj = str(tmp_path / "bumpy.obj")
    tscene.save_scene(_normal_mapped_scene(), obj)
    host = tscene.load_scene(obj)
    _host_equal(host, jscene.load_scene(obj))
    bumpy, plain = host.shapes
    assert host.materials[host.instances[0].material].norm_txt == 0
    assert len(bumpy.tangsp) == len(bumpy.pos) and len(plain.tangsp) == 0
    dots = (bumpy.tangsp[:, :3] * bumpy.norm).sum(-1)
    assert np.abs(dots).max() < 1e-5
    for ext in (".gltf", ".glb"):
        pdir, jdir = tmp_path / f"port{ext}", tmp_path / f"jax{ext}"
        tscene.save_scene(host, str(pdir / f"bumpy{ext}"))
        jscene.save_scene(_convert(host, jscene), str(jdir / f"bumpy{ext}"))
        assert _files(pdir) == _files(jdir)
        again = tscene.load_scene(str(pdir / f"bumpy{ext}"))
        _host_equal(again, jscene.load_scene(str(pdir / f"bumpy{ext}")))
        assert_same(again.shapes[0].tangsp, bumpy.tangsp)


# --------------------------------------------------------------------------
# load and save errors (tests/test_io.py:339-366)
# --------------------------------------------------------------------------


def _error_case(tmp_path, case):
    """-> (a callable taking the scene module, what it should raise)."""
    if case == "unknown_extension":
        p = tmp_path / "scene.ply"
        p.write_text("ply")
        return lambda m: m.load_scene(str(p)), "unsupported"
    if case == "missing_file":
        return lambda m: m.load_scene("/nonexistent/scene.gltf"), "not found"
    if case == "save_unknown_extension":
        return (lambda m: m.save_scene(_convert(tts.make_hair_scene(4), m),
                                       str(tmp_path / "scene.usd")),
                "unsupported")
    if case == "malformed_gltf":
        p = tmp_path / "bad.gltf"
        p.write_text("{not json")
        return lambda m: m.load_scene(str(p)), "malformed"
    if case == "missing_texture":
        (tmp_path / "scene.mtl").write_text(
            "newmtl m\nKd 0.5 0.5 0.5\nmap_Kd missing.png\n")
        obj = tmp_path / "scene.obj"
        obj.write_text("mtllib scene.mtl\nusemtl m\n"
                       "v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
        return lambda m: m.load_scene(str(obj)), "texture"
    p = tmp_path / "bad.glb"
    good = _glb(_tri_gltf(), TRI.tobytes())
    if case == "glb_bad_magic":
        p.write_bytes(b"glTX" + good[4:])
    elif case == "glb_version":
        p.write_bytes(good[:4] + struct.pack("<I", 1) + good[8:])
    elif case == "glb_no_json":
        p.write_bytes(good[:12])
    elif case == "buffer_without_uri":
        p = tmp_path / "nobuf.gltf"
        p.write_text(json.dumps(_tri_gltf()))
    elif case == "non_base64_uri":
        p = tmp_path / "text.gltf"
        p.write_text(json.dumps(_tri_gltf(uri="data:text/plain,abc")))
    elif case == "bad_component_type":
        g = _tri_gltf(uri=_b64(TRI))
        g["accessors"][0]["componentType"] = 5130
        p = tmp_path / "ctype.gltf"
        p.write_text(json.dumps(g))
    return lambda m: m.load_scene(str(p)), ""


ERRORS = ["unknown_extension", "missing_file", "save_unknown_extension",
          "malformed_gltf", "missing_texture", "glb_bad_magic",
          "glb_version", "glb_no_json", "buffer_without_uri",
          "non_base64_uri", "bad_component_type"]


@pytest.mark.parametrize("case", ERRORS)
def test_load_errors_match_jax(tmp_path, case):
    fn, match = _error_case(tmp_path, case)
    with pytest.raises(ValueError, match=match or None) as got:
        fn(tscene)
    with pytest.raises(ValueError) as want:
        fn(jscene)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)
    assert type(got.value).__module__.startswith(
        "yocto_raytracing_tpu_torch.")
    if isinstance(want.value, jscene.SceneLoadError):
        assert isinstance(got.value, tscene.SceneLoadError)


# --------------------------------------------------------------------------
# animation, skins and morphs (tests/test_gltf_animation.py)
# --------------------------------------------------------------------------


def _buffers(*arrays):
    buffers = [dict(uri=_b64(a), byteLength=a.nbytes) for a in arrays]
    views = [dict(buffer=i, byteOffset=0, byteLength=b["byteLength"])
             for i, b in enumerate(buffers)]
    return buffers, views


def _write_animated_gltf(path, interp="LINEAR"):
    """tests/test_gltf_animation.py:25-80: one triangle whose node has a
    translation channel (0,0,0)->(2,0,0) over t in [0, 1], a STEP rotation
    channel and a weights channel for one morph target."""
    pos = TRI
    idx = np.asarray([0, 1, 2], np.uint16)
    times = np.asarray([0.0, 1.0], np.float32)
    trans = np.asarray([[0, 0, 0], [2, 0, 0]], np.float32)
    rots = np.asarray([[0, 0, 0, 1],
                       [0, 0, np.sin(np.pi / 4), np.cos(np.pi / 4)]],
                      np.float32)
    morph = np.asarray([[0, 0, 1], [0, 0, 1], [0, 0, 1]], np.float32)
    weights_anim = np.asarray([0.0, 1.0], np.float32)
    buffers, views = _buffers(pos, idx, times, trans, rots, morph,
                              weights_anim)
    accessors = [
        dict(bufferView=0, componentType=5126, count=3, type="VEC3",
             min=pos.min(0).tolist(), max=pos.max(0).tolist()),
        dict(bufferView=1, componentType=5123, count=3, type="SCALAR"),
        dict(bufferView=2, componentType=5126, count=2, type="SCALAR"),
        dict(bufferView=3, componentType=5126, count=2, type="VEC3"),
        dict(bufferView=4, componentType=5126, count=2, type="VEC4"),
        dict(bufferView=5, componentType=5126, count=3, type="VEC3"),
        dict(bufferView=6, componentType=5126, count=2, type="SCALAR"),
    ]
    g = dict(
        asset=dict(version="2.0"), scene=0, scenes=[dict(nodes=[0])],
        nodes=[dict(mesh=0, name="tri")],
        meshes=[dict(primitives=[dict(
            attributes=dict(POSITION=0), indices=1,
            targets=[dict(POSITION=5, NORMAL=5, TANGENT=5)])],
            weights=[0.25])],
        buffers=buffers, bufferViews=views, accessors=accessors,
        animations=[dict(
            name="move",
            samplers=[
                dict(input=2, output=3, interpolation=interp),
                dict(input=2, output=4, interpolation="STEP"),
                dict(input=2, output=6, interpolation="LINEAR"),
            ],
            channels=[
                dict(sampler=0, target=dict(node=0, path="translation")),
                dict(sampler=1, target=dict(node=0, path="rotation")),
                dict(sampler=2, target=dict(node=0, path="weights")),
            ])],
    )
    with open(path, "w") as f:
        json.dump(g, f)
    return str(path)


@pytest.fixture
def animated(tmp_path):
    path = _write_animated_gltf(tmp_path / "anim.gltf")
    return (tgltf.load_gltf(path, return_graph=True),
            jgltf.load_gltf(path, return_graph=True))


def test_animation_channels_parsed(animated):
    (host, graph), (jhost, jgraph) = animated
    _host_equal(host, jhost)
    _graph_equal(graph, jgraph)
    assert len(host.instances) == 1 and len(graph.channels) == 3
    assert sorted(ch["path"] for ch in graph.channels) == [
        "rotation", "translation", "weights"]
    assert tgltf.animation_bounds(graph) == (0.0, 1.0)
    assert tgltf.animation_bounds(graph) == jgltf.animation_bounds(jgraph)
    assert graph.shape_morphs[0][0]["weight"] == 0.25


TIMES = [-1.0, 0.0, 0.1, 0.25, 0.5, 0.7, 1.0, 9.0]


def test_translation_linear_and_clamp(animated):
    (host, graph), (jhost, jgraph) = animated
    for ch, jch in zip(graph.channels, jgraph.channels):
        for t in TIMES:
            assert_same(tgltf.sample_channel(ch, t), jgltf.sample_channel(jch, t),
                   f"{ch['path']} at {t}")
    ch = next(c for c in graph.channels if c["path"] == "translation")
    np.testing.assert_allclose(tgltf.sample_channel(ch, -1.0), [0, 0, 0])
    np.testing.assert_allclose(tgltf.sample_channel(ch, 9.0), [2, 0, 0])
    np.testing.assert_allclose(tgltf.sample_channel(ch, 0.5), [1, 0, 0],
                               atol=1e-6)
    for t in TIMES:
        tgltf.update_animated_transforms(graph, t)
        tgltf.apply_graph_transforms(graph, host)
        jgltf.update_animated_transforms(jgraph, t)
        jgltf.apply_graph_transforms(jgraph, jhost)
        _host_equal(host, jhost)
        assert_same(graph.nodes, jgraph.nodes)
        assert_same(tgltf.node_world_transforms(graph),
               jgltf.node_world_transforms(jgraph))
        if t == 0.5:
            np.testing.assert_allclose(host.instances[0].o, [1, 0, 0],
                                       atol=1e-6)
            np.testing.assert_allclose(host.instances[0].axes, np.eye(3),
                                       atol=1e-6)
    np.testing.assert_allclose(host.instances[0].axes[0], [0, 1, 0],
                               atol=1e-6)


def test_rotation_slerp_midpoint():
    qa = np.asarray([0, 0, 0, 1], np.float32)
    qb = np.asarray([0, 0, np.sin(np.pi / 4), np.cos(np.pi / 4)], np.float32)
    mid = tgltf._slerp(qa, qb, 0.5)
    np.testing.assert_allclose(
        mid, [0, 0, np.sin(np.pi / 8), np.cos(np.pi / 8)], atol=1e-6)
    near = np.asarray([0, 0, 0.01, 0.99995], np.float32)
    for a, b in ((qa, qb), (qa, -qb), (qa, near), (qb, -near)):
        for t in (0.0, 0.3, 0.5, 1.0):
            assert_same(tgltf._slerp(a, b, t), jgltf._slerp(a, b, t))


def test_morph_weights_playback(animated):
    (host, graph), (jhost, jgraph) = animated
    tgltf.update_animated_transforms(graph, 0.5)
    jgltf.update_animated_transforms(jgraph, 0.5)
    weights = graph.nodes[0]["weights"]
    np.testing.assert_allclose(weights, [0.5], atol=1e-6)
    shape, jshape = host.shapes[0], jhost.shapes[0]
    shape.tangsp = jshape.tangsp = np.ones((3, 4), np.float32)
    for w in (weights, [0.0], [], [0.3, 0.1]):
        got = tgltf.morph_vertices(shape, graph.shape_morphs[0], w)
        assert_same(got, jgltf.morph_vertices(jshape, jgraph.shape_morphs[0], w))
    pos, norm, tangsp = tgltf.morph_vertices(shape, graph.shape_morphs[0],
                                             weights)
    np.testing.assert_allclose(pos[:, 2], 0.5, atol=1e-6)
    pos0, *_ = tgltf.morph_vertices(shape, graph.shape_morphs[0], [0.0])
    np.testing.assert_array_equal(pos0, shape.pos)


@pytest.mark.parametrize("path", ["translation", "rotation"])
def test_cubicspline_matches_endpoints(animated, path):
    (host, graph), _ = animated
    ch = dict(next(c for c in graph.channels if c["path"] == "translation"))
    comps = 3 if path == "translation" else 4
    rng = np.random.default_rng(comps)
    k = rng.normal(size=(2, 3, comps)).astype(np.float32)
    ch.update(interp="CUBICSPLINE", values=k, path=path)
    for t in TIMES:
        assert_same(tgltf.sample_channel(ch, t), jgltf.sample_channel(ch, t),
               f"{t}")
    k = np.zeros((2, 3, 3), np.float32)
    k[1, 1] = [2, 0, 0]
    ch.update(values=k, path="translation")
    np.testing.assert_allclose(tgltf.sample_channel(ch, 0.0), [0, 0, 0])
    np.testing.assert_allclose(tgltf.sample_channel(ch, 1.0), [2, 0, 0])
    np.testing.assert_allclose(tgltf.sample_channel(ch, 0.5), [1, 0, 0],
                               atol=1e-6)


def test_skinning_identity_and_translation():
    xf = np.stack([np.eye(4, dtype=np.float32)] * 2)
    xf[1, 0, 3] = 1.0
    pos = np.asarray([[0, 0, 0], [1, 1, 1]], np.float32)
    joints = np.asarray([[0, 0, 0, 0], [1, 0, 0, 0]], np.int32)
    weights = np.asarray([[1, 0, 0, 0], [1, 0, 0, 0]], np.float32)
    out = tgltf.skin_vertices(pos, joints, weights, xf, device="cpu")
    assert out.dtype == torch.float32 and out.device.type == "cpu"
    np.testing.assert_array_equal(out.numpy(), [[0, 0, 0], [2, 1, 1]])
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jgltf.skin_vertices(pos, joints, weights,
                                                    xf)))
    weights = np.asarray([[0.5, 0.5, 0, 0]], np.float32)
    joints = np.asarray([[0, 1, 0, 0]], np.int32)
    out = tgltf.skin_vertices(pos[:1], joints, weights, xf, device="cpu")
    np.testing.assert_array_equal(out.numpy(), [[0.5, 0, 0]])


SKIN_ULP_BOUND = 2.0


def _skin_gap(got, want, pos, joints, w, xf):
    """|got - want| in ULP of the magnitude of the terms each coordinate
    sums: eps * sum_k w_k (|M_k| |p| + |t_k|)."""
    m = np.asarray(xf, np.float64)[np.asarray(joints)]
    terms = (np.abs(m[..., :3, :3] * np.asarray(pos)[:, None, None, :])
             .sum(-1) + np.abs(m[..., :3, 3]))
    scale = (terms * np.asarray(w)[..., None]).sum(1)
    return np.abs(got.astype(np.float64) - want) / (
        np.finfo(np.float32).eps * scale)


def test_skin_vertices_within_ulp_of_jax_einsum():
    """1,000 seeded vertices, 4 slots over 8 random joint matrices: every
    coordinate within SKIN_ULP_BOUND ULP of JAX's ``einsum``, in ULP of the
    magnitude of the terms it sums (eps * sum_k w_k (|M_k| |p| + |t_k|)),
    since a coordinate that cancels has a tiny ULP of its own. Largest gap
    measured: 1.36 of those ULP (1,024 ULP of a coordinate of 4.0e-4 that
    cancels); 848 of the 3,000 coordinates differ."""
    rng = np.random.default_rng(0)
    nv, nj = 1000, 8
    pos = rng.normal(size=(nv, 3)).astype(np.float32)
    xf = np.tile(np.eye(4, dtype=np.float32), (nj, 1, 1))
    xf[:, :3, :] = rng.normal(size=(nj, 3, 4)).astype(np.float32)
    joints = rng.integers(0, nj, (nv, 4)).astype(np.int32)
    w = rng.uniform(0, 1, (nv, 4)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    got = tgltf.skin_vertices(pos, joints, w, xf, device="cpu").numpy()
    want = np.asarray(jgltf.skin_vertices(pos, joints, w, xf))
    gap = _skin_gap(got, want, pos, joints, w, xf)
    assert gap.max() <= SKIN_ULP_BOUND, gap.max()
    # the explicit order, in f32, op for op
    mm = xf[joints]
    coords = [mm[:, :, i, 0] * pos[:, None, 0] + mm[:, :, i, 1] * pos[:, None, 1]
              + mm[:, :, i, 2] * pos[:, None, 2] + mm[:, :, i, 3]
              for i in range(3)]
    d = np.stack(coords, -1) * w[:, :, None]
    np.testing.assert_array_equal(got, d[:, 0] + d[:, 1] + d[:, 2] + d[:, 3])


def test_skin_vertices_explicit_and_on_the_card_by_default(monkeypatch):
    src = inspect.getsource(tgltf.skin_vertices)
    body = src[src.index('"""', src.index('"""') + 3):]
    for word in ("einsum", "matmul", "addcmul", "bmm", "@", "mm("):
        assert word not in body, word
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    eye = np.eye(4, dtype=np.float32)[None]
    args = (np.zeros((1, 3), np.float32), np.zeros((1, 4), np.int32),
            np.ones((1, 4), np.float32), eye)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tgltf.skin_vertices(*args)


def test_get_skin_transforms_inverse_bind():
    def graph(mod):
        g = mod.GltfGraph(
            nodes=[dict(name="joint", translation=[3, 0, 0])], roots=[0],
            instance_nodes=[], camera_nodes=[], channels=[],
            skins=[dict(name="s", joints=[0],
                        inverse_bind=np.asarray([np.eye(4)], np.float32),
                        skeleton=0)],
            shape_morphs={}, shape_skin_attrs={})
        g.skins[0]["inverse_bind"][0, 0, 3] = -3.0
        return g
    xf = tgltf.get_skin_transforms(graph(tgltf), 0,
                                   np.eye(4, dtype=np.float32))
    assert_same(xf, jgltf.get_skin_transforms(graph(jgltf), 0,
                                         np.eye(4, dtype=np.float32)))
    np.testing.assert_allclose(xf[0], np.eye(4), atol=1e-6)


def test_skinned_mesh_loads_and_deforms(tmp_path):
    """JOINTS_0 (u8), WEIGHTS_0 and a skin with inverse bind matrices over a
    two-joint chain: the graph equals JAX's, and the deform of the loaded
    mesh by the joint matrices of the animated chain equals JAX's within
    the ULP bound above."""
    rng = np.random.default_rng(5)
    pos = rng.normal(size=(40, 3)).astype(np.float32)
    joints = rng.integers(0, 2, (40, 4)).astype(np.uint8)
    weights = rng.uniform(0, 1, (40, 4)).astype(np.float32)
    weights /= weights.sum(1, keepdims=True)
    ib = np.stack([np.eye(4, dtype=np.float32)] * 2)
    ib[1, :3, 3] = [0, -1, 0]
    times = np.asarray([0.0, 2.0], np.float32)
    rots = np.asarray([[0, 0, 0, 1], [0.3826834, 0, 0, 0.9238795]],
                      np.float32)
    buffers, views = _buffers(pos, joints, weights,
                              ib.transpose(0, 2, 1).copy(), times, rots)
    g = dict(
        asset=dict(version="2.0"), scene=0, scenes=[dict(nodes=[0, 1])],
        nodes=[dict(mesh=0, skin=0, name="body"),
               dict(name="root", children=[2]),
               dict(name="tip", translation=[0, 1, 0])],
        meshes=[dict(primitives=[dict(attributes=dict(
            POSITION=0, JOINTS_0=1, WEIGHTS_0=2))])],
        skins=[dict(name="chain", joints=[1, 2], inverseBindMatrices=3,
                    skeleton=1)],
        buffers=buffers, bufferViews=views,
        accessors=[
            dict(bufferView=0, componentType=5126, count=40, type="VEC3"),
            dict(bufferView=1, componentType=5121, count=40, type="VEC4"),
            dict(bufferView=2, componentType=5126, count=40, type="VEC4"),
            dict(bufferView=3, componentType=5126, count=2, type="MAT4"),
            dict(bufferView=4, componentType=5126, count=2, type="SCALAR"),
            dict(bufferView=5, componentType=5126, count=2, type="VEC4")],
        animations=[dict(samplers=[dict(input=4, output=5)], channels=[
            dict(sampler=0, target=dict(node=2, path="rotation")),
            dict(sampler=0, target=dict(node=1, path="rotation"))])])
    path = _write(tmp_path / "skin.gltf", g)
    (host, graph), (jhost, jgraph) = (tgltf.load_gltf(path, True),
                                      jgltf.load_gltf(path, True))
    _host_equal(host, jhost)
    _graph_equal(graph, jgraph)
    assert graph.channels[0]["nodes"] == [2, 1]
    np.testing.assert_array_equal(graph.skins[0]["inverse_bind"], ib)
    tgltf.update_animated_transforms(graph, 1.0)
    jgltf.update_animated_transforms(jgraph, 1.0)
    xf = tgltf.get_skin_transforms(graph, 0, np.eye(4, dtype=np.float32))
    assert_same(xf, jgltf.get_skin_transforms(jgraph, 0,
                                         np.eye(4, dtype=np.float32)))
    sj, sw = graph.shape_skin_attrs[0]
    got = tgltf.skin_vertices(host.shapes[0].pos, sj, sw, xf,
                              device="cpu").numpy()
    want = np.asarray(jgltf.skin_vertices(host.shapes[0].pos, sj, sw, xf))
    gap = _skin_gap(got, want, host.shapes[0].pos, sj, sw, xf)
    assert gap.max() <= SKIN_ULP_BOUND, gap.max()
