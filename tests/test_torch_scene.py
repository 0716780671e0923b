"""The port's scene layer equals the JAX package's, leaf for leaf.

Both packages build each scene with their own ``testscenes`` and
``build_device_scene``; the flat arrays must be identical (same dtypes, same
values), because every later parity test feeds them to both packages. The
port has its own copies of the BVH builder (with its native fast path), the
OBJ parser and writer and the image codecs, so these tests also hold the
copies to the JAX package's results.

Also checks that the port imports neither JAX nor anything of the JAX
package (by its source, and by running it in a process where both are
unimportable), and that its entry points default to the card.
"""

import ast
import os
import subprocess
import sys
import textwrap
from dataclasses import fields

import numpy as np
import pytest
import torch

from yocto_raytracing_tpu import bvh as jbvh, image as jimage
from yocto_raytracing_tpu import scene as jscene, testscenes as jts
from yocto_raytracing_tpu_torch import bvh as tbvh, image as timage
from yocto_raytracing_tpu_torch import native as tnative
from yocto_raytracing_tpu_torch import scene as tscene, testscenes as tts
from yocto_raytracing_tpu_torch.io import objparser as tobjparser
from yocto_raytracing_tpu_torch.render import renderer as tren

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(REPO, "yocto_raytracing_tpu_torch")

SCENES = [
    ("random0", lambda m: m.make_random_scene(seed=0)),
    ("random1", lambda m: m.make_random_scene(seed=1)),
    ("random2", lambda m: m.make_random_scene(seed=2)),
    ("random3", lambda m: m.make_random_scene(seed=3)),
    ("hair64", lambda m: m.make_hair_scene(64)),
    ("grad", lambda m: m.make_grad_scene()),
]


@pytest.mark.parametrize("name,make", SCENES, ids=[s[0] for s in SCENES])
def test_device_scene_leaves_equal(name, make):
    jd, jm = jscene.build_device_scene(make(jts))
    td, tm = tscene.build_device_scene(make(tts))
    jnames = [f.name for f in fields(jscene.DeviceScene)]
    assert list(td) == jnames
    assert list(tscene.LEAF_NAMES) == jnames
    for k in jnames:
        a = np.asarray(getattr(jd, k))
        b = td[k]
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=k)
    for k in ("max_stack", "num_instances", "num_prims", "num_nodes",
              "num_lights", "shape_prim_offset", "shape_vert_offset",
              "shape_node_root", "has_kd_textures", "has_ks_textures"):
        assert getattr(jm, k) == getattr(tm, k), k


def test_from_jax_arrays_round_trip():
    jd, _ = jscene.build_device_scene(jts.make_hair_scene(64))
    leaves = {f.name: np.asarray(getattr(jd, f.name))
              for f in fields(jscene.DeviceScene)}
    ts = tscene.from_jax_arrays(leaves, "cpu")
    for k, a in leaves.items():
        t = getattr(ts, k)
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        assert t.dtype == (torch.float32 if a.dtype == np.float32
                           else torch.int32), k
        np.testing.assert_array_equal(t.numpy(), a, err_msg=k)
    with pytest.raises(ValueError, match="missing"):
        tscene.from_jax_arrays({k: v for k, v in leaves.items()
                                if k != "pos"}, "cpu")


def test_obj_load_matches_jax(tmp_path):
    from yocto_raytracing_tpu.io import objwriter

    obj = str(tmp_path / "hair.obj")
    objwriter.save_obj(jts.make_hair_scene(32), obj)
    jd, _ = jscene.build_device_scene(jscene.load_scene(obj))
    td, _ = tscene.build_device_scene(tscene.load_scene(obj))
    for f in fields(jscene.DeviceScene):
        np.testing.assert_array_equal(np.asarray(getattr(jd, f.name)),
                                      td[f.name], err_msg=f.name)
    # its glTF twin, written by the port, loads to the same leaves in both
    glb = str(tmp_path / "hair.glb")
    tscene.save_scene(tscene.load_scene(obj), glb)
    jd, _ = jscene.build_device_scene(jscene.load_scene(glb))
    td, _ = tscene.build_device_scene(tscene.load_scene(glb))
    for f in fields(jscene.DeviceScene):
        np.testing.assert_array_equal(np.asarray(getattr(jd, f.name)),
                                      td[f.name], err_msg=f.name)
    with pytest.raises(tscene.SceneLoadError, match="unsupported"):
        path = tmp_path / "x.fbx"
        path.write_text("{}")
        tscene.load_scene(str(path))


def test_cuda_device_without_card_raises(monkeypatch):
    td, _ = tscene.build_device_scene(tts.make_grad_scene())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tscene.to_torch(td, "cuda")


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    pkg = os.path.relpath(os.path.dirname(path), os.path.dirname(PORT_DIR))
    pkg = pkg.replace(os.sep, ".")
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg.split(".")[:len(pkg.split(".")) - node.level + 1]
                mod = ".".join(base + ([node.module] if node.module else []))
            else:
                mod = node.module
            yield mod
            for a in node.names:
                yield f"{mod}.{a.name}"


def _port_files():
    return sorted(os.path.join(d, f) for d, _, fs in os.walk(PORT_DIR)
                  for f in fs if f.endswith(".py"))


def test_port_imports_no_jax():
    """No module of the port imports jax or anything of the JAX package."""
    files = _port_files() + [os.path.join(REPO, "chip_smoke.py")]
    assert len(files) >= 20
    names = {os.path.relpath(p, PORT_DIR) for p in files}
    for mod in ("io/gltf.py", "animation.py", "geometry.py",
                "procedural.py", "ops/intersect.py"):
        assert mod.replace("/", os.sep) in names, mod
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "yocto_raytracing_tpu"), (
                path, mod)


def test_port_runs_without_jax_package(tmp_path):
    """A process where jax and the JAX package cannot be imported imports
    every module of the port, then loads a hair scene from OBJ and renders
    a 32x18 frame on the CPU, and renders the same bits from its GLB
    twin."""
    mods = sorted(
        "yocto_raytracing_tpu_torch." + os.path.relpath(p, PORT_DIR)[:-3]
        .replace(os.sep, ".").removesuffix(".__init__")
        for p in _port_files())
    for mod in ("io.gltf", "animation", "geometry", "procedural"):
        assert f"yocto_raytracing_tpu_torch.{mod}" in mods, mod
    code = textwrap.dedent(f"""
        import importlib, sys
        for blocked in ("jax", "jaxlib", "yocto_raytracing_tpu"):
            sys.modules[blocked] = None
        for m in {mods!r}:
            importlib.import_module(m)
        from yocto_raytracing_tpu_torch import scene, testscenes
        from yocto_raytracing_tpu_torch.render import renderer
        path = {str(tmp_path / "hair.obj")!r}
        scene.save_scene(testscenes.make_hair_scene(64), path)
        img, *_ = renderer.render_scene_file(path, 18, 1, max_depth=2,
                                             device="cpu")
        assert img.shape == (18, 32, 4) and img[..., :3].max() > 0.05
        glb = path[:-4] + ".glb"
        scene.save_scene(scene.load_scene(path), glb)
        again, *_ = renderer.render_scene_file(glb, 18, 1, max_depth=2,
                                               device="cpu")
        assert (again == img).all()
        loaded = sorted(k for k, v in sys.modules.items()
                        if v is not None and k.split(".")[0]
                        in ("jax", "jaxlib", "yocto_raytracing_tpu"))
        assert not loaded, loaded
        print("ok", len({mods!r}))
        """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["ok", str(len(mods))]


def test_native_copy_matches_python_and_jax(tmp_path):
    """The port's own native builder (built into kernels/build/) gives the
    BVH of its numpy builder and of the JAX package's native builder, and
    parses an OBJ as its Python parser does."""
    if tnative.get_lib() is None:
        pytest.skip("no g++ to build the native host runtime")
    assert os.path.dirname(tnative._SRC).endswith(
        os.path.join("kernels", "host"))
    assert os.path.exists(os.path.join(tnative._BUILD, "yrt_native.so"))
    rng = np.random.default_rng(0)
    for n in (1, 5, 64, 1000):
        lo = rng.uniform(-5, 5, size=(n, 3)).astype(np.float32)
        hi = lo + rng.uniform(0, 1, size=(n, 3)).astype(np.float32)
        nat = tnative.build_tree_native(lo, hi)
        for tree in (tbvh._build_tree_python(lo, hi),
                     jbvh._build_tree_python(lo, hi)):
            ref = (tree.bbox_min, tree.bbox_max, tree.start, tree.count,
                   tree.isleaf, tree.leaf_prims, tree.height)
            for a, b in zip(nat, ref):
                np.testing.assert_array_equal(a, b)
    obj = str(tmp_path / "hair.obj")
    tscene.save_scene(tts.make_hair_scene(32), obj)
    a = tobjparser._load_obj_python(obj)
    b = tobjparser._assemble_from_native(obj, *tnative.parse_obj_native(obj))
    assert [s.name for s in a.shapes] == [s.name for s in b.shapes]
    for sa, sb in zip(a.shapes, b.shapes):
        for k in ("pos", "norm", "texcoord", "radius", "points", "lines",
                  "triangles"):
            va, vb = getattr(sa, k), getattr(sb, k)
            assert (va is None) == (vb is None), k
            if va is not None:
                np.testing.assert_array_equal(va, vb, err_msg=k)


@pytest.mark.parametrize("ext", [".hdr", ".png"])
def test_save_hdr_or_ldr_matches_jax(tmp_path, ext):
    rng = np.random.default_rng(2)
    img = np.ones((12, 20, 4), np.float32)
    img[..., :3] = rng.uniform(0, 3, (12, 20, 3)).astype(np.float32)
    a, b = tmp_path / f"jax{ext}", tmp_path / f"port{ext}"
    jimage.save_hdr_or_ldr(str(a), img)
    timage.save_hdr_or_ldr(str(b), img)
    assert a.read_bytes() == b.read_bytes()
    if ext == ".hdr":
        np.testing.assert_array_equal(timage.load_image4f(str(b)),
                                      jimage.load_image4f(str(a)))


def test_entry_points_default_to_the_card(tmp_path, monkeypatch):
    """``render_scene_file`` and ``to_torch`` run on the card unless the
    caller asks for the CPU: without a card, the defaults raise."""
    obj = tmp_path / "grad.obj"
    tscene.save_scene(tts.make_grad_scene(), str(obj))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tren.render_scene_file(str(obj), 16, 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tren.render_scene_file(str(obj), 16, 1, stochastic=True, seed=7,
                               area_lights=True)
    leaves, _ = tscene.build_device_scene(tts.make_grad_scene())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tscene.to_torch(leaves)
    img, *_ = tren.render_scene_file(str(obj), 16, 1, max_depth=2,
                                     stochastic=True, seed=7,
                                     area_lights=True, device="cpu")
    assert img.shape == (16, 16, 4)
