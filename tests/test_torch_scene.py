"""The port's scene layer equals the JAX package's, leaf for leaf.

Both packages build each scene with their own ``testscenes`` and
``build_device_scene``; the flat arrays must be identical (same dtypes, same
values), because every later parity test feeds them to both packages.
Also checks that the port never imports JAX, and imports from the JAX
package only its numpy-only modules.
"""

import ast
import os
from dataclasses import fields

import numpy as np
import pytest
import torch

from yocto_raytracing_tpu import scene as jscene, testscenes as jts
from yocto_raytracing_tpu_torch import scene as tscene, testscenes as tts

PORT_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "yocto_raytracing_tpu_torch")

# the JAX package's modules that import no jax (numpy/ctypes only)
ALLOWED_FROM_JAX_PACKAGE = {
    "yocto_raytracing_tpu.bvh", "yocto_raytracing_tpu.native",
    "yocto_raytracing_tpu.io.objparser", "yocto_raytracing_tpu.io.objwriter",
    "yocto_raytracing_tpu.image", "yocto_raytracing_tpu.io.hdr",
    "yocto_raytracing_tpu.procedural",
}

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
    with pytest.raises(tscene.SceneLoadError, match="not yet ported"):
        path = tmp_path / "x.gltf"
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


def test_port_imports_no_jax():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PORT_DIR)
             for f in fs if f.endswith(".py")]
    assert len(files) >= 10
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib"), (path, mod)
            if top == "yocto_raytracing_tpu":
                assert (mod in ALLOWED_FROM_JAX_PACKAGE
                        or mod.rsplit(".", 1)[0] in ALLOWED_FROM_JAX_PACKAGE
                        or mod in ("yocto_raytracing_tpu",
                                   "yocto_raytracing_tpu.io")), (path, mod)
