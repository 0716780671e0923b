"""Port's plain hit query == the JAX package's ops/traverse.py.

Same scene leaves (``from_jax_arrays``) and the same seeded rays go to both.
The contract is tests/test_stream.py's ``_assert_equal``: ``hit`` equal,
``t`` within 1 ULP, ``inst``/``prim`` equal wherever ``t`` is bit-equal.
The JAX walk runs jitted in a child process whose XLA:CPU emits no FMA
(tests/jax_nofma.py), so it rounds every operation like the port.

The CUDA kernel K1 is held against this plain version on the card by
chip_smoke.py and tests/test_torch_kernels.py.
"""

from dataclasses import fields

import numpy as np
import pytest
import torch

import jax_nofma
from yocto_raytracing_tpu import scene as jscene, testscenes as jts
from yocto_raytracing_tpu_torch import scene as tscene
from yocto_raytracing_tpu_torch.ops import traverse as ttrav

FLT_MAX = np.float32(3.4028235e38)


def _leaves(scene_fn, kwargs):
    jd, _ = jscene.build_device_scene(getattr(jts, scene_fn)(**kwargs))
    return {f.name: np.asarray(getattr(jd, f.name))
            for f in fields(jscene.DeviceScene)}


def _rays(seed, n):
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-4, 4, size=(n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return (ro, rd, np.full(n, 1e-4, np.float32),
            np.full(n, FLT_MAX, np.float32))


def _torch_hits(leaves, rays, any_hit=False, device="cpu"):
    ts = tscene.from_jax_arrays(leaves, device)
    out = ttrav.intersect_scene(
        ts, *(torch.from_numpy(x).to(device) for x in rays), any_hit=any_hit)
    return {k: v.cpu().numpy() for k, v in out.items()}


def assert_hits_equal(a, b):
    """tests/test_stream.py's _assert_equal contract."""
    np.testing.assert_array_equal(a["hit"], b["hit"], err_msg="hit")
    ta, tb = a["t"], b["t"]
    ulp = np.abs(ta.view(np.int32).astype(np.int64) - tb.view(np.int32))
    assert ulp.max() <= 1, f"t ULP diff {ulp.max()} at {ulp.argmax()}"
    exact = ta == tb
    for k in ("inst", "prim"):
        np.testing.assert_array_equal(a[k][exact], b[k][exact], err_msg=k)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_scenes(seed):
    scene = ("make_random_scene", dict(seed=seed))
    rays = _rays(seed + 10, 512)
    a = jax_nofma.hits(*scene, rays)
    assert_hits_equal(a, _torch_hits(_leaves(*scene), rays))
    assert a["hit"].sum() > 20


def test_hair_scene():
    scene = ("make_hair_scene", dict(n_strands=64))
    rays = _rays(5, 512)
    a = jax_nofma.hits(*scene, rays)
    assert_hits_equal(a, _torch_hits(_leaves(*scene), rays))
    assert a["hit"].sum() > 20


def test_any_hit():
    scene = ("make_random_scene", dict(seed=7))
    rays = _rays(8, 512)
    a = jax_nofma.hits(*scene, rays, any_hit=True)
    b = _torch_hits(_leaves(*scene), rays, any_hit=True)
    np.testing.assert_array_equal(a["hit"], b["hit"])
    assert a["hit"].sum() > 20


def test_300_instance_scene():
    """The 300-instance scene of __graft_entry__.py (instance-heavy BVH)."""
    scene = ("make_random_scene", dict(seed=21, n_shapes=2, n_tris=10,
                                       n_lines=0, n_points=2,
                                       n_instances=300))
    rays = _rays(22, 512)
    a = jax_nofma.hits(*scene, rays)
    assert_hits_equal(a, _torch_hits(_leaves(*scene), rays))
    assert a["hit"].sum() > 20


def test_dead_rays_hit_nothing():
    leaves = _leaves("make_hair_scene", dict(n_strands=64))
    ro, rd, tmin, _ = _rays(9, 256)
    dead = np.full(256, -FLT_MAX, np.float32)
    for any_hit in (False, True):
        b = _torch_hits(leaves, (ro, rd, tmin, dead), any_hit=any_hit)
        assert not b["hit"].any()
        assert (b["inst"] == -1).all() and (b["prim"] == -1).all()
        np.testing.assert_array_equal(b["t"], dead)

