"""The port's CUDA kernels against their plain torch versions, on a card.

Every test here needs an NVIDIA GPU and nvcc, and skips without one. The
file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels.py

(``--noconftest``: tests/conftest.py configures JAX for the other tests.)
"""

import numpy as np
import pytest
import torch

from torch_card import cuda_device  # noqa: F401  (fixture)
from yocto_raytracing_tpu_torch import kernels
from yocto_raytracing_tpu_torch import scene as scene_lib, testscenes
from yocto_raytracing_tpu_torch.ops import traverse
from yocto_raytracing_tpu_torch.render import camera, renderer

FLT_MAX = np.float32(3.4028235e38)


def _scene(host, device):
    leaves, meta = scene_lib.build_device_scene(host)
    return scene_lib.to_torch(leaves, device), meta


def _rays(seed, n, device):
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-4, 4, size=(n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return [torch.from_numpy(x).to(device) for x in
            (ro, rd, np.full(n, 1e-4, np.float32),
             np.full(n, FLT_MAX, np.float32))]


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("make", [
    lambda: testscenes.make_random_scene(seed=0),
    lambda: testscenes.make_hair_scene(64),
    lambda: testscenes.make_random_scene(seed=21, n_shapes=2, n_tris=10,
                                         n_lines=0, n_points=2,
                                         n_instances=300),
], ids=["random0", "hair64", "inst300"])
def test_hit_kernel_matches_plain(cuda_device, make, any_hit):
    ts, _ = _scene(make(), cuda_device)
    rays = _rays(5, 8192, cuda_device)
    before = kernels.launches["hit"]
    a = traverse.intersect_scene_plain(ts, *rays, any_hit=any_hit)
    b = traverse.intersect_scene(ts, *rays, any_hit=any_hit)
    assert kernels.launches["hit"] == before + 1
    for k in ("hit", "inst", "prim", "t"):
        np.testing.assert_array_equal(a[k].cpu().numpy(), b[k].cpu().numpy(),
                                      err_msg=k)
    assert int(b["hit"].sum()) > 100


@pytest.mark.cuda
def test_hit_kernel_dead_rays(cuda_device):
    ts, _ = _scene(testscenes.make_hair_scene(64), cuda_device)
    ro, rd, tmin, _ = _rays(9, 1024, cuda_device)
    dead = torch.full_like(tmin, -float(FLT_MAX))
    out = traverse.intersect_scene(ts, ro, rd, tmin, dead)
    assert not bool(out["hit"].any())
    assert bool((out["prim"] == -1).all())


@pytest.mark.cuda
def test_camera_kernel_matches_plain(cuda_device):
    ts, _ = _scene(testscenes.make_hair_scene(64), cuda_device)
    ids = torch.arange(171 * 96 * 9, dtype=torch.int32, device=cuda_device)
    a = camera.camera_rays_plain(ts, ids, 171, 96, 3)
    b = camera.camera_rays(ts, ids, 171, 96, 3)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.cpu().numpy(), y.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("spp", [1, 4, 16])
def test_pixel_kernel_matches_plain(cuda_device, spp):
    g = torch.Generator(device=cuda_device).manual_seed(spp)
    rgb = torch.rand((4096 * spp, 3), device=cuda_device, generator=g) * 1.5
    x = renderer.pixel_finish_plain(rgb, spp, False)
    y = renderer.pixel_finish(rgb, spp, False)
    np.testing.assert_array_equal(x.cpu().numpy(), y.cpu().numpy())
    x = renderer.pixel_finish_plain(rgb, spp, True).cpu().numpy()
    y = renderer.pixel_finish(rgb, spp, True).cpu().numpy()
    assert np.abs(x.astype(np.int32) - y).max() <= 1


@pytest.mark.cuda
def test_wrappers_reject_bad_arguments(cuda_device):
    ts, _ = _scene(testscenes.make_grad_scene(), cuda_device)
    ro, rd, tmin, tmax = _rays(1, 64, cuda_device)
    with pytest.raises(ValueError, match="dtype"):
        traverse.intersect_scene(ts, ro.double(), rd, tmin, tmax)
    with pytest.raises(ValueError, match="contiguous"):
        traverse.intersect_scene(ts, ro.t().contiguous().t(), rd, tmin, tmax)
    with pytest.raises(ValueError, match="whole pixels"):
        renderer.pixel_finish(torch.zeros((10, 3), device=cuda_device), 4,
                              False)
