"""The port's CUDA kernels against their plain torch versions, on a card.

K1-K3 bit-equal (K3's u8 within 1 step); K4 (shading) bit-equal to the
plain shading on the same K1 hits and shadow query; K5 (shading backward)
and K6 (camera backward) within relative L2 error 1e-4 per leaf of torch
autograd of the plain versions (the leaf gradients are atomic or
reordered sums); a training step through the kernels: loss equal to the
plain path's (rtol 1e-5), gradient within 1e-4 of the f64 reference (the
plain path in f64 on the same hits; 1.25x the plain f32 path's own error
where that is larger), update ``d - lr * g``.

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
from yocto_raytracing_tpu_torch.kernels import parity
from yocto_raytracing_tpu_torch.ops import traverse
from yocto_raytracing_tpu_torch.parallel import mesh
from yocto_raytracing_tpu_torch.render import camera, renderer, shade

FLT_MAX = np.float32(3.4028235e38)
GRAD_RTOL = 1e-4


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
    hits = traverse.intersect_scene(ts, ro, rd, tmin, tmax)
    amb = torch.full((3,), 0.1, device=cuda_device)
    active = torch.ones(64, dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError, match="dtype"):
        shade.shade_step(ts, ro, rd.double(), hits, amb, active,
                         parity.occluder(ts))


# (scene, width, height, samples, bounce)
SHADE_CASES = {
    "hair64": (lambda: testscenes.make_hair_scene(64), 96, 54, 2, 1),
    "mirror_bounce2": (testscenes.make_grad_scene, 64, 64, 2, 2),
    "textured": (lambda: testscenes.make_textured_hair_scene(64), 96, 54, 2,
                 1),
}


def _shade_case(name, device):
    make, w, h, s, bounce = SHADE_CASES[name]
    ts, meta = _scene(make(), device)
    ids = torch.arange(w * h * s * s, dtype=torch.int32, device=device)
    amb = torch.full((3,), 0.1, device=device)
    return ts, meta, amb, parity.shade_inputs(ts, ids, w, h, s, bounce, amb)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SHADE_CASES))
def test_shade_kernel_matches_plain(cuda_device, name):
    ts, meta, amb, inputs = _shade_case(name, cuda_device)
    before = kernels.launches["shade"]
    rep = parity.compare_shade(ts, inputs, amb, meta.has_kd_textures,
                               meta.has_ks_textures)
    assert kernels.launches["shade"] == before + 1
    assert rep["mask_equal"] and rep["hits"] > 100
    for out in parity.SHADE_OUTPUTS:
        assert rep[out] == 0, (out, rep)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SHADE_CASES))
def test_shade_bwd_matches_autograd(cuda_device, name):
    ts, meta, amb, inputs = _shade_case(name, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    before = kernels.launches["shade_bwd"]
    rep = parity.compare_shade_grads(ts, inputs, amb, gen,
                                     meta.has_kd_textures,
                                     meta.has_ks_textures)
    assert kernels.launches["shade_bwd"] == before + 1
    parity.check_grads(rep, GRAD_RTOL, name)
    for leaf in ("ro", "rd", "pos", "inst_axes", "mat_kd", "light_ke"):
        assert rep[leaf]["norm"] > 0, leaf
    if name == "textured":
        assert rep["texcoord"]["norm"] > 0


@pytest.mark.cuda
def test_camera_bwd_matches_autograd(cuda_device):
    ts, _ = _scene(testscenes.make_hair_scene(64), cuda_device)
    ids = torch.arange(171 * 96 * 9, dtype=torch.int32, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    before = kernels.launches["camera_bwd"]
    rep = parity.compare_camera_grads(ts, ids, 171, 96, 3, gen)
    assert kernels.launches["camera_bwd"] == before + 1
    parity.check_grads({k: v for k, v in rep.items() if k != "cam_focus"},
                       GRAD_RTOL, "K6")
    # d_focus is zero up to rounding (directions do not depend on focus)
    assert rep["cam_focus"]["max_abs"] <= 1e-5 * rep["cam_axes"]["norm"]


@pytest.mark.cuda
def test_train_step_matches_plain(cuda_device):
    ts, _ = _scene(testscenes.make_grad_scene(), cuda_device)
    w = h = 32
    ids = torch.arange(w * h, dtype=torch.int32, device=cuda_device)
    amb = torch.full((3,), 0.1, device=cuda_device)
    target = torch.rand((w * h, 3), device=cuda_device,
                        generator=torch.Generator(
                            device=cuda_device).manual_seed(1))
    kw = dict(width=w, height=h, samples=1, max_depth=3)
    kernels.reset_launches()
    new_k, loss_k = mesh.train_step(ts, ids, target, amb, 0.1, **kw)
    assert all(kernels.launches[k] > 0 for k in ("camera_rays", "hit",
                                                 "shade", "shade_bwd",
                                                 "camera_bwd"))
    rep = parity.compare_loss_grads(ts, ids, target, amb, **kw)
    np.testing.assert_allclose(rep["plain_loss"], float(loss_k), rtol=1e-5)
    np.testing.assert_allclose(rep["loss"], float(loss_k), rtol=1e-5)
    parity.check_grads(rep["kernel"],
                       parity.loss_grad_bounds(rep, GRAD_RTOL, 1.25),
                       "train step gradient")
    assert rep["kernel"]["mat_kr"]["norm"] > 0
    parity.check_update(ts, new_k, rep["grads"], 0.1, "train step")
