"""The port's CUDA kernels against their plain torch versions, on a card.

K1-K3 bit-equal (K3's u8 within 1 step, also on partial blocks, views at
a 12-byte offset and 4,900 spp; its RGBA equal to plain's at 16 spp, alone
and at a frame buffer's chunk rows; K1 also on dead, NaN-tmax and
partial batches, the 10,004-instance scene, equal-t ties, axis-parallel and
NaN directions, identity instance frames beside frames a bit away from
them, and after a training step); K4 (shading)
bit-equal to the plain shading and to its first form (``shade_simple.cu``)
on the same K1 hits and shadow query; K5 (shading backward) and K6 (camera
backward) within relative L2 error 1e-4 per leaf of torch autograd of the
plain versions (the leaf gradients are atomic or reordered sums), K5 also
of its first form (``shade_bwd_simple.cu``), with every lane of a warp on
one prim, 4 prims in runs and 3 interleaved, with dead warps, dead blocks
and a ragged tail, and with light gradients bit-identical over two runs; a training step through the kernels: loss equal
to the plain path's (rtol 1e-5), gradient within 1e-4 of the f64 reference
(the plain path in f64 on the same hits; 1.25x the plain f32 path's own
error where that is larger), update ``d - lr * g``; K7 (stochastic camera
rays), K8 (area-light points) and K4 with per-ray light positions
bit-equal to their plain versions, and a stochastic area-light frame
through them within 1 u8 step of the all-plain path; the reverses of the
stochastic modes, K5 with per-ray light positions, K9 (thin-lens rays)
and K10 (light points), within 1e-4 of torch autograd of their plain
versions; K6 and K9 bit-equal to ``camera.ordered_camera_sums`` of their
plain per-ray terms computed on the card (1 to 2^20 + 3 rays), within 1e-4
of their first forms (``camera_bwd_simple.cu``), the same bits from launch
to launch (also after a launch of no ray or of another batch), and K9's 15
shared sums at aperture 0 bit-equal to K6's on the same uv; K8 also bit-equal to its first
form (``lights_simple.cu``) and K10 within 1 ULP of the explicit f64
reverse and 1e-4 of its first form, bit-identical over two runs where
every light spans at most 8 vertices, with 1, 2 and 8 lights, shared
shapes, a deg light and lamp panels of 81 and 1,089 vertices, and on the
adversarial CDF rows of ``light_pick_rows`` (NaN, inf and zero weights,
ties, x on an entry), staged and not; and the
stochastic training
gradient against its f64 reference; K11 (refit and culled walk) bit for
bit equal to the brute-force plain query, the plain walk and its first
form ``overlap_simple.cu``, on moved ``pos`` and duplicated prims too, its
wrapper synchronising no host, and its refit kernel word for word equal to
the plain refit;
``train_step_sharded`` in a one-rank NCCL group equal to ``train_step``,
and the CLI on the card writing the host tonemap of ``render_image`` (also
checkpointed and resumed, and ``--sharded``); the device loop: K12
bit-equal to ``bounce_update_plain`` with and without a zero alive word,
K1 and K4 under a zero alive word leaving their outputs as they were, the
frame of ``frame_device`` (a CUDA graph of a chunk, replayed) bit-equal
to the eager loop's in f32 sums and u8 on the hair, mirror, area hair and
area mirror frames with its launch counts the eager loop's plus its dead
bounces' launches, and two ``render_image`` calls the same bits; the
training step's device loop: K12's out-of-place form bit-equal to its
in-place one, K14 bit-equal to ``bounce_update_bwd_plain``,
``loss_grads_device`` (a miss and a hit) on the mirror and mirror-pair
scenes with the first form's loss bits and gradients within 1e-5 of its
first form's, launching nothing in a dead bounce, ``train_step``'s update
``d - lr * g`` of that gradient and its gradient within the f64 contract,
and a hit of ``train_step`` under ``set_sync_debug_mode("error")``
keeping its graph and the reserved memory.

Every test here needs an NVIDIA GPU and nvcc, and skips without one. The
file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels.py

(``--noconftest``: tests/conftest.py configures JAX for the other tests.)
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import light_pick_rows
from bounce_states import random_bounce
from torch_card import cuda_device  # noqa: F401  (fixture)
from yocto_raytracing_tpu_torch import kernels
from yocto_raytracing_tpu_torch import scene as scene_lib, testscenes
from yocto_raytracing_tpu_torch.kernels import parity
from yocto_raytracing_tpu_torch.ops import traverse
from yocto_raytracing_tpu_torch.parallel import mesh
from yocto_raytracing_tpu_torch.render import camera, lights, renderer, shade
from yocto_raytracing_tpu_torch.utils import tracer

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


def _tie_rays(ts, seed, n, device):
    """Rays aimed exactly at vertices and edge midpoints of the scene's
    triangles (identity instances), where neighbouring triangles accept
    the same t and the last accepted one must win."""
    rng = np.random.default_rng(seed)
    pos = ts.pos.cpu().numpy()
    tri = ts.prim_v.cpu().numpy()[ts.prim_type.cpu().numpy() == 2]
    pick = tri[rng.integers(0, len(tri), n)]
    k = rng.integers(0, 3, n)
    a = pos[pick[np.arange(n), k]]
    b = pos[pick[np.arange(n), (k + 1) % 3]]
    aim = np.where((np.arange(n) % 2 == 0)[:, None], a,
                   (a + b) * np.float32(0.5)).astype(np.float32)
    ro = (aim + rng.normal(size=(n, 3)) * 3).astype(np.float32)
    rd = aim - ro
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return [torch.from_numpy(x).to(device) for x in
            (ro, rd, np.full(n, 1e-4, np.float32),
             np.full(n, FLT_MAX, np.float32))]


def _axis_rays(ts, seed, n, device):
    """Axis-parallel rays from points on node bounding planes (a slab bound
    of 0 * inf = NaN) aimed at the scene, and every 16th ray with a NaN
    direction component."""
    rng = np.random.default_rng(seed)
    lo = ts.node_bbox_min.cpu().numpy()
    hi = ts.node_bbox_max.cpu().numpy()
    node = rng.integers(0, len(lo), n)
    ro = np.where(rng.random((n, 3)) < 0.5, lo[node], hi[node])
    axis = rng.integers(0, 3, n)
    rd = np.zeros((n, 3), np.float32)
    rd[np.arange(n), axis] = np.where(rng.random(n) < 0.5, 1.0, -1.0)
    rd[::16, 1] = np.nan
    return [torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)
            for x in (ro, rd, np.full(n, 1e-4), np.full(n, FLT_MAX))]


# (scene, rays): the scenes of the CPU traversal tests and the 10,004-
# instance scene on 8,192 random rays; half the lanes dead, interleaved;
# batches that fill no warp or block; every third lane with a NaN tmax;
# rays on shared edges and vertices; axis-parallel rays on slab planes and
# NaN directions; identity instance frames, which K1 enters on the world
# ray, beside frames a bit away from them (a -0.0 origin, axis words 1 ulp
# off 1.0 and +0.0, a -0.0 axis word) and rotated ones, on random rays and
# on rays at shared edges and vertices
HIT_CASES = {
    "random0": (lambda: testscenes.make_random_scene(seed=0), 8192),
    "hair64": (lambda: testscenes.make_hair_scene(64), 8192),
    "inst300": (lambda: testscenes.make_random_scene(
        seed=21, n_shapes=2, n_tris=10, n_lines=0, n_points=2,
        n_instances=300), 8192),
    "inst10004": (lambda: testscenes.make_random_scene(n_instances=10004),
                  8192),
    "half_dead": (lambda: testscenes.make_hair_scene(64), "half_dead"),
    "n1": (lambda: testscenes.make_random_scene(seed=0), 1),
    "n33": (lambda: testscenes.make_random_scene(seed=0), 33),
    "n8191": (lambda: testscenes.make_random_scene(seed=0), 8191),
    "nan_tmax": (lambda: testscenes.make_hair_scene(64), "nan_tmax"),
    "ties": (lambda: testscenes.make_hair_scene(64), "ties"),
    "axis_nan": (lambda: testscenes.make_hair_scene(64), "axis_nan"),
    "mixed_frames": (testscenes.make_mixed_frame_scene, 8192),
    "mixed_ties": (testscenes.make_mixed_frame_scene, "ties"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("case", list(HIT_CASES))
def test_hit_kernel_matches_plain(cuda_device, case, any_hit):
    make, rays = HIT_CASES[case]
    ts, _ = _scene(make(), cuda_device)
    if rays == "ties":
        rays = _tie_rays(ts, 6, 8192, cuda_device)
    elif rays == "axis_nan":
        rays = _axis_rays(ts, 7, 8192, cuda_device)
    elif rays == "half_dead":
        rays = _rays(5, 8192, cuda_device)
        rays[3][1::2] = -float(FLT_MAX)
    elif rays == "nan_tmax":
        rays = _rays(7, 8191, cuda_device)
        rays[3][::3] = float("nan")
    else:
        rays = _rays(5, rays, cuda_device)
    before = dict(kernels.launches)
    a = traverse.intersect_scene_plain(ts, *rays, any_hit=any_hit)
    b = traverse.intersect_scene(ts, *rays, any_hit=any_hit)
    assert kernels.launches["hit"] == before["hit"] + 1
    assert kernels.launches["hit_any"] == before["hit_any"] + int(any_hit)
    for k in ("hit", "inst", "prim", "t"):
        np.testing.assert_array_equal(a[k].cpu().numpy(), b[k].cpu().numpy(),
                                      err_msg=k)
    if rays[0].shape[0] >= 8191:
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
def test_hit_kernel_after_train_step(cuda_device):
    """K1 on the scene that ``train_step`` returns equals the plain walk on
    it: the records are packed from the new leaves, never stale ones."""
    ts, _ = _scene(testscenes.make_hair_scene(64), cuda_device)
    w, h, samples = 64, 48, 1
    ids = torch.arange(w * h, dtype=torch.int32, device=cuda_device)
    amb = torch.full((3,), 0.1, device=cuda_device)
    target = renderer.trace_rays(ts, ids, amb, w, h, samples, 2) * 0.5
    new, _ = mesh.train_step(ts, ids, target, amb, 10.0, width=w, height=h,
                             samples=samples, max_depth=2,
                             trainable=("pos",))
    assert not torch.equal(new.pos, ts.pos)
    rays = _rays(8, 8192, cuda_device)
    for any_hit in (False, True):
        a = traverse.intersect_scene_plain(new, *rays, any_hit=any_hit)
        b = traverse.intersect_scene(new, *rays, any_hit=any_hit)
        for k in ("hit", "inst", "prim", "t"):
            np.testing.assert_array_equal(
                a[k].cpu().numpy(), b[k].cpu().numpy(), err_msg=k)
    # and the frame after the step within 1 u8 step of the all-plain path
    x = renderer.trace_rays(new, ids, amb, w, h, samples, 2)
    y = renderer.trace_rays(new, ids, amb, w, h, samples, 2, plain=True)
    x, y = (renderer.pixel_finish_plain(v, 1, True).cpu().numpy().astype(
        np.int32) for v in (x, y))
    assert np.abs(x - y).max() <= 1


@pytest.mark.cuda
def test_camera_kernel_matches_plain(cuda_device):
    ts, _ = _scene(testscenes.make_hair_scene(64), cuda_device)
    ids = torch.arange(171 * 96 * 9, dtype=torch.int32, device=cuda_device)
    a = camera.camera_rays_plain(ts, ids, 171, 96, 3)
    b = camera.camera_rays(ts, ids, 171, 96, 3)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.cpu().numpy(), y.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("spp", [1, 4, 9, 16, 4900])
def test_pixel_kernel_matches_plain(cuda_device, spp):
    """K3 against plain (sums bit-equal, u8 within 1 step) at pixel counts
    that leave a partial block, on views at a 12-byte offset, and at the
    4,900 spp of ``--samples 70``."""
    g = torch.Generator(device=cuda_device).manual_seed(spp)
    cases = ((4096, 0), (4093, 1), (1000, 1), (3, 0), (37, 1))
    for npix, offset in cases if spp < 100 else cases[3:]:
        # some negative samples: the tonemap's max(x, 0)
        big = torch.rand(((npix + 1) * spp, 3), device=cuda_device,
                         generator=g) * 1.5 - 0.2
        rgb = big[offset:offset + npix * spp]
        x = renderer.pixel_finish_plain(rgb, spp, False)
        y = renderer.pixel_finish(rgb, spp, False)
        assert torch.equal(x, y), (npix, offset)
        x = renderer.pixel_finish_plain(rgb, spp, True)
        y = renderer.pixel_finish(rgb, spp, True)
        assert y.shape == (npix, 4) and (y[:, 3] == 255).all()
        assert (x.int() - y.int()).abs().max() <= 1, (npix, offset)


@pytest.mark.cuda
def test_pixel_kernel_rgba_in_a_frame_buffer(cuda_device):
    """K3's LDR RGBA (one 4-byte store a pixel, alpha 255) equals the plain
    version's, launched alone and into a frame buffer at a chunk's rows (the
    other rows untouched); a misaligned buffer is refused; the device
    loop's RGBA frame is the eager loop's."""
    g = torch.Generator(device=cuda_device).manual_seed(20)
    npix, spp = 3001, 16
    rgb = torch.rand((npix * spp, 3), device=cuda_device,
                     generator=g) * 1.5 - 0.2
    plain = renderer.pixel_finish_plain(rgb, spp, True)
    alone = renderer.pixel_finish(rgb, spp, True)
    assert torch.equal(alone, plain)
    out = torch.zeros((3 * npix, 4), dtype=torch.uint8, device=cuda_device)
    chunk = torch.tensor([1], dtype=torch.int32, device=cuda_device)
    assert renderer.pixel_finish(rgb, spp, True, out=out, chunk=chunk) is out
    assert torch.equal(out[npix:2 * npix], plain)
    assert not out[:npix].any() and not out[2 * npix:].any()
    flat = torch.zeros(3 * npix * 4 + 1, dtype=torch.uint8,
                       device=cuda_device)
    with pytest.raises(ValueError, match="aligned"):
        renderer.pixel_finish(rgb, spp, True, out=flat[1:].view(-1, 4),
                              chunk=chunk)
    ts, meta, kw = _loop_case("mirror", cuda_device)
    npix = LOOP_W * LOOP_H
    eager = renderer.frame_eager(ts, meta, LOOP_W, LOOP_H, 2, ldr=True, **kw)
    dev = renderer.frame_device(ts, meta, LOOP_W, LOOP_H, 2, ldr=True, **kw)
    assert dev.shape[1] == 4 and eager.shape == (npix, 4)
    assert np.array_equal(dev[:npix].cpu().numpy(), eager)
    assert (eager[:, 3] == 255).all()


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
@pytest.mark.parametrize("name", list(SHADE_CASES))
def test_shade_kernel_matches_simple(cuda_device, name):
    """K4 on the shade records bit-equal to its first form on the scene's
    arrays (``shade_simple.cu``) and to the plain shading."""
    ts, meta, amb, inputs = _shade_case(name, cuda_device)
    rep = parity.compare_shade(ts, inputs, amb, meta.has_kd_textures,
                               meta.has_ks_textures)
    assert rep["mask_equal"] and rep["hits"] > 100
    for out in parity.SHADE_OUTPUTS:
        assert rep["simple"][out] == 0 and rep[out] == 0, (out, rep)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SHADE_CASES))
def test_shade_bwd_matches_simple(cuda_device, name):
    """K5 within 1e-4 relative L2 of its first form
    (``shade_bwd_simple.cu``) on every leaf, d_ro and d_rd."""
    ts, meta, amb, inputs = _shade_case(name, cuda_device)
    saved = parity.shade_bwd_inputs(ts, inputs, amb, meta.has_kd_textures,
                                    meta.has_ks_textures)
    gen = torch.Generator(device=cuda_device).manual_seed(13)
    rep = parity.compare_shade_bwd_simple(ts, saved, gen)
    parity.check_grads(rep, GRAD_RTOL, f"K5 {name} vs first form")
    for leaf in ("ro", "rd", "pos", "inst_axes", "mat_kd", "light_ke"):
        assert rep[leaf]["norm"] > 0, leaf


def _retopologized(inputs, pairs):
    """``inputs`` with every ray live and lane i of each warp given the hit
    topology ``pairs[i % 32]`` ((inst, prim) from the bounce's own hits):
    the sums of K5 then fall on the rows those pairs name."""
    ro, rd, hits, active = inputs
    n = ro.shape[0]
    lane = torch.arange(n, device=ro.device) % 32
    inst = torch.tensor([p[0] for p in pairs], dtype=torch.int32,
                        device=ro.device)[lane]
    prim = torch.tensor([p[1] for p in pairs], dtype=torch.int32,
                        device=ro.device)[lane]
    hits = dict(hits, hit=torch.ones_like(hits["hit"]), inst=inst, prim=prim)
    return ro, rd, hits, torch.ones_like(active)


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["one_prim", "four_runs", "interleaved"])
def test_shade_bwd_contention(cuda_device, pattern):
    """Every lane of every warp on one prim, then 4 prims a warp in runs of
    8 lanes, then 3 prims interleaved lane by lane (runs of one): K5
    within 1e-4 of torch autograd of the plain version and of its first
    form."""
    ts, meta, amb, inputs = _shade_case("hair64", cuda_device)
    _, _, hits, active = inputs
    live = (active & hits["hit"]).nonzero().flatten()
    pairs = {(int(hits["inst"][i]), int(hits["prim"][i]))
             for i in live[:: max(1, live.numel() // 64)].tolist()}
    pairs = sorted(pairs)
    assert len(pairs) >= 4
    lanes = {"one_prim": [pairs[0]] * 32,
             "four_runs": [pairs[k // 8] for k in range(32)],
             "interleaved": [pairs[k % 3] for k in range(32)]}[pattern]
    inputs = _retopologized(inputs, lanes)
    gen = torch.Generator(device=cuda_device).manual_seed(21)
    rep = parity.compare_shade_grads(ts, inputs, amb, gen,
                                     meta.has_kd_textures,
                                     meta.has_ks_textures)
    parity.check_grads(rep, GRAD_RTOL, f"K5 {pattern}")
    assert rep["pos"]["norm"] > 0 and rep["inst_axes"]["norm"] > 0
    saved = parity.shade_bwd_inputs(ts, inputs, amb, meta.has_kd_textures,
                                    meta.has_ks_textures)
    parity.check_grads(parity.compare_shade_bwd_simple(ts, saved, gen),
                       GRAD_RTOL, f"K5 {pattern} vs first form")


@pytest.mark.cuda
def test_shade_bwd_dead_warps(cuda_device):
    """Whole dead warps, whole dead blocks of 128 rays, partly dead warps
    and a ragged tail (n not a multiple of 32): K5 within 1e-4 of torch
    autograd of the plain version, exact zeros on every dead lane; a batch
    with no live ray gives zeros everywhere."""
    ts, meta, amb, inputs = _shade_case("hair64", cuda_device)
    ro, rd, hits, active = inputs
    n = ro.shape[0] - 37
    i = torch.arange(n, device=cuda_device)
    keep = ~(((i // 32) % 3 == 0) | ((i // 128) % 5 == 1)
             | (((i // 32) % 7 == 2) & (i % 32 < 11)))
    cut = (ro[:n].contiguous(), rd[:n].contiguous(),
           {k: v[:n].contiguous() for k, v in hits.items()},
           (active[:n] & keep).contiguous())
    gen = torch.Generator(device=cuda_device).manual_seed(22)
    rep = parity.compare_shade_grads(ts, cut, amb, gen,
                                     meta.has_kd_textures,
                                     meta.has_ks_textures)
    parity.check_grads(rep, GRAD_RTOL, "K5 dead warps")
    dead = (cut[3] & cut[2]["hit"]).logical_not()
    saved = parity.shade_bwd_inputs(ts, cut, amb, meta.has_kd_textures,
                                    meta.has_ks_textures)
    got = parity.bwd_grads(shade.shade_step_bwd, ts, saved,
                           parity.shade_bwd_cotangents(saved, gen))
    assert bool(dead.any())
    for k in ("ro", "rd"):
        assert bool((got[k][dead] == 0).all()), k
    none = dict(saved, mask=torch.zeros_like(saved["mask"]))
    got = parity.bwd_grads(shade.shade_step_bwd, ts, none,
                           parity.shade_bwd_cotangents(none, gen))
    for k, v in got.items():
        assert not bool(v.any()), k


@pytest.mark.cuda
def test_shade_bwd_many_instances(cuda_device):
    """300 instances (3,600 instance values, past the rows that K5 sums
    per block into its scratch: it adds them with atomics) and no light:
    K5 within 1e-4 of torch autograd of the plain version and of its first
    form."""
    ts, meta = _scene(testscenes.make_random_scene(
        seed=21, n_shapes=2, n_tris=10, n_lines=0, n_points=2,
        n_instances=300), cuda_device)
    assert ts.inst_axes.shape[0] * 12 > 1024 and ts.light_ke.shape[0] == 0
    ids = torch.arange(128 * 128, dtype=torch.int32, device=cuda_device)
    amb = torch.full((3,), 0.1, device=cuda_device)
    inputs = parity.shade_inputs(ts, ids, 128, 128, 1, 1, amb)
    gen = torch.Generator(device=cuda_device).manual_seed(25)
    rep = parity.compare_shade_grads(ts, inputs, amb, gen,
                                     meta.has_kd_textures,
                                     meta.has_ks_textures)
    parity.check_grads(rep, GRAD_RTOL, "K5 300 instances")
    assert rep["inst_axes"]["norm"] > 0 and rep["pos"]["norm"] > 0
    saved = parity.shade_bwd_inputs(ts, inputs, amb, meta.has_kd_textures,
                                    meta.has_ks_textures)
    parity.check_grads(parity.compare_shade_bwd_simple(ts, saved, gen),
                       GRAD_RTOL, "K5 300 instances vs first form")


@pytest.mark.cuda
def test_shade_bwd_per_ray_lights_matches_simple(cuda_device):
    """K5 with per-ray light positions within 1e-4 of its first form,
    the (L, N, 3) light positions' gradient included."""
    ts, meta, sampler = _area_case(cuda_device)
    ids = torch.arange(64 * 64 * 4, dtype=torch.int32, device=cuda_device)
    amb = torch.full((3,), 0.1, device=cuda_device)
    inputs = parity.shade_inputs(ts, ids, 64, 64, 2, 1, amb)
    lpos = lights.sample_light_points(ts, sampler, ids, 3)
    saved = parity.shade_bwd_inputs(ts, inputs, amb, meta.has_kd_textures,
                                    meta.has_ks_textures, lpos)
    gen = torch.Generator(device=cuda_device).manual_seed(23)
    rep = parity.compare_shade_bwd_simple(ts, saved, gen)
    parity.check_grads(rep, GRAD_RTOL, "K5 per-ray lights vs first form")
    assert rep["light_pos_ray"]["norm"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("per_ray", [False, True], ids=["fixed", "per_ray"])
def test_shade_bwd_light_grads_deterministic(cuda_device, per_ray):
    """The light leaves' gradients are summed per block, then in a fixed
    order: two runs give the same bits."""
    ts, meta, sampler = _area_case(cuda_device)
    ids = torch.arange(64 * 64 * 4, dtype=torch.int32, device=cuda_device)
    amb = torch.full((3,), 0.1, device=cuda_device)
    inputs = parity.shade_inputs(ts, ids, 64, 64, 2, 1, amb)
    lpos = lights.sample_light_points(ts, sampler, ids, 3) if per_ray \
        else None
    saved = parity.shade_bwd_inputs(ts, inputs, amb, meta.has_kd_textures,
                                    meta.has_ks_textures, lpos)
    gen = torch.Generator(device=cuda_device).manual_seed(24)
    cots = parity.shade_bwd_cotangents(saved, gen)
    a, b = (parity.bwd_grads(shade.shade_step_bwd, ts, saved, cots)
            for _ in range(2))
    for k in ("light_pos", "light_axes", "light_o", "light_ke"):
        assert torch.equal(a[k], b[k]), k
    assert a["light_ke"].abs().sum() > 0


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
                                                 "camera_bwd", "bounce",
                                                 "bounce_bwd", "records"))
    # the step's device loop gives its gradient without the update
    loss_d, out = renderer.loss_grads_device(ts, ids, target, amb, w, h, 1,
                                             3)
    grads = {n: g for n, g in zip(scene_lib.LEAF_NAMES, out)
             if g is not None}
    rep = parity.compare_loss_grads(ts, ids, target, amb,
                                    also=dict(device=grads), **kw)
    np.testing.assert_allclose(rep["plain_loss"], float(loss_k), rtol=1e-5)
    # the forward is the eager loop's arithmetic: the loss's bits
    assert rep["loss"] == float(loss_k) == float(loss_d)
    bounds = parity.loss_grad_bounds(rep, GRAD_RTOL, 1.25)
    parity.check_grads(rep["kernel"], bounds, "train step gradient")
    parity.check_grads(rep["device"], bounds, "device loop gradient")
    assert rep["device"]["mat_kr"]["norm"] > 0
    parity.check_update(ts, new_k, grads, 0.1, "train step")


def _area_grad_scene(aperture=0.0):
    """The mirror scene with its point light an emissive 1 m quad (two
    triangles) facing down, and the camera's aperture set."""
    host = testscenes.make_grad_scene()
    ist = next(i for i in host.instances if i.name == "light")
    shp = host.shapes[ist.shape]
    c = shp.pos[0]
    shp.pos = np.asarray([c + [-0.5, 0, -0.5], c + [0.5, 0, -0.5],
                          c + [0.5, 0, 0.5], c + [-0.5, 0, 0.5]], np.float32)
    shp.points = np.zeros(0, np.int32)
    shp.triangles = np.asarray([[0, 2, 1], [0, 3, 2]], np.int32)
    shp.norm = np.zeros((0, 3), np.float32)
    shp.texcoord = np.zeros((4, 2), np.float32)
    shp.radius = np.zeros(0, np.float32)
    host.cameras[0].aperture = aperture
    scene_lib.finalize_scene(host)
    return host


def _area_case(device, aperture=0.0):
    host = _area_grad_scene(aperture)
    leaves, meta = scene_lib.build_device_scene(host)
    ts = scene_lib.to_torch(leaves, device)
    return ts, meta, lights.build_light_sampler(host, leaves, meta, device)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 7, 2**32 - 1])
def test_stochastic_camera_kernel_matches_plain(cuda_device, seed):
    ts, _, _ = _area_case(cuda_device, aperture=0.3)
    ids = torch.arange(171 * 96 * 9, dtype=torch.int32, device=cuda_device)
    before = kernels.launches["camera_rays_stochastic"]
    rep = parity.compare_camera_stochastic(ts, ids, 171, 96, 3, seed)
    assert kernels.launches["camera_rays_stochastic"] == before + 1
    assert rep["uv"] == rep["ro"] == rep["rd"] == 0, rep


@pytest.mark.cuda
def test_stochastic_camera_zero_aperture_is_pinhole(cuda_device):
    ts, _, _ = _area_case(cuda_device, aperture=0.0)
    ids = torch.arange(64 * 64 * 4, dtype=torch.int32, device=cuda_device)
    uv, ro, rd = camera.camera_rays_stochastic(ts, ids, 64, 64, 2, 5)
    ro0, rd0 = camera.eval_camera(ts, uv)
    np.testing.assert_array_equal(ro.cpu().numpy(), ro0.cpu().numpy())
    np.testing.assert_array_equal(rd.cpu().numpy(), rd0.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("deg", [False, True], ids=["sampled", "deg"])
def test_light_points_kernel_matches_plain(cuda_device, deg):
    ts, _, sampler = _area_case(cuda_device)
    if deg:
        sampler = dict(sampler, deg=torch.ones_like(sampler["deg"]))
    ids = torch.arange(1 << 16, dtype=torch.int32, device=cuda_device)
    before = kernels.launches["light_points"]
    rep = parity.compare_light_points(ts, sampler, ids, 11)
    assert kernels.launches["light_points"] == before + 1
    assert rep["equal"], rep


@pytest.mark.cuda
def test_shade_kernel_per_ray_lights_matches_plain(cuda_device):
    ts, meta, sampler = _area_case(cuda_device)
    ids = torch.arange(64 * 64 * 4, dtype=torch.int32, device=cuda_device)
    amb = torch.full((3,), 0.1, device=cuda_device)
    inputs = parity.shade_inputs(ts, ids, 64, 64, 2, 1, amb)
    lpos = lights.sample_light_points(ts, sampler, ids, 3)
    rep = parity.compare_shade(ts, inputs, amb, meta.has_kd_textures,
                               meta.has_ks_textures, light_pos=lpos)
    assert rep["mask_equal"] and rep["hits"] > 100
    for out in parity.SHADE_OUTPUTS:
        assert rep[out] == 0, (out, rep)


@pytest.mark.cuda
def test_stochastic_area_frame_matches_plain(cuda_device):
    ts, meta, sampler = _area_case(cuda_device, aperture=0.2)
    w = h = 48
    kw = dict(max_depth=3, stochastic=True, seed=7, light_sampler=sampler)
    kernels.reset_launches()
    img = renderer.render_image(ts, meta, w, h, 2, ldr=True, **kw)
    assert kernels.launches["camera_rays_stochastic"] > 0
    assert kernels.launches["light_points"] > 0
    assert kernels.launches["camera_rays"] == 0
    ids = torch.arange(w * h * 4, dtype=torch.int32, device=cuda_device)
    amb = torch.full((3,), 0.1, device=cuda_device)
    rgb = renderer.trace_rays(ts, ids, amb, w, h, 2, plain=True,
                              has_kd_textures=meta.has_kd_textures,
                              has_ks_textures=meta.has_ks_textures, **kw)
    plain = renderer.pixel_finish_plain(rgb, 4, True).cpu().numpy()
    d = np.abs(plain.astype(np.int32) - img.reshape(-1, 4))
    assert d.max() <= 1
    again = renderer.render_image(ts, meta, w, h, 2, ldr=True,
                                  chunk_pixels=100, **kw)
    np.testing.assert_array_equal(img, again)


@pytest.mark.cuda
def test_shade_bwd_per_ray_lights_matches_autograd(cuda_device):
    ts, meta, sampler = _area_case(cuda_device)
    ids = torch.arange(64 * 64 * 4, dtype=torch.int32, device=cuda_device)
    amb = torch.full((3,), 0.1, device=cuda_device)
    inputs = parity.shade_inputs(ts, ids, 64, 64, 2, 1, amb)
    lpos = lights.sample_light_points(ts, sampler, ids, 3)
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    before = dict(kernels.launches)
    rep = parity.compare_shade_grads(ts, inputs, amb, gen,
                                     meta.has_kd_textures,
                                     meta.has_ks_textures, light_pos=lpos)
    assert kernels.launches["shade_bwd_lights"] == \
        before["shade_bwd_lights"] + 1
    assert kernels.launches["shade_bwd"] == before["shade_bwd"]
    parity.check_grads(rep, GRAD_RTOL, "K5 per-ray lights")
    for leaf in ("ro", "rd", "light_pos_ray", "light_ke", "mat_kd"):
        assert rep[leaf]["norm"] > 0, leaf
    assert rep["light_pos"]["norm"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("aperture", [0.0, 0.3])
def test_camera_stochastic_bwd_matches_autograd(cuda_device, aperture):
    ts, _, _ = _area_case(cuda_device, aperture=aperture)
    ids = torch.arange(171 * 96 * 9, dtype=torch.int32, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    before = kernels.launches["camera_bwd_stochastic"]
    rep = parity.compare_camera_stochastic_grads(ts, ids, 171, 96, 3, 7, gen)
    assert kernels.launches["camera_bwd_stochastic"] == before + 1
    focus = rep.pop("cam_focus")
    parity.check_grads(rep, GRAD_RTOL, "K9")
    assert rep["cam_aperture"]["norm"] > 0
    if aperture:
        parity.check_grads({"cam_focus": focus}, GRAD_RTOL, "K9")
    else:   # no lens: d_focus is zero up to rounding, as K6's
        assert focus["max_abs"] <= 1e-5 * rep["cam_axes"]["norm"]


@pytest.mark.cuda
def test_camera_stochastic_bwd_zero_aperture_is_k6(cuda_device):
    """At aperture 0, K9's 15 shared sums are K6's on the same uv, bit for
    bit: one order of sums, and per-ray terms of the same value."""
    ts, _, _ = _area_case(cuda_device, aperture=0.0)
    n = 64 * 64 * 4
    ids = torch.arange(n, dtype=torch.int32, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    g_ro, g_rd = (torch.randn((n, 3), device=cuda_device, generator=gen)
                  for _ in range(2))
    uv, _, _ = camera.camera_rays_stochastic(ts, ids, 64, 64, 2, 5)
    h, w = camera.camera_frame(ts)
    k6 = camera.camera_rays_bwd(uv, g_ro, g_rd, ts.cam_axes, ts.cam_o, h, w,
                                ts.cam_focus)
    k9 = camera.camera_rays_stochastic_bwd(
        ids, ts.cam_axes, ts.cam_o, h, w, ts.cam_focus, ts.cam_aperture, 64,
        64, 2, 5, g_ro, g_rd)
    assert torch.equal(k9[:15], k6)


# the camera reverses' batches: one ray, one short warp block, one tile of
# a block and a ray, the training batch and three
CAMERA_BWD_RAYS = [1, 255, camera.CAM_THREADS * camera.CAM_RAYS + 1,
                   (1 << 20) + 3]


def _camera_bwd_case(device, n, seed):
    """(K6's and K9's sums, and their ordered sums of the plain per-ray
    terms on the card) for n rays of a 910x512 frame at 4x4 samples: K6
    on the hair scene's K2 uv, K9 on the area scene at aperture 0.3."""
    gen = torch.Generator(device=device).manual_seed(seed)
    # ids spread over the frame's 7,454,720
    ids = torch.arange(n, dtype=torch.int32, device=device) * 7 % (
        910 * 512 * 16)
    g_ro, g_rd = (torch.randn((n, 3), device=device, generator=gen)
                  for _ in range(2))
    hs, _ = _scene(testscenes.make_hair_scene(64), device)
    with torch.no_grad():
        uv = camera.camera_rays(hs, ids, 910, 512, 4)[0]
    h, w = camera.camera_frame(hs)
    k6_args = (uv, g_ro, g_rd, hs.cam_axes, hs.cam_o, h, w, hs.cam_focus)
    ts, _, _ = _area_case(device, aperture=0.3)
    h, w = camera.camera_frame(ts)
    k9_args = (ids, ts.cam_axes, ts.cam_o, h, w, ts.cam_focus,
               ts.cam_aperture, 910, 512, 4, 7, g_ro, g_rd)
    return k6_args, k9_args


@pytest.mark.cuda
@pytest.mark.parametrize("n", CAMERA_BWD_RAYS)
def test_camera_bwd_kernels_equal_ordered_sums(cuda_device, n):
    """K6 and K9 bit-equal to ``ordered_camera_sums`` of the plain per-ray
    terms computed on the card, and within 1e-4 of their first forms."""
    k6_args, k9_args = _camera_bwd_case(cuda_device, n, n % 1000)
    before = dict(kernels.launches)
    k6 = camera.camera_rays_bwd(*k6_args)
    k9 = camera.camera_rays_stochastic_bwd(*k9_args)
    assert kernels.launches["camera_bwd"] == before["camera_bwd"] + 1
    assert kernels.launches["camera_bwd_stochastic"] == \
        before["camera_bwd_stochastic"] + 1
    terms6 = camera.camera_bwd_terms_plain(*k6_args)
    terms9 = camera.camera_stochastic_bwd_terms_plain(*k9_args)
    assert torch.equal(k6, camera.ordered_camera_sums(terms6)[:15])
    assert torch.equal(k9, camera.ordered_camera_sums(terms9))
    for kern, simple in ((k6, parity.camera_bwd_simple(*k6_args)),
                         (k9, parity.camera_stochastic_bwd_simple(*k9_args))):
        rel = float(torch.linalg.vector_norm(kern - simple)
                    / torch.linalg.vector_norm(simple))
        assert rel <= GRAD_RTOL, rel
    assert kernels.launches == {**before, "camera_bwd":
                                before["camera_bwd"] + 1,
                                "camera_bwd_stochastic":
                                before["camera_bwd_stochastic"] + 1}


@pytest.mark.cuda
def test_camera_bwd_kernels_repeat(cuda_device):
    """Two launches on the same inputs give the same bits, also right after
    a launch of no ray (16 zeros) and after one of another batch: each
    launch's last block sets its counter back to 0."""
    small = _camera_bwd_case(cuda_device, 255, 1)
    k6_args, k9_args = _camera_bwd_case(cuda_device, (1 << 20) + 3, 2)
    first = (camera.camera_rays_bwd(*k6_args),
             camera.camera_rays_stochastic_bwd(*k9_args))
    again = (camera.camera_rays_bwd(*k6_args),
             camera.camera_rays_stochastic_bwd(*k9_args))
    empty6 = tuple(x[:0] for x in k6_args[:3]) + k6_args[3:]
    empty9 = (k9_args[0][:0],) + k9_args[1:11] + tuple(
        x[:0] for x in k9_args[11:])
    zeros = (camera.camera_rays_bwd(*empty6),
             camera.camera_rays_stochastic_bwd(*empty9))
    after_empty = (camera.camera_rays_bwd(*k6_args),
                   camera.camera_rays_stochastic_bwd(*k9_args))
    camera.camera_rays_bwd(*small[0])
    camera.camera_rays_stochastic_bwd(*small[1])
    after_other = (camera.camera_rays_bwd(*k6_args),
                   camera.camera_rays_stochastic_bwd(*k9_args))
    assert zeros[0].shape == (15,) and zeros[1].shape == (16,)
    assert not zeros[0].any() and not zeros[1].any()
    for out in (again, after_empty, after_other):
        for a, b in zip(first, out):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert not camera._counters[k6_args[0].device].any()


@pytest.mark.cuda
@pytest.mark.parametrize("deg", [False, True], ids=["sampled", "deg"])
def test_light_points_bwd_matches_autograd(cuda_device, deg):
    ts, _, sampler = _area_case(cuda_device)
    if deg:
        sampler = dict(sampler, deg=torch.ones_like(sampler["deg"]))
    ids = torch.arange(1 << 16, dtype=torch.int32, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    before = kernels.launches["light_points_bwd"]
    rep = parity.compare_light_points_grads(ts, sampler, ids, 11, gen)
    assert kernels.launches["light_points_bwd"] == before + 1
    parity.check_grads(rep, GRAD_RTOL, "K10")
    assert rep["light_pos" if deg else "pos"]["norm"] > 0



def _add_light(host, name, shape, o=(0.0, 0.0, 0.0)):
    """An emissive instance of ``shape`` (a HostShape, or the index of one
    already in the scene) at offset ``o``, with the light's material."""
    if not isinstance(shape, int):
        host.shapes.append(shape)
        shape = len(host.shapes) - 1
    mat = next(i for i in host.instances if i.name == "light").material
    host.instances.append(scene_lib.HostInstance(
        name=name, axes=np.eye(3, dtype=np.float32),
        o=np.asarray(o, np.float32), shape=shape, material=mat))


def _light_case(case, device):
    """Light sets for K8 and K10 on the area mirror scene (its quad light,
    4 vertices): ``one``; ``two`` (+ a 4-segment polyline, 5 vertices);
    ``eight`` (+ a mixed shape of 2 points, 2 segments and 2 triangles on
    6 vertices, and 5 more instances of the quad: shared shapes); ``deg``
    (``two`` with its last light marked as a shape without elements);
    ``panel8`` and ``panel`` (the quad as a lamp panel of 8 x 8 and
    32 x 32 cells: 81 and 1,089 vertices, K10's shared-row and global
    paths). Returns the scene, the sampler and whether every light's span
    is at most 8 vertices (K10's register path)."""
    host = _area_grad_scene()
    light = next(i for i in host.instances if i.name == "light")
    if case in ("panel8", "panel"):
        shp = host.shapes[light.shape]
        shp.pos, shp.triangles = testscenes.panel_grid(
            shp.pos[:4].mean(axis=0), cells=8 if case == "panel8" else 32)
        shp.texcoord = np.zeros((len(shp.pos), 2), np.float32)
    if case in ("two", "eight", "deg"):
        c = np.asarray([-2.5, 3.5, -1.0], np.float32)
        _add_light(host, "polyline", testscenes._shape(
            "polyline", [c + [dx, 0.1 * dx * dx, 0.3 * dx]
                         for dx in (-0.8, -0.3, 0.0, 0.4, 0.9)],
            lines=[[0, 1], [1, 2], [2, 3], [3, 4]]))
    if case == "eight":
        c = np.asarray([2.0, 4.0, 3.0], np.float32)
        _add_light(host, "mixed", testscenes._shape(
            "mixed", [c + d for d in ([0, 0, 0], [0.5, 0, 0], [0, 0, 0.5],
                                      [0.5, 0, 0.5], [-0.4, 0.1, 0.2],
                                      [-0.2, 0, -0.4])],
            points=[4, 5], lines=[[4, 5], [5, 0]],
            triangles=[[0, 1, 2], [1, 3, 2]]))
        for k in range(5):
            _add_light(host, f"quad{k}", light.shape, (0.3 * k, 0.0, -0.2 * k))
    scene_lib.finalize_scene(host)
    leaves, meta = scene_lib.build_device_scene(host)
    ts = scene_lib.to_torch(leaves, device)
    sampler = lights.build_light_sampler(host, leaves, meta, device)
    if case == "deg":
        sampler = {k: v.clone() for k, v in sampler.items()}
        sampler["deg"][-1] = True
        sampler["cdf"][-1] = 1.0
        sampler["n"][-1] = 1
    return ts, sampler, case not in ("panel8", "panel")


LIGHT_CASES = ("one", "two", "eight", "deg", "panel8", "panel")
LIGHT_RAYS = (1, 6221, 1 << 16)


def _light_ids(n, device):
    rng = np.random.default_rng(n)
    return torch.from_numpy(rng.integers(0, 2**31 - 1, n).astype(
        np.int32)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("n", LIGHT_RAYS)
@pytest.mark.parametrize("case", LIGHT_CASES)
def test_light_points_kernel_matches_plain_and_simple(cuda_device, case, n):
    """K8 bit for bit equal to the plain version and to its first form
    (``lights_simple.cu``)."""
    ts, sampler, _ = _light_case(case, cuda_device)
    nl = {"one": 1, "two": 2, "eight": 8, "deg": 2}.get(case, 1)
    assert sampler["cdf"].shape[0] == nl
    rep = parity.compare_light_points(ts, sampler, _light_ids(n, cuda_device),
                                      11)
    assert rep["equal"] and rep["simple_equal"], rep


@pytest.mark.cuda
@pytest.mark.parametrize("n", LIGHT_RAYS)
@pytest.mark.parametrize("case", LIGHT_CASES)
def test_light_points_bwd_matches_f64_and_simple(cuda_device, case, n):
    """K10 within 1 ULP of the explicit f64 reverse (entries below 1e-9 of
    the largest within that much of it), within 1e-4 relative L2 of its
    first form, and bit for bit the same over two runs where every span is
    at most 8 vertices."""
    ts, sampler, registers = _light_case(case, cuda_device)
    ids = _light_ids(n, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    g = torch.randn((sampler["cdf"].shape[0], n, 3), device=cuda_device,
                    generator=gen)
    before = kernels.launches["light_points_bwd"]
    rep = parity.compare_light_points_bwd(ts, sampler, ids, 11, g)
    assert kernels.launches["light_points_bwd"] == before + 2
    for out in ("d_pos", "d_light_pos"):
        assert rep[out]["ulp"] <= 1, (out, rep[out])
        assert rep[out]["small_abs"] <= rep[out]["floor"], (out, rep[out])
    parity.check_grads(rep["simple"], GRAD_RTOL, "K10 vs first form")
    assert rep["simple"]["light_pos" if case == "deg" else "pos"]["norm"] > 0
    if registers:
        assert rep["repeat"]


@pytest.mark.cuda
@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("name", list(light_pick_rows.PICK_ROWS))
def test_light_kernels_on_adversarial_rows(cuda_device, name, padded):
    """K8 and K10 on samplers made by hand from the adversarial CDF rows of
    ``light_pick_rows`` (ties, zero weights, a zero total, NaN and inf
    weights, edge padding, tiny and huge weights, 2,048 elements) over the
    lamp panel's 2,048 triangles: K8 bit for bit equal to the plain version
    and to its first form, K10 within 1 ULP of the explicit f64 reverse and
    1e-4 of its first form. The ray ids put r0 at 0, 2^-24, k / 8 and just
    below 1, then 6,221 seeded ones. As built the rows fit K8's staging
    (but the 2,048-element set); ``padded`` pads each with its last value
    by 300 more entries, which do not."""
    ts, panel, _ = _light_case("panel", cuda_device)
    cdf = light_pick_rows.cdf_rows(light_pick_rows.PICK_ROWS[name],
                                   300 if padded else 0)
    nl, ne = cdf.shape
    ts = dataclasses.replace(ts, light_pos=ts.light_pos[:1].repeat(nl, 1))
    assert (nl * (ne + 1) <= 256) == (not padded and name != "grid_2048")
    ids = torch.from_numpy(np.concatenate([
        light_pick_rows.ids_for_r0(11, light_pick_rows.R0_TARGETS),
        _light_ids(6221, "cpu").numpy()])).to(cuda_device)
    n_elems = [len(r) for r in light_pick_rows.PICK_ROWS[name]]
    sampler = dict(
        cdf=torch.from_numpy(cdf).to(cuda_device),
        n=torch.tensor(n_elems, dtype=torch.int32, device=cuda_device),
        prim_lo=panel["prim_lo"][:1].repeat(nl),
        deg=torch.zeros(nl, dtype=torch.bool, device=cuda_device))
    rep = parity.compare_light_points(ts, sampler, ids, 11)
    assert rep["equal"] and rep["simple_equal"], rep
    gen = torch.Generator(device=cuda_device).manual_seed(ne)
    g = torch.randn((nl, ids.shape[0], 3), device=cuda_device, generator=gen)
    rep = parity.compare_light_points_bwd(ts, sampler, ids, 11, g)
    for out in ("d_pos", "d_light_pos"):
        assert rep[out]["ulp"] <= 1, (out, rep[out])
        assert rep[out]["small_abs"] <= rep[out]["floor"], (out, rep[out])
    parity.check_grads(rep["simple"], GRAD_RTOL, "K10 vs first form")
    assert rep["simple"]["pos"]["norm"] > 0

def _duplicates_scene():
    """The random scene with every triangle of shape 0 listed twice and
    instance 0 repeated: ties decide prim and inst."""
    host = testscenes.make_random_scene(seed=1)
    shp = host.shapes[0]
    shp.triangles = np.concatenate([shp.triangles, shp.triangles])
    host.instances.append(host.instances[0])
    return host


def _moved_leaves(leaves, seed):
    """pos and radius moved after the build (no rebuild)."""
    rng = np.random.default_rng(seed)
    out = dict(leaves)
    out["pos"] = (leaves["pos"] + rng.normal(
        scale=0.05, size=leaves["pos"].shape)).astype(np.float32)
    out["radius"] = (leaves["radius"] * rng.uniform(
        0.5, 2.0, leaves["radius"].shape)).astype(np.float32)
    return out


OVERLAP_SCENES = {
    "random0": (lambda: testscenes.make_random_scene(seed=0), False),
    "hair64": (lambda: testscenes.make_hair_scene(64), False),
    "moved": (lambda: testscenes.make_random_scene(seed=2), True),
    "duplicates": (_duplicates_scene, False),
}


def _overlap_case(name, device):
    make, moved = OVERLAP_SCENES[name]
    leaves, meta = scene_lib.build_device_scene(make())
    if moved:
        leaves = _moved_leaves(leaves, 3)
    return scene_lib.to_torch(leaves, device), meta


@pytest.mark.cuda
@pytest.mark.parametrize("make", list(OVERLAP_SCENES))
@pytest.mark.parametrize("dist_max", [10.0, 1.0, 0.05])
def test_overlap_kernel_matches_plain(cuda_device, make, dist_max):
    """K11 (refit kernel and culled walk) against the brute-force plain
    query, the plain walk and its first form, every output bit for bit; its
    wrapper synchronises no host (``set_sync_debug_mode("error")``)."""
    from yocto_raytracing_tpu_torch.ops import overlap

    ts, meta = _overlap_case(make, cuda_device)
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.uniform(-2, 2, (8192, 3)).astype(
        np.float32)).to(cuda_device)
    overlap.overlap_scene(ts, meta, q[:8], dist_max)   # build, load
    torch.cuda.synchronize()
    before = dict(kernels.launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = overlap.overlap_scene(ts, meta, q, dist_max)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert kernels.launches["overlap"] == before["overlap"] + 1
    assert kernels.launches["overlap_refit"] == before["overlap_refit"] + 1
    plain = overlap.overlap_scene_plain(ts, meta, q, dist_max)
    rep = parity.overlap_gaps(got, plain)
    assert rep["equal"] and rep["found"] > 0, rep
    assert rep["dist"] == rep["euv"] == 0, rep
    assert parity.overlap_identical(got, plain)
    assert parity.overlap_identical(
        got, overlap.overlap_scene_walk_plain(ts, meta, q, dist_max))
    assert parity.overlap_identical(
        got, parity.overlap_simple(ts, meta, q, dist_max))


@pytest.mark.cuda
@pytest.mark.parametrize("make", list(OVERLAP_SCENES))
def test_overlap_refit_kernel_matches_plain(cuda_device, make):
    """The refit kernel's records equal the plain refit's word for word."""
    from yocto_raytracing_tpu_torch.ops import overlap

    ts, _ = _overlap_case(make, cuda_device)
    a = overlap.refit_cuda(ts)
    b = overlap.refit_plain(ts)
    for x, y in zip(a[:2], b[:2]):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


@pytest.mark.cuda
def test_stochastic_train_gradient_matches_reference(cuda_device):
    """The gradient of the render loss through K7/K9, K8/K10 and K4/K5 with
    per-ray lights, against the f64 reference on the recorded hits."""
    ts, meta, sampler = _area_case(cuda_device, aperture=0.2)
    w = h = 32
    ids = torch.arange(w * h * 4, dtype=torch.int32, device=cuda_device)
    amb = torch.full((3,), 0.1, device=cuda_device)
    target = torch.rand((ids.shape[0], 3), device=cuda_device,
                        generator=torch.Generator(
                            device=cuda_device).manual_seed(1))
    kw = dict(width=w, height=h, samples=2, max_depth=3, stochastic=True,
              seed=7, light_sampler=sampler)
    kernels.reset_launches()
    rep = parity.compare_loss_grads(ts, ids, target, amb, **kw)
    for k in ("camera_rays_stochastic", "camera_bwd_stochastic",
              "light_points", "light_points_bwd", "shade_bwd_lights"):
        assert kernels.launches[k] > 0, k
    assert kernels.launches["shade_bwd"] == 0
    np.testing.assert_allclose(rep["loss"], rep["ref_loss"], rtol=1e-5)
    parity.check_grads(rep["kernel"],
                       parity.loss_grad_bounds(rep, GRAD_RTOL, 1.25),
                       "stochastic train gradient")
    for leaf in ("cam_aperture", "cam_focus", "pos", "light_ke"):
        assert rep["kernel"][leaf]["norm"] > 0, leaf


def _free_port():
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.cuda
def test_train_step_sharded_nccl_world_of_one(cuda_device):
    """``train_step_sharded`` in a real one-rank NCCL group: the same step
    as ``train_step`` (loss rtol 1e-6, leaves rtol 1e-5 / atol 1e-7; K5's
    f64 atomic sums may move the last bit), through the kernels, with one
    all_reduce of the loss and one per trainable leaf."""
    import torch.distributed as dist

    ts, _ = _scene(testscenes.make_grad_scene(), cuda_device)
    w = h = 32
    ids = torch.arange(w * h, dtype=torch.int32, device=cuda_device)
    amb = torch.full((3,), 0.1, device=cuda_device)
    target = torch.rand((w * h, 3), device=cuda_device,
                        generator=torch.Generator(
                            device=cuda_device).manual_seed(1))
    kw = dict(width=w, height=h, samples=1, max_depth=3)
    assert mesh.init_distributed(f"tcp://127.0.0.1:{_free_port()}", 1, 0,
                                 device="cuda") == 0
    reduces = []
    all_reduce = dist.all_reduce
    try:
        assert dist.get_backend() == "nccl"
        rays = mesh.make_ray_mesh("cuda")
        assert rays.group is not None and rays.world_size == 1

        def counted(x, *args, **kwargs):
            reduces.append(x.numel())
            return all_reduce(x, *args, **kwargs)

        dist.all_reduce = counted
        kernels.reset_launches()
        new_s, loss_s = mesh.train_step_sharded(
            ts, mesh.shard_rays(ids, rays), mesh.shard_rays(target, rays),
            amb, 0.1, mesh=rays, **kw)
        torch.cuda.synchronize()
    finally:
        dist.all_reduce = all_reduce
        dist.destroy_process_group()
    assert all(kernels.launches[k] > 0 for k in ("camera_rays", "hit",
                                                 "shade", "shade_bwd",
                                                 "camera_bwd"))
    assert reduces == [1] + [getattr(ts, n).numel()
                             for n in scene_lib.LEAF_NAMES
                             if getattr(ts, n).is_floating_point()]
    new_1, loss_1 = mesh.train_step(ts, ids, target, amb, 0.1, **kw)
    np.testing.assert_allclose(float(loss_s), float(loss_1), rtol=1e-6)
    for name in scene_lib.LEAF_NAMES:
        np.testing.assert_allclose(getattr(new_s, name).cpu().numpy(),
                                   getattr(new_1, name).cpu().numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=name)


@pytest.mark.cuda
def test_cli_on_the_card(cuda_device, tmp_path):
    """``cli.main`` with ``--device cuda``: the PNG is the host tonemap of
    ``render_image`` on the card, also with ``--checkpoint`` resumed from
    a truncated snapshot and with ``--sharded`` (one process, no group)."""
    from yocto_raytracing_tpu_torch import cli, image

    obj = str(tmp_path / "hair.obj")
    scene_lib.save_scene(testscenes.make_hair_scene(64), obj)
    ts, meta = _scene(scene_lib.load_scene(obj), cuda_device)
    want = image.tonemap(renderer.render_image(ts, meta, 171, 96, 2,
                                               max_depth=4))
    png = str(tmp_path / "out.png")
    base = ["-r", "96", "-s", "2", "--max-depth", "4", "--device", "cuda",
            "-o", png]
    ck = str(tmp_path / "ck.npz")
    for extra in ([], ["--checkpoint", ck, "--chunk-pixels", "4096"],
                  ["--checkpoint", ck, "--chunk-pixels", "4096"],
                  ["--sharded"]):
        if "--sharded" in extra:
            os.remove(ck)
        if os.path.exists(ck):   # the second run resumes from half
            with np.load(ck) as snap:
                key, acc, done = snap["key"], snap["acc"], int(snap["done"])
            renderer._atomic_savez(ck, key=key, done=done // 2,
                                   acc=acc[:done // 2])
        assert cli.main(base + extra + [obj]) == 0
        np.testing.assert_array_equal(image.load_image4b(png), want,
                                      err_msg=" ".join(extra))


# --------------------------------------------------------------------------
# the device loop: K12, the alive word, the CUDA graph of a chunk
# --------------------------------------------------------------------------


def _same_bits(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("word", [None, 1, 0], ids=["no_word", "alive",
                                                    "dead"])
def test_bounce_kernel_matches_plain(cuda_device, word):
    """K12 in place == bounce_update_plain bit for bit, tmax and the next
    alive word too; with a zero alive word it writes nothing."""
    n = 100_003
    acc, thr, color, kr, p, refl, mask = (
        torch.from_numpy(x).to(cuda_device) for x in random_bounce(11, n))
    want = renderer.bounce_update_plain(acc, thr, color, kr, p, refl, mask)
    state = [acc.clone(), thr.clone(),
             torch.full((n, 3), 7.0, device=cuda_device),
             torch.full((n, 3), 7.0, device=cuda_device),
             torch.zeros(n, device=cuda_device)]
    before = [t.clone() for t in state]
    alive = torch.tensor([0 if word is None else word, 0],
                         dtype=torch.int32, device=cuda_device)
    kernels.reset_launches()
    renderer.bounce_update(*state, color, kr, p, refl, mask,
                           None if word is None else alive[0:1], alive[1:2])
    torch.cuda.synchronize()
    assert kernels.launches["bounce"] == 1
    if word == 0:
        assert all(_same_bits(a, b) for a, b in zip(state, before))
        assert alive.tolist() == [0, 0]
        return
    for name, a, b in zip(("acc", "thr", "ro", "rd"), state, want):
        assert _same_bits(a, b), name
    tmax = torch.where(want[4], float(FLT_MAX), float(-FLT_MAX))
    assert _same_bits(state[4], tmax)
    assert alive[1].item() == int(want[4].any())


@pytest.mark.cuda
@pytest.mark.parametrize("word", [1, 0], ids=["alive", "dead"])
def test_bounce_kernel_out_of_place_matches_in_place(cuda_device, word):
    """K12's out-of-place form (the training step's) == its in-place form
    bit for bit: acc, tmax and the next word in place, thr read from its
    slot (left as it was) and the next thr, ro and rd written into the
    next slots; with a zero alive word it writes nothing."""
    n = 100_003
    acc, thr, color, kr, p, refl, mask = (
        torch.from_numpy(x).to(cuda_device) for x in random_bounce(13, n))

    def state():
        return [acc.clone(), torch.full((n, 3), 7.0, device=cuda_device),
                torch.full((n, 3), 7.0, device=cuda_device),
                torch.zeros(n, device=cuda_device)]

    a1, ro1, rd1, tmax1 = state()
    thr1 = thr.clone()
    w1 = torch.tensor([word, 0], dtype=torch.int32, device=cuda_device)
    renderer.bounce_update(a1, thr1, ro1, rd1, tmax1, color, kr, p, refl,
                           mask, w1[0:1], w1[1:2])
    a2, ro2, rd2, tmax2 = state()
    thr_in = thr.clone()
    thr2 = torch.full((n, 3), 5.0, device=cuda_device)
    before = [t.clone() for t in (a2, thr2, ro2, rd2, tmax2)]
    w2 = torch.tensor([word, 0], dtype=torch.int32, device=cuda_device)
    kernels.reset_launches()
    renderer.bounce_update_out(a2, thr_in, thr2, ro2, rd2, tmax2, color,
                               kr, p, refl, mask, w2[0:1], w2[1:2])
    torch.cuda.synchronize()
    assert kernels.launches["bounce"] == 1
    assert _same_bits(thr_in, thr)
    got = (a2, thr2, ro2, rd2, tmax2)
    if word == 0:
        assert all(_same_bits(a, b) for a, b in zip(got, before))
        assert w2.tolist() == [0, 0]
        return
    for name, a, b in zip(("acc", "thr", "ro", "rd", "tmax"), got,
                          (a1, thr1, ro1, rd1, tmax1)):
        assert _same_bits(a, b), name
    assert w2.tolist() == w1.tolist() == [1, 1]


@pytest.mark.cuda
def test_bounce_bwd_kernel_matches_plain(cuda_device):
    """K14 == ``bounce_update_bwd_plain`` bit for bit on a random state
    (dead lanes, kr of 0, -0.0 and NaN, NaN colors on masked lanes,
    infinite throughputs): the four cotangents written, g_thr in place."""
    n = 100_003
    _, thr, color, kr, _, _, mask = (
        torch.from_numpy(x).to(cuda_device) for x in random_bounce(14, n))
    rng = np.random.default_rng(14)
    g_acc, g_thr, g_ro, g_rd = (
        torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)).to(
            cuda_device) for _ in range(4))
    want = renderer.bounce_update_bwd_plain(g_acc, g_thr, g_ro, g_rd, thr,
                                            color, kr, mask)
    out = [torch.full((n, 3), 7.0, device=cuda_device) for _ in range(4)]
    carry = g_thr.clone()
    kernels.reset_launches()
    renderer.bounce_update_bwd(g_acc, carry, g_ro, g_rd, thr, color, kr,
                               mask, out)
    torch.cuda.synchronize()
    assert kernels.launches["bounce_bwd"] == 1
    for name, a, b in zip(("g_color", "g_kr", "g_p", "g_refl", "g_thr"),
                          (*out, carry), want):
        assert _same_bits(a, b), name


def _step_case(name, device, w=32, h=32):
    ts, _ = _scene(getattr(testscenes, name)(), device)
    ids = torch.arange(w * h, dtype=torch.int32, device=device)
    amb = torch.full((3,), 0.1, device=device)
    target = torch.rand((w * h, 3), device=device, generator=torch.Generator(
        device=device).manual_seed(2))
    return ts, ids, target, amb, dict(width=w, height=h, samples=1,
                                      max_depth=4)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["make_grad_scene",
                                  "make_mirror_pair_scene"])
def test_train_step_device_loop_matches_first_form(cuda_device, name):
    """The training step's device loop (``loss_grads_device``, a miss and
    a hit) against its first form (``mesh._loss_and_grads_autograd``):
    the loss bit-equal, every leaf's gradient within 1e-5 relative L2 (the
    leaf sums are atomic, and the loop sums the bounces in f64 before it
    rounds; ``cam_focus``, zero up to rounding, left out); its dead
    bounces made no launch either way, its live ones one K1 nearest, K4,
    K12, K14 and K5 each (the mirror pair's bounces 2 and 3 in IF nodes);
    ``train_step``'s update ``d - lr * g`` of that gradient."""
    ts, ids, target, amb, kw = _step_case(name, cuda_device)
    diff, static = mesh.partition_scene(ts)
    loss_f, grads_f = mesh._loss_and_grads_autograd(diff, static, ids,
                                                    target, amb, kw)
    want = {k: g.double() for k, g in zip(scene_lib.LEAF_NAMES, grads_f)
            if g is not None and k != "cam_focus"}
    renderer._steps.clear()
    for call in ("miss", "hit"):
        kernels.reset_launches()
        with tracer.recording():   # the dead bounces' tally
            loss_d, out = renderer.loss_grads_device(ts, ids, target, amb,
                                                     32, 32, 1,
                                                     kw["max_depth"])
        made = kernels.made_launches()
        rec = kernels.last_step()
        assert rec["cache_hit"] is (call == "hit")
        assert float(loss_d) == float(loss_f)
        live = int(rec["ran"][:-1].sum())
        for k in ("bounce", "bounce_bwd", "shade_bwd", "shade"):
            assert made[k] == live, (k, made[k], live)
        assert made["hit"] - made["hit_any"] == live
        assert kernels.skipped_launches()["step_bounces"] == (
            kw["max_depth"] - live)
        if name == "make_mirror_pair_scene":
            assert rec["ran"].tolist()[:4] == [1, 1, 1, 1]
        got = {k: g for k, g in zip(scene_lib.LEAF_NAMES, out)
               if g is not None}
        rep = parity.relative_errors({k: g.double() for k, g in got.items()},
                                     want, per_element=False)
        parity.check_grads(rep, 1e-5, f"{name} {call}: device loop")
    new, loss = mesh.train_step(ts, ids, target, amb, 0.1, **kw)
    assert float(loss) == float(loss_f)
    parity.check_update(ts, new, got, 0.1, f"{name}: train_step")


@pytest.mark.cuda
def test_train_step_hit_makes_no_sync(cuda_device):
    """A hit of ``train_step`` under ``set_sync_debug_mode("error")``:
    it waits for nothing, keeps its graph (no capture) and the reserved
    memory, and repeats the miss's loss."""
    ts, ids, target, amb, kw = _step_case("make_mirror_pair_scene",
                                          cuda_device)
    _, loss1 = mesh.train_step(ts, ids, target, amb, 0.1, **kw)
    (state,) = renderer._steps.values()
    graph = state.graph
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        new, loss2 = mesh.train_step(ts, ids, target, amb, 0.1, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()
    assert kernels.last_step()["cache_hit"] is True
    assert renderer._steps[next(iter(renderer._steps))] is state
    assert state.graph is graph
    assert kernels.last_step()["host_ms"]["capture"] == 0.0
    assert torch.cuda.memory_reserved() == reserved
    assert float(loss2) == float(loss1)
    assert new.mat_kd.data_ptr() != state.out["mat_kd"].data_ptr()


@pytest.mark.cuda
def test_dead_word_leaves_hit_and_shade_outputs(cuda_device):
    """K1 (both kinds) and K4 (prep and finish) with a zero alive word
    leave every output as it was; with a word of 1 they give the answers
    of the launches without a word."""
    import ctypes

    from yocto_raytracing_tpu_torch.kernels import _build
    from yocto_raytracing_tpu_torch.ops import hit_records, shade_records

    ts, meta = _scene(testscenes.make_hair_scene(64), cuda_device)
    n = 5_000
    ro, rd, tmin, tmax = _rays(1, n, cuda_device)
    zero = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    one = torch.ones(1, dtype=torch.int32, device=cuda_device)
    recs = hit_records.pack(ts)
    lib = _build.library()
    ptr = _build.ptr
    for any_hit in (False, True):
        outs = [torch.ones(n, dtype=torch.bool, device=cuda_device),
                torch.full((n,), -7, dtype=torch.int32, device=cuda_device),
                torch.full((n,), -7, dtype=torch.int32, device=cuda_device),
                torch.full((n,), 123.0, device=cuda_device)]
        before = [t.clone() for t in outs]
        err = lib.yrt_hit(
            ptr(recs.nodes), ptr(recs.prims), ptr(recs.insts),
            ptr(recs.node_count), recs.insts.shape[0], ptr(ro), ptr(rd),
            ptr(tmin), ptr(tmax), n, int(any_hit), *(ptr(t) for t in outs),
            ptr(zero), _build.current_stream())
        _build.check_launch(err, "yrt_hit")
        torch.cuda.synchronize()
        assert all(_same_bits(a, b) for a, b in zip(outs, before))
        a = traverse.intersect_scene_cuda(ts, ro, rd, tmin, tmax, any_hit,
                                          records=recs, alive=one)
        b = traverse.intersect_scene_cuda(ts, ro, rd, tmin, tmax, any_hit,
                                          records=recs)
        assert all(_same_bits(a[k], b[k]) for k in a)
    # K4 on the camera rays' hits
    ids = torch.arange(96 * 54, dtype=torch.int32, device=cuda_device)
    _, cro, crd = camera.camera_rays(ts, ids, 96, 54, 1)
    m = ids.shape[0]
    ctmin = torch.full((m,), 1e-4, device=cuda_device)
    hits = traverse.intersect_scene_cuda(
        ts, cro, crd, ctmin, torch.full((m,), float(FLT_MAX),
                                        device=cuda_device), records=recs)
    amb = torch.full((3,), 0.1, device=cuda_device)
    srec = shade_records.pack(ts)
    leaves = {k: getattr(ts, k) for k in shade.GRAD_LEAVES}
    nl = ts.light_ke.shape[0]
    args = shade._shade_args(ts, leaves, amb, meta.has_kd_textures,
                             meta.has_ks_textures, None, m, srec, zero)
    io = (ptr(cro), ptr(crd), ptr(hits["inst"]), ptr(hits["prim"]),
          ptr(hits["hit"]))
    sh = [torch.full((nl, m, 3), 123.0, device=cuda_device),
          torch.full((nl, m, 3), 123.0, device=cuda_device),
          torch.full((nl, m), 123.0, device=cuda_device),
          torch.full((nl, m), 123.0, device=cuda_device)]
    fin = [torch.full((m, 3), 123.0, device=cuda_device) for _ in range(4)]
    before = [t.clone() for t in sh + fin]
    occ = torch.zeros((nl, m), dtype=torch.bool, device=cuda_device)
    err = lib.yrt_shade_prep(ctypes.byref(args), *io, m,
                             *(ptr(t) for t in sh), _build.current_stream())
    _build.check_launch(err, "yrt_shade_prep")
    err = lib.yrt_shade_finish(ctypes.byref(args), *io, ptr(occ), m,
                               *(ptr(t) for t in fin),
                               _build.current_stream())
    _build.check_launch(err, "yrt_shade_finish")
    torch.cuda.synchronize()
    assert all(_same_bits(a, b) for a, b in zip(sh + fin, before))

    def occluder(p, d, tmin_, tmax_, mask):
        res = traverse.intersect_scene_cuda(
            ts, p.reshape(-1, 3), d.reshape(-1, 3), tmin_.reshape(-1),
            torch.where(mask, tmax_, -float(FLT_MAX)).reshape(-1),
            any_hit=True, records=recs)
        return res["hit"].reshape(p.shape[:-1])

    got = shade.shade_bounce_cuda(ts, cro, crd, hits, amb, occluder, one,
                                  meta.has_kd_textures, meta.has_ks_textures,
                                  None, srec)
    want = shade.shade_step(ts, cro, crd, hits, amb,
                            torch.ones(m, dtype=torch.bool,
                                       device=cuda_device), occluder,
                            meta.has_kd_textures, meta.has_ks_textures,
                            records=srec)
    assert all(_same_bits(a, b) for a, b in zip(got, want[:4]))


def _area_hair_host():
    """The hair scene with light1 an emissive 1 m quad and light2 an
    emissive 4-segment polyline, aperture 0.1 (chip_smoke's area hair
    frame, at 64 strands)."""
    host = testscenes.make_hair_scene(64)
    for name, pos, kw in (
            ("light1", [[1.5, 4, 2.5], [2.5, 4, 2.5], [2.5, 4, 3.5],
                        [1.5, 4, 3.5]], dict(triangles=[[0, 1, 2],
                                                        [0, 2, 3]])),
            ("light2", [[-2.5 + dx, 3.5 + 0.1 * dx * dx, -1 + 0.3 * dx]
                        for dx in (-0.8, -0.3, 0.0, 0.4, 0.9)],
             dict(lines=[[0, 1], [1, 2], [2, 3], [3, 4]]))):
        ist = next(i for i in host.instances if i.name == name)
        shp = host.shapes[ist.shape]
        shp.pos = np.asarray(pos, np.float32)
        shp.points = np.zeros(0, np.int32)
        shp.lines = np.asarray(kw.get("lines", ()), np.int32).reshape(-1, 2)
        shp.triangles = np.asarray(kw.get("triangles", ()),
                                   np.int32).reshape(-1, 3)
        shp.norm = np.zeros((0, 3), np.float32)
        shp.texcoord = np.zeros((len(pos), 2), np.float32)
        shp.radius = np.zeros(0, np.float32)
    host.cameras[0].aperture = 0.1
    return scene_lib.finalize_scene(host)


# name: (host, area lights); 160 x 90 at 2 x 2 samples, depth 4, chunks of
# 2,000 pixels: 7 whole chunks and a tail of 400
LOOP_FRAMES = {
    "hair": (lambda: testscenes.make_hair_scene(64), False),
    "mirror": (testscenes.make_grad_scene, False),
    "area_hair": (_area_hair_host, True),
    "area_mirror": (_area_grad_scene, True),
}
LOOP_W, LOOP_H, LOOP_CHUNK = 160, 90, 2000


def _loop_case(name, device):
    make, area = LOOP_FRAMES[name]
    host = make()
    leaves, meta = scene_lib.build_device_scene(host)
    ts = scene_lib.to_torch(leaves, device)
    kw = dict(max_depth=4, chunk_pixels=LOOP_CHUNK)
    if area:
        kw.update(stochastic=True, seed=7, light_sampler=lights.
                  build_light_sampler(host, leaves, meta, device))
    return ts, meta, kw


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(LOOP_FRAMES))
def test_graph_frame_matches_eager(cuda_device, name):
    """The device loop (a CUDA graph of a chunk, replayed) gives the eager
    loop's f32 sums and u8 pixels bit for bit, and its launch counts are
    the eager loop's plus the launches of its dead bounces, and one K13
    launch (its records packed in place)."""
    ts, meta, kw = _loop_case(name, cuda_device)
    npix = LOOP_W * LOOP_H
    for ldr in (False, True):
        kernels.reset_launches()
        eager = renderer.frame_eager(ts, meta, LOOP_W, LOOP_H, 2, ldr=ldr,
                                     **kw)
        counts_eager = dict(kernels.launches)
        kernels.reset_launches()
        with tracer.recording():   # the dead bounces' tally
            dev = renderer.frame_device(ts, meta, LOOP_W, LOOP_H, 2,
                                        ldr=ldr, **kw)
        counts = dict(kernels.launches)
        got = dev[:npix].cpu().numpy()
        assert np.array_equal(got.view(np.uint8), eager.view(np.uint8)), ldr
        dead = kernels.skipped_launches()
        ran = kernels.last_frame()["ran"].cpu()
        chunks = -(-npix // LOOP_CHUNK)
        assert ran.shape == (chunks, kw["max_depth"] + 1)
        assert dead["bounces"] == chunks * kw["max_depth"] - int(
            ran[:, :-1].sum())
        assert counts_eager["bounce"] == counts_eager["records"] == 0
        assert counts["records"] == 1
        assert counts["bounce"] == chunks * kw["max_depth"]
        assert counts["bounce"] - dead["bounces"] == counts_eager["hit"] - \
            counts_eager["hit_any"]   # live bounces: one nearest query each
        for k, v in counts_eager.items():
            if k not in ("bounce", "records"):
                assert counts[k] == v + dead.get(k, 0), k
    if name == "mirror":
        assert int(ran[:, 1].sum()) > 0   # a second bounce ran somewhere
    if name == "hair":
        assert dead["bounces"] == chunks * (kw["max_depth"] - 1)


@pytest.mark.cuda
def test_graph_frame_repeats(cuda_device):
    """Two render_image calls through the device loop: the same bits."""
    ts, meta, kw = _loop_case("area_hair", cuda_device)
    a = renderer.render_image(ts, meta, LOOP_W, LOOP_H, 2, **kw)
    b = renderer.render_image(ts, meta, LOOP_W, LOOP_H, 2, **kw)
    assert np.array_equal(a.view(np.int32), b.view(np.int32))
