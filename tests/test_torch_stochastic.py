"""The port's stochastic camera (jittered AA + thin-lens DOF) == the JAX
package's.

Both packages compute on the same inputs (numpy seeds, scene leaves through
``from_jax_arrays``); the JAX side runs op by op (``jax.disable_jit``), or,
for whole frames, jitted in the no-FMA child (``tests/jax_nofma.py``):

* PCG variates (``pcg_hash``, ``per_ray_uniform``) and the jittered uv:
  bit-equal, for seeds {0, 3, 7, 2**32 - 1} and ids up to 2**31 - 1;
* ``sample_triangle``, ``sample_discrete`` and ``eval_camera_dof`` (on the
  same lens samples): bit-equal; ``sample_disk`` and the other cos/sin
  samplers: within ``TRIG_ULP`` (PyTorch's CPU cos/sin against XLA:CPU's);
* the whole ray chain: uv bit-equal, the origin within ``TRIG_ULP`` (the
  lens sample's gap), the unit direction within ``DIR_ABS`` = 2 ULP of 1.0
  (its small components cancel in q - ro, so their own ULP count says
  little: up to 106 ULP found on a component of 1.3e-4);
* frames (48x32, 2x2 samples, depth 2, ``make_random_scene(seed=2)``, with
  and without an aperture): every u8 channel within 1 step after
  ``image.tonemap``;
* the port's own laws, as ``tests/test_stochastic.py`` states them for
  JAX: seed-determinism, seed-sensitivity, chunk invariance, zero aperture
  = pinhole, DOF rays meet on the focus plane.
"""

from dataclasses import fields

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import jax_nofma
from yocto_raytracing_tpu import image as image_mod
from yocto_raytracing_tpu import scene as jscene, testscenes as jts
from yocto_raytracing_tpu.ops import sampling as jsamp
from yocto_raytracing_tpu.render import camera as jcam
from yocto_raytracing_tpu_torch import scene as tscene
from yocto_raytracing_tpu_torch.ops import sampling as tsamp
from yocto_raytracing_tpu_torch.render import camera as tcam
from yocto_raytracing_tpu_torch.render import renderer as tren

SEEDS = [0, 3, 7, 2**32 - 1]
TRIG_ULP = 2   # torch CPU cos/sin vs XLA:CPU cos/sin, largest gap found
DIR_ABS = 2 * 2.0 ** -23   # 2 ULP of a unit vector's length
IDS = np.concatenate([np.arange(4096), [2**31 - 1, 2**31 - 2, 123456789,
                                        987654321]]).astype(np.int32)


def _ordered(x):
    i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
    return np.where(i < 0, -(i & 0x7FFFFFFF), i)


def _ulp(a, b):
    return int(np.abs(_ordered(np.asarray(a)) - _ordered(np.asarray(b))).max())


def _both(host):
    jd, meta = jscene.build_device_scene(host)
    leaves = {f.name: np.asarray(getattr(jd, f.name))
              for f in fields(jscene.DeviceScene)}
    return (jscene.to_jax(jd), tscene.from_jax_arrays(leaves, "cpu"), meta,
            leaves)


def _dof_scene(aperture=0.5, seed=2):
    host = jts.make_random_scene(seed=seed)
    host.cameras[0].aperture = aperture
    return host


@pytest.mark.parametrize("seed", SEEDS)
def test_pcg_variates_bit_equal(seed):
    with jax.disable_jit():
        h_j = np.asarray(jcam._pcg_hash(jnp.asarray(IDS.astype(np.uint32)
                                                    ^ np.uint32(seed))))
        r_j = np.asarray(jcam.per_ray_uniform(jnp.uint32(seed),
                                              jnp.asarray(IDS), 3))
    h_t = tcam.pcg_hash(torch.from_numpy(IDS).to(torch.int64)
                        ^ seed).numpy()
    np.testing.assert_array_equal(h_t, h_j.astype(np.int64))
    r_t = tcam.per_ray_uniform(seed, torch.from_numpy(IDS), 3)
    assert r_t.dtype == torch.float32 and r_t.shape == (len(IDS), 3)
    np.testing.assert_array_equal(r_t.numpy(), r_j)
    assert 0.0 <= r_t.min() and r_t.max() < 1.0


@pytest.mark.parametrize("seed", [0, 2**32 - 1])
def test_pixel_uv_jittered_bit_equal(seed):
    width, height, samples = 37, 23, 3
    ids = np.arange(width * height * samples * samples, dtype=np.int32)
    with jax.disable_jit():
        pix_j, uv_j = jcam.pixel_uv_jittered(
            jnp.int32(width), jnp.int32(height), jnp.int32(samples),
            jnp.asarray(ids), jnp.uint32(seed))
    pix_t, uv_t = tcam.pixel_uv_jittered(width, height, samples,
                                         torch.from_numpy(ids), seed)
    np.testing.assert_array_equal(pix_t.numpy(), np.asarray(pix_j))
    np.testing.assert_array_equal(uv_t.numpy(), np.asarray(uv_j))
    # each sample stays in its stratification cell
    _, uv_c = tcam.pixel_uv(width, height, samples, torch.from_numpy(ids))
    cell = 0.5 / samples
    assert float((uv_t - uv_c).abs()[:, 0].max()) <= cell / width + 1e-6


def test_sample_triangle_and_discrete_bit_equal():
    rng = np.random.default_rng(4)
    ruv = rng.uniform(0, 1, (5000, 2)).astype(np.float32)
    v = [rng.uniform(-2, 2, (5000, 3)).astype(np.float32) for _ in range(3)]
    cdf = np.cumsum(rng.uniform(0, 1, 17)).astype(np.float32)
    r = rng.uniform(0, 1, 5000).astype(np.float32)
    with jax.disable_jit():
        bary_j = jsamp.sample_triangle(jnp.asarray(ruv))
        pt_j = jsamp.sample_triangle(jnp.asarray(ruv), *map(jnp.asarray, v))
        idx_j = jsamp.sample_discrete(jnp.asarray(cdf), jnp.asarray(r))
    tv = [torch.from_numpy(x) for x in v]
    np.testing.assert_array_equal(
        tsamp.sample_triangle(torch.from_numpy(ruv)).numpy(),
        np.asarray(bary_j))
    np.testing.assert_array_equal(
        tsamp.sample_triangle(torch.from_numpy(ruv), *tv).numpy(),
        np.asarray(pt_j))
    np.testing.assert_array_equal(
        tsamp.sample_discrete(torch.from_numpy(cdf),
                              torch.from_numpy(r)).numpy(),
        np.asarray(idx_j))
    np.testing.assert_array_equal(tsamp.sample_points_cdf(5),
                                  jsamp.sample_points_cdf(5))


TRIG_SAMPLERS = ["sample_disk", "sample_hemisphere", "sample_sphere",
                 "sample_hemisphere_cosine", "sample_cylinder"]


@pytest.mark.parametrize("name", TRIG_SAMPLERS)
def test_trig_samplers_within_ulp(name):
    ruv = np.random.default_rng(5).uniform(0, 1, (50000, 2)).astype(
        np.float32)
    with jax.disable_jit():
        a = np.asarray(getattr(jsamp, name)(jnp.asarray(ruv)))
    b = getattr(tsamp, name)(torch.from_numpy(ruv)).numpy()
    assert b.dtype == np.float32 and b.shape == a.shape
    assert _ulp(a, b) <= TRIG_ULP, _ulp(a, b)


def test_eval_camera_dof_bit_equal():
    jdev, ts, _, _ = _both(_dof_scene())
    rng = np.random.default_rng(6)
    uv = rng.uniform(0, 1, (4096, 2)).astype(np.float32)
    lens = np.asarray(tsamp.sample_disk(torch.from_numpy(
        rng.uniform(0, 1, (4096, 2)).astype(np.float32))))[:, :2]
    with jax.disable_jit():
        ro_j, rd_j = jcam.eval_camera_dof(jdev, jnp.asarray(uv),
                                          jnp.asarray(lens))
    ro_t, rd_t = tcam.eval_camera_dof(ts, torch.from_numpy(uv),
                                      torch.from_numpy(lens))
    np.testing.assert_array_equal(ro_t.numpy(), np.asarray(ro_j))
    np.testing.assert_array_equal(rd_t.numpy(), np.asarray(rd_j))


@pytest.mark.parametrize("seed", [0, 4, 7])
def test_camera_rays_stochastic_matches_jax_chain(seed):
    """The port's ray chain against renderer.py:214-227 of JAX, op by op."""
    jdev, ts, _, _ = _both(_dof_scene())
    width, height, samples = 24, 16, 2
    ids = np.arange(width * height * samples * samples, dtype=np.int32)
    with jax.disable_jit():
        s = jnp.uint32(seed)
        _, uv_j = jcam.pixel_uv_jittered(jnp.int32(width), jnp.int32(height),
                                         jnp.int32(samples),
                                         jnp.asarray(ids), s)
        ruv = jcam.per_ray_uniform(s ^ jnp.uint32(0x9E3779B9),
                                   jnp.asarray(ids), 2)
        lens_j = np.array(jsamp.sample_disk(ruv)[:, :2])
        ro_j, rd_j = jcam.eval_camera_dof(jdev, uv_j, jnp.asarray(lens_j))
    uv_t, ro_t, rd_t = tcam.camera_rays_stochastic(
        ts, torch.from_numpy(ids), width, height, samples, seed)
    np.testing.assert_array_equal(uv_t.numpy(), np.asarray(uv_j))
    assert _ulp(ro_j, ro_t.numpy()) <= TRIG_ULP
    assert np.abs(np.asarray(rd_j) - rd_t.numpy()).max() <= DIR_ABS
    assert float((ro_t - ts.cam_o).abs().max()) > 1e-3   # a real aperture
    # on JAX's own lens samples the rest of the chain is bit-equal
    ro2, rd2 = tcam.eval_camera_dof(ts, uv_t, torch.from_numpy(lens_j))
    np.testing.assert_array_equal(ro2.numpy(), np.asarray(ro_j))
    np.testing.assert_array_equal(rd2.numpy(), np.asarray(rd_j))


def _frame_pair(host, width, height, samples, max_depth, seed):
    _, ts, meta, leaves = _both(host)
    spp = samples * samples
    ids = np.arange(width * height * spp, dtype=np.int32)
    amb = np.full(3, 0.1, np.float32)
    rgb = jax_nofma.radiance(leaves, ids, amb, width=width, height=height,
                             samples=samples, max_depth=max_depth,
                             stochastic=True, seed=seed)["rgb"]
    per = rgb.reshape(-1, spp, 3)
    acc = per[:, 0]
    for k in range(1, spp):
        acc = acc + per[:, k]
    hdr_j = np.ones((width * height, 4), np.float32)
    hdr_j[:, :3] = acc / np.float32(spp)
    hdr_j = hdr_j.reshape(height, width, 4)
    hdr_t = tren.render_image(ts, meta, width, height, samples,
                              max_depth=max_depth, stochastic=True,
                              seed=seed)
    return hdr_j, hdr_t, ts, meta


@pytest.mark.parametrize("aperture", [0.0, 0.3], ids=["jitter", "dof"])
def test_stochastic_frame_matches_jax(aperture):
    hdr_j, hdr_t, _, _ = _frame_pair(_dof_scene(aperture), 48, 32, 2, 2,
                                     seed=11)
    assert hdr_t.shape == (32, 48, 4) and hdr_t.dtype == np.float32
    d = np.abs(image_mod.tonemap(hdr_t).astype(np.int32)
               - image_mod.tonemap(hdr_j))
    assert d.max() <= 1, (d.max(), int((d > 1).any(axis=-1).sum()))
    assert hdr_t[..., :3].max() > 0.01        # not a black frame


def _render(ts, meta, **kw):
    kw = dict(dict(max_depth=2, stochastic=True, seed=3), **kw)
    return tren.render_image(ts, meta, 40, 24, 2, **kw)


def test_stochastic_frame_laws():
    """Same seed: identical; another seed: different; any chunk size:
    identical pixels; the deterministic frame differs from both."""
    _, ts, meta, _ = _both(_dof_scene(0.3))
    a = _render(ts, meta)
    np.testing.assert_array_equal(a, _render(ts, meta))
    np.testing.assert_array_equal(
        _render(ts, meta, chunk_pixels=1 << 10),
        _render(ts, meta, chunk_pixels=1 << 6))
    np.testing.assert_array_equal(a, _render(ts, meta, chunk_pixels=1 << 6))
    assert np.abs(a - _render(ts, meta, seed=4)).max() > 1e-3
    assert np.abs(a - _render(ts, meta, stochastic=False)).max() > 1e-3


def test_zero_aperture_gives_pinhole_rays():
    _, ts, _, _ = _both(jts.make_random_scene(seed=1))   # aperture 0
    uv = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 1, (256, 2)).astype(np.float32))
    lens = torch.from_numpy(np.random.default_rng(2).uniform(
        -1, 1, (256, 2)).astype(np.float32))
    ro0, rd0 = tcam.eval_camera(ts, uv)
    ro1, rd1 = tcam.eval_camera_dof(ts, uv, lens)
    np.testing.assert_array_equal(ro0.numpy(), ro1.numpy())
    np.testing.assert_array_equal(rd0.numpy(), rd1.numpy())


def test_dof_rays_meet_on_focus_plane():
    _, ts, _, _ = _both(_dof_scene(0.5, seed=0))
    uv = torch.tensor([[0.3, 0.6]] * 8)
    lens = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (8, 2)).astype(np.float32))
    lens = lens / torch.clamp(torch.linalg.vector_norm(lens, dim=-1,
                                                       keepdim=True), min=1)
    ro, rd = (x.numpy() for x in tcam.eval_camera_dof(ts, uv, lens))
    z = ts.cam_axes[2].numpy()
    o = ts.cam_o.numpy()
    t = (float(ts.cam_focus) - (ro - o) @ (-z)) / (rd @ (-z))
    pts = ro + rd * t[:, None]
    assert np.abs(pts - pts[0]).max() < 1e-4
    assert np.abs(ro - ro[0]).max() > 1e-3
