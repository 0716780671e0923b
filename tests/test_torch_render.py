"""Port's camera, shading and renderer == the JAX package's.

Both packages compute on the same scene leaves (``from_jax_arrays``):

* camera rays: every ray id of a 64x36, 2x2-sample frame, within 1 ULP
  (JAX run op by op, see test_torch_intersect.py);
* one shading bounce on the same hits: allclose(rtol=1e-5, atol=1e-6), on
  the hair scene and on a textured variant (kd and ks checker textures);
  JAX shades op by op, its shadow walk runs jitted;
* whole frames against JAX ``render_image`` (intersector "bvh"): HDR within
  1e-5, every u8 channel within 1 step after ``image.tonemap``, and the
  device tonemap (``ldr=True``) within 1 step of JAX's;
* the port alone against the reference binary's golden of the hair scene
  (tests/goldens/lines_96_s1.png), which needs no scene assets.
"""

import os
from dataclasses import fields

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from conftest import assert_golden_match
from yocto_raytracing_tpu import image as image_mod
from yocto_raytracing_tpu import procedural
from yocto_raytracing_tpu import scene as jscene, testscenes as jts
from yocto_raytracing_tpu.io import objwriter
from yocto_raytracing_tpu.ops import traverse as jtrav
from yocto_raytracing_tpu.render import camera as jcam
from yocto_raytracing_tpu.render import renderer as jren
from yocto_raytracing_tpu.render import shade as jshade
from yocto_raytracing_tpu_torch import scene as tscene
from yocto_raytracing_tpu_torch import testscenes as tts
from yocto_raytracing_tpu_torch.ops import traverse as ttrav
from yocto_raytracing_tpu_torch.render import camera as tcam
from yocto_raytracing_tpu_torch.render import renderer as tren
from yocto_raytracing_tpu_torch.render import shade as tshade

FLT_MAX = np.float32(3.4028235e38)


def _both(host):
    jd, meta = jscene.build_device_scene(host)
    leaves = {f.name: np.asarray(getattr(jd, f.name))
              for f in fields(jscene.DeviceScene)}
    return jscene.to_jax(jd), tscene.from_jax_arrays(leaves, "cpu"), meta


def _textured_hair_scene():
    host = jts.make_hair_scene(64)
    host.textures = [
        jscene.HostTexture("checker_kd.png", ldr=procedural.make_checker_image(
            64, 48, tile=8, c0=(200, 60, 30, 255), c1=(40, 120, 220, 255))),
        jscene.HostTexture("checker_ks.png", ldr=procedural.make_checker_image(
            32, 32, tile=4, c0=(250, 250, 250, 255), c1=(10, 80, 10, 255))),
    ]
    host.materials[0].kd_txt = 0      # floor
    host.materials[1].ks_txt = 1      # interior sphere
    host.materials[1].ks = np.full(3, 0.5, np.float32)
    return host


def _ordered(x):
    i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
    return np.where(i < 0, -(i & 0x7FFFFFFF), i)


def test_camera_rays_every_ray_id():
    jdev, ts, _ = _both(jts.make_hair_scene(64))
    width, height, samples = 64, 36, 2
    ids = np.arange(width * height * samples * samples, dtype=np.int32)
    with jax.disable_jit():
        _, uv_j = jcam.pixel_uv(jnp.int32(width), jnp.int32(height),
                                jnp.int32(samples), jnp.asarray(ids))
        ro_j, rd_j = jcam.eval_camera(jdev, uv_j)
    uv_t, ro_t, rd_t = tcam.camera_rays(ts, torch.from_numpy(ids), width,
                                        height, samples)
    for a, b, what in ((uv_j, uv_t, "uv"), (ro_j, ro_t, "ro"),
                       (rd_j, rd_t, "rd")):
        d = np.abs(_ordered(a) - _ordered(b.numpy()))
        assert d.max() <= 1, f"{what}: {d.max()} ULP"


def _shade_both(host):
    jdev, ts, meta = _both(host)
    width, height, samples = 48, 27, 1
    n = width * height
    ids = torch.arange(n, dtype=torch.int32)
    _, ro, rd = tcam.camera_rays(ts, ids, width, height, samples)
    ro, rd = ro.contiguous(), rd.contiguous()
    tmin = torch.full((n,), 1e-4)
    hits = ttrav.intersect_scene(ts, ro, rd, tmin, torch.full((n,), FLT_MAX))
    amb = torch.full((3,), 0.1)
    active = torch.ones(n, dtype=torch.bool)

    def occ_t(p, d, tmin_, tmax_, mask):
        res = ttrav.intersect_scene(
            ts, p.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous(),
            tmin_.reshape(-1), torch.where(mask, tmax_, -FLT_MAX).reshape(-1),
            any_hit=True)
        return res["hit"].reshape(p.shape[:-1])

    def occ_j(p, d, tmin_, tmax_, mask):
        # the shadow walk itself runs jitted (op by op it takes minutes)
        with jax.disable_jit(False):
            res = jtrav.intersect_scene(
                jdev, p.reshape(-1, 3), d.reshape(-1, 3), tmin_.reshape(-1),
                jnp.where(mask, tmax_, -FLT_MAX).reshape(-1), any_hit=True)
        return res["hit"].reshape(p.shape[:-1])

    out_t = tshade.shade_step(ts, ro, rd, hits, amb, active, occ_t,
                              meta.has_kd_textures, meta.has_ks_textures)
    jhits = {k: jnp.asarray(v.numpy()) for k, v in hits.items()}
    with jax.disable_jit():
        out_j = jshade.shade_step(
            jdev, jnp.asarray(ro.numpy()), jnp.asarray(rd.numpy()), jhits,
            jnp.asarray(amb.numpy()), jnp.asarray(active.numpy()), occ_j,
            meta.has_kd_textures, meta.has_ks_textures)
    return out_j, out_t, hits


@pytest.mark.parametrize("textured", [False, True], ids=["plain", "textured"])
def test_shade_step(textured):
    host = _textured_hair_scene() if textured else jts.make_hair_scene(64)
    out_j, out_t, hits = _shade_both(host)
    names = ("color", "kr", "p", "refl_dir", "mask")
    for a, b, what in zip(out_j, out_t, names):
        a = np.asarray(a)
        b = b.numpy()
        if what == "mask":
            np.testing.assert_array_equal(a, b)
            continue
        mask = hits["hit"].numpy()
        np.testing.assert_allclose(b[mask], a[mask], rtol=1e-5, atol=1e-6,
                                   err_msg=what)
    assert hits["hit"].numpy().mean() > 0.5
    if textured:  # the checker shows: floor colour varies across hits
        color = out_t[0].numpy()[hits["prim"].numpy() < 2]
        assert color.std(axis=0).max() > 1e-3


FRAMES = [
    ("hair", lambda m: m.make_hair_scene(64), 48, 27),
    ("grad_mirror", lambda m: m.make_grad_scene(), 32, 32),
]


@pytest.mark.parametrize("name,make,width,height", FRAMES,
                         ids=[f[0] for f in FRAMES])
def test_render_image(name, make, width, height):
    jdev, ts, meta = _both(make(jts))
    kw = dict(max_depth=4)
    hdr_j = jren.render_image(jdev, meta, width, height, 2, **kw)
    hdr_t = tren.render_image(ts, meta, width, height, 2, **kw)
    assert hdr_t.shape == (height, width, 4) and hdr_t.dtype == np.float32
    np.testing.assert_allclose(hdr_t, hdr_j, rtol=0, atol=1e-5)
    d = np.abs(image_mod.tonemap(hdr_t).astype(np.int32)
               - image_mod.tonemap(hdr_j))
    assert d.max() <= 1, d.max()
    ldr_j = jren.render_image(jdev, meta, width, height, 2, ldr=True, **kw)
    ldr_t = tren.render_image(ts, meta, width, height, 2, ldr=True, **kw)
    assert ldr_t.dtype == np.uint8 and ldr_t.shape == (height, width, 4)
    assert np.abs(ldr_t.astype(np.int32) - ldr_j).max() <= 1
    assert hdr_t[..., :3].max() > 0.05   # not a black frame


def test_grad_scene_mirror_bounce_contributes():
    _, ts, meta = _both(jts.make_grad_scene())
    one = tren.render_image(ts, meta, 32, 32, 1, max_depth=1)
    two = tren.render_image(ts, meta, 32, 32, 1, max_depth=4)
    assert (np.abs(two - one).max(axis=-1) > 1e-4).sum() > 20


def test_golden_lines_port(goldens_dir, tmp_path):
    """The hair scene against the reference binary's render
    (tests/test_golden.py::test_golden_parity_lines builds the same OBJ)."""
    host = tts.make_hair_scene(256)
    obj = tmp_path / "lines_pointlight.obj"
    objwriter.save_obj(host, str(obj))
    img, *_ = tren.render_scene_file(str(obj), 96, 1, device="cpu")
    assert_golden_match(image_mod.tonemap(img),
                        os.path.join(goldens_dir, "lines_96_s1.png"))


def test_render_scene_file_cuda_without_card_raises(tmp_path, monkeypatch):
    obj = tmp_path / "grad.obj"
    objwriter.save_obj(tts.make_grad_scene(), str(obj))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tren.render_scene_file(str(obj), 16, 1, device="cuda")


def test_pixel_finish_plain():
    rng = np.random.default_rng(3)
    rgb = rng.uniform(-0.1, 2.0, size=(40 * 9, 3)).astype(np.float32)
    sums = tren.pixel_finish(torch.from_numpy(rgb), 9, ldr=False).numpy()
    ref = rgb.reshape(40, 9, 3)
    acc = ref[:, 0]
    for k in range(1, 9):
        acc = acc + ref[:, k]
    np.testing.assert_array_equal(sums, acc)
    u8 = tren.pixel_finish(torch.from_numpy(rgb), 9, ldr=True).numpy()
    assert u8.shape == (40, 4) and (u8[:, 3] == 255).all()
    img = np.ones((40, 1, 4), np.float32)
    img[:, 0, :3] = acc / np.float32(9)
    host = image_mod.tonemap(img)[:, 0]
    assert np.abs(u8.astype(np.int32) - host).max() <= 1

