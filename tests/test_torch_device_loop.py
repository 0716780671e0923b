"""The port's device loop (``renderer.frame_device``, the schedule of the
CUDA graph of a chunk) == the eager loop == the JAX package, on the CPU.

* ``bounce_update_plain`` (K12's plain version) is bit for bit the JAX
  ``trace_rays`` body's state update (renderer.py:297-304, run op by op
  with ``jax.disable_jit``) on random states made with numpy from a seed:
  dead lanes, ``kr`` of 0 and -0.0, NaN colors on masked lanes;
  ``bounce_update`` writes it in place, leaves everything as it was where
  its alive word is 0, and sets the next word where a lane goes on;
* the device loop's schedule (ids from a chunk index, a fixed ``max_depth``
  of bounces, a dead bounce the identity, each chunk's pixels written at
  its rows by ``pixel_finish``) run through the plain versions: f32 sums
  and u8 frames ``torch.equal`` to ``frame_eager`` (the eager per-chunk
  loop) on the hair, mirror and area-light scenes at 32x32 with a tail
  chunk; its count of live bounces equal to the eager loop's nearest-hit
  queries; within JAX ``render_image``'s contract (HDR 1e-5, 1 u8 step),
  and for the area-light frame within 1 u8 step of JAX's ``trace_rays``
  (the no-FMA child, as ``test_torch_lights.py`` holds it);
* ``render_image`` without a checkpoint runs that schedule on the CPU, and
  with one the eager loop, to the same pixels.
"""

from dataclasses import fields

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import jax_nofma
from bounce_states import random_bounce
from test_torch_lights import occluded_scene
from yocto_raytracing_tpu import image as image_mod
from yocto_raytracing_tpu import scene as jscene, testscenes as jts
from yocto_raytracing_tpu.render import lights as jlights
from yocto_raytracing_tpu.render import renderer as jren
from yocto_raytracing_tpu_torch import kernels, scene as tscene
from yocto_raytracing_tpu_torch.ops import traverse as ttrav
from yocto_raytracing_tpu_torch.render import lights as tlights
from yocto_raytracing_tpu_torch.render import renderer as tren

FLT_MAX = np.float32(3.4028235e38)
W = H = 32
SAMPLES, DEPTH = 2, 4
CHUNK = 300       # 1,024 pixels: three whole chunks and a tail of 124


def _jax_body_update(acc, thr, color, kr, p, refl_dir, mask):
    """The JAX trace_rays body's update (renderer.py:297-304), op by op."""
    with jax.disable_jit():
        acc, thr, color, kr, p, refl_dir, mask = map(
            jnp.asarray, (acc, thr, color, kr, p, refl_dir, mask))
        acc = acc + thr * color
        cont = mask & jnp.any(kr > 0, axis=-1)
        thr = jnp.where(cont[:, None], thr * kr, thr)
        p = jnp.where(cont[:, None], p, 0.0)
        refl_dir = jnp.where(cont[:, None], refl_dir, 1.0)
        return [np.asarray(x) for x in (acc, thr, p, refl_dir, cont)]


def _bits(x):
    x = x if torch.is_tensor(x) else torch.from_numpy(np.array(x))
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bounce_update_plain_is_jax_body(seed):
    args = random_bounce(seed)
    want = _jax_body_update(*args)
    got = tren.bounce_update_plain(*(torch.from_numpy(a) for a in args))
    assert np.isnan(args[2]).any() and (np.signbit(args[3])
                                        & (args[3] == 0)).any()
    for name, g, w in zip(("acc", "thr", "ro", "rd", "cont"), got, want):
        assert torch.equal(_bits(g), _bits(w)), name
    assert 0 < int(got[-1].sum()) < len(args[-1])


@pytest.mark.parametrize("seed", [3, 4])
def test_bounce_update_in_place_and_alive_words(seed):
    acc, thr, color, kr, p, refl, mask = (torch.from_numpy(a)
                                          for a in random_bounce(seed))
    want = tren.bounce_update_plain(acc, thr, color, kr, p, refl, mask)
    n = acc.shape[0]
    state = [acc.clone(), thr.clone(), torch.full((n, 3), 7.0),
             torch.full((n, 3), 7.0), torch.zeros(n)]
    before = [t.clone() for t in state]
    alive = torch.tensor([0, 0], dtype=torch.int32)
    tren.bounce_update(*state, color, kr, p, refl, mask, alive[0:1],
                       alive[1:2])
    for a, b in zip(state, before):   # a dead bounce writes nothing
        assert torch.equal(_bits(a), _bits(b))
    assert alive.tolist() == [0, 0]
    alive[0] = 1
    tren.bounce_update(*state, color, kr, p, refl, mask, alive[0:1],
                       alive[1:2])
    for a, b in zip(state[:4], want[:4]):
        assert torch.equal(_bits(a), _bits(b))
    tmax = torch.where(want[4], FLT_MAX.item(), -FLT_MAX.item())
    assert torch.equal(state[4], tmax) and state[4].dtype == torch.float32
    assert alive.tolist() == [1, 1]
    # no lane goes on: the next word stays 0
    alive = torch.tensor([1, 0], dtype=torch.int32)
    tren.bounce_update(*state, color, torch.zeros_like(kr), p, refl, mask,
                       alive[0:1], alive[1:2])
    assert alive.tolist() == [1, 0]


def test_pixel_finish_writes_the_chunk_rows():
    rng = np.random.default_rng(5)
    rgb = torch.from_numpy(rng.uniform(0, 2, (10 * 4, 3)).astype(np.float32))
    for ldr in (False, True):
        out = (torch.zeros((30, 4), dtype=torch.uint8) if ldr
               else torch.zeros((30, 3), dtype=torch.float32))
        got = tren.pixel_finish(rgb, 4, ldr, out=out,
                                chunk=torch.tensor([2], dtype=torch.int32))
        assert got is out
        assert torch.equal(out[20:], tren.pixel_finish(rgb, 4, ldr))
        assert not out[:20].any()
        if ldr:   # RGBA, alpha 255
            assert (out[20:, 3] == 255).all()


def _jax_and_torch(host):
    jd, meta = jscene.build_device_scene(host)
    leaves = {f.name: np.asarray(getattr(jd, f.name))
              for f in fields(jscene.DeviceScene)}
    return jd, meta, leaves, tscene.from_jax_arrays(leaves, "cpu")


def _frames(ts, meta, **kw):
    """(device-loop frame, its record of the bounces that ran, eager frame,
    the eager loop's nearest-hit queries) as numpy: (npix, 3) f32 sums, or
    with ``ldr`` (npix, 4) u8 RGBA."""
    calls = []
    query = ttrav.intersect_scene

    def counting(*args, any_hit=False, **kwargs):
        calls.append(any_hit)
        return query(*args, any_hit=any_hit, **kwargs)

    dev = tren.frame_device(ts, meta, W, H, SAMPLES, max_depth=DEPTH,
                            chunk_pixels=CHUNK, **kw)
    ran = kernels.last_frame()["ran"]
    ttrav.intersect_scene = counting
    try:
        eager = tren.frame_eager(ts, meta, W, H, SAMPLES, max_depth=DEPTH,
                                 chunk_pixels=CHUNK, **kw)
    finally:
        ttrav.intersect_scene = query
    assert dev.shape == (4 * CHUNK, 4 if kw.get("ldr") else 3)
    return dev[:W * H].numpy(), ran, eager, calls.count(False)


def _check_schedule(ts, meta, **kw):
    """The device loop against the eager loop: f32 sums and u8 the same
    bits, live bounces counted alike. Returns the f32 sums."""
    dev, ran, eager, nearest = _frames(ts, meta, **kw)
    assert np.array_equal(dev.view(np.int32), eager.view(np.int32))
    assert ran.shape == (4, DEPTH + 1) and ran[:, 0].tolist() == [1] * 4
    assert int(ran[:, :-1].sum()) == nearest
    # a chunk's live bounces are a prefix of its bounces
    assert (ran[:, 1:] <= ran[:, :-1]).all()
    dev_u8, _, eager_u8, _ = _frames(ts, meta, ldr=True, **kw)
    assert dev_u8.dtype == np.uint8 and np.array_equal(dev_u8, eager_u8)
    return dev, dev_u8, int(ran[:, 1].sum())


def _hdr(sums):
    img = np.ones((W * H, 4), np.float32)
    img[:, :3] = sums / np.float32(SAMPLES * SAMPLES)
    return img.reshape(H, W, 4)


@pytest.mark.parametrize("name", ["hair", "mirror"])
def test_device_loop_schedule(name):
    host = jts.make_hair_scene(16) if name == "hair" else jts.make_grad_scene()
    jd, meta, _, ts = _jax_and_torch(host)
    sums, u8, second = _check_schedule(ts, meta)
    # the mirror's second bounce runs in some chunks; the hair's in none
    assert (second > 0) == (name == "mirror")
    hdr_j = jren.render_image(jscene.to_jax(jd), meta, W, H, SAMPLES,
                              max_depth=DEPTH)
    hdr = _hdr(sums)
    np.testing.assert_allclose(hdr, hdr_j, rtol=0, atol=1e-5)
    d = np.abs(image_mod.tonemap(hdr).astype(np.int32)
               - image_mod.tonemap(hdr_j))
    assert d.max() <= 1
    ldr_j = jren.render_image(jscene.to_jax(jd), meta, W, H, SAMPLES,
                              max_depth=DEPTH, ldr=True)
    assert np.abs(u8.astype(np.int32) - ldr_j.reshape(-1, 4)).max() <= 1
    assert (u8[:, 3] == 255).all()
    assert hdr[..., :3].max() > 0.05


def test_device_loop_schedule_area_lights():
    host_j, host_t = occluded_scene("jax"), occluded_scene("torch")
    jd, meta, leaves, ts = _jax_and_torch(host_j)
    sj = jlights.build_light_sampler(host_j, jd, meta)
    st = tlights.build_light_sampler(host_t, None, meta, "cpu")
    kw = dict(stochastic=True, seed=3, light_sampler=st)
    sums, _, _ = _check_schedule(ts, meta, **kw)
    spp = SAMPLES * SAMPLES
    rgb = jax_nofma.radiance(
        leaves, np.arange(W * H * spp, dtype=np.int32),
        np.full(3, 0.1, np.float32), width=W, height=H, samples=SAMPLES,
        max_depth=DEPTH, stochastic=True, seed=3,
        sampler={k: np.asarray(v) for k, v in sj.items()})["rgb"]
    per = rgb.reshape(-1, spp, 3)
    acc = per[:, 0]
    for k in range(1, spp):
        acc = acc + per[:, k]
    d = np.abs(image_mod.tonemap(_hdr(sums)).astype(np.int32)
               - image_mod.tonemap(_hdr(acc)))
    assert d.max() <= 1
    # the sampled light: not the point-light frame
    point = tren.frame_device(ts, meta, W, H, SAMPLES, max_depth=DEPTH,
                              chunk_pixels=CHUNK)[:W * H].numpy()
    assert np.abs(point - sums).max() > 1e-3


def test_render_image_runs_the_device_loop_on_the_cpu(tmp_path):
    """``render_image`` without a checkpoint runs ``frame_device`` on the
    CPU too (its record is left), with a checkpoint ``frame_eager``: the
    same pixels, f32 and u8."""
    _, meta, _, ts = _jax_and_torch(jts.make_grad_scene())
    kw = dict(max_depth=DEPTH, chunk_pixels=CHUNK)
    for ldr in (False, True):
        kernels.reset_launches()
        img = tren.render_image(ts, meta, W, H, SAMPLES, ldr=ldr, **kw)
        ran = kernels.last_frame()["ran"]
        assert ran.shape == (4, DEPTH + 1)
        ran[:] = -1
        ckpt = tren.render_image(ts, meta, W, H, SAMPLES, ldr=ldr,
                                 checkpoint=str(tmp_path / f"c{ldr}.npz"),
                                 **kw)
        assert (kernels.last_frame()["ran"] == -1).all()   # not run
        assert img.dtype == ckpt.dtype and img.shape == (H, W, 4)
        if ldr:   # the checkpointed frame tonemaps on the host
            d = np.abs(img.astype(np.int32) - ckpt)
            assert d.max() <= 1
        else:
            assert np.array_equal(img.view(np.int32), ckpt.view(np.int32))
        assert kernels.skipped_launches()["bounces"] == 0   # no launch
