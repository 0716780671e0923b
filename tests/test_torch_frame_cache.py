"""The device loop's kept state (``renderer.frame_device``): its cache key,
the staging of its inputs, and its graph.

On the CPU (``frame_device``'s schedule through the plain versions, on the
same cache entry and staging as the card's):

* ``frame_key`` holds every knob that changes a frame's buffers or graph
  (sizes, samples, depth, chunk, ``ldr``, the sampled modes, the light
  sampler, the texture flags, each leaf's and table's shape and dtype) and
  none of the values: a clone of the scene with other values keys alike,
  and so does another seed, sampled modes or not (the entry's seed word
  holds it);
* a call that hits the cache gives ``frame_eager``'s bits after a leaf
  edited in place, with a new scene of the same shapes, a new ``ambient``
  and a new seed, f32 sums and u8, and two configurations alternating give
  each its own frame (seeds in turns: ``tests/test_torch_seed_word.py``);
* a new key frees the old entry (one entry at most), and the returned
  tensor is the loop's own buffer, overwritten by the next call;
* a first call and a repeated one give ``frame_eager``'s bits, f32 sums
  and u8, on the mirror and area hair frames, and the record's host
  stages are the set-up, the capture and the replays;
* on two facing mirrors (``testscenes.make_mirror_pair_scene``) bounces 2
  and 3 run in some chunks, and the frame is ``frame_eager``'s.

On the card (marker ``cuda``): the same cases through the kept CUDA graph
on the hair, mirror, area hair, area mirror and mirror-pair frames, a
cache hit making no capture and keeping its graph; in a repeated frame's
profile the bounce kernels of its live bounces and no other, also those
that run inside IF nodes set by the K12 launch of an IF node's body (the
mirror pair), and ``kernels.made_launches`` counting them; the returned
buffer. The file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_frame_cache.py
"""

import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch

from test_torch_kernels import _area_grad_scene, _area_hair_host
from torch_card import cuda_device  # noqa: F401  (fixture)
from yocto_raytracing_tpu_torch import kernels
from yocto_raytracing_tpu_torch import scene as scene_lib, testscenes
from yocto_raytracing_tpu_torch.render import lights, renderer
from yocto_raytracing_tpu_torch.utils import tracer

# 384 pixels in chunks of 150: two whole chunks and a tail of 84 (CPU)
W, H, SAMPLES, DEPTH, CHUNK = 24, 16, 2, 4, 150
# name: (host, area lights), as test_torch_kernels' device-loop frames
FRAMES = {
    "hair": (lambda: testscenes.make_hair_scene(16), False),
    "mirror": (testscenes.make_grad_scene, False),
    "area_hair": (_area_hair_host, True),
    "area_mirror": (lambda: _area_grad_scene(0.2), True),
    "mirror_pair": (testscenes.make_mirror_pair_scene, False),
}


def _case(name, device):
    """(host, leaves, TorchScene, meta, frame keywords) of a frame."""
    make, area = FRAMES[name]
    host = make()
    leaves, meta = scene_lib.build_device_scene(host)
    ts = scene_lib.to_torch(leaves, device)
    kw = dict(max_depth=DEPTH, chunk_pixels=CHUNK)
    if area:
        kw.update(stochastic=True, seed=3, light_sampler=lights.
                  build_light_sampler(host, leaves, meta, device))
    return host, leaves, ts, meta, kw


def _bits(a):
    return a.view(np.int32) if a.dtype == np.float32 else a


def _device(ts, meta, w=W, h=H, **kw):
    """frame_device's frame on the host, a copy (the loop keeps its
    buffer)."""
    out = renderer.frame_device(ts, meta, w, h, SAMPLES, **kw)
    return out[:w * h].cpu().numpy().copy()


def _check(ts, meta, hit, w=W, h=H, **kw):
    """frame_device == frame_eager bit for bit; the call hit the cache as
    ``hit`` says."""
    got = _device(ts, meta, w, h, **kw)
    assert kernels.last_frame()["cache_hit"] is hit
    want = renderer.frame_eager(ts, meta, w, h, SAMPLES, **kw)
    assert got.dtype == want.dtype
    assert np.array_equal(_bits(got), _bits(want))
    return got


def _key(ts, meta, **kw):
    args = dict(width=W, height=H, samples=SAMPLES, max_depth=DEPTH,
                chunk_pixels=CHUNK, ldr=False, stochastic=False, seed=0,
                light_sampler=None)
    args.update(kw)
    return renderer.frame_key(ts, meta, **args)


def _with(ts, **leaves):
    """A new TorchScene: ``ts``'s leaves, some replaced."""
    return scene_lib.TorchScene(**{
        f.name: leaves.get(f.name, getattr(ts, f.name))
        for f in dataclasses.fields(ts)})


def test_frame_key_ignores_values():
    _, _, ts, meta, _ = _case("mirror", "cpu")
    other = _with(ts, **{k: torch.rand_like(getattr(ts, k))
                         for k in ("pos", "mat_kd", "cam_o", "light_ke")})
    assert _key(ts, meta) == _key(other, meta)
    # no seed keys: a sampled mode reads it from the entry's seed word
    assert _key(ts, meta, seed=5) == _key(ts, meta)
    assert _key(ts, meta, stochastic=True, seed=5) == _key(
        ts, meta, stochastic=True)


KEY_CHANGES = {
    "width": dict(width=W + 1), "height": dict(height=H + 1),
    "samples": dict(samples=SAMPLES + 1), "depth": dict(max_depth=DEPTH + 1),
    "chunk": dict(chunk_pixels=CHUNK + 1), "ldr": dict(ldr=True),
    "stochastic": dict(stochastic=True), "sampler": "sampler",
    "table shape": "table", "seed under a sampler": "sampler seed",
    "kd textures": "kd", "leaf shape": "shape", "leaf dtype": "dtype",
}


# knobs that the entry stages on every call: their keys are alike
KEYS_ALIKE = ("seed under a sampler",)


@pytest.mark.parametrize("change", list(KEY_CHANGES))
def test_frame_key_changes(change):
    """Each knob of ``KEY_CHANGES`` makes another key, but for those of
    ``KEYS_ALIKE``, which the entry stages on every call."""
    _, _, ts, meta, kw = _case("area_mirror", "cpu")
    sampler = kw["light_sampler"]
    base = _key(ts, meta)
    what = KEY_CHANGES[change]
    if isinstance(what, dict):
        other = _key(ts, meta, **what)
    elif what == "sampler":
        other = _key(ts, meta, light_sampler=sampler)
    elif what == "table":
        base = _key(ts, meta, light_sampler=sampler)
        other = _key(ts, meta, light_sampler=dict(
            sampler, cdf=torch.cat([sampler["cdf"], sampler["cdf"][:, -1:]],
                                   1)))
    elif what == "sampler seed":
        base = _key(ts, meta, light_sampler=sampler)
        other = _key(ts, meta, light_sampler=sampler, seed=9)
    elif what == "kd":
        other = _key(ts, dataclasses.replace(
            meta, has_kd_textures=not meta.has_kd_textures))
    elif what == "shape":
        other = _key(_with(ts, pos=torch.cat([ts.pos, ts.pos[:1]])), meta)
    else:
        other = _key(_with(ts, radius=ts.radius.double()), meta)
    assert (other == base) is (change in KEYS_ALIKE)


EDITS = ("repeat", "material in place", "camera in place", "new scene",
         "ambient", "seed")


@pytest.mark.parametrize("edit", EDITS)
@pytest.mark.parametrize("name", ["hair", "area_mirror"])
def test_cache_hit_gives_the_eager_bits(name, edit):
    """A first call (a miss), then one after the edit: the edited inputs'
    frame bit for bit, from the kept entry (a new seed too), but for a new
    ``ldr``."""
    if edit == "seed" and name == "hair":
        edit = "ldr"   # the deterministic frame reads no seed
    _, leaves, ts, meta, kw = _case(name, "cpu")
    renderer._frames.clear()
    _check(ts, meta, False, **kw)
    hit = edit != "ldr"
    if edit == "material in place":
        ts.mat_kd.mul_(0.5)
        ts.light_ke[0].mul_(2.0)
    elif edit == "camera in place":
        ts.cam_o.add_(torch.tensor([0.05, -0.03, 0.1]))
    elif edit == "new scene":
        ts = scene_lib.to_torch(dict(
            leaves, mat_kd=leaves["mat_kd"][::-1].copy(),
            cam_focus=leaves["cam_focus"] * 1.5), "cpu")
    elif edit == "ambient":
        kw["ambient"] = 0.3
    elif edit == "seed":
        kw["seed"] = 4
    elif edit == "ldr":
        kw["ldr"] = True
    _check(ts, meta, hit, **kw)
    _check(ts, meta, True, **kw)


def test_two_configurations_alternate():
    """Two configurations in turns: each call a miss (one entry), each its
    own frame."""
    _, _, ts, meta, kw = _case("mirror", "cpu")
    _, _, ta, ma, kwa = _case("area_mirror", "cpu")
    renderer._frames.clear()
    frames = {}
    for turn in range(4):
        if turn % 2:
            got = _check(ta, ma, False, **kwa)
        else:
            got = _check(ts, meta, False, ldr=True, **kw)
        assert np.array_equal(frames.setdefault(turn % 2, got), got)
        assert len(renderer._frames) == 1


def test_new_key_frees_the_old_entry():
    _, _, ts, meta, kw = _case("hair", "cpu")
    renderer._frames.clear()
    renderer.frame_device(ts, meta, W, H, SAMPLES, **kw)
    (old,) = renderer._frames.values()
    ref = weakref.ref(old)
    ran = weakref.ref(old.ran)
    del old
    renderer.frame_device(ts, meta, W, H + 2, SAMPLES, **kw)
    gc.collect()
    assert ref() is None and ran() is None
    assert len(renderer._frames) == 1
    (new,) = renderer._frames.values()
    assert new.height == H + 2 and new.graph is None   # the CPU: no graph


def test_returned_tensor_is_the_loops_buffer():
    """Valid until the next call: the next frame of the key writes it."""
    _, _, ts, meta, kw = _case("mirror", "cpu")
    renderer._frames.clear()
    a = renderer.frame_device(ts, meta, W, H, SAMPLES, **kw)
    first = a.clone()
    b = renderer.frame_device(ts, meta, W, H, SAMPLES, ambient=0.4, **kw)
    assert b is a and not torch.equal(a, first)
    want = renderer.frame_eager(ts, meta, W, H, SAMPLES, ambient=0.4, **kw)
    assert np.array_equal(_bits(a[:W * H].numpy()), _bits(want))


@pytest.mark.parametrize("ldr", [False, True], ids=["f32", "u8"])
@pytest.mark.parametrize("name", ["mirror", "area_hair"])
def test_frame_device_gives_the_eager_bits(name, ldr):
    """A first call (a miss) and a repeated one (a hit): ``frame_eager``'s
    bits, the same alive words, and the host's milliseconds in the set-up,
    the capture and the replays."""
    _, _, ts, meta, kw = _case(name, "cpu")
    renderer._frames.clear()
    _check(ts, meta, False, ldr=ldr, **kw)
    ran = kernels.last_frame()["ran"].clone()
    _check(ts, meta, True, ldr=ldr, **kw)
    record = kernels.last_frame()
    assert torch.equal(record["ran"], ran)
    assert list(record["host_ms"]) == ["setup", "capture", "replay"]
    assert len(renderer._frames) == 1


def test_bounces_past_the_first_mirror_run():
    """Two facing mirrors: bounces 2 and 3 run in some chunks (and not in
    all), on the first call, the repeated one and after the mirrors' kr is
    edited in place, each frame_eager's bits."""
    _, _, ts, meta, kw = _case("mirror_pair", "cpu")
    renderer._frames.clear()
    for hit in (False, True):
        _check(ts, meta, hit, **kw)
        ran = kernels.last_frame()["ran"]
        assert (ran[:, 2] > 0).any() and (ran[:, 3] > 0).any()
        assert not (ran[:, 2] > 0).all()
    ts.mat_kr.mul_(0.5)
    _check(ts, meta, True, **kw)


def _old_rgba(ts, meta, w, h, max_depth, **kw):
    """``render_image(ldr=True)``'s image as the host assembled it before K3
    wrote RGBA: the three-channel u8 tonemap of the plain pixel finish (sum
    in sample order, / spp, pow(max(x, 0), 1/2.2), clip, * 255, truncate),
    copied into a full-255 (npix, 4) buffer."""
    spp = SAMPLES * SAMPLES
    kw.pop("chunk_pixels", None)
    ids = torch.arange(w * h * spp, dtype=torch.int32)
    rgb = renderer.trace_rays(ts, ids, torch.full((3,), 0.1), w, h, SAMPLES,
                              max_depth, meta.has_kd_textures,
                              meta.has_ks_textures, **kw)
    per = rgb.reshape(-1, spp, 3)
    acc = per[:, 0]
    for k in range(1, spp):
        acc = acc + per[:, k]
    x = acc / torch.tensor(spp, dtype=torch.float32)
    x = torch.pow(torch.clamp(x, min=0.0), renderer.INV_GAMMA)
    out = (torch.clamp(x, 0.0, 1.0) * 255.0).to(torch.uint8).numpy()
    img = np.full((w * h, 4), 255, np.uint8)
    img[:, :3] = out
    return img.reshape(h, w, 4)


@pytest.mark.parametrize("name", ["hair", "area_mirror"])
def test_render_image_rgba_is_the_old_assembly(name):
    """``render_image(ldr=True)`` returns K3's RGBA buffer as copied: a
    C-contiguous (h, w, 4) u8 image, alpha 255, bit-equal to the old host
    assembly of the three tonemapped channels; the image is the call's own,
    not a view of the loop's buffer."""
    _, _, ts, meta, kw = _case(name, "cpu")
    renderer._frames.clear()
    img = renderer.render_image(ts, meta, W, H, SAMPLES, ldr=True, **kw)
    assert img.dtype == np.uint8 and img.shape == (H, W, 4)
    assert img.flags["C_CONTIGUOUS"]
    assert (img[..., 3] == 255).all()
    assert np.array_equal(img, _old_rgba(ts, meta, W, H, **kw))
    (state,) = renderer._frames.values()
    assert not np.shares_memory(img, state.out.numpy())
    again = img.copy()
    renderer.render_image(ts, meta, W, H, SAMPLES, ldr=True, ambient=0.4,
                          **kw)
    assert np.array_equal(img, again)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

# 160 x 90 at 2 x 2 samples, chunks of 2,000 pixels: 7 whole and a tail
CW, CH, CCHUNK = 160, 90, 2000


def _card_case(name, device):
    host, leaves, ts, meta, kw = _case(name, device)
    kw["chunk_pixels"] = CCHUNK
    return leaves, ts, meta, kw


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(FRAMES))
def test_card_cache_cases(cuda_device, name):
    """First call, repeated call (no capture, the same graph), a leaf
    edited in place, a new scene of the same shapes, two configurations
    (``ldr``, and with a sampler a new seed) alternating: each
    frame_eager's bits."""
    leaves, ts, meta, kw = _card_case(name, cuda_device)
    renderer._frames.clear()
    for ldr in (False, True):
        _check(ts, meta, False, CW, CH, ldr=ldr, **kw)
        (state,) = renderer._frames.values()
        graph = state.graph
        _check(ts, meta, True, CW, CH, ldr=ldr, **kw)
        host_ms = kernels.last_frame()["host_ms"]
        assert host_ms["capture"] == 0
        assert renderer._frames[next(iter(renderer._frames))].graph is graph
    ts.mat_kd.mul_(0.5)
    _check(ts, meta, True, CW, CH, ldr=True, **kw)
    new = scene_lib.to_torch(dict(leaves, mat_ks=leaves["mat_ks"] * 0.25,
                                  cam_focus=leaves["cam_focus"] * 1.5),
                             cuda_device)
    _check(new, meta, True, CW, CH, ldr=True, **kw)
    other = dict(kw, seed=8) if "light_sampler" in kw else dict(kw)
    for turn in range(4):   # two keys in turns: a miss each
        args = (kw, True) if turn % 2 else (other, False)
        _check(new, meta, False, CW, CH, ldr=args[1], **args[0])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["hair", "mirror_pair"])
def test_card_dead_bounces_launch_nothing(cuda_device, name):
    """A repeated frame's profile holds the bounce kernels of its live
    bounces only: no K1, K4 or K12 launch in a dead bounce, and every
    launch of a live one, bounces 2 and 3 too on the mirror pair, whose IF
    nodes K12 sets from inside the node before. ``made_launches`` counts
    what the card made (the dead bounces tallied inside
    ``tracer.recording()``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _, ts, meta, kw = _card_case(name, cuda_device)
    renderer._frames.clear()
    renderer.frame_device(ts, meta, CW, CH, SAMPLES, **kw)
    torch.cuda.synchronize()
    kernels.reset_launches()
    with tracer.recording(), \
            profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = _device(ts, meta, CW, CH, **kw)
        torch.cuda.synchronize()
    made = kernels.made_launches()
    ran = kernels.last_frame()["ran"].cpu()
    live = int(ran[:, :-1].sum())
    assert kernels.last_frame()["cache_hit"]
    assert live < ran.shape[0] * DEPTH   # the frame has dead bounces
    if name == "mirror_pair":
        assert ran[:, 2].sum() > 0 and ran[:, 3].sum() > 0
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    for fn in ("hit_nearest_kernel", "hit_any_kernel", "shade_prep_kernel",
               "shade_finish_kernel", "bounce_kernel"):
        assert sum(n.startswith(f"yrt::{fn}(") for n in names) == live, fn
    assert made["bounce"] == made["shade"] == made["hit_any"] == live
    assert made["hit"] == 2 * live
    want = renderer.frame_eager(ts, meta, CW, CH, SAMPLES, **kw)
    assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.cuda
def test_card_returned_tensor_is_the_loops_buffer(cuda_device):
    _, ts, meta, kw = _card_case("mirror", cuda_device)
    renderer._frames.clear()
    a = renderer.frame_device(ts, meta, CW, CH, SAMPLES, **kw)
    first = a.clone()
    b = renderer.frame_device(ts, meta, CW, CH, SAMPLES, ambient=0.4, **kw)
    assert b is a and not torch.equal(a, first)


@pytest.mark.cuda
def test_card_render_image_returns_its_own_buffer(cuda_device):
    """Two successive ``render_image`` calls return distinct page-locked
    copies: the first image is unchanged by the second frame, which differs
    from it."""
    _, ts, meta, kw = _card_case("mirror", cuda_device)
    renderer._frames.clear()
    a = renderer.render_image(ts, meta, CW, CH, SAMPLES, ldr=True, **kw)
    first = a.copy()
    b = renderer.render_image(ts, meta, CW, CH, SAMPLES, ldr=True,
                              ambient=0.4, **kw)
    assert a.shape == b.shape == (CH, CW, 4) and a.dtype == np.uint8
    assert not np.shares_memory(a, b)
    assert np.array_equal(a, first) and not np.array_equal(a, b)
    assert (a[..., 3] == 255).all() and (b[..., 3] == 255).all()
    want = renderer.frame_eager(ts, meta, CW, CH, SAMPLES, ldr=True,
                                ambient=0.4, **kw)
    assert np.array_equal(b.reshape(-1, 4), want)
