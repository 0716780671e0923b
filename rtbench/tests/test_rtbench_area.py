"""The ``lines.area_frame`` cell on the CPU at small sizes: its reference
against the port's plain versions, its frame seeds, its checks and its
rooflines.

* the generator's scene is what the port loads from the written OBJ, the
  camera's aperture included;
* ``ref/stochastic.py``'s rays and ``ref/lights.py``'s tables and points
  equal the port's plain versions bit for bit, on seeded ids and seeds;
* a frame's seeds never repeat within a run and follow the run's seed;
* a small run is ``correct``; the control (the reference in bfloat16) and
  the stale-seed fault in its notes are not, nor a run whose frames come
  out under the last frame's seed or 3 u8 steps brighter;
* K7's and K8's work reconciles with the kernel table's bounds.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time

import numpy as np
import pytest
import torch

from rtbench.core import runner, spec
from rtbench.core.trace import TraceData, mfu_percent
from rtbench.drive import area_frames
from rtbench.ref import flat, objwriter
from rtbench.ref import lights as ref_lights
from rtbench.ref import stochastic as ref_stochastic
from rtbench.roofline import k7, k8, peaks
from rtbench.scenes import hair_area

H100 = "NVIDIA H100 80GB HBM3"
# a frame of 43 x 24 at one sample, a capture and one window frame
SMALL = dict(resolution=24, samples=1, keep_frames=2, check_pixels=256,
             warm_hits=0)
SEEDS = (0, 3, 2**31 + 7, 2**32 - 1, 3_000_000_019)


@pytest.fixture(scope="module")
def loaded():
    """(the port's loaded host scene, its TorchScene and meta, its light
    sampler; the reference's leaves and light tables) of the cell's
    scene, on the CPU."""
    from yocto_raytracing_tpu_torch import scene as port_scene
    from yocto_raytracing_tpu_torch.render import lights

    host = hair_area.make(spec.cell("lines.area_frame").config["scene"])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "s.obj")
        objwriter.save_obj(host, path)
        port_host = port_scene.load_scene(path)
    leaves, meta = port_scene.build_device_scene(port_host)
    ts = port_scene.to_torch(leaves, "cpu")
    sampler = lights.build_light_sampler(port_host, leaves, meta, "cpu")
    return host, leaves, ts, meta, sampler, area_frames.reference(host, "cpu")


def test_reference_leaves_are_the_loaded_scene(loaded):
    host, leaves, _, meta, _, _ = loaded
    ref, rmeta = flat.build_device_scene(flat.as_loaded(host))
    assert leaves.keys() == ref.keys()
    for k in leaves:
        a, b = np.asarray(leaves[k]), np.asarray(ref[k])
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
    assert dataclasses.asdict(meta) == dataclasses.asdict(rmeta)
    assert float(leaves["cam_aperture"]) == np.float32(hair_area.APERTURE)
    assert meta.num_lights == 2


def _ids(seed, n=4096, total=910 * 512 * 16):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, total, (n,), generator=g, dtype=torch.int32)


@pytest.mark.parametrize("seed", SEEDS)
def test_reference_rays_are_the_port_s(loaded, seed):
    from yocto_raytracing_tpu_torch.render import camera

    _, _, ts, _, _, (ref_scene, _) = loaded
    ids = _ids(seed % 97)
    want = camera.camera_rays_stochastic_plain(ts, ids, 910, 512, 4, seed)
    got = ref_stochastic.camera_rays_stochastic_plain(ref_scene, ids, 910,
                                                      512, 4, seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert torch.equal(ref_stochastic.per_ray_uniform(seed, ids, 3),
                       camera.per_ray_uniform(seed, ids, 3))


def test_reference_light_tables_are_the_port_s(loaded):
    *_, sampler, (_, tables) = loaded
    assert sampler.keys() == tables.keys()
    for k in sampler:
        assert sampler[k].dtype == tables[k].dtype
        assert torch.equal(sampler[k], tables[k]), k
    assert tables["n"].tolist() == [2, 4]         # the quad, the polyline
    assert not bool(tables["deg"].any())


@pytest.mark.parametrize("seed", SEEDS)
def test_reference_light_points_are_the_port_s(loaded, seed):
    from yocto_raytracing_tpu_torch.render import lights

    _, _, ts, _, sampler, (ref_scene, tables) = loaded
    ids = _ids(seed % 89)
    want = lights.sample_light_points_plain(ts, sampler, ids, seed)
    got = ref_lights.sample_light_points_plain(ref_scene, tables, ids, seed)
    assert got.shape == want.shape == (2, ids.shape[0], 3)
    assert torch.equal(got, want)


def test_frame_seeds_never_repeat_and_follow_the_run():
    base = area_frames.seed_base(2**31 + 3)
    seeds = [area_frames.frame_seed(base, k) for k in range(1 << 16)]
    assert len(set(seeds)) == len(seeds)
    assert all(0 <= s < 2**32 for s in seeds)
    assert base == area_frames.seed_base(2**31 + 3)
    assert base != area_frames.seed_base(2**31 + 4)
    # a bijection on 32 bits: around the wrap too
    top = [area_frames.frame_seed(2**32 - 8, k) for k in range(16)]
    assert len(set(top)) == 16


def _run(monkeypatch=None, how=None, **extra):
    cell = spec.cell("lines.area_frame")
    if how is not None:
        _broken(monkeypatch, how)
    return runner.run_cell(cell, 2**31 + 3, 0.01, False, "cpu", time.time(),
                           dict(SMALL, **extra))


def _broken(monkeypatch, how):
    from yocto_raytracing_tpu_torch.render import renderer

    real = renderer.render_image
    seeds = []

    def render_image(*args, **kw):
        if how == "stale seed":    # the last frame's seed, as a stale word
            seeds.append(kw["seed"])
            kw["seed"] = seeds[-2] if len(seeds) > 1 else seeds[-1]
            return real(*args, **kw)
        out = real(*args, **kw).copy()     # every pixel a few steps brighter
        out[..., :3] = (out[..., :3].astype(int) + 3).clip(0, 255)
        return out

    monkeypatch.setattr(renderer, "render_image", render_image)


def test_small_run_is_correct_and_its_control_is_not():
    """The run is correct; the control and the stale-seed fault that its
    notes hold are not."""
    out = _run(control="bfloat16")
    assert runner.correct(out.compared), out.compared
    assert out.compared["px_off"][0] == 0.0
    for name in ("control", "fault_stale_seed"):
        assert not out.notes[name]["correct"], out.notes
    assert set(out.metrics) == {"frame_Mrays_s", "frame_p95_ms", "setup_s"}


@pytest.mark.parametrize("how", ["stale seed", "altered"])
def test_broken_frames_are_not_correct(monkeypatch, how):
    out = _run(monkeypatch, how)
    assert not runner.correct(out.compared), out.compared


def _tables():
    return dict(cdf=np.array([[0.5, 1.0, 1.0, 1.0], [0.5, 1.0, 1.5, 2.0]],
                             np.float32),
                n=np.array([2, 4]), prim_lo=np.array([0, 2]),
                deg=np.array([False, False]),
                prim_type=np.array([2, 2, 1, 1, 1, 1]))


def test_k7_and_k8_work_and_the_kernel_table_s_bounds():
    """Per ray: K7 183 operations and 36 bytes, K8 39 + 29 + 21 operations
    and 4 + 2 x 12 bytes on a quad and a 4-segment polyline; bound by
    memory, 5.63 and 4.38 us a 524,288-ray chunk."""
    rays = 524_288
    t = TraceData(None, H100, 1, {"camera_rays": rays, "light_rays": rays,
                                  "light_tables": _tables()})
    assert k8.ops_per_light_ray(_tables()) == [29.0, 21.0]
    assert k7.work(t) == (183 * rays, 36 * rays)
    assert k8.work(t) == ((39 + 29 + 21) * rays, 28 * rays)
    assert peaks.bound_s(H100, *k7.work(t)) == pytest.approx(5.634e-6,
                                                             rel=1e-3)
    assert peaks.bound_s(H100, *k8.work(t)) == pytest.approx(4.382e-6,
                                                             rel=1e-3)
    none = TraceData(None, H100, 1, {})
    assert k7.work(none) == (0, 0) and k8.work(none) == (0, 0)


def test_k7_and_k8_shares_over_their_device_time():
    from rtbench.core import profile

    rays = 524_288 * 15
    p = profile.Profile(0.5, 1.0, {
        "yrt::camera_rays_stochastic_kernel(a)": 15 * 9.5e-6,
        "yrt::light_points_kernel(b)": 15 * 8.2e-6}, {}, [])
    t = TraceData(p, H100, 1, {"camera_rays": rays, "light_rays": rays,
                               "light_tables": _tables()})
    assert k7.share(t) == pytest.approx(100 * 5.634 / 9.5, rel=1e-3)
    assert k8.share(t) == pytest.approx(100 * 4.382 / 8.2, rel=1e-3)
    assert mfu_percent(t, (k7, k8)) == pytest.approx(
        100 * (183 + 89) * rays / 67e12, rel=1e-9)
