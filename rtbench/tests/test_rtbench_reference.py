"""The plain reference against the port's CPU path, at small sizes: the
same leaves, frames, training steps and closest-element answers; and the
roofline counters against the plain walks."""

from __future__ import annotations

import dataclasses
import os
import tempfile

import numpy as np
import pytest
import torch

from rtbench.core import common, spec
from rtbench.drive import frames, queries, steps
from rtbench.ref import flat, objwriter, overlap as ref_overlap
from rtbench.ref import render as ref_render, walk
from rtbench.scenes import hair, refl


@pytest.mark.parametrize("gen,params", [(hair, {"n_strands": 256}),
                                        (refl, {"sphere_segments": [96, 36]})],
                         ids=["hair", "refl"])
def test_reference_leaves_are_the_loaded_scene(gen, params):
    from yocto_raytracing_tpu_torch import scene as port_scene

    host = gen.make(params)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "s.obj")
        objwriter.save_obj(host, path)
        port, pmeta = port_scene.build_device_scene(
            port_scene.load_scene(path))
    ref, rmeta = flat.build_device_scene(flat.as_loaded(host))
    assert port.keys() == ref.keys()
    for k in port:
        a, b = np.asarray(port[k]), np.asarray(ref[k])
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
    assert dataclasses.asdict(pmeta) == dataclasses.asdict(rmeta)


def _loaded(workload, resolution):
    cell = spec.cell(workload)
    cfg = dict(cell.config, render=dict(cell.config["render"],
                                        resolution=resolution))
    return cell, common.load_config_scene(cfg, "cpu")


@pytest.mark.parametrize("workload", ["lines.frame", "refl.frame"])
def test_reference_frame_matches_the_port(workload):
    from yocto_raytracing_tpu_torch.render import renderer

    cell, ld = _loaded(workload, 24)
    p = dict(cell.config["render"], samples=2, max_depth=4,
             check_pixels=ld.width * ld.height)
    axes, o = frames.poses(ld.host.cameras[0], cell.traffic, 5)
    sc = dataclasses.replace(ld.scene, cam_axes=torch.from_numpy(axes[3]),
                             cam_o=torch.from_numpy(o[3]))
    img = renderer.render_image(sc, ld.meta, ld.width, ld.height, 2,
                                ambient=p["ambient"], max_depth=4, ldr=True)
    ref, _, _ = common.reference_scene(ld.host, "cpu")
    assert frames.px_off([(3, img)], ref, axes, o, p, ld.width, ld.height,
                         5) == 0.0
    got = img.reshape(-1, 4)[:, :3].astype(int)
    want = frames.reference_pixels(
        [frames._posed(ref, axes[3], o[3])],
        [np.arange(ld.width * ld.height)], p, ld.width, ld.height)[0]
    assert np.abs(got - want.astype(int)).max() <= 1


def test_reference_step_matches_the_port():
    from yocto_raytracing_tpu_torch.parallel import mesh

    cell, ld = _loaded("refl.train", 24)
    p = dict(cell.config["render"], **cell.traffic)
    n, lr = 512, p["lr"]
    spp = p["samples"] ** 2
    per_ray = steps.target_image(ld.width, ld.height, p,
                                 "cpu").repeat_interleave(spp, dim=0)
    feed = [(torch.arange(off, off + n, dtype=torch.int32),
             per_ray[off:off + n]) for off in (2048, 9000, 4096)]
    amb = torch.full((3,), p["ambient"])
    names = p["trainable"]
    kw = dict(width=ld.width, height=ld.height, samples=p["samples"],
              max_depth=p["max_depth"], trainable=names)
    scene = ld.scene
    prog = dict(losses=[], p0=steps.trained(scene, names))
    for j, (ids, tgt) in enumerate(feed):
        scene, loss = mesh.train_step(scene, ids, tgt, amb, lr, **kw)
        prog["losses"].append(float(loss))
        if j == 0:
            prog["p1"] = steps.trained(scene, names)
    prog["last"] = steps.trained(scene, names)
    assert prog["last"].keys() == set(names)
    ref_scene, _, _ = common.reference_scene(ld.host, "cpu")
    losses, first, p1, last = steps.reference_steps(
        ref_scene, feed, p, ld.width, ld.height, lr)
    ref = dict(losses=losses, first=first, p1=p1, last=last,
               p0=steps.trained(ref_scene, names))
    gaps = steps.gaps(prog, ref, lr)
    assert all(g <= lim for g, lim in zip(
        gaps, (cell.limits[k] for k in ("loss_gap", "grad_gap",
                                        "change_gap")))), gaps


def test_reference_queries_match_the_port():
    from yocto_raytracing_tpu_torch.ops import overlap

    cell = spec.cell("lines.overlap")
    ld = common.load_config_scene(cell.config, "cpu")
    p = dict(cell.traffic, check_queries=256)
    g = torch.Generator()
    g.manual_seed(4)
    lo = torch.tensor(p["box_min"])
    pts = torch.rand((1024, 3), generator=g) * (
        torch.tensor(p["box_max"]) - lo) + lo
    out = overlap.overlap_scene(ld.scene, ld.meta, pts, p["dist_max"])
    ref_scene, ref_meta, _ = common.reference_scene(ld.host, "cpu")
    assert queries.compare([(pts, out)], ref_scene, ref_meta, p, 4) == (
        0.0, 0.0)
    assert 0.1 < float(out["found"].float().mean()) < 0.6


def test_walk_counters_are_the_port_s_plain_walk():
    """The benchmark's frozen walks count what the port's plain walks
    count, on the same rays and queries of the hair scene."""
    from yocto_raytracing_tpu_torch.ops import overlap, traverse

    cell, ld = _loaded("lines.frame", 24)
    ref_scene, ref_meta, _ = common.reference_scene(ld.host, "cpu")
    rng = np.random.default_rng(1)
    ro = torch.from_numpy(rng.uniform(-2, 2, (300, 3)).astype(np.float32))
    rd = torch.from_numpy(rng.normal(size=(300, 3)).astype(np.float32))
    rd = rd / rd.norm(dim=1, keepdim=True)
    tmin = torch.full((300,), 1e-4)
    tmax = torch.full((300,), 3.4e38)
    for any_hit in (False, True):
        mine, theirs = {}, {}
        a = walk.intersect_scene_plain(ref_scene, ro, rd, tmin, tmax,
                                       any_hit, stats=mine)
        b = traverse.intersect_scene_plain(ld.scene, ro, rd, tmin, tmax,
                                           any_hit, stats=theirs)
        assert mine == theirs and mine["nodes"] > 300
        assert all(torch.equal(a[k], b[k]) for k in a)
    q = ro * 0.5 + torch.tensor([0.0, 1.0, 0.0])
    mine, theirs = {}, {}
    a = ref_overlap.overlap_scene_walk_plain(ref_scene, ref_meta, q, 0.2,
                                             stats=mine)
    b = overlap.overlap_scene_walk_plain(ld.scene, ld.meta, q, 0.2,
                                         stats=theirs)
    assert mine == theirs and mine["nodes"] > 0
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_radiance_counts_live_lanes_only():
    """``radiance``'s counts are the walk's on the live lanes of each
    query: a bounce with no live lane adds none."""
    cell, ld = _loaded("lines.frame", 16)
    ref_scene, _, _ = common.reference_scene(ld.host, "cpu")
    ids = torch.arange(0, 200, dtype=torch.int32)
    stats = {}
    rgb = ref_render.trace_rays(ref_scene, ids, torch.full((3,), 0.1),
                                ld.width, ld.height, 1, 4, stats=stats)
    plain = ref_render.trace_rays(ref_scene, ids, torch.full((3,), 0.1),
                                  ld.width, ld.height, 1, 4)
    assert torch.equal(rgb, plain)
    assert stats["nearest"]["rays"] == 200   # hair: no mirror, one bounce
    assert 0 < stats["nearest"]["hits"] <= 200
    assert stats["any"]["rays"] <= 2 * stats["nearest"]["hits"]
