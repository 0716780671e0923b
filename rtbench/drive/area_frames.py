"""Traffic of kind ``area_frames``: one viewer of sampled frames, a fresh
seed each frame.

A closed loop with one caller, as ``frames``: each request is
``renderer.render_image(..., ldr=True, stochastic=True, seed=s,
light_sampler=...)`` with no checkpoint (the device loop), timed from the
call to the u8 image on the host, at the next of ``frames.poses``' orbit
poses (the same poses, in the same seeded order). Every frame, warm-up and
traced ones too, has a seed of its own: ``frame_seed(base, k)`` for the
k-th frame of the run, a bijection of k on 32 bits from a base drawn from
the run's seed, so no seed repeats within a run. A viewer renders each
displayed frame under a new seed so that the noise does not freeze on the
screen and successive frames can be averaged. Set-up writes the
configuration's scene as OBJ/MTL, loads it with the port's
``load_scene``, builds the device scene and the port's light sampler
(``lights.build_light_sampler``) from what it loaded, and runs
``warm_hits`` + 1 frames (one capture, then hits).

End to end, as ``frames``: ``frame_Mrays_s`` and ``frame_p95_ms``.
``correct``: ``keep_frames`` frames of the window drawn from the seed,
``check_pixels`` pixels of each, rendered again by the plain reference
(``rtbench/ref``: its stochastic camera, its own light tables and points,
its depth loop with per-ray lights) at the frame's pose and seed; ``px_off``
is the share of those pixels with a channel more than one u8 step off.
With ``control`` the notes also hold the control (the reference in that
dtype against itself in float32) and the stale-seed fault (the reference
at each kept frame's pose under the seed of the frame before it, what a
seed word left unwritten gives), each with its ``px_off`` and whether it
would pass.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

from rtbench.core import common, spec
from rtbench.core.profile import traced
from rtbench.core.runner import Outcome, correct
from rtbench.core.trace import TraceData
from rtbench.drive.frames import _posed, poses
from rtbench.ref import area as ref_area
from rtbench.ref import flat, objwriter
from rtbench.ref import lights as ref_lights
from rtbench.ref import render as ref_render
from rtbench.ref import stochastic as ref_stochastic

REF_BLOCK_RAYS = 1 << 20   # rays per block of the reference's frames
U32 = 0xFFFFFFFF


def frame_seed(base: int, k: int) -> int:
    """The seed of the run's k-th frame: murmur3's 32-bit finalizer of
    ``base + k``, a bijection on 32 bits, so k < 2^32 frames never share a
    seed."""
    h = (base + k) & U32
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & U32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & U32
    return h ^ (h >> 16)


def seed_base(seed: int) -> int:
    """The run's base of frame seeds, drawn from its seed."""
    return int(np.random.default_rng([seed, 5]).integers(0, 1 << 32))


def load(config: dict, device):
    """(``common.Loaded``, the port's light sampler): the configuration's
    scene made by its generator, written as OBJ/MTL and loaded by the port
    as a user loads a scene file (``load_scene``, ``build_device_scene``,
    ``to_torch``), the sampler built from what was loaded."""
    from yocto_raytracing_tpu_torch import scene as port_scene
    from yocto_raytracing_tpu_torch.render import lights, renderer

    gen = spec.load_module(
        spec.BENCH / "scenes" / f"{config['scene']['generator']}.py",
        "rtbench_scene_" + config["scene"]["generator"])
    host = gen.make(config["scene"])
    with tempfile.TemporaryDirectory(prefix="rtbench-") as tmp:
        path = os.path.join(tmp, "scene.obj")
        objwriter.save_obj(host, path)
        loaded = port_scene.load_scene(path)
    leaves, meta = port_scene.build_device_scene(loaded)
    sampler = lights.build_light_sampler(loaded, leaves, meta, device)
    res = config["render"]["resolution"]
    return common.Loaded(
        host=host, scene=port_scene.to_torch(leaves, device), meta=meta,
        width=renderer.image_width(loaded.cameras[0].aspect, res),
        height=res), sampler


def reference(host, device):
    """The reference's leaves and its own light tables, worked out from
    the generator's scene (``flat.as_loaded``)."""
    as_loaded = flat.as_loaded(host)
    leaves, meta = flat.build_device_scene(as_loaded)
    return (flat.to_device(leaves, device),
            ref_lights.build_light_sampler(as_loaded, meta, device))


def reference_rays(scene, sampler, ids, p, width, height, seed):
    """(ro, rd, light points (L, N, 3)) of ray ids ``ids`` under ``seed``,
    seen through ``scene``'s camera: the reference's stochastic camera and
    light points."""
    _, ro, rd = ref_stochastic.camera_rays_stochastic_plain(
        scene, ids, width, height, p["samples"], seed)
    return ro, rd, ref_lights.sample_light_points_plain(scene, sampler, ids,
                                                        seed)


def reference_pixels(scenes, sampler, pix, seeds, p, width, height):
    """The plain reference's u8 RGB of pixels ``pix[i]`` (sorted (n,) i64
    arrays) of frame ``i`` seen through ``scenes[i]`` under ``seeds[i]``:
    every sample of each pixel, the frames' rays in one depth loop a block
    of ``REF_BLOCK_RAYS``, summed and tonemapped."""
    spp = p["samples"] * p["samples"]
    dev = scenes[0].pos.device
    amb = torch.full((3,), p["ambient"], dtype=scenes[0].pos.dtype,
                     device=dev)
    ro, rd, lp = [], [], []
    for sc, px, seed in zip(scenes, pix, seeds):
        px = torch.as_tensor(px, device=dev)
        ids = (px[:, None] * spp + torch.arange(spp, device=dev)).reshape(-1)
        o, d, lpos = reference_rays(sc, sampler, ids.to(torch.int32), p,
                                    width, height, seed)
        ro.append(o)
        rd.append(d)
        lp.append(lpos)
    ro, rd, lp = torch.cat(ro), torch.cat(rd), torch.cat(lp, 1)
    rgb = torch.cat([
        ref_area.radiance(scenes[0], ro[s:s + REF_BLOCK_RAYS],
                          rd[s:s + REF_BLOCK_RAYS],
                          lp[:, s:s + REF_BLOCK_RAYS], amb, p["max_depth"])
        for s in range(0, ro.shape[0], REF_BLOCK_RAYS)])
    u8 = ref_render.pixel_finish_plain(rgb, spp, True).cpu().numpy()
    return np.split(u8, np.cumsum([len(x) for x in pix])[:-1])


def px_off(images, ref, axes, o, p, width, height, seed, dtype=None,
           seeds=None):
    """The share of the sampled pixels of ``images`` ([(pose index, seed,
    (H, W, 4) u8)]) with a channel more than one u8 step off the
    reference's at the frame's pose and seed. With ``dtype`` the reference
    runs in it (the control) and is compared with itself in float32; with
    ``seeds`` the reference under those seeds is compared with it under the
    frames' own (a fault)."""
    ref_scene, sampler = ref
    rng = np.random.default_rng([seed, 3])
    pix = [np.sort(rng.choice(width * height, p["check_pixels"],
                              replace=False)) for _ in images]
    scenes = [_posed(ref_scene, axes[pose], o[pose])
              for pose, _, _ in images]
    own = [s for _, s, _ in images]
    want = reference_pixels(scenes, sampler, pix, own, p, width, height)
    if dtype is not None:
        got = reference_pixels([flat.lowered(sc, dtype) for sc in scenes],
                               sampler, pix, own, p, width, height)
    elif seeds is not None:
        got = reference_pixels(scenes, sampler, pix, seeds, p, width, height)
    else:
        got = [img.reshape(-1, 4)[px, :3]
               for (_, _, img), px in zip(images, pix)]
    off = sum(int((np.abs(g.astype(np.int32) - w.astype(np.int32)).max(1)
                   > 1).sum()) for g, w in zip(got, want))
    return off / sum(len(x) for x in pix)


def run(cell, seed, seconds, trace, device, t_start, sizes):
    from yocto_raytracing_tpu_torch import kernels
    from yocto_raytracing_tpu_torch.render import renderer

    p = {**cell.config["render"], **cell.traffic, **sizes}
    if not (p["stochastic"] and p["area_lights"]):
        raise ValueError("area_frames traffic renders stochastic frames with "
                         "area lights: the configuration asks for "
                         f"stochastic {p['stochastic']}, area lights "
                         f"{p['area_lights']}")
    loaded, sampler = load(
        dict(cell.config, render=dict(cell.config["render"],
                                      resolution=p["resolution"])), device)
    loaded_s = time.time() - t_start
    width, height, meta = loaded.width, loaded.height, loaded.meta
    axes, o = poses(loaded.host.cameras[0], p, seed)
    axes_t = torch.from_numpy(axes).to(device)
    o_t = torch.from_numpy(o).to(device)
    n_poses = len(axes)
    rays = width * height * p["samples"] ** 2
    base = seed_base(seed)

    def frame(k):
        sc = dataclasses.replace(loaded.scene, cam_axes=axes_t[k % n_poses],
                                 cam_o=o_t[k % n_poses])
        return renderer.render_image(
            sc, meta, width, height, p["samples"], ambient=p["ambient"],
            max_depth=p["max_depth"], ldr=True, stochastic=True,
            seed=frame_seed(base, k), light_sampler=sampler)

    for k in range(p["warm_hits"] + 1):     # one capture, then hits
        frame(k)
    first = p["warm_hits"] + 1
    setup_s = time.time() - t_start

    keep = common.Reservoir(p["keep_frames"], np.random.default_rng([seed, 2]))
    lat = []
    t0 = time.perf_counter()
    k = 0
    while True:
        a = time.perf_counter()
        img = frame(first + k)
        b = time.perf_counter()
        lat.append(b - a)
        keep.offer((first + k, img))
        k += 1
        if b - t0 >= seconds:
            break
    elapsed = b - t0
    t_window = time.perf_counter()
    mem = (torch.cuda.max_memory_allocated(device)
           if torch.device(device).type == "cuda" else 0)
    metrics = dict(frame_Mrays_s=k * rays / elapsed / 1e6,
                   frame_p95_ms=common.p95(lat) * 1e3, setup_s=setup_s)

    data = None
    if trace:
        nxt = [first + k]

        def window(count):
            recs = []
            for _ in range(count):
                frame(nxt[0])
                last = kernels.last_frame()
                recs.append((nxt[0] % n_poses, frame_seed(base, nxt[0]),
                             sum(last["host_ms"].values()),
                             int(last["ran"][:, :-1].sum()),
                             int(last["ran"].shape[0])))
                nxt[0] += 1
            return recs

        def expect(recs):
            live = sum(r[3] for r in recs)
            chunks = sum(r[4] for r in recs)
            return {"hit_nearest_kernel": live, "shade_finish_kernel": live,
                    "camera_rays_stochastic_kernel": chunks,
                    "light_points_kernel": chunks}

        prof = traced(window, p["trace_frames"], expect, p["name_frames"])
        data = _trace_data(prof, loaded, p, axes, o, width, height, seed,
                           device)

    # the program's part is over: the reference runs on what is left
    host = loaded.host
    del loaded, sampler
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = reference(host, device)
    kept = [(j % n_poses, frame_seed(base, j), img) for j, img in keep.items]
    share = px_off(kept, ref, axes, o, p, width, height, seed)
    notes = {"phases_s": dict(
        loaded=loaded_s, setup=setup_s, window=t_window - t0,
        trace=t_ref - t_window, reference=time.perf_counter() - t_ref)}
    if p.get("control"):     # the control and the stale-seed fault
        limit = cell.limits["px_off"]
        for name, kw in (
                ("control", dict(dtype=getattr(torch, p["control"]))),
                ("fault_stale_seed", dict(seeds=[
                    frame_seed(base, j - 1) for j, _ in keep.items]))):
            c = {"px_off": (px_off(kept, ref, axes, o, p, width, height,
                                   seed, **kw), limit)}
            notes[name] = dict(px_off=c["px_off"][0], correct=correct(c))
    return Outcome(metrics=metrics, attempted=k, failed=0,
                   compared={"px_off": (share, cell.limits["px_off"])},
                   memory_peak_bytes=int(mem), trace=data, notes=notes)


def _trace_data(prof, loaded, p, axes, o, width, height, seed, device):
    recs = prof.records
    n = len(recs)
    spp = p["samples"] ** 2
    chunk = min(1 << 15, width * height) * spp
    host = loaded.host

    def hit_counts():
        """The plain walk's work on ``walk_rays`` rays drawn from the seed
        among every traced frame's, each at its frame's pose and seed with
        its own light points, in one depth loop, scaled to every ray of
        every traced frame."""
        rng = np.random.default_rng([seed, 4])
        ref_scene, sampler = reference(host, device)
        amb = torch.full((3,), p["ambient"], device=device)
        per = max(1, p["walk_rays"] // n)
        ro, rd, lp = [], [], []
        for pose, fseed, *_ in recs:
            ids = torch.as_tensor(np.sort(rng.choice(
                width * height * spp, per, replace=False)),
                dtype=torch.int32, device=device)
            a, b, c = reference_rays(_posed(ref_scene, axes[pose], o[pose]),
                                     sampler, ids, p, width, height, fseed)
            ro.append(a)
            rd.append(b)
            lp.append(c)
        stats: dict = {}
        ref_area.radiance(ref_scene, torch.cat(ro), torch.cat(rd),
                          torch.cat(lp, 1), amb, p["max_depth"], stats=stats)
        scale = width * height * spp / per
        return {q: {k: v * scale for k, v in c.items()}
                for q, c in stats.items()}

    leaves = common.reference_scene(host, "cpu")[2]
    _, tables = reference(host, "cpu")
    return TraceData(prof, torch.cuda.get_device_name(0)
                     if torch.device(device).type == "cuda" else "cpu", n, {
        "host_ms": [r[2] for r in recs],
        "hit_counts": hit_counts,
        "hit_leaves_bytes": n * common.leaves_bytes(leaves,
                                                    common.HIT_LEAVES),
        "shade_lanes": sum(r[3] for r in recs) * chunk,
        "shade_leaves_bytes": n * common.leaves_bytes(leaves,
                                                      common.SHADE_LEAVES),
        "camera_rays": n * width * height * spp,
        "light_rays": n * width * height * spp,
        "light_tables": dict(tables, prim_type=leaves["prim_type"]),
    })
