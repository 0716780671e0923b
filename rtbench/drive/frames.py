"""Traffic of kind ``frames``: one viewer asking for frame after frame.

A closed loop with one caller: each request is
``renderer.render_image(..., ldr=True)`` with no checkpoint (the device
loop's kept graph), timed from the call to the u8 image on the host, at a
new camera pose. The poses orbit the configuration camera's target at its
distance: ``poses`` of them, the centres of a grid of azimuth by
elevation cells within ``azimuth_deg`` and ``elevation_deg`` of the
camera's own, in an order drawn from the seed, so every seed asks for the
same work in another order. Set-up loads the scene,
makes the poses and runs ``warm_hits`` + 1 frames (one capture, then
hits).

End to end: ``frame_Mrays_s``, the primary rays of every frame of the
window over its seconds, and ``frame_p95_ms`` over all its frames.
``correct``: ``keep_frames`` frames of the window drawn from the seed,
``check_pixels`` pixels of each drawn from the seed, rendered again by the
plain reference (``rtbench/ref``) from the generator's arrays at the same
pose; ``px_off`` is the share of those pixels with a channel more than one
u8 step off.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from rtbench.core import common
from rtbench.core.profile import traced
from rtbench.core.runner import Outcome, correct
from rtbench.core.trace import TraceData
from rtbench.ref import camera as ref_camera
from rtbench.ref import flat
from rtbench.ref import render as ref_render
from rtbench.ref.shapes import lookat_camera

REF_BLOCK_RAYS = 1 << 20   # rays per block of the reference's frames


def poses(camera, params: dict, seed: int):
    """(axes (P, 3, 3), o (P, 3)) float32: the mix's orbit of ``camera``."""
    rng = np.random.default_rng([seed, 1])
    axes = np.asarray(camera.axes, np.float64)
    o = np.asarray(camera.o, np.float64)
    target = o - axes[2] * float(camera.focus)
    rel = o - target
    r = float(np.linalg.norm(rel))
    az0 = math.atan2(rel[0], rel[2])
    el0 = math.asin(rel[1] / r)
    n_el = max(1, int(round(math.sqrt(params["poses"]))))
    n_az = params["poses"] // n_el
    cell_az = 2 * params["azimuth_deg"] / n_az
    cell_el = 2 * params["elevation_deg"] / n_el
    ia, ie = np.meshgrid(np.arange(n_az), np.arange(n_el), indexing="ij")
    daz = -params["azimuth_deg"] + (ia.ravel() + 0.5) * cell_az
    de = -params["elevation_deg"] + (ie.ravel() + 0.5) * cell_el
    order = rng.permutation(ia.size)
    out_axes, out_o = [], []
    for k in order:
        az = az0 + math.radians(daz[k])
        el = el0 + math.radians(de[k])
        eye = target + r * np.array([math.cos(el) * math.sin(az),
                                     math.sin(el),
                                     math.cos(el) * math.cos(az)])
        cam = lookat_camera("pose", eye, target)
        out_axes.append(cam.axes)
        out_o.append(cam.o)
    return np.stack(out_axes), np.stack(out_o)


def reference_pixels(scenes, pix, p: dict, width: int, height: int):
    """The plain reference's u8 RGB of pixels ``pix[i]`` (sorted (n,) i64
    arrays) of frame ``i`` seen through ``scenes[i]`` (the leaves at its
    pose): every sample of each pixel, the frames' rays in one depth loop
    a block of ``REF_BLOCK_RAYS``, summed and tonemapped."""
    spp = p["samples"] * p["samples"]
    dev = scenes[0].pos.device
    dt = scenes[0].pos.dtype
    amb = torch.full((3,), p["ambient"], dtype=dt, device=dev)
    ro, rd = [], []
    for sc, px in zip(scenes, pix):
        px = torch.as_tensor(px, device=dev)
        ids = (px[:, None] * spp + torch.arange(spp, device=dev)).reshape(-1)
        _, o, d = ref_camera.camera_rays_plain(sc, ids.to(torch.int32),
                                               width, height, p["samples"])
        ro.append(o)
        rd.append(d)
    ro, rd = torch.cat(ro), torch.cat(rd)
    rgb = torch.cat([
        ref_render.radiance(scenes[0], ro[s:s + REF_BLOCK_RAYS],
                            rd[s:s + REF_BLOCK_RAYS], amb, p["max_depth"])
        for s in range(0, ro.shape[0], REF_BLOCK_RAYS)])
    u8 = ref_render.pixel_finish_plain(rgb, spp, True).cpu().numpy()
    return np.split(u8, np.cumsum([len(x) for x in pix])[:-1])


def px_off(images, ref_scene, axes, o, p, width, height, seed, dtype=None):
    """The share of the sampled pixels of ``images`` ([(pose index, (H, W,
    4) u8)]) with a channel more than one u8 step off the reference's. With
    ``dtype`` the reference runs in it (the control) and is compared with
    itself in float32."""
    rng = np.random.default_rng([seed, 3])
    pix = [np.sort(rng.choice(width * height, p["check_pixels"],
                              replace=False)) for _ in images]
    scenes = [_posed(ref_scene, axes[pose], o[pose]) for pose, _ in images]
    want = reference_pixels(scenes, pix, p, width, height)
    if dtype is None:
        got = [img.reshape(-1, 4)[px, :3] for (_, img), px in zip(images, pix)]
    else:
        got = reference_pixels([flat.lowered(sc, dtype) for sc in scenes],
                               pix, p, width, height)
    off = sum(int((np.abs(g.astype(np.int32) - w.astype(np.int32)).max(1)
                   > 1).sum()) for g, w in zip(got, want))
    return off / sum(len(x) for x in pix)


def _posed(scene, axes, o):
    """The reference's leaves with the camera at a pose."""
    out = type(scene)(**vars(scene))
    out.cam_axes = torch.as_tensor(axes, device=scene.pos.device).to(
        scene.pos.dtype)
    out.cam_o = torch.as_tensor(o, device=scene.pos.device).to(
        scene.pos.dtype)
    return out


def run(cell, seed, seconds, trace, device, t_start, sizes):
    from yocto_raytracing_tpu_torch import kernels
    from yocto_raytracing_tpu_torch.render import renderer

    p = {**cell.config["render"], **cell.traffic, **sizes}
    loaded = common.load_config_scene(
        dict(cell.config, render=dict(cell.config["render"],
                                      resolution=p["resolution"])), device)
    loaded_s = time.time() - t_start
    width, height, meta = loaded.width, loaded.height, loaded.meta
    axes, o = poses(loaded.host.cameras[0], p, seed)
    axes_t = torch.from_numpy(axes).to(device)
    o_t = torch.from_numpy(o).to(device)
    n_poses = len(axes)
    rays = width * height * p["samples"] ** 2

    def frame(k):
        sc = dataclasses.replace(loaded.scene, cam_axes=axes_t[k % n_poses],
                                 cam_o=o_t[k % n_poses])
        return renderer.render_image(
            sc, meta, width, height, p["samples"], ambient=p["ambient"],
            max_depth=p["max_depth"], ldr=True)

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
        keep.offer(((first + k) % n_poses, img))
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
                recs.append((nxt[0] % n_poses, sum(last["host_ms"].values()),
                             int(last["ran"][:, :-1].sum())))
                nxt[0] += 1
            return recs

        def expect(recs):
            live = sum(r[2] for r in recs)
            return {"hit_nearest_kernel": live, "shade_finish_kernel": live}

        prof = traced(window, p["trace_frames"], expect, p["name_frames"])
        data = _trace_data(prof, loaded, p, axes, o, width, height, seed,
                           device)

    # the program's part is over: the reference runs on what is left
    host = loaded.host
    del loaded
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref_scene, _, _ = common.reference_scene(host, device)
    share = px_off(keep.items, ref_scene, axes, o, p, width, height, seed)
    notes = {"phases_s": dict(
        loaded=loaded_s, setup=setup_s, window=t_window - t0,
        trace=t_ref - t_window, reference=time.perf_counter() - t_ref)}
    if p.get("control"):     # the reference in a lower precision instead
        c = {"px_off": (px_off(keep.items, ref_scene, axes, o, p, width,
                               height, seed,
                               dtype=getattr(torch, p["control"])),
                        cell.limits["px_off"])}
        notes["control"] = dict(px_off=c["px_off"][0], correct=correct(c))
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
        among every traced frame's, in one depth loop, scaled to every ray
        of every traced frame."""
        rng = np.random.default_rng([seed, 4])
        ref_scene, _, _ = common.reference_scene(host, device)
        amb = torch.full((3,), p["ambient"], device=device)
        per = max(1, p["walk_rays"] // n)
        ro, rd = [], []
        for j in range(n):
            ids = torch.as_tensor(np.sort(rng.choice(
                width * height * spp, per, replace=False)),
                dtype=torch.int32, device=device)
            _, a, b = ref_camera.camera_rays_plain(
                _posed(ref_scene, axes[recs[j][0]], o[recs[j][0]]), ids,
                width, height, p["samples"])
            ro.append(a)
            rd.append(b)
        stats: dict = {}
        ref_render.radiance(ref_scene, torch.cat(ro), torch.cat(rd), amb,
                            p["max_depth"], stats=stats)
        scale = width * height * spp / per
        return {q: {k: v * scale for k, v in c.items()}
                for q, c in stats.items()}

    leaves = common.reference_scene(host, "cpu")[2]
    return TraceData(prof, torch.cuda.get_device_name(0)
                     if torch.device(device).type == "cuda" else "cpu", n, {
        "host_ms": [r[1] for r in recs],
        "hit_counts": hit_counts,
        "hit_leaves_bytes": n * common.leaves_bytes(leaves,
                                                    common.HIT_LEAVES),
        "shade_lanes": sum(r[2] for r in recs) * chunk,
        "shade_leaves_bytes": n * common.leaves_bytes(leaves,
                                                      common.SHADE_LEAVES),
    })
