"""The choices of the device loop's kept graph (``render/renderer.py::
frame_device``) on one NVIDIA GPU, timed in turns.

    python3 frame_loop_ablation.py [--rounds 2] [--reps 5]

The frames are ``chip_smoke.py``'s (RES rows, SAMPLES, CHUNK_PIXELS, DEPTH;
the area frames stochastic with seed SEED): hair, mirror, area hair, area
mirror, the mirror pair (``testscenes.make_mirror_pair_scene``) and the
hair frame at depth 8, each written to OBJ and loaded back. For each:

* a call that misses the cache, four ways in one order and then the
  reverse, ``--rounds`` times: the loop's first form
  (``renderer._frame_device_first``: an eager chunk 0, then a graph with
  every bounce launched), ``frame_device`` itself (the kept entry cleared
  first), and two misses built here from the loop's own parts: ``split``,
  the same steps as ``frame_device``'s miss with the host's milliseconds
  taken between each (the entry made; the stage: its leaves copied, the
  records packed by K13, the camera frame; the chunk captured; the
  replays), and ``chunk0``, the same with chunk 0 run eagerly before the
  capture (the other way to load every kernel before it). Wall ms per
  call (to the frame's f32 sums on the host), each call's f32 sums
  bit-equal to ``frame_eager``'s;
* the records of a kept entry brought up to date, in turns: by K13 and
  the camera frame's five ops (what ``_FrameState.stage`` does), by the
  packers' torch ops then a copy into the entry's tensors (``eager``), by
  a CUDA graph of those (``graph``, captured here: its capture's host ms
  is what a miss would add), and the whole stage: host enqueue ms and
  device ms (CUDA events) a call, ``--reps`` calls a turn, each way's
  records bit-equal to those of the entry's first call.

Nothing here changes the repository. The numbers are the card's, printed
beside its name and power limit.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

import chip_smoke as cs


def hand_miss(args, kw, npix, eager_chunk0):
    """A miss of ``frame_device`` built from its parts (see the module
    docstring); returns the f32 sums on the host and the host ms of each
    step."""
    from yocto_raytracing_tpu_torch.render import renderer

    scene, sampler = args[0], kw["light_sampler"]
    pos = (kw["max_depth"], kw["chunk_pixels"], False, kw["stochastic"])
    renderer._frames.clear()
    names, t = [], [time.perf_counter()]

    def mark(name):
        names.append(name)
        t.append(time.perf_counter())

    with torch.no_grad():
        state = renderer._FrameState(*args, *pos, sampler)
        mark("entry")
        state.stage(scene, sampler, 0.1, kw["seed"])
        mark("stage")
        if eager_chunk0:
            state.run_chunk()
            mark("chunk0")
        state.capture(if_nodes=True)
        mark("capture")
        state.replay(state.n_chunks - int(eager_chunk0))
        mark("replay")
    renderer._frames[renderer.frame_key(*args, *pos, kw["seed"],
                                        sampler)] = state
    out = renderer.to_host(state.out[:npix])
    return out, dict(zip(names, np.diff(t) * 1e3))


def misses(label, args, kw, npix, rounds, smi) -> None:
    from yocto_raytracing_tpu_torch.render import renderer

    want = renderer.frame_eager(*args, **kw).view(np.int32)

    def package():
        renderer._frames.clear()
        return renderer.to_host(renderer.frame_device(*args, **kw)[:npix]), {}

    ways = dict(
        first=lambda: (renderer.to_host(renderer._frame_device_first(
            *args, **kw)[:npix]), {}),
        miss=package,
        split=lambda: hand_miss(args, kw, npix, False),
        chunk0=lambda: hand_miss(args, kw, npix, True))
    order = list(ways)
    walls = {k: [] for k in ways}
    steps = {k: [] for k in ways}
    for _ in range(rounds):
        for k in order + order[::-1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got, ms = ways[k]()
            walls[k].append((time.perf_counter() - t0) * 1e3)
            steps[k].append(ms)
            if not np.array_equal(got.view(np.int32), want):
                raise AssertionError(f"{label} {k}: the f32 sums differ "
                                     f"from the eager loop's")
    for k in ways:
        line = (f"{label} miss way {k}: wall ms in turns "
                + ", ".join(f"{w:.2f}" for w in walls[k]))
        if steps[k][0]:
            line += "; host ms " + ", ".join(
                f"{s} " + "/".join(f"{m[s]:.2f}" for m in steps[k])
                for s in steps[k][0])
        cs.log(line + f"; f32 bit-equal to the eager loop; on {smi}")


def staging(label, args, kw, reps, smi) -> None:
    from yocto_raytracing_tpu_torch.ops import (hit_records, records,
                                                shade_records)
    from yocto_raytracing_tpu_torch.render import camera, renderer

    renderer._frames.clear()
    renderer.frame_device(*args, **kw)
    (state,) = renderer._frames.values()
    dst = (*records.tables(state.hrec, state.srec), *state.cam)
    want = [t.clone() for t in dst]

    def k13():
        state.stage(args[0], kw["light_sampler"], 0.1, kw["seed"])

    def eager():
        new = (*hit_records.pack(state.fixed)[:3],
               *shade_records.pack(state.scene),
               *camera.camera_frame(state.scene))
        for d, src in zip(dst, new):
            d.copy_(src)

    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph = renderer._capture(state.dev, eager)
        capture_ms = (time.perf_counter() - t0) * 1e3
        ways = dict(k13=state.pack_records, eager=eager, graph=graph.replay,
                    stage=k13)
        host = {k: [] for k in ways}
        dev = {k: [] for k in ways}
        for k in list(ways) + list(ways)[::-1]:
            for d in dst:
                d.zero_()
            ways[k]()
            n = 6 if k == "k13" else len(dst)   # k13: the records alone
            if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                       for a, b in zip(dst[:n], want[:n])):
                raise AssertionError(f"{label} staging {k}: the records "
                                     f"differ from the first call's")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                ways[k]()
            host[k].append((time.perf_counter() - t0) * 1e3 / reps)
            dev[k].append(cs.cuda_ms(ways[k], reps))
    cs.log(f"{label} staging, a call in turns: "
           + "; ".join(f"{k} host " + "/".join(f"{v:.3f}" for v in host[k])
                       + " ms, device " + "/".join(f"{v:.4f}" for v in dev[k])
                       + " ms" for k in ways)
           + f"; the graph's capture {capture_ms:.2f} ms (k13: the records "
           f"alone; stage: the copies of the leaves, the records, the "
           f"camera frame); on {smi}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=5)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from yocto_raytracing_tpu_torch import scene as scene_lib, testscenes
    from yocto_raytracing_tpu_torch.render import lights, renderer

    device = torch.device("cuda")
    smi = cs.nvidia_smi_line()
    cs.log(f"device: {smi}; torch {torch.__version__}, CUDA "
           f"{torch.version.cuda}")
    hosts = dict(hair=testscenes.make_hair_scene(256),
                 mirror=testscenes.make_grad_scene(),
                 area_hair=cs.area_hair_scene(),
                 area_mirror=cs.area_mirror_scene(),
                 mirror_pair=testscenes.make_mirror_pair_scene())
    frames = [(name, name.startswith("area"), cs.DEPTH) for name in hosts]
    frames.append(("hair", False, 8))
    with tempfile.TemporaryDirectory() as tmp:
        for name, area, depth in frames:
            path = os.path.join(tmp, f"{name}.obj")
            scene_lib.save_scene(hosts[name], path)
            host = scene_lib.load_scene(path)
            scene, meta = cs.scene_on(host, device)
            sampler = (lights.build_light_sampler(host, None, meta, device)
                       if area else None)
            width = renderer.image_width(host.cameras[0].aspect, cs.RES)
            kw = dict(max_depth=depth, chunk_pixels=cs.CHUNK_PIXELS,
                      stochastic=area, seed=cs.SEED, light_sampler=sampler)
            args = (scene, meta, width, cs.RES, cs.SAMPLES)
            label = f"{name} depth {depth}"
            renderer.frame_device(*args, **kw)   # the kernels loaded
            misses(label, args, kw, width * cs.RES, opts.rounds, smi)
            staging(label, args, kw, opts.reps, smi)


if __name__ == "__main__":
    main()
