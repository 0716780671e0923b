"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from this checkout and holds each against its
plain torch version on the card: K1 hit (its nearest-hit and any-hit
kernels, on random rays, and on every hit query of the hair and area hair
frames, every launch against the plain walk; the 10,004-instance
scene's nearest hits against the plain walk run on the host CPU by worker
processes beside the card's phases), K2 camera rays, K3 pixel finish
(also at 4,900 spp, its device time beside torch's sum(1)), K4
shading (bit-equal, also with per-ray light positions), K5 shading
backward (also with per-ray light positions, and through its saved-bounce
entry against its plain version; its light gradients bit-identical over
two runs), K6 camera backward, K9 thin-lens camera backward and K10
light-points backward (relative L2 error <= 1e-4 per gradient leaf of
torch autograd; K6 and K9 also bit-equal to ``ordered_camera_sums`` of
their plain per-ray terms on the card and over two launches, within 1e-4
of the f64 sum of those terms, at 2**20 rays, beside their registers,
their SASS count a ray and its issue floor; K9's 15 shared sums at
aperture 0 bit-equal to K6's), K7 stochastic camera rays, K8 area-light
points, K11 overlap query with its refit kernel, K12, the device loop's
bounce update (bit-equal; K12 also writes nothing under a zero alive word,
and its out-of-place form equals its in-place one), K14, its reverse
(bit-equal; on lanes with an infinite thr or a NaN kr its NaN at plain's
positions, as JAX's transpose gives), and K13, the device loop's records
(bit-equal to the packers on four scenes, the 10,004-instance scene among
them, before and after leaves edited in place; timed on hair and the
10,004-instance scene beside an empty launch of its grid). K8 and K10 are
also held on the area hair frame's lights (a quad and a polyline), the
area mirror frame's quad and a lamp panel of 2,048 triangles: K8
bit-equal to the plain version, K10 within 1 ULP of the explicit f64
reverse and 1e-4 of autograd, bit-identical over two runs where every
light spans at most 8 vertices.
Then it drives the port's eight paths through their user entry points:

* rendering, ``render_scene_file(..., device="cuda")``: the hair scene
  (lines + triangles + two point lights; the stand-in for the reference's
  lines/refl scenes) at 910x512 with 4x4 samples, depth 4, and the mirror
  scene (``make_grad_scene``, a kr=0.5 mirror) at 512x512, 4x4 samples,
  depth 4. The frame runs as the device loop (``frame_device``: one CUDA
  graph of a chunk, kept across calls of one configuration and replayed,
  each bounce after the first in an IF node, so a dead bounce launches
  nothing; K1, K2, K3, K4 and K12 in it); the phase ``frame_device_loop``
  holds its f32 sums bit-equal to the eager per-chunk loop's
  (``frame_eager``) on the hair, mirror, area hair, area mirror and
  mirror-pair frames (two facing mirrors, where bounces 2 and 3 must run
  in some chunks) and the hair frame at depth 8, timed in turns with its
  own first and repeated calls, and prints for each
  the wall, host enqueue by stage, device busy time, idle share, device
  ops, copies to the host (the frame's 1; a miss also reads the
  instances' frame words), live bounces by depth, dead bounces and
  their launches and device time in its own profile, the reserved
  memory's growth and the kept entry's size; and ``render_scene_file``'s
  wall split into load, build, upload and ``render_image``;
* training, ``parallel.mesh.train_step`` on 2**20 rays per step (the JAX
  bench's training batch) of the same two frames, the mirror pair (two
  facing mirrors: bounces 2 and 3 live) at depth 4 and the hair frame at
  depth 8, towards a target rendered with perturbed ``mat_kd`` and
  ``light_ke``. The step runs as the training step's device loop
  (``renderer.loss_grads_device``: one CUDA graph kept across calls, K12
  out of place and K14, its reverse, beside K1, K2, K4, K5, K6 and K13,
  each bounce after the first and its reverse in IF nodes that K12 sets).
  Step 1 with every float leaf trainable: its loss bit-equal to the
  step through autograd (``mesh._train_step_autograd``, the eager loop
  under autograd), the device loop's gradient and the autograd step's
  against an f64 reference, each update ``d - lr * g`` of its own
  gradient; the loop's first call of a key (a miss) and its repeated call
  (a hit) timed in turns, with a profile of a hit (no launch in a dead
  bounce, forward or reverse); then 5 steps on the materials and lights
  with a strictly falling loss;
* the stochastic modes, ``render_scene_file(..., stochastic=True, seed=7,
  area_lights=True, device="cuda")``: the hair scene with an emissive quad
  and an emissive polyline for its two lights and a 0.1 aperture, at
  910x512, and the mirror scene with an emissive quad light, at 512x512,
  both 4x4 samples, depth 4. Each frame is held within 1 u8 step of the
  all-plain path, bit-identical on a rerun and at another chunk size, and
  different under another seed; the point-light hair frame in area mode is
  the deterministic frame bit for bit;
* the stochastic modes' gradient, ``trace_rays(..., differentiable=True,
  stochastic=True, seed=7, light_sampler=...)`` with an MSE loss on 2**20
  rays of the area hair and area mirror frames, towards a target rendered
  with perturbed ``mat_kd``, ``light_ke`` and light-shape ``pos``: every
  float leaf's gradient against the f64 reference, ``cam_aperture`` and
  the light vertices moved, a timed and a profiled fwd+bwd;
* the overlap query, ``ops.overlap.overlap_scene`` (the refit of K11's
  records, then K11's culled walk) on 2**20 query points against the hair
  scene (capsule radii), a random scene (points, lines, triangles), the
  hair scene with pos and radius moved after the build, and points along
  the hair strands in strand order (coherent traffic): bit-equal to the
  brute-force plain query on every query and to the plain walk on a
  65,536-query subset, whose walk work gives the walk's bound;
* the ray-sharded paths, ``parallel.mesh`` in a one-rank NCCL group:
  ``render_image_sharded`` of the hair and area hair frames (host spp sum,
  no K3) within 1 u8 step of ``render_image`` (the f32 ULP gap printed),
  ``train_step_sharded`` on 2**20 rays against ``train_step``, and a
  profiled sharded step with K1, K2, K4, K5, K6 and one all_reduce for the
  loss and one per float leaf; the all_reduce's time beside its bound;
* glTF scenes (``phase_gltf``): the textured hair scene saved as .glb
  and .gltf and rendered with ``render_scene_file(..., device="cuda")``
  at the main frame's size, f32 bit-equal to the in-memory scene's frame,
  u8 within 1 step of the all-plain path (K1-K4, K12 and K13 counted on
  the .glb frame); the hair scene's .gltf with a LINEAR translation channel
  on the sphere's node, played at t = 0, 0.5 and 1 (graph playback, the
  device scene rebuilt, each frame's cache hit and host ms; t = 0 bit-equal to
  the file without the channel, t = 1 different, each within 1 u8 step
  of the all-plain path); ``io.gltf.skin_vertices`` on the card
  bit-equal to the CPU;
* the CLI, ``python -m yocto_raytracing_tpu_torch.cli`` in subprocesses:
  the hair frame as PNG, plain, with ``--checkpoint`` (and resumed from a
  snapshot cut to half), ``--sharded``, and ``--sharded`` under
  ``torch.distributed.run``, and plain on its ``.glb`` twin, each
  bit-equal to ``image.tonemap`` of ``render_image``; a missing scene
  exits 1 with ``error:`` first.

Each path runs with the launch counts set to 0 just before it and read just
after, and fails if a kernel of the path never launched. A CUDA graph's
replays count the launches it captured, those inside the IF nodes of dead
bounces too, which the card does not make; the ``kernels`` line's
``launches`` are those the card made (``kernels.made_launches``: the
counts less ``kernels.skipped_launches``), with the counts as
``counted`` and the difference as ``skipped``.

Every phase raises on failure, so the exit code is non-zero unless all of
them pass. Without a CUDA device it exits non-zero before printing any
result. The line before the last is the per-kernel JSON record
(``{"kernels": [...]}``: launches on the path that runs the kernel, largest
difference from the plain version, kernel / plain / library-call ms, and
the least time the card could take, ``bound_ms``, from the bytes each input
and output needs once and the operations counted from the kernel source;
K1's two kinds give ``ms``, ``plain_ms`` and ``bound_ms`` for one launch,
the hair frame's middle one, and their frame averages apart);
the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
The script imports nothing of JAX or of the JAX package, and checks it.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
FLT_MAX = np.float32(3.4028235e38)
CHUNK_PIXELS = 1 << 15
COMPARE_PIXELS = 1 << 18
GRAD_RAYS = 1 << 16          # K5/K6 comparisons per scene
TRAIN_RAYS = 1 << 20         # rays per training step (bench.py:242)
GRAD_RTOL = 1e-4             # K5/K6 relative L2 error per leaf
# gradient of render_loss on the kernel path against its f64 reference (the
# plain path in f64 on the kernel path's hits), relative L2 per leaf: 1e-4,
# the K5 bound; where f32 arithmetic alone misses it (the plain f32 path is
# as far from the reference: hair cam_fovy 6.4e-4, cam_aspect 2.5e-4, norm
# 1.4e-4 at 2**20 rays on an H100), 1.25x the plain path's own error
TRAIN_GRAD_RTOL = 1e-4
TRAIN_PLAIN_FACTOR = 1.25
TRAIN_LR = 1.0
TRAIN_SUBSET = ("mat_kd", "mat_ks", "light_ke")
# the mirror pair's 5 steps: its two kr 0.8 mirrors make the loss four
# bounces deep, and SGD at TRAIN_LR oversteps its minimum
PAIR_LR = 0.25
SAMPLES, DEPTH, RES = 4, 4, 512
SEED = 7
# NVIDIA H100 SXM data sheet: HBM3 rate and f32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# operations per ray (per light and ray for light_points), counted from the
# kernel sources, integer and float alike
OPS_PER_RAY = {"camera_rays": 45, "pixel_finish": 6,
               "shade": 360, "shade_bwd": 1100, "shade_bwd_lights": 1100,
               "camera_bwd": 110, "camera_rays_stochastic": 150,
               "camera_bwd_stochastic": 210, "light_points": 60,
               "light_points_bwd": 75, "bounce": 15, "bounce_bwd": 21}
# K11's operations per (query, prim) pair by prim type, counted from
# overlap.cu (the triangle's cascade at its face case), and per (query,
# instance) for the move into the instance frame
OVERLAP_OPS_PER_PAIR = {0: 15, 1: 50, 2: 100}   # point, line, triangle
OVERLAP_OPS_PER_INSTANCE = 20
# K1's operations per unit of the work that its walk does (the plain walk
# counts the units on the same rays, ``intersect_scene_plain(stats=)``),
# counted from hit.cu and common.cuh: a node visit (the slab test, 43, and
# the next-node choice, 10), a change of the ray's frame (``local_ray``),
# and a prim test of each kind
HIT_OPS = {"nodes": 53, "frames": 47, "point_tests": 35, "line_tests": 80,
           "triangle_tests": 65}
# the 10,004-instance scene's nearest-hit rays held against the plain walk:
# every HIT_PLAIN_STRIDE-th of them, walked on the host CPU by
# HIT_PLAIN_WORKERS processes (one torch thread each) while the card runs
# the other phases; the rays are random_rays(HIT_BIG_SEED, HIT_BIG_RAYS)
HIT_PLAIN_STRIDE = 16
HIT_PLAIN_WORKERS = 4
HIT_BIG_SEED = 300
HIT_BIG_RAYS = 1 << 16
HIT_FRAME_BATCH = 8      # a frame's K1 launches walked by one plain call
OVERLAP_QUERIES = 1 << 20
OVERLAP_COMPARE = 1 << 16
# K11's operations per unit of its culled walk's work (the plain walk counts
# the units on the first OVERLAP_COMPARE queries of the same run,
# ``overlap_scene_walk_plain(stats=)``), counted from overlap.cu: a node
# visit (two record loads, cull_box's gaps, square root and slack, the next
# node), a prim test of each kind (its record and tag, the pair math of
# OVERLAP_OPS_PER_PAIR, the tie rule)
WALK_OPS = {"nodes": 50, "point_tests": 25, "line_tests": 60,
            "triangle_tests": 110}
# the kernels of one overlap_scene call on the card
OVERLAP_KERNELS = ("overlap", "overlap_refit")
K3_ROUNDS = 8            # K3 launches per profile
BOUNCE_ROUNDS = 20       # K12 launches per profile
# the device functions of one bounce of the device loop in launch order,
# each with its launch-count key: K1 nearest, K4 prep, K1 any hit, K4
# finish, K12; a scene without lights launches no prep and no any hit
BOUNCE_SEQUENCE = (("hit_nearest", "hit_nearest_kernel"),
                   ("shade", "shade_prep_kernel"),
                   ("hit_any", "hit_any_kernel"),
                   ("shade", "shade_finish_kernel"),
                   ("bounce", "bounce_kernel"))
# the device functions of one bounce of the training step's device loop,
# forward and reverse, by launch-count key: each runs once in a live bounce
# and never in a dead one (its IF nodes skip it both ways)
STEP_BOUNCE_FUNCTIONS = (("hit_nearest", "hit_nearest_kernel"),
                         ("shade", "shade_finish_kernel"),
                         ("bounce", "bounce_kernel"),
                         ("bounce_bwd", "bounce_bwd_kernel"),
                         ("shade_bwd", "shade_bwd_kernel"))
# the training step's device loop, timed in turns: its first call of a key
# (a miss: its entry cleared first) and its repeated call (a hit); six
# calls, over which the reserved memory's growth is read
STEP_TURNS = ("miss", "hit", "hit", "miss", "hit", "hit")
PANEL_CELLS = 32         # the lamp panel light: 32 x 32 cells, 2,048 triangles
K3_BIG_SPP = 4900        # render_image's spp at --samples 70
# idle host seconds on each side of a profiled call, their growth from one
# attempt to the next and their most, and the most sessions tried for one
# profile (see profile_summary): on some hosts a trace loses device events
# at pads of 0.05 and 0.4 s in most profiles, and now and then at 3.2 s,
# or gives a graph's kernels out of their order (a frame miss's trace, in
# all of five attempts once)
PROFILE_PAD_S = 0.05
PROFILE_PAD_GROWTH = 8
PROFILE_PAD_MAX_S = 3.2
PROFILE_ATTEMPTS = 8


def log(*args):
    print(*args, flush=True)


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` warm calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def profile_summary(fn, label: str, expect=(), check=None) -> dict:
    """One call of ``fn`` under torch.profiler: wall ms (host clock, ends in
    a synchronize), device busy ms (sum of the trace's device events), the
    idle share of the wall, the number of device ops, the top ops, the
    device microseconds of every op name (``by_name``), the device events
    in the order they started (``events``: name, us) and the count of
    every host event name (``host``). ``check``, when given, is called on
    ``events`` after the call; what it returns is kept as ``checked``, and
    a ValueError from it says the trace lost events.

    The profiled window is padded with idle host time on each side of the
    call, so that device events whose converted timestamps land outside the
    call still fall inside the trace's window. A trace that holds no device
    event at all (not even the call's copies), or none of a kernel in
    ``expect`` (keys of DEVICE_FUNCTIONS) that the call launches, is a loss
    of the tracer, not of the call (the launch counts show the call's
    kernels): it is reported and the call is profiled again, at most
    PROFILE_ATTEMPTS times in all, each time with PROFILE_PAD_GROWTH times
    the pad (PROFILE_PAD_S the first time, PROFILE_PAD_MAX_S at most): late
    in a run the first kernel of a call has been lost three times in a row
    at one pad."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        pad = min(PROFILE_PAD_S * PROFILE_PAD_GROWTH ** (attempt - 1),
                  PROFILE_PAD_MAX_S)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            time.sleep(pad)
        evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        by_name = {}
        for e in evs:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us())
        lost = [k for k in expect if not device_us(by_name, k)]
        events = [(e.name, e.time_range.elapsed_us()) for e in
                  sorted(evs, key=lambda e: e.time_range.start)]
        checked = None
        if evs and not lost and check is not None:
            try:
                checked = check(events)
            except ValueError as exc:
                lost = [str(exc)]
        if evs and not lost:
            break
        log(f"profile {label}: attempt {attempt} of {PROFILE_ATTEMPTS} "
            f"(pad {pad} s): the trace holds "
            + (f"none of {lost}" if evs else "no device event"))
    else:
        raise AssertionError(f"profile {label}: the trace holds no device "
                             f"event, or not every kernel of {expect}, in "
                             f"{PROFILE_ATTEMPTS} attempts")
    host = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU:
            host[e.name] = host.get(e.name, 0) + 1
    busy = sum(e.time_range.elapsed_us() for e in evs) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    out = dict(wall_ms=wall, busy_ms=busy, idle=1.0 - busy / wall,
               ops=len(evs), by_name=by_name, events=events, host=host,
               checked=checked,
               d2h=sum(e.name.startswith("Memcpy DtoH") for e in evs),
               d2h_pinned=sum(e.name == "Memcpy DtoH (Device -> Pinned)"
                              for e in evs))
    log(f"profile {label}: wall {wall:.2f} ms, device busy {busy:.2f} ms, "
        f"idle share {out['idle']:.3f}, device ops {len(evs)}; top: "
        + "; ".join(f"{n[:48]} {t / 1e3:.2f} ms" for n, t in top))
    return out


# the device functions of each kernel wrapper, as the profiler names them
DEVICE_FUNCTIONS = {
    "hit": ("hit_nearest_kernel", "hit_any_kernel"),
    "hit_nearest": ("hit_nearest_kernel",),
    "hit_any": ("hit_any_kernel",),
    "camera_rays": ("camera_rays_kernel",),
    "pixel_finish": ("pixel_finish_kernel",),
    "shade": ("shade_prep_kernel", "shade_finish_kernel"),
    "shade_prep": ("shade_prep_kernel",),
    "shade_finish": ("shade_finish_kernel",),
    "shade_bwd": ("shade_bwd_kernel", "light_sum_kernel"),
    "camera_bwd": ("camera_bwd_kernel",),
    "camera_rays_stochastic": ("camera_rays_stochastic_kernel",),
    "light_points": ("light_points_kernel",),
    "shade_bwd_lights": ("shade_bwd_kernel", "light_sum_kernel"),
    "camera_bwd_stochastic": ("camera_stochastic_bwd_kernel",),
    "light_points_bwd": ("light_span_kernel", "light_points_bwd_kernel",
                         "light_points_bwd_finish_kernel"),
    "overlap": ("overlap_kernel",),
    "overlap_refit": ("overlap_parent_kernel", "overlap_refit_kernel"),
    "bounce": ("bounce_kernel",),
    "bounce_bwd": ("bounce_bwd_kernel",),
    "records": ("records_kernel",),
    "records_empty": ("records_empty_kernel",)}


def device_us(by_name: dict, kernel: str) -> float:
    """Summed device microseconds of ``kernel``'s device functions among a
    trace's ops (named ``yrt::<function>(<arguments>)``)."""
    return sum(t for name, t in by_name.items()
               if name.startswith(tuple(
                   f"yrt::{fn}(" for fn in DEVICE_FUNCTIONS[kernel])))


def device_ms(prof: dict, kernel: str, launches: int) -> float:
    """Device milliseconds per launch of ``kernel`` in a profiled path run
    (its device functions' summed time over the ``launches`` the card
    made): the kernel alone, without the host work around its launch."""
    us = device_us(prof["by_name"], kernel)
    if us == 0:
        raise AssertionError(f"the profile of {kernel}'s path holds none "
                             f"of its device functions")
    return us / 1e3 / launches


def dead_bounce_launches(events, record) -> dict:
    """The device loop's bounces in a profiled frame. ``events`` are the
    trace's device events in the order they started (``profile_summary``),
    ``record`` the frame's ``kernels.last_frame()``. The launches of the
    bounce kernels go a bounce (BOUNCE_SEQUENCE) after another, chunk after
    chunk: in ``frame_device``'s graph only the live bounces launch (a dead
    one sits in an IF node whose body does not run). Each group is matched
    to a live bounce of the record: returns the dead bounces ("bounces")
    and the live bounces by depth ("live_by_depth"). Raises ValueError
    where the launches do not fit the record (the tracer lost one),
    AssertionError where the graph launched a dead bounce."""
    ran = record["ran"].cpu()
    chunks, depth = ran.shape[0], ran.shape[1] - 1
    live = ran[:, :-1].flatten().tolist()
    fns = [fn for _, fn in BOUNCE_SEQUENCE if record["lights"]
           or fn not in ("shade_prep_kernel", "hit_any_kernel")]
    launched = [name[5:].split("(")[0] for name, _ in events
                if name.startswith(tuple(f"yrt::{fn}(" for fn in fns))]
    m = len(fns)
    bounces = [b for b in range(chunks * depth) if live[b]]
    if len(launched) != len(bounces) * m:
        if len(launched) == chunks * depth * m:
            raise AssertionError(f"the graph launched its "
                                 f"{live.count(0)} dead bounces")
        raise ValueError(f"{len(launched)} bounce launches, not "
                         f"{len(bounces) * m}")
    for j, b in enumerate(bounces):
        group = launched[j * m:(j + 1) * m]
        if group != fns:
            raise ValueError(f"bounce {b}: launches {group}")
    return dict(bounces=live.count(0),
                live_by_depth=ran[:, :-1].sum(0).tolist())


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(name: str, nbytes_: int, rays: int, ops: int | None = None) -> dict:
    """``bound_ms``, the least time the card could take: the larger of the
    bytes over the memory rate and the operations (``ops``, or
    OPS_PER_RAY[name] * rays) over the f32 rate; ``bound_by`` says
    which."""
    t_bytes = nbytes_ / HBM_BYTES_PER_S * 1e3
    if ops is None:
        ops = OPS_PER_RAY[name] * rays
    t_ops = ops / F32_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def leaves_bytes(scene, names) -> int:
    return nbytes(*(getattr(scene, k) for k in names))


HIT_LEAVES = ("node_bbox_min", "node_bbox_max", "node_start", "node_count",
              "node_isleaf", "node_kind", "node_skip", "leaf_items",
              "inst_axes", "inst_o", "inst_shape_root", "prim_v",
              "prim_type", "pos", "radius")
SHADE_LEAVES = ("pos", "norm", "texcoord", "prim_v", "prim_type",
                "inst_axes", "inst_o", "inst_mat", "inst_is_lines", "mat_kd",
                "mat_ks", "mat_kr", "mat_rs", "mat_kd_txt", "mat_ks_txt",
                "tex_quad", "tex_w", "tex_h", "light_pos", "light_axes",
                "light_o", "light_ke")


def ordered(x: np.ndarray) -> np.ndarray:
    """f32 -> int64 whose differences count ULPs across zero."""
    i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
    return np.where(i < 0, -(i & 0x7FFFFFFF), i)


HIT_OUTPUTS = ("hit", "inst", "prim", "t")


def assert_same_hits(a: dict, b: dict, what: str) -> None:
    """K1's contract with the plain walk: all four outputs equal, t bit for
    bit (NaN included)."""
    for k in HIT_OUTPUTS:
        x, y = a[k], b[k]
        if k == "t":
            x, y = x.view(torch.int32), y.view(torch.int32)
        if not torch.equal(x, y):
            raise AssertionError(f"{what}: {k} differs on "
                                 f"{int((x != y).sum())} rays")


def timed(fn):
    """(fn(), its CUDA-event milliseconds), one cold call."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    stop.record()
    stop.synchronize()
    return out, start.elapsed_time(stop)


def random_rays(seed: int, n: int, device):
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-4, 4, size=(n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return (torch.from_numpy(ro).to(device), torch.from_numpy(rd).to(device),
            torch.full((n,), 1e-4, device=device),
            torch.full((n,), float(FLT_MAX), device=device))


def scene_on(host, device):
    from yocto_raytracing_tpu_torch import scene as scene_lib

    leaves, meta = scene_lib.build_device_scene(host)
    return scene_lib.to_torch(leaves, device), meta


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this run needs an NVIDIA GPU")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    log(f"device: {kind} (count {count}); torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log("nvidia-smi name, power.limit:")
    log(smi)
    return dict(kind=kind, count=count, smi=smi)


# the shading kernels whose registers and spills the build reports apart:
# K4's two launches and K5's
SHADE_ENTRIES = ("shade_prep_kernel", "shade_finish_kernel",
                 "shade_bwd_kernel", "light_sum_kernel")


def sass_functions(text: str) -> dict:
    """{function name: its instruction and label lines} from the output of
    ``cuobjdump -sass``."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        line = line.strip()
        if cur is not None and (re.match(r"/\*[0-9a-f]{4,}\*/", line)
                                or re.match(r"\.L_x_\d+:", line)):
            cur.append(line)
    return out


def sass_count(lines) -> int:
    """The instructions among ``sass_functions``' lines of a function."""
    return sum(line.startswith("/*") for line in lines)


def sass_loop_fast_path(lines) -> dict:
    """The instructions of one trip through a kernel's largest loop (the
    backward branch that spans the most code: the camera reverses' loop
    over a thread's rays) on its fast path: from the loop's head to its
    backward branch, a forward conditional branch within the loop is taken
    where the code it skips holds a call (the IEEE divide's and square
    root's slow paths) or an inner loop (cosf's and sinf's reduction of
    large arguments), and an unconditional one is followed. Returns
    {"count": instructions a trip, "static": the loop's instructions,
    "skipped": those left out}."""
    code = []
    for line in lines:
        m = re.match(r"/\*([0-9a-f]+)\*/\s+(.*?)\s*;", line)
        if m:
            code.append((int(m.group(1), 16), m.group(2)))
    at = {a: i for i, (a, _) in enumerate(code)}

    def target(text):
        m = re.search(r"\bBRA\s+(?:`\()?(0x[0-9a-f]+|\.L_x_\d+)", text)
        return int(m.group(1), 16) if m and m.group(1).startswith("0x") \
            else None

    loops = [(a - t, t, a) for a, text in code
             if (t := target(text)) is not None and t <= a]
    if not loops:
        raise ValueError("no loop in the function")
    _, head, back = max(loops)
    i, count = at[head], 0
    while True:
        a, text = code[i]
        count += 1
        if a == back:
            break
        t = target(text)
        if t is not None and a < t <= back:
            skipped = code[i + 1:at[t]]
            if not text.startswith("@") or any(
                    "CALL" in x or ((u := target(x)) is not None and u <= b)
                    for b, x in skipped):
                i = at[t]
                continue
        i += 1
    static = at[back] - at[head] + 1
    return dict(count=count, static=static, skipped=static - count)


def ptxas_entries(log_text: str) -> dict:
    """{mangled entry name: (registers, spill store bytes, spill load
    bytes)} from nvcc's ``-Xptxas -v`` output."""
    import re

    out, name, spill = {}, None, (0, 0)
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = (int(m.group(1)), *spill)
            name = None
    return out


def phase_build() -> tuple:
    """Build the kernels; log ptxas's lines, and the registers and spills
    of K4's and K5's kernels; then the camera reverses'
    (``phase_camera_build``). Returns (shading registers, camera
    reverses' record)."""
    from yocto_raytracing_tpu_torch import kernels

    info = kernels.build()
    log(f"build: {info.seconds:.1f} s -> {info.path.name}")
    for line in info.log.splitlines():
        if ("registers" in line or "spill" in line
                or "Compiling entry" in line):
            log("  ptxas:", line.strip())
    regs = {}
    for mangled, (r, st, ld) in ptxas_entries(info.log).items():
        for entry in SHADE_ENTRIES:
            if entry in mangled:
                regs[entry] = dict(registers=r, spill_stores=st,
                                   spill_loads=ld)
    log("ptxas, shading kernels: " + "; ".join(
        f"{k} {v['registers']} registers, spill stores/loads "
        f"{v['spill_stores']}/{v['spill_loads']} bytes"
        for k, v in sorted(regs.items())))
    if len(regs) != len(SHADE_ENTRIES):
        raise AssertionError(f"ptxas reported {sorted(regs)}")
    return regs, phase_camera_build(info)


# the camera reverses' kernels (and K7, which shares K9's sample), by the
# DEVICE_FUNCTIONS key whose registers the build reports: its one function
CAMERA_ENTRIES = {key: DEVICE_FUNCTIONS[key][0] for key in (
    "camera_bwd", "camera_bwd_stochastic", "camera_rays_stochastic")}


def phase_camera_build(info) -> dict:
    """The camera reverses' kernels in the build: registers from ptxas (by
    CAMERA_ENTRIES key); for K6 and K9, the SASS instructions of a trip
    through their loop over a thread's rays on its fast path
    (``cuobjdump -sass``, ``sass_loop_fast_path``: one ray's work) and the
    issue floor that implies at TRAIN_RAYS rays, one warp instruction a
    scheduler a clock, 4 schedulers on each of 132 SMs, at the card's
    highest SM clock (``nvidia-smi``)."""
    from yocto_raytracing_tpu_torch.kernels import _build

    out = {}
    for mangled, (r, st, ld) in ptxas_entries(info.log).items():
        for key, entry in CAMERA_ENTRIES.items():
            if re.search(rf"\d{entry}E", mangled):
                out[key] = dict(registers=r, spill_stores=st, spill_loads=ld)
    if len(out) != len(CAMERA_ENTRIES):
        raise AssertionError(f"ptxas reported {sorted(out)}")
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = sass_functions(subprocess.run(
        [tool, "-sass", str(info.path)], capture_output=True, text=True,
        timeout=300, check=True).stdout)
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0])
    warps = -(-TRAIN_RAYS // 32)
    for key in ("camera_bwd", "camera_bwd_stochastic"):
        lines = next(v for k, v in sass.items()
                     if re.search(rf"\d{CAMERA_ENTRIES[key]}E", k))
        path = sass_loop_fast_path(lines)
        out[key].update(sass_per_ray=path["count"],
                        sass_loop=path["static"], sass_total=sass_count(lines),
                        issue_floor_us=warps * path["count"]
                        / (4 * 132 * mhz * 1e6) * 1e6, sm_mhz=mhz)
    log("camera reverses: " + "; ".join(
        f"{k} {v['registers']} registers, {v['spill_stores']} B spilled"
        + (f", SASS {v['sass_per_ray']} instructions a ray (loop "
           f"{v['sass_loop']}, kernel {v['sass_total']}), issue floor "
           f"{v['issue_floor_us']:.2f} us at {TRAIN_RAYS} rays and "
           f"{v['sm_mhz']:.0f} MHz" if "sass_per_ray" in v else "")
        for k, v in out.items()))
    return out


def plain_walk_part(part: int):
    """Worker of ``start_plain_walk`` (a spawned process, CPU only): the
    plain walk on the host CPU over the 10,004-instance scene's rays
    ``part``, ``part + HIT_PLAIN_WORKERS``, ... of every HIT_PLAIN_STRIDE-th
    of ``random_rays(HIT_BIG_SEED, HIT_BIG_RAYS)``: ({output: array},
    seconds)."""
    from yocto_raytracing_tpu_torch import testscenes
    from yocto_raytracing_tpu_torch.ops import traverse

    torch.set_num_threads(1)
    scene, _ = scene_on(testscenes.make_random_scene(n_instances=10004),
                        "cpu")
    rays = random_rays(HIT_BIG_SEED, HIT_BIG_RAYS, "cpu")
    sub = [x[::HIT_PLAIN_STRIDE][part::HIT_PLAIN_WORKERS].contiguous()
           for x in rays]
    t0 = time.perf_counter()
    out = traverse.intersect_scene_plain(scene, *sub, False)
    return {k: v.numpy() for k, v in out.items()}, time.perf_counter() - t0


def start_plain_walk(pool):
    """Start the host CPU's plain walk of the 10,004-instance scene's
    nearest-hit rays (``plain_walk_part`` in ``pool``); ``phase_hit_kernel``
    gives the kernel's answers, ``check_plain_walk`` holds the two."""
    return pool.map_async(plain_walk_part, range(HIT_PLAIN_WORKERS))


def check_plain_walk(pending, kern: dict) -> None:
    """The kernel's nearest hits on the 10,004-instance scene (every
    HIT_PLAIN_STRIDE-th ray, on the host) bit-equal to the plain walk on the
    host CPU. The CPU tests hold that walk to the JAX package's; the card
    holds the kernel to the same walk on the card on the other scenes."""
    t0 = time.perf_counter()
    parts = pending.get(timeout=900)
    waited = time.perf_counter() - t0
    n = kern["hit"].shape[0]
    plain = {k: torch.empty_like(v) for k, v in kern.items()}
    for p, (res, _) in enumerate(parts):
        for k in HIT_OUTPUTS:
            plain[k][p::HIT_PLAIN_WORKERS] = torch.from_numpy(res[k])
    assert_same_hits(plain, kern, "K1 random 10004 instances nearest-hit "
                     "(the plain walk on the host CPU)")
    log(f"K1 random 10004 instances nearest-hit: {n} rays (every "
        f"{HIT_PLAIN_STRIDE}th) equal to the plain walk on the host CPU "
        f"({HIT_PLAIN_WORKERS} processes of one thread, "
        f"{max(sec for _, sec in parts):.1f} s the longest, waited "
        f"{waited:.1f} s at the end; tolerance: bit-equal)")


def phase_hit_kernel(device) -> dict:
    """K1 against the plain walk, nearest and any hit, on random rays. On
    the 10,004-instance scene, where frame changes dominate, the nearest-hit
    walk is held against the plain walk on every HIT_PLAIN_STRIDE-th ray
    (each ray's answer is its own) on the host CPU (``check_plain_walk``,
    later): the lockstep plain walk runs as many steps as the batch's
    longest walk, ~22,500 here, 243 s on the card. The kernel's answers on
    those rays are returned."""
    from yocto_raytracing_tpu_torch import testscenes
    from yocto_raytracing_tpu_torch.ops import traverse

    cases = [(f"random seed {s}", lambda s=s: testscenes.make_random_scene(
        seed=s), 1 << 16, 100 + s) for s in range(4)]
    cases.append(("hair 256", lambda: testscenes.make_hair_scene(256),
                  1 << 16, 200))
    cases.append(("random 10004 instances", lambda: testscenes.
                  make_random_scene(n_instances=10004), HIT_BIG_RAYS,
                  HIT_BIG_SEED))
    big = None
    for name, make, n, seed in cases:
        scene, _ = scene_on(make(), device)
        rays = random_rays(seed, n, device)
        for any_hit in (False, True):
            what = f"K1 {name} {'any' if any_hit else 'nearest'}-hit"
            t0 = time.perf_counter()
            kern = traverse.intersect_scene(scene, *rays, any_hit)
            torch.cuda.synchronize()
            kern_s = time.perf_counter() - t0
            if "10004" in name and not any_hit:
                # held against the host CPU's plain walk later
                big = {k: v[::HIT_PLAIN_STRIDE].cpu()
                       for k, v in kern.items()}
                log(f"{what}: {n} rays, {int(kern['hit'].sum())} hits; "
                    f"kernel {kern_s:.4f} s")
                continue
            t1 = time.perf_counter()
            plain = traverse.intersect_scene_plain(scene, *rays, any_hit)
            torch.cuda.synchronize()
            assert_same_hits(plain, kern, what)
            log(f"{what}: {n} rays, {int(kern['hit'].sum())} hits, equal "
                f"to the plain walk ({time.perf_counter() - t1:.2f} s; "
                f"tolerance: bit-equal); kernel {kern_s:.4f} s")
    return big


def phase_frame_kernels(scene, width, height, samples, device) -> dict:
    """K2 and K3 on the middle chunk of the hair frame (the rows that cross
    the hair ball): kernel against plain, values and CUDA-event times; K3's
    device time per launch in both modes beside torch's sum(1), and K3
    against plain on a few pixels at K3_BIG_SPP."""
    from yocto_raytracing_tpu_torch.render import camera, renderer

    spp = samples * samples
    n = CHUNK_PIXELS * spp
    first = (width * height // 2 // CHUNK_PIXELS) * CHUNK_PIXELS
    ids = torch.arange(first * spp, first * spp + n, dtype=torch.int32,
                       device=device)
    rec = {}

    a = camera.camera_rays_plain(scene, ids, width, height, samples)
    b = camera.camera_rays(scene, ids, width, height, samples)
    for x, y, what in zip(a, b, ("uv", "ro", "rd")):
        ulp = np.abs(ordered(x.cpu().numpy()) - ordered(y.cpu().numpy()))
        if ulp.max() > 1:
            raise AssertionError(f"K2 {what}: {ulp.max()} ULP")
    err = max(float((x - y).abs().max()) for x, y in zip(a, b))
    rec["camera_rays"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: camera.camera_rays(scene, ids, width, height,
                                              samples), 20),
        plain_ms=cuda_ms(lambda: camera.camera_rays_plain(
            scene, ids, width, height, samples), 5),
        library_ms=None, **bound("camera_rays", nbytes(ids, *b), n))
    log(f"K2 camera rays: {n} rays, max |kernel - plain| {err} "
        f"(tolerance 1 ULP)")

    rgb = renderer.trace_rays(scene, ids, torch.full((3,), 0.1,
                                                     device=device),
                              width, height, samples, 4).contiguous()
    errs = []
    for ldr in (False, True):
        x = renderer.pixel_finish_plain(rgb, spp, ldr)
        y = renderer.pixel_finish(rgb, spp, ldr)
        if ldr:
            d = (x.int() - y.int()).abs().max().item()
            if d > 1:
                raise AssertionError(f"K3 ldr: {d} u8 steps")
        else:
            d = (x - y).abs().max().item()
            if not bool(((x - y).abs() <= 1e-6 * x.abs()).all()):
                raise AssertionError(f"K3 sums: max abs diff {d}")
        errs.append(float(d))
    # device time per launch in both modes; torch's sum(1), the HDR mode's
    # one-call counterpart (LDR has none)
    dev_us = {}
    for ldr in (False, True):
        mode = "ldr" if ldr else "hdr"
        prof = profile_summary(
            lambda ldr=ldr: [renderer.pixel_finish(rgb, spp, ldr)
                             for _ in range(K3_ROUNDS)],
            f"K3 {mode}", ("pixel_finish",))
        dev_us[mode] = device_us(prof["by_name"], "pixel_finish") / K3_ROUNDS
    prof = profile_summary(
        lambda: [rgb.view(-1, spp, 3).sum(1) for _ in range(K3_ROUNDS)],
        "torch sum(1)")
    dev_us["sum1"] = prof["busy_ms"] * 1e3 / K3_ROUNDS
    # any spp: a few pixels at K3_BIG_SPP
    big = torch.rand((37 * K3_BIG_SPP, 3), device=device,
                     generator=torch.Generator(device=device).manual_seed(5))
    for ldr in (False, True):
        x = renderer.pixel_finish_plain(big, K3_BIG_SPP, ldr)
        y = renderer.pixel_finish(big, K3_BIG_SPP, ldr)
        ok = (bool((x.int() - y.int()).abs().max() <= 1) if ldr
              else torch.equal(x, y))
        if not ok:
            raise AssertionError(f"K3 at {K3_BIG_SPP} spp, ldr={ldr}: "
                                 f"differs from plain")
    rec["pixel_finish"] = dict(
        max_abs_err=max(errs),
        ms=cuda_ms(lambda: renderer.pixel_finish(rgb, spp, True), 20),
        plain_ms=cuda_ms(lambda: renderer.pixel_finish_plain(rgb, spp, True),
                         5),
        # one PyTorch call for the spp sum (without the tonemap to u8)
        library_ms=cuda_ms(lambda: rgb.view(-1, spp, 3).sum(1), 20),
        ldr_device_us=dev_us["ldr"], hdr_device_us=dev_us["hdr"],
        library_device_us=dev_us["sum1"],
        **bound("pixel_finish", nbytes(rgb) + CHUNK_PIXELS * 4, n))
    sum_ms = cuda_ms(lambda: renderer.pixel_finish(rgb, spp, False), 20)
    log(f"K3 pixel finish: {CHUNK_PIXELS} pixels x {spp} spp, "
        f"max |kernel - plain| sums {errs[0]}, u8 {errs[1]} (tolerance: "
        f"sums 1e-6 relative, u8 1 step), also at {K3_BIG_SPP} spp; "
        f"timed calls: kernel u8 "
        f"{rec['pixel_finish']['ms']:.4f} ms, kernel f32 sums {sum_ms:.4f} "
        f"ms, torch sum(1) {rec['pixel_finish']['library_ms']:.4f} ms; "
        f"device us per launch: LDR {dev_us['ldr']:.2f}, HDR "
        f"{dev_us['hdr']:.2f}, torch sum(1) {dev_us['sum1']:.2f} (HDR's "
        f"one-call counterpart); bound "
        f"{rec['pixel_finish']['bound_ms'] * 1e3:.2f} us")
    return rec


def record_hit_queries(scene, meta, width, **trace_kw) -> list:
    """The inputs of every K1 query of one frame (910x512-class: RES rows,
    SAMPLES x SAMPLES, depth DEPTH, CHUNK_PIXELS a chunk, as render_image
    cuts it): [(any_hit, (ro, rd, tmin, tmax))], through trace_rays' hit
    hook."""
    from yocto_raytracing_tpu_torch.ops import traverse
    from yocto_raytracing_tpu_torch.render import renderer

    queries = []

    def record(sc, ro, rd, tmin, tmax, any_hit=False):
        queries.append((any_hit, (ro, rd, tmin, tmax)))
        return traverse.intersect_scene(sc, ro, rd, tmin, tmax, any_hit)

    spp = SAMPLES * SAMPLES
    npix = width * RES
    amb = torch.full((3,), 0.1, device=scene.device)
    for start in range(0, npix, CHUNK_PIXELS):
        ids = torch.arange(start * spp, (start + CHUNK_PIXELS) * spp,
                           dtype=torch.int32, device=scene.device)
        renderer.trace_rays(scene, ids.clamp(max=npix * spp - 1), amb, width,
                            RES, SAMPLES, DEPTH, meta.has_kd_textures,
                            meta.has_ks_textures, intersect=record,
                            **trace_kw)
    return queries


def check_frame_launches(scene, qs, any_hit, kernel, what) -> float:
    """``kernel`` (K1) on every launch ``qs`` of one kind of a frame
    bit-equal to the plain walk, HIT_FRAME_BATCH launches concatenated into
    one plain call (each ray's answer is its own). Returns the plain walk's
    seconds."""
    from yocto_raytracing_tpu_torch.ops import traverse

    t0 = time.perf_counter()
    for first in range(0, len(qs), HIT_FRAME_BATCH):
        batch = qs[first:first + HIT_FRAME_BATCH]
        plain = traverse.intersect_scene_plain(
            scene, *(torch.cat(x) for x in zip(*batch)), any_hit)
        start = 0
        for k, args in enumerate(batch, first):
            n = args[0].shape[0]
            assert_same_hits({key: v[start:start + n]
                              for key, v in plain.items()},
                             kernel(args), f"{what} launch {k}")
            start += n
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_hit_frame(name, scene, meta, width, **trace_kw) -> dict:
    """K1 on every query of one frame, each launch kind apart (nearest hit:
    the camera rays; any hit: the stacked shadow rays):

    * the kernel equal to the plain walk on every launch
      (``check_frame_launches``);
    * the live-lane share (tmax >= tmin) and the share of 32-lane groups
      that mix live and dead lanes;
    * the middle launch (the chunk that crosses the hair ball) held against
      its own bound: HIT_OPS over the plain walk's counts on its live lanes
      (a dead lane needs no test), beside the kernel's time on that launch
      alone (CUDA events, and the profiler's device time of that one
      launch);
    * the kernel over the frame's launches of the kind, timed the same way
      and profiled: time per launch."""
    from yocto_raytracing_tpu_torch import scene as scene_lib
    from yocto_raytracing_tpu_torch.ops import hit_records, traverse

    fixed = scene_lib.detached(scene)
    queries = record_hit_queries(fixed, meta, width, **trace_kw)
    recs = hit_records.pack(fixed)
    out = {}
    for kind, any_hit in (("hit_nearest", False), ("hit_any", True)):
        qs = [args for a, args in queries if a == any_hit]
        if not qs:
            raise AssertionError(f"{name}: no {kind} query")

        def new(args):
            return traverse.intersect_scene_cuda(fixed, *args, any_hit,
                                                 records=recs)

        live = [args[3] >= args[2] for args in qs]
        lanes = sum(x.numel() for x in live)
        n_live = sum(int(x.sum()) for x in live)
        groups = [x[:x.numel() // 32 * 32].view(-1, 32) for x in live]
        n_groups = sum(g.shape[0] for g in groups)
        mixed = sum(int((g.any(1) & ~g.all(1)).sum()) for g in groups)

        plain_s = check_frame_launches(fixed, qs, any_hit, new,
                                       f"K1 {kind} {name}")
        mid = qs[len(qs) // 2]
        plain, plain_ms = timed(lambda: traverse.intersect_scene_plain(
            fixed, *mid, any_hit))
        t_new = new(mid)
        mid_live = live[len(qs) // 2]
        work = {}
        traverse.intersect_scene_plain(
            fixed, *(x[mid_live] for x in mid), any_hit, stats=work)
        ops = sum(HIT_OPS[k] * v for k, v in work.items())
        b = bound(kind, nbytes(*mid, *plain.values())
                  + leaves_bytes(fixed, HIT_LEAVES), 0, ops=ops)

        def frame_pass():
            for args in qs:
                new(args)

        mid_ms = cuda_ms(lambda: new(mid), 5)
        frame_ms = cuda_ms(frame_pass, 3) / len(qs)
        prof = profile_summary(lambda: new(mid),
                               f"K1 {kind} {name} middle launch", (kind,))
        mid_us = device_us(prof["by_name"], kind)
        prof = profile_summary(frame_pass, f"K1 {kind} {name} frame",
                               (kind,))
        frame_us = device_us(prof["by_name"], kind) / len(qs)
        both = plain["hit"]
        err = float((plain["t"][both] - t_new["t"][both]).abs().max()) \
            if bool(both.any()) else 0.0
        out[kind] = dict(
            max_abs_err=err, ms=mid_ms, plain_ms=plain_ms, library_ms=None,
            mid_device_ms=mid_us / 1e3, frame_ms=frame_ms,
            frame_device_ms=frame_us / 1e3,
            live_share=n_live / lanes, mixed_group_share=mixed / n_groups,
            **b)
        log(f"K1 {kind} {name} frame: {len(qs)} launches, {lanes} lanes, "
            f"live share {n_live / lanes:.4f}, 32-lane groups that mix live "
            f"and dead lanes {mixed / n_groups:.4f}; the kernel equal to "
            f"the plain walk on every launch (tolerance: bit-equal; the "
            f"plain walk {plain_s:.1f} s, {HIT_FRAME_BATCH} launches a "
            f"call)")
        log(f"K1 {kind} {name} middle launch: work per live lane (the plain "
            f"walk's counts) " + ", ".join(
                f"{k} {v / max(int(mid_live.sum()), 1):.3f}"
                for k, v in work.items())
            + f"; bound {b['bound_ms'] * 1e3:.2f} us ({b['bound_by']}); "
            f"device us (profiler) {mid_us:.1f}: kernel / bound "
            f"{mid_us / (b['bound_ms'] * 1e3):.2f}x; timed "
            f"{mid_ms * 1e3:.1f} us; plain walk {plain_ms:.1f} ms")
        log(f"K1 {kind} {name} frame, device us per launch (profiler) "
            f"{frame_us:.1f}; timed per launch {frame_ms * 1e3:.1f} us")
    return out


FRAME_KERNELS = ("hit", "hit_any", "camera_rays", "pixel_finish", "shade",
                 "bounce", "records")
TRAIN_KERNELS = ("hit", "camera_rays", "shade", "shade_bwd", "camera_bwd")


def phase_frame(path, resolution, samples, max_depth, device, dev_info,
                name) -> dict:
    """One frame through render_scene_file on the card: its launch counts
    and those of them that belong to dead bounces, which its graph does
    not make (``kernels.skipped_launches``); a warm profile, which must
    hold the live bounces' launches and no dead one's
    (``dead_bounce_launches``), its dead bounces counted alike; the first
    COMPARE_PIXELS pixels against the all-plain path."""
    from yocto_raytracing_tpu_torch import kernels
    from yocto_raytracing_tpu_torch.render import renderer
    from yocto_raytracing_tpu_torch.utils import tracer

    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with tracer.recording():   # the dead bounces' tally
        img, host, scene, meta = renderer.render_scene_file(
            path, resolution, samples, max_depth=max_depth,
            chunk_pixels=CHUNK_PIXELS, device=device, ldr=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kernels.launches)
    skipped = kernels.skipped_launches()
    made = kernels.made_launches()
    height, width = img.shape[:2]
    spp = samples * samples
    rays = width * height * spp
    log(f"frame {name}: {width}x{height} x {spp} spp = {rays} primary rays, "
        f"depth {max_depth}: {wall:.3f} s wall, {rays / wall / 1e6:.3f} "
        f"Mrays/s on {dev_info['smi']}; launches {counts}; of them in "
        f"{skipped['bounces']} dead bounces "
        + str({k: v for k, v in skipped.items() if v and k != "bounces"}))
    if img.shape != (resolution, width, 4) or img.dtype != np.uint8:
        raise AssertionError(f"frame {name}: bad image {img.shape} "
                             f"{img.dtype}")
    if not (img[..., 3] == 255).all() or img[..., :3].max() == 0:
        raise AssertionError(f"frame {name}: alpha or black frame")
    for k in FRAME_KERNELS:
        if counts[k] <= 0:
            raise AssertionError(f"frame {name}: kernel {k} never launched")
    prof = profile_summary(lambda: renderer.render_scene_file(
        path, resolution, samples, max_depth=max_depth,
        chunk_pixels=CHUNK_PIXELS, device=device, ldr=True),
        f"warm frame {name}",
        ("hit_nearest", "hit_any", "camera_rays", "pixel_finish", "shade"),
        check=lambda ev: dead_bounce_launches(ev, kernels.last_frame()))
    dead = prof["checked"]
    log(f"frame {name}: in the warm profile {dead['bounces']} dead bounces, "
        f"none launched; live bounces by depth {dead['live_by_depth']}")
    if dead["bounces"] != skipped["bounces"]:
        raise AssertionError(f"frame {name}: {dead['bounces']} dead bounces "
                             f"in the profile, {skipped['bounces']} counted")

    # all-plain path on the card, first COMPARE_PIXELS pixels
    check_plain_pixels(f"frame {name}", img, scene, meta, samples, max_depth,
                       0, min(COMPARE_PIXELS, width * height))
    for d in (skipped, made):
        d["hit_nearest"] = d["hit"] - d["hit_any"]
    return dict(counts=counts, skipped=skipped, made=made, wall=wall,
                rays=rays, image=img, prof=prof)


def check_plain_pixels(what, img, scene, meta, samples, max_depth, start,
                       stop) -> None:
    """Pixels [start, stop) of the u8 frame ``img`` (device tonemap) against
    the all-plain path on the card (plain torch walk, shading and pixel
    finish): within 1 u8 step."""
    from yocto_raytracing_tpu_torch.render import renderer

    height, width = img.shape[:2]
    spp = samples * samples
    amb = torch.full((3,), 0.1, dtype=torch.float32, device=scene.device)
    parts = []
    t0 = time.perf_counter()
    for lo in range(start, stop, CHUNK_PIXELS):
        hi = min(lo + CHUNK_PIXELS, stop)
        ids = torch.arange(lo * spp, hi * spp, dtype=torch.int32,
                           device=scene.device)
        rgb = renderer.trace_rays(scene, ids, amb, width, height, samples,
                                  max_depth, meta.has_kd_textures,
                                  meta.has_ks_textures, plain=True)
        parts.append(renderer.pixel_finish_plain(rgb, spp, True))
    plain = torch.cat(parts).cpu().numpy()
    got = img.reshape(-1, 4)[start:stop]
    d = np.abs(plain.astype(np.int32) - got)
    log(f"{what}: kernel vs all-plain on pixels {start}-{stop}: max "
        f"{d.max()} u8 steps, {int((d > 0).any(axis=1).sum())} pixels "
        f"differ ({time.perf_counter() - t0:.1f} s)")
    if d.max() > 1:
        raise AssertionError(f"{what}: {d.max()} u8 steps off plain")


STOCHASTIC_KERNELS = ("hit", "hit_any", "camera_rays_stochastic",
                      "light_points", "shade", "pixel_finish", "bounce")


def set_geometry(shp, pos, lines=(), triangles=()):
    """Give a host shape new vertices and elements (no points); normals,
    texcoords and radii as a loader would leave them."""
    shp.pos = np.asarray(pos, np.float32)
    shp.points = np.zeros(0, np.int32)
    shp.lines = np.asarray(lines, np.int32).reshape(-1, 2)
    shp.triangles = np.asarray(triangles, np.int32).reshape(-1, 3)
    shp.norm = np.zeros((0, 3), np.float32)
    shp.texcoord = np.zeros((len(shp.pos), 2), np.float32)
    shp.radius = np.zeros(0, np.float32)


def light_shape(host, name):
    ist = next(i for i in host.instances if i.name == name)
    return host.shapes[ist.shape]


def quad(center):
    """A 1 m square around ``center`` in its horizontal plane, two
    triangles facing down."""
    c = np.asarray(center, np.float32)
    return ([c + d for d in ([-0.5, 0, -0.5], [0.5, 0, -0.5],
                             [0.5, 0, 0.5], [-0.5, 0, 0.5])],
            [[0, 1, 2], [0, 2, 3]])


def area_hair_scene(cells=1):
    """``make_hair_scene(256)`` with light1 an emissive 1 m quad at (2, 4,
    3) facing down, light2 an emissive 4-segment polyline around (-2.5,
    3.5, -1) (ke stays 40) and the camera's aperture 0.1 at its focus, the
    distance to the target. With ``cells`` > 1 the quad is a lamp panel of
    ``cells`` x ``cells`` cells, two triangles each (``panel_grid``)."""
    from yocto_raytracing_tpu_torch import scene as scene_lib, testscenes

    host = testscenes.make_hair_scene(256)
    pos, tris = (quad((2.0, 4.0, 3.0)) if cells == 1 else
                 testscenes.panel_grid((2.0, 4.0, 3.0), cells=cells))
    set_geometry(light_shape(host, "light1"), pos, triangles=tris)
    c = np.asarray([-2.5, 3.5, -1.0], np.float32)
    set_geometry(light_shape(host, "light2"),
                 [c + [dx, 0.1 * dx * dx, 0.3 * dx]
                  for dx in (-0.8, -0.3, 0.0, 0.4, 0.9)],
                 lines=[[0, 1], [1, 2], [2, 3], [3, 4]])
    host.cameras[0].aperture = 0.1
    return scene_lib.finalize_scene(host)


def area_mirror_scene():
    """``make_grad_scene()`` with its point light an emissive 1 m quad
    around the same point, facing down."""
    from yocto_raytracing_tpu_torch import scene as scene_lib, testscenes

    host = testscenes.make_grad_scene()
    shp = light_shape(host, "light")
    pos, tris = quad(shp.pos[0])
    set_geometry(shp, pos, triangles=tris)
    return scene_lib.finalize_scene(host)


def phase_stochastic(host, device) -> dict:
    """K7, K8 and K4 with per-ray light positions against their plain
    versions on the middle 524,288-ray chunk of the area hair frame
    (bit-equal), and their CUDA-event times."""
    from yocto_raytracing_tpu_torch import scene as scene_lib
    from yocto_raytracing_tpu_torch.kernels import parity
    from yocto_raytracing_tpu_torch.render import (camera, lights, renderer,
                                                   shade)

    leaves, meta = scene_lib.build_device_scene(host)
    scene = scene_lib.to_torch(leaves, device)
    sampler = lights.build_light_sampler(host, leaves, meta, device)
    width = renderer.image_width(host.cameras[0].aspect, RES)
    n = CHUNK_PIXELS * SAMPLES * SAMPLES
    ids = middle_ids(width, RES, SAMPLES, n, device)
    rec = {}

    rep = parity.compare_camera_stochastic(scene, ids, width, RES, SAMPLES,
                                           SEED)
    log(f"K7 stochastic camera rays: {n} rays, aperture "
        f"{float(scene.cam_aperture)}; ULP gap kernel vs plain uv "
        f"{rep['uv']}, ro {rep['ro']}, rd {rep['rd']} (tolerance: "
        f"bit-equal)")
    if rep["uv"] or rep["ro"] or rep["rd"]:
        raise AssertionError(f"K7: {rep}")
    outs = camera.camera_rays_stochastic_cuda(scene, ids, width, RES,
                                              SAMPLES, SEED)
    rec["camera_rays_stochastic"] = dict(
        max_abs_err=rep["max_abs_err"],
        ms=cuda_ms(lambda: camera.camera_rays_stochastic_cuda(
            scene, ids, width, RES, SAMPLES, SEED), 20),
        plain_ms=cuda_ms(lambda: camera.camera_rays_stochastic_plain(
            scene, ids, width, RES, SAMPLES, SEED), 5),
        library_ms=None,
        **bound("camera_rays_stochastic", nbytes(ids, *outs), n))

    rep = parity.compare_light_points(scene, sampler, ids, SEED)
    nl = int(sampler["cdf"].shape[0])
    log(f"K8 light points: {nl} lights x {n} rays, elements "
        f"{sampler['n'].tolist()}; ULP gap kernel vs plain {rep['points']}, "
        f"bit-equal {rep['equal']} (tolerance: bit-equal)")
    if not rep["equal"]:
        raise AssertionError(f"K8: {rep}")
    lpos = lights.sample_light_points_cuda(scene, sampler, ids, SEED)
    rec["light_points"] = dict(
        max_abs_err=rep["max_abs_err"],
        ms=cuda_ms(lambda: lights.sample_light_points_cuda(
            scene, sampler, ids, SEED), 20),
        plain_ms=cuda_ms(lambda: lights.sample_light_points_plain(
            scene, sampler, ids, SEED), 5),
        library_ms=None, **light_points_bound(sampler, n))

    amb = torch.full((3,), 0.1, device=device)
    ro, rd, hits, active = inputs = parity.shade_inputs(
        scene, ids, width, RES, SAMPLES, 1, amb)
    rep = parity.compare_shade(scene, inputs, amb, meta.has_kd_textures,
                               meta.has_ks_textures, light_pos=lpos)
    gaps = {k: rep[k] for k in parity.SHADE_OUTPUTS}
    log(f"K4 shade with per-ray lights: {n} rays, {rep['hits']} hits; ULP "
        f"gap kernel vs plain {gaps}, masks equal {rep['mask_equal']} "
        f"(tolerance: bit-equal)")
    if not rep["mask_equal"] or any(gaps.values()):
        raise AssertionError(f"K4 with per-ray lights: {rep}")
    occ = parity.occluder(scene)

    def run(fn, light_pos):
        with torch.no_grad():
            fn(scene, ro, rd, hits, amb, active, occ, meta.has_kd_textures,
               meta.has_ks_textures, light_pos)

    rec["shade_lights"] = dict(
        **k4_times("shade with per-ray lights, area hair", scene, meta,
                   inputs, amb, lpos),
        plain_ms=cuda_ms(lambda: run(shade.shade_step_plain, lpos), 3),
        fixed_ms=cuda_ms(lambda: run(shade.shade_step_cuda, None), 10),
        **bound("shade", n * (24 + 8 + 1 + 48) + nbytes(lpos)
                + leaves_bytes(scene, SHADE_LEAVES), n))
    log(f"K4 shade with per-ray lights: kernel "
        f"{rec['shade_lights']['ms']:.3f} ms (the same rays with the fixed "
        f"lights {rec['shade_lights']['fixed_ms']:.3f} ms), plain "
        f"{rec['shade_lights']['plain_ms']:.3f} ms per bounce (with the K1 "
        f"shadow query), bound {rec['shade_lights']['bound_ms'] * 1e3:.1f} "
        f"us")
    for k in ("camera_rays_stochastic", "light_points"):
        r = rec[k]
        log(f"{k}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"bound {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']})")
    return rec


def render_stochastic(path, resolution, device, **kw):
    from yocto_raytracing_tpu_torch.render import renderer

    kw = dict(dict(max_depth=DEPTH, chunk_pixels=CHUNK_PIXELS,
                   stochastic=True, seed=SEED, area_lights=True), **kw)
    return renderer.render_scene_file(path, resolution, SAMPLES,
                                      device=device, ldr=True, **kw)


def phase_area_frame(path, device, dev_info, name) -> dict:
    """A stochastic area-light frame through render_scene_file on the card:
    its launch counts, a warm profile, the first COMPARE_PIXELS pixels
    against the all-plain path (1 u8 step), a bit-identical rerun and
    chunking, and another frame under another seed."""
    from yocto_raytracing_tpu_torch import kernels
    from yocto_raytracing_tpu_torch.render import lights, renderer

    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    img, host, scene, meta = render_stochastic(path, RES, device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kernels.launches)
    height, width = img.shape[:2]
    spp = SAMPLES * SAMPLES
    rays = width * height * spp
    log(f"frame {name} (stochastic, seed {SEED}, area lights, aperture "
        f"{host.cameras[0].aperture}): {width}x{height} x {spp} spp = "
        f"{rays} primary rays, depth {DEPTH}: {wall:.3f} s wall, "
        f"{rays / wall / 1e6:.3f} Mrays/s on {dev_info['smi']}; launches "
        f"{counts}")
    if img.shape != (RES, width, 4) or img.dtype != np.uint8:
        raise AssertionError(f"frame {name}: bad image {img.shape}")
    if not (img[..., 3] == 255).all() or img[..., :3].max() == 0:
        raise AssertionError(f"frame {name}: alpha or black frame")
    for k in STOCHASTIC_KERNELS:
        if counts[k] <= 0:
            raise AssertionError(f"frame {name}: kernel {k} never launched")
    if counts["camera_rays"]:
        raise AssertionError(f"frame {name}: the pinhole kernel K2 ran")
    prof = profile_summary(lambda: render_stochastic(path, RES, device),
                           f"warm stochastic frame {name}",
                           ("camera_rays_stochastic", "light_points"))

    again = render_stochastic(path, RES, device)[0]
    rechunked = render_stochastic(path, RES, device, chunk_pixels=1 << 13)[0]
    other = render_stochastic(path, RES, device, seed=SEED + 1)[0]
    same = np.array_equal(img, again) and np.array_equal(img, rechunked)
    moved = int((other != img).any(axis=-1).sum())
    log(f"frame {name}: rerun and chunk_pixels {1 << 13} bit-identical "
        f"{same}; seed {SEED + 1} differs on {moved} pixels")
    if not same or moved == 0:
        raise AssertionError(f"frame {name}: seed/chunk determinism")

    npix = min(COMPARE_PIXELS, width * height)
    sampler = lights.build_light_sampler(host, None, meta, device)
    amb = torch.full((3,), 0.1, dtype=torch.float32, device=device)
    parts = []
    t0 = time.perf_counter()
    for start in range(0, npix, CHUNK_PIXELS):
        stop = min(start + CHUNK_PIXELS, npix)
        ids = torch.arange(start * spp, stop * spp, dtype=torch.int32,
                           device=device)
        rgb = renderer.trace_rays(scene, ids, amb, width, height, SAMPLES,
                                  DEPTH, meta.has_kd_textures,
                                  meta.has_ks_textures, plain=True,
                                  stochastic=True, seed=SEED,
                                  light_sampler=sampler)
        parts.append(renderer.pixel_finish_plain(rgb, spp, True))
    plain = torch.cat(parts).cpu().numpy()
    d = np.abs(plain.astype(np.int32) - img.reshape(-1, 4)[:npix])
    log(f"frame {name}: kernel vs all-plain on {npix} pixels: max "
        f"{d.max()} u8 steps, {int((d > 0).any(axis=1).sum())} pixels "
        f"differ ({time.perf_counter() - t0:.1f} s)")
    if d.max() > 1:
        raise AssertionError(f"frame {name}: {d.max()} u8 steps off plain")
    return dict(counts=counts, wall=wall, rays=rays, prof=prof)


def phase_point_light_area(path, deterministic, device):
    """The point-light hair frame in area mode (non-stochastic, any seed)
    equals the deterministic frame bit for bit: a single-point light's
    sample is its position."""
    img = render_stochastic(path, RES, device, stochastic=False)[0]
    log(f"frame hair (point lights) with area lights: bit-equal to the "
        f"deterministic frame {np.array_equal(img, deterministic)}")
    if not np.array_equal(img, deterministic):
        raise AssertionError("point-light area frame differs from the "
                             "deterministic frame")


def bounce_state(seed: int, n: int, device) -> list:
    """A random bounce at ``n`` rays on the card, made with numpy from a
    seed: acc, thr, color, kr, p, refl_dir (N, 3) f32 and mask (N,) bool,
    with dead lanes, kr of 0 and -0.0, NaN kr and NaN colors on masked
    lanes."""
    rng = np.random.default_rng(seed)
    f = np.float32
    acc = rng.uniform(-1, 4, (n, 3)).astype(f)
    thr = rng.uniform(0, 1, (n, 3)).astype(f)
    color = rng.uniform(0, 2, (n, 3)).astype(f)
    kr = rng.uniform(-0.2, 1, (n, 3)).astype(f)
    pick = rng.integers(0, 6, (n, 3))
    kr[pick == 0] = 0.0
    kr[pick == 1] = -0.0
    kr[(pick == 2) & (rng.uniform(size=(n, 3)) < 0.1)] = np.nan
    p = rng.normal(size=(n, 3)).astype(f)
    refl = rng.normal(size=(n, 3)).astype(f)
    mask = rng.uniform(size=n) < 0.7
    color[~mask & (rng.uniform(size=n) < 0.5)] = np.nan
    return [torch.from_numpy(x).to(device)
            for x in (acc, thr, color, kr, p, refl, mask)]


def phase_bounce_kernel(device) -> dict:
    """K12 against its plain version (``bounce_update_plain``) at a chunk's
    524,288 rays (CHUNK_PIXELS at SAMPLES x SAMPLES): acc, thr, ro, rd and
    tmax bit-equal, the next alive word set as any(cont); with a zero alive
    word nothing written. Its timed call, plain time and device time per
    launch, live and dead, beside its bound."""
    from yocto_raytracing_tpu_torch.render import renderer

    n = CHUNK_PIXELS * SAMPLES * SAMPLES
    acc, thr, color, kr, p, refl, mask = bounce_state(SEED, n, device)
    want = renderer.bounce_update_plain(acc, thr, color, kr, p, refl, mask)
    state = [acc.clone(), thr.clone(), torch.zeros_like(acc),
             torch.zeros_like(acc), torch.zeros(n, device=device)]
    words = torch.tensor([1, 0, 0, 0], dtype=torch.int32, device=device)
    ins = (color, kr, p, refl, mask)
    renderer.bounce_update_cuda(*state, *ins, words[0:1], words[1:2])
    tmax = torch.where(want[4], float(FLT_MAX), float(-FLT_MAX))
    err = 0.0
    for name, a, b in zip(("acc", "thr", "ro", "rd", "tmax"), state,
                          (*want[:4], tmax)):
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise AssertionError(f"K12 {name}: differs from plain on "
                                 f"{int((a != b).sum())} values")
        both = torch.isfinite(a) & torch.isfinite(b)
        err = max(err, float((a[both] - b[both]).abs().max()))
    if words[1].item() != int(want[4].any()):
        raise AssertionError("K12: the next alive word is wrong")
    before = [t.clone() for t in state]
    renderer.bounce_update_cuda(*state, *ins, words[2:3], words[3:4])
    if words[3].item() or not all(
            torch.equal(a.view(torch.int32), b.view(torch.int32))
            for a, b in zip(state, before)):
        raise AssertionError("K12 wrote under a zero alive word")

    def launch(word):
        return lambda: renderer.bounce_update_cuda(*state, *ins, word,
                                                   words[1:2])

    # the bytes this state needs: every lane reads color, kr, mask, acc and
    # thr and writes acc, ro, rd and tmax; a lane that goes on also reads p
    # and refl_dir and writes thr
    live = int(want[4].sum())
    moved = (nbytes(color, kr, mask, acc, thr)
             + nbytes(state[0], state[2], state[3], state[4])
             + live * 3 * 12)

    dev_us = {}
    for what, word in (("live", words[0:1]), ("dead", words[2:3])):
        prof = profile_summary(
            lambda f=launch(word): [f() for _ in range(BOUNCE_ROUNDS)],
            f"K12 {what}", ("bounce",))
        dev_us[what] = device_us(prof["by_name"], "bounce") / BOUNCE_ROUNDS
    rec = dict(
        max_abs_err=err, ms=cuda_ms(launch(words[0:1]), 20),
        plain_ms=cuda_ms(lambda: renderer.bounce_update_plain(
            acc, thr, color, kr, p, refl, mask), 5),
        library_ms=None, device_us=dev_us["live"],
        dead_device_us=dev_us["dead"],
        **bound("bounce", moved, n))
    log(f"K12 bounce: {n} rays, acc, thr, ro, rd and tmax bit-equal to "
        f"plain, the alive word set, nothing written under a zero word; "
        f"timed call {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms; "
        f"device us per launch (profiler) {dev_us['live']:.2f}, dead "
        f"{dev_us['dead']:.2f}; bound {rec['bound_ms'] * 1e3:.2f} us "
        f"({rec['bound_by']}, {moved / n:.1f} bytes a ray, {live} of the "
        f"rays go on)")
    return rec


def phase_bounce_bwd_kernel(device) -> dict:
    """K14, the reverse of K12 (the training step's device loop), against
    its plain version (``bounce_update_bwd_plain``) at a step's TRAIN_RAYS
    rays on a random bounce (``bounce_state``: dead lanes, kr of 0, -0.0
    and NaN, NaN colors on masked lanes) with normal cotangents: the four
    shading cotangents and the throughput's (in place) bit-equal. K12's
    out-of-place form (the step's forward) bit-equal to its in-place form
    on the same state. K14's timed call, plain time and device time per
    launch beside its bound."""
    from yocto_raytracing_tpu_torch.render import renderer

    n = TRAIN_RAYS
    acc, thr, color, kr, p, refl, mask = bounce_state(SEED + 1, n, device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    g_acc, g_thr, g_ro, g_rd = (torch.randn((n, 3), generator=gen,
                                            device=device) for _ in range(4))
    want = renderer.bounce_update_bwd_plain(g_acc, g_thr, g_ro, g_rd, thr,
                                            color, kr, mask)
    out = [torch.zeros_like(acc) for _ in range(4)]
    carry = g_thr.clone()
    renderer.bounce_update_bwd_cuda(g_acc, carry, g_ro, g_rd, thr, color,
                                    kr, mask, out)
    err = 0.0
    for name, a, b in zip(("g_color", "g_kr", "g_p", "g_refl", "g_thr"),
                          (*out, carry), want):
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise AssertionError(f"K14 {name}: differs from plain on "
                                 f"{int((a != b).sum())} values")
        both = torch.isfinite(a) & torch.isfinite(b)
        err = max(err, float((a[both] - b[both]).abs().max()))
    # lanes with an infinite thr beside the NaN kr: JAX's transpose gives
    # NaN where a lane that does not go on multiplies its zero cotangent by
    # them; K14 the same NaN positions, and the finite values bit-equal
    thr_inf = thr.clone()
    thr_inf[::16] = float("inf")
    want_inf = renderer.bounce_update_bwd_plain(g_acc, g_thr, g_ro, g_rd,
                                                thr_inf, color, kr, mask)
    out_inf = [torch.zeros_like(acc) for _ in range(4)]
    carry_inf = g_thr.clone()
    renderer.bounce_update_bwd_cuda(g_acc, carry_inf, g_ro, g_rd, thr_inf,
                                    color, kr, mask, out_inf)
    nan_values = 0
    for name, a, b in zip(("g_color", "g_kr", "g_p", "g_refl", "g_thr"),
                          (*out_inf, carry_inf), want_inf):
        nan = b.isnan()
        if not torch.equal(a.isnan(), nan) or not torch.equal(
                a[~nan].view(torch.int32), b[~nan].view(torch.int32)):
            raise AssertionError(f"K14 {name} with infinite thr: differs "
                                 f"from plain")
        nan_values += int(nan.sum())
    dead = ~(mask & (kr > 0).any(-1))
    dead_nan = int(want_inf[1][dead].isnan().any(-1).sum())
    if dead_nan == 0:
        raise AssertionError("K14: no dead lane with an infinite thr or a "
                             "NaN kr")
    # K12 out of place against in place
    words = torch.tensor([1, 0, 1, 0], dtype=torch.int32, device=device)
    ins = (color, kr, p, refl, mask)
    st_in = [acc.clone(), thr.clone(), torch.zeros_like(acc),
             torch.zeros_like(acc), torch.zeros(n, device=device)]
    renderer.bounce_update_cuda(*st_in, *ins, words[0:1], words[1:2])
    st_out = [acc.clone(), torch.zeros_like(acc), torch.zeros_like(acc),
              torch.zeros(n, device=device)]
    thr_out = torch.zeros_like(acc)
    renderer.bounce_update_out_cuda(st_out[0], thr, thr_out, *st_out[1:],
                                    *ins, words[2:3], words[3:4])
    for name, a, b in zip(("acc", "thr", "ro", "rd", "tmax"), st_in,
                          (st_out[0], thr_out, *st_out[1:])):
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise AssertionError(f"K12 out of place {name}: differs from "
                                 f"in place")
    if words.tolist() != [1, 1, 1, 1] or not torch.equal(
            thr.view(torch.int32), bounce_state(SEED + 1, n, device)[1]
            .view(torch.int32)):
        raise AssertionError("K12 out of place: alive word or thr_in")

    def launch():
        renderer.bounce_update_bwd_cuda(g_acc, carry, g_ro, g_rd, thr,
                                        color, kr, mask, out)

    # the bytes this state needs: every lane reads g_acc, thr, color, kr,
    # g_thr and mask and writes five (N, 3) cotangents; a lane that goes
    # on also reads g_ro and g_rd
    live = int((mask & (kr > 0).any(-1)).sum())
    moved = (nbytes(g_acc, thr, color, kr, g_thr, mask) + 5 * nbytes(g_acc)
             + live * 2 * 12)
    prof = profile_summary(lambda: [launch() for _ in range(BOUNCE_ROUNDS)],
                           "K14 bounce_bwd", ("bounce_bwd",))
    dev_us = device_us(prof["by_name"], "bounce_bwd") / BOUNCE_ROUNDS
    rec = dict(
        max_abs_err=err, ms=cuda_ms(launch, 20),
        plain_ms=cuda_ms(lambda: renderer.bounce_update_bwd_plain(
            g_acc, g_thr, g_ro, g_rd, thr, color, kr, mask), 5),
        library_ms=None, device_us=dev_us, **bound("bounce_bwd", moved, n))
    log(f"K14 bounce_bwd: {n} rays, the four shading cotangents and g_thr "
        f"bit-equal to plain; with an infinite thr on every 16th ray, "
        f"{nan_values} NaN values at plain's positions ({dead_nan} dead "
        f"lanes with a NaN g_kr, as JAX's transpose gives), the rest "
        f"bit-equal; K12 out of place bit-equal to in place; "
        f"timed call {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms; "
        f"device us per launch (profiler) {dev_us:.2f}; bound "
        f"{rec['bound_ms'] * 1e3:.2f} us ({rec['bound_by']}, "
        f"{moved / n:.1f} bytes a ray, {live} of the rays go on)")
    return rec


RECORDS_ROUNDS = 20      # K13 launches per profile
# the scenes on which K13 is timed (all four of phase_records_kernel are
# held bit-equal)
RECORDS_TIMED = ("hair", "random 10004 instances")


def phase_records_kernel(device) -> dict:
    """K13 against its plain version (``hit_records.pack`` and
    ``shade_records.pack``) on the hair scene (the main path's), the
    10,004-instance scene (the benchmark's instance10000 stand-in), a
    random 8-instance scene and the mirror pair: every record table
    bit-equal, through ``pack_into`` and through a prepared launch after
    leaves are edited in place (node starts whose packed sums wrap). On
    hair and the 10,004-instance scene: the prepared launch (the device
    loops' way, ``records.prepare``) timed (``kernel_time``: CUDA events,
    and device us per launch from a profile of RECORDS_ROUNDS launches),
    an empty launch of its grid and arguments profiled and timed the same
    way
    (the floor of any such launch), the unprepared ``pack_into`` (its
    arguments checked on every call), the packers' time and the bound (the
    leaves read once, the tables written once). Returns the hair scene's
    record, the 10,004-instance scene's under "big"."""
    from yocto_raytracing_tpu_torch import testscenes
    from yocto_raytracing_tpu_torch.ops import (hit_records, records,
                                                shade_records)

    cases = [("hair", lambda: testscenes.make_hair_scene(256)),
             ("random 10004 instances",
              lambda: testscenes.make_random_scene(n_instances=10004)),
             ("random", lambda: testscenes.make_random_scene(seed=0)),
             ("mirror pair", testscenes.make_mirror_pair_scene)]
    out = {}
    for name, make in cases:
        scene, _ = scene_on(make(), device)
        hrec, srec = records.empty(scene)
        new = records.prepare(scene, hrec, srec)
        for edit in (False, True):
            if edit:
                scene.pos.mul_(1.5)
                scene.mat_kd.add_(0.25)
                scene.node_skip.add_(3)
                scene.node_start[::3] = 2 ** 29 + 7   # 8 * start wraps
            want = (*hit_records.pack(scene)[:3], *shade_records.pack(scene))
            for t in records.tables(hrec, srec):
                t.fill_(float("nan"))
            if edit:
                new()
            else:
                records.pack_into(scene, hrec, srec)
            for i, (a, b) in enumerate(zip(records.tables(hrec, srec),
                                           want)):
                if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
                    raise AssertionError(f"K13 {name} table {i} (edited "
                                         f"{edit}): differs from plain")
        if name not in RECORDS_TIMED:
            continue
        t = kernel_time(f"K13 {name}", new, "records", 20,
                        per_profile=RECORDS_ROUNDS)
        empty = records.prepare_cuda(scene, hrec, srec, empty=True)
        prof = profile_summary(lambda: [empty() for _ in range(
            RECORDS_ROUNDS)], f"K13 {name}: empty launch", ("records_empty",))
        ins = [getattr(scene, k) for k, _, _ in records.LEAVES]
        moved = nbytes(*ins, *records.tables(hrec, srec))
        out[name] = rec = dict(
            max_abs_err=0.0, ms=t["ms"], device_us=t["device_us"],
            empty_us=launch_us(prof, "records_empty")[0],
            empty_ms=cuda_ms(empty, 20), blocks=new.blocks,
            unprepared_ms=cuda_ms(
                lambda: records.pack_into(scene, hrec, srec), 20),
            plain_ms=cuda_ms(lambda: (hit_records.pack(scene),
                                      shade_records.pack(scene)), 5),
            library_ms=None, moved=moved, **bound("records", moved, 0, ops=0))
        log(f"K13 records, {name} ({scene.node_start.shape[0]} nodes, "
            f"{scene.prim_v.shape[0]} prims, {scene.inst_axes.shape[0]} "
            f"instances; {new.blocks} blocks of 256 threads, a thread a "
            f"16-byte quad): device us per launch (profiler) "
            f"{rec['device_us']:.2f}, an empty launch of its grid "
            f"{rec['empty_us']:.2f}; prepared launch timed {rec['ms']:.4f} "
            f"ms, the empty launch {rec['empty_ms']:.4f} ms; unprepared "
            f"pack_into {rec['unprepared_ms']:.4f} ms; plain "
            f"{rec['plain_ms']:.4f} ms; bound {rec['bound_ms'] * 1e3:.3f} us "
            f"({rec['bound_by']}, {moved} bytes)")
    log("K13 records: the hair, 10,004-instance, random and mirror-pair "
        "scenes' six tables bit-equal to plain, before and after leaves "
        "edited in place")
    return dict(out["hair"], big=out["random 10004 instances"])


# the ways of running a frame, timed in turns (eager loop, frame_device's
# first call of a key, its repeated call)
LOOP_TURNS = ("eager", "miss", "hit", "hit", "miss", "eager")


def tensor_mib(obj) -> float:
    """MiB of the storages that ``obj``'s tensors hold (its attributes,
    lists, tuples, dicts and dataclasses walked), each storage once."""
    import dataclasses

    seen, total = set(), 0

    def add(x):
        nonlocal total
        if isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            if st.data_ptr() not in seen:
                seen.add(st.data_ptr())
                total += st.nbytes()
        elif isinstance(x, (list, tuple)):
            for y in x:
                add(y)
        elif isinstance(x, dict):
            for y in x.values():
                add(y)
        elif dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                add(getattr(x, f.name))

    add(dict(vars(obj)))
    return total / 2 ** 20


def loop_turns(label, ways, order, expect, dev_info) -> dict:
    """Run ``ways`` (name -> call returning a frame's f32 sums on the
    host) in the order ``order``, each result bit-equal to the eager
    loop's (computed first; AssertionError on a miss), then profile each
    way once, in the order of their first turns. Returns per
    way: its walls in turns, the records' ``host_ms`` and ``cache_hit``, the
    profile (with ``dead_bounce_launches`` for the device loop), and the
    growth of the reserved device memory over the turns."""
    from yocto_raytracing_tpu_torch import kernels

    want = ways["eager"]().view(np.int32)
    out = {k: dict(walls=[], host_ms=[], hits=[]) for k in ways}
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    for k in order:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = ways[k]()
        torch.cuda.synchronize()
        out[k]["walls"].append((time.perf_counter() - t0) * 1e3)
        if not np.array_equal(got.view(np.int32), want):
            raise AssertionError(f"{label} {k}: the f32 sums differ from "
                                 f"the eager loop's")
        if k != "eager":
            rec = kernels.last_frame()
            out[k]["host_ms"].append(rec["host_ms"])
            out[k]["hits"].append(rec["cache_hit"])
    grown = (torch.cuda.memory_reserved() - reserved) / 2 ** 20
    for k in dict.fromkeys(order):
        check = (None if k == "eager" else
                 lambda ev: dead_bounce_launches(ev, kernels.last_frame()))
        out[k]["prof"] = profile_summary(ways[k], f"{label} {k}", expect,
                                         check=check)
    for k, r in out.items():
        p = r.get("prof", dict(checked=None))
        dead = p["checked"]
        stages = {s: [h[s] for h in r["host_ms"]] for s in
                  (r["host_ms"][0] if r["host_ms"] else ())}
        log(f"{label} {k}: wall ms in turns "
            + ", ".join(f"{w:.2f}" for w in r["walls"])
            + ("" if "prof" not in r else
               f"; device busy {p['busy_ms']:.3f} ms, idle share "
               f"{p['idle']:.3f}, device ops {p['ops']}, copies to the "
               f"host {p['d2h']}")
            + ("" if dead is None else
               f"; live bounces by depth {dead['live_by_depth']}, dead "
               f"bounces {dead['bounces']}, none launched")
            + ("" if not stages else "; host ms (enqueue) "
               + ", ".join(f"{s} " + "/".join(f"{v:.2f}" for v in vs)
                           for s, vs in stages.items())
               + f"; cache hits {r['hits']}")
            + f"; f32 bit-equal to the eager loop; on {dev_info['smi']}")
    log(f"{label}: reserved device memory grew {grown:.1f} MiB over the "
        f"{len(order)} calls in turns")
    out["grown_mib"] = grown
    return out


def phase_frame_device_loop(frames, deep, device, dev_info) -> None:
    """The device loop on the frames (RES rows, SAMPLES, CHUNK_PIXELS; the
    area frames stochastic with seed SEED) at their depths, three ways in
    turns (LOOP_TURNS), each ending in the frame's f32 sums on the host:
    the eager per-chunk loop (``frame_eager``), ``frame_device``'s first
    call of a key (a miss: the kept entry cleared
    first; records packed eagerly, the chunk captured before chunk 0 with
    dead bounces in IF nodes, the staging graph captured after the
    replays) and its repeated call (a hit). For each: wall per call,
    ``host_ms`` by stage, one profile (device busy time, idle share, device
    ops, copies to the host: the frame's one into pinned memory, and on a
    miss at most one read of the instances' frame words, the live bounces
    by depth and the dead bounces, none launched in the graph:
    ``dead_bounce_launches``), f32 sums bit-equal to the
    eager loop's (a miss raises); the reserved memory's growth over the
    turns and the kept entry's size. A frame named in ``deep`` must run
    bounces 2 and 3 in some chunk (their IF nodes set by K12 inside the
    node before). On each frame, last, the loop after a leaf edited in
    place and under a new seed (``loop_edits``). Also
    ``render_scene_file``'s wall split into scene load, device scene and
    BVH build, upload and ``render_image``."""
    from yocto_raytracing_tpu_torch import scene as scene_lib
    from yocto_raytracing_tpu_torch.render import lights, renderer

    t_phase = time.perf_counter()
    for name, path, area, depth in frames:
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        host = scene_lib.load_scene(path)
        t.append(time.perf_counter())
        leaves, meta = scene_lib.build_device_scene(host)
        t.append(time.perf_counter())
        scene = scene_lib.to_torch(leaves, device)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        sampler = (lights.build_light_sampler(host, leaves, meta, device)
                   if area else None)
        width = renderer.image_width(host.cameras[0].aspect, RES)
        kw = dict(max_depth=depth, chunk_pixels=CHUNK_PIXELS,
                  stochastic=area, seed=SEED, light_sampler=sampler)
        renderer.render_image(scene, meta, width, RES, SAMPLES, ldr=True,
                              **kw)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        split = np.diff(t) * 1e3
        npix = width * RES
        args = (scene, meta, width, RES, SAMPLES)

        def hit():
            return renderer.to_host(renderer.frame_device(*args, **kw)[:npix])

        def miss():
            renderer._frames.clear()
            return hit()

        ways = dict(eager=lambda: renderer.frame_eager(*args, **kw),
                    miss=miss, hit=hit)
        expect = ("hit_nearest", "hit_any", "shade", "pixel_finish",
                  "camera_rays_stochastic" if area else "camera_rays")
        label = f"frame_device_loop {name} depth {depth}"
        log(f"{label}: {width}x{RES} x {SAMPLES ** 2} spp, "
            f"{-(-npix // CHUNK_PIXELS)} chunks; render_scene_file split ms: "
            f"load {split[0]:.2f}, device scene and BVH {split[1]:.2f}, "
            f"upload {split[2]:.2f}, render_image {split[3]:.2f}")
        res = loop_turns(label, ways, LOOP_TURNS, expect, dev_info)
        # the frame crosses to the host once, into the pinned buffer; a
        # miss also reads the instances' frame words to pageable memory
        # when it builds the entry (hit_records.identity_share, k1_ident)
        hit_d2h, miss_d2h = (res[k]["prof"]["d2h"] for k in ("hit", "miss"))
        miss_pinned = res["miss"]["prof"]["d2h_pinned"]
        if hit_d2h != 1 or miss_pinned != 1 or miss_d2h - miss_pinned > 1:
            raise AssertionError(
                f"{label}: copies to the host: hit {hit_d2h}, not 1; miss "
                f"{miss_pinned} to pinned memory, not 1, and "
                f"{miss_d2h - miss_pinned} others, not at most 1")
        if (not all(res["hit"]["hits"]) or any(res["miss"]["hits"])
                or any(h["capture"] for h in res["hit"]["host_ms"])):
            raise AssertionError(f"{label}: a repeated call missed the "
                                 f"cache or captured")
        live = res["hit"]["prof"]["checked"]["live_by_depth"]
        if name in deep and not (live[2] and live[3]):
            raise AssertionError(f"{label}: bounces 2 and 3 ran in "
                                 f"{live[2]} and {live[3]} chunks, not in "
                                 f"some")
        renderer._frames.clear()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        hit()
        torch.cuda.synchronize()
        (state,) = renderer._frames.values()
        log(f"{label}: the kept entry holds {tensor_mib(state):.1f} MiB of "
            f"tensors (its copy of the scene {tensor_mib(state.scene):.2f}); "
            f"allocated "
            f"{(torch.cuda.memory_allocated() - before) / 2 ** 20:.1f} MiB "
            f"more than with no entry, graphs' pools included")
        loop_edits(label, args, kw, npix, dev_info)
    log(f"frame_device_loop: phase {time.perf_counter() - t_phase:.1f} s")


def loop_edits(label, args, kw, npix, dev_info) -> None:
    """``frame_device`` after a call of its key, then after a scene leaf is
    edited in place (the materials' kd halved) and, where the frame reads a
    seed, under a new one (the entry's seed word): each a cache hit, its
    f32 sums bit-equal to ``frame_eager``'s on the same inputs."""
    from yocto_raytracing_tpu_torch import kernels
    from yocto_raytracing_tpu_torch.render import renderer

    scene = args[0]
    renderer.frame_device(*args, **kw)   # the entry of this key, kept
    cases = [("kd halved in place", kw, True)]
    if kw["stochastic"]:
        cases.append((f"seed {kw['seed'] + 1}",
                      dict(kw, seed=kw["seed"] + 1), False))
    for what, kw2, edit in cases:
        if edit:
            scene.mat_kd.mul_(0.5)
        got = renderer.to_host(renderer.frame_device(*args, **kw2)[:npix])
        rec = kernels.last_frame()
        same = np.array_equal(got.view(np.int32), renderer.frame_eager(
            *args, **kw2).view(np.int32))
        log(f"{label} {what}: cache hit {rec['cache_hit']}, f32 sums "
            f"bit-equal to the eager loop's on the same inputs: {same}; on "
            f"{dev_info['smi']}")
        if not same or not rec["cache_hit"]:
            raise AssertionError(f"{label} {what}: the frame differs from "
                                 f"the eager loop's, or the cache missed")


def phase_small_reference(path, device):
    """The port on the card against the port on the CPU (plain torch, held
    to the JAX package and the reference golden by the CPU tests): the hair
    scene at 96p, HDR within 1e-5 and device tonemap within 1 u8 step."""
    from yocto_raytracing_tpu_torch.render import renderer

    for ldr in (False, True):
        gpu, *_ = renderer.render_scene_file(path, 96, 1, device=device,
                                             ldr=ldr)
        cpu, *_ = renderer.render_scene_file(path, 96, 1, device="cpu",
                                             ldr=ldr)
        if not np.isfinite(gpu.astype(np.float32)).all():
            raise AssertionError("small reference: non-finite pixels")
        d = np.abs(gpu.astype(np.float64) - cpu).max()
        limit = 1.0 if ldr else 1e-5
        log(f"small reference (hair 96p, {'ldr' if ldr else 'hdr'}): "
            f"max |cuda - cpu| {d}")
        if d > limit:
            raise AssertionError(f"small reference: {d} > {limit}")


def middle_ids(width, height, samples, n, device, last=False):
    """``n`` consecutive ray ids (scanline order) from the middle of the
    frame, or its end with ``last``."""
    total = width * height * samples * samples
    first = total - n if last else (total // 2 - n // 2)
    return torch.arange(first, first + n, dtype=torch.int32, device=device)


def k4_times(label, scene, meta, inputs, amb, light_pos=None) -> dict:
    """K4 on one bounce with the K1 shadow query, through the host path of
    the device loop (``shade.forward_launches`` with one argument struct,
    records packed once): timed calls (CUDA events around the call), and
    the device time of the prep and finish kernels apart, from one
    profiled call. Returns ms and us per launch."""
    from yocto_raytracing_tpu_torch.kernels import parity
    from yocto_raytracing_tpu_torch.ops import shade_records
    from yocto_raytracing_tpu_torch.render import shade

    ro, rd, hits, active = inputs
    occ = parity.occluder(scene)
    mask = active & hits["hit"]
    leaves = {k: getattr(scene, k) for k in shade.GRAD_LEAVES}
    recs = shade_records.pack(scene)
    args = shade._shade_args(scene, leaves, amb, meta.has_kd_textures,
                             meta.has_ks_textures, light_pos, ro.shape[0],
                             recs)

    def run():
        with torch.no_grad():
            shade.forward_launches(args, ro, rd, hits["inst"], hits["prim"],
                                   mask, occ)

    ms = cuda_ms(run, 10)
    prof = profile_summary(run, f"K4 {label}", ("shade_prep", "shade_finish"))
    out = dict(ms=ms, prep_us=device_us(prof["by_name"], "shade_prep"),
               finish_us=device_us(prof["by_name"], "shade_finish"))
    log(f"K4 {label}: {ro.shape[0]} rays, device us per launch (profiler) "
        f"prep {out['prep_us']:.1f}, finish {out['finish_us']:.1f}; timed "
        f"launches with the K1 shadow query {ms:.3f} ms")
    return out


def phase_shade_kernel(cases, device) -> dict:
    """K4 against the plain shading on the same K1 hits and the same K1
    shadow query: bit-equal outputs (ULP gap 0) and equal masks. The first
    case is timed (CUDA events, with the K1 shadow query; ``k4_times``)."""
    from yocto_raytracing_tpu_torch.kernels import parity
    from yocto_raytracing_tpu_torch.render import shade

    amb = torch.full((3,), 0.1, device=device)
    rec = None
    for name, scene, meta, w, h, bounce, last in cases:
        ids = middle_ids(w, h, SAMPLES, CHUNK_PIXELS * SAMPLES * SAMPLES,
                         device, last)
        inputs = parity.shade_inputs(scene, ids, w, h, SAMPLES, bounce, amb)
        rep = parity.compare_shade(scene, inputs, amb, meta.has_kd_textures,
                                   meta.has_ks_textures)
        gaps = {k: rep[k] for k in parity.SHADE_OUTPUTS}
        log(f"K4 shade {name}: {ids.shape[0]} rays, bounce {bounce}, "
            f"{rep['hits']} hits; ULP gap kernel vs plain {gaps}, masks "
            f"equal {rep['mask_equal']} (tolerance: bit-equal)")
        if not rep["mask_equal"] or any(gaps.values()):
            raise AssertionError(f"K4 {name}: {rep}")
        if rec is None:
            occ = parity.occluder(scene)
            ro, rd, hits, active = inputs

            def run(fn):
                with torch.no_grad():
                    fn(scene, ro, rd, hits, amb, active, occ,
                       meta.has_kd_textures, meta.has_ks_textures)

            n = ro.shape[0]
            rec = dict(max_abs_err=rep["max_abs_err"],
                       plain_ms=cuda_ms(lambda: run(shade.shade_step_plain),
                                        3),
                       library_ms=None,
                       wrapper_ms=cuda_ms(lambda: run(shade.shade_step_cuda),
                                          10),
                       **k4_times(f"shade {name}", scene, meta, inputs,
                                  amb),
                       # ro, rd, inst, prim, mask in; color, kr, p, refl out
                       **bound("shade", n * (24 + 8 + 1 + 48)
                               + leaves_bytes(scene, SHADE_LEAVES), n))
            log(f"K4 shade {name}: kernel {rec['ms']:.3f} ms, through "
                f"shade_step_cuda {rec['wrapper_ms']:.3f} ms, plain "
                f"{rec['plain_ms']:.3f} ms per bounce (each with the K1 "
                f"shadow query); bound {rec['bound_ms'] * 1e3:.2f} us")
    return rec


def k5_check(label, scene, meta, inputs, amb, gen, light_pos=None) -> dict:
    """K5 through its saved-bounce entry (``shade.shade_step_bwd``, the
    device loop's) on one bounce: every leaf, d_ro and d_rd within
    GRAD_RTOL relative L2 of its plain version on the saved bounce
    (``parity.compare_shade_bwd``), or with per-ray light positions of
    torch autograd of the plain shading (``parity.compare_shade_grads``);
    the light leaves bit-identical over two runs of K5 (their sums run in a
    fixed order); timed (CUDA events around the wrapper, its buffers
    included) and profiled (``kernel_time``: device us per launch of K5's
    two kernels)."""
    from yocto_raytracing_tpu_torch.kernels import parity

    saved = parity.shade_bwd_inputs(scene, inputs, amb, meta.has_kd_textures,
                                    meta.has_ks_textures, light_pos)
    if light_pos is None:
        rep = parity.compare_shade_bwd(scene, saved, gen)
        against = "its plain version on the saved bounce"
    else:
        rep = parity.compare_shade_grads(scene, inputs, amb, gen,
                                         meta.has_kd_textures,
                                         meta.has_ks_textures, light_pos)
        against = "torch autograd of the plain shading"
    worst = parity.check_grads(rep, GRAD_RTOL, f"K5 {label}")
    cots = parity.shade_bwd_cotangents(saved, gen)

    def new():
        return parity.bwd_grads(scene, saved, cots)

    a, b = new(), new()
    lights_same = all(torch.equal(a[k], b[k]) for k in
                      ("light_pos", "light_axes", "light_o", "light_ke"))
    if not lights_same:
        raise AssertionError(f"K5 {label}: light gradients differ between "
                             f"two runs")
    kind = "shade_bwd" if light_pos is None else "shade_bwd_lights"
    out = kernel_time(f"K5 {label}", new, kind, 10)
    live = saved["mask"][: saved["mask"].numel() // 32 * 32].view(-1, 32)
    out.update(rel_vs_plain=worst,
               dead_warp_share=float(1 - live.any(1).float().mean()))
    log(f"K5 {label}: {saved['ro'].shape[0]} rays, dead-warp share "
        f"{out['dead_warp_share']:.4f}: against {against}, largest "
        f"relative L2 error {worst:.3e} over ro, rd and the leaves "
        f"(tolerance {GRAD_RTOL}); light leaves bit-identical over two "
        f"runs; device us per launch (profiler) {out['device_us']:.1f}; "
        f"timed call {out['ms']:.3f} ms")
    return out


def light_points_bound(sampler, n: int) -> dict:
    """K8's bound for n rays: the id read (4 B) and the L points written
    (12 B each) per ray; operations: OPS_PER_RAY per (light, ray) plus
    the search's ceil(log2 E) + 1 compares."""
    nl, ne = sampler["cdf"].shape
    search = int(np.ceil(np.log2(ne))) + 1
    return bound("light_points", 4 * n + 12 * nl * n, nl * n,
                 ops=nl * n * (OPS_PER_RAY["light_points"] + search))


def light_points_bwd_bound(sampler, n: int, num_verts: int,
                           g=None) -> dict:
    """K10's bound for n rays: the (L, N, 3) cotangent read once, d_pos and
    d_light_pos written once, and the ids of the rays that add a term;
    operations: OPS_PER_RAY per (light, ray) that adds one. A zero row of
    the cotangent adds nothing, so with ``g`` given only its non-zero rows
    count, and only the ids of rays with a non-zero row for some light;
    without it every row does."""
    nl = sampler["cdf"].shape[0]
    if g is None:
        rows, id_rays = nl * n, n
    else:
        live = (g != 0).any(-1)
        rows, id_rays = int(live.sum()), int(live.any(0).sum())
    return bound("light_points_bwd", 12 * nl * n + 4 * id_rays
                 + 12 * (num_verts + nl), rows)


def launch_us(prof: dict, kind: str) -> tuple:
    """One launch of ``kind`` in a profile of one or more: (device us, its
    device functions' mean event times {function: us}, the fewest events
    of one function in the trace). Means over the events in the trace, so
    an event the tracer lost does not count as a launch that took no
    time."""
    parts, captured = {}, []
    for f in DEVICE_FUNCTIONS[kind]:
        evs = [us for name, us in prof["events"]
               if name.startswith(f"yrt::{f}(")]
        if not evs:
            raise AssertionError(f"the profile of {kind} holds no {f}")
        parts[f] = sum(evs) / len(evs)
        captured.append(len(evs))
    return sum(parts.values()), parts, min(captured)


def kernel_time(label, fn, kind: str, reps: int, per_profile=1) -> dict:
    """A kernel's wrapper ``fn`` (its DEVICE_FUNCTIONS key ``kind``): timed
    calls (CUDA events around the call, ``reps`` calls), and the device us
    per launch from a profile of ``per_profile`` calls (``launch_us``), in
    all and by device function ("parts"), with the fewest launches the
    profile kept ("captured")."""
    ms = cuda_ms(fn, reps)
    prof = profile_summary(lambda: [fn() for _ in range(per_profile)],
                           label, (kind,))
    us, parts, captured = launch_us(prof, kind)
    return dict(ms=ms, device_us=us, parts=parts, captured=captured)


def camera_bwd_check(label, key, new, terms, build) -> dict:
    """K6 or K9 (``key``) at the path's batch: ``new()`` returns its sums,
    ``terms`` are the plain per-ray terms on the card. Held: two launches
    bit for bit, bit for bit ``ordered_camera_sums(terms)``, and within
    GRAD_RTOL relative L2 of the f64 sum of the terms; then timed
    (``kernel_time``, 20 launches a profile), beside the registers, SASS
    count and issue floor of ``build`` (``phase_camera_build``)."""
    from yocto_raytracing_tpu_torch.kernels import parity

    t0 = time.perf_counter()
    a, b = new(), new()
    rep = parity.compare_camera_sums(a, terms)
    if not (torch.equal(a.view(torch.int32), b.view(torch.int32))
            and rep["equal"] and rep["rel"] <= GRAD_RTOL):
        raise AssertionError(f"{label}: two launches equal "
                             f"{torch.equal(a, b)}, {rep}")
    out = dict(kernel_time(label, new, key, 20, 20),
               sums_vs_f64=rep, registers=build[key]["registers"],
               sass_per_ray=build[key]["sass_per_ray"],
               issue_floor_us=build[key]["issue_floor_us"])
    log(f"{label}: {terms.shape[0]} rays: bit-equal to the ordered sums of "
        f"the plain terms and over two launches; against the f64 sum of "
        f"the terms {rep['rel']:.3e} relative L2, max {rep['max_abs']:.3e} "
        f"(tolerance {GRAD_RTOL}); device us per launch (profiler) "
        f"{out['device_us']:.2f} (launches in the trace, of 20: "
        f"{out['captured']}); timed call {out['ms']:.4f} ms; registers "
        f"{out['registers']}; SASS {out['sass_per_ray']} instructions a "
        f"ray, issue floor {out['issue_floor_us']:.2f} us; these checks and "
        f"timings took {time.perf_counter() - t0:.1f} s")
    return out


def k8_check(label, scene, sampler, ids) -> dict:
    """K8 against the plain version on the same ids (bit-equal), then timed
    (``kernel_time``), beside K8's bound."""
    from yocto_raytracing_tpu_torch.kernels import parity
    from yocto_raytracing_tpu_torch.render import lights

    rep = parity.compare_light_points(scene, sampler, ids, SEED)
    if not rep["equal"]:
        raise AssertionError(f"K8 {label}: {rep}")

    def new():
        with torch.no_grad():
            lights.sample_light_points_cuda(scene, sampler, ids, SEED)

    nl, ne = sampler["cdf"].shape
    n = ids.shape[0]
    out = dict(kernel_time(f"K8 {label}", new, "light_points", 10),
               **light_points_bound(sampler, n))
    log(f"K8 {label}: {nl} lights x {n} rays, elements "
        f"{sampler['n'].tolist()} (E {ne}): bit-equal to the plain version; "
        f"device us per launch (profiler) {out['device_us']:.2f}, bound "
        f"{out['bound_ms'] * 1e3:.2f} us ({out['bound_by']}); timed call "
        f"{out['ms']:.4f} ms")
    return out


def k10_check(label, scene, sampler, ids, gen, registers, g=None) -> dict:
    """K10 on a seeded cotangent (or on ``g``, a path's own): within 1 ULP
    of the explicit f64 reverse (``light_points_bwd_plain``; entries below
    ``parity.LIGHT_BWD_FLOOR`` of the largest within that much of it),
    within GRAD_RTOL relative L2 of torch autograd of the plain version,
    bit-identical over two runs where ``registers`` (every light spans at
    most 8 vertices); then timed (``kernel_time``), beside K10's bound."""
    from yocto_raytracing_tpu_torch.kernels import parity
    from yocto_raytracing_tpu_torch.render import lights

    nl = sampler["cdf"].shape[0]
    n, nv = ids.shape[0], scene.pos.shape[0]
    if g is None:
        g = torch.randn((nl, n, 3), device=ids.device, generator=gen)
    rep = parity.compare_light_points_bwd(scene, sampler, ids, SEED, g)
    for out in ("d_pos", "d_light_pos"):
        r = rep[out]
        if r["ulp"] > 1 or r["small_abs"] > r["floor"]:
            raise AssertionError(f"K10 {label} vs the f64 reverse, {out}: "
                                 f"{r}")
    if registers and not rep["repeat"]:
        raise AssertionError(f"K10 {label}: two runs differ")
    auto = parity.compare_light_points_grads(scene, sampler, ids, SEED, gen)
    aworst = parity.check_grads(auto, GRAD_RTOL, f"K10 {label}")

    def new():
        lights.light_points_bwd(scene, sampler, ids, SEED, g, nv)

    out = dict(kernel_time(f"K10 {label}", new, "light_points_bwd", 10),
               **light_points_bwd_bound(sampler, n, nv, g),
               ulp=max(rep["d_pos"]["ulp"], rep["d_light_pos"]["ulp"]),
               rel_vs_autograd=aworst, repeat=rep["repeat"],
               nonzero_share=float((g != 0).any(-1).float().mean()))
    log(f"K10 {label}: {nl} lights x {n} rays, cotangent rows non-zero "
        f"{out['nonzero_share']:.4f}: against the f64 reverse "
        f"{out['ulp']} ULP (tolerance 1), against autograd {aworst:.3e} "
        f"relative L2 (tolerance {GRAD_RTOL}); two runs bit-identical "
        f"{rep['repeat']}"
        f"{' (required)' if registers else ' (atomic path: not required)'}; "
        f"device us per launch (profiler) {out['device_us']:.2f}, bound "
        f"{out['bound_ms'] * 1e3:.2f} us ({out['bound_by']}); timed call "
        f"{out['ms']:.4f} ms")
    return out


def phase_light_kernels(cases, device) -> dict:
    """K8 and K10 against their plain versions on ``cases`` [(name, host,
    registers)]: K8 on the middle CHUNK_PIXELS * SAMPLES^2 ray ids of the
    frame, K10 on the middle TRAIN_RAYS (``k8_check``, ``k10_check``).
    Returns {name: {"k8": ..., "k10": ...}}."""
    from yocto_raytracing_tpu_torch import scene as scene_lib
    from yocto_raytracing_tpu_torch.render import lights, renderer

    gen = torch.Generator(device=device)
    out = {}
    for k, (name, host, registers) in enumerate(cases):
        leaves, meta = scene_lib.build_device_scene(host)
        scene = scene_lib.to_torch(leaves, device)
        sampler = lights.build_light_sampler(host, leaves, meta, device)
        width = renderer.image_width(host.cameras[0].aspect, RES)
        ids = middle_ids(width, RES, SAMPLES,
                         CHUNK_PIXELS * SAMPLES * SAMPLES, device)
        k8 = k8_check(name, scene, sampler, ids)
        gen.manual_seed(500 + k)
        k10 = k10_check(name, scene, sampler,
                        middle_ids(width, RES, SAMPLES, TRAIN_RAYS, device),
                        gen, registers)
        out[name] = dict(k8=k8, k10=k10)
    return out


def _backward_ms(outs, wrt, cots, reps):
    return cuda_ms(lambda: torch.autograd.grad(outs, wrt, cots,
                                               retain_graph=True,
                                               allow_unused=True), reps)


def phase_grad_kernels(cases, device, camera_build) -> dict:
    """K5 and K6 against torch autograd of the plain versions for seeded
    cotangents: GRAD_RAYS rays per scene, then the training batch
    (TRAIN_RAYS) of the first case, which is also timed. At the training
    batch of the first two cases (hair, mirror) K5 is also held through
    its saved-bounce entry against its plain version and timed
    (``k5_check``); at the first case's, K6 against its order of sums
    (``camera_bwd_check``)."""
    from yocto_raytracing_tpu_torch.kernels import parity
    from yocto_raytracing_tpu_torch.render import camera, shade

    amb = torch.full((3,), 0.1, device=device)
    gen = torch.Generator(device=device)
    rec = {}
    for k, (name, scene, meta, w, h, bounce, last) in enumerate(cases):
        for n in ((GRAD_RAYS, TRAIN_RAYS) if k < 2 else (GRAD_RAYS,)):
            ids = middle_ids(w, h, SAMPLES, n, device, last)
            inputs = parity.shade_inputs(scene, ids, w, h, SAMPLES, bounce,
                                         amb)
            if n == TRAIN_RAYS:
                gen.manual_seed(400 + k)
                k5 = k5_check(f"shade_bwd {name}", scene, meta, inputs, amb,
                              gen)
                if k == 1:
                    rec["shade_bwd"].update(
                        {f"mirror_{x}": v for x, v in k5.items()})
                    continue
            gen.manual_seed(100 + k)
            rep = parity.compare_shade_grads(
                scene, inputs, amb, gen, meta.has_kd_textures,
                meta.has_ks_textures)
            worst = parity.check_grads(rep, GRAD_RTOL, f"K5 {name}")
            nonzero = sorted(x for x, r in rep.items() if r["norm"] > 0)
            log(f"K5 shade_bwd {name}: {n} rays, bounce {bounce}: largest "
                f"relative L2 error {worst:.3e} over ro, rd and "
                f"{len(rep) - 2} scene leaves (tolerance {GRAD_RTOL}); "
                f"plain zeros kept; non-zero: {', '.join(nonzero)}")
            gen.manual_seed(200 + k)
            crep = parity.compare_camera_grads(scene, ids, w, h, SAMPLES,
                                               gen)
            focus = crep.pop("cam_focus")
            cworst = parity.check_grads(crep, GRAD_RTOL, f"K6 {name}")
            if focus["max_abs"] > 1e-5 * crep["cam_axes"]["norm"]:
                raise AssertionError(f"K6 {name} cam_focus: {focus}")
            log(f"K6 camera_bwd {name}: {n} rays: largest relative L2 "
                f"error {cworst:.3e} (tolerance {GRAD_RTOL}); d_focus "
                f"{focus['norm']:.3e} kernel-plain {focus['max_abs']:.3e} "
                f"(zero up to rounding)")
            if n != TRAIN_RAYS:
                continue
            # time both backwards at the training batch
            ro, _, hits, active = inputs
            cots = [torch.randn(ro.shape, device=device, generator=gen)
                    * (active & hits["hit"])[:, None] for _ in range(4)]
            times = {}
            for which, fn, reps in (("autograd_ms", shade.shade_step_cuda,
                                     10),
                                    ("plain_ms", shade.shade_step_plain, 3)):
                outs, wrt = parity.shade_graph(fn, scene, inputs, amb,
                                               meta.has_kd_textures,
                                               meta.has_ks_textures)
                times[which] = _backward_ms(outs, list(wrt.values()), cots,
                                            reps)
                del outs
            leaves = list(shade.GRAD_LEAVES)
            rec["shade_bwd"] = dict(
                max_abs_err=max(r["max_abs"] for r in rep.values()),
                library_ms=None, **times, **k5,
                # ro, rd, inst, prim, mask, occlusion, 4 cotangents in;
                # d_ro, d_rd and the leaf gradients out
                **bound("shade_bwd", n * (24 + 8 + 1 + 48 + 24)
                        + nbytes(*(getattr(scene, k) for k in leaves))
                        + leaves_bytes(scene, SHADE_LEAVES)
                        + n * scene.light_ke.shape[0], n))
            log(f"K5 shade_bwd {name}: backward of one bounce at {n} rays: "
                f"kernel {k5['ms']:.3f} ms (through autograd "
                f"{times['autograd_ms']:.3f} ms), plain autograd "
                f"{times['plain_ms']:.3f} ms")
            cam_cots = [torch.randn((n, 3), device=device, generator=gen)
                        for _ in range(2)]
            times = {}
            for which, fn, reps in (("ms", camera.camera_rays_cuda, 20),
                                    ("plain_ms", camera.camera_rays_plain,
                                     5)):
                outs, leaves = parity.camera_graph(fn, scene, ids, w, h,
                                                   SAMPLES)
                times[which] = _backward_ms(outs, list(leaves.values()),
                                            cam_cots, reps)
            with torch.no_grad():
                uv = camera.camera_rays_cuda(scene, ids, w, h, SAMPLES)[0]
            fh, fw = camera.camera_frame(scene)
            args = (uv, *cam_cots, scene.cam_axes, scene.cam_o, fh, fw,
                    scene.cam_focus)
            sums = camera_bwd_check(
                f"K6 camera_bwd {name}", "camera_bwd",
                lambda: camera.camera_rays_bwd(*args),
                camera.camera_bwd_terms_plain(*args), camera_build)
            rec["camera_bwd"] = dict(
                max_abs_err=max(r["max_abs"] for r in crep.values()),
                library_ms=None, **times, sums=sums,
                # uv, g_ro, g_rd in, 15 sums out
                **bound("camera_bwd", n * 32 + 15 * 4, n))
            log(f"K6 camera_bwd {name}: backward at {n} rays: kernel "
                f"{times['ms']:.3f} ms, plain autograd "
                f"{times['plain_ms']:.3f} ms (the kernel's include the "
                f"fovy/aspect chain in torch)")
    return rec


def perturbed(scene, seed, pos_rows=()):
    """The scene with mat_kd and light_ke scaled by 1 + 0.2 N(0, 1), and
    the ``pos`` rows ``pos_rows`` moved by 0.05 N(0, 1) (seeded numpy): what
    the training target is rendered from."""
    import dataclasses

    rng = np.random.default_rng(seed)
    out = {}
    for name in ("mat_kd", "light_ke"):
        x = getattr(scene, name)
        f = 1 + 0.2 * rng.standard_normal(tuple(x.shape))
        out[name] = x * torch.from_numpy(f.astype(np.float32)).to(x.device)
    if len(pos_rows):
        pos = scene.pos.clone()
        d = 0.05 * rng.standard_normal((len(pos_rows), 3))
        pos[list(pos_rows)] += torch.from_numpy(d.astype(np.float32)).to(
            pos.device)
        out["pos"] = pos
    return dataclasses.replace(scene, **out)


def check_loss_gradient(what: str, rep: dict, loss: float) -> str:
    """Hold a ``parity.compare_loss_grads`` report: ``loss`` equal to the
    kernel and plain paths' losses (1e-5), every leaf's gradient within
    TRAIN_GRAD_RTOL of the f64 reference or TRAIN_PLAIN_FACTOR x the plain
    f32 path's own error, and each leaf the report leaves out as zero up to
    rounding (cam_focus without a lens, cam_aperture at aperture 0) within
    1e-5 |d cam_axes|, as a value that vanishes to first order. A report
    with a "device" entry (the training step's device loop) is held to the
    same bounds. Logs the per-leaf errors; returns a summary for the
    caller's log line."""
    from yocto_raytracing_tpu_torch.kernels import parity

    for key in ("loss", "plain_loss"):
        if not abs(rep[key] - loss) <= 1e-5 * abs(loss):
            raise AssertionError(f"{what}: loss {loss} vs {key} {rep[key]}")
    bounds = parity.loss_grad_bounds(rep, TRAIN_GRAD_RTOL,
                                     TRAIN_PLAIN_FACTOR)
    paths = [k for k in ("device", "kernel") if k in rep]
    worst = {k: parity.check_grads(rep[k], bounds, f"{what} {k} gradient")
             for k in paths}
    worst_leaf = {k: max(rep[k], key=lambda n: rep[k][n]["rel"])
                  for k in paths}
    rounding = {k: float(rep["grads"][k].abs())
                for k in ("cam_focus", "cam_aperture")
                if k not in rep["kernel"]}
    for k, v in rounding.items():
        if v > 1e-5 * rep["kernel"]["cam_axes"]["norm"]:
            raise AssertionError(f"{what}: d {k} {v}")
    wide = sorted(k for k, b in bounds.items() if b > TRAIN_GRAD_RTOL)
    log(f"{what}: per leaf, relative L2 error vs the f64 reference, "
        + " / ".join(paths) + " / plain path: " + ", ".join(
            f"{k} " + "/".join(f"{rep[p][k]['rel']:.2e}"
                               for p in (*paths, "plain"))
            for k in sorted(rep["kernel"]) if rep["kernel"][k]["norm"] > 0))
    return (f"loss {loss!r} (kernel path {rep['loss']!r}, plain path "
            f"{rep['plain_loss']!r}, f64 reference {rep['ref_loss']!r}); "
            f"gradient vs the f64 reference: largest relative L2 error "
            + ", ".join(f"{p} {worst[p]:.3e} ({worst_leaf[p]})"
                        for p in paths)
            + f" (tolerance {TRAIN_GRAD_RTOL} per "
            f"leaf, {TRAIN_PLAIN_FACTOR}x the plain f32 path's own error on "
            f"{', '.join(wide) or 'no leaf'}), the plain f32 path's largest "
            f"{max(r['rel'] for r in rep['plain'].values()):.3e}; zero up "
            f"to rounding (<= 1e-5 |d cam_axes|): " + (", ".join(
                f"d {k} {v:.3e}" for k, v in rounding.items()) or "none"))


def step_bounce_launches(events, record) -> dict:
    """The launches of the training step's bounces in a profiled step.
    ``events`` are the trace's device events (``profile_summary``),
    ``record`` the step's ``kernels.last_step()``. Each live bounce
    launches each function of STEP_BOUNCE_FUNCTIONS once, forward and
    reverse; a dead one none (its IF nodes skip it). Returns the live
    bounces, the dead ones and the launches by key; raises ValueError
    where the trace holds fewer (the tracer lost some), AssertionError
    where it holds more (the graph launched a dead bounce)."""
    ran = record["ran"].tolist()[:-1]
    live = sum(ran)
    got = {}
    for key, fn in STEP_BOUNCE_FUNCTIONS:
        got[key] = sum(name.startswith(f"yrt::{fn}(") for name, _ in events)
        if got[key] > live:
            raise AssertionError(f"{key}: {got[key]} launches for {live} "
                                 f"live bounces: a dead bounce launched")
        if got[key] < live:
            raise ValueError(f"{key}: {got[key]} launches, not {live}")
    return dict(live=live, dead=len(ran) - live, launches=got)


def phase_train(name, scene, w, h, last, device, dev_info, depth=DEPTH,
                steps_lr=TRAIN_LR) -> dict:
    """``train_step`` on TRAIN_RAYS rays at ``depth``: the training step's
    device loop (``renderer.loss_grads_device``: one CUDA graph kept across
    calls, dead bounces skipped forward and back by IF nodes) against the
    step through autograd (``mesh._train_step_autograd``: the eager loop
    under autograd). Step 1 with every float leaf trainable: its loss
    bit-equal to the autograd step's; the device loop's gradient (its own
    call, without the update) and the autograd step's within
    TRAIN_GRAD_RTOL of the f64 reference (``parity.compare_loss_grads``,
    the plain path's own error printed beside them); each step's update
    ``d - lr * g`` of its own path's gradient. The device loop's two ways
    in turns (STEP_TURNS: a miss, a hit), each loss bit-equal, with the
    hits' host ms and the reserved memory's growth, and the kept entry's
    size. Then 5 steps on TRAIN_SUBSET at ``steps_lr`` with a strictly
    falling loss, each loss bit-equal to the autograd step's on the same
    leaves (the leaves staged into the kept entry); a profiled hit (idle
    share, device ops, the bounces' launches: none in a dead bounce,
    ``step_bounce_launches``)."""
    from yocto_raytracing_tpu_torch import kernels
    from yocto_raytracing_tpu_torch import scene as scene_lib
    from yocto_raytracing_tpu_torch.kernels import parity
    from yocto_raytracing_tpu_torch.parallel import mesh
    from yocto_raytracing_tpu_torch.render import renderer
    from yocto_raytracing_tpu_torch.utils import tracer

    t_phase = time.perf_counter()
    label = f"train {name}" + ("" if depth == DEPTH else f" depth {depth}")
    amb = torch.full((3,), 0.1, device=device)
    ids = middle_ids(w, h, SAMPLES, TRAIN_RAYS, device, last)
    kw = dict(width=w, height=h, samples=SAMPLES, max_depth=depth)
    target = renderer.trace_rays(perturbed(scene, 7), ids, amb, w, h,
                                 SAMPLES, depth)

    def device_step(sc=scene, lr=TRAIN_LR, **extra):
        return mesh.train_step(sc, ids, target, amb, lr, **kw, **extra)

    def autograd_step(sc=scene, lr=TRAIN_LR, **extra):
        return mesh._train_step_autograd(sc, ids, target, amb, lr, **kw,
                                         **extra)

    renderer._steps.clear()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with tracer.recording():   # the dead bounces' tally
        new_k, loss_k = device_step()
    torch.cuda.synchronize()
    wall1 = time.perf_counter() - t0
    counts = dict(kernels.launches)
    made = kernels.made_launches()
    skipped = kernels.skipped_launches()
    ran = kernels.last_step()["ran"].tolist()
    for k in (*TRAIN_KERNELS, "bounce", "bounce_bwd", "records"):
        if made[k] <= 0:
            raise AssertionError(f"{label}: kernel {k} never launched")
    live = sum(ran[:-1])
    if made["bounce_bwd"] != live or made["shade_bwd"] != live:
        raise AssertionError(f"{label}: K14 {made['bounce_bwd']}, K5 "
                             f"{made['shade_bwd']} launches for {live} live "
                             f"bounces")

    _, out = renderer.loss_grads_device(scene, ids, target, amb, w, h,
                                        SAMPLES, depth)
    grads = {k: g for k, g in zip(scene_lib.LEAF_NAMES, out)
             if g is not None}
    new_f, loss_f = autograd_step()
    t0 = time.perf_counter()
    rep = parity.compare_loss_grads(scene, ids, target, amb,
                                    also=dict(device=grads), **kw)
    torch.cuda.synchronize()
    compare_s = time.perf_counter() - t0
    if not float(loss_k) == float(loss_f) == rep["loss"]:
        raise AssertionError(f"{label}: loss {float(loss_k)!r} vs the "
                             f"autograd step's {float(loss_f)!r}: not the "
                             f"same bits")
    summary = check_loss_gradient(label, rep, float(loss_k))
    parity.check_update(scene, new_k, grads, TRAIN_LR, label)
    parity.check_update(scene, new_f, rep["grads"], TRAIN_LR,
                        f"{label} autograd step")
    log(f"{label}: step 1, all float leaves trainable, {TRAIN_RAYS} "
        f"rays, depth {depth}: {summary}; loss bit-equal to the autograd "
        f"step's; update = d - lr * g on every float leaf, both ways; "
        f"device loop step (a miss) {wall1:.3f} s, the four gradients "
        f"{compare_s:.1f} s; bounces run {ran[:-1]}; launches made {made} "
        f"(counted {counts}; skipped in dead bounces {skipped})")
    if name in ("mirror", "mirror pair") and rep["device"]["mat_kr"][
            "norm"] == 0:
        raise AssertionError(f"{label}: no gradient through the bounce")
    if name == "mirror pair" and ran[:4] != [1, 1, 1, 1]:
        raise AssertionError(f"{label}: bounces 2 and 3 did not run: {ran}")

    def miss():
        renderer._steps.clear()
        return device_step()

    ways = dict(miss=miss, hit=device_step)
    turns = {k: dict(walls=[], host_ms=[], hits=[]) for k in ways}
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    for k in STEP_TURNS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, loss = ways[k]()
        torch.cuda.synchronize()
        turns[k]["walls"].append((time.perf_counter() - t0) * 1e3)
        if float(loss) != float(loss_f):
            raise AssertionError(f"{label} {k}: loss {float(loss)!r}, not "
                                 f"the autograd step's bits")
        rec = kernels.last_step()
        turns[k]["host_ms"].append(rec["host_ms"])
        turns[k]["hits"].append(rec["cache_hit"])
    grown = (torch.cuda.memory_reserved() - reserved) / 2 ** 20
    if (not all(turns["hit"]["hits"]) or any(turns["miss"]["hits"])
            or any(h["capture"] for h in turns["hit"]["host_ms"])):
        raise AssertionError(f"{label}: a repeated step missed the cache "
                             f"or captured")
    renderer._steps.clear()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    device_step()
    torch.cuda.synchronize()
    (state,) = renderer._steps.values()
    entry_mib = tensor_mib(state)
    pool_mib = (torch.cuda.memory_allocated() - before) / 2 ** 20
    for k, r in turns.items():
        stages = {st: [x[st] for x in r["host_ms"]] for st in r["host_ms"][0]}
        log(f"{label} {k}: wall ms in turns "
            + ", ".join(f"{x:.2f}" for x in r["walls"]) + "; host ms "
            + ", ".join(f"{st} " + "/".join(f"{v:.2f}" for v in vs)
                        for st, vs in stages.items())
            + f"; cache hits {r['hits']}; loss bit-equal to the autograd "
            f"step's; on {dev_info['smi']}")
    log(f"{label}: reserved device memory grew {grown:.1f} MiB over the "
        f"{len(STEP_TURNS)} calls in turns; the kept entry holds "
        f"{entry_mib:.1f} MiB of tensors, allocated {pool_mib:.1f} MiB "
        f"more than with no entry, the graph's pool included")

    device_step()   # the entry of the profiled configuration: a hit
    prof = profile_summary(
        device_step, f"warm {label} step (a hit), every float leaf "
        f"trainable", ("shade_bwd", "camera_bwd", "bounce_bwd", "records"),
        check=lambda ev: step_bounce_launches(ev, kernels.last_step()))
    if not kernels.last_step()["cache_hit"]:
        raise AssertionError(f"{label}: the profiled step missed the cache")
    launched = prof["checked"]
    log(f"{label} hit profile: {launched['live']} live bounces, "
        f"{launched['dead']} dead: launches in the trace "
        f"{launched['launches']}, none in a dead bounce")

    cur = scene
    losses, walls = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nxt, loss = device_step(cur, steps_lr, trainable=TRAIN_SUBSET)
        losses.append(float(loss))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        _, want = autograd_step(cur, steps_lr, trainable=TRAIN_SUBSET)
        if float(want) != losses[-1]:
            raise AssertionError(f"{label}: step {len(losses)} loss "
                                 f"{losses[-1]!r}, the autograd step's "
                                 f"{float(want)!r}")
        cur = nxt
    peak = torch.cuda.max_memory_allocated()
    log(f"{label}: 5 steps on {', '.join(TRAIN_SUBSET)}, lr "
        f"{steps_lr}: losses {[repr(x) for x in losses]}, each bit-equal "
        f"to the autograd step's on the same leaves; step wall "
        f"{', '.join(f'{x:.4f}' for x in walls)} s = "
        f"{', '.join(f'{TRAIN_RAYS / x / 1e6:.2f}' for x in walls)} Mrays/s "
        f"(the first a miss) on {dev_info['smi']}; peak memory "
        f"{peak / 2**30:.2f} GiB")
    if not all(np.isfinite(losses)) or not all(
            b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"{label}: loss not strictly falling "
                             f"{losses}")
    log(f"{label}: phase {time.perf_counter() - t_phase:.1f} s")
    return dict(counts=counts, made=made, skipped=skipped, walls=walls,
                peak=peak, prof=prof, turns=turns, grown_mib=grown,
                entry_mib=entry_mib)


def light_vertex_rows(host, meta) -> list:
    """Per light (emissive instance, in the scene's light order), the rows
    of ``pos`` that hold its shape's vertices."""
    rows = []
    for ist in host.instances:
        mat = host.materials[ist.material] if ist.material >= 0 else None
        if mat is not None and (mat.ke > 0).all():
            lo = meta.shape_vert_offset[ist.shape]
            rows.append(list(range(lo, lo + len(host.shapes[ist.shape].pos))))
    return rows


def phase_reverse_kernels(host, device, camera_build) -> dict:
    """The reverses of the stochastic modes against torch autograd of
    their plain versions on the area hair scene, relative L2 error <=
    GRAD_RTOL per leaf: K5 with per-ray light positions (GRAD_RAYS rays,
    camera bounce), K9 at the scene's aperture (0.1) and at aperture 0,
    where its 15 shared sums must equal K6's on the same uv bit for bit,
    and K10 on the quad and polyline lights; each then timed at
    TRAIN_RAYS, kernel backward against plain autograd (CUDA events), and
    K9 against its order of sums (``camera_bwd_check``)."""
    import dataclasses
    import functools

    from yocto_raytracing_tpu_torch import scene as scene_lib
    from yocto_raytracing_tpu_torch.kernels import parity
    from yocto_raytracing_tpu_torch.render import (camera, lights, renderer,
                                                   shade)

    leaves, meta = scene_lib.build_device_scene(host)
    scene = scene_lib.to_torch(leaves, device)
    sampler = lights.build_light_sampler(host, leaves, meta, device)
    nl = int(sampler["cdf"].shape[0])
    width = renderer.image_width(host.cameras[0].aspect, RES)
    amb = torch.full((3,), 0.1, device=device)
    gen = torch.Generator(device=device)
    rec = {}

    for n in (GRAD_RAYS, TRAIN_RAYS):
        ids = middle_ids(width, RES, SAMPLES, n, device)
        inputs = parity.shade_inputs(scene, ids, width, RES, SAMPLES, 1, amb)
        with torch.no_grad():
            lpos = lights.sample_light_points_cuda(scene, sampler, ids, SEED)
        if n == GRAD_RAYS:
            gen.manual_seed(300)
            rep = parity.compare_shade_grads(
                scene, inputs, amb, gen, meta.has_kd_textures,
                meta.has_ks_textures, light_pos=lpos)
            worst = parity.check_grads(rep, GRAD_RTOL, "K5 per-ray lights")
            log(f"K5 shade_bwd with per-ray lights, area hair: {n} rays: "
                f"largest relative L2 error {worst:.3e} over ro, rd, the "
                f"(L, N, 3) light positions "
                f"({rep['light_pos_ray']['rel']:.3e}) and {len(rep) - 3} "
                f"scene leaves (tolerance {GRAD_RTOL}); "
                f"plain zeros kept (unlit lanes' light positions included)")
            k5_err = max(r["max_abs"] for r in rep.values())
            continue
        gen.manual_seed(402)
        k5 = k5_check("shade_bwd with per-ray lights, area hair", scene,
                      meta, inputs, amb, gen, lpos)
        ro, _, hits, active = inputs
        cots = [torch.randn(ro.shape, device=device, generator=gen)
                * (active & hits["hit"])[:, None] for _ in range(4)]
        times = {}
        for which, fn, reps in (("autograd_ms", shade.shade_step_cuda, 10),
                                ("plain_ms", shade.shade_step_plain, 1)):
            outs, wrt = parity.shade_graph(fn, scene, inputs, amb,
                                           meta.has_kd_textures,
                                           meta.has_ks_textures, lpos)
            times[which] = _backward_ms(outs, list(wrt.values()), cots, reps)
            del outs
        rec["shade_bwd_lights"] = dict(
            max_abs_err=k5_err, library_ms=None, **times, **k5,
            # as K5, plus the per-ray light positions in and their
            # gradient out
            **bound("shade_bwd_lights", n * (24 + 8 + 1 + 48 + 24)
                    + 2 * nbytes(lpos)
                    + nbytes(*(getattr(scene, k) for k in shade.GRAD_LEAVES))
                    + leaves_bytes(scene, SHADE_LEAVES) + n * nl, n))
        log(f"K5 shade_bwd with per-ray lights: backward of one bounce at "
            f"{n} rays: kernel {k5['ms']:.3f} ms (through autograd "
            f"{times['autograd_ms']:.3f} ms), plain autograd "
            f"{times['plain_ms']:.3f} ms")

    n = TRAIN_RAYS
    ids = middle_ids(width, RES, SAMPLES, n, device)
    gen.manual_seed(301)
    rep = parity.compare_camera_stochastic_grads(scene, ids, width, RES,
                                                 SAMPLES, SEED, gen)
    worst = parity.check_grads(rep, GRAD_RTOL, "K9")
    flat = dataclasses.replace(scene, cam_aperture=torch.zeros_like(
        scene.cam_aperture))
    g_ro, g_rd = (torch.randn((n, 3), device=device, generator=gen)
                  for _ in range(2))
    with torch.no_grad():
        uv = camera.camera_rays_stochastic_cuda(flat, ids, width, RES,
                                                SAMPLES, SEED)[0]
        h, w = camera.camera_frame(flat)
        k6 = camera.camera_rays_bwd(uv, g_ro, g_rd, flat.cam_axes, flat.cam_o,
                                    h, w, flat.cam_focus)
        k9 = camera.camera_rays_stochastic_bwd(
            ids, flat.cam_axes, flat.cam_o, h, w, flat.cam_focus,
            flat.cam_aperture, width, RES, SAMPLES, SEED, g_ro, g_rd)
    same = bool(torch.equal(k9[:15], k6))
    log(f"K9 camera_bwd_stochastic, area hair: {n} rays, aperture "
        f"{float(scene.cam_aperture)}: largest relative L2 error {worst:.3e} "
        f"over {', '.join(rep)} (tolerance {GRAD_RTOL}; d_aperture "
        f"{rep['cam_aperture']['norm']:.3e}, d_focus "
        f"{rep['cam_focus']['norm']:.3e}); aperture 0: K9's 15 shared sums "
        f"equal K6's on the same uv: {same} (max |diff| "
        f"{float((k9[:15] - k6).abs().max()):.3e})")
    if not same:
        raise AssertionError(f"K9 at aperture 0 vs K6: {k9[:15] - k6}")
    cam_cots = [torch.randn((n, 3), device=device, generator=gen)
                for _ in range(2)]
    times = {}
    for which, fn, reps in (
            ("ms", camera.camera_rays_stochastic_cuda, 20),
            ("plain_ms", camera.camera_rays_stochastic_plain, 5)):
        outs, cleaves = parity.camera_graph(
            functools.partial(fn, seed=SEED), scene, ids, width, RES,
            SAMPLES, parity.STOCHASTIC_CAMERA_LEAVES)
        times[which] = _backward_ms(outs, list(cleaves.values()), cam_cots,
                                    reps)
    h, w = camera.camera_frame(scene)
    args = (ids, scene.cam_axes, scene.cam_o, h, w, scene.cam_focus,
            scene.cam_aperture, width, RES, SAMPLES, SEED, *cam_cots)
    sums = camera_bwd_check(
        "K9 camera_bwd_stochastic area hair", "camera_bwd_stochastic",
        lambda: camera.camera_rays_stochastic_bwd(*args),
        camera.camera_stochastic_bwd_terms_plain(*args), camera_build)
    rec["camera_bwd_stochastic"] = dict(
        max_abs_err=max(r["max_abs"] for r in rep.values()),
        library_ms=None, **times, sums=sums,
        # ids, g_ro, g_rd in, 16 sums out
        **bound("camera_bwd_stochastic", n * 28 + 16 * 4, n))
    log(f"K9 camera_bwd_stochastic: backward at {n} rays: kernel "
        f"{times['ms']:.3f} ms, plain autograd {times['plain_ms']:.3f} ms "
        f"(the kernel's include the fovy/aspect chain in torch)")

    gen.manual_seed(302)
    rep = parity.compare_light_points_grads(scene, sampler, ids, SEED, gen)
    worst = parity.check_grads(rep, GRAD_RTOL, "K10")
    log(f"K10 light_points_bwd, area hair: {nl} lights x {n} rays, elements "
        f"{sampler['n'].tolist()}: relative L2 error pos "
        f"{rep['pos']['rel']:.3e}, light_pos {rep['light_pos']['rel']:.3e} "
        f"(tolerance {GRAD_RTOL})")
    lcots = [torch.randn((nl, n, 3), device=device, generator=gen)]
    times = {}
    for which, fn, reps in (("ms", lights.sample_light_points_cuda, 20),
                            ("plain_ms", lights.sample_light_points_plain,
                             5)):
        outs, lleaves = parity.light_points_graph(fn, scene, sampler, ids,
                                                  SEED)
        times[which] = _backward_ms(outs, list(lleaves.values()), lcots,
                                    reps)
    rec["light_points_bwd"] = dict(
        max_abs_err=max(r["max_abs"] for r in rep.values()),
        library_ms=None, **times,
        **light_points_bwd_bound(sampler, n, scene.pos.shape[0]))
    log(f"K10 light_points_bwd: backward at {nl} x {n}: kernel "
        f"{times['ms']:.4f} ms, plain autograd {times['plain_ms']:.4f} ms")
    return rec


STOCHASTIC_TRAIN_KERNELS = ("hit", "camera_rays_stochastic",
                            "camera_bwd_stochastic", "light_points",
                            "light_points_bwd", "shade", "shade_bwd_lights")


def phase_train_stochastic(name, host, last, device, dev_info) -> dict:
    """The stochastic modes' gradient on TRAIN_RAYS rays: the MSE loss of
    ``trace_rays(..., differentiable=True, stochastic=True, seed=SEED,
    light_sampler=...)`` towards a target rendered with perturbed mat_kd,
    light_ke and light-shape pos, every float leaf trainable. The kernel
    path's gradient within TRAIN_GRAD_RTOL of the f64 reference (or
    TRAIN_PLAIN_FACTOR x the plain f32 path's error), cam_aperture and each
    light's vertices moved; warm fwd+bwd walls and one profiled call, which
    must hold K5, K9 and K10; then K10 on the cotangent that the step
    hands K10 (``k10_check``)."""
    from yocto_raytracing_tpu_torch import kernels
    from yocto_raytracing_tpu_torch import scene as scene_lib
    from yocto_raytracing_tpu_torch.kernels import parity
    from yocto_raytracing_tpu_torch.render import lights, renderer

    leaves, meta = scene_lib.build_device_scene(host)
    scene = scene_lib.to_torch(leaves, device)
    sampler = lights.build_light_sampler(host, leaves, meta, device)
    w = renderer.image_width(host.cameras[0].aspect, RES)
    ids = middle_ids(w, RES, SAMPLES, TRAIN_RAYS, device, last)
    rows = light_vertex_rows(host, meta)
    step, target, amb, kw = stochastic_loss_step(host, meta, scene, sampler,
                                                 ids)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    loss, grads = step()
    torch.cuda.synchronize()
    wall1 = time.perf_counter() - t0
    counts = dict(kernels.launches)
    for k in STOCHASTIC_TRAIN_KERNELS:
        if counts[k] <= 0:
            raise AssertionError(f"stochastic train {name}: kernel {k} "
                                 f"never launched")
    for k in ("camera_rays", "camera_bwd", "shade_bwd"):
        if counts[k]:
            raise AssertionError(f"stochastic train {name}: the fixed-light "
                                 f"or pinhole kernel {k} ran")

    t0 = time.perf_counter()
    rep = parity.compare_loss_grads(scene, ids, target, amb, **kw)
    torch.cuda.synchronize()
    compare_s = time.perf_counter() - t0
    summary = check_loss_gradient(f"stochastic train {name}", rep,
                                  float(loss))
    aperture_g = float(grads["cam_aperture"])
    light_g = [float(grads["pos"][r].abs().sum()) for r in rows]
    if aperture_g == 0 or not all(light_g):
        raise AssertionError(f"stochastic train {name}: d cam_aperture "
                             f"{aperture_g}, light vertices {light_g}")
    log(f"stochastic train {name}: {TRAIN_RAYS} rays, every float leaf "
        f"trainable, aperture {float(scene.cam_aperture)}: {summary}; d "
        f"cam_aperture {aperture_g:.4e}, |d pos| over each light's vertices "
        f"{', '.join(f'{x:.4e}' for x in light_g)}; first fwd+bwd "
        f"{wall1:.3f} s, the three gradients {compare_s:.1f} s; launches "
        f"{counts}")

    walls = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    log(f"stochastic train {name}: fwd+bwd wall (warm, 5 reps) "
        f"{', '.join(f'{x:.4f}' for x in walls)} s = "
        f"{', '.join(f'{TRAIN_RAYS / x / 1e6:.2f}' for x in walls)} Mrays/s "
        f"on {dev_info['smi']}; peak memory {peak / 2**30:.2f} GiB")
    prof = profile_summary(step, f"warm stochastic fwd+bwd {name}",
                           ("shade_bwd_lights", "camera_bwd_stochastic",
                            "light_points_bwd"))
    for k in ("shade_bwd_lights", "camera_bwd_stochastic",
              "light_points_bwd"):
        device_ms(prof, k, counts[k])   # raises if K5, K9 or K10 is missing

    # K10 on the cotangent this step gives K10
    k10 = k10_check(f"{name}, the step's cotangent", scene, sampler, ids,
                    torch.Generator(device=device).manual_seed(600), True,
                    g=step_light_cotangent(step))
    return dict(counts=counts, walls=walls, peak=peak, prof=prof, k10=k10)


def stochastic_loss_step(host, meta, scene, sampler, ids):
    """(step, target, amb, kw) of the stochastic modes' training loss on
    the rays ``ids``: ``step()`` gives ``parity.loss_grads`` of the MSE of
    ``trace_rays(..., stochastic=True, seed=SEED, light_sampler=sampler)``
    towards ``target``, the frame rendered with perturbed mat_kd, light_ke
    and light-shape pos; ``kw`` its ``loss_grads`` keywords."""
    from yocto_raytracing_tpu_torch.kernels import parity
    from yocto_raytracing_tpu_torch.render import renderer

    w = renderer.image_width(host.cameras[0].aspect, RES)
    amb = torch.full((3,), 0.1, device=ids.device)
    rows = [r for lr in light_vertex_rows(host, meta) for r in lr]
    kw = dict(width=w, height=RES, samples=SAMPLES, max_depth=DEPTH,
              stochastic=True, seed=SEED, light_sampler=sampler)
    target = renderer.trace_rays(
        perturbed(scene, 7, rows), ids, amb, w, RES, SAMPLES, DEPTH,
        meta.has_kd_textures, meta.has_ks_textures, stochastic=True,
        seed=SEED, light_sampler=sampler)

    def step():
        return parity.loss_grads(scene, ids, target, amb, **kw)

    return step, target, amb, kw


def step_light_cotangent(step) -> torch.Tensor:
    """The (L, N, 3) cotangent that one call of ``step`` (a training step
    whose forward samples light points on the card) hands K10, recorded by
    wrapping ``lights.light_points_bwd`` for the call."""
    from yocto_raytracing_tpu_torch.render import lights

    cots = []
    bwd = lights.light_points_bwd

    def recording(*args):
        cots.append(args[4].clone())
        return bwd(*args)

    lights.light_points_bwd = recording
    try:
        step()
    finally:
        lights.light_points_bwd = bwd
    return cots[0]


def moved_leaves(leaves: dict, seed: int) -> dict:
    """The scene's pos moved (N(0, 0.02) per coordinate) and radius scaled
    (U(0.5, 2)) after the build, without a rebuild."""
    rng = np.random.default_rng(seed)
    out = dict(leaves)
    out["pos"] = (leaves["pos"] + rng.normal(
        scale=0.02, size=leaves["pos"].shape)).astype(np.float32)
    out["radius"] = (leaves["radius"] * rng.uniform(
        0.5, 2.0, leaves["radius"].shape)).astype(np.float32)
    return out


def phase_overlap(device, dev_info):
    """``overlap_scene`` on OVERLAP_QUERIES points against the hair scene
    (capsule radii, triangles, points), a random scene (points, lines,
    triangles in 8 instances), the hair scene with pos and radius moved
    after the build (uniform random points in a box), and the hair scene
    again on points along its strands in strand order (``strand_queries``,
    coherent traffic: jittered by N(0, 0.1), and exactly on the strands):
    the refit and K11 on all of them, bit-equal to the brute-force plain
    query on every query and to the plain walk on the first
    OVERLAP_COMPARE, whose walk work the plain walk counts (``stats``). On
    all but the moved scene, ``overlap_times``. The hair run is the path:
    its launch counts, a
    profiled call (wall, idle share), and kernel, refit and plain timed on
    all queries. Returns (record, path)."""
    from yocto_raytracing_tpu_torch import kernels, scene as scene_lib
    from yocto_raytracing_tpu_torch import testscenes
    from yocto_raytracing_tpu_torch.kernels import parity
    from yocto_raytracing_tpu_torch.ops import overlap

    hair_box = ((-1.5, -0.2, -1.5), (1.5, 2.2, 1.5))
    cases = [("hair 256", testscenes.make_hair_scene(256), hair_box, 0.2,
              False),
             ("random seed 0", testscenes.make_random_scene(seed=0),
              ((-4.0,) * 3, (4.0,) * 3), 0.75, False),
             ("hair 256, pos moved", testscenes.make_hair_scene(256),
              hair_box, 0.2, True),
             ("hair 256, strand points", testscenes.make_hair_scene(256),
              0.1, 0.2, False),
             ("hair 256, points on the strands",
              testscenes.make_hair_scene(256), 0.0, 0.2, False)]
    rec = {}
    path = None
    for k, (name, host, box, dist_max, moved) in enumerate(cases):
        leaves, meta = scene_lib.build_device_scene(host)
        if moved:
            leaves = moved_leaves(leaves, 13)
        scene = scene_lib.to_torch(leaves, device)
        rng = np.random.default_rng(11 + k)
        if not isinstance(box, tuple):   # points along strands, jittered
            q = strand_queries(scene, meta, OVERLAP_QUERIES, rng, box)
        else:
            q = torch.from_numpy(rng.uniform(
                *box, (OVERLAP_QUERIES, 3)).astype(np.float32)).to(device)
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = overlap.overlap_scene(scene, meta, q, dist_max)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(kernels.launches)
        if any(counts[key] != 1 for key in OVERLAP_KERNELS):
            raise AssertionError(f"overlap {name}: launches "
                                 + str({key: counts[key]
                                        for key in OVERLAP_KERNELS}))
        share = float(out["found"].float().mean())
        plain, plain_ms = timed(lambda: overlap.overlap_scene_plain(
            scene, meta, q, dist_max))
        gaps = parity.overlap_gaps(out, plain)
        sub = slice(0, OVERLAP_COMPARE)
        kern = {key: v[sub] for key, v in out.items()}
        stats = {}
        walk = overlap.overlap_scene_walk_plain(scene, meta, q[sub],
                                                dist_max, stats=stats)
        flags = (overlap.refit_cuda(scene).nodes.view(torch.int32)[:, 7]
                 >> 1) & 1
        thin = (int(flags.sum()), int((scene.node_kind == 1).sum()))
        log(f"K11 overlap {name}: {OVERLAP_QUERIES} queries, {meta.num_prims} "
            f"prims in {meta.num_instances} instances, dist_max {dist_max}: "
            f"found share {share:.4f}; against the brute-force plain query "
            f"on every query: found/inst/prim equal {gaps['equal']}, ULP "
            f"gap dist {gaps['dist']}, euv {gaps['euv']} over "
            f"{gaps['found']} found (tolerance: bit-equal); on the first "
            f"{OVERLAP_COMPARE} the plain walk bit-equal "
            f"{parity.overlap_identical(kern, walk)}; walk work per query "
            + ", ".join(f"{key} {v / OVERLAP_COMPARE:.2f}"
                        for key, v in stats.items())
            + f"; thin: {thin[0]} of {thin[1]} shape nodes never skipped; "
            f"call {wall:.4f} s")
        if (not gaps["equal"] or gaps["dist"] or gaps["euv"]
                or not parity.overlap_identical(out, plain)
                or not parity.overlap_identical(kern, walk)):
            raise AssertionError(f"K11 {name}: {gaps}")
        # points along strands lie mostly within reach
        if not 0.05 <= share <= (0.95 if isinstance(box, tuple) else 1.0):
            raise AssertionError(f"overlap {name}: found share {share}")
        if moved:
            continue
        r = rec[name] = overlap_times(scene, meta, q, dist_max, name)
        walk_ops = OVERLAP_OPS_PER_INSTANCE * meta.num_instances + sum(
            WALK_OPS[key] * v for key, v in stats.items()) / OVERLAP_COMPARE
        r["walk"] = {key: v / OVERLAP_COMPARE for key, v in stats.items()}
        r["walk_ops_per_query"] = walk_ops
        if path is not None:
            continue
        prof = profile_summary(lambda: overlap.overlap_scene(
            scene, meta, q, dist_max), f"overlap {name}", OVERLAP_KERNELS)
        path = dict(counts=counts, prof=prof)
        walls = []
        for _ in range(5):   # warm, host clock to the synchronize
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            overlap.overlap_scene(scene, meta, q, dist_max)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        brute_ops = brute_force_ops(scene, meta) * OVERLAP_QUERIES
        io_bytes = OVERLAP_QUERIES * (16 + 29)   # queries, dist_max; outputs
        recs = overlap.refit_cuda(scene)
        want = overlap.refit_plain(scene)
        if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(recs[:2], want[:2])):
            raise AssertionError("overlap refit: the kernel's records differ "
                                 "from the plain refit's")
        refit_in = leaves_bytes(scene, [n for n, _, _ in
                                        overlap.REFIT_LEAVES])
        rec["overlap_refit"] = dict(
            max_abs_err=0.0,
            ms=cuda_ms(lambda: overlap.refit_cuda(scene), 20),
            plain_ms=cuda_ms(lambda: overlap.refit_plain(scene), 2),
            library_ms=None,
            # the leaves it reads once, the node and prim records written
            **bound("overlap_refit", refit_in + nbytes(*recs[:2]), 0, ops=0))
        rec["overlap"] = dict(
            max_abs_err=gaps["max_abs_err"],
            ms=cuda_ms(lambda: overlap.overlap_scene(scene, meta, q,
                                                     dist_max), 5),
            # the one call on every query above (2.4 s a call)
            plain_ms=plain_ms,
            library_ms=None, wall_ms=sorted(walls)[2], idle=prof["idle"],
            **{key: v for key, v in r.items()},
            # the walk's counted work; the brute force's (JAX's work) beside
            brute_force_bound_ms=bound(
                "overlap", 0, OVERLAP_QUERIES, ops=brute_ops)["bound_ms"],
            # queries and dist_max in, found/dist/inst/prim/euv out, the
            # instance frames and the records once
            **bound("overlap", io_bytes + nbytes(
                scene.inst_axes, scene.inst_o, scene.inst_shape_root,
                *recs[:2]), OVERLAP_QUERIES,
                ops=int(walk_ops * OVERLAP_QUERIES)))
        o = rec["overlap"]
        log(f"K11 overlap {name}: timed call {o['ms']:.3f} ms (refit "
            f"{rec['overlap_refit']['ms']:.4f} ms), plain (brute force) "
            f"{o['plain_ms']:.3f} ms for {OVERLAP_QUERIES} queries; "
            f"{walk_ops:.0f} operations per query for the walk (counted on "
            f"the first {OVERLAP_COMPARE} queries, scaled up), "
            f"{brute_ops / OVERLAP_QUERIES:.0f} for the brute force; bounds "
            f"{o['bound_ms'] * 1e3:.1f} us ({o['bound_by']}), brute force "
            f"{o['brute_force_bound_ms'] * 1e3:.1f} us; the call's warm "
            f"wall (host clock, median of 5) {o['wall_ms']:.3f} ms, "
            f"profiled {prof['wall_ms']:.3f} ms with idle share "
            f"{prof['idle']:.3f}; on {dev_info['smi']}")
    return rec, path


def brute_force_ops(scene, meta) -> int:
    """Operations per query of the brute force (JAX's work, K11's first
    form): every prim of every instance, OVERLAP_OPS_PER_PAIR by type."""
    from yocto_raytracing_tpu_torch.ops import overlap

    lo, hi = overlap.instance_prim_ranges(scene, meta)
    ptype = scene.prim_type.cpu().numpy()
    ops = 0
    for a, b in zip(lo.tolist(), hi.tolist()):
        kinds = np.bincount(ptype[a:b], minlength=3)
        ops += OVERLAP_OPS_PER_INSTANCE + sum(
            int(c) * OVERLAP_OPS_PER_PAIR[t] for t, c in enumerate(kinds))
    return ops


def strand_queries(scene, meta, n: int, rng, jitter: float) -> torch.Tensor:
    """n world-space points along the scene's lines (the hair strands), in
    line order: each line's points at even steps from its first vertex to
    its second, moved by N(0, jitter) per coordinate. Coherent traffic, as
    a tool that projects points sampled along (or near) strands sends
    it."""
    from yocto_raytracing_tpu_torch.ops import intersect as isect, overlap
    from yocto_raytracing_tpu_torch.scene import PRIM_LINE

    lo, hi = overlap.instance_prim_ranges(scene, meta)
    per_inst = []
    for ii, (a, b) in enumerate(zip(lo.tolist(), hi.tolist())):
        lines = a + torch.nonzero(scene.prim_type[a:b] == PRIM_LINE).squeeze(1)
        if lines.numel():
            per_inst.append((ii, scene.prim_v[lines].long()))
    per = -(-n // sum(pv.shape[0] for _, pv in per_inst))
    t = ((torch.arange(per, device=scene.pos.device) + 0.5) / per)[
        None, :, None]
    pts = []
    for ii, pv in per_inst:
        v0, v1 = scene.pos[pv[:, 0]][:, None], scene.pos[pv[:, 1]][:, None]
        local = (v0 * (1.0 - t) + v1 * t).reshape(-1, 3)
        pts.append(isect.transform_point(scene.inst_axes[ii],
                                         scene.inst_o[ii], local))
    noise = torch.from_numpy(rng.normal(scale=jitter, size=(n, 3)).astype(
        np.float32)).to(scene.pos.device)
    return (torch.cat(pts)[:n] + noise).contiguous()


def overlap_times(scene, meta, q, dist_max, name) -> dict:
    """K11 (the whole call: refit and walk), device us per launch of the
    walk from a profile of two calls, and the call's timed ms."""
    from yocto_raytracing_tpu_torch.ops import overlap

    def call():
        overlap.overlap_scene_cuda(scene, meta, q, dist_max)

    prof = profile_summary(lambda: [call() for _ in range(2)],
                           f"K11 {name}", ("overlap",))
    out = dict(overlap_device_us=device_us(prof["by_name"], "overlap") / 2,
               call_ms=cuda_ms(call, 5))
    log(f"K11 {name}, device us per launch {out['overlap_device_us']:.1f}; "
        f"timed call {out['call_ms']:.4f} ms")
    return out


GLTF_COMPARE_PIXELS = 1 << 15   # a band through the middle of the frame
GLTF_TIMES = (0.0, 0.5, 1.0)
GLTF_SHIFT = (0.4, 0.1, 0.0)     # the sphere's translation at t = 1
SKIN_JOINTS = 4


def add_translation_channel(path, node, shift) -> None:
    """Add one LINEAR translation channel, (0, 0, 0) at t = 0 to ``shift``
    at t = 1, on ``node`` of the .gltf at ``path``: its keys in base64
    ``data:`` buffers, as tests/test_gltf_animation.py writes one."""
    import base64

    with open(path) as f:
        g = json.load(f)
    for arr, kind in ((np.asarray([0.0, 1.0], np.float32), "SCALAR"),
                      (np.asarray([[0, 0, 0], shift], np.float32), "VEC3")):
        g["buffers"].append({"uri": "data:application/octet-stream;base64,"
                             + base64.b64encode(arr.tobytes()).decode(),
                             "byteLength": arr.nbytes})
        g["bufferViews"].append({"buffer": len(g["buffers"]) - 1,
                                 "byteOffset": 0, "byteLength": arr.nbytes})
        g["accessors"].append({"bufferView": len(g["bufferViews"]) - 1,
                               "componentType": 5126, "count": len(arr),
                               "type": kind})
    n = len(g["accessors"])
    g["animations"] = [{"name": "move", "samplers": [
        {"input": n - 2, "output": n - 1, "interpolation": "LINEAR"}],
        "channels": [{"sampler": 0,
                      "target": {"node": node, "path": "translation"}}]}]
    with open(path, "w") as f:
        json.dump(g, f)


def phase_gltf(tmp, device, dev_info) -> dict:
    """glTF scenes through the main path on the card, at the main frame's
    size (RES rows, SAMPLES x SAMPLES, DEPTH):

    (a) ``make_textured_hair_scene(256)`` saved as .glb and as .gltf
        (checker PNGs beside them) and rendered with
        ``render_scene_file(..., device="cuda")``: the f32 frames bit-equal
        to the same host scene rendered from memory (``build_device_scene``
        + ``render_image``); the .glb's u8 frame within 1 step of the
        all-plain path on a band through the middle, the .gltf's equal to
        it; the .glb frame's launch counts (set to 0 just before it) hold
        K1-K4, K12 and K13;
    (b) the .gltf of ``make_hair_scene(256)`` with a LINEAR translation
        channel on the sphere's node, loaded with ``return_graph=True``; at
        t = 0, 0.5 and 1: ``update_animated_transforms``,
        ``apply_graph_transforms``, the device scene rebuilt and a u8 frame
        on the card, each within 1 u8 step of the all-plain path, whether
        it hit the device loop's cache (the same shapes as the frame
        before: no capture) and its host ms (``kernels.last_frame()``);
        t = 0's f32 frame, rendered before its u8 one, bit-equal to the
        file's without the channel, t = 1 different from t = 0;
    (c) ``io.gltf.skin_vertices`` on the sphere's 325 vertices, 4 seeded
        joints and weights: the card's result bit-equal to the CPU's.
    """
    from yocto_raytracing_tpu_torch import kernels, scene as scene_lib
    from yocto_raytracing_tpu_torch import testscenes
    from yocto_raytracing_tpu_torch.io import gltf
    from yocto_raytracing_tpu_torch.render import renderer
    from yocto_raytracing_tpu_torch.utils import tracer

    t_phase = time.perf_counter()
    kw = dict(max_depth=DEPTH, chunk_pixels=CHUNK_PIXELS)

    def timed_call(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def check_plain(what, img, scene, meta):
        mid = (RES // 2) * img.shape[1] - GLTF_COMPARE_PIXELS // 2
        check_plain_pixels(what, img, scene, meta, SAMPLES, DEPTH, mid,
                           mid + GLTF_COMPARE_PIXELS)

    # (a) the textured hair scene from .glb and .gltf
    host = testscenes.make_textured_hair_scene(256)
    scene, meta = scene_on(host, device)
    width = renderer.image_width(host.cameras[0].aspect, RES)
    memory = renderer.render_image(scene, meta, width, RES, SAMPLES, **kw)
    u8 = {}
    for ext in (".glb", ".gltf"):
        path = os.path.join(tmp, f"gltf_{ext[1:]}", f"textured_hair{ext}")
        scene_lib.save_scene(host, path)
        kernels.reset_launches()
        with tracer.recording():   # the dead bounces' tally
            (u8[ext], _, fscene, fmeta), wall = timed_call(
                lambda: renderer.render_scene_file(path, RES, SAMPLES,
                                                   device=device, ldr=True,
                                                   **kw))
        if ext == ".glb":
            counts = kernels.made_launches()
            check_plain("gltf .glb frame", u8[ext], fscene, fmeta)
        (f32, *_), wall_f32 = timed_call(
            lambda: renderer.render_scene_file(path, RES, SAMPLES,
                                               device=device, **kw))
        same = np.array_equal(f32.view(np.int32), memory.view(np.int32))
        log(f"gltf {ext} frame: textured hair 256, {width}x{RES} x "
            f"{SAMPLES ** 2} spp, depth {DEPTH}: render_scene_file wall "
            f"{wall:.3f} s (u8), {wall_f32:.3f} s (f32); f32 bit-equal to "
            f"the in-memory scene's frame: {same}; on {dev_info['smi']}")
        if not same:
            raise AssertionError(f"gltf {ext} frame: f32 differs from the "
                                 f"in-memory scene's")
    missing = [k for k in FRAME_KERNELS if counts[k] <= 0]
    log(f"gltf .glb frame launches {counts}")
    if missing:
        raise AssertionError(f"gltf .glb frame: kernels {missing} never "
                             f"launched")
    if not np.array_equal(u8[".gltf"], u8[".glb"]):
        raise AssertionError("gltf: the .gltf u8 frame differs from .glb's")

    # (b) the animated hair scene
    path = os.path.join(tmp, "gltf_anim", "hair.gltf")
    scene_lib.save_scene(testscenes.make_hair_scene(256), path)
    still, *_ = renderer.render_scene_file(path, RES, SAMPLES, device=device,
                                           **kw)
    ahost, graph = gltf.load_gltf(path, return_graph=True)
    sphere = [i for i, ist in enumerate(ahost.instances)
              if ist.name == "interior"]
    add_translation_channel(path, graph.instance_nodes[sphere[0]], GLTF_SHIFT)
    ahost, graph = gltf.load_gltf(path, return_graph=True)
    if (len(sphere) != 1 or len(graph.channels) != 1
            or gltf.animation_bounds(graph) != (0.0, 1.0)):
        raise AssertionError("gltf animation: the channel did not load")
    frames = {}
    for t in GLTF_TIMES:
        t0 = time.perf_counter()
        gltf.update_animated_transforms(graph, t)
        gltf.apply_graph_transforms(graph, ahost)
        ascene, ameta = scene_on(ahost, device)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        if t == 0.0:   # first, so that the u8 frames follow one another
            f32 = renderer.render_image(ascene, ameta, width, RES, SAMPLES,
                                        **kw)
            if not np.array_equal(f32.view(np.int32), still.view(np.int32)):
                raise AssertionError("gltf animation t=0: differs from the "
                                     "frame without the channel")
        frames[t], wall = timed_call(lambda: renderer.render_image(
            ascene, ameta, width, RES, SAMPLES, ldr=True, **kw))
        rec = kernels.last_frame()
        host_ms = rec["host_ms"]
        log(f"gltf animation t={t}: sphere origin "
            f"{ahost.instances[sphere[0]].o.tolist()}, device scene rebuilt "
            f"in {t_build:.3f} s, render_image wall {wall:.3f} s; the "
            f"device loop's cache hit: {rec['cache_hit']}, host ms "
            + ", ".join(f"{k} {v:.2f}" for k, v in host_ms.items())
            + f"; on {dev_info['smi']}")
        if rec["cache_hit"] == (host_ms["capture"] > 0):
            raise AssertionError(f"gltf animation t={t}: a cache hit with "
                                 f"a capture, or a miss without one")
        check_plain(f"gltf animation t={t}", frames[t], ascene, ameta)
    moved = int((frames[1.0] != frames[0.0]).any(axis=-1).sum())
    log(f"gltf animation: t=0 bit-equal to the frame without the channel; "
        f"t=1 differs from t=0 in {moved} pixels")
    if moved == 0:
        raise AssertionError("gltf animation: t=1 equals t=0")

    # (c) skinning on the card against the CPU
    pos = ahost.shapes[ahost.instances[sphere[0]].shape].pos
    rng = np.random.default_rng(SEED)
    xf = np.tile(np.eye(4, dtype=np.float32), (SKIN_JOINTS, 1, 1))
    xf[:, :3, :] = rng.normal(size=(SKIN_JOINTS, 3, 4)).astype(np.float32)
    joints = rng.integers(0, SKIN_JOINTS, (len(pos), 4)).astype(np.int32)
    weights = rng.uniform(0, 1, (len(pos), 4)).astype(np.float32)
    weights /= weights.sum(1, keepdims=True)
    card = gltf.skin_vertices(pos, joints, weights, xf)
    cpu = gltf.skin_vertices(pos, joints, weights, xf, device="cpu")
    same = card.device.type == "cuda" and torch.equal(card.cpu(), cpu)
    seconds = time.perf_counter() - t_phase
    log(f"gltf skinning: {len(pos)} vertices, {SKIN_JOINTS} joints, card "
        f"bit-equal to the CPU: {same}; phase gltf {seconds:.1f} s on "
        f"{dev_info['smi']}")
    if len(pos) != 325 or not same:
        raise AssertionError("gltf skinning: the card differs from the CPU")
    return dict(counts=counts, seconds=seconds)


SHARDED_FRAME_KERNELS = {"hair": ("hit", "camera_rays", "shade"),
                         "area hair": ("hit", "camera_rays_stochastic",
                                       "light_points", "shade")}
# the host event of one torch.distributed.all_reduce in torch.profiler's
# trace (the c10d dispatcher op)
ALL_REDUCE_EVENT = "c10d::allreduce_"


def free_port() -> int:
    """A free TCP port on the loopback interface (bind to 0, read back)."""
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def frame_gaps(a: np.ndarray, b: np.ndarray):
    """(largest f32 ULP gap of the RGB channels, largest u8 gap after
    ``image.tonemap``) between two f32 frames."""
    from yocto_raytracing_tpu_torch import image

    ulp = int(np.abs(ordered(a[..., :3]) - ordered(b[..., :3])).max())
    u8 = int(np.abs(image.tonemap(a).astype(np.int32)
                    - image.tonemap(b)).max())
    return ulp, u8


def phase_sharded(hair_obj, area_hair_obj, device, dev_info) -> dict:
    """The ray-sharded paths (``parallel.mesh``) in a real one-rank NCCL
    group: the hair frame and the stochastic area hair frame (seed SEED,
    area lights) through ``render_image_sharded`` against ``render_image``
    (within 1 u8 step after the tonemap; the f32 ULP gap printed), each
    with its launch counts (no K3: the spp sum runs on the host);
    ``train_step_sharded`` on TRAIN_RAYS rays of the hair frame, every
    float leaf trainable, against ``train_step`` (loss rtol 1e-6, leaves
    rtol 1e-5 / atol 1e-7); a profiled sharded step, which must hold K1,
    K2, K4, K5 and K6 and 1 + (trainable leaves) all_reduce calls, and the
    all_reduce's time beside its bound. The group is destroyed after."""
    import torch.distributed as dist

    from yocto_raytracing_tpu_torch import kernels
    from yocto_raytracing_tpu_torch import scene as scene_lib
    from yocto_raytracing_tpu_torch.parallel import mesh
    from yocto_raytracing_tpu_torch.render import lights, renderer

    rank = mesh.init_distributed(f"tcp://127.0.0.1:{free_port()}", 1, 0,
                                 device=device.type)
    try:
        rays = mesh.make_ray_mesh(device.type)
        backend = dist.get_backend()
        log(f"sharded: torch.distributed group, backend {backend}, world "
            f"size {rays.world_size}, rank {rank}, device {rays.device}")
        if (backend != mesh.BACKENDS[device.type] or rays.group is None
                or rays.world_size != 1):
            raise AssertionError(f"sharded: not a one-rank "
                                 f"{mesh.BACKENDS[device.type]} group: "
                                 f"{backend} {rays}")
        rec = {}
        for name, path, kw in (
                ("hair", hair_obj, {}),
                ("area hair", area_hair_obj, dict(stochastic=True,
                                                  seed=SEED))):
            host = scene_lib.load_scene(path)
            leaves, meta = scene_lib.build_device_scene(host)
            scene = scene_lib.to_torch(leaves, device)
            if kw:
                kw["light_sampler"] = lights.build_light_sampler(
                    host, leaves, meta, device)
            width = renderer.image_width(host.cameras[0].aspect, RES)
            args = (scene, meta)
            frame = dict(width=width, height=RES, samples=SAMPLES,
                         max_depth=DEPTH, chunk_pixels=CHUNK_PIXELS, **kw)
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            sharded = mesh.render_image_sharded(*args, rays, **frame)
            wall = time.perf_counter() - t0
            counts = dict(kernels.launches)
            for k in SHARDED_FRAME_KERNELS[name]:
                if counts[k] <= 0:
                    raise AssertionError(f"sharded frame {name}: kernel {k} "
                                         f"never launched")
            if counts["pixel_finish"]:
                raise AssertionError(f"sharded frame {name}: K3 ran; the "
                                     f"spp sum belongs to the host")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            whole = renderer.render_image(*args, **frame)
            wall_whole = time.perf_counter() - t0
            if sharded.shape != whole.shape or not np.isfinite(sharded).all():
                raise AssertionError(f"sharded frame {name}: shape or "
                                     f"non-finite pixels")
            ulp, u8 = frame_gaps(sharded, whole)
            rays_n = width * RES * SAMPLES * SAMPLES
            log(f"sharded frame {name}: {width}x{RES} x "
                f"{SAMPLES * SAMPLES} spp, depth {DEPTH}"
                f"{', stochastic seed %d, area lights' % SEED if kw else ''}"
                f": render_image_sharded {wall:.3f} s, render_image "
                f"{wall_whole:.3f} s wall on {dev_info['smi']}; launches "
                f"{counts}; against render_image: u8 gap {u8} (tolerance 1 "
                f"step)")
            log(f"sharded frame {name}: largest f32 ULP gap to render_image "
                f"{ulp}")
            if u8 > 1:
                raise AssertionError(f"sharded frame {name}: {u8} u8 steps")
            rec[name] = dict(wall=wall, ulp=ulp, u8=u8, rays=rays_n)

        host = scene_lib.load_scene(hair_obj)
        leaves, meta = scene_lib.build_device_scene(host)
        scene = scene_lib.to_torch(leaves, device)
        w = renderer.image_width(host.cameras[0].aspect, RES)
        amb = torch.full((3,), 0.1, device=device)
        ids = middle_ids(w, RES, SAMPLES, TRAIN_RAYS, device)
        kw = dict(width=w, height=RES, samples=SAMPLES, max_depth=DEPTH)
        target = renderer.trace_rays(perturbed(scene, 7), ids, amb, w, RES,
                                     SAMPLES, DEPTH)
        local = (mesh.shard_rays(ids, rays), mesh.shard_rays(target, rays))

        def step():
            return mesh.train_step_sharded(scene, *local, amb, TRAIN_LR,
                                           mesh=rays, **kw)

        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        new_s, loss_s = step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(kernels.launches)
        for k in TRAIN_KERNELS:
            if counts[k] <= 0:
                raise AssertionError(f"sharded train: kernel {k} never "
                                     f"launched")
        new_1, loss_1 = mesh.train_step(scene, ids, target, amb, TRAIN_LR,
                                        **kw)
        worst = (0.0, "")   # |a - b| / (atol + rtol |b|), the largest
        for k in scene_lib.LEAF_NAMES:
            a = getattr(new_s, k).double()
            b = getattr(new_1, k).double()
            if a.numel():
                share = float(((a - b).abs() / (1e-7 + 1e-5 * b.abs())).max())
                worst = max(worst, (share, k))
        if worst[0] > 1:
            raise AssertionError(f"sharded train: leaf {worst[1]} off "
                                 f"train_step's ({worst[0]:.3f} of the "
                                 f"tolerance)")
        loss_gap = abs(float(loss_s) - float(loss_1)) / abs(float(loss_1))
        if not loss_gap <= 1e-6:
            raise AssertionError(f"sharded train: loss {float(loss_s)} vs "
                                 f"{float(loss_1)}")
        n_leaves = sum(getattr(scene, k).is_floating_point()
                       for k in scene_lib.LEAF_NAMES)
        log(f"sharded train hair: {TRAIN_RAYS} rays, every float leaf "
            f"({n_leaves}) trainable: loss {float(loss_s)!r} vs train_step "
            f"{float(loss_1)!r} (relative gap {loss_gap:.2e}, tolerance "
            f"1e-6); updated leaves: largest gap {worst[0]:.3f} of the "
            f"tolerance rtol 1e-5 / atol 1e-7 ({worst[1]}); first step "
            f"{wall:.3f} s; launches {counts}")

        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        prof = profile_summary(step, "warm sharded train step hair",
                               TRAIN_KERNELS)
        for k in TRAIN_KERNELS:
            device_ms(prof, k, counts[k])   # raises if K1/K2/K4/K5/K6 is missing
        found = {n: c for n, c in prof["host"].items()
                 if "allreduce" in n.lower().replace("_", "")}
        calls = found.get(ALL_REDUCE_EVENT, 0)
        nccl = {n: t for n, t in prof["by_name"].items()
                if "nccl" in n.lower()}
        log(f"sharded train hair: all_reduce host events {found}; NCCL "
            f"device kernels {nccl or 'none'}")
        if calls != 1 + n_leaves:
            raise AssertionError(f"sharded train: {calls} all_reduce calls, "
                                 f"want {1 + n_leaves}")
        loss, grads, _ = mesh.loss_and_grads_sharded(
            scene, *local, amb, mesh=rays, **kw)
        bufs = [loss] + [g for g in grads if g is not None]
        n_bytes = nbytes(*bufs)

        def reduce_all():
            for x in bufs:
                dist.all_reduce(x)

        ar_ms = cuda_ms(reduce_all, 20)
        rec["all_reduce"] = dict(
            calls=calls, bytes=n_bytes, ms=ar_ms,
            device_us=sum(nccl.values()), kernels=len(nccl),
            bound_ms=n_bytes / HBM_BYTES_PER_S * 1e3, walls=walls,
            prof=prof, counts=counts)
        log(f"B9 all_reduce, world of one: {calls} calls per step carrying "
            f"{n_bytes} bytes (the loss and every float leaf's gradient); "
            f"NCCL device time in the profiled step "
            f"{sum(nccl.values()):.1f} us over {len(nccl)} kernel names; "
            f"CUDA-event time of the step's {len(bufs)} all_reduce calls "
            f"{ar_ms:.4f} ms; bound {rec['all_reduce']['bound_ms'] * 1e3:.3f}"
            f" us (the bytes once over {HBM_BYTES_PER_S / 1e12} TB/s); "
            f"sharded step wall {', '.join(f'{x:.4f}' for x in walls)} s on "
            f"{dev_info['smi']}")
        return rec
    finally:
        dist.destroy_process_group()


def run_command(cmd, label, dev_info, timeout=600):
    """Run ``cmd`` from the checkout in its own session (killed whole on a
    timeout), log its wall time; returns (returncode, stdout, stderr)."""
    import signal

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    log(f"cli {label}: exit {proc.returncode}, "
        f"{time.perf_counter() - t0:.2f} s wall on {dev_info['smi']}")
    return proc.returncode, out, err


def phase_cli(hair_obj, tmp, device, dev_info) -> dict:
    """The CLI as a user runs it, in subprocesses on the card: the hair
    frame at RES, SAMPLES x SAMPLES, depth DEPTH, saved as PNG, must be
    ``image.tonemap(render_image(...))`` of the same settings bit for bit;
    so must the ``--checkpoint`` run, again after its snapshot is cut to
    half its ``done``, the ``--sharded`` run in a plain process (world of
    one, no group) and the ``--sharded`` run under torchrun (one rank,
    ``init_distributed`` from its environment, NCCL), and the plain run
    on the scene's ``.glb`` twin. A missing scene exits 1 with ``error:``
    first on stderr."""
    from yocto_raytracing_tpu_torch import image
    from yocto_raytracing_tpu_torch import scene as scene_lib
    from yocto_raytracing_tpu_torch.parallel import mesh
    from yocto_raytracing_tpu_torch.render import renderer

    host = scene_lib.load_scene(hair_obj)
    scene, meta = scene_on(host, device)
    width = renderer.image_width(host.cameras[0].aspect, RES)
    want = image.tonemap(renderer.render_image(scene, meta, width, RES,
                                               SAMPLES, max_depth=DEPTH))
    cli = [sys.executable, "-m", "yocto_raytracing_tpu_torch.cli"]
    args = ["-r", str(RES), "-s", str(SAMPLES), "--max-depth", str(DEPTH),
            "--device", device.type]
    png = os.path.join(tmp, "cli.png")
    ck = os.path.join(tmp, "cli_ck.npz")
    torchrun = [sys.executable, "-m", "torch.distributed.run",
                "--nproc_per_node=1", "--master_addr=127.0.0.1",
                f"--master_port={free_port()}", "-m",
                "yocto_raytracing_tpu_torch.cli"]
    runs = [("plain", cli + args), ("--checkpoint", cli + args + [
        "--checkpoint", ck]), ("--checkpoint, resumed from half", None),
        ("--sharded", cli + args + ["--sharded"]),
        ("--sharded under torchrun", torchrun + args + ["--sharded"])]
    walls = {}
    for label, cmd in runs:
        if cmd is None:   # the snapshot cut to half its done, then rerun
            with np.load(ck) as snap:
                key, acc, done = snap["key"], snap["acc"], int(snap["done"])
            if done != width * RES:
                raise AssertionError(f"cli: snapshot done {done}")
            renderer._atomic_savez(ck, key=key, done=done // 2,
                                   acc=acc[:done // 2])
            cmd = runs[1][1]
        if os.path.exists(png):
            os.remove(png)
        t0 = time.perf_counter()
        rc, out, err = run_command(cmd + ["-o", png, hair_obj], label,
                                   dev_info)
        walls[label] = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"cli {label}: exit {rc}\n{out}\n{err}")
        got = image.load_image4b(png)
        d = int(np.abs(got.astype(np.int32) - want).max())
        log(f"cli {label}: PNG {got.shape} against image.tonemap("
            f"render_image): bit-equal {np.array_equal(got, want)}, max "
            f"{d} u8 steps")
        if not np.array_equal(got, want):
            raise AssertionError(f"cli {label}: PNG differs by {d}")
        backend = mesh.BACKENDS[device.type]
        if "torchrun" in label and f"backend {backend}" not in err:
            raise AssertionError(f"cli {label}: no {backend} group\n{err}")
        if label == "--sharded" and "no group" not in err:
            raise AssertionError(f"cli {label}: a group was started\n{err}")
    # the .glb twin of the scene writes the .obj run's PNG
    glb = os.path.join(tmp, "cli_glb", "hair.glb")
    scene_lib.save_scene(host, glb)
    os.remove(png)
    t0 = time.perf_counter()
    rc, out, err = run_command(cli + args + ["-o", png, glb], ".glb",
                               dev_info)
    walls[".glb"] = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli .glb: exit {rc}\n{out}\n{err}")
    got = image.load_image4b(png)
    log(f"cli .glb: PNG bit-equal to the .obj run's: "
        f"{np.array_equal(got, want)}")
    if not np.array_equal(got, want):
        raise AssertionError("cli .glb: PNG differs from the .obj run's")
    rc, out, err = run_command(cli + args + [os.path.join(tmp, "none.obj")],
                               "missing scene", dev_info)
    log(f"cli missing scene: stderr {err.strip()[:120]!r}")
    if rc != 1 or not err.startswith("error:") or "Traceback" in err:
        raise AssertionError(f"cli missing scene: exit {rc}\n{err}")
    return walls


def main() -> None:
    t_start = time.perf_counter()
    dev_info = phase_device()
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    shade_regs, camera_build = phase_build()
    # the host CPU's plain walk for K1 on the 10,004-instance scene runs in
    # worker processes beside the card's phases (the native BVH builder is
    # built first, once)
    from yocto_raytracing_tpu_torch import native

    native.get_lib()
    pool = multiprocessing.get_context("spawn").Pool(HIT_PLAIN_WORKERS)
    try:
        run_phases(dev_info, device, shade_regs, camera_build,
                   start_plain_walk(pool), t_start)
    finally:
        pool.terminate()
        pool.join()


def run_phase(fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its seconds logged."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    log(f"{fn.__name__}: {time.perf_counter() - t0:.1f} s")
    return out


def run_phases(dev_info, device, shade_regs, camera_build, plain_walk,
               t_start) -> None:
    from yocto_raytracing_tpu_torch import scene as scene_lib, testscenes
    from yocto_raytracing_tpu_torch.render import lights, renderer

    hit_10004 = run_phase(phase_hit_kernel, device)
    # first of the profiled phases: the tracer has lost this call's few
    # device events late in a run
    overlap_rec, overlap_path = run_phase(phase_overlap, device, dev_info)

    with tempfile.TemporaryDirectory() as tmp:
        hair_obj = os.path.join(tmp, "hair.obj")
        scene_lib.save_scene(testscenes.make_hair_scene(256), hair_obj)
        grad_obj = os.path.join(tmp, "mirror.obj")
        scene_lib.save_scene(testscenes.make_grad_scene(), grad_obj)

        hair = scene_lib.load_scene(hair_obj)
        hscene, hmeta = scene_on(hair, device)
        mscene, mmeta = scene_on(scene_lib.load_scene(grad_obj), device)
        tscene, tmeta = scene_on(testscenes.make_textured_hair_scene(256),
                                 device)
        width = renderer.image_width(hair.cameras[0].aspect, RES)
        rec = run_phase(phase_frame_kernels, hscene, width, RES, SAMPLES,
                        device)
        rec["bounce"] = run_phase(phase_bounce_kernel, device)
        rec["bounce_bwd"] = run_phase(phase_bounce_bwd_kernel, device)
        rec["records"] = run_phase(phase_records_kernel, device)
        rec.update(run_phase(phase_hit_frame, "hair", hscene, hmeta, width))
        # (name, scene, meta, width, height, bounce, rays from the end)
        cases = [("hair", hscene, hmeta, width, RES, 1, False),
                 ("mirror", mscene, mmeta, RES, RES, 2, True),
                 ("textured hair", tscene, tmeta, width, RES, 1, False)]
        rec["shade"] = run_phase(phase_shade_kernel, cases, device)
        rec.update(run_phase(phase_grad_kernels, cases, device, camera_build))

        main_frame = run_phase(phase_frame, hair_obj, RES, SAMPLES, DEPTH,
                               device, dev_info, "hair")
        run_phase(phase_frame, grad_obj, RES, SAMPLES, DEPTH, device,
                  dev_info, "mirror")
        run_phase(phase_small_reference, hair_obj, device)
        main_train = run_phase(phase_train, "hair", hscene, width, RES,
                               False, device, dev_info)
        mirror_train = run_phase(phase_train, "mirror", mscene, RES, RES,
                                 True, device, dev_info)
        pair = testscenes.make_mirror_pair_scene()
        pscene, _ = scene_on(pair, device)
        # at lr 1.0 its second step raises the loss (0.0138, 0.00047,
        # 0.00051 on an H100): SGD oversteps there
        pair_train = run_phase(
            phase_train, "mirror pair", pscene,
            renderer.image_width(pair.cameras[0].aspect, RES), RES, False,
            device, dev_info, steps_lr=PAIR_LR)
        deep_train = run_phase(phase_train, "hair", hscene, width, RES,
                               False, device, dev_info, depth=8)

        area_hair = area_hair_scene()
        area_hair_obj = os.path.join(tmp, "area_hair.obj")
        scene_lib.save_scene(area_hair, area_hair_obj)
        area_mirror_obj = os.path.join(tmp, "area_mirror.obj")
        scene_lib.save_scene(area_mirror_scene(), area_mirror_obj)
        rec.update(run_phase(phase_stochastic,
                             scene_lib.load_scene(area_hair_obj), device))
        area_host = scene_lib.load_scene(area_hair_obj)
        ascene, ameta = scene_on(area_host, device)
        run_phase(
            phase_hit_frame, "area hair", ascene, ameta,
            renderer.image_width(area_host.cameras[0].aspect, RES),
            stochastic=True, seed=SEED,
            light_sampler=lights.build_light_sampler(area_host, None, ameta,
                                                     device))
        stochastic_frame = run_phase(phase_area_frame, area_hair_obj, device,
                                     dev_info, "area hair")
        run_phase(phase_area_frame, area_mirror_obj, device, dev_info,
                  "area mirror")
        run_phase(phase_point_light_area, hair_obj, main_frame["image"],
                  device)
        pair_obj = os.path.join(tmp, "mirror_pair.obj")
        scene_lib.save_scene(testscenes.make_mirror_pair_scene(), pair_obj)
        run_phase(
            phase_frame_device_loop,
            [("hair", hair_obj, False, DEPTH),
             ("mirror", grad_obj, False, DEPTH),
             ("area hair", area_hair_obj, True, DEPTH),
             ("area mirror", area_mirror_obj, True, DEPTH),
             ("mirror pair", pair_obj, False, DEPTH),
             ("hair", hair_obj, False, 8)], ("mirror pair",), device,
            dev_info)
        rec.update(run_phase(phase_reverse_kernels,
                             scene_lib.load_scene(area_hair_obj), device,
                             camera_build))
        panel_obj = os.path.join(tmp, "area_hair_panel.obj")
        scene_lib.save_scene(area_hair_scene(PANEL_CELLS), panel_obj)
        light_cases = run_phase(
            phase_light_kernels,
            [("area hair", scene_lib.load_scene(area_hair_obj), True),
             ("area mirror", scene_lib.load_scene(area_mirror_obj), True),
             ("lamp panel", scene_lib.load_scene(panel_obj), False)],
            device)
        stochastic_train = run_phase(
            phase_train_stochastic, "area hair",
            scene_lib.load_scene(area_hair_obj), False, device, dev_info)
        run_phase(phase_train_stochastic, "area mirror",
                  scene_lib.load_scene(area_mirror_obj), True, device,
                  dev_info)
        rec["overlap"] = dict(
            overlap_rec["overlap"],
            random_seed_0=overlap_rec["random seed 0"],
            strand_points=overlap_rec["hair 256, strand points"],
            on_strands=overlap_rec["hair 256, points on the strands"])
        rec["overlap_refit"] = overlap_rec["overlap_refit"]
        gltf_frame = run_phase(phase_gltf, tmp, device, dev_info)
        # last: the NCCL group and the CLI's subprocesses
        run_phase(phase_sharded, hair_obj, area_hair_obj, device, dev_info)
        run_phase(phase_cli, hair_obj, tmp, device, dev_info)
    check_plain_walk(plain_walk, hit_10004)

    src = "yocto_raytracing_tpu_torch/kernels/csrc/"
    counts = main_frame["counts"]
    counts["hit_nearest"] = counts["hit"] - counts["hit_any"]
    table = {  # name: (source, replaces, path that runs it)
        "hit_nearest": ("hit.cu", "yocto_raytracing_tpu/ops/traverse.py:82",
                        main_frame),
        "hit_any": ("hit.cu", "yocto_raytracing_tpu/ops/traverse.py:82",
                    main_frame),
        "camera_rays": ("camera.cu",
                        "yocto_raytracing_tpu/render/camera.py:124",
                        main_frame),
        "pixel_finish": ("pixel.cu",
                         "yocto_raytracing_tpu/render/renderer.py:106",
                         main_frame),
        "shade": ("shade.cu", "yocto_raytracing_tpu/render/shade.py:159",
                  main_frame),
        "shade_bwd": ("shade_bwd.cu",
                      "yocto_raytracing_tpu/render/shade.py:159",
                      main_train),
        "camera_bwd": ("camera.cu",
                       "yocto_raytracing_tpu/render/camera.py:27",
                       main_train),
        "camera_rays_stochastic": (
            "stochastic.cu", "yocto_raytracing_tpu/render/camera.py:100",
            stochastic_frame),
        "light_points": ("lights.cu",
                         "yocto_raytracing_tpu/render/lights.py:82",
                         stochastic_frame),
        "shade_bwd_lights": ("shade_bwd.cu",
                             "yocto_raytracing_tpu/render/shade.py:242",
                             stochastic_train),
        "camera_bwd_stochastic": ("stochastic.cu",
                                  "yocto_raytracing_tpu/render/camera.py:73",
                                  stochastic_train),
        "light_points_bwd": ("lights.cu",
                             "yocto_raytracing_tpu/render/lights.py:82",
                             stochastic_train),
        "overlap": ("overlap.cu", "yocto_raytracing_tpu/ops/overlap.py:244",
                    overlap_path),
        "overlap_refit": ("overlap.cu",
                          "yocto_raytracing_tpu/ops/overlap.py:244",
                          overlap_path),
        "bounce": ("bounce.cu", "yocto_raytracing_tpu/render/renderer.py:179",
                   main_frame),
        "records": ("records.cu",
                    "yocto_raytracing_tpu/render/renderer.py:179",
                    main_frame),
        "bounce_bwd": ("bounce.cu",
                       "yocto_raytracing_tpu/render/renderer.py:342",
                       main_train),
    }
    # "launches": what the card made on the path. The main path's counters
    # gain a CUDA graph's captured launches on every replay, those in the
    # IF nodes of dead bounces too, which the card does not make: those
    # are "counted" less "skipped" (``kernels.made_launches``)
    kernels_rec = []
    for k, (f, r, path) in table.items():
        skipped = path.get("skipped", {}).get(k, 0)
        made = path["made"][k] if "made" in path else path["counts"][k]
        kernels_rec.append(dict(
            name=k, route="cuda", source=src + f, replaces=r,
            launches=made, counted=path["counts"][k], skipped=skipped,
            **rec[k], device_ms=device_ms(path["prof"], k, made)))
    by_name = {r["name"]: r for r in kernels_rec}
    # the glTF frame's path (render_scene_file of a .glb) launches K1-K4
    # and K12 too: its own counts, set to 0 just before it
    gltf_counts = gltf_frame["counts"]
    gltf_counts["hit_nearest"] = gltf_counts["hit"] - gltf_counts["hit_any"]
    for k in ("hit_nearest", "hit_any", "camera_rays", "pixel_finish",
              "shade", "bounce", "records"):
        by_name[k]["gltf_launches"] = gltf_counts[k]
    k4_regs = {k: v for k, v in shade_regs.items() if "bwd" not in k
               and "light_sum" not in k}
    k5_regs = {k: v for k, v in shade_regs.items() if k not in k4_regs}
    by_name["shade"]["ptxas"] = k4_regs
    by_name["shade"]["lights"] = rec["shade_lights"]
    for k in ("shade_bwd", "shade_bwd_lights"):
        by_name[k]["ptxas"] = k5_regs
    for kind, key in (("light_points", "k8"), ("light_points_bwd", "k10")):
        by_name[kind]["cases"] = {k: v[key] for k, v in light_cases.items()}
    by_name["light_points_bwd"]["step_cotangent"] = stochastic_train["k10"]
    for label, r in (("hair", main_train), ("mirror", mirror_train),
                     ("mirror pair", pair_train), ("hair depth 8",
                                                   deep_train)):
        t, p = r["turns"], r["prof"]
        log(f"train step {label}, {TRAIN_RAYS} rays, every float leaf, "
            f"wall ms in turns: hit "
            + "/".join(f"{x:.2f}" for x in t["hit"]["walls"]) + ", miss "
            + "/".join(f"{x:.2f}" for x in t["miss"]["walls"])
            + f"; profiled hit: busy {p['busy_ms']:.3f} ms, idle share "
            f"{p['idle']:.3f}, {p['ops']} device ops; the entry "
            f"{r['entry_mib']:.1f} MiB, reserved +{r['grown_mib']:.1f} MiB "
            f"over {len(STEP_TURNS)} calls; on {dev_info['smi']}")
    r = by_name["records"]
    r["step_device_us"] = (device_us(main_train["prof"]["by_name"], "records")
                           / main_train["made"]["records"])
    for r in kernels_rec:
        log(f"{r['name']}: {r['launches']} launches made on its path "
            f"({r['counted']} counted, {r['skipped']} of them in dead "
            f"bounces, not made); per launch there, device "
            f"{r['device_ms'] * 1e3:.1f} us (profiler) "
            f"against a bound of {r['bound_ms'] * 1e3:.2f} us at the "
            f"timed shape; timed call {r['ms']:.4f} ms (CUDA events around "
            f"the wrapper), plain {r['plain_ms']:.4f} ms")
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "yocto_raytracing_tpu"))
    if loaded:
        raise AssertionError(f"the JAX package or jax was imported: {loaded}")
    log(f"no module of jax or of the JAX package was imported; total "
        f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels_rec}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_info["kind"],
        "count": dev_info["count"]}}))


if __name__ == "__main__":
    sys.exit(main())
