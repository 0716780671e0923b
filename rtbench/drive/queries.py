"""Traffic of kind ``queries``: one tool asking for closest elements.

A closed loop with one caller: each request is ``ops.overlap.overlap_scene``
on ``points`` query points drawn fresh for the call from the seed (a
generator on the device), uniform in the box ``box_min``..``box_max``,
with ``dist_max``; the answers stay on the device and each call ends with
a synchronize. Set-up loads the scene and makes ``warm_calls`` calls.

End to end: ``query_Mq_s``, the queries answered in the window over its
seconds. ``correct``: ``keep_calls`` calls of the window drawn from the
seed, ``check_queries`` queries of each drawn from the seed, answered
again by the plain reference's brute force (``rtbench/ref/overlap.py``)
on the generator's arrays: ``mismatch`` is the share whose found, inst or
prim differ, ``answer_gap`` the widest gap of dist or euv among the rest.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from rtbench.core import common
from rtbench.core.profile import traced
from rtbench.core.runner import Outcome, correct
from rtbench.core.trace import TraceData
from rtbench.ref import flat
from rtbench.ref import overlap as ref_overlap


def compare(answers, ref_scene, ref_meta, p, seed, dtype=None):
    """(mismatch, answer_gap) of the sampled queries of ``answers`` ([(points,
    outputs)]) against the brute force. With ``dtype`` the brute force runs
    in it (the control) and is compared with itself in float32."""
    rng = np.random.default_rng([seed, 3])
    bad = total = 0
    gap = 0.0
    for pts, out in answers:
        idx = torch.as_tensor(np.sort(rng.choice(
            pts.shape[0], p["check_queries"], replace=False)),
            device=pts.device)
        q = pts[idx].to(ref_scene.pos.device, torch.float32)
        want = ref_overlap.overlap_scene_plain(ref_scene, ref_meta, q,
                                               p["dist_max"])
        if dtype is None:
            got = {k: v[idx].to(q.device) for k, v in out.items()}
        else:
            got = ref_overlap.overlap_scene_plain(
                flat.lowered(ref_scene, dtype), ref_meta, q.to(dtype),
                p["dist_max"])
        same = ((got["found"] == want["found"])
                & (got["inst"] == want["inst"])
                & (got["prim"] == want["prim"]))
        bad += int((~same).sum())
        total += len(idx)
        both = same & want["found"]
        if bool(both.any()):
            d = (got["dist"].float() - want["dist"]).abs()[both]
            e = (got["euv"].float() - want["euv"]).abs()[both]
            gap = max(gap, float(d.max()), float(e.max()))
    return bad / total, gap


def run(cell, seed, seconds, trace, device, t_start, sizes):
    from yocto_raytracing_tpu_torch.ops import overlap

    p = {**cell.traffic, **sizes}
    loaded = common.load_config_scene(cell.config, device)
    loaded_s = time.time() - t_start
    scene, meta = loaded.scene, loaded.meta
    lo = torch.tensor(p["box_min"], dtype=torch.float32, device=device)
    span = torch.tensor(p["box_max"], dtype=torch.float32,
                        device=device) - lo
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    n = p["points"]

    def call():
        pts = torch.rand((n, 3), generator=gen, device=device) * span + lo
        out = overlap.overlap_scene(scene, meta, pts, p["dist_max"])
        common.sync(device)
        return pts, out

    for _ in range(p["warm_calls"]):
        call()
    setup_s = time.time() - t_start

    keep = common.Reservoir(p["keep_calls"], np.random.default_rng([seed, 2]))
    t0 = time.perf_counter()
    k = 0
    while True:
        keep.offer(call())
        k += 1
        b = time.perf_counter()
        if b - t0 >= seconds:
            break
    elapsed = b - t0
    t_window = time.perf_counter()
    mem = (torch.cuda.max_memory_allocated(device)
           if torch.device(device).type == "cuda" else 0)
    metrics = dict(query_Mq_s=k * n / elapsed / 1e6, setup_s=setup_s)

    data = None
    if trace:
        # the points of the calls whose queries the walk counts
        walked = set(np.random.default_rng([seed, 4]).choice(
            p["trace_calls"], min(p["trace_calls"], p["walk_calls"]),
            replace=False).tolist())

        def window(count):
            recs = []
            for j in range(count):
                pts, _ = call()
                recs.append(pts if j in walked else None)
            return recs

        prof = traced(window, p["trace_calls"],
                      lambda recs: {"overlap_kernel": len(recs)},
                      p["name_calls"])
        data = _trace_data(prof, loaded, p, seed, device)

    host = loaded.host
    del loaded, scene
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref_scene, ref_meta, _ = common.reference_scene(host, device)
    mismatch, gap = compare(keep.items, ref_scene, ref_meta, p, seed)
    notes = {"phases_s": dict(
        loaded=loaded_s, setup=setup_s, window=t_window - t0,
        trace=t_ref - t_window, reference=time.perf_counter() - t_ref)}
    if p.get("control"):
        cm, cg = compare(keep.items, ref_scene, ref_meta, p, seed,
                         dtype=getattr(torch, p["control"]))
    lim = cell.limits
    if p.get("control"):
        c = {"mismatch": (cm, lim["mismatch"]),
             "answer_gap": (cg, lim["answer_gap"])}
        notes["control"] = dict(mismatch=cm, answer_gap=cg,
                                correct=correct(c))
    return Outcome(metrics=metrics, attempted=k, failed=0,
                   compared={"mismatch": (mismatch, lim["mismatch"]),
                             "answer_gap": (gap, lim["answer_gap"])},
                   memory_peak_bytes=int(mem), trace=data, notes=notes)


def _trace_data(prof, loaded, p, seed, device):
    calls = len(prof.records)
    pts = [q for q in prof.records if q is not None]
    host = loaded.host
    ref_scene, ref_meta, leaves = common.reference_scene(host, device)
    recs = ref_overlap.refit_plain(ref_scene)
    # a call reads the refit's leaves and writes the records, then the walk
    # reads the records and the instance frames
    refit_in = common.leaves_bytes(leaves, (
        "node_start", "node_count", "node_isleaf", "node_kind", "node_skip",
        "node_bbox_min", "node_bbox_max", "leaf_items", "prim_v",
        "prim_type", "pos", "radius"))
    rec_bytes = sum(t.numel() * t.element_size() for t in recs[:2])
    frames = common.leaves_bytes(leaves, ("inst_axes", "inst_o",
                                          "inst_shape_root"))

    def walk_counts():
        """The plain walk's work on ``walk_queries`` queries drawn from the
        seed among those of ``walk_calls`` traced calls, scaled to all the
        traced calls' queries."""
        rng = np.random.default_rng([seed, 5])
        per = max(1, p["walk_queries"] // len(pts))
        stats: dict = {}
        sampled = 0
        for q in pts:
            idx = torch.as_tensor(rng.choice(q.shape[0], per, replace=False),
                                  device=q.device)
            ref_overlap.overlap_scene_walk_plain(
                ref_scene, ref_meta, q[idx].to(ref_scene.pos.device),
                p["dist_max"], stats=stats)
            sampled += per
        scale = calls * p["points"] / sampled
        return {k: v * scale for k, v in stats.items()}

    return TraceData(prof, torch.cuda.get_device_name(0)
                     if torch.device(device).type == "cuda" else "cpu",
                     calls, {
        "walk_counts": walk_counts,
        "queries": calls * p["points"],
        "instances": ref_meta.num_instances,
        "call_bytes": calls * (refit_in + 2 * rec_bytes + frames),
    })
