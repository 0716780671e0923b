"""Traffic of kind ``steps``: one inverse-rendering loop taking SGD steps.

A closed loop with one caller: each request is
``parallel.mesh.train_step`` on ``rays`` consecutive ray ids of the
frame at an offset, the leaves named in ``trainable`` trained at ``lr``,
and each step takes the scene the previous one returned. The offsets start ``offsets`` equal
strata of the frame's ray ids, in an order drawn from the seed. The
target is a low-frequency HDR image that the benchmark makes
(``target``: a base colour plus ``terms`` sinusoids of at most
``max_cycles`` cycles across the frame, drawn from its own ``seed``, on
the device); a step's target rows are its rays' pixels. So every seed
trains on the same batches and target in another order: the seed changes
the trajectory, and not the work. The loss is read on the host every
``loss_every`` steps, as a logging loop does; the window ends with a
synchronize. Set-up loads the scene, makes the target and takes the
first step (the capture) and ``warm_steps`` more through the same call
and feed; the window goes on from that same scene.

End to end: ``step_Mrays_s``, ``rays`` x the steps of the window over its
seconds. ``correct``: the plain reference (``rtbench/ref``, torch
autograd) takes the same steps and the two sides are compared per step:
the loss (``loss_gap``: the widest relative gap), the first gradient as
the optimizer got it, ``(before - after) / lr`` (``grad_gap``), and the
change of the leaves over the steps (``change_gap``), each by the worst
leaf: the gap between the program's norm and the reference's, over the
larger of the reference's norm of that leaf and of the median leaf. The
change leaves out a leaf whose reference gradient is under a thousandth
of the median leaf's (moved by round-off alone). Two stretches are
checked: the start, the set-up's first step from the generator's arrays;
and two consecutive steps of the window, the first drawn from the seed
among its first ``check_within``, which the reference takes from the
program's trained leaves as they were before them (it cannot replay
thousands of steps), the other leaves being the generator's.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from rtbench.core import common
from rtbench.core.profile import traced
from rtbench.core.runner import Outcome, correct
from rtbench.core.trace import TraceData
from rtbench.ref import flat
from rtbench.ref import render as ref_render

TINY_GRAD = 1e-3    # of the median leaf's reference gradient norm


def offsets(total: int, n: int, p: dict, seed: int) -> np.ndarray:
    """The mix's offsets into the frame's ``total`` ray ids, in the seed's
    order."""
    rng = np.random.default_rng([seed, 1])
    strata = p["offsets"]
    off = np.arange(strata) * ((total - n) // (strata - 1))
    return off[rng.permutation(strata)]


def target_image(width: int, height: int, p: dict, device):
    """(height * width, 3) f32: the low-frequency HDR target."""
    t = p["target"]
    rng = np.random.default_rng(t["seed"])
    v, u = torch.meshgrid(
        (torch.arange(height, device=device, dtype=torch.float32) + 0.5)
        / height,
        (torch.arange(width, device=device, dtype=torch.float32) + 0.5)
        / width, indexing="ij")
    img = torch.zeros((height, width, 3), device=device)
    for c in range(3):
        img[..., c] = float(rng.uniform(*t["base"]))
        for _ in range(t["terms"]):
            fx, fy = rng.uniform(-t["max_cycles"], t["max_cycles"], 2)
            phase, amp = rng.uniform(0, 2 * math.pi), rng.uniform(0, t["amp"])
            img[..., c] += amp * torch.sin(2 * math.pi * (fx * u + fy * v)
                                           + phase)
    return img.clamp(min=0.0).reshape(-1, 3)


def trained(scene, names) -> dict:
    """The leaves in ``names`` (those the steps train), cloned."""
    return {k: v.detach().clone() for k, v in vars(scene).items()
            if k in names}


def reference_steps(ref_scene, feed, p, width, height, lr, dtype=None,
                    start=None):
    """The plain reference's checked steps: (losses, first gradients,
    leaves after the first step, leaves after the last step), in float32,
    or in ``dtype`` (the control). The mix's ``trainable`` leaves are
    trained; ``start`` (name -> tensor) replaces some of them first."""
    scene = flat.lowered(ref_scene, dtype or torch.float32)
    names = [k for k in vars(scene) if k in p["trainable"]]
    for k, v in (start or {}).items():
        setattr(scene, k, v.to(scene.pos.device, scene.pos.dtype))
    amb = torch.full((3,), p["ambient"], dtype=scene.pos.dtype,
                     device=scene.pos.device)
    losses, first = [], None
    for ids, target in feed:
        for k in names:
            setattr(scene, k, getattr(scene, k).detach().requires_grad_(True))
        loss = ref_render.render_loss(
            scene, ids, target.to(scene.pos.dtype), amb, width=width,
            height=height, samples=p["samples"], max_depth=p["max_depth"])
        grads = torch.autograd.grad(loss, [getattr(scene, k) for k in names],
                                    allow_unused=True)
        grads = [torch.zeros_like(getattr(scene, k)) if g is None else g
                 for k, g in zip(names, grads)]
        losses.append(float(loss.detach()))
        for k, g in zip(names, grads):
            setattr(scene, k, (getattr(scene, k) - lr * g).detach())
        if first is None:
            first = {k: g.detach().float() for k, g in zip(names, grads)}
            after_first = {k: getattr(scene, k).float() for k in names}
    return (losses, first, after_first,
            {k: getattr(scene, k).float() for k in names})


def gaps(prog: dict, ref: dict, lr: float, worst: dict | None = None):
    """(loss_gap, grad_gap, change_gap) of the program's checked steps
    against the reference's, each given as ``losses``, ``p0`` (the leaves
    before), ``p1`` (after the first step) and ``last`` (after the last);
    the reference's also as ``first`` (its first gradients). The first
    gradient is taken on both sides as the update shows it, ``(p0 - p1) /
    lr``, so that an update below a leaf's float32 resolution reads 0 on
    both; ``worst``, when given, gains the leaf that reads each gap."""
    loss_gap = max(_rel(a - b, abs(b)) for a, b in zip(prog["losses"],
                                                       ref["losses"]))

    def step_norms(side):
        return {k: float(((side["p0"][k].double() - side["p1"][k].double())
                          / lr).norm()) for k in ref["first"]}

    g_ref, g_prog = step_norms(ref), step_norms(prog)
    g_med = float(np.median(list(g_ref.values())))
    grad_gap = max(_rel(g_prog[k] - g_ref[k], max(g_ref[k], g_med))
                   for k in g_ref)
    exact = {k: float(v.double().norm()) for k, v in ref["first"].items()}
    e_med = float(np.median(list(exact.values())))
    moved = [k for k in exact if exact[k] >= TINY_GRAD * e_med]
    d_ref = {k: float((ref["last"][k].double() - ref["p0"][k].double())
                      .norm()) for k in moved}
    d_prog = {k: float((prog["last"][k].double() - prog["p0"][k].double())
                       .norm()) for k in moved}
    d_med = float(np.median(list(d_ref.values()))) if moved else 0.0
    change_gap = max((_rel(d_prog[k] - d_ref[k], max(d_ref[k], d_med))
                      for k in moved), default=0.0)
    if worst is not None:
        worst["grad"] = max(g_ref, key=lambda k: _rel(
            g_prog[k] - g_ref[k], max(g_ref[k], g_med)))
        worst["change"] = max(moved, key=lambda k: _rel(
            d_prog[k] - d_ref[k], max(d_ref[k], d_med)), default=None)
    return loss_gap, grad_gap, change_gap


def _rel(gap: float, scale: float) -> float:
    """|gap| / scale; where the reference's scale is 0 (no ray of the
    step reaches the leaf), 0 for no gap and infinity for any."""
    if scale > 0:
        return abs(gap) / scale
    return 0.0 if gap == 0 else math.inf


def run(cell, seed, seconds, trace, device, t_start, sizes):
    from yocto_raytracing_tpu_torch import kernels
    from yocto_raytracing_tpu_torch.parallel import mesh

    p = {**cell.config["render"], **cell.traffic, **sizes}
    loaded = common.load_config_scene(
        dict(cell.config, render=dict(cell.config["render"],
                                      resolution=p["resolution"])), device)
    loaded_s = time.time() - t_start
    width, height = loaded.width, loaded.height
    spp = p["samples"] ** 2
    n, lr, names = p["rays"], p["lr"], p["trainable"]
    offs = offsets(width * height * spp, n, p, seed)
    per_ray = target_image(width, height, p, device).repeat_interleave(
        spp, dim=0)
    base = torch.arange(n, dtype=torch.int32, device=device)
    amb = torch.full((3,), p["ambient"], device=device)
    kw = dict(width=width, height=height, samples=p["samples"],
              max_depth=p["max_depth"], trainable=names)

    def feed(s):
        off = int(offs[s % len(offs)])
        return base + off, per_ray[off:off + n]

    def step(scene, s):
        return mesh.train_step(scene, *feed(s), amb, lr, **kw)

    scene = loaded.scene
    p0 = trained(scene, names)
    scene, loss = step(scene, 0)              # the capture
    start = dict(losses=[float(loss)], p0=p0, p1=trained(scene, names))
    start["last"] = start["p1"]
    for s in range(1, p["warm_steps"] + 1):   # hits
        scene, _ = step(scene, s)
    setup_s = time.time() - t_start

    first = p["warm_steps"] + 1
    j = int(np.random.default_rng([seed, 5]).integers(p["check_within"]))
    win = dict(losses=[])

    def timed_step(k, scene):
        """Step ``k`` of the window, keeping what the checked steps ``j``
        and ``j + 1`` left."""
        if k == j:
            win["p0"] = trained(scene, names)
        scene, loss = step(scene, first + k)
        if k in (j, j + 1):
            win["losses"].append(loss.detach().clone())
            win["p1" if k == j else "last"] = trained(scene, names)
        return scene, loss

    t0 = time.perf_counter()
    k = 0
    logged = []
    while True:
        scene, loss = timed_step(k, scene)
        k += 1
        if k % p["loss_every"] == 0:
            logged.append(float(loss))
        if time.perf_counter() - t0 >= seconds:
            break
    common.sync(device)
    elapsed = time.perf_counter() - t0
    t_window = time.perf_counter()
    steps_run = k
    while k <= j + 1:      # a window too short for the checked steps
        scene, _ = timed_step(k, scene)
        k += 1
    win["losses"] = [float(x) for x in win["losses"]]
    mem = (torch.cuda.max_memory_allocated(device)
           if torch.device(device).type == "cuda" else 0)
    metrics = dict(step_Mrays_s=steps_run * n / elapsed / 1e6,
                   setup_s=setup_s)

    data = None
    if trace:
        state = {"scene": scene, "next": first + k}

        def window(count):
            recs = []
            for _ in range(count):
                s = state["next"]
                state["scene"], _ = step(state["scene"], s)
                last = kernels.last_step()
                recs.append((s, sum(last["host_ms"].values()),
                             int(last["ran"][:-1].sum())))
                state["next"] += 1
            return recs

        prof = traced(window, p["trace_steps"],
                      lambda recs: {"shade_bwd_kernel": sum(r[2]
                                                            for r in recs)},
                      p["name_steps"])
        data = _trace_data(prof, loaded, p, offs, width, height, seed, device)

    host = loaded.host
    del loaded, scene
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref_scene, _, _ = common.reference_scene(host, device)
    feeds = {"start": [feed(0)],
             "window": [feed(first + j), feed(first + j + 1)]}
    starts = {"start": None, "window": win["p0"]}
    prog = {"start": start, "window": win}

    def reference(which, dtype=None, half=False):
        fd = feeds[which]
        if half:
            fd = [(ids[:len(ids) // 2], t[:len(ids) // 2]) for ids, t in fd]
        losses, first_g, p1, last = reference_steps(
            ref_scene, fd, p, width, height, lr, dtype, starts[which])
        p_before = (trained(ref_scene, list(first_g)) if which == "start"
                    else {k: v.float() for k, v in win["p0"].items()})
        return dict(losses=losses, first=first_g, p1=p1, last=last,
                    p0={k: v.float().to(p1[k].device)
                        for k, v in p_before.items()})

    ref = {w: reference(w) for w in feeds}
    worst: dict = {}
    lim = cell.limits

    def compare(sides) -> dict:
        """The numbers compared, each with its limit, of ``sides`` (the
        start's and the window's steps) against the reference's."""
        both = [gaps(sides[w], ref[w], lr,
                     worst.setdefault(w, {}) if sides is prog else None)
                for w in feeds]
        return {name: (max(g[i] for g in both), lim[name]) for i, name in
                enumerate(("loss_gap", "grad_gap", "change_gap"))}

    compared = compare(prog)
    notes = {"phases_s": dict(
        loaded=loaded_s, setup=setup_s, window=t_window - t0,
        trace=t_ref - t_window, reference=time.perf_counter() - t_ref),
             "checked_window_step": j,
             "last_logged_loss": logged[-1] if logged else None,
             "worst_leaf": worst}
    if p.get("control"):
        # the reference in a lower precision in the program's place, and
        # the faults of a training step planted in the reference: half the
        # batch left out (the mean over the rest), and the state left
        # unchanged (every step returns the leaves it was given)
        dt = getattr(torch, p["control"])
        planted = {
            "control": {w: reference(w, dtype=dt) for w in feeds},
            "fault_half_batch": {w: reference(w, half=True) for w in feeds},
            "fault_unchanged": {w: dict(ref[w], p1=ref[w]["p0"],
                                        last=ref[w]["p0"]) for w in feeds}}
        for name, sides in planted.items():
            c = compare(sides)
            notes[name] = dict({k: v for k, (v, _) in c.items()},
                               correct=correct(c))
    return Outcome(metrics=metrics, attempted=steps_run, failed=0,
                   compared=compared, memory_peak_bytes=int(mem), trace=data,
                   notes=notes)


def _trace_data(prof, loaded, p, offs, width, height, seed, device):
    recs = prof.records
    n_steps = len(recs)
    n = p["rays"]
    host = loaded.host

    def hit_counts():
        """The plain walk's work on ``walk_rays`` rays drawn from the seed
        among every traced step's, scaled to every ray of every traced step
        (on the scene as generated: the steps move its leaves a little, and
        never its BVH)."""
        rng = np.random.default_rng([seed, 4])
        ref_scene, _, _ = common.reference_scene(host, device)
        amb = torch.full((3,), p["ambient"], device=device)
        per = max(1, p["walk_rays"] // n_steps)
        ids = np.concatenate([
            np.sort(rng.choice(n, per, replace=False))
            + int(offs[r[0] % len(offs)]) for r in recs])
        stats: dict = {}
        ref_render.trace_rays(ref_scene, torch.as_tensor(
            ids, dtype=torch.int32, device=device), amb, width, height,
            p["samples"], p["max_depth"], stats=stats)
        scale = n / per
        return {q: {k: v * scale for k, v in c.items()}
                for q, c in stats.items()}

    leaves = common.reference_scene(host, "cpu")[2]
    return TraceData(prof, torch.cuda.get_device_name(0)
                     if torch.device(device).type == "cuda" else "cpu",
                     n_steps, {
        "host_ms": [r[1] for r in recs],
        "hit_counts": hit_counts,
        "hit_leaves_bytes": n_steps * common.leaves_bytes(
            leaves, common.HIT_LEAVES),
        "shade_lanes": sum(r[2] for r in recs) * n,
        "shade_leaves_bytes": n_steps * common.leaves_bytes(
            leaves, common.SHADE_LEAVES),
    })
