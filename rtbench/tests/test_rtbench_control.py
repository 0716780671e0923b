"""``correct`` comes out false where it should, on the CPU at small sizes:
for the control (the plain reference computed in bfloat16, the precision
below the configurations' float32, put in the program's place), and for
a full run whose timed path is broken underneath, once for each fault the
cell can have: an answer altered where it is produced (frames, queries),
a stale frame, a step that returns its state unchanged, half of the batch
left out."""

from __future__ import annotations

import time

import pytest
import torch

from rtbench.core import runner, spec


def _run(workload, small, seed=2**31 + 3, **extra):
    cell = spec.cell(workload)
    return cell, runner.run_cell(cell, seed, 0.01, False, "cpu", time.time(),
                                 dict(small[cell.kind], **extra))


@pytest.mark.parametrize("workload", ["lines.frame", "refl.frame",
                                      "lines.overlap", "refl.train"])
def test_control_fails(workload, small):
    """The run itself is correct; the control, and each fault planted in
    the reference, is not, as ``runner.correct`` decides it against the
    cell's limits."""
    _, out = _run(workload, small, control="bfloat16")
    assert runner.correct(out.compared), out.compared
    planted = {k: v for k, v in out.notes.items()
               if isinstance(v, dict) and "correct" in v}
    assert "control" in planted
    if workload.endswith(".train"):
        assert {"fault_half_batch", "fault_unchanged"} <= planted.keys()
    assert not any(v["correct"] for v in planted.values()), planted


def _broken_frames(monkeypatch, how):
    from yocto_raytracing_tpu_torch.render import renderer

    real = renderer.render_image
    last = []

    def render_image(*args, **kw):
        img = real(*args, **kw)
        if how == "stale":          # the previous frame's image again
            last.append(img.copy())
            return last[-2] if len(last) > 1 else img
        out = img.copy()            # every pixel a few steps brighter
        out[..., :3] = (out[..., :3].astype(int) + 3).clip(0, 255)
        return out

    monkeypatch.setattr(renderer, "render_image", render_image)


@pytest.mark.parametrize("how", ["altered", "stale"])
def test_broken_frames_are_not_correct(monkeypatch, small, how):
    _broken_frames(monkeypatch, how)
    small = dict(small, frames=dict(small["frames"], warm_hits=1))
    _, out = _run("lines.frame", small)
    assert not runner.correct(out.compared), out.compared


@pytest.mark.parametrize("how", ["dist", "prim"])
def test_broken_queries_are_not_correct(monkeypatch, small, how):
    from yocto_raytracing_tpu_torch.ops import overlap

    real = overlap.overlap_scene

    def overlap_scene(*args, **kw):
        out = dict(real(*args, **kw))
        if how == "dist":
            out["dist"] = torch.where(out["found"], out["dist"] + 1e-3,
                                      out["dist"])
        else:
            out["prim"] = torch.where(out["found"], out["prim"] + 1,
                                      out["prim"])
        return out

    monkeypatch.setattr(overlap, "overlap_scene", overlap_scene)
    _, out = _run("lines.overlap", small)
    assert not runner.correct(out.compared), out.compared


@pytest.mark.parametrize("how", ["unchanged", "half_batch"])
def test_broken_steps_are_not_correct(monkeypatch, small, how):
    from yocto_raytracing_tpu_torch.parallel import mesh

    real = mesh.train_step

    def train_step(scene, ids, target, *args, **kw):
        if how == "unchanged":
            _, loss = real(scene, ids, target, *args, **kw)
            return scene, loss
        half = ids.shape[0] // 2
        return real(scene, ids[:half], target[:half], *args, **kw)

    monkeypatch.setattr(mesh, "train_step", train_step)
    _, out = _run("refl.train", small)
    assert not runner.correct(out.compared), out.compared
