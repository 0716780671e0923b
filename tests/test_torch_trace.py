"""The port's spans (``utils/tracer.py``) and what reads them.

On the CPU:

* under ``torch.profiler`` (CPU activity) ``render_image`` leaves its
  spans, nested as the program opens them, and each lies on the
  profiler's clock, within the profiler's event of its name (a
  device-loop stage too, whose clock readings the loop's record shares);
* with no profiler and no ``recording()`` block nothing is recorded, no
  clock is read and nothing is allocated;
* a span's self time is its duration less its children's;
* ``render_image``'s ``host_rgba`` is 0 where the image is K3's copied
  RGBA buffer, 1 where the host made a pass over the pixels;
* the loop span's ``hit`` is the record's ``cache_hit``, and the record's
  ``host_ms`` are the stage spans' durations, frames and steps alike;
* the loop span's ``k1_ident`` is the scene's share of identity instance
  frames, counted once when the entry is built;
* the ring keeps the last ``RING`` requests;
* ``train_step``, ``overlap_scene`` and ``log_phase`` leave their spans,
  the loop's first form none; the dead-bounce tally runs only inside
  ``recording()`` (not under a profiler alone), and its reader refuses a
  tally that lacks a frame or step run on the card outside it.

On the card (marker ``cuda``): the copy to the host's spans, the capture
stage of a miss, ``overlap_scene``'s stages, the tally inside
``recording()`` and its reader's refusal after a frame outside it. The
file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_trace.py
"""

import itertools
import tracemalloc

import numpy as np
import pytest
import torch

from torch_card import cuda_device  # noqa: F401  (fixture)
from yocto_raytracing_tpu_torch import kernels, scene as scene_lib, testscenes
from yocto_raytracing_tpu_torch.kernels import _build
from yocto_raytracing_tpu_torch.ops import overlap
from yocto_raytracing_tpu_torch.parallel import mesh
from yocto_raytracing_tpu_torch.render import renderer
from yocto_raytracing_tpu_torch.utils import log_phase, tracer

# 96 pixels in chunks of 40: two whole chunks and a tail (CPU)
W, H, SAMPLES, DEPTH, CHUNK = 12, 8, 1, 2, 40
# the profiler stamps its host events from a cycle counter converted to
# the wall clock: a few hundred ns apart from a clock read at most
CLOCK_NS = 1000


@pytest.fixture(autouse=True)
def _empty_ring():
    tracer.clear()
    renderer._frames.clear()
    renderer._steps.clear()
    yield
    tracer.clear()


def _frame_case(device="cpu"):
    leaves, meta = scene_lib.build_device_scene(testscenes.make_hair_scene(8))
    return scene_lib.to_torch(leaves, device), meta


def _render(ts, meta, **kw):
    return renderer.render_image(ts, meta, W, H, SAMPLES, ldr=True,
                                 max_depth=DEPTH, chunk_pixels=CHUNK, **kw)


def _step_case(device="cpu"):
    leaves, meta = scene_lib.build_device_scene(testscenes.make_grad_scene())
    ts = scene_lib.to_torch(leaves, device)
    n = W * H
    ids = torch.arange(n, dtype=torch.int32, device=device)
    target = torch.full((n, 3), 0.5, dtype=torch.float32, device=device)
    amb = torch.full((3,), 0.1, dtype=torch.float32, device=device)
    return ts, meta, ids, target, amb


def _step(ts, ids, target, amb):
    return mesh.train_step(ts, ids, target, amb, 0.5, width=W, height=H,
                           samples=SAMPLES, max_depth=DEPTH,
                           trainable=["mat_kd", "light_ke"])


def _tree(spans):
    """{span id: (name, [child names in order])}."""
    out = {s.id: (s.name, []) for s in spans}
    for s in spans:
        if s.parent is not None:
            out[s.parent][1].append(s.name)
    return out


def _named(spans, name):
    return [s for s in spans if s.name == name]


def _children(spans, span):
    return [s for s in spans if s.parent == span.id]


def test_render_image_spans_nest_on_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile

    ts, meta = _frame_case()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):     # a miss, then a hit
            _render(ts, meta)
    spans = tracer.spans()
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["render_image"] * 2
    tree = _tree(spans)
    for root, loop in zip(roots, ("entry", None)):
        assert tree[root.id][1] == ["frame_device", "to_host", "image"]
        (dev,) = [s for s in _children(spans, root)
                  if s.name == "frame_device"]
        want = ["key", "entry", "stage", "replay"]
        if loop is None:
            want.remove("entry")
        assert tree[dev.id][1] == want
        for s in spans:
            if s.request == root.request:
                assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
    # the shared clock: the profiler's events of each span's name
    t0 = prof.profiler.kineto_results.trace_start_ns()
    events = prof.events()
    for name in {s.name for s in spans}:
        ev = sorted((e for e in events if e.name == name),
                    key=lambda e: e.time_range.start)
        mine = _named(spans, name)
        assert len(ev) == len(mine), name
        for s, e in zip(mine, ev):
            lo = t0 + round(e.time_range.start * 1e3)
            hi = t0 + round(e.time_range.end * 1e3)
            # read inside the annotation
            assert lo - CLOCK_NS <= s.start_ns <= s.end_ns <= \
                hi + CLOCK_NS, (name, s, lo, hi)


def test_nothing_recorded_when_off(capsys):
    ts, meta = _frame_case()
    _render(ts, meta)
    ts2, _, ids, target, amb = _step_case()
    _step(ts2, ids, target, amb)
    overlap.overlap_scene(ts, meta, torch.zeros((4, 3)), 0.1)
    with log_phase("phase"):
        pass
    assert not tracer.in_recording()
    assert tracer.spans() == []
    assert kernels.last_frame()["host_ms"]["setup"] > 0   # the record is


def test_off_reads_no_clock_and_allocates_nothing(monkeypatch):
    def no_clock():
        raise AssertionError("the clock was read")

    monkeypatch.setattr(tracer, "clock", no_clock)
    assert tracer.begin("x") is None
    tracer.end(None)
    tracer.note(None, "hit", 1)
    tracemalloc.start()
    try:
        pairs = itertools.repeat(None, 10000)
        _, before = tracemalloc.get_traced_memory()
        tracemalloc.reset_peak()
        for _ in pairs:
            tracer.end(tracer.begin("x"))
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert peak - before == 0
    assert tracer.spans() == []


def test_self_time_is_the_span_less_its_children():
    """Children lie inside their parent, one after another, so a span's
    self time (its duration less its children's) is the part of it that
    no child covers; a grandchild counts in its own parent only."""
    with tracer.recording():
        outer = tracer.begin("outer")
        a = tracer.begin("a")
        a1 = tracer.begin("a1")
        tracer.end(a1)
        tracer.end(a)
        b = tracer.begin("b")
        tracer.end(b)
        tracer.end(outer)
    spans = tracer.spans()
    assert [s.name for s in spans] == ["outer", "a", "a1", "b"]
    assert a1.parent == a.id and b.parent == a.parent == outer.id
    assert {s.request for s in spans} == {outer.id}
    for parent in spans:
        kids = _children(spans, parent)
        bounds = [parent.start_ns] + [t for k in kids
                                      for t in (k.start_ns, k.end_ns)] + [
            parent.end_ns]
        assert bounds == sorted(bounds)   # inside, one after another
        uncovered = sum(bounds[i + 1] - bounds[i]
                        for i in range(0, len(bounds), 2))
        assert uncovered == parent.ns - sum(k.ns for k in kids) >= 0


def test_end_closes_what_is_left_open_inside():
    """A span left open inside another (an exception between its begin and
    end) closes with it, at the same reading."""
    with tracer.recording():
        outer = tracer.begin("outer")
        inner = tracer.begin("inner")
        tracer.end(outer)
        tracer.end(inner)       # already closed: nothing
        nxt = tracer.begin("next")
        tracer.end(nxt)
    assert inner.end_ns == outer.end_ns
    assert nxt.parent is None and nxt.request == nxt.id


@pytest.mark.parametrize("which", ["frame", "step"])
def test_loop_span_hit_and_host_ms_are_the_records(which):
    """The loop span's ``hit`` is ``cache_hit``; ``host_ms`` is the stage
    spans' durations (setup: key, entry and stage), miss and hit."""
    if which == "frame":
        ts, meta = _frame_case()
        call, loop, last = (lambda: _render(ts, meta), "frame_device",
                            kernels.last_frame)
    else:
        ts, _, ids, target, amb = _step_case()
        call, loop, last = (lambda: _step(ts, ids, target, amb),
                            "loss_grads_device", kernels.last_step)
    with tracer.recording():
        for _ in range(2):
            tracer.clear()
            call()
            spans = tracer.spans()
            (sp,) = _named(spans, loop)
            rec = last()
            assert sp.attrs["hit"] == int(rec["cache_hit"])
            ns = {s.name: s.ns for s in _children(spans, sp)}
            assert ("entry" in ns) is not rec["cache_hit"]
            host = rec["host_ms"]
            assert host["setup"] == sum(
                ns.get(k, 0) for k in ("key", "entry", "stage")) / 1e6
            assert host["capture"] == ns.get("capture", 0) / 1e6 == 0.0
            assert host["replay"] == ns["replay"] / 1e6
            assert host.get("chunk0", 0.0) == 0.0
    assert rec["cache_hit"]


@pytest.mark.parametrize("which", ["frame", "step"])
@pytest.mark.parametrize("make,share", [
    (lambda: testscenes.make_hair_scene(8), 1.0),
    (testscenes.make_mixed_frame_scene, 5 / 12)], ids=["hair", "mixed"])
def test_loop_span_notes_k1_ident(monkeypatch, which, make, share):
    """The loop span carries ``k1_ident``, the share of the scene's
    instances whose frame words are the identity's bits, on a miss and on
    a hit; it is counted once, when the entry is built, so a hit reads
    nothing for it."""
    from yocto_raytracing_tpu_torch.ops import hit_records

    counted = []
    real = hit_records.identity_share

    def identity_share(scene):
        counted.append(1)
        return real(scene)

    monkeypatch.setattr(hit_records, "identity_share", identity_share)
    leaves, meta = scene_lib.build_device_scene(make())
    ts = scene_lib.to_torch(leaves, "cpu")
    if which == "frame":
        call, loop = (lambda: _render(ts, meta)), "frame_device"
    else:
        n = W * H
        ids = torch.arange(n, dtype=torch.int32)
        target = torch.full((n, 3), 0.5, dtype=torch.float32)
        amb = torch.full((3,), 0.1, dtype=torch.float32)
        call, loop = (lambda: mesh.train_step(
            ts, ids, target, amb, 0.5, width=W, height=H, samples=SAMPLES,
            max_depth=DEPTH, trainable=["mat_kd"])), "loss_grads_device"
    with tracer.recording():
        for _ in range(2):     # a miss, then a hit
            call()
    sps = _named(tracer.spans(), loop)
    assert [sp.attrs["hit"] for sp in sps] == [0, 1]
    for sp in sps:
        assert isinstance(sp.attrs["k1_ident"], float)
        assert sp.attrs["k1_ident"] == share
    assert len(counted) == 1


@pytest.mark.parametrize("mode,host_rgba", [
    ("ldr", 0), ("hdr", 1), ("ldr checkpointed", 1)])
def test_render_image_notes_host_rgba(tmp_path, mode, host_rgba):
    """``render_image``'s ``host_rgba`` is 0 where the image is K3's copied
    RGBA buffer, 1 where the host made a pass over the pixels (f32 sums,
    the checkpointed path's host tonemap); the ``image`` span is there
    either way."""
    ts, meta = _frame_case()
    kw = dict(ldr=mode != "hdr", max_depth=DEPTH, chunk_pixels=CHUNK)
    if mode == "ldr checkpointed":
        kw["checkpoint"] = str(tmp_path / "ck.npz")
    with tracer.recording():
        renderer.render_image(ts, meta, W, H, SAMPLES, **kw)
    spans = tracer.spans()
    (root,) = _named(spans, "render_image")
    assert root.attrs == {"host_rgba": host_rgba}
    assert [s.name for s in _children(spans, root)][-1] == "image"


def test_first_form_records_no_spans():
    """``_frame_device_first`` (for ``chip_smoke.py`` and the tests) opens
    no span, and still leaves its record."""
    ts, meta = _frame_case()
    with tracer.recording():
        renderer._frame_device_first(ts, meta, W, H, SAMPLES,
                                     max_depth=DEPTH, chunk_pixels=CHUNK)
    assert tracer.spans() == []
    host = kernels.last_frame()["host_ms"]
    assert list(host) == ["setup", "chunk0", "capture", "replay"]
    assert host["chunk0"] > 0 and host["capture"] == 0.0


def test_off_stages_share_one_reading_a_boundary(monkeypatch):
    """With spans off, a boundary between two stages is one clock reading:
    the stages' milliseconds sum to the last reading less the first."""
    readings = iter(range(0, 10**9, 10**6 + 7))
    monkeypatch.setattr(tracer, "clock", lambda: next(readings))
    st = tracer.Stages("a")
    assert st.next("b") is None
    st.next("a")
    st.stop()
    assert st.ms("a") == 2 * (10**6 + 7) / 1e6
    assert st.ms("a", "b") == 3 * (10**6 + 7) / 1e6
    assert st.ms("c") == 0.0


def test_ring_keeps_the_last_requests():
    with tracer.recording():
        for _ in range(tracer.RING + 44):
            root = tracer.begin("root")
            tracer.end(tracer.begin("child"))
            tracer.end(root)
    spans = tracer.spans()
    roots = [s for s in spans if s.parent is None]
    assert len(roots) == tracer.RING and len(spans) == 2 * tracer.RING
    assert roots[-1].id == root.id
    assert {s.request for s in spans} == {r.id for r in roots}
    assert [r.id for r in roots] == sorted(r.id for r in roots)


def test_train_step_spans():
    ts, _, ids, target, amb = _step_case()
    with tracer.recording():
        new, loss = _step(ts, ids, target, amb)
    spans = tracer.spans()
    tree = _tree(spans)
    (root,) = [s for s in spans if s.parent is None]
    assert root.name == "train_step"
    assert tree[root.id][1] == ["partition_scene", "loss_grads_device",
                                "combine_scene"]
    (loop,) = _named(spans, "loss_grads_device")
    assert tree[loop.id][1] == ["key", "entry", "stage", "replay"]
    assert np.isfinite(float(loss))


def test_overlap_scene_and_log_phase_spans(capsys):
    ts, meta = _frame_case()
    with tracer.recording():
        overlap.overlap_scene(ts, meta, torch.zeros((4, 3)), 0.1)
        with log_phase("building bvh + device scene"):
            pass
    assert [s.name for s in tracer.spans()] == [
        "overlap_scene", "building bvh + device scene"]
    err = capsys.readouterr().err
    assert "building bvh + device scene..." in err
    assert "building bvh + device scene done in " in err


def test_dead_bounce_tally_runs_only_inside_recording(monkeypatch):
    """Untraced and under a profiler alone the tally stays off the path;
    inside ``recording()`` every frame's and step's bounces join it."""
    from torch.profiler import ProfilerActivity, profile

    tallied = []
    monkeypatch.setattr(_build, "_tally",
                        lambda ran, slot: tallied.append(slot))
    ts, meta = _frame_case()
    ts2, _, ids, target, amb = _step_case()
    _render(ts, meta)
    _step(ts2, ids, target, amb)
    with profile(activities=[ProfilerActivity.CPU]):
        _render(ts, meta)
        _step(ts2, ids, target, amb)
    assert tallied == []
    with tracer.recording():
        _render(ts, meta)
        _step(ts2, ids, target, amb)
    lights = [int(t.light_ke.shape[0] > 0) for t in (ts, ts2)]
    assert tallied == [lights[0], 2 + lights[1]]   # a frame's slot, a step's


def test_skipped_launches_refuses_an_untallied_frame(monkeypatch):
    """A frame or step on the card outside ``recording()`` since the last
    reset leaves the tally short: its readers raise until the next reset.
    (The CPU's loop launches nothing it skips: it is never untallied.)"""
    ts, meta = _frame_case()
    kernels.reset_launches()
    _render(ts, meta)
    assert kernels.skipped_launches()["bounces"] == 0
    monkeypatch.setattr(_build, "_untallied", 1)
    with pytest.raises(RuntimeError, match="outside tracer.recording"):
        kernels.skipped_launches()
    with pytest.raises(RuntimeError, match="outside tracer.recording"):
        kernels.made_launches()
    kernels.reset_launches()
    assert kernels.made_launches() == kernels.launches


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.mark.cuda
def test_card_spans(cuda_device):
    """The copy to the host's spans, a miss's capture stage, K11's call's
    stages, the dead bounces tallied inside ``recording()``, and their
    reader's refusal after a frame outside it."""
    ts, meta = _frame_case(cuda_device)
    kernels.reset_launches()
    with tracer.recording():
        for _ in range(2):
            _render(ts, meta)
        pos = torch.rand((256, 3), device=cuda_device)
        overlap.overlap_scene(ts, meta, pos, 0.1)
        torch.cuda.synchronize()
    spans = tracer.spans()
    tree = _tree(spans)
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["render_image"] * 2 + [
        "overlap_scene"]
    for root, miss in zip(roots, (True, False)):
        assert tree[root.id][1] == ["frame_device", "to_host", "image"]
        dev, host, _ = _children(spans, root)
        assert tree[dev.id][1] == (
            ["key", "entry", "stage", "capture", "replay"] if miss
            else ["key", "stage", "replay"])
        assert dev.attrs["hit"] == int(not miss)
        assert tree[host.id][1] == ["pinned", "copy"]
    assert tree[roots[2].id][1] == ["check", "refit", "outputs", "walk"]
    ran = kernels.last_frame()["ran"]
    dead = 2 * (ran.shape[0] * DEPTH - int(ran[:, :-1].sum()))
    assert kernels.skipped_launches()["bounces"] == dead
    _render(ts, meta)   # outside recording(): untallied
    with pytest.raises(RuntimeError, match="outside tracer.recording"):
        kernels.skipped_launches()
    kernels.reset_launches()
