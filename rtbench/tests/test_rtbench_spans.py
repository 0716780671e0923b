"""The readers of the program's spans, on hand-made spans (the window they
read among a traced run's windows, the value of a request), and on the
spans of a small frame, step and query on the CPU."""

from __future__ import annotations

import sys
from types import SimpleNamespace

import pytest
import torch

from rtbench.core import spans, spec
from rtbench.core.profile import PAD_S


def _span(name, start, end, id, parent=None, request=None, **attrs):
    return SimpleNamespace(name=name, start_ns=start * 1000,
                           end_ns=end * 1000, id=id, parent=parent,
                           request=id if request is None else request,
                           attrs=attrs)


def _frame(first_id, t0, entry_us, loop_us, copy_us, image_us, hit=1):
    """A render_image request: root, frame_device (a key stage inside),
    to_host (pinned and copy inside), image; times in us."""
    r = first_id
    t_loop = t0 + entry_us
    t_host = t_loop + loop_us
    t_img = t_host + 2 + copy_us
    end = t_img + image_us
    return [
        _span("render_image", t0, end, r),
        _span("frame_device", t_loop, t_host, r + 1, r, r, hit=hit),
        _span("key", t_loop, t_loop + 5, r + 2, r + 1, r),
        _span("to_host", t_host, t_img, r + 3, r, r),
        _span("pinned", t_host, t_host + 2, r + 4, r + 3, r),
        _span("copy", t_host + 2, t_img, r + 5, r + 3, r),
        _span("image", t_img, end, r + 6, r, r),
    ]


FRAMES = (_frame(1, 0, 100, 2000, 4000, 900, hit=0)
          + _frame(10, 10_000, 300, 2100, 3000, 800)
          + _frame(20, 20_000, 200, 1900, 5000, 1000))


def test_entry_self_time_is_the_root_less_its_children():
    # 100, 300 and 200 us outside the children: the median 200 us
    assert spans.self_ms(FRAMES, "render_image") == pytest.approx(0.2)
    assert spans.self_ms(FRAMES, "train_step") is None
    assert spans.self_ms([], "render_image") is None


def test_to_host_is_the_median_copy_of_a_request():
    # 2 + 4000, 2 + 3000, 2 + 5000 us
    assert spans.part_ms(FRAMES, "render_image", "to_host") == \
        pytest.approx(4.002)
    # a to_host outside a frame's request is not a frame's
    stray = _span("to_host", 90_000, 99_000, 50)
    assert spans.part_ms(FRAMES + [stray], "render_image", "to_host") == \
        pytest.approx(4.002)


def test_misses_are_the_share_of_loop_spans_with_hit_zero():
    assert spans.miss_percent(FRAMES, "frame_device") == \
        pytest.approx(100 / 3)
    hits = [s for s in FRAMES if s.id >= 10]
    assert spans.miss_percent(hits, "frame_device") == 0.0
    assert spans.miss_percent(FRAMES, "loss_grads_device") is None


def test_root_ms_is_the_whole_call():
    calls = [_span("overlap_scene", 0, 1500, 1),
             _span("walk", 100, 1400, 2, 1, 1),
             _span("overlap_scene", 2000, 3700, 3),
             _span("overlap_scene", 4000, 5600, 4)]
    assert spans.root_ms(calls, "overlap_scene") == pytest.approx(1.6)


def _roots(first_id, t0_us, n, us=1000):
    """``n`` requests of ``us`` each, back to back from ``t0_us``."""
    return [_span("render_image", t0_us + k * us, t0_us + (k + 1) * us - 1,
                  first_id + k) for k in range(n)]


def test_measured_is_the_last_window_before_the_host_traced_one():
    """A traced run's windows: 2 warm-up requests, a device-only window of
    4 that lost events, its second attempt, then 3 traced on the host too;
    each window apart by its pads. The readers take the second attempt."""
    pad = int(PAD_S * 1e6)                       # us
    warm = _roots(1, 0, 2)
    first = _roots(10, 2 * pad + 2000, 4)
    kept = _roots(20, 4 * pad + 6000, 4)
    kept_child = _span("to_host", 4 * pad + 6100, 4 * pad + 6200, 90, 20, 20)
    host = _roots(30, 6 * pad + 10_000, 3)
    run = warm + first + kept + [kept_child] + host
    got = spans.measured(run, 4)
    assert [s.id for s in got] == [20, 21, 22, 23, 90]
    # a gap inside a window shorter than a pad does not split it
    slow = (_roots(20, 4 * pad + 6000, 2)
            + _roots(22, 4 * pad + 8000 + pad // 2, 2))
    run2 = warm + first + slow + host
    assert [s.id for s in spans.measured(run2, 4)] == [20, 21, 22, 23]
    # one window, no gap: its last requests
    assert [s.id for s in spans.measured(first, 3)] == [11, 12, 13]
    assert spans.measured([], 4) == []
    trace = SimpleNamespace(requests=4)
    assert spans.root_ms(spans.measured(run, trace.requests),
                         "render_image") == pytest.approx(0.999)


def test_a_program_without_the_tracer_reads_nothing(monkeypatch):
    import yocto_raytracing_tpu_torch.utils as utils

    monkeypatch.delattr(utils, "tracer", raising=False)
    monkeypatch.setitem(sys.modules,
                        "yocto_raytracing_tpu_torch.utils.tracer", None)
    trace = SimpleNamespace(requests=4)
    assert spans.program_spans(trace) is None
    for name in ("entry_host_ms.frame", "to_host_ms.frame",
                 "loop_misses.frame", "entry_host_ms.step",
                 "loop_misses.step", "entry_host_ms.query"):
        assert spec.metric_reader(name).read(trace) is None


def test_readers_on_the_port_s_spans():
    """A frame, a step and a query of the port on the CPU, recorded back to
    back as one window of 5 requests: each reader finds its spans, the
    loops' second calls hit."""
    from yocto_raytracing_tpu_torch import scene as scene_lib, testscenes
    from yocto_raytracing_tpu_torch.ops import overlap
    from yocto_raytracing_tpu_torch.parallel import mesh
    from yocto_raytracing_tpu_torch.render import renderer
    from yocto_raytracing_tpu_torch.utils import tracer

    leaves, meta = scene_lib.build_device_scene(testscenes.make_hair_scene(8))
    ts = scene_lib.to_torch(leaves, "cpu")
    ids = torch.arange(64, dtype=torch.int32)
    target = torch.full((64, 3), 0.5)
    amb = torch.full((3,), 0.1)
    renderer._frames.clear()
    renderer._steps.clear()
    tracer.clear()
    with tracer.recording():
        for _ in range(2):
            renderer.render_image(ts, meta, 8, 8, 1, ldr=True, max_depth=2)
            mesh.train_step(ts, ids, target, amb, 0.5, width=8, height=8,
                            samples=1, max_depth=2, trainable=["mat_kd"])
        overlap.overlap_scene(ts, meta, torch.zeros((4, 3)), 0.1)
    trace = SimpleNamespace(requests=5)
    try:
        for name in ("entry_host_ms.frame", "to_host_ms.frame",
                     "entry_host_ms.step", "entry_host_ms.query"):
            value = spec.metric_reader(name).read(trace)
            assert value is not None and value >= 0, name
        for name in ("loop_misses.frame", "loop_misses.step"):
            assert spec.metric_reader(name).read(trace) == 50.0
    finally:
        tracer.clear()
