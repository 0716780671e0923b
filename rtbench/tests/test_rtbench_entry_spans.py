"""The readers of the entry's image: the ``image`` span of ``render_image``
and its ``host_rgba`` counter, on hand-made spans, on a program without the
tracer, and on the spans of small frames of the port on the CPU."""

from __future__ import annotations

import sys
from types import SimpleNamespace

import pytest
import torch

from rtbench.core import spans, spec


def _span(name, start, end, id, parent=None, request=None, **attrs):
    return SimpleNamespace(name=name, start_ns=start * 1000,
                           end_ns=end * 1000, id=id, parent=parent,
                           request=id if request is None else request,
                           attrs=attrs)


def _frames(*flags, image_us=(900, 800, 1000)):
    """render_image roots, each with an ``image`` child of the given us;
    ``host_rgba`` on the root as given (None: no attribute, as a program
    without the counter leaves them)."""
    out = []
    for k, flag in enumerate(flags):
        t0 = 10_000 * k
        root = _span("render_image", t0, t0 + 5000, 1 + 2 * k)
        if flag is not None:
            root.attrs["host_rgba"] = flag
        img = image_us[k % len(image_us)]
        out += [root, _span("image", t0 + 5000 - img, t0 + 5000, 2 + 2 * k,
                            1 + 2 * k, 1 + 2 * k, host_rgba=1)]
    return out


def test_image_is_the_median_image_span_of_a_frame():
    # 900, 800 and 1000 us
    assert spans.part_ms(_frames(0, 0, 0), "render_image", "image") == \
        pytest.approx(0.9)
    # an image outside a frame's request is not a frame's
    stray = _span("image", 90_000, 99_000, 50)
    assert spans.part_ms(_frames(0, 0, 0) + [stray], "render_image",
                         "image") == pytest.approx(0.9)


@pytest.mark.parametrize("flags,want", [
    ((0, 0, 0), 0.0), ((1, 0, 0, 0), 25.0), ((1, 1), 100.0),
    ((None, None), None), ((), None)])
def test_host_rgba_is_the_share_of_frames_with_a_host_pass(
        monkeypatch, flags, want):
    monkeypatch.setattr(spans, "program_spans",
                        lambda trace: _frames(*flags))
    got = spec.metric_reader("host_rgba.frame").read(None)
    assert got == want if want is None else got == pytest.approx(want)


@pytest.mark.parametrize("name", ["image_ms.frame", "host_rgba.frame"])
def test_a_program_without_the_tracer_reads_nothing(monkeypatch, name):
    import yocto_raytracing_tpu_torch.utils as utils

    monkeypatch.delattr(utils, "tracer", raising=False)
    monkeypatch.setitem(sys.modules,
                        "yocto_raytracing_tpu_torch.utils.tracer", None)
    trace = SimpleNamespace(requests=4)
    assert spec.metric_reader(name).read(trace) is None


def test_readers_on_the_port_s_frames():
    """Two LDR frames of the port on the CPU, recorded as one window: the
    image span is read, and no frame's image took a host pass."""
    from yocto_raytracing_tpu_torch import scene as scene_lib, testscenes
    from yocto_raytracing_tpu_torch.render import renderer
    from yocto_raytracing_tpu_torch.utils import tracer

    leaves, meta = scene_lib.build_device_scene(testscenes.make_hair_scene(8))
    ts = scene_lib.to_torch(leaves, "cpu")
    renderer._frames.clear()
    tracer.clear()
    with tracer.recording():
        for _ in range(2):
            renderer.render_image(ts, meta, 8, 8, 1, ldr=True, max_depth=2)
    trace = SimpleNamespace(requests=2)
    try:
        value = spec.metric_reader("image_ms.frame").read(trace)
        assert value is not None and value >= 0
        assert spec.metric_reader("host_rgba.frame").read(trace) == 0.0
    finally:
        tracer.clear()
