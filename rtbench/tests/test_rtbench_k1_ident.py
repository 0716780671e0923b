"""The reader of K1's identity-frame counter, ``k1_ident.frame``: on
hand-made spans, on a program without the tracer or without the counter,
and on the spans of small frames of the port on the CPU."""

from __future__ import annotations

import sys
from types import SimpleNamespace

import pytest

from rtbench.core import spans, spec


def _span(name, start, end, id, parent=None, request=None, **attrs):
    return SimpleNamespace(name=name, start_ns=start * 1000,
                           end_ns=end * 1000, id=id, parent=parent,
                           request=id if request is None else request,
                           attrs=attrs)


def _frames(*shares):
    """render_image roots, each with a ``frame_device`` child that carries
    ``k1_ident`` as given (None: no attribute, as a program without the
    counter leaves it)."""
    out = []
    for k, share in enumerate(shares):
        t0 = 10_000 * k
        root = _span("render_image", t0, t0 + 5000, 1 + 2 * k)
        loop = _span("frame_device", t0, t0 + 4000, 2 + 2 * k, 1 + 2 * k,
                     1 + 2 * k, hit=1)
        if share is not None:
            loop.attrs["k1_ident"] = share
        out += [root, loop]
    return out


@pytest.mark.parametrize("shares,want", [
    ((1.0, 1.0, 1.0), 100.0), ((1.0, 0.0, 1.0, 0.0), 50.0),
    ((0.25, 0.25), 25.0), ((1.0, None), 100.0), ((None, None), None),
    ((), None)])
def test_k1_ident_is_the_mean_share_of_the_frames(monkeypatch, shares, want):
    monkeypatch.setattr(spans, "program_spans",
                        lambda trace: _frames(*shares))
    got = spec.metric_reader("k1_ident.frame").read(None)
    assert got == want if want is None else got == pytest.approx(want)


def test_a_program_without_the_tracer_reads_nothing(monkeypatch):
    import yocto_raytracing_tpu_torch.utils as utils

    monkeypatch.delattr(utils, "tracer", raising=False)
    monkeypatch.setitem(sys.modules,
                        "yocto_raytracing_tpu_torch.utils.tracer", None)
    trace = SimpleNamespace(requests=4)
    assert spec.metric_reader("k1_ident.frame").read(trace) is None


@pytest.mark.parametrize("make,want", [
    ("make_hair_scene", 100.0), ("make_mixed_frame_scene", 500 / 12)])
def test_reader_on_the_port_s_frames(make, want):
    """Two LDR frames of the port on the CPU, recorded as one window: the
    hair stand-in's instances all have the identity's frame bits, the
    mixed-frame scene's 5 of 12."""
    from yocto_raytracing_tpu_torch import scene as scene_lib, testscenes
    from yocto_raytracing_tpu_torch.render import renderer
    from yocto_raytracing_tpu_torch.utils import tracer

    host = (testscenes.make_hair_scene(8) if make == "make_hair_scene"
            else testscenes.make_mixed_frame_scene())
    leaves, meta = scene_lib.build_device_scene(host)
    ts = scene_lib.to_torch(leaves, "cpu")
    renderer._frames.clear()
    tracer.clear()
    with tracer.recording():
        for _ in range(2):
            renderer.render_image(ts, meta, 8, 8, 1, ldr=True, max_depth=2)
    trace = SimpleNamespace(requests=2)
    try:
        got = spec.metric_reader("k1_ident.frame").read(trace)
        assert got == pytest.approx(want)
    finally:
        tracer.clear()
        renderer._frames.clear()
