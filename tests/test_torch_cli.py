"""The port's CLI (``python -m yocto_raytracing_tpu_torch.cli``), its
checkpoint/resume and ``render_scene_file(intersector=)``: the port of
tests/test_cli.py, on the CPU.

* the parser's defaults and short flags are the reference's, every flag
  lands in ``RenderConfig``, ``--device`` included;
* a load error exits 1 with ``error:`` first on stderr and no traceback,
  also when another caller made the logger first;
* a checkpointed frame equals the uncheckpointed one bit for bit (f32, and
  u8 through the host tonemap), resumes bit-identically from a truncated
  snapshot, and ignores a snapshot written under another configuration;
* ``intersector="bvh"`` renders what ``"stream"`` renders; anything else
  raises ``ValueError``;
* the CLI's hair frame at 96p, 1 spp matches the reference binary's
  golden (tests/goldens/lines_96_s1.png), as ``test_golden_lines_port``
  does through ``render_scene_file``; ``--checkpoint`` (resumed from a
  truncated snapshot) and ``--sharded`` (one process, no group) write the
  same PNG;
* the hair scene's ``.glb`` and ``.gltf`` twins write the PNG of its
  ``.obj``, byte for byte.
"""

import io
import os
import sys

import numpy as np
import pytest

from conftest import assert_golden_match
from yocto_raytracing_tpu_torch import cli, image as image_mod
from yocto_raytracing_tpu_torch import scene as tscene, testscenes as tts
from yocto_raytracing_tpu_torch.render import renderer as tren
from yocto_raytracing_tpu_torch.utils import RenderConfig, get_logger

FRAME = dict(width=16, height=16, max_depth=2, chunk_pixels=64)


def test_parser_defaults_match_reference():
    # raytrace.cpp:258-270: -r 720, -s 1, -a 0.1, -o out.png
    args = cli.build_parser().parse_args(["scene.obj"])
    assert args.resolution == 720
    assert args.samples == 1
    assert args.ambient == pytest.approx(0.1)
    assert args.output == "out.png"
    assert args.scenein == "scene.obj"
    assert args.device == "cuda"
    cfg = cli.config_from_args(args)
    assert cfg == RenderConfig(output="out.png")


def test_parser_short_flags():
    args = cli.build_parser().parse_args(
        ["-r", "96", "-s", "3", "-a", "0.2", "-o", "x.hdr", "in.obj"])
    assert (args.resolution, args.samples, args.ambient, args.output) == (
        96, 3, pytest.approx(0.2), "x.hdr")


def test_config_from_args_roundtrip():
    args = cli.build_parser().parse_args(
        ["-r", "96", "-s", "3", "-a", "0.2", "-o", "x.hdr",
         "--camera", "1", "--max-depth", "5", "--chunk-pixels", "256",
         "--intersector", "bvh", "--checkpoint", "c.npz", "--sharded",
         "--stochastic", "--seed", "9", "--area-lights", "--device", "cpu",
         "in.obj"])
    cfg = cli.config_from_args(args)
    assert cfg.resolution == 96 and cfg.samples == 3
    assert cfg.ambient == pytest.approx(0.2)
    assert (cfg.output, cfg.camera, cfg.max_depth) == ("x.hdr", 1, 5)
    assert (cfg.chunk_pixels, cfg.intersector, cfg.checkpoint) == (
        256, "bvh", "c.npz")
    assert (cfg.sharded, cfg.stochastic, cfg.seed, cfg.area_lights,
            cfg.device) == (True, True, 9, True, "cpu")
    assert cfg.to_dict()["device"] == "cpu"
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["--intersector", "foo", "in.obj"])


@pytest.mark.parametrize("logger_first", [False, True],
                         ids=["fresh", "logger_made_first"])
def test_cli_load_error_clean_exit(tmp_path, capsys, monkeypatch,
                                   logger_first):
    # missing file / unknown extension -> message + exit 1, no traceback
    # (reference printf+exit(1)s, src/scene.cpp:119-122)
    if logger_first:   # another caller made the logger under another stderr
        monkeypatch.setattr(sys, "stderr", io.StringIO())
        get_logger().info("an earlier caller's line")
        monkeypatch.undo()
    rc = cli.main(["-r", "8", "--device", "cpu",
                   os.path.join(tmp_path, "nope.obj")])
    assert rc == 1
    err = capsys.readouterr().err
    assert err.startswith("error:") and "Traceback" not in err

    bad = os.path.join(tmp_path, "scene.xyz")
    open(bad, "w").close()
    rc = cli.main(["-r", "8", "--device", "cpu", bad])
    assert rc == 1
    err = capsys.readouterr().err
    assert err.startswith("error:") and "Traceback" not in err


def test_run_rejects_unknown_intersector(tmp_path):
    with pytest.raises(ValueError, match="intersector"):
        cli.run(str(tmp_path / "nope.obj"),
                RenderConfig(intersector="foo", device="cpu"))


@pytest.fixture(scope="module")
def grad():
    leaves, meta = tscene.build_device_scene(tts.make_grad_scene())
    return tscene.to_torch(leaves, "cpu"), meta


def test_checkpoint_resume(tmp_path, grad):
    dev, meta = grad
    ck = os.path.join(tmp_path, "acc.npz")
    full = tren.render_image(dev, meta, samples=1, **FRAME)
    # with checkpointing: the same bits; then the snapshot truncated to
    # mid-render and resumed: the same bits again
    first = tren.render_image(dev, meta, samples=1, checkpoint=ck, **FRAME)
    np.testing.assert_array_equal(full, first)
    with np.load(ck) as snap:
        key, acc = snap["key"], snap["acc"]
        assert int(snap["done"]) == 256
    tren._atomic_savez(ck, key=key, done=100, acc=acc[:100])
    resumed = tren.render_image(dev, meta, samples=1, checkpoint=ck,
                                **FRAME)
    np.testing.assert_array_equal(full, resumed)
    # ldr on the checkpointed path: the host tonemap of the f32 frame
    tren._atomic_savez(ck, key=key, done=100, acc=acc[:100])
    ldr = tren.render_image(dev, meta, samples=1, checkpoint=ck, ldr=True,
                            **FRAME)
    np.testing.assert_array_equal(ldr, image_mod.tonemap(full))


@pytest.mark.parametrize("first,second", [
    (dict(samples=1), dict(samples=2)),
    (dict(samples=2, stochastic=True, seed=1),
     dict(samples=2, stochastic=True, seed=2)),
    (dict(samples=2), dict(samples=2, stochastic=True)),
], ids=["samples", "seed", "stochastic"])
def test_checkpoint_config_mismatch_ignored(tmp_path, grad, first, second):
    dev, meta = grad
    ck = os.path.join(tmp_path, "acc.npz")
    tren.render_image(dev, meta, checkpoint=ck, **first, **FRAME)
    want = tren.render_image(dev, meta, **second, **FRAME)
    got = tren.render_image(dev, meta, checkpoint=ck, **second, **FRAME)
    np.testing.assert_array_equal(got, want)
    assert np.abs(want - tren.render_image(dev, meta, **first,
                                           **FRAME)).max() > 1e-4


@pytest.fixture(scope="module")
def hair_obj(tmp_path_factory):
    path = tmp_path_factory.mktemp("cli") / "lines_pointlight.obj"
    tscene.save_scene(tts.make_hair_scene(256), str(path))
    return str(path)


def test_render_scene_file_intersector(hair_obj):
    """C1: the JAX package's ``intersector`` keyword; both names run K1."""
    kw = dict(max_depth=2, device="cpu")
    a, *_ = tren.render_scene_file(hair_obj, 24, 1, intersector="stream",
                                   **kw)
    b, *_ = tren.render_scene_file(hair_obj, 24, 1, intersector="bvh", **kw)
    np.testing.assert_array_equal(a, b)
    assert a[..., :3].max() > 0.05
    with pytest.raises(ValueError, match="intersector"):
        tren.render_scene_file(hair_obj, 24, 1, intersector="foo", **kw)


def test_cli_golden_lines(goldens_dir, hair_obj, tmp_path, capsys):
    """The hair scene through the CLI against the reference binary's
    render; ``--checkpoint`` resumed from a truncated snapshot and
    ``--sharded`` in one process write the same PNG."""
    base = ["-r", "96", "-s", "1", "--device", "cpu"]
    png = str(tmp_path / "out.png")
    assert cli.main(base + ["-o", png, hair_obj]) == 0
    ldr = image_mod.load_image4b(png)
    assert_golden_match(ldr, os.path.join(goldens_dir, "lines_96_s1.png"))
    err = capsys.readouterr().err
    assert "rendering 171x96 @ 1 spp" in err   # the phase log

    ck = str(tmp_path / "ck.npz")
    argv = base + ["--chunk-pixels", "4096", "--checkpoint", ck, "-o", png,
                   hair_obj]
    assert cli.main(argv) == 0
    np.testing.assert_array_equal(image_mod.load_image4b(png), ldr)
    with np.load(ck) as snap:
        key, acc, done = snap["key"], snap["acc"], int(snap["done"])
    assert done == 171 * 96
    tren._atomic_savez(ck, key=key, done=done // 2, acc=acc[:done // 2])
    os.remove(png)
    assert cli.main(argv) == 0
    np.testing.assert_array_equal(image_mod.load_image4b(png), ldr)

    assert cli.main(base + ["--sharded", "-o", png, hair_obj]) == 0
    np.testing.assert_array_equal(image_mod.load_image4b(png), ldr)


def test_cli_gltf_twin_writes_the_obj_png(tmp_path):
    """``cli.main`` on the ``.glb`` and ``.gltf`` of the hair scene writes
    the same PNG bytes as on its ``.obj`` twin."""
    base = ["-r", "32", "-s", "1", "--max-depth", "2", "--device", "cpu"]
    host = tts.make_hair_scene(32)
    pngs = []
    for ext in (".obj", ".glb", ".gltf"):
        scene_path = str(tmp_path / ext[1:] / f"hair{ext}")
        tscene.save_scene(host, scene_path)
        png = str(tmp_path / f"{ext[1:]}.png")
        assert cli.main(base + ["-o", png, scene_path]) == 0
        pngs.append(open(png, "rb").read())
    assert pngs[1] == pngs[0] and pngs[2] == pngs[0]
    assert image_mod.load_image4b(str(tmp_path / "obj.png"))[..., :3].max() > 0
