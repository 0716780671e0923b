"""K4's and K5's packed shade records (``ops/shade_records.py``) against the
scene leaves.

* The records unpack to bit copies of the leaves they were built from,
  field by field and row by row, on the card tests' shading scenes (hair,
  the mirror scene, textured hair) and on an area-light hair scene.
* A scene rebuilt from the records' words, decoded as
  ``kernels/csrc/shade.cuh`` decodes them (``load_hit_record``,
  ``load_material_record``: each prim its own three vertex slots, ids and
  flags read back from their int32 words), shades every ray of a bounce
  ``torch.equal`` to the leaves: ``eval_hit``'s p, n, uv, barycentrics,
  material and hair flag, and ``shade_step_plain``'s outputs (material
  rows and textures included), masked and dead lanes included, with fixed
  and with per-ray light positions. This holds the record layout and the
  kernels' decoding on the CPU, where no CUDA kernel runs; the card tests
  hold the kernels themselves.
* Records packed after a training step hold the new leaves.
"""

import dataclasses

import numpy as np
import pytest
import torch

from yocto_raytracing_tpu_torch import scene as tscene, testscenes as tts
from yocto_raytracing_tpu_torch.kernels import parity
from yocto_raytracing_tpu_torch.ops import shade_records
from yocto_raytracing_tpu_torch.parallel import mesh
from yocto_raytracing_tpu_torch.render import lights, renderer, shade


def _set_geometry(shp, pos, lines=(), triangles=()):
    shp.pos = np.asarray(pos, np.float32)
    shp.points = np.zeros(0, np.int32)
    shp.lines = np.asarray(lines, np.int32).reshape(-1, 2)
    shp.triangles = np.asarray(triangles, np.int32).reshape(-1, 3)
    shp.norm = np.zeros((0, 3), np.float32)
    shp.texcoord = np.zeros((len(shp.pos), 2), np.float32)
    shp.radius = np.zeros(0, np.float32)


def _light_shape(host, name):
    ist = next(i for i in host.instances if i.name == name)
    return host.shapes[ist.shape]


def _area_hair_scene():
    """``make_hair_scene(64)`` with light1 an emissive 1 m quad facing
    down and light2 an emissive 4-segment polyline (the smoke run's area
    hair scene at 64 strands)."""
    host = tts.make_hair_scene(64)
    c = np.asarray([2.0, 4.0, 3.0], np.float32)
    _set_geometry(_light_shape(host, "light1"),
                  [c + d for d in ([-0.5, 0, -0.5], [0.5, 0, -0.5],
                                   [0.5, 0, 0.5], [-0.5, 0, 0.5])],
                  triangles=[[0, 1, 2], [0, 2, 3]])
    c = np.asarray([-2.5, 3.5, -1.0], np.float32)
    _set_geometry(_light_shape(host, "light2"),
                  [c + [dx, 0.1 * dx * dx, 0.3 * dx]
                   for dx in (-0.8, -0.3, 0.0, 0.4, 0.9)],
                  lines=[[0, 1], [1, 2], [2, 3], [3, 4]])
    return tscene.finalize_scene(host)


# (scene, width, height, samples, bounce): the card tests' SHADE_CASES and
# the area hair scene
CASES = {
    "hair64": (lambda: tts.make_hair_scene(64), 96, 54, 2, 1),
    "mirror_bounce2": (tts.make_grad_scene, 64, 64, 2, 2),
    "textured": (lambda: tts.make_textured_hair_scene(64), 96, 54, 2, 1),
    "area_hair": (_area_hair_scene, 96, 54, 2, 1),
}


def _case(name):
    make, w, h, s, bounce = CASES[name]
    host = make()
    leaves, meta = tscene.build_device_scene(host)
    return host, leaves, meta, tscene.to_torch(leaves, "cpu"), (w, h, s,
                                                                bounce)


def _bits(t):
    return t.detach().numpy().view(np.int32)


def _decoded_scene(ts, rec):
    """``ts`` with its shading leaves rebuilt from the records' words as the
    kernels decode them: prim p's vertex k is vertex 3 p + k, with the
    prim record's pos, norm and texcoord words; instance and material rows
    from their records; ids, types and flags from int32 words."""
    i32 = torch.int32
    p, s, m = rec.prims, rec.insts, rec.mats
    vert = p[:, 4:].reshape(-1, 3, 8)
    return dataclasses.replace(
        ts,
        pos=vert[..., 0:3].reshape(-1, 3).contiguous(),
        norm=vert[..., 3:6].reshape(-1, 3).contiguous(),
        texcoord=vert[..., 6:8].reshape(-1, 2).contiguous(),
        prim_v=torch.arange(3 * p.shape[0], dtype=i32).reshape(-1, 3),
        prim_type=p[:, 3].contiguous().view(i32),
        inst_axes=s[:, 0:9].reshape(-1, 3, 3).contiguous(),
        inst_o=s[:, 9:12].contiguous(),
        inst_mat=s[:, 12].contiguous().view(i32),
        inst_is_lines=s[:, 13].contiguous().view(i32),
        mat_kd=m[:, 0:3].contiguous(), mat_ks=m[:, 3:6].contiguous(),
        mat_kr=m[:, 6:9].contiguous(), mat_rs=m[:, 9].contiguous(),
        mat_kd_txt=m[:, 10].contiguous().view(i32),
        mat_ks_txt=m[:, 11].contiguous().view(i32))


def _check_copies(ts, rec):
    u = shade_records.unpack(rec)
    pv = ts.prim_v.numpy()
    assert u["prim_v"].shape == (pv.shape[0], 3)
    assert np.array_equal(u["prim_v"], pv)
    assert np.array_equal(u["prim_type"], ts.prim_type.numpy())
    for field, leaf in (("vert_pos", ts.pos), ("vert_norm", ts.norm),
                        ("vert_texcoord", ts.texcoord)):
        for k in range(3):
            assert np.array_equal(u[field][:, k], _bits(leaf)[pv[:, k]]), \
                (field, k)
    ni = ts.inst_axes.shape[0]
    assert u["inst_axes"].shape == (ni, 3, 3)
    assert np.array_equal(u["inst_axes"], _bits(ts.inst_axes))
    assert np.array_equal(u["inst_o"], _bits(ts.inst_o))
    assert np.array_equal(u["inst_mat"], ts.inst_mat.numpy())
    assert np.array_equal(u["inst_is_lines"], ts.inst_is_lines.numpy())
    assert not u["inst_pad"].any()
    for name in ("mat_kd", "mat_ks", "mat_kr", "mat_rs"):
        assert np.array_equal(u[name], _bits(getattr(ts, name))), name
    for name in ("mat_kd_txt", "mat_ks_txt"):
        assert np.array_equal(u[name], getattr(ts, name).numpy()), name


@pytest.mark.parametrize("name", list(CASES))
def test_records_copy_leaves(name):
    _, _, _, ts, _ = _case(name)
    rec = shade_records.pack(ts)
    assert rec.prims.dtype == rec.insts.dtype == rec.mats.dtype == \
        torch.float32
    assert (rec.prims.shape[1], rec.insts.shape[1], rec.mats.shape[1]) == (
        shade_records.PRIM_WORDS, shade_records.INST_WORDS,
        shade_records.MAT_WORDS)
    # 16-byte records: 7, 4 and 3 float4 loads
    assert all(r.shape[1] * 4 % 16 == 0 for r in rec)
    _check_copies(ts, rec)


def _inputs(ts, dims):
    w, h, s, bounce = dims
    ids = torch.arange(w * h * s * s, dtype=torch.int32)
    amb = torch.full((3,), 0.1)
    return amb, ids, parity.shade_inputs(ts, ids, w, h, s, bounce, amb)


@pytest.mark.parametrize("name", list(CASES))
def test_decoded_eval_hit_equals_leaves(name):
    """eval_hit on the decoded records equals eval_hit on the leaves on
    every ray of the bounce: the hit rays, and the masked and dead lanes'
    dummy hit (inst 0, prim 0) that K4 and K5 shade too."""
    _, _, _, ts, dims = _case(name)
    dec = _decoded_scene(ts, shade_records.pack(ts))
    _, _, (ro, rd, hits, active) = _inputs(ts, dims)
    mask = active & hits["hit"]
    assert bool(mask.any()) and not bool(mask.all())
    inst = torch.where(mask, hits["inst"], 0)
    prim = torch.where(mask, hits["prim"], 0)
    want = shade.eval_hit(ts, ro, rd, inst, prim)
    got = shade.eval_hit(dec, ro, rd, inst, prim)
    for k in ("p", "n", "uv", "ew", "mat", "is_lines"):
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("name", list(CASES))
def test_decoded_shade_step_equals_leaves(name):
    """shade_step_plain (eval_hit, the material row, textures, lights) on
    the decoded records equals it on the leaves, bit for bit, on every
    ray; the area-light scene with its per-ray light positions too."""
    host, leaves, meta, ts, dims = _case(name)
    dec = _decoded_scene(ts, shade_records.pack(ts))
    amb, ids, (ro, rd, hits, active) = _inputs(ts, dims)
    occ = parity.occluder(ts)
    light_pos = [None]
    if name == "area_hair":
        sampler = lights.build_light_sampler(host, leaves, meta, "cpu")
        light_pos.append(lights.sample_light_points_plain(ts, sampler, ids,
                                                          7))
    for lp in light_pos:
        want = shade.shade_step_plain(ts, ro, rd, hits, amb, active, occ,
                                      meta.has_kd_textures,
                                      meta.has_ks_textures, lp)
        got = shade.shade_step_plain(dec, ro, rd, hits, amb, active, occ,
                                     meta.has_kd_textures,
                                     meta.has_ks_textures, lp)
        for k, (a, b) in enumerate(zip(got, want)):
            assert torch.equal(a.view(torch.int32) if a.is_floating_point()
                               else a,
                               b.view(torch.int32) if b.is_floating_point()
                               else b), (k, lp is None)


def test_records_follow_train_step():
    """``train_step`` returns new leaves; records packed from them hold the
    new positions and materials (the renderer packs per call and per
    frame, so none go stale)."""
    host = tts.make_hair_scene(16)
    leaves, meta = tscene.build_device_scene(host)
    scene = tscene.to_torch(leaves, "cpu")
    w, h, spp = 24, 16, 1
    ids = torch.arange(w * h, dtype=torch.int32)
    amb = torch.full((3,), 0.1)
    target = renderer.trace_rays(scene, ids, amb, w, h, spp, 2) * 0.5
    before = shade_records.unpack(shade_records.pack(scene))
    new, _ = mesh.train_step(scene, ids, target, amb, 10.0, width=w,
                             height=h, samples=spp, max_depth=2,
                             trainable=("pos", "mat_kd"))
    assert not torch.equal(new.pos, scene.pos)
    assert not torch.equal(new.mat_kd, scene.mat_kd)
    rec = shade_records.pack(new)
    _check_copies(new, rec)
    after = shade_records.unpack(rec)
    for field in ("vert_pos", "mat_kd"):
        assert not np.array_equal(after[field], before[field]), field


def test_pack_rejects_f64_leaves():
    _, _, _, ts, _ = _case("hair64")
    with pytest.raises(ValueError, match="f32"):
        shade_records.pack(dataclasses.replace(ts, pos=ts.pos.double()))
