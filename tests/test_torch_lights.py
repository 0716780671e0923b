"""The port's area lights (``render/lights.py``, K8's plain version, K4's
per-ray light positions) == the JAX package's.

Both packages build each scene from their own ``testscenes`` and compute on
the same leaves (``from_jax_arrays``):

* ``build_light_sampler`` tables: ``np.array_equal`` on four scenes, the
  occluded-triangle scene of ``tests/test_area_lights.py``, an emissive
  polyline, a mixed point/line/triangle emissive shape and a zero-element
  emissive shape (``deg``);
* ``sample_light_points``: bit-equal to JAX (op by op) on the variates of
  ``seed ^ 0x85EBCA6B``, on every light kind and on a ``deg`` light;
* one shading bounce with per-ray light positions: allclose(rtol=1e-5,
  atol=1e-6), as ``test_torch_render.py::test_shade_step`` holds it;
* area-light frames (24x24, 2x2 samples, depth 2, the JAX side jitted in
  the no-FMA child): every u8 channel within 1 step after ``image.tonemap``;
* laws: a single-point light in area mode gives the deterministic frame bit
  for bit; seed-determinism; the CPU path stays differentiable.
"""

import types
from dataclasses import fields

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import jax_nofma
from yocto_raytracing_tpu import image as image_mod
from yocto_raytracing_tpu import scene as jscene, testscenes as jts
from yocto_raytracing_tpu.ops import traverse as jtrav
from yocto_raytracing_tpu.render import camera as jcam
from yocto_raytracing_tpu.render import lights as jlights
from yocto_raytracing_tpu.render import shade as jshade
from yocto_raytracing_tpu_torch import scene as tscene, testscenes as tts
from yocto_raytracing_tpu_torch.ops import traverse as ttrav
from yocto_raytracing_tpu_torch.render import camera as tcam
from yocto_raytracing_tpu_torch.render import lights as tlights
from yocto_raytracing_tpu_torch.render import renderer as tren
from yocto_raytracing_tpu_torch.render import shade as tshade

FLT_MAX = np.float32(3.4028235e38)
PKG = {"jax": (jscene, jts), "torch": (tscene, tts)}


def _light_shape(host, name):
    """The emissive shape of instance ``name``."""
    ist = next(i for i in host.instances if i.name == name)
    return host.shapes[ist.shape]


def _set_geometry(shp, pos, points=(), lines=(), triangles=()):
    shp.pos = np.asarray(pos, np.float32)
    shp.points = np.asarray(points, np.int32).reshape(-1)
    shp.lines = np.asarray(lines, np.int32).reshape(-1, 2)
    shp.triangles = np.asarray(triangles, np.int32).reshape(-1, 3)
    shp.norm = np.zeros((0, 3), np.float32)
    shp.texcoord = np.zeros((len(shp.pos), 2), np.float32)
    shp.radius = np.zeros(0, np.float32)


def occluded_scene(pkg, light_tri=True):
    """tests/test_area_lights.py::_occluded_scene: the grad scene, its
    point light replaced by an area triangle around the same centroid."""
    scene_lib, ts = PKG[pkg]
    host = ts.make_grad_scene()
    if light_tri:
        shp = _light_shape(host, "light")
        c = shp.pos[0].copy()
        _set_geometry(shp, [c + [-0.6, 0, -0.6], c + [0.6, 0, -0.6],
                            c + [0.0, 0, 0.9]], triangles=[[0, 1, 2]])
        scene_lib.finalize_scene(host)
    return host


def polyline_scene(pkg):
    """The hair scene (16 strands) with light2 an emissive 4-segment
    polyline around (-2.5, 3.5, -1)."""
    scene_lib, ts = PKG[pkg]
    host = ts.make_hair_scene(16)
    c = np.asarray([-2.5, 3.5, -1.0], np.float32)
    pos = [c + [dx, 0.1 * dx * dx, 0.3 * dx] for dx in (-0.8, -0.3, 0.0, 0.4,
                                                       0.9)]
    _set_geometry(_light_shape(host, "light2"), pos,
                  lines=[[0, 1], [1, 2], [2, 3], [3, 4]])
    scene_lib.finalize_scene(host)
    return host


def mixed_scene(pkg):
    """The hair scene with light1 one emissive shape of 2 points, 2
    segments and 2 triangles (pool order: points, lines, triangles)."""
    scene_lib, ts = PKG[pkg]
    host = ts.make_hair_scene(16)
    c = np.asarray([2.0, 4.0, 3.0], np.float32)
    pos = [c + d for d in ([0, 0, 0], [0.5, 0, 0], [0, 0, 0.5],
                           [0.5, 0, 0.5], [-0.4, 0.1, 0.2], [-0.2, 0, -0.4])]
    _set_geometry(_light_shape(host, "light1"), pos, points=[4, 5],
                  lines=[[4, 5], [5, 0]], triangles=[[0, 1, 2], [1, 3, 2]])
    scene_lib.finalize_scene(host)
    return host


def ghost_scene(pkg):
    """The hair scene plus an emissive shape with a vertex and no element:
    no prim in the pool, so its light is ``deg``. Its BVH cannot be built,
    so only the tables are compared (``meta`` from the prim counts)."""
    scene_lib, ts = PKG[pkg]
    host = ts.make_hair_scene(16)
    host.shapes.append(ts._shape("ghost", [[0.5, 3.0, 0.5]]))
    host.materials.append(scene_lib.HostMaterial(
        name="ghost", ke=np.full(3, 5.0, np.float32)))
    host.instances.append(scene_lib.HostInstance(
        name="ghost", axes=np.eye(3, dtype=np.float32),
        o=np.zeros(3, np.float32), shape=len(host.shapes) - 1,
        material=len(host.materials) - 1))
    return host


def _meta_of(host, scene_lib):
    try:
        return scene_lib.build_device_scene(host)[1]
    except ValueError:   # the ghost shape: prim offsets are all it needs
        off = np.cumsum([0] + [s.num_prims for s in host.shapes])[:-1]
        return types.SimpleNamespace(shape_prim_offset=[int(x) for x in off])


TABLE_SCENES = {"occluded_triangle": occluded_scene,
                "polyline": polyline_scene, "mixed": mixed_scene,
                "zero_elements": ghost_scene}


@pytest.mark.parametrize("name", list(TABLE_SCENES))
def test_light_sampler_tables_equal(name):
    make = TABLE_SCENES[name]
    hj, ht = make("jax"), make("torch")
    sj = jlights.build_light_sampler(hj, None, _meta_of(hj, jscene))
    st = tlights.build_light_sampler(ht, None, _meta_of(ht, tscene), "cpu")
    assert sorted(st) == sorted(sj)
    for k in sj:
        a = np.asarray(sj[k])
        b = st[k].numpy()
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        np.testing.assert_array_equal(b, a, err_msg=k)
    if name == "zero_elements":
        assert bool(st["deg"][-1]) and not bool(st["deg"][:-1].any())
    else:
        assert not bool(st["deg"].any())
    if name == "mixed":
        assert st["n"].tolist() == [6, 1]


def _both(host_j, host_t):
    jd, meta = jscene.build_device_scene(host_j)
    leaves = {f.name: np.asarray(getattr(jd, f.name))
              for f in fields(jscene.DeviceScene)}
    sj = jlights.build_light_sampler(host_j, jd, meta)
    st = tlights.build_light_sampler(host_t, None, meta, "cpu")
    return (jscene.to_jax(jd), tscene.from_jax_arrays(leaves, "cpu"), meta,
            leaves, sj, st)


POINT_SCENES = {"occluded_triangle": occluded_scene,
                "polyline": polyline_scene, "mixed": mixed_scene,
                "point_lights": lambda pkg: PKG[pkg][1].make_hair_scene(16)}


@pytest.mark.parametrize("deg", [False, True], ids=["sampled", "deg"])
@pytest.mark.parametrize("name", list(POINT_SCENES))
def test_sample_light_points_bit_equal(name, deg):
    make = POINT_SCENES[name]
    jdev, ts, _, _, sj, st = _both(make("jax"), make("torch"))
    if deg:   # every light falls back to its fixed position
        sj = dict(sj, deg=jnp.ones_like(sj["deg"]))
        st = dict(st, deg=torch.ones_like(st["deg"]))
    seed = 9
    ids = np.arange(20000, dtype=np.int32) * 7919 % (2**31 - 1)
    with jax.disable_jit():
        ruv = jcam.per_ray_uniform(jnp.uint32(seed) ^ jnp.uint32(0x85EBCA6B),
                                   jnp.asarray(ids), 3)
        pj = np.asarray(jlights.sample_light_points(jdev, sj, ruv))
    pt = tlights.sample_light_points(ts, st, torch.from_numpy(ids), seed)
    assert pt.shape == (ts.light_pos.shape[0], len(ids), 3)
    np.testing.assert_array_equal(pt.numpy(), pj)
    spread = np.ptp(pt.numpy(), axis=1).max(axis=-1)  # per light
    first = ts.prim_type[st["prim_lo"].clamp(max=ts.prim_type.shape[0] - 1)]
    for l in range(pt.shape[0]):
        if deg or (st["n"][l] == 1 and int(first[l]) == tscene.PRIM_POINT):
            assert spread[l] == 0      # a point: always the same position
        else:
            assert spread[l] > 0.05


def _shade_pair(host_j, host_t, seed):
    jdev, ts, meta, _, sj, st = _both(host_j, host_t)
    width, height, samples = 32, 32, 1
    n = width * height
    ids = torch.arange(n, dtype=torch.int32)
    _, ro, rd = tcam.camera_rays(ts, ids, width, height, samples)
    ro, rd = ro.contiguous(), rd.contiguous()
    hits = ttrav.intersect_scene(ts, ro, rd, torch.full((n,), 1e-4),
                                 torch.full((n,), FLT_MAX))
    amb = torch.full((3,), 0.1)
    active = torch.ones(n, dtype=torch.bool)
    lpos = tlights.sample_light_points(ts, st, ids, seed)

    def occ_t(p, d, tmin_, tmax_, mask):
        res = ttrav.intersect_scene(
            ts, p.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous(),
            tmin_.reshape(-1), torch.where(mask, tmax_, -FLT_MAX).reshape(-1),
            any_hit=True)
        return res["hit"].reshape(p.shape[:-1])

    def occ_j(p, d, tmin_, tmax_, mask):
        with jax.disable_jit(False):
            res = jtrav.intersect_scene(
                jdev, p.reshape(-1, 3), d.reshape(-1, 3), tmin_.reshape(-1),
                jnp.where(mask, tmax_, -FLT_MAX).reshape(-1), any_hit=True)
        return res["hit"].reshape(p.shape[:-1])

    out_t = tshade.shade_step(ts, ro, rd, hits, amb, active, occ_t,
                              meta.has_kd_textures, meta.has_ks_textures,
                              light_pos=lpos)
    jhits = {k: jnp.asarray(v.numpy()) for k, v in hits.items()}
    with jax.disable_jit():
        out_j = jshade.shade_step(
            jdev, jnp.asarray(ro.numpy()), jnp.asarray(rd.numpy()), jhits,
            jnp.asarray(amb.numpy()), jnp.asarray(active.numpy()), occ_j,
            meta.has_kd_textures, meta.has_ks_textures,
            light_pos=jnp.asarray(lpos.numpy()))
    fixed = tshade.shade_step(ts, ro, rd, hits, amb, active, occ_t,
                              meta.has_kd_textures, meta.has_ks_textures)
    return out_j, out_t, fixed, hits


def test_shade_step_per_ray_lights():
    out_j, out_t, fixed, hits = _shade_pair(occluded_scene("jax"),
                                            occluded_scene("torch"), 5)
    mask = hits["hit"].numpy()
    assert mask.mean() > 0.5
    for a, b, what in zip(out_j[:4], out_t[:4],
                          ("color", "kr", "p", "refl_dir")):
        np.testing.assert_allclose(b.numpy()[mask], np.asarray(a)[mask],
                                   rtol=1e-5, atol=1e-6, err_msg=what)
    np.testing.assert_array_equal(out_t[4].numpy(), np.asarray(out_j[4]))
    # the sampled positions move the shading off the fixed light's
    assert float((out_t[0] - fixed[0]).abs().max()) > 1e-3


def _area_frames(make, stochastic, seed=3):
    host_j, host_t = make("jax"), make("torch")
    _, ts, meta, leaves, sj, st = _both(host_j, host_t)
    w = h = 24
    samples, depth = 2, 2
    spp = samples * samples
    ids = np.arange(w * h * spp, dtype=np.int32)
    rgb = jax_nofma.radiance(
        leaves, ids, np.full(3, 0.1, np.float32), width=w, height=h,
        samples=samples, max_depth=depth, stochastic=stochastic, seed=seed,
        sampler={k: np.asarray(v) for k, v in sj.items()})["rgb"]
    per = rgb.reshape(-1, spp, 3)
    acc = per[:, 0]
    for k in range(1, spp):
        acc = acc + per[:, k]
    hdr_j = np.ones((w * h, 4), np.float32)
    hdr_j[:, :3] = acc / np.float32(spp)
    hdr_t = tren.render_image(ts, meta, w, h, samples, max_depth=depth,
                              stochastic=stochastic, seed=seed,
                              light_sampler=st)
    return hdr_j.reshape(h, w, 4), hdr_t, ts, meta, st


@pytest.mark.parametrize("stochastic", [False, True],
                         ids=["area", "area_stochastic"])
def test_area_frame_matches_jax(stochastic):
    hdr_j, hdr_t, ts, meta, _ = _area_frames(occluded_scene, stochastic)
    d = np.abs(image_mod.tonemap(hdr_t).astype(np.int32)
               - image_mod.tonemap(hdr_j))
    assert d.max() <= 1, (d.max(), int((d > 1).any(axis=-1).sum()))
    det = tren.render_image(ts, meta, 24, 24, 2, max_depth=2)
    assert np.abs(det - hdr_t).max() > 1e-3   # shadows moved and softened


def test_point_light_area_mode_is_deterministic_frame():
    """A single-point emissive shape: area mode == deterministic mode, bit
    for bit (the CDF pick and the point both collapse to pos[0])."""
    host = occluded_scene("torch", light_tri=False)
    leaves, meta = tscene.build_device_scene(host)
    ts = tscene.to_torch(leaves, "cpu")
    sampler = tlights.build_light_sampler(host, leaves, meta, "cpu")
    det = tren.render_image(ts, meta, 24, 24, 2, max_depth=2)
    for seed in (0, 5):
        area = tren.render_image(ts, meta, 24, 24, 2, max_depth=2,
                                 light_sampler=sampler, seed=seed)
        np.testing.assert_array_equal(area, det)


def test_area_mode_laws_and_cpu_gradient():
    host = occluded_scene("torch")
    leaves, meta = tscene.build_device_scene(host)
    ts = tscene.to_torch(leaves, "cpu")
    sampler = tlights.build_light_sampler(host, leaves, meta, "cpu")
    kw = dict(max_depth=2, light_sampler=sampler)
    a = tren.render_image(ts, meta, 20, 20, 2, seed=3, **kw)
    np.testing.assert_array_equal(
        a, tren.render_image(ts, meta, 20, 20, 2, seed=3, chunk_pixels=64,
                             **kw))
    assert np.abs(a - tren.render_image(ts, meta, 20, 20, 2, seed=4,
                                        **kw)).max() > 1e-3
    # the plain path is differentiable through the sampled points
    pos = ts.pos.detach().requires_grad_(True)
    scene = tscene.TorchScene(**{k: (pos if k == "pos" else getattr(ts, k))
                                 for k in tscene.LEAF_NAMES})
    ids = torch.arange(20 * 20 * 4, dtype=torch.int32)
    amb = torch.full((3,), 0.1)
    rgb = tren.trace_rays(scene, ids, amb, 20, 20, 2, 2,
                          differentiable=True, stochastic=True, seed=3,
                          light_sampler=sampler)
    with torch.no_grad():
        ref = tren.trace_rays(ts, ids, amb, 20, 20, 2, 2, stochastic=True,
                              seed=3, light_sampler=sampler)
    np.testing.assert_array_equal(rgb.detach().numpy(), ref.numpy())
    (g,) = torch.autograd.grad(rgb.sum(), [pos])
    light_rows = slice(meta.shape_vert_offset[2], None)   # the light's verts
    assert torch.isfinite(g).all() and float(g[light_rows].abs().sum()) > 0
