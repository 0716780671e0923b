"""The port's host utilities equal the JAX package's.

Each case runs the same inputs through both packages and holds the results
``array_equal`` (the same dtype and the same bits):

* ``geometry``: every case of tests/test_geometry_mesh.py, on the port's
  copy and the JAX module, plus their own assertions;
* ``procedural``: the structural cases of tests/test_procedural.py, and
  every image maker and ``bump_to_normal_map`` at three sizes;
* ``animation``: the keyframe cases of tests/test_geometry_extras.py;
* the OBJ ``t`` (tetrahedra) lines through ``load_scene`` into
  ``HostShape.tetrahedra``;
* ``ops.intersect.intersect_quad`` and ``intersect_tetrahedron`` on the
  ray grid of tests/test_geometry_extras.py against JAX run op by op
  (``jax.disable_jit``): ``hit`` equal, ``t`` and ``euv`` bit-equal.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from host_compare import assert_same
from yocto_raytracing_tpu import animation as janim, geometry as jgeo
from yocto_raytracing_tpu import procedural as jproc
from yocto_raytracing_tpu import scene as jscene, testscenes as jts
from yocto_raytracing_tpu.ops import intersect as jisect
from yocto_raytracing_tpu_torch import animation as tanim, geometry as tgeo
from yocto_raytracing_tpu_torch import procedural as tproc
from yocto_raytracing_tpu_torch import scene as tscene, testscenes as tts
from yocto_raytracing_tpu_torch.ops import intersect as tisect
from yocto_raytracing_tpu_torch.render import renderer as tren


def _both(fn):
    """fn(module) on the JAX module and the port's copy, held equal."""
    got = fn(tgeo)
    assert_same(got, fn(jgeo))
    return got


# --------------------------------------------------------------------------
# geometry (tests/test_geometry_mesh.py)
# --------------------------------------------------------------------------


def test_element_geometry_helpers():
    v0 = np.asarray([0, 0, 0], np.float32)
    v1 = np.asarray([1, 0, 0], np.float32)
    v2 = np.asarray([0, 1, 0], np.float32)
    v3 = np.asarray([0, 0, 1], np.float32)
    np.testing.assert_allclose(
        _both(lambda g: g.triangle_normal(v0, v1, v2)), [0, 0, 1])
    np.testing.assert_allclose(
        _both(lambda g: g.triangle_area(v0, v1, v2)), 0.5)
    np.testing.assert_allclose(_both(lambda g: g.line_tangent(v0, v1)),
                               [1, 0, 0])
    np.testing.assert_allclose(_both(lambda g: g.line_length(v0, 2 * v1)),
                               2.0)
    np.testing.assert_allclose(
        _both(lambda g: g.tetrahedron_volume(v0, v1, v2, v3)), 1 / 6,
        rtol=1e-6)
    np.testing.assert_allclose(
        _both(lambda g: g.tetrahedron_volume(v0, v2, v1, v3)), -1 / 6,
        rtol=1e-6)
    a = _both(lambda g: g.triangle_area(
        np.stack([v0, v0]), np.stack([v1, 2 * v1]), np.stack([v2, 2 * v2])))
    np.testing.assert_allclose(a, [0.5, 2.0])
    # seeded batches: the same bits on arbitrary inputs
    rng = np.random.default_rng(0)
    p = rng.normal(size=(4, 64, 3)).astype(np.float32)
    for name, k in (("triangle_normal", 3), ("triangle_area", 3),
                    ("line_tangent", 2), ("line_length", 2),
                    ("tetrahedron_volume", 4)):
        _both(lambda g: getattr(g, name)(*p[:k]))


def test_quads_to_triangles():
    q = np.asarray([[0, 1, 2, 3], [4, 5, 6, 7]], np.int32)
    t = _both(lambda g: g.quads_to_triangles(q))
    np.testing.assert_array_equal(
        t, [[0, 1, 3], [2, 3, 1], [4, 5, 7], [6, 7, 5]])


def test_edge_map_first_seen_order():
    tris = np.asarray([[0, 1, 2], [2, 1, 3]], np.int32)
    edges, ids = _both(lambda g: g.edge_map(tris))
    assert len(edges) == 5
    np.testing.assert_array_equal(edges[0], [0, 1])
    np.testing.assert_array_equal(edges[1], [1, 2])
    assert ids[(1, 2)] == 1
    assert ids[(1, 3)] in range(5)
    quads = np.asarray([[0, 1, 2, 3], [3, 2, 4, 4], [1, 5, 6, 2]], np.int32)
    _both(lambda g: g.edge_map(quads))


def test_tesselate_lines():
    lines = np.asarray([[0, 1]], np.int32)
    verts = dict(pos=np.asarray([[0, 0, 0], [2, 0, 0]], np.float32),
                 radius=np.asarray([1.0, 3.0], np.float32))
    nl, nv = _both(lambda g: g.tesselate_lines(lines, verts))
    assert nl.shape == (2, 2)
    np.testing.assert_allclose(nv["pos"][2], [1, 0, 0])
    np.testing.assert_allclose(nv["radius"][2], 2.0)
    np.testing.assert_array_equal(nl, [[0, 2], [2, 1]])
    rng = np.random.default_rng(1)
    verts = dict(pos=rng.normal(size=(6, 3)).astype(np.float32),
                 tang=rng.normal(size=(6, 3)).astype(np.float32))
    lines = np.asarray([[0, 1], [1, 2], [3, 4], [4, 5]], np.int32)
    _both(lambda g: g.tesselate_lines(lines, verts))


def test_tesselate_triangles_counts_and_midpoints():
    tris = np.asarray([[0, 1, 2]], np.int32)
    pos = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    nt, nv = _both(lambda g: g.tesselate_triangles(tris, dict(pos=pos)))
    assert nt.shape == (4, 3)
    assert len(nv["pos"]) == 6
    got = {tuple(np.round(m, 6)) for m in nv["pos"][3:]}
    assert got == {(0.5, 0.0, 0.0), (0.5, 0.5, 0.0), (0.0, 0.5, 0.0)}

    def area(t):
        a, b, c = nv["pos"][t]
        return 0.5 * np.linalg.norm(np.cross(b - a, c - a))
    np.testing.assert_allclose(sum(area(t) for t in nt), 0.5, rtol=1e-6)


def test_tesselate_quads_degenerate():
    q = np.asarray([[0, 1, 2, 3], [0, 1, 4, 4]], np.int32)
    pos = np.asarray([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                      [2, 0, 0]], np.float32)
    nq, nv = _both(lambda g: g.tesselate_quads(q, dict(pos=pos)))
    assert nq.shape == (7, 4)
    np.testing.assert_allclose(nv["pos"][-2], [0.5, 0.5, 0.0])
    np.testing.assert_allclose(nv["pos"][-1], [1.0, 0.0, 0.0])


def _cube():
    pos = np.asarray([[x, y, z] for z in (0, 1) for y in (0, 1)
                      for x in (0, 1)], np.float32)
    quads = np.asarray([
        [0, 1, 3, 2], [4, 6, 7, 5], [0, 4, 5, 1],
        [2, 3, 7, 6], [0, 2, 6, 4], [1, 5, 7, 3]], np.int32)
    return pos, quads


def test_catmullclark_smooths_cube_toward_center():
    pos, quads = _cube()
    norm = pos - 0.5
    nq, nv = _both(lambda g: g.tesselate_catmullclark(
        quads, dict(pos=pos, norm=norm)))
    assert nq.shape == (24, 4)
    center = np.asarray([0.5, 0.5, 0.5])
    r_orig = np.linalg.norm(pos - center, axis=1).max()
    r_new = np.linalg.norm(nv["pos"] - center, axis=1).max()
    assert r_new < r_orig
    np.testing.assert_allclose(nv["pos"].mean(axis=0), center, atol=1e-6)
    # a second step on the first's output
    _both(lambda g: g.tesselate_catmullclark(nq, nv))


def test_make_faces_triangles_and_quads():
    def pos_fn(uv):
        return np.concatenate([uv, np.zeros_like(uv[:, :1])], axis=1)

    def norm_fn(uv):
        return np.stack([uv[:, 1], uv[:, 0], np.ones(len(uv))], axis=1)

    tris, pos, norm, tc = _both(lambda g: g.make_faces(
        2, 3, pos_fn, as_triangles=True))
    assert pos.shape == (3 * 4, 3)
    assert tris.shape == (2 * 3 * 2, 3)
    np.testing.assert_allclose(tc, pos[:, :2])
    np.testing.assert_array_equal(tris[0], [0, 1, 3])
    np.testing.assert_array_equal(tris[2], [1, 2, 5])
    quads, *_ = _both(lambda g: g.make_faces(2, 2, pos_fn,
                                             as_triangles=False))
    assert quads.shape == (4, 4)
    np.testing.assert_array_equal(quads[0], [0, 1, 4, 3])
    _both(lambda g: g.make_faces(5, 7, pos_fn, norm_fn=norm_fn,
                                 texcoord_fn=lambda uv: uv * 2))


def test_make_lines_and_points():
    lines, pos, tang, tc, rad = _both(lambda g: g.make_lines(
        3, 4, lambda j, u: np.stack([u, j.astype(np.float32),
                                     np.zeros_like(u)], axis=-1)))
    assert lines.shape == (12, 2)
    assert pos.shape == (15, 3)
    np.testing.assert_array_equal(lines[0], [0, 1])
    np.testing.assert_array_equal(lines[4], [5, 6])
    pts, pos, norm, tc, rad = _both(lambda g: g.make_points(
        5, lambda i: np.stack([i.astype(np.float32), np.zeros(5),
                               np.zeros(5)], axis=-1)))
    np.testing.assert_array_equal(pts, np.arange(5))
    assert pos.shape == (5, 3) and rad.shape == (5,)


def test_merge_meshes():
    ta = np.asarray([[0, 1, 2]], np.int32)
    va = dict(pos=np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32))
    tb = np.asarray([[0, 1, 2]], np.int32)
    vb = dict(pos=np.asarray([[5, 0, 0], [6, 0, 0], [5, 1, 0]], np.float32))
    elems, verts = _both(lambda g: g.merge_meshes(ta, va, tb, vb))
    assert elems.shape == (2, 3)
    np.testing.assert_array_equal(elems[1], [3, 4, 5])
    assert len(verts["pos"]) == 6


def test_tesselated_mesh_renders():
    """A tesselated shape through both packages' finalize and scene build
    (the same leaves), then the port's frame on the CPU."""
    built = []
    for geo, scn, tsc in ((tgeo, tscene, tts), (jgeo, jscene, jts)):
        host = tsc.make_random_scene(seed=4, n_instances=1, n_shapes=1,
                                     n_lines=0, n_points=0, n_tris=4)
        shp = host.shapes[0]
        nt, nv = geo.tesselate_triangles(
            shp.triangles, dict(pos=shp.pos, texcoord=shp.texcoord,
                                radius=shp.radius))
        shp.triangles = nt
        shp.pos = nv["pos"].astype(np.float32)
        shp.texcoord = nv["texcoord"].astype(np.float32)
        shp.radius = nv["radius"].astype(np.float32)
        shp.norm = np.zeros((0, 3), np.float32)
        scn.finalize_scene(host)
        built.append(scn.build_device_scene(host))
    (leaves, meta), (jd, _) = built
    for k in leaves:
        assert_same(np.asarray(leaves[k]), np.asarray(getattr(jd, k)), k)
    img = tren.render_image(tscene.to_torch(leaves, "cpu"), meta, 16, 16,
                            samples=1, ambient=0.3, max_depth=1)
    assert np.isfinite(img).all()


# --------------------------------------------------------------------------
# procedural (tests/test_procedural.py)
# --------------------------------------------------------------------------


def test_grid_structure():
    img = tproc.make_grid_image(64, 64, 16)
    assert_same(img, jproc.make_grid_image(64, 64, 16))
    assert img.shape == (64, 64, 4)
    assert (img[0, :, 0] == 90).all()
    assert (img[8, 8] == [128, 128, 128, 255]).all()


def test_checker_structure():
    img = tproc.make_checker_image(64, 64, 16)
    assert_same(img, jproc.make_checker_image(64, 64, 16))
    assert (img[0, 0] == [90, 90, 90, 255]).all()
    assert (img[0, 16] == [128, 128, 128, 255]).all()


def test_bump_to_normal_unit_length():
    bump = tproc.make_bumpdimple_image(64, 64, 16)
    nm = tproc.bump_to_normal_map(bump, 4.0)
    assert_same(nm, jproc.bump_to_normal_map(
        jproc.make_bumpdimple_image(64, 64, 16), 4.0))
    n = nm[..., :3].astype(np.float32) / 255.0 * 2.0 - 1.0
    ln = np.linalg.norm(n, axis=-1)
    assert np.all(ln < 1.1) and np.all(ln > 0.85)
    assert nm[..., 3].min() == 255


MAKERS = [
    ("grid", lambda p, w, h, t: p.make_grid_image(w, h, t)),
    ("grid_colors", lambda p, w, h, t: p.make_grid_image(
        w, h, t, (1, 2, 3, 4), (250, 200, 150, 100))),
    ("checker", lambda p, w, h, t: p.make_checker_image(w, h, t)),
    ("bumpdimple", lambda p, w, h, t: p.make_bumpdimple_image(w, h, t)),
    ("ramp", lambda p, w, h, t: p.make_ramp_image(
        w, h, (10, 20, 30, 255), (200, 100, 50, 255))),
    ("ramp_srgb", lambda p, w, h, t: p.make_ramp_image(
        w, h, (10, 20, 30, 255), (200, 100, 50, 255), srgb=True)),
    ("gammaramp", lambda p, w, h, t: p.make_gammaramp_image(w, h)),
    ("gammaramp_f", lambda p, w, h, t: p.make_gammaramp_imagef(w, h)),
    ("uv", lambda p, w, h, t: p.make_uv_image(w, h)),
    ("uvgrid", lambda p, w, h, t: p.make_uvgrid_image(w, h, t, True)),
    ("uvgrid_gray", lambda p, w, h, t: p.make_uvgrid_image(w, h, t, False)),
    ("recuvgrid", lambda p, w, h, t: p.make_recuvgrid_image(w, h, t, True)),
    ("recuvgrid_gray",
     lambda p, w, h, t: p.make_recuvgrid_image(w, h, t, False)),
    ("bump_normal", lambda p, w, h, t: p.bump_to_normal_map(
        p.make_bumpdimple_image(w, h, t), 4.0)),
    ("uvgrid_normal", lambda p, w, h, t: p.bump_to_normal_map(
        p.make_uvgrid_image(w, h, t), 0.5)),
]
SIZES = [(64, 64, 16), (128, 128, 32), (96, 160, 32)]


@pytest.mark.parametrize("size", SIZES, ids=["64", "128", "96x160"])
@pytest.mark.parametrize("name,maker", MAKERS, ids=[m[0] for m in MAKERS])
def test_procedural_maker_equals_jax(name, maker, size):
    w, h, t = size
    img = maker(tproc, w, h, t)
    assert_same(img, maker(jproc, w, h, t), name)
    assert img.shape == (h, w, 4)


# --------------------------------------------------------------------------
# keyframe animation (tests/test_geometry_extras.py:103, 112)
# --------------------------------------------------------------------------


def test_update_animation_stepwise_index():
    for mod in (tanim, janim):
        assert mod.keyframe_index(0.0, 1 / 60, 4) == 0
        assert mod.keyframe_index(1 / 60 * 1.5, 1 / 60, 4) == 1
        assert mod.keyframe_index(1 / 60 * 9, 1 / 60, 4) == 1
    times = np.asarray([0.0, 0.02, 0.1, -0.03, 7.7, 1e3], np.float32)
    idx = tanim.keyframe_index(times, 1 / 60, 4)
    assert_same(idx, janim.keyframe_index(times, 1 / 60, 4))
    np.testing.assert_array_equal(idx[:3], [0, 1, 2])


def _playback(anim_mod, testscenes):
    host = testscenes.make_random_scene(seed=0)
    anim = anim_mod.Animation(delta_t=0.5)
    ist = host.instances[0]
    base_o = ist.o.copy()
    base_pos = host.shapes[ist.shape].pos.copy()
    anim_mod.add_keyframe(host, 0, anim)
    ist.o = base_o + np.float32(1.0)
    host.shapes[ist.shape].pos = base_pos + np.float32(2.0)
    anim_mod.add_keyframe(host, 0, anim)
    assert anim.num_keyframes == 2
    states = []
    for time in (0.0, 0.6, 1.1):
        anim_mod.update_animation(host, 0, anim, time=time)
        states.append((host.instances[0].o.copy(),
                       host.shapes[ist.shape].pos.copy()))
    np.testing.assert_array_equal(states[0][0], base_o)
    np.testing.assert_array_equal(states[0][1], base_pos)
    np.testing.assert_array_equal(states[1][0], base_o + 1.0)
    np.testing.assert_array_equal(states[2][0], base_o)
    return states, anim_mod.stack_tracks(anim)


def test_animation_roundtrip_and_playback():
    states, tracks = _playback(tanim, tts)
    assert_same((states, tracks), _playback(janim, jts))
    axes, o, pos, norm = tracks
    assert axes.shape == (2, 3, 3) and o.shape == (2, 3)
    assert pos.shape[0] == 2 and norm.shape[0] == 2


# --------------------------------------------------------------------------
# OBJ tetrahedra (tests/test_geometry_extras.py:24)
# --------------------------------------------------------------------------


def test_obj_parses_tetrahedra(tmp_path):
    """``t`` lines reach ``HostShape.tetrahedra`` through ``load_scene``,
    as in the JAX package."""
    obj = tmp_path / "tet.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 1\nv 1 1 1\n"
                   "t 1 2 3 4\nt 2 3 4 5\n"
                   "f 1 2 3\n")
    got = tscene.load_scene(str(obj))
    want = jscene.load_scene(str(obj))
    for a, b in zip(got.shapes, want.shapes):
        assert_same(a.tetrahedra, b.tetrahedra, "tetrahedra")
        assert_same(a.triangles, b.triangles, "triangles")
        assert_same(a.tangsp, b.tangsp, "tangsp")
    np.testing.assert_array_equal(got.shapes[0].tetrahedra,
                                  [[0, 1, 2, 3], [1, 2, 3, 4]])


# --------------------------------------------------------------------------
# quad and tetrahedron intersection (tests/test_geometry_extras.py:44-96)
# --------------------------------------------------------------------------


def _ray_grid(n=64, seed=0):
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    ro[:, 2] = 3.0
    rd = np.tile(np.asarray([[0, 0, -1.0]], np.float32), (n, 1))
    jitter = rng.normal(scale=0.2, size=(n, 3)).astype(np.float32)
    rd = (rd + jitter) / np.linalg.norm(rd + jitter, axis=-1, keepdims=True)
    tmin = np.full(n, 1e-4, np.float32)
    tmax = np.full(n, 3.4e38, np.float32)
    return ro, rd, tmin, tmax


QUADS = [
    ("planar", [[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]]),
    ("skewed", [[-1, -1, 0], [1.5, -1, 0.5], [1, 1.2, -0.3], [-1, 1, 0.2]]),
]
TETRAS = [
    ("unit", [[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]]),
    ("big", [[-1.5, -1.5, -1], [1.5, -1, 0], [0, 1.5, 0.5], [0, 0, 1.5]]),
]


def _torch(*arrays):
    return [torch.from_numpy(np.asarray(a, np.float32)) for a in arrays]


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("name,verts", QUADS, ids=[q[0] for q in QUADS])
def test_intersect_quad_equals_jax(name, verts, seed):
    rays = _ray_grid(seed=seed)
    v = np.asarray(verts, np.float32)
    hit, t, euv = tisect.intersect_quad(*_torch(*rays), *_torch(*v))
    with jax.disable_jit():
        jh, jt, je = jisect.intersect_quad(
            *map(jnp.asarray, rays), *map(jnp.asarray, v))
    assert_same(hit.numpy(), np.asarray(jh), "hit")
    assert_same(t.numpy(), np.asarray(jt), "t")
    assert_same(euv.numpy(), np.asarray(je), "euv")
    assert hit.any() and not hit.all()
    s = euv.sum(-1).numpy()[hit.numpy()]
    np.testing.assert_allclose(s, 1.0, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("name,verts", TETRAS, ids=[q[0] for q in TETRAS])
def test_intersect_tetrahedron_equals_jax(name, verts, seed):
    rays = _ray_grid(seed=seed)
    v = np.asarray(verts, np.float32)
    hit, t = tisect.intersect_tetrahedron(*_torch(*rays), *_torch(*v))
    with jax.disable_jit():
        jh, jt = jisect.intersect_tetrahedron(
            *map(jnp.asarray, rays), *map(jnp.asarray, v))
    assert_same(hit.numpy(), np.asarray(jh), "hit")
    assert_same(t.numpy(), np.asarray(jt), "t")
    # the nearest of the four face tests (test_geometry_extras.py:76-96)
    ts = [tisect.intersect_triangle(*_torch(*rays), *_torch(a, b, c))[1]
          for a, b, c in (v[[0, 1, 2]], v[[0, 1, 3]], v[[0, 2, 3]],
                          v[[1, 2, 3]])]
    np.testing.assert_array_equal(t.numpy(),
                                  torch.stack(ts).amin(0).numpy())
    assert hit.any()
