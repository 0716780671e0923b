"""The port's overlap query (``ops/overlap.py``, K11's plain version) and
brute-force oracle (``ops/brute.py``) == the JAX package's.

* every primitive helper (``closestuv_line``, ``closestuv_triangle``,
  ``overlap_point/line/triangle/quad/tetrahedron``, ``distance_check_bbox``,
  ``overlap_bbox``) bit-equal to JAX run op by op (``jax.disable_jit``) on
  random inputs from numpy seeds;
* ``overlap_scene`` (on the CPU the culled walk,
  ``overlap_scene_walk_plain``) against the JAX function jitted in the
  no-FMA child (``tests/jax_nofma.py``) on ``make_random_scene`` seeds 0-3
  and the hair scene, at ``dist_max`` 10, 1.0 and 0.05: ``found``,
  ``inst`` and ``prim`` equal, ``dist`` and ``euv`` bit-equal, and every
  output ``torch.equal`` to the brute force (``overlap_scene_plain``);
* ``intersect_scene_brute`` against the port's own BVH walk
  (``traverse.intersect_scene_plain``) on random rays, as
  ``tests/test_bvh.py`` holds the JAX walk to the JAX oracle.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import jax_nofma
from yocto_raytracing_tpu.ops import overlap as joverlap
from yocto_raytracing_tpu_torch import scene as tscene, testscenes as tts
from yocto_raytracing_tpu_torch.kernels import parity
from yocto_raytracing_tpu_torch.ops import brute as tbrute
from yocto_raytracing_tpu_torch.ops import overlap as toverlap
from yocto_raytracing_tpu_torch.ops import traverse as ttrav

FLT_MAX = np.float32(3.4028235e38)
N = 3000


def _inputs(seed, n=N):
    """Query points, vertices and radii (f32) that land in every case of
    the triangle cascade: queries around small random triangles."""
    rng = np.random.default_rng(seed)
    f = np.float32
    v = [rng.uniform(-1, 1, (n, 3)).astype(f) for _ in range(4)]
    pos = (rng.uniform(-2, 2, (n, 3))).astype(f)
    r = [rng.uniform(0, 0.1, n).astype(f) for _ in range(4)]
    r[0][::7] = 0.0
    dist_max = rng.uniform(0.05, 2.0, n).astype(f)
    return pos, dist_max, v, r


def _both(fn_name, args):
    """(JAX op by op, port) results of ``fn_name`` on numpy ``args``, as
    tuples of numpy arrays."""
    with jax.disable_jit():
        a = getattr(joverlap, fn_name)(*(jnp.asarray(x) for x in args))
    b = getattr(toverlap, fn_name)(*(torch.from_numpy(x) for x in args))
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return [np.asarray(x) for x in a], [x.numpy() for x in b]


def _arguments(fn_name, seed):
    pos, dm, v, r = _inputs(seed)
    return {
        "closestuv_line": (pos, v[0], v[1]),
        "closestuv_triangle": (pos, v[0], v[1], v[2]),
        "overlap_point": (pos, dm, v[0], r[0]),
        "overlap_line": (pos, dm, v[0], v[1], r[0], r[1]),
        "overlap_triangle": (pos, dm, v[0], v[1], v[2], r[0],
                             r[1], r[2]),
        "overlap_quad": (pos, dm, v[0], v[1], v[2], v[3], *r),
        "overlap_tetrahedron": (pos, dm, v[0], v[1], v[2], v[3], *r),
        "distance_check_bbox": (pos, dm, np.minimum(v[0], v[1]),
                                np.maximum(v[0], v[1])),
        "overlap_bbox": (np.minimum(v[0], v[1]), np.maximum(v[0], v[1]),
                         np.minimum(v[2], pos), np.maximum(v[2], pos)),
    }[fn_name]


@pytest.mark.parametrize("fn_name", [
    "closestuv_line", "closestuv_triangle", "overlap_point", "overlap_line",
    "overlap_triangle", "overlap_quad", "overlap_tetrahedron",
    "distance_check_bbox", "overlap_bbox"])
def test_helpers_bit_equal_jax(fn_name):
    for seed in (0, 1):
        got_j, got_t = _both(fn_name, _arguments(fn_name, seed))
        assert len(got_j) == len(got_t)
        for a, b in zip(got_j, got_t):
            assert a.dtype == b.dtype and a.shape == b.shape, fn_name
            np.testing.assert_array_equal(b.view(np.uint8), a.view(np.uint8),
                                          err_msg=fn_name)
        if fn_name.startswith("overlap_") and fn_name != "overlap_bbox":
            ok = got_t[0]
            assert 0 < ok.mean() < 1, (fn_name, ok.mean())


def test_closestuv_triangle_takes_every_case():
    """The random inputs reach every corner, edge and face case."""
    pos, _, v, _ = _inputs(0)
    uv = toverlap.closestuv_triangle(*(torch.from_numpy(x) for x in
                                       (pos, v[0], v[1], v[2]))).numpy()
    ones = (uv == 1.0).sum(axis=0)
    zeros = (uv == 0.0).sum(axis=-1)
    assert (ones > 0).all()                      # three corners
    assert ((zeros == 1).sum()) > 0              # edges
    assert ((zeros == 0).sum()) > 0              # face


SCENES = {
    "random0": ("make_random_scene", {"seed": 0}),
    "random1": ("make_random_scene", {"seed": 1}),
    "random2": ("make_random_scene", {"seed": 2}),
    "random3": ("make_random_scene", {"seed": 3}),
    "hair": ("make_hair_scene", {"n_strands": 32}),
}
DIST_MAX = (10.0, 1.0, 0.05)
NQ = 512


def _queries(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    lo, hi = ((-4, 4) if name != "hair" else (-1, 2))
    q = rng.uniform(lo, hi, (NQ, 3)).astype(np.float32)
    if name == "hair":   # around the hair ball, where the strands are
        q[: NQ // 2] = (rng.normal(size=(NQ // 2, 3)) * 0.5
                        + [0, 1, 0]).astype(np.float32)
    return q


@functools.lru_cache(maxsize=None)
def _jax_overlap(name):
    """The JAX answers for the three dist_max, one child process per scene
    (the three query sets stacked)."""
    fn, kw = SCENES[name]
    q = _queries(name)
    dm = np.repeat(np.asarray(DIST_MAX, np.float32), NQ)
    return jax_nofma.overlap(fn, kw, np.concatenate([q] * len(DIST_MAX)), dm)


@pytest.mark.parametrize("dist_max", DIST_MAX)
@pytest.mark.parametrize("name", list(SCENES))
def test_overlap_scene_matches_jax(name, dist_max):
    fn, kw = SCENES[name]
    leaves, meta = tscene.build_device_scene(getattr(tts, fn)(**kw))
    ts = tscene.to_torch(leaves, "cpu")
    q = _queries(name)
    got = toverlap.overlap_scene(ts, meta, torch.from_numpy(q), dist_max)
    assert parity.overlap_identical(got, toverlap.overlap_scene_plain(
        ts, meta, torch.from_numpy(q), dist_max))
    k = DIST_MAX.index(dist_max)
    ref = {key: v[k * NQ:(k + 1) * NQ] for key, v in
           _jax_overlap(name).items()}
    assert sorted(got) == sorted(ref)
    for key in ("found", "inst", "prim"):
        np.testing.assert_array_equal(got[key].numpy(), ref[key],
                                      err_msg=key)
    for key in ("dist", "euv"):
        g = got[key].numpy()
        assert g.dtype == ref[key].dtype == np.float32
        np.testing.assert_array_equal(g.view(np.int32),
                                      ref[key].view(np.int32), err_msg=key)
    share = got["found"].float().mean().item()
    if dist_max == 10.0:
        assert share == 1.0
    elif dist_max == 0.05:
        assert share < 0.5
    found = got["found"].numpy()
    assert (got["inst"].numpy()[~found] == -1).all()
    assert (got["dist"].numpy()[~found] == FLT_MAX).all()
    assert (got["euv"].numpy()[~found] == 0).all()
    # the winner's euv is a partition of unity over its element
    e = got["euv"].numpy()[found]
    np.testing.assert_allclose(e.sum(axis=-1), 1.0, atol=1e-5)


def test_overlap_scene_per_query_dist_max():
    """A (Q,) dist_max equals one call per distinct value."""
    leaves, meta = tscene.build_device_scene(tts.make_random_scene(seed=2))
    ts = tscene.to_torch(leaves, "cpu")
    q = torch.from_numpy(_queries("random2"))
    dm = torch.from_numpy(np.resize(np.asarray(DIST_MAX, np.float32), NQ))
    got = toverlap.overlap_scene(ts, meta, q, dm)
    for k, d in enumerate(DIST_MAX):
        one = toverlap.overlap_scene(ts, meta, q, d)
        sel = dm == d
        for key in got:
            assert torch.equal(got[key][sel], one[key][sel]), (key, d)
    assert 0 < got["found"].float().mean().item() < 1


def _rays(seed, n):
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-4, 4, size=(n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return [torch.from_numpy(x) for x in
            (ro, rd, np.full(n, 1e-4, np.float32),
             np.full(n, FLT_MAX, np.float32))]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_brute_matches_bvh_walk(seed):
    leaves, meta = tscene.build_device_scene(tts.make_random_scene(seed=seed))
    ts = tscene.to_torch(leaves, "cpu")
    rays = _rays(seed + 100, 256)
    got = ttrav.intersect_scene_plain(ts, *rays)
    want = tbrute.intersect_scene_brute(ts, meta, *rays)
    hit_g, hit_w = got["hit"].numpy(), want["hit"].numpy()
    assert (hit_g == hit_w).all(), f"{(hit_g != hit_w).sum()} lanes disagree"
    assert hit_g.sum() > 20
    both = hit_g & hit_w
    t_g, t_w = got["t"].numpy()[both], want["t"].numpy()[both]
    np.testing.assert_allclose(t_g, t_w, rtol=1e-6, atol=1e-6)
    same = got["prim"].numpy()[both] == want["prim"].numpy()[both]
    assert (same | np.isclose(t_g, t_w, rtol=1e-5)).all()
    assert (want["t"].numpy()[~hit_w] == FLT_MAX).all()
