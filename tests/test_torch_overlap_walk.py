"""K11's culled walk (``ops/overlap.py::overlap_scene_walk_plain``, the CPU
path of ``overlap_scene``) and its records (``refit_plain``).

* the refit equals the build's ``node_bbox_min/max`` bit for bit on
  unmoved scenes, its words decode to the BVH's structure, and after
  ``pos`` and ``radius`` move (no rebuild) every node's box contains its
  prims' boxes;
* the walk bit-equal (found, inst, prim equal; dist and euv equal as int32
  views) to JAX's ``overlap_scene`` run op by op (``jax.disable_jit``) and
  ``torch.equal`` to the port's brute force (``overlap_scene_plain``), on
  queries made to attack the skip test: at exactly the winner's distance as
  ``dist_max`` and one f32 ULP either side, at distance ``dist_max`` from
  vertices, edge midpoints and faces, on node-box faces and corners and one
  ULP off them; duplicated prims and instances (ties decide prim and
  inst); per-query ``dist_max``; ``pos`` and ``radius`` moved after the
  build; thin and collinear triangles; rotated and scaled instance frames;
* the walk refits on every call: moving the same scene's ``pos`` and
  ``radius`` moves its answers with the brute force's;
* on the hair scene at ``dist_max`` 0.2 the walk tests far fewer prims
  than the brute force's (query, prim) pairs.

Inputs come from numpy seeds.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from yocto_raytracing_tpu import scene as jscene
from yocto_raytracing_tpu.ops import overlap as joverlap
from yocto_raytracing_tpu_torch import scene as tscene, testscenes as tts
from yocto_raytracing_tpu_torch.kernels import parity
from yocto_raytracing_tpu_torch.ops import overlap as toverlap
from yocto_raytracing_tpu_torch.scene import HostInstance, HostMaterial

F32 = np.float32


def _frame(rng, scale=(1.0, 1.0, 1.0)):
    """A random rotation, its rows scaled by ``scale``."""
    ax = rng.normal(size=3)
    ax /= np.linalg.norm(ax)
    ang = rng.uniform(0, 2 * np.pi)
    k = np.array([[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]], [-ax[1], ax[0], 0]])
    rot = np.eye(3) + np.sin(ang) * k + (1 - np.cos(ang)) * k @ k
    return (rot * np.asarray(scale)[:, None]).astype(F32)


def _adversarial_host(seed=0):
    """Two shapes, six instances: random triangles with duplicates, thin
    needles (two vertices one ULP apart), a collinear triangle and
    triangles with a repeated vertex; lines and points with radii, some
    duplicated. Instances 0 and 1 (and 3 and 4) are identical, 2 is
    rotated and moved, 5 is rotated with scaled axes."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1, 1, (24, 3)).astype(F32)
    tris = [tuple(rng.integers(0, 24, 3)) for _ in range(28)]
    tris += tris[:4]                                   # duplicated prims
    tris += [(0, 0, 5), (6, 7, 7), (8, 9, 8)]          # repeated vertices
    a = np.array([0.3, -0.2, 0.4], F32)
    extra = [a, np.nextafter(a, F32(2)), np.array([0.9, 0.7, -0.5], F32),
             np.array([-0.5, 0.25, 0.5], F32), np.array([0.0, 0.5, 0.0], F32),
             np.array([0.5, 0.75, -0.5], F32)]        # needle, collinear
    base = len(pos)
    pos = np.concatenate([pos, np.stack(extra)])
    tris += [(base, base + 1, base + 2), (base + 2, base, base + 1),
             (base + 3, base + 4, base + 5)]
    mesh = tts._shape("mesh", pos, triangles=np.asarray(tris, np.int32),
                      radius=rng.uniform(0, 0.03, len(pos)).astype(F32))
    cpos = rng.uniform(-1, 1, (20, 3)).astype(F32)
    lines = [(2 * i, 2 * i + 1) for i in range(8)] + [(0, 1), (2, 3)]
    points = [16, 17, 18, 19, 16]
    curves = tts._shape("curves", cpos, points=points, lines=lines,
                        radius=rng.uniform(0.005, 0.05, 20).astype(F32))
    eye, zero = np.eye(3, dtype=F32), np.zeros(3, F32)
    frames = [(eye, zero, 0), (eye, zero, 0),
              (_frame(rng), rng.uniform(-2, 2, 3).astype(F32), 0),
              (eye, zero, 1), (eye, zero, 1),
              (_frame(rng, (1.7, 0.6, 1.0)), rng.uniform(-2, 2, 3).astype(F32),
               1)]
    instances = [HostInstance(name=f"i{k}", axes=ax, o=o, shape=s,
                              material=0)
                 for k, (ax, o, s) in enumerate(frames)]
    cam = tts.lookat_camera("cam", eye=(0, 0, 6), target=(0, 0, 0))
    return tts.assemble([mesh, curves], [HostMaterial(name="m")], [0, 0],
                        [cam], instances=instances)


def _built(host):
    leaves, meta = tscene.build_device_scene(host)
    return leaves, meta


def _moved(leaves, seed):
    """pos and radius moved after the build (no rebuild)."""
    rng = np.random.default_rng(seed)
    out = dict(leaves)
    out["pos"] = (leaves["pos"] + rng.normal(
        scale=0.05, size=leaves["pos"].shape)).astype(F32)
    out["radius"] = (leaves["radius"] * rng.uniform(
        0.5, 2.0, leaves["radius"].shape)).astype(F32)
    return out


def _both(leaves, meta, q, dist_max):
    """(JAX op by op, the port's walk, the port's brute force), numpy /
    torch dicts."""
    js = jscene.DeviceScene(**{k: jnp.asarray(v) for k, v in leaves.items()})
    with jax.disable_jit():
        ref = joverlap.overlap_scene(js, meta, jnp.asarray(q),
                                     jnp.asarray(dist_max))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    ts = tscene.to_torch(leaves, "cpu")
    qt = torch.from_numpy(q)
    dm = torch.from_numpy(np.broadcast_to(np.asarray(dist_max, F32),
                                          (len(q),)).copy())
    walk = toverlap.overlap_scene(ts, meta, qt, dm)
    brute = toverlap.overlap_scene_plain(ts, meta, qt, dm)
    return ref, walk, brute


def _assert_bit_equal(ref, walk, brute):
    assert parity.overlap_identical(walk, brute)
    for k in ("found", "inst", "prim"):
        np.testing.assert_array_equal(walk[k].numpy(), ref[k], err_msg=k)
    for k in ("dist", "euv"):
        np.testing.assert_array_equal(walk[k].numpy().view(np.int32),
                                      ref[k].view(np.int32), err_msg=k)


def _ulps(x):
    """x, and x one f32 ULP down and up (every coordinate)."""
    x = np.asarray(x, F32)
    return [x, np.nextafter(x, F32(-np.inf)), np.nextafter(x, F32(np.inf))]


def _nearest(leaves, meta, q):
    """The brute force's nearest distance of every query (dist_max 10)."""
    ts = tscene.to_torch(leaves, "cpu")
    out = toverlap.overlap_scene_plain(ts, meta, torch.from_numpy(q), 10.0)
    return out["dist"].numpy()


def _at_winner_distance(leaves, meta, q):
    """Each query three times, with dist_max its own nearest distance and
    one ULP either side: the fold's and the skip test's limit. A neighbour
    that would be subnormal is left at the distance itself: XLA:CPU
    flushes subnormals to zero, the port (and IEEE) does not."""
    d = _nearest(leaves, meta, q)
    tiny = np.finfo(F32).tiny
    dm = [np.where(np.abs(x) < tiny, d, x) for x in _ulps(d)]
    return np.concatenate([q] * 3), np.concatenate(dm)


def _feature_queries(leaves, rng, n, dist):
    """Queries at ``dist`` from vertices, edge midpoints and triangle
    faces (along the face normal) of the scene's triangles."""
    pos = leaves["pos"]
    tri = leaves["prim_v"][leaves["prim_type"] == 2]
    pick = tri[rng.integers(0, len(tri), n)]
    v = pos[pick]                                              # (n, 3, 3)
    nrm = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-12)
    k = rng.integers(0, 3, n)
    vert = v[np.arange(n), k]
    edge = (v[np.arange(n), k] + v[np.arange(n), (k + 1) % 3]) / 2
    face = v.mean(axis=1)
    out = [vert + dist * nrm, edge + dist * nrm, face + dist * nrm,
           vert + np.array([dist, 0, 0])]
    return np.concatenate(out).astype(F32)


def _box_queries(leaves, rng, n):
    """Corners and face centres of shape-node boxes, and one ULP off
    them."""
    shape = leaves["node_kind"] == 1
    lo, hi = leaves["node_bbox_min"][shape], leaves["node_bbox_max"][shape]
    pick = rng.integers(0, len(lo), n)
    lo, hi = lo[pick], hi[pick]
    corner = np.where(rng.integers(0, 2, (n, 3)) == 1, hi, lo)
    face = (lo + hi) / 2
    axis = rng.integers(0, 3, n)
    face[np.arange(n), axis] = np.where(rng.integers(0, 2, n) == 1,
                                        hi[np.arange(n), axis],
                                        lo[np.arange(n), axis])
    return np.concatenate(_ulps(corner) + _ulps(face)).astype(F32)


CASES = ("vertices_edges_faces", "winner_distance", "box_faces_corners",
         "per_query_dist_max", "moved", "moved_winner_distance")


@pytest.mark.parametrize("case", CASES)
def test_walk_bit_equal_jax_adversarial(case):
    leaves, meta = _built(_adversarial_host(0))
    rng = np.random.default_rng(sum(map(ord, case)))
    if case.startswith("moved"):
        leaves = _moved(leaves, 5)
    if case == "vertices_edges_faces":
        q = _feature_queries(leaves, rng, 48, 0.1)
        dm = np.full(len(q), 0.1, F32)
    elif case == "box_faces_corners":
        q = _box_queries(leaves, rng, 40)
        dm = rng.choice(np.asarray([0.0, 1e-3, 0.05, 0.3], F32), len(q))
    elif case == "per_query_dist_max":
        q = rng.uniform(-2.5, 2.5, (400, 3)).astype(F32)
        dm = rng.uniform(0, 0.6, 400).astype(F32)
    elif case == "moved":
        q = np.concatenate([_feature_queries(leaves, rng, 32, 0.05),
                            rng.uniform(-2.5, 2.5, (200, 3)).astype(F32)])
        dm = np.full(len(q), 0.2, F32)
    else:
        q = np.concatenate([_feature_queries(leaves, rng, 24, 0.07),
                            rng.uniform(-2.5, 2.5, (80, 3)).astype(F32)])
        q, dm = _at_winner_distance(leaves, meta, q)
    ref, walk, brute = _both(leaves, meta, q, dm)
    _assert_bit_equal(ref, walk, brute)
    found = walk["found"].numpy()
    assert 0.05 < found.mean() < 1.0, found.mean()
    if case.endswith("winner_distance"):
        # at its own distance (and one ULP above) every query finds
        n = len(q) // 3
        assert found[:n].all() and found[2 * n:].all()


def test_walk_ties_decide_prim_and_inst():
    """Duplicated prims and instances: the winners are the last prim and
    the last instance of each tie, as JAX's."""
    leaves, meta = _built(_adversarial_host(1))
    rng = np.random.default_rng(3)
    q = _feature_queries(leaves, rng, 64, 0.02)
    ref, walk, brute = _both(leaves, meta, q, np.full(len(q), 0.5, F32))
    _assert_bit_equal(ref, walk, brute)
    inst = walk["inst"].numpy()
    # instances 0 and 1 (and 3 and 4) are the same: 0 and 3 never win
    assert not np.isin(inst, [0, 3]).any() and np.isin(inst, [1, 4]).any()
    prim = walk["prim"].numpy()
    dup = np.arange(4)           # triangles 0-3 repeat as 28-31
    assert not np.isin(prim, dup).any()


@pytest.mark.parametrize("name", ["random0", "random3", "hair",
                                  "adversarial", "grad"])
def test_refit_equals_build_boxes(name):
    host = {"random0": lambda: tts.make_random_scene(seed=0),
            "random3": lambda: tts.make_random_scene(seed=3),
            "hair": lambda: tts.make_hair_scene(64),
            "adversarial": lambda: _adversarial_host(0),
            "grad": tts.make_grad_scene}[name]()
    leaves, meta = _built(host)
    ts = tscene.to_torch(leaves, "cpu")
    rec = toverlap.refit_plain(ts)
    w = rec.nodes.view(torch.int32).numpy()
    np.testing.assert_array_equal(w[:, 0:3],
                                  leaves["node_bbox_min"].view(np.int32))
    np.testing.assert_array_equal(w[:, 3:6],
                                  leaves["node_bbox_max"].view(np.int32))
    np.testing.assert_array_equal(w[:, 6] >> 4, leaves["node_start"])
    np.testing.assert_array_equal(w[:, 6] & 15,
                                  np.minimum(leaves["node_count"], 15))
    np.testing.assert_array_equal(w[:, 7] >> 2, leaves["node_skip"])
    np.testing.assert_array_equal(w[:, 7] & 1, leaves["node_isleaf"])
    # the prim records are bit copies of the leaves, slot by slot
    ni = len(leaves["inst_axes"])
    p = rec.prims.view(torch.int32).numpy()
    prim = leaves["leaf_items"][ni:]
    pv = leaves["prim_v"][prim]
    thin_bit = toverlap.THIN_BIT
    np.testing.assert_array_equal((p[:, 12] & ~thin_bit) >> 2, prim)
    np.testing.assert_array_equal(p[:, 12] & 3, leaves["prim_type"][prim])
    _, _, pflag, _ = toverlap._slot_boxes(ts, torch.from_numpy(prim))
    np.testing.assert_array_equal((p[:, 12] & thin_bit) != 0, pflag.numpy())
    for k in range(3):
        np.testing.assert_array_equal(p[:, 4 * k:4 * k + 3],
                                      leaves["pos"][pv[:, k]].view(np.int32))
        np.testing.assert_array_equal(
            p[:, 4 * k + 3], leaves["radius"][pv[:, k]].view(np.int32))
    # a node is flagged exactly when a flagged prim lies under it
    flag = (w[:, 7] >> 1) & 1
    assert not flag[leaves["node_kind"] == 0].any()
    if name == "adversarial":
        assert flag.any()
    if name == "random0":
        assert not flag.any()


def _subtree_prims(leaves, n):
    """Pool ids of the prims under shape node n."""
    out, stack = [], [n]
    while stack:
        m = stack.pop()
        s = leaves["node_start"][m]
        if leaves["node_isleaf"][m]:
            out.extend(leaves["leaf_items"][s:s + leaves["node_count"][m]])
        else:
            stack.extend([s, s + 1])
    return np.asarray(out)


@pytest.mark.parametrize("seed", [0, 1])
def test_refit_contains_moved_prims(seed):
    """After pos and radius move, every shape node's box holds the boxes
    of the prims under it, and the same nodes are flagged as thin-triangle
    ancestors as a refit of the moved scene's own prims says."""
    leaves, meta = _built(_adversarial_host(seed))
    moved = _moved(leaves, 10 + seed)
    ts = tscene.to_torch(moved, "cpu")
    rec = toverlap.refit_plain(ts)
    nodes = rec.nodes.numpy()
    flags = (rec.nodes.view(torch.int32).numpy()[:, 7] >> 1) & 1
    prim = torch.arange(len(moved["prim_type"]), dtype=torch.int32)
    plo, phi, pflag, _ = toverlap._slot_boxes(ts, prim)
    plo, phi, pflag = plo.numpy(), phi.numpy(), pflag.numpy()
    moved_any = False
    for n in np.nonzero(moved["node_kind"] == 1)[0]:
        sub = _subtree_prims(moved, n)
        lo, hi = plo[sub].min(axis=0), phi[sub].max(axis=0)
        np.testing.assert_array_equal(nodes[n, 0:3], lo)
        np.testing.assert_array_equal(nodes[n, 3:6], hi)
        assert flags[n] == pflag[sub].any()
        v = moved["pos"][moved["prim_v"][sub]].reshape(-1, 3)
        assert (v >= nodes[n, 0:3]).all() and (v <= nodes[n, 3:6]).all()
        moved_any |= not np.array_equal(lo, leaves["node_bbox_min"][n])
    assert moved_any


@pytest.mark.parametrize("seed", [2, 3])
def test_walk_refits_on_every_call(seed):
    """The walk refits its records on every call: after ``pos`` and
    ``radius`` of the same scene move, its answers are the brute force's
    on the moved scene, not those of the earlier boxes."""
    leaves, meta = _built(_adversarial_host(seed))
    ts = tscene.to_torch(leaves, "cpu")
    rng = np.random.default_rng(seed + 2)
    q = torch.from_numpy(rng.uniform(-2.5, 2.5, (300, 3)).astype(F32))
    before = toverlap.overlap_scene_walk_plain(ts, meta, q, 0.3)
    moved = _moved(leaves, seed + 5)
    ts.pos.copy_(torch.from_numpy(moved["pos"]))
    ts.radius.copy_(torch.from_numpy(moved["radius"]))
    a = toverlap.overlap_scene_walk_plain(ts, meta, q, 0.3)
    assert parity.overlap_identical(
        a, toverlap.overlap_scene_plain(ts, meta, q, 0.3))
    assert not parity.overlap_identical(a, before)
    assert 0 < a["found"].float().mean() < 1


def test_walk_tests_fewer_prims_than_brute_force():
    """The hair scene at dist_max 0.2: the walk's prim tests are a small
    share of the brute force's (query, prim) pairs, and its answers the
    brute force's."""
    leaves, meta = _built(tts.make_hair_scene(256))
    ts = tscene.to_torch(leaves, "cpu")
    rng = np.random.default_rng(11)
    q = torch.from_numpy(rng.uniform([-1.5, -0.2, -1.5], [1.5, 2.2, 1.5],
                                     (512, 3)).astype(F32))
    stats = {}
    walk = toverlap.overlap_scene_walk_plain(ts, meta, q, 0.2, stats=stats)
    brute = toverlap.overlap_scene_plain(ts, meta, q, 0.2)
    assert parity.overlap_identical(walk, brute)
    tests = sum(stats[k] for k in toverlap.WALK_STATS[1:])
    pairs = len(q) * meta.num_prims
    assert tests < pairs / 10, (stats, pairs)
    assert stats["nodes"] < pairs / 10, (stats, pairs)
    assert 0.05 < walk["found"].float().mean() < 0.95
