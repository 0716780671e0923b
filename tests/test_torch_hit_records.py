"""K1's packed records (``ops/hit_records.py``) against the scene leaves.

* The records unpack to bit copies of the leaves they were built from,
  field by field and slot by slot, on the scenes the traversal tests use,
  and on a scene whose degenerate leaves hold more than 4 prims and more
  than 7 instances (the saturated counts).
* A walk over the records, decoded as ``kernels/csrc/hit.cu`` decodes them
  and stepping as its kernels step (one ray at a time, the plain walk's
  own math), is ``torch.equal`` to ``traverse.intersect_scene_plain`` on
  every ray, equal-t ties on shared edges and vertices included: this
  holds the kernel's control flow and record layout on the CPU, where no
  CUDA kernel runs. The card tests hold the kernel itself.
* The walk enters an instance whose 12 frame words are the identity's
  bits on the world ray, as ``hit.cu::enter_slot`` does: equal to the
  plain walk on a scene that mixes such frames with frames a bit away from
  them (a -0.0 origin, axis words 1 ulp off 1.0 and +0.0, a -0.0 axis
  word) and rotated ones; ``identity_share`` counts those instances.
* Records packed after a training step hold the new positions.
* The dead-lane rule, ``!(tmax >= tmin)`` -> ``(0, -1, -1, tmax)``, is
  what the plain walk answers for such rays.
* The slab test's NaN guards, which ``hit.cu`` drops for live rays, change
  no bit under ``fmaxf``/``fminf`` semantics.
"""

import numpy as np
import pytest
import torch

from yocto_raytracing_tpu_torch import scene as tscene, testscenes as tts
from yocto_raytracing_tpu_torch.ops import hit_records
from yocto_raytracing_tpu_torch.ops import intersect as isect
from yocto_raytracing_tpu_torch.ops import traverse as ttrav
from yocto_raytracing_tpu_torch.parallel import mesh

FLT_MAX = np.float32(3.4028235e38)


def _degenerate_scene():
    """9 instances with one frame (one scene leaf of count 9) of a shape
    whose 6 triangles share a centroid (one shape leaf of count 6)."""
    host = tts.make_random_scene(seed=4, n_shapes=1, n_instances=9)
    shp = host.shapes[0]
    shp.triangles = np.asarray([[0, 1, 2], [1, 2, 0], [2, 0, 1]] * 2,
                               np.int32)
    for ist in host.instances:
        ist.axes = host.instances[0].axes.copy()
        ist.o = host.instances[0].o.copy()
    return host


SCENES = {
    **{f"random{s}": (lambda s=s: tts.make_random_scene(seed=s))
       for s in range(4)},
    "hair64": lambda: tts.make_hair_scene(64),
    "inst300": lambda: tts.make_random_scene(
        seed=21, n_shapes=2, n_tris=10, n_lines=0, n_points=2,
        n_instances=300),
    "degenerate": _degenerate_scene,
    "mixed": tts.make_mixed_frame_scene,
}


def _scene(name):
    leaves, _ = tscene.build_device_scene(SCENES[name]())
    return tscene.to_torch(leaves, "cpu")


def _bits(t):
    return t.numpy().view(np.int32)


def _rays(seed, n):
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-4, 4, size=(n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return [torch.from_numpy(x) for x in
            (ro, rd, np.full(n, 1e-4, np.float32),
             np.full(n, FLT_MAX, np.float32))]


@pytest.mark.parametrize("name", list(SCENES))
def test_records_copy_leaves(name):
    ts = _scene(name)
    u = hit_records.unpack(hit_records.pack(ts))
    ni = ts.inst_axes.shape[0]
    items = ts.leaf_items.numpy()
    count = ts.node_count.numpy()
    # the scene leaves' slots are 0 .. I-1 (the scene tree comes first)
    scene_leaf = (ts.node_isleaf.numpy() == 1) & (ts.node_kind.numpy() == 0)
    start = ts.node_start.numpy()
    assert (start[scene_leaf] + count[scene_leaf]).max() <= ni
    assert np.array_equal(np.sort(items[:ni]), np.arange(ni))

    for k in ("node_bbox_min", "node_bbox_max"):
        assert np.array_equal(u[k], _bits(getattr(ts, k)))
    for k in ("node_start", "node_skip", "node_isleaf", "node_kind"):
        assert np.array_equal(u[k], getattr(ts, k).numpy()), k
    assert np.array_equal(u["node_count_sat"],
                          np.minimum(count, hit_records.COUNT_SAT))

    prim = items[ni:]
    pv = ts.prim_v.numpy()[prim]
    pos, rad = _bits(ts.pos), _bits(ts.radius)
    assert np.array_equal(u["prim_id"], prim)
    assert np.array_equal(u["prim_type"], ts.prim_type.numpy()[prim])
    for j in range(3):
        assert np.array_equal(u[f"prim_v{j}"], pos[pv[:, j]])
    for j in range(2):
        assert np.array_equal(u[f"prim_r{j}"], rad[pv[:, j]])

    inst = items[:ni]
    assert np.array_equal(u["inst_id"], inst)
    assert np.array_equal(u["inst_axes"], _bits(ts.inst_axes)[inst])
    assert np.array_equal(u["inst_o"], _bits(ts.inst_o)[inst])
    assert np.array_equal(u["inst_shape_root"],
                          ts.inst_shape_root.numpy()[inst])
    if name == "degenerate":
        assert count[scene_leaf].max() > hit_records.COUNT_SAT
        assert count[ts.node_kind.numpy() == 1].max() > 4


def _f32(words):
    return torch.from_numpy(np.asarray(words, np.int32).view(np.float32))


def _records_walk(rec, ro, rd, tmin, tmax, any_hit):
    """hit.cu's walk of one ray over the records (its word decoding and
    its steps), with the plain walk's math on (1, ...) tensors."""
    nodes = rec.nodes.numpy().view(np.int32)
    prims = rec.prims.numpy().view(np.int32)
    insts = rec.insts.numpy().view(np.int32)
    node_count = rec.node_count.numpy()
    ni = insts.shape[0]
    t = tmax.clone()
    hit_inst, hit_prim = -1, -1
    if not bool(tmax[0] >= tmin[0]):          # dead: retired before the walk
        return 0, -1, -1, t

    def frame(axes, o):
        return isect.transform_ray_inverse(axes[None], o[None], ro, rd)

    def enter(slot):
        w = insts[slot]
        if np.array_equal(w[0:12], hit_records.IDENTITY_WORDS):
            lo, ld = world               # the identity's bits: world itself
        else:
            lo, ld = frame(_f32(w[0:9]).reshape(3, 3), _f32(w[9:12]))
        return lo, ld, int(w[12]), int(w[13])

    world = frame(torch.eye(3), torch.zeros(3))
    lo, ld = world
    node, inst = 0, -1
    slot = slot_end = 0
    leaf_skip = -1
    while node >= 0:
        w = nodes[node]
        nstart, nskip = int(w[6]) >> 3, int(w[7]) >> 2
        nleaf, nkind = bool(w[7] & 2), int(w[7] & 1)
        bhit = bool(isect.intersect_bbox(lo, ld, tmin, t, _f32(w[0:3])[None],
                                         _f32(w[3:6])[None])[0])
        if bhit and not nleaf:
            nxt = nstart + 1
        elif bhit and nkind == 1:
            got = False
            for k in range(min(int(w[6]) & 7, 4)):
                p = prims[nstart + k - ni]
                v0, v1, v2 = (_f32(p[j:j + 3])[None] for j in (0, 4, 8))
                r0, r1 = _f32(p[3:4]), _f32(p[7:8])
                ptype = int(p[11]) & 3
                if ptype == 0:
                    h, tk = isect.intersect_point(lo, ld, tmin, t, v0, r0)
                elif ptype == 1:
                    h, tk, _ = isect.intersect_line(lo, ld, tmin, t, v0, v1,
                                                    r0, r1)
                else:
                    h, tk, _, _ = isect.intersect_triangle(lo, ld, tmin, t,
                                                           v0, v1, v2)
                if bool(h[0]):
                    t, hit_inst, got = tk, inst, True
                    hit_prim = int(p[11]) >> 2
            if any_hit and got:
                break
            nxt = nskip
        elif bhit:
            c = int(w[6]) & 7
            slot = nstart
            slot_end = nstart + (int(node_count[node])
                                 if c == hit_records.COUNT_SAT else c)
            leaf_skip = nskip
            lo, ld, nxt, inst = enter(slot)
        else:
            nxt = nskip
        if nxt < 0 and inst >= 0:
            slot += 1
            if slot < slot_end:
                lo, ld, nxt, inst = enter(slot)
            else:
                nxt, inst = leaf_skip, -1
                lo, ld = world
        node = nxt
    return int(hit_prim >= 0), hit_inst, hit_prim, t


def _tie_aims(ts, seed, n):
    """Vertices and edge midpoints of the scene's triangles (identity
    instances): rays aimed there hit two triangles at the same t."""
    rng = np.random.default_rng(seed)
    pos = ts.pos.numpy()
    tri = ts.prim_v.numpy()[ts.prim_type.numpy() == 2]
    pick = tri[rng.integers(0, len(tri), n)]
    k = rng.integers(0, 3, n)
    a = pos[pick[np.arange(n), k]]
    b = pos[pick[np.arange(n), (k + 1) % 3]]
    return torch.from_numpy(np.where(
        (np.arange(n) % 2 == 0)[:, None], a,
        (a + b) * np.float32(0.5)).astype(np.float32))


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("name", ["random0", "hair64", "inst300",
                                  "degenerate", "ties", "mixed",
                                  "mixed_ties"])
def test_records_walk_matches_plain(name, any_hit):
    ts = _scene({"ties": "hair64", "mixed_ties": "mixed"}.get(name, name))
    rec = hit_records.pack(ts)
    ro, _, tmin, tmax = _rays(31, 96)
    # aimed at points of the scene's box, so that most rays walk into it,
    # or at shared vertices and edges
    lo, hi = ts.node_bbox_min[0], ts.node_bbox_max[0]
    aim = lo + (hi - lo) * torch.from_numpy(
        np.random.default_rng(32).uniform(size=(96, 3)).astype(np.float32))
    if name in ("ties", "mixed_ties"):
        aim = _tie_aims(ts, 33, 96)
    rd = aim - ro
    rd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    # dead lanes among the live ones: behind tmin, -FLT_MAX and NaN
    tmax[1::7] = tmin[1::7] * 0.5
    tmax[2::7] = float(-FLT_MAX)
    tmax[3::7] = float("nan")
    want = ttrav.intersect_scene_plain(ts, ro, rd, tmin, tmax, any_hit)
    got = [_records_walk(rec, ro[i:i + 1], rd[i:i + 1], tmin[i:i + 1],
                         tmax[i:i + 1], any_hit) for i in range(len(tmin))]
    assert torch.equal(want["hit"], torch.tensor([g[0] == 1 for g in got]))
    assert torch.equal(want["inst"],
                       torch.tensor([g[1] for g in got], dtype=torch.int32))
    assert torch.equal(want["prim"],
                       torch.tensor([g[2] for g in got], dtype=torch.int32))
    t = torch.cat([g[3] for g in got])
    assert np.array_equal(_bits(t), _bits(want["t"]))
    assert int(want["hit"].sum()) > 10


def _nan_frame_scene():
    """The mixed-frame scene with instance 0's origin word a NaN."""
    host = tts.make_mixed_frame_scene()
    host.instances[0].o[1] = np.float32("nan")
    return host


@pytest.mark.parametrize("make,share", [
    (lambda: tts.make_hair_scene(64), 1.0),
    (tts.make_random_scene, 0.0),
    (tts.make_mixed_frame_scene, 5 / 12),
    (_nan_frame_scene, 4 / 12),
], ids=["hair", "random", "mixed", "mixed_nan"])
def test_identity_share(make, share):
    """``identity_share`` counts the instances whose 12 frame words are the
    identity's bits (those K1 enters on the world ray): not a -0.0 origin,
    an axis word 1 ulp off 1.0 or +0.0, a -0.0 axis word or a NaN word."""
    leaves, _ = tscene.build_device_scene(make())
    ts = tscene.to_torch(leaves, "cpu")
    assert hit_records.identity_share(ts) == share
    words = hit_records.unpack(hit_records.pack(ts))
    ident = np.concatenate([words["inst_axes"].reshape(-1, 9),
                            words["inst_o"]], 1) == hit_records.IDENTITY_WORDS
    assert ident.all(1).mean() == share   # the records' words, per slot


def test_records_follow_train_step():
    """``train_step`` returns new leaves; records packed from them hold the
    new positions (the renderer packs per call, so none go stale)."""
    host = tts.make_hair_scene(16)
    leaves, meta = tscene.build_device_scene(host)
    scene = tscene.to_torch(leaves, "cpu")
    w, h, spp = 24, 16, 1
    ids = torch.arange(w * h, dtype=torch.int32)
    amb = torch.full((3,), 0.1)
    from yocto_raytracing_tpu_torch.render import renderer
    target = renderer.trace_rays(scene, ids, amb, w, h, spp, 2) * 0.5
    before = hit_records.pack(scene)
    new, _ = mesh.train_step(scene, ids, target, amb, 10.0, width=w,
                             height=h, samples=spp, max_depth=2,
                             trainable=("pos",))
    assert not torch.equal(new.pos, scene.pos)
    after = hit_records.unpack(hit_records.pack(new))
    ni = new.inst_axes.shape[0]
    pv = new.prim_v.numpy()[new.leaf_items.numpy()[ni:]]
    for j in range(3):
        assert np.array_equal(after[f"prim_v{j}"], _bits(new.pos)[pv[:, j]])
    assert not np.array_equal(after["prim_v0"],
                              hit_records.unpack(before)["prim_v0"])


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("dead", ["below_tmin", "neg_flt_max", "nan"])
def test_dead_lane_rule_matches_plain(dead, any_hit):
    ts = _scene("hair64")
    ro, rd, tmin, _ = _rays(9, 256)
    tmax = {"below_tmin": tmin * 0.5,
            "neg_flt_max": torch.full_like(tmin, -FLT_MAX),
            "nan": torch.full_like(tmin, float("nan"))}[dead]
    assert not bool((tmax >= tmin).any())
    got = ttrav.intersect_scene_plain(ts, ro, rd, tmin, tmax, any_hit)
    assert not bool(got["hit"].any())
    assert bool((got["inst"] == -1).all()) and bool((got["prim"] == -1).all())
    assert np.array_equal(_bits(got["t"]), _bits(tmax))


def test_slab_nan_guards_are_redundant():
    """``hit.cu``'s ``hit_bbox_live`` drops ``hit_bbox``'s NaN guards (a NaN
    slab bound becomes -inf in the max, +inf in the min): with
    ``fmaxf``/``fminf`` semantics (``torch.fmax``/``fmin``: a NaN operand
    yields the other) and tmin, tmax not NaN, as for every live ray, both
    give the same bits, on bounds that mix NaN, infinities, signed zeros
    and finite values."""
    rng = np.random.default_rng(12)
    pool = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0, -2.5, 3e38],
                    np.float32)
    n = 200_000
    lo = torch.from_numpy(rng.choice(pool, (n, 3)))
    hi = torch.from_numpy(rng.choice(pool, (n, 3)))
    tmin = torch.from_numpy(rng.choice(pool[1:], n))
    tmax = torch.from_numpy(rng.choice(pool[1:], n))

    def chain(op, x, last):
        return op(op(op(x[:, 0], x[:, 1]), x[:, 2]), last)

    slack = torch.tensor(1.00000024, dtype=torch.float32)
    guarded = (chain(torch.fmax, torch.nan_to_num(lo, nan=-np.inf,
                                                  posinf=np.inf,
                                                  neginf=-np.inf), tmin),
               chain(torch.fmin, torch.nan_to_num(hi, nan=np.inf,
                                                  posinf=np.inf,
                                                  neginf=-np.inf), tmax)
               * slack)
    live = (chain(torch.fmax, lo, tmin), chain(torch.fmin, hi, tmax) * slack)
    for g, v in zip(guarded, live):
        assert np.array_equal(_bits(g), _bits(v))
    assert torch.equal(guarded[0] <= guarded[1], live[0] <= live[1])
