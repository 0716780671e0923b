"""K13, the device loop's records packed in place (``ops/records.py``,
``kernels/csrc/records.cu``).

On the CPU: a transcription in numpy of K13's thread map (``block_plan``'s
blocks, one table a block, a thread a 16-byte quad of a row, every word
read through int32 views, the int32 sums wrapping) bit-equal to
``hit_records.pack`` and ``shade_records.pack`` on the hair, textured
hair, mirror, mirror-pair and random scenes, after leaves edited to
extreme values (counts past the saturation, sums that wrap), and on the
10,004-instance scene with a wrapped sum; the block plan covering every
quad of every table once, no block for an empty table; the tables
transcribed a row at a time from the leaves, independently of the
packers, and bit-equal to them;
``records.pack_into`` and ``records.prepare`` on the CPU (the plain
version) equal to the packers; its tables' shapes, and the node counts
left as the leaf.

On the card (marker ``cuda``): K13 bit-equal to the packers on the same
scenes and edits and on the 10,004-instance scene, through ``pack_into``
and a prepared launch, one launch counted a call; a wrong leaf,
a strided table and a table off 16-byte alignment refused. The file
imports no JAX.
"""

import functools

import numpy as np
import pytest
import torch

from torch_card import cuda_device  # noqa: F401  (fixture)
from yocto_raytracing_tpu_torch import kernels
from yocto_raytracing_tpu_torch import scene as scene_lib, testscenes
from yocto_raytracing_tpu_torch.ops import hit_records, records, shade_records

SCENES = {
    "hair": lambda: testscenes.make_hair_scene(16),
    "textured hair": lambda: testscenes.make_textured_hair_scene(16),
    "mirror": testscenes.make_grad_scene,
    "mirror pair": testscenes.make_mirror_pair_scene,
    "random 0": lambda: testscenes.make_random_scene(seed=0),
    "random 1": lambda: testscenes.make_random_scene(seed=1, n_instances=3),
}


BIG = "random 10004 instances"


@functools.lru_cache(maxsize=None)
def _leaves(name):
    host = (testscenes.make_random_scene(n_instances=10004) if name == BIG
            else SCENES[name]())
    return scene_lib.build_device_scene(host)[0]


def _scene(name, device="cpu"):
    """A new torch scene of the scene ``name`` (its leaves built once)."""
    return scene_lib.to_torch(_leaves(name), device)


def _edit(ts):
    """Leaves at the edges of the packers' int32 sums: counts past the
    saturation and negative, starts and skips whose sums wrap."""
    ts.node_count[::2] = torch.tensor(9, dtype=torch.int32)
    ts.node_count[1::5] = torch.tensor(-3, dtype=torch.int32)
    ts.node_start[::3] = torch.tensor(2 ** 29 + 7, dtype=torch.int32)
    ts.node_skip[::4] = torch.tensor(2 ** 30 + 1, dtype=torch.int32)
    ts.prim_type.add_(2 ** 30)
    ts.pos.mul_(-1.5)
    ts.mat_kd_txt.fill_(-1)


def _kernel_rows(ts) -> tuple:
    """The six tables transcribed a row at a time from the leaves' words,
    as the record layouts of ops/hit_records.py and ops/shade_records.py
    describe them: an oracle independent of the packers' torch ops."""
    a = {k: getattr(ts, k).numpy() for k, _, _ in records.LEAVES}
    w = {k: (v.view(np.int32) if v.dtype == np.float32 else v)
         for k, v in a.items()}
    n = records.sizes(ts)
    ni = n["I"]

    def add(x, y, k):   # torch.add(x, y, alpha=k) in int32, wrapping
        r = (int(x) + k * int(y)) & 0xFFFFFFFF
        return r - (1 << 32) if r >= 1 << 31 else r

    nodes = np.zeros((n["M"], 8), np.int32)
    for i in range(n["M"]):
        nodes[i, 0:3] = w["node_bbox_min"][i]
        nodes[i, 3:6] = w["node_bbox_max"][i]
        nodes[i, 6] = add(min(w["node_count"][i], hit_records.COUNT_SAT),
                          w["node_start"][i], 8)
        nodes[i, 7] = add(add(w["node_kind"][i], w["node_isleaf"][i], 2),
                          w["node_skip"][i], 4)
    hprims = np.zeros((n["K"] - ni, 12), np.int32)
    for j in range(n["K"] - ni):
        prim = w["leaf_items"][ni + j]
        v = w["prim_v"][prim]
        for c in range(3):
            hprims[j, 4 * c:4 * c + 3] = w["pos"][v[c]]
            if c < 2:
                hprims[j, 4 * c + 3] = w["radius"][v[c]]
        hprims[j, 11] = add(w["prim_type"][prim], prim, 4)
    hinsts = np.zeros((ni, 16), np.int32)
    for j in range(ni):
        item = w["leaf_items"][j]
        hinsts[j, 0:9] = w["inst_axes"][item].reshape(9)
        hinsts[j, 9:12] = w["inst_o"][item]
        hinsts[j, 12] = w["inst_shape_root"][item]
        hinsts[j, 13:16] = item
    sprims = np.zeros((n["P"], 28), np.int32)
    for p in range(n["P"]):
        v = w["prim_v"][p]
        sprims[p, 0:3] = v
        sprims[p, 3] = w["prim_type"][p]
        for c in range(3):
            o = 4 + 8 * c
            sprims[p, o:o + 3] = w["pos"][v[c]]
            sprims[p, o + 3:o + 6] = w["norm"][v[c]]
            sprims[p, o + 6:o + 8] = w["texcoord"][v[c]]
    sinsts = np.zeros((ni, 16), np.int32)
    for i in range(ni):
        sinsts[i, 0:9] = w["inst_axes"][i].reshape(9)
        sinsts[i, 9:12] = w["inst_o"][i]
        sinsts[i, 12] = w["inst_mat"][i]
        sinsts[i, 13] = w["inst_is_lines"][i]
    mats = np.zeros((n["T"], 12), np.int32)
    for i in range(n["T"]):
        mats[i, 0:3] = w["mat_kd"][i]
        mats[i, 3:6] = w["mat_ks"][i]
        mats[i, 6:9] = w["mat_kr"][i]
        mats[i, 9] = w["mat_rs"][i]
        mats[i, 10] = w["mat_kd_txt"][i]
        mats[i, 11] = w["mat_ks_txt"][i]
    return nodes, hprims, hinsts, sprims, sinsts, mats


def _add(a, b, k):
    """records.cu's add_wrap on arrays: a + k * b in int32, wrapping."""
    r = (a.astype(np.int64) + k * b.astype(np.int64)) & 0xFFFFFFFF
    return r.astype(np.uint32).view(np.int32)


def _frame_quad(w, item, c):
    """records.cu's frame_quad: quad c < 3 of instance ``item``'s axes (9)
    and o (3); rows with c == 3 are left to the caller."""
    a, o = w["inst_axes"].reshape(-1, 9)[item], w["inst_o"][item]
    out = np.zeros((len(item), 4), np.int32)
    lo, hi = c < 2, c == 2
    cols = 4 * c[lo][:, None] + np.arange(4)
    out[lo] = np.take_along_axis(a[lo], cols, 1)
    out[hi] = np.concatenate([a[hi, 8:9], o[hi]], 1)
    return out


def _quads(w, t, q, ni):
    """The words of quads ``q`` of table ``t``, as records.cu's quad
    function of that table loads them."""
    Q = records.QUADS[t]
    row, c = q // Q, q % Q
    if t == 0:   # hit nodes: bbox_min, bbox_max[0] | bbox_max[1:], sums
        bmin, bmax = w["node_bbox_min"][row], w["node_bbox_max"][row]
        first = np.concatenate([bmin, bmax[:, :1]], 1)
        sums = np.stack([
            _add(np.minimum(w["node_count"][row], hit_records.COUNT_SAT),
                 w["node_start"][row], 8),
            _add(_add(w["node_kind"][row], w["node_isleaf"][row], 2),
                 w["node_skip"][row], 4)], 1)
        second = np.concatenate([bmax[:, 1:], sums], 1)
        return np.where((c == 0)[:, None], first, second)
    if t == 1:   # hit prims: the vertex c's pos, radius or type + 4 prim
        prim = w["leaf_items"][ni + row]
        v = w["prim_v"][prim, c]
        last = np.where(c < 2, w["radius"][v],
                        _add(w["prim_type"][prim], prim, 4))
        return np.concatenate([w["pos"][v], last[:, None]], 1)
    if t in (2, 4):   # hit / shade insts
        item = w["leaf_items"][row] if t == 2 else row
        out = _frame_quad(w, item, c)
        tail = (np.stack([w["inst_shape_root"][item], item, item, item], 1)
                if t == 2 else
                np.stack([w["inst_mat"][item], w["inst_is_lines"][item],
                          0 * item, 0 * item], 1))
        return np.where((c == 3)[:, None], tail, out)
    if t == 3:   # shade prims: prim_v, type | pos, norm[0] | norm[1:], uv
        first = np.concatenate([w["prim_v"][row],
                                w["prim_type"][row][:, None]], 1)
        v = w["prim_v"][row, np.maximum(c - 1, 0) >> 1]
        odd = np.concatenate([w["pos"][v], w["norm"][v][:, :1]], 1)
        even = np.concatenate([w["norm"][v][:, 1:], w["texcoord"][v]], 1)
        out = np.where((c % 2 == 1)[:, None], odd, even)
        return np.where((c == 0)[:, None], first, out)
    # shade mats: kd, ks[0] | ks[1:], kr[:2] | kr[2], rs, kd_txt, ks_txt
    m = np.concatenate([w["mat_kd"][row], w["mat_ks"][row],
                        w["mat_kr"][row], w["mat_rs"][row][:, None],
                        w["mat_kd_txt"][row][:, None],
                        w["mat_ks_txt"][row][:, None]], 1)
    return np.take_along_axis(m, 4 * c[:, None] + np.arange(4), 1)


def _words(ts) -> dict:
    a = {k: getattr(ts, k).numpy() for k, _, _ in records.LEAVES}
    return {k: (v.view(np.int32) if v.dtype == np.float32 else v)
            for k, v in a.items()}


def _quad_map(ts) -> tuple:
    """The six tables as records.cu's K13 writes them: block b of
    ``block_plan`` takes the table t with start[t] <= b < start[t + 1]
    (the kernel's loop), its thread i the table's quad (b - start[t]) *
    THREADS + i, if there is one, and stores that quad's four words. Each
    table is returned with the count of the stores into each quad."""
    w = _words(ts)
    n = records.sizes(ts)
    rows = records.table_rows(n)
    start = records.block_plan(rows)
    out = [np.full((r * q, 4), -7, np.int32)
           for r, q in zip(rows, records.QUADS)]
    stores = [np.zeros(r * q, np.int64) for r, q in zip(rows, records.QUADS)]
    for b in range(start[-1]):
        t = 0
        while b >= start[t + 1]:
            t += 1
        q = (b - start[t]) * records.THREADS + np.arange(records.THREADS)
        q = q[q < rows[t] * records.QUADS[t]]
        out[t][q] = _quads(w, t, q, n["I"])
        stores[t][q] += 1
    return ([o.reshape(r, -1) for o, r in zip(out, rows)], stores)


def _packers(ts) -> tuple:
    return (*hit_records.pack(ts)[:3], *shade_records.pack(ts))


def _bits(t):
    return t.cpu().contiguous().view(torch.int32).numpy()


@pytest.mark.parametrize("edit", [False, True])
@pytest.mark.parametrize("name", list(SCENES))
def test_kernel_rows_equal_the_packers(name, edit):
    ts = _scene(name)
    if edit:
        _edit(ts)
    for i, (got, want) in enumerate(zip(_kernel_rows(ts), _packers(ts))):
        assert np.array_equal(got, _bits(want)), i


@pytest.mark.parametrize("edit", [False, True])
@pytest.mark.parametrize("name", list(SCENES))
def test_quad_map_equals_the_packers(name, edit):
    ts = _scene(name)
    if edit:
        _edit(ts)
    got, stores = _quad_map(ts)
    for i, (g, want, st) in enumerate(zip(got, _packers(ts), stores)):
        assert np.array_equal(g, _bits(want)), i
        assert (st == 1).all(), i


def test_quad_map_on_10004_instances_with_a_wrapped_sum():
    """The benchmark's instance10000 stand-in (7,066 nodes, 10,004
    instances: 95,907 quads in 379 blocks), its node starts and skips
    edited so that the packed sums wrap."""
    ts = _scene(BIG)
    _edit(ts)
    n = records.sizes(ts)
    assert records.block_plan(records.table_rows(n))[-1] == 379
    wide = (ts.node_start.long() * 8 + ts.node_count.clamp(max=7).long())
    assert (wide >= 2 ** 31).any()
    got, stores = _quad_map(ts)
    for i, (g, want, st) in enumerate(zip(got, _packers(ts), stores)):
        assert np.array_equal(g, _bits(want)), i
        assert (st == 1).all(), i


PLAN_ROWS = [(0, 0, 0, 0, 0, 0), (1, 1, 1, 1, 1, 1), (128, 0, 64, 0, 0, 86),
             (0, 5, 0, 1000, 3, 0), (129, 86, 65, 37, 64, 85),
             (7066, 174, 10004, 174, 10004, 1), (1066, 1604, 5, 1604, 5, 4)]


@pytest.mark.parametrize("rows", PLAN_ROWS, ids=str)
def test_block_plan_covers_every_quad_once(rows):
    """Every quad of every table is taken by exactly one thread, every
    block serves one table and has a quad of it in its first thread, and
    an empty table gets no block."""
    start = records.block_plan(rows)
    assert start[0] == 0 and len(start) == 7
    seen = [np.zeros(r * q, np.int64) for r, q in zip(rows, records.QUADS)]
    for t, (r, q) in enumerate(zip(rows, records.QUADS)):
        blocks = range(start[t], start[t + 1])
        if r == 0:
            assert len(blocks) == 0
        for b in blocks:
            quads = (b - start[t]) * records.THREADS + np.arange(
                records.THREADS)
            assert quads[0] < r * q
            quads = quads[quads < r * q]
            np.add.at(seen[t], quads, 1)
    for t, s in enumerate(seen):
        assert (s == 1).all(), t


@pytest.mark.parametrize("name", ["hair", "random 0"])
def test_pack_into_on_the_cpu_is_the_packers(name):
    ts = _scene(name)
    hrec, srec = records.empty(ts)
    assert hrec.node_count is ts.node_count
    n = records.sizes(ts)
    assert [tuple(t.shape) for t in records.tables(hrec, srec)] == [
        (n["M"], 8), (n["K"] - n["I"], 12), (n["I"], 16), (n["P"], 28),
        (n["I"], 16), (n["T"], 12)]
    fill = records.prepare(ts, hrec, srec)
    for edit in (False, True):
        if edit:   # the prepared fill sees the leaves' new values
            _edit(ts)
            fill()
        else:
            records.pack_into(ts, hrec, srec)
        for got, want in zip(records.tables(hrec, srec), _packers(ts)):
            assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("name", [*SCENES, BIG])
def test_card_records_equal_the_packers(cuda_device, name):
    ts = _scene(name, cuda_device)
    hrec, srec = records.empty(ts)
    fill = records.prepare(ts, hrec, srec)
    for edit in (False, True):
        kernels.reset_launches()
        if edit:   # the prepared launch sees the leaves' new values
            _edit(ts)
            fill()
        else:
            records.pack_into(ts, hrec, srec)
        assert kernels.launches["records"] == 1
        want = _packers(ts)
        for i, (got, w) in enumerate(zip(records.tables(hrec, srec), want)):
            assert np.array_equal(_bits(got), _bits(w)), i


@pytest.mark.cuda
def test_card_records_refuse_a_wrong_leaf(cuda_device):
    ts = _scene("hair", cuda_device)
    hrec, srec = records.empty(ts)
    ts.radius = ts.radius.double()
    with pytest.raises(ValueError, match="radius"):
        records.pack_into(ts, hrec, srec)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["strided", "misaligned"])
def test_card_records_refuse_a_strided_or_misaligned_table(cuda_device,
                                                           fault):
    """K13 stores 16-byte quads: a table that is not contiguous, or not
    16-byte aligned, is refused by ``prepare``, with no fallback."""
    ts = _scene("hair", cuda_device)
    hrec, srec = records.empty(ts)
    rows, width = srec.mats.shape
    if fault == "strided":
        bad = torch.empty((rows, 2 * width), device=cuda_device)[:, :width]
    else:
        bad = torch.empty(rows * width + 1, device=cuda_device)[1:].view(
            rows, width)
    srec = srec._replace(mats=bad)
    match = "not contiguous" if fault == "strided" else "16-byte aligned"
    with pytest.raises(ValueError, match=match):
        records.prepare(ts, hrec, srec)
