"""K13, the device loop's records packed in place (``ops/records.py``,
``kernels/csrc/records.cu``).

On the CPU: a transcription of the kernel's rows in numpy (a row of one
of the six tables a thread, every word read through int32 views, the int32
sums wrapping) bit-equal to ``hit_records.pack`` and ``shade_records.pack``
on the hair, textured hair, mirror, mirror-pair and random scenes, and
after leaves edited to extreme values (counts past the saturation, sums
that wrap); ``records.pack_into`` and ``records.prepare`` on the CPU (the
plain version) equal to the packers; its tables' shapes, and the node
counts left as the leaf.

On the card (marker ``cuda``): K13 bit-equal to the packers on the same
scenes and edits, through ``pack_into`` and a prepared launch, one launch
counted a call, and a wrong leaf refused. The
file imports no JAX.
"""

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


def _scene(name, device="cpu"):
    leaves, _ = scene_lib.build_device_scene(SCENES[name]())
    return scene_lib.to_torch(leaves, device)


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
    """The six tables as records.cu writes them, a row at a time."""
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
@pytest.mark.parametrize("name", list(SCENES))
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
        for i, (got, want) in enumerate(zip(records.tables(hrec, srec),
                                            _packers(ts))):
            assert np.array_equal(_bits(got), _bits(want)), i


@pytest.mark.cuda
def test_card_records_refuse_a_wrong_leaf(cuda_device):
    ts = _scene("hair", cuda_device)
    hrec, srec = records.empty(ts)
    ts.radius = ts.radius.double()
    with pytest.raises(ValueError, match="radius"):
        records.pack_into(ts, hrec, srec)
