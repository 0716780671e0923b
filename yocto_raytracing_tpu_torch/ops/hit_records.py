"""Packed records of the two-level BVH, the layout K1 reads.

K1 (``kernels/csrc/hit.cu``) walks the same threaded BVH as
``traverse.intersect_scene_plain``. The scene leaves keep that BVH in
structure-of-arrays form: a node visit touches seven arrays, a prim test a
chain ``leaf_items`` -> ``prim_v`` -> ``pos``/``radius``, and a change of
frame three more. ``pack`` copies the leaves into three record arrays, so
that a visit, a prim test and a frame change each read one record with
16-byte loads. The values are bit copies of the leaves (every word goes
through int32 views, never float arithmetic), so the walk sees the same bits.

* ``nodes`` (M, 8), one 32-byte record per node: ``bbox_min`` xyz,
  ``bbox_max`` xyz, then two int32 words,
  ``start * 8 + min(count, 7)`` and ``skip * 4 + isleaf * 2 + kind``.
  A shape leaf tests ``min(count, 4)`` prims, so the saturated count is
  enough there; a scene leaf whose count reads 7 takes its full count from
  ``node_count``.
* ``prims`` (K - I, 12), one 48-byte record per shape-leaf slot, in
  ``leaf_items`` order (slot ``s`` at row ``s - I``): ``v0`` xyz, ``r0``,
  ``v1`` xyz, ``r1``, ``v2`` xyz, then ``prim * 4 + type``. A triangle
  uses ``v0 v1 v2``, a line ``v0 v1 r0 r1``, a point ``v0 r0``
  (``prim_v`` repeats a point's vertex, and a line's first one).
* ``insts`` (I, 16), one 64-byte record per scene-leaf slot (slot ``s``
  at row ``s``): the instance's three axis rows and origin (12 words),
  its shape root, its instance id, and two words of padding.

``bvh.build_scene_bvh`` flattens the scene tree first, so the scene
leaves' slots are ``0 .. I-1``, one per instance, and the shape leaves'
slots follow.

The records are no ``TorchScene`` field: they are rebuilt from the leaves
whenever the leaves may have changed (``render.renderer.trace_rays`` packs
once per call, and ``traverse.intersect_scene`` packs for itself when it is
given none). ``pack`` is a few torch ops, with no host synchronisation.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..scene import TorchScene

NODE_WORDS, PRIM_WORDS, INST_WORDS = 8, 12, 16
COUNT_SAT = 7           # the packed count saturates here (3 bits)
MAX_INDEX = 1 << 28     # start (and prim ids) must stay below, node ids too


class HitRecords(NamedTuple):
    nodes: torch.Tensor       # (M, 8) f32 words
    prims: torch.Tensor       # (K - I, 12) f32 words
    insts: torch.Tensor       # (I, 16) f32 words
    node_count: torch.Tensor  # (M,) i32, the scene's own (saturated counts)


def pack(scene: TorchScene) -> HitRecords:
    """The records of ``scene``'s BVH, on its device (f32 leaves)."""
    i32 = torch.int32
    m, k, ni = (scene.node_start.shape[0], scene.leaf_items.shape[0],
                scene.inst_axes.shape[0])
    if max(m, k) >= MAX_INDEX:
        raise ValueError(f"BVH too large to pack: {m} nodes, {k} slots")
    for name in ("node_bbox_min", "node_bbox_max", "pos", "radius",
                 "inst_axes", "inst_o"):
        if getattr(scene, name).dtype != torch.float32:
            raise ValueError(f"{name}: records hold f32 leaves")

    def bits(x):
        return x.detach().contiguous().view(i32)

    with torch.no_grad():
        w_start = torch.add(scene.node_count.clamp(max=COUNT_SAT),
                            scene.node_start, alpha=8)
        w_flags = torch.add(torch.add(scene.node_kind, scene.node_isleaf,
                                      alpha=2), scene.node_skip, alpha=4)
        nodes = torch.cat([bits(scene.node_bbox_min),
                           bits(scene.node_bbox_max), w_start[:, None],
                           w_flags[:, None]], 1)

        prim = scene.leaf_items[ni:]
        pv = scene.prim_v[prim]
        v = bits(scene.pos)[pv]                       # (P, 3, 3)
        r = bits(scene.radius)[pv]                    # (P, 3)
        w_prim = torch.add(scene.prim_type[prim], prim, alpha=4)
        prims = torch.cat([v[:, 0], r[:, 0:1], v[:, 1], r[:, 1:2], v[:, 2],
                           w_prim[:, None]], 1)

        item = scene.leaf_items[:ni]
        insts = torch.cat([bits(scene.inst_axes).reshape(ni, 9)[item],
                           bits(scene.inst_o)[item],
                           scene.inst_shape_root[item][:, None],
                           item[:, None].expand(ni, 3)], 1)
    f32 = torch.float32
    return HitRecords(nodes.view(f32), prims.view(f32), insts.view(f32),
                      scene.node_count)


def unpack(rec: HitRecords) -> dict:
    """The fields that the records hold, as numpy arrays (floats by their
    bits, as int32): what K1 reads back, for the tests."""
    n = rec.nodes.cpu().numpy().view(np.int32)
    p = rec.prims.cpu().numpy().view(np.int32)
    s = rec.insts.cpu().numpy().view(np.int32)
    return dict(
        node_bbox_min=n[:, 0:3], node_bbox_max=n[:, 3:6],
        node_start=n[:, 6] >> 3, node_count_sat=n[:, 6] & 7,
        node_skip=n[:, 7] >> 2, node_isleaf=(n[:, 7] >> 1) & 1,
        node_kind=n[:, 7] & 1,
        prim_v0=p[:, 0:3], prim_r0=p[:, 3], prim_v1=p[:, 4:7],
        prim_r1=p[:, 7], prim_v2=p[:, 8:11], prim_id=p[:, 11] >> 2,
        prim_type=p[:, 11] & 3,
        inst_axes=s[:, 0:9].reshape(-1, 3, 3), inst_o=s[:, 9:12],
        inst_shape_root=s[:, 12], inst_id=s[:, 13])
