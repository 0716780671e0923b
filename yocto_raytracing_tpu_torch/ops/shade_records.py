"""Packed records of the shading leaves, the layout K4 and K5 read.

A shading bounce (``render/shade.py::eval_hit`` and the material row of
``shade_step``) gathers, per ray, an instance's frame, material and hair
flag, a prim's three vertex ids and type, the three vertices' position,
normal and texcoord, and a material's kd, ks, kr, rs and texture ids. The
scene leaves hold these in structure-of-arrays form, so a bounce is a chain
of dependent scalar loads: inst -> inst_mat -> mat_*, prim -> prim_v -> pos,
norm, texcoord. ``pack`` copies the leaves into three record arrays, so that
each of those reads is one record with 16-byte loads. The values are bit
copies of the leaves (every word goes through int32 views, never float
arithmetic), so K4 computes the same bits as from the leaves.

* ``prims`` (P, 28), one 112-byte record per prim: ``prim_v`` (3 ids) and
  ``prim_type``, then for each of the three vertices ``pos`` xyz, ``norm``
  xyz and ``texcoord`` uv (8 words).
* ``insts`` (I, 16), one 64-byte record per instance: ``inst_axes`` (three
  rows), ``inst_o``, ``inst_mat``, ``inst_is_lines`` and two words of
  padding.
* ``mats`` (Mt, 12), one 48-byte record per material: ``mat_kd``,
  ``mat_ks``, ``mat_kr``, ``mat_rs``, ``mat_kd_txt`` and ``mat_ks_txt``.

Gradients do not go through the records: K5 still adds them by vertex,
instance and material id into gradients of the leaves. The records are no
``TorchScene`` field and nothing caches them: they are rebuilt whenever the
leaves may have changed (``render.renderer.trace_rays`` packs once per call,
``render_image`` once per frame, and ``render.shade.shade_step`` packs for
itself when it is given none). ``pack`` is a few torch ops with no host
synchronisation.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..scene import TorchScene

PRIM_WORDS, INST_WORDS, MAT_WORDS = 28, 16, 12

# float leaves that the records copy, by their bits
FLOAT_LEAVES = ("pos", "norm", "texcoord", "inst_axes", "inst_o", "mat_kd",
                "mat_ks", "mat_kr", "mat_rs")


class ShadeRecords(NamedTuple):
    prims: torch.Tensor   # (P, 28) f32 words
    insts: torch.Tensor   # (I, 16) f32 words
    mats: torch.Tensor    # (Mt, 12) f32 words


def pack(scene: TorchScene) -> ShadeRecords:
    """The shading records of ``scene``, on its device (f32 leaves)."""
    i32 = torch.int32
    for name in FLOAT_LEAVES:
        if getattr(scene, name).dtype != torch.float32:
            raise ValueError(f"{name}: records hold f32 leaves")

    def bits(x):
        return x.detach().contiguous().view(i32)

    with torch.no_grad():
        vert = torch.cat([bits(scene.pos), bits(scene.norm),
                          bits(scene.texcoord)], 1)               # (V, 8)
        pv = scene.prim_v
        prims = torch.cat([pv, scene.prim_type[:, None], vert[pv[:, 0]],
                           vert[pv[:, 1]], vert[pv[:, 2]]], 1)
        ni = scene.inst_axes.shape[0]
        insts = torch.cat([bits(scene.inst_axes).reshape(ni, 9),
                           bits(scene.inst_o), scene.inst_mat[:, None],
                           scene.inst_is_lines[:, None],
                           torch.zeros((ni, 2), dtype=i32,
                                       device=pv.device)], 1)
        mats = torch.cat([bits(scene.mat_kd), bits(scene.mat_ks),
                          bits(scene.mat_kr), bits(scene.mat_rs)[:, None],
                          scene.mat_kd_txt[:, None],
                          scene.mat_ks_txt[:, None]], 1)
    f32 = torch.float32
    return ShadeRecords(prims.contiguous().view(f32),
                        insts.contiguous().view(f32),
                        mats.contiguous().view(f32))


def unpack(rec: ShadeRecords) -> dict:
    """The fields that the records hold, as numpy arrays (floats by their
    bits, as int32): what K4 and K5 read back, for the tests."""
    p = rec.prims.cpu().numpy().view(np.int32)
    s = rec.insts.cpu().numpy().view(np.int32)
    m = rec.mats.cpu().numpy().view(np.int32)
    vert = p[:, 4:].reshape(-1, 3, 8)
    return dict(
        prim_v=p[:, 0:3], prim_type=p[:, 3], vert_pos=vert[..., 0:3],
        vert_norm=vert[..., 3:6], vert_texcoord=vert[..., 6:8],
        inst_axes=s[:, 0:9].reshape(-1, 3, 3), inst_o=s[:, 9:12],
        inst_mat=s[:, 12], inst_is_lines=s[:, 13], inst_pad=s[:, 14:16],
        mat_kd=m[:, 0:3], mat_ks=m[:, 3:6], mat_kr=m[:, 6:9], mat_rs=m[:, 9],
        mat_kd_txt=m[:, 10], mat_ks_txt=m[:, 11])
