"""K1's and K4's records packed in place from the scene's leaves: K13.

``hit_records.pack`` and ``shade_records.pack`` make new record tensors
with about 35 torch ops. The device loop (``render.renderer.frame_device``)
keeps its records across calls, so it packs them into the same tensors on
every call: ``empty`` makes them once, ``pack_into`` fills them, on the
card with one launch of K13 (``kernels/csrc/records.cu``), on the CPU
through the two packers (the plain version); ``prepare`` checks the
arguments once for tensors that stay put, so that each later fill is the
launch alone. Either way the records are bit copies of the leaves, equal
to the packers' records.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import _build
from ..scene import TorchScene
from . import hit_records, shade_records
from .hit_records import HitRecords
from .shade_records import ShadeRecords

# the leaves K13 reads, in the order of ``yrt::RecordLeaves``, each with its
# dtype and shape in the scene's sizes: M nodes, K leaf slots, P prims, V
# vertices, I instances, T materials
LEAVES = (
    ("node_bbox_min", torch.float32, ("M", 3)),
    ("node_bbox_max", torch.float32, ("M", 3)),
    ("node_count", torch.int32, ("M",)),
    ("node_start", torch.int32, ("M",)),
    ("node_kind", torch.int32, ("M",)),
    ("node_isleaf", torch.int32, ("M",)),
    ("node_skip", torch.int32, ("M",)),
    ("leaf_items", torch.int32, ("K",)),
    ("prim_v", torch.int32, ("P", 3)),
    ("prim_type", torch.int32, ("P",)),
    ("pos", torch.float32, ("V", 3)),
    ("radius", torch.float32, ("V",)),
    ("norm", torch.float32, ("V", 3)),
    ("texcoord", torch.float32, ("V", 2)),
    ("inst_axes", torch.float32, ("I", 3, 3)),
    ("inst_o", torch.float32, ("I", 3)),
    ("inst_shape_root", torch.int32, ("I",)),
    ("inst_mat", torch.int32, ("I",)),
    ("inst_is_lines", torch.int32, ("I",)),
    ("mat_kd", torch.float32, ("T", 3)),
    ("mat_ks", torch.float32, ("T", 3)),
    ("mat_kr", torch.float32, ("T", 3)),
    ("mat_rs", torch.float32, ("T",)),
    ("mat_kd_txt", torch.int32, ("T",)),
    ("mat_ks_txt", torch.int32, ("T",)),
)


def sizes(scene: TorchScene) -> dict:
    """The scene's table sizes: M, K, P, V, I, T."""
    return dict(M=scene.node_start.shape[0], K=scene.leaf_items.shape[0],
                P=scene.prim_v.shape[0], V=scene.pos.shape[0],
                I=scene.inst_axes.shape[0], T=scene.mat_kd.shape[0])


def empty(scene: TorchScene) -> tuple[HitRecords, ShadeRecords]:
    """Record tensors of ``scene``'s sizes on its device, not yet filled;
    the hit records' node counts are the scene's own leaf."""
    n = sizes(scene)
    if n["K"] < n["I"]:
        raise ValueError(f"{n['K']} leaf slots, fewer than {n['I']} "
                         f"instances")

    def words(rows, width):
        return torch.empty((rows, width), dtype=torch.float32,
                           device=scene.pos.device)

    hrec = HitRecords(words(n["M"], hit_records.NODE_WORDS),
                      words(n["K"] - n["I"], hit_records.PRIM_WORDS),
                      words(n["I"], hit_records.INST_WORDS),
                      scene.node_count)
    srec = ShadeRecords(words(n["P"], shade_records.PRIM_WORDS),
                        words(n["I"], shade_records.INST_WORDS),
                        words(n["T"], shade_records.MAT_WORDS))
    return hrec, srec


def tables(hrec: HitRecords, srec: ShadeRecords) -> tuple:
    """The six record tables that K13 writes, in ``yrt::RecordTables``'
    order."""
    return (*hrec[:3], *srec)


def pack_into(scene: TorchScene, hrec: HitRecords,
              srec: ShadeRecords) -> None:
    """Fill ``hrec`` and ``srec`` (from ``empty``) with ``scene``'s records,
    bit-equal to ``hit_records.pack`` and ``shade_records.pack``. CPU
    tensors take the packers (the plain version); CUDA tensors launch K13
    (or raise)."""
    if _build.device_kind(scene.pos) == "cuda":
        pack_into_cuda(scene, hrec, srec)
        return
    new = (*hit_records.pack(scene)[:3], *shade_records.pack(scene))
    for dst, src in zip(tables(hrec, srec), new):
        dst.copy_(src)


def pack_into_cuda(scene: TorchScene, hrec: HitRecords,
                   srec: ShadeRecords) -> None:
    """K13 launch, CUDA only: ``pack_into``."""
    prepare_cuda(scene, hrec, srec)()


def prepare(scene: TorchScene, hrec: HitRecords, srec: ShadeRecords):
    """A function of no arguments that does ``pack_into(scene, hrec,
    srec)``, for tensors that stay where they are between its calls (the
    device loop's own leaves and records): on CUDA the arguments are
    checked and K13's pointer arrays made here, once, so a call is one
    launch."""
    if _build.device_kind(scene.pos) == "cuda":
        return prepare_cuda(scene, hrec, srec)
    return lambda: pack_into(scene, hrec, srec)


def prepare_cuda(scene: TorchScene, hrec: HitRecords, srec: ShadeRecords):
    """``prepare`` on CUDA tensors: K13 launches (or raise)."""
    n = sizes(scene)
    if max(n["M"], n["K"]) >= hit_records.MAX_INDEX:
        raise ValueError(f"BVH too large to pack: {n['M']} nodes, "
                         f"{n['K']} slots")
    dev = scene.pos.device
    check = _build.check_tensor
    leaves = []
    for name, dtype, shape in LEAVES:
        t = getattr(scene, name)
        check(name, t, dtype, tuple(n.get(s, s) for s in shape), dev)
        leaves.append(t)
    outs = tables(hrec, srec)
    widths = (hit_records.NODE_WORDS, hit_records.PRIM_WORDS,
              hit_records.INST_WORDS, shade_records.PRIM_WORDS,
              shade_records.INST_WORDS, shade_records.MAT_WORDS)
    rows = (n["M"], n["K"] - n["I"], n["I"], n["P"], n["I"], n["T"])
    for i, (t, w, r) in enumerate(zip(outs, widths, rows)):
        check(f"table {i}", t, torch.float32, (r, w), dev)
    # the arrays hold the pointers; cast keeps them alive
    leaf_ptrs = ctypes.cast((ctypes.c_void_p * len(leaves))(
        *(t.data_ptr() for t in leaves)), ctypes.c_void_p)
    out_ptrs = ctypes.cast((ctypes.c_void_p * len(outs))(
        *(t.data_ptr() for t in outs)), ctypes.c_void_p)
    lib = _build.library()

    def launch():
        err = lib.yrt_records(leaf_ptrs, out_ptrs, n["M"], n["K"], n["I"],
                              n["P"], n["T"], _build.current_stream())
        _build.check_launch(err, "yrt_records")
        _build.launches["records"] += 1

    launch.tensors = (leaves, outs)   # alive as long as the launcher
    return launch
