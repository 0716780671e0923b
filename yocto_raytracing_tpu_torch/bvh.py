"""Flat-array two-level BVH construction.

Re-implements the reference build algorithm (src/scene.cpp:509-657) — top-down
midpoint split on the largest centroid-extent axis, leaf threshold 4, x>=y>=z
axis precedence, degenerate-centroid leaves — but emits a single unified node
pool ready for device traversal instead of per-object pointer trees:

* scene-level tree first (root = node 0), leaves hold instance ids;
* then every shape tree, leaves hold global prim ids;
* internal nodes always have exactly 2 children, stored contiguously
  (node_start, node_start+1), matching the reference layout
  (src/scene.cpp:595-599).

The builder is pure numpy (host-side, like the reference's CPU build); a
native C++ fast path with identical output lives in kernels/host/ and is
used automatically when built. This module is this package's own copy of
``yocto_raytracing_tpu/bvh.py``, code and results unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class FlatBVH:
    bbox_min: np.ndarray   # (M, 3) f32
    bbox_max: np.ndarray   # (M, 3) f32
    start: np.ndarray      # (M,) i32
    count: np.ndarray      # (M,) i32
    isleaf: np.ndarray     # (M,) i32
    kind: np.ndarray       # (M,) i32: 0 = instance leaf, 1 = prim leaf
    skip: np.ndarray       # (M,) i32 threaded skip pointer (-1 = tree done)
    leaf_items: np.ndarray  # (K,) i32
    shape_node_root: list  # shape id -> node index of its root
    max_stack: int


@dataclass
class _Tree:
    """One tree in reference layout (node 0 = root, children contiguous)."""

    bbox_min: np.ndarray
    bbox_max: np.ndarray
    start: np.ndarray   # internal: first child node; leaf: first leaf slot
    count: np.ndarray
    isleaf: np.ndarray
    leaf_prims: np.ndarray  # permutation of local prim ids
    height: int


def _std_partition(idx: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Reorder ``idx`` exactly like libstdc++'s std::partition.

    The reference's split_prims calls std::partition (src/scene.cpp:628),
    which for bidirectional iterators converges two pointers and swaps the
    i-th left-side failing element with the i-th right-side passing element
    (scanning from the end). Exact-equal hit distances are common (abutting
    coplanar prims), making the intra-leaf order — hence the equal-t tie
    winner — pixel-visible, so a stable partition is NOT equivalent.
    """
    out = idx.copy()
    f_pos = np.nonzero(~mask)[0]          # failing, ascending
    t_pos = np.nonzero(mask)[0][::-1]     # passing, descending
    m = min(len(f_pos), len(t_pos))
    f_pos, t_pos = f_pos[:m], t_pos[:m]
    pairs = f_pos < t_pos
    f_pos, t_pos = f_pos[pairs], t_pos[pairs]
    out[f_pos], out[t_pos] = out[t_pos], out[f_pos]
    return out


def _build_tree(bbox_min: np.ndarray, bbox_max: np.ndarray,
                equal_num: bool = False) -> _Tree:
    """Build one BVH over prims given per-prim bboxes.

    Parity with make_node/split_prims (src/scene.cpp:572-639). The default
    ``equal_num=False`` is the midpoint partition main() uses
    (src/raytrace.cpp:278), including std::partition's exact element order
    (_std_partition). ``equal_num=True`` is the API's other split mode
    (src/scene.cpp:622-627): median split via std::nth_element — see
    _build_tree_python for the contract matched.
    Dispatches to the native C++ builder when available (identical output,
    asserted by tests).
    """
    from . import native

    if not equal_num:
        nat = native.build_tree_native(bbox_min, bbox_max)
        if nat is not None:
            nb_min, nb_max, start, count, isleaf, leaf_prims, height = nat
            return _Tree(bbox_min=nb_min, bbox_max=nb_max, start=start,
                         count=count, isleaf=isleaf, leaf_prims=leaf_prims,
                         height=int(height))
    return _build_tree_python(bbox_min, bbox_max, equal_num=equal_num)


def _build_tree_python(bbox_min: np.ndarray, bbox_max: np.ndarray,
                       equal_num: bool = False) -> _Tree:
    """Pure-numpy reference implementation of _build_tree.

    ``equal_num=True`` reproduces the nth_element median split
    (src/scene.cpp:622-627): mid = (start+end)/2, and after the split every
    centroid left of mid compares <= every centroid from mid on — the
    guarantee std::nth_element makes. np.argpartition (also introselect)
    provides exactly that contract; the intra-half element ORDER is
    implementation-defined in both libraries, and since the reference
    binary never executes this mode (main passes equal_num=false,
    src/raytrace.cpp:278) there is no oracle render to pin an order
    against — the conformance bar is the property test
    (tests/test_bvh.py: equal_num tree ≡ brute force ≡ midpoint tree).
    """
    n = len(bbox_min)
    centers = (bbox_min + bbox_max) * 0.5
    order = np.arange(n, dtype=np.int32)

    cap = max(2 * n, 16)
    nb_min = np.empty((cap, 3), np.float32)
    nb_max = np.empty((cap, 3), np.float32)
    nstart = np.empty(cap, np.int64)
    ncount = np.empty(cap, np.int64)
    nleaf = np.zeros(cap, np.int32)
    num_nodes = 1  # root preallocated (src/scene.cpp:647)
    height = 0

    # worklist of (node_id, start, end, depth); LIFO with right child pushed
    # first reproduces the C++ depth-first left-then-right emission order
    stack = [(0, 0, n, 0)]
    while stack:
        nid, s, e, depth = stack.pop()
        height = max(height, depth)
        idx = order[s:e]
        pb_min = bbox_min[idx]
        pb_max = bbox_max[idx]
        nb_min[nid] = pb_min.min(axis=0) if len(idx) else np.float32(np.finfo(np.float32).max)
        nb_max[nid] = pb_max.max(axis=0) if len(idx) else np.float32(-np.finfo(np.float32).max)

        split_ok = False
        if e - s > 4:
            c = centers[idx]
            cmin = c.min(axis=0)
            cmax = c.max(axis=0)
            size = cmax - cmin
            if not (size == 0).all():
                # axis precedence x >= y >= z (src/scene.cpp:616-621)
                if size[0] >= size[1] and size[0] >= size[2]:
                    axis = 0
                elif size[1] >= size[0] and size[1] >= size[2]:
                    axis = 1
                else:
                    axis = 2
                if equal_num:
                    # median split (scene.cpp:623-627): always succeeds
                    # once the centroid extent is non-degenerate
                    mid = (s + e) // 2
                    part = np.argpartition(c[:, axis], mid - s)
                    order[s:e] = idx[part.astype(np.int32)]
                    split_ok = True
                else:
                    half = (cmin[axis] + cmax[axis]) * 0.5
                    mask = c[:, axis] < half
                    mid = s + int(mask.sum())
                    if s < mid < e:
                        order[s:e] = _std_partition(idx, mask)
                        split_ok = True

        if not split_ok:
            nleaf[nid] = 1
            nstart[nid] = s
            ncount[nid] = e - s
        else:
            first = num_nodes
            if first + 2 > cap:
                grow = max(cap // 2, 16)
                nb_min = np.concatenate([nb_min, np.empty((grow, 3), np.float32)])
                nb_max = np.concatenate([nb_max, np.empty((grow, 3), np.float32)])
                nstart = np.concatenate([nstart, np.empty(grow, np.int64)])
                ncount = np.concatenate([ncount, np.empty(grow, np.int64)])
                nleaf = np.concatenate([nleaf, np.zeros(grow, np.int32)])
                cap += grow
            num_nodes += 2
            nleaf[nid] = 0
            nstart[nid] = first
            ncount[nid] = 2
            stack.append((first + 1, mid, e, depth + 1))
            stack.append((first, s, mid, depth + 1))

    return _Tree(
        bbox_min=nb_min[:num_nodes].copy(),
        bbox_max=nb_max[:num_nodes].copy(),
        start=nstart[:num_nodes].astype(np.int32),
        count=ncount[:num_nodes].astype(np.int32),
        isleaf=nleaf[:num_nodes].copy(),
        leaf_prims=order,
        height=height,
    )


def _shape_prim_bounds(shp) -> tuple:
    """Per-prim bboxes in BVH prim order: points, lines, triangles.

    Points/lines inflate by vertex radius; triangles don't
    (src/scene.cpp:521-547).
    """
    mins, maxs = [], []
    if len(shp.points):
        p = shp.pos[shp.points]
        r = shp.radius[shp.points][:, None]
        mins.append(p - r)
        maxs.append(p + r)
    if len(shp.lines):
        p0 = shp.pos[shp.lines[:, 0]]
        p1 = shp.pos[shp.lines[:, 1]]
        r0 = shp.radius[shp.lines[:, 0]][:, None]
        r1 = shp.radius[shp.lines[:, 1]][:, None]
        mins.append(np.minimum(p0 - r0, p1 - r1))
        maxs.append(np.maximum(p0 + r0, p1 + r1))
    if len(shp.triangles):
        v = shp.pos[shp.triangles]  # (T, 3, 3)
        mins.append(v.min(axis=1))
        maxs.append(v.max(axis=1))
    bbox_min = np.concatenate(mins).astype(np.float32)
    bbox_max = np.concatenate(maxs).astype(np.float32)
    return bbox_min, bbox_max


def _thread_tree(start: np.ndarray, isleaf: np.ndarray) -> np.ndarray:
    """Skip pointers for stackless traversal in the reference's DFS order.

    The reference's stack machine pushes children (start, start+1) and pops
    LIFO (src/scene.cpp:461-463): the SECOND child is visited first. The
    threaded equivalent: on bbox hit at an internal node go to start+1; on
    miss (or subtree exhaustion) go to skip[n]:

        skip[start+1] = start          (sibling next)
        skip[start]   = skip[parent]   (resume above)

    skip[root] = -1 terminates the tree. Visit order — hence equal-t tie
    winners — is identical to the stack machine.
    """
    n = len(start)
    skip = np.full(n, -1, np.int32)
    # iterative preorder; children ids are always > parent id so a simple
    # worklist suffices
    work = [0]
    while work:
        nid = work.pop()
        if isleaf[nid]:
            continue
        c0 = int(start[nid])
        c1 = c0 + 1
        skip[c1] = c0
        skip[c0] = skip[nid]
        work.append(c0)
        work.append(c1)
    return skip


def bbox_to_world(axes: np.ndarray, o: np.ndarray,
                  bmin: np.ndarray, bmax: np.ndarray) -> tuple:
    """8-corner transform of a bbox (parity: src/vmath.h:312-326)."""
    corners = np.array([
        [bmin[0], bmin[1], bmin[2]], [bmin[0], bmin[1], bmax[2]],
        [bmin[0], bmax[1], bmin[2]], [bmin[0], bmax[1], bmax[2]],
        [bmax[0], bmin[1], bmin[2]], [bmax[0], bmin[1], bmax[2]],
        [bmax[0], bmax[1], bmin[2]], [bmax[0], bmax[1], bmax[2]],
    ], dtype=np.float32)
    w = corners @ axes + o
    return w.min(axis=0), w.max(axis=0)


def build_scene_bvh(host, shape_prim_offset: list,
                    equal_num: bool = False) -> FlatBVH:
    """Build all shape trees + the scene tree, flattened into one pool.

    ``equal_num`` selects the reference build_bvh API's split mode
    (src/scene.cpp:652 argument): False = midpoint partition (what main
    runs), True = nth_element median split."""
    trees = []
    for shp in host.shapes:
        bmin, bmax = _shape_prim_bounds(shp)
        trees.append(_build_tree(bmin, bmax, equal_num=equal_num))

    # scene tree over world-space instance bboxes (src/scene.cpp:554-565)
    ib_min = np.empty((len(host.instances), 3), np.float32)
    ib_max = np.empty((len(host.instances), 3), np.float32)
    for k, ist in enumerate(host.instances):
        t = trees[ist.shape]
        ib_min[k], ib_max[k] = bbox_to_world(
            ist.axes, ist.o, t.bbox_min[0], t.bbox_max[0])
    scene_tree = _build_tree(ib_min, ib_max, equal_num=equal_num)

    # flatten: scene tree first, then shape trees
    all_trees = [scene_tree] + trees
    node_offset = np.cumsum([0] + [len(t.start) for t in all_trees])
    leaf_offset = np.cumsum([0] + [len(t.leaf_prims) for t in all_trees])

    def flat_tree(t: _Tree, ti: int, item_base: int):
        start = t.start.copy()
        internal = t.isleaf == 0
        start[internal] += node_offset[ti]
        start[~internal] += leaf_offset[ti]
        items = t.leaf_prims + item_base
        return start, items

    starts, items_l, skips = [], [], []
    for ti, t in enumerate(all_trees):
        base = 0 if ti == 0 else shape_prim_offset[ti - 1]
        s, it = flat_tree(t, ti, base)
        starts.append(s)
        items_l.append(it)
        sk = _thread_tree(t.start, t.isleaf)
        sk = np.where(sk >= 0, sk + node_offset[ti], -1).astype(np.int32)
        skips.append(sk)

    kind = np.concatenate([
        np.zeros(len(scene_tree.start), np.int32),
        np.ones(node_offset[-1] - len(scene_tree.start), np.int32),
    ])

    max_shape_h = max((t.height for t in trees), default=0)
    # LIFO bound: scene path (height+1) + up-to-4 instance roots pushed at a
    # scene leaf + shape path (height+1), with slack
    max_stack = scene_tree.height + 1 + 4 + max_shape_h + 1 + 2
    max_stack = ((max_stack + 7) // 8) * 8

    return FlatBVH(
        bbox_min=np.concatenate([t.bbox_min for t in all_trees]),
        bbox_max=np.concatenate([t.bbox_max for t in all_trees]),
        start=np.concatenate(starts).astype(np.int32),
        count=np.concatenate([t.count for t in all_trees]).astype(np.int32),
        isleaf=np.concatenate([t.isleaf for t in all_trees]).astype(np.int32),
        kind=kind,
        skip=np.concatenate(skips).astype(np.int32),
        leaf_items=np.concatenate(items_l).astype(np.int32),
        shape_node_root=[int(node_offset[i + 1]) for i in range(len(trees))],
        max_stack=int(max_stack),
    )
