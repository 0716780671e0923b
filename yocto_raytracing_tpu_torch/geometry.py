"""Mesh utilities: edge maps, tesselation/subdivision, parametric shape
generation, merging.

This package's own copy of ``yocto_raytracing_tpu/geometry.py`` (numpy
only, results unchanged).

Capability parity with the ym mesh-utility section
(src/ext/yocto_math.h:3793-4480): ``quads_to_triangles``, the edge map,
midpoint tesselation of lines/triangles/quads, Catmull-Clark subdivision,
parametric surface/line/point generation, and mesh merging — vectorized
numpy host-side tools (mesh prep happens before device upload, like the
reference runs them before building BVHs).

Determinism note: the reference's edge/face point NUMBERING follows
``std::unordered_map`` iteration order — implementation-defined. The
VALUES it produces are order-independent (midpoints/centroids), so no
behavior depends on the numbering. Here edges are numbered in FIRST-SEEN
order (deterministic across runs), matching the reference's insertion
ids though not its iteration layout.
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# element geometry helpers (src/vmath.h:225-245)
# ---------------------------------------------------------------------------


def triangle_normal(v0, v1, v2):
    """normalize(cross(v1-v0, v2-v0)) (vmath.h:225-228), batched."""
    n = np.cross(np.asarray(v1) - v0, np.asarray(v2) - v0)
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    return (n / np.maximum(ln, 1e-30)).astype(np.float32)


def triangle_area(v0, v1, v2):
    """|cross(e1, e2)| / 2 (vmath.h:230-232), batched."""
    c = np.cross(np.asarray(v1) - v0, np.asarray(v2) - v0)
    return (np.linalg.norm(c, axis=-1) / 2).astype(np.float32)


def line_tangent(v0, v1):
    """normalize(v1 - v0) (vmath.h:234-236), batched."""
    d = np.asarray(v1, np.float32) - v0
    ln = np.linalg.norm(d, axis=-1, keepdims=True)
    return (d / np.maximum(ln, 1e-30)).astype(np.float32)


def line_length(v0, v1):
    """|v1 - v0| (vmath.h:238-240), batched."""
    return np.linalg.norm(np.asarray(v1, np.float32) - v0,
                          axis=-1).astype(np.float32)


def tetrahedron_volume(v0, v1, v2, v3):
    """dot(cross(v1-v0, v2-v0), v3-v0) / 6 (vmath.h:242-245), batched,
    signed."""
    v0 = np.asarray(v0, np.float32)
    c = np.cross(np.asarray(v1) - v0, np.asarray(v2) - v0)
    return (np.sum(c * (np.asarray(v3) - v0), axis=-1) / 6).astype(
        np.float32)


def quads_to_triangles(quads: np.ndarray) -> np.ndarray:
    """(Q, 4) -> (2Q, 3): {x, y, w}, {z, w, y} (yocto_math.h:3856-3867)."""
    q = np.asarray(quads, np.int32).reshape(-1, 4)
    t1 = q[:, [0, 1, 3]]
    t2 = q[:, [2, 3, 1]]
    return np.stack([t1, t2], axis=1).reshape(-1, 3)


def edge_map(faces: np.ndarray):
    """Unique undirected edges of a triangle/quad array, first-seen order.

    Returns (edges (E, 2) i32 with min-vertex-first like the reference's
    canonicalization, ids dict {(a, b): id}) — ym::edge_map
    (yocto_math.h:3872-3943); degenerate quads (z == w) contribute their
    triangle edges only.
    """
    f = np.asarray(faces, np.int32)
    if f.shape[1] == 3:
        # per-face interleaved (e01, e12, e20 of face 0, then face 1, ...)
        # so first-seen numbering equals the reference's per-face insertion
        # order (edge_map(triangles), yocto_math.h:3877-3884)
        raw = f[:, [[0, 1], [1, 2], [2, 0]]].reshape(-1, 2)
    else:
        # per-face insertion order for first-seen numbering (quads emit 4
        # edges, degenerate z == w quads their 3 triangle edges; faces are
        # few; host-side tool)
        raws = []
        for row in f:
            if row[2] == row[3]:
                raws += [(row[0], row[1]), (row[1], row[2]),
                         (row[2], row[0])]
            else:
                raws += [(row[0], row[1]), (row[1], row[2]),
                         (row[2], row[3]), (row[3], row[0])]
        raw = np.asarray(raws, np.int32).reshape(-1, 2)  # (0, 2) if empty
    canon = np.stack([raw.min(axis=1), raw.max(axis=1)], axis=1)
    _, first, inverse = np.unique(canon, axis=0, return_index=True,
                                  return_inverse=True)
    # renumber unique edges by first occurrence (insertion order)
    order = np.argsort(first, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    ids = rank[inverse]              # per raw edge -> first-seen id
    edges = np.empty((len(order), 2), np.int32)
    edges[ids] = canon
    id_of = {(int(a), int(b)): int(i) for (a, b), i in
             zip(canon, ids)}
    return edges, id_of


def _midpoints(vert: np.ndarray, edges: np.ndarray) -> np.ndarray:
    return (vert[edges[:, 0]] + vert[edges[:, 1]]) / 2.0


def tesselate_lines(lines, verts: dict, normalize_tangents=True):
    """Split each segment in half (yocto_math.h:3949-3986).

    ``verts`` maps name -> (V, ...) arrays ("tang" gets re-normalized);
    returns (new_lines, new_verts).
    """
    lines = np.asarray(lines, np.int32).reshape(-1, 2)
    nv = len(next(iter(verts.values())))
    out = {}
    for name, v in verts.items():
        v = np.asarray(v)
        mid = (v[lines[:, 0]] + v[lines[:, 1]]) / 2.0
        nvert = np.concatenate([v, mid])
        if name == "tang" and normalize_tangents and nvert.ndim == 2:
            n = np.linalg.norm(nvert, axis=-1, keepdims=True)
            nvert = nvert / np.maximum(n, 1e-20)
        out[name] = nvert
    eid = nv + np.arange(len(lines), dtype=np.int32)
    new = np.stack([
        np.stack([lines[:, 0], eid], axis=1),
        np.stack([eid, lines[:, 1]], axis=1)], axis=1).reshape(-1, 2)
    return new, out


def tesselate_triangles(triangles, verts: dict, normalize_normals=True):
    """4-way midpoint split (yocto_math.h:3988-4032).

    Returns (new_triangles (4T, 3), new_verts)."""
    tris = np.asarray(triangles, np.int32).reshape(-1, 3)
    nv = len(next(iter(verts.values())))
    edges, id_of = edge_map(tris)
    out = {}
    for name, v in verts.items():
        v = np.asarray(v)
        nvert = np.concatenate([v, _midpoints(v, edges)])
        if name == "norm" and normalize_normals and nvert.ndim == 2:
            n = np.linalg.norm(nvert, axis=-1, keepdims=True)
            nvert = nvert / np.maximum(n, 1e-20)
        out[name] = nvert

    def e(a, b):
        lo = np.minimum(a, b)
        hi = np.maximum(a, b)
        return nv + np.asarray(
            [id_of[(int(x), int(y))] for x, y in zip(lo, hi)], np.int32)

    exy = e(tris[:, 0], tris[:, 1])
    eyz = e(tris[:, 1], tris[:, 2])
    ezx = e(tris[:, 2], tris[:, 0])
    new = np.stack([
        np.stack([tris[:, 0], exy, ezx], axis=1),
        np.stack([tris[:, 1], eyz, exy], axis=1),
        np.stack([tris[:, 2], ezx, eyz], axis=1),
        np.stack([exy, eyz, ezx], axis=1)], axis=1).reshape(-1, 3)
    return new, out


def tesselate_quads(quads, verts: dict, normalize_normals=True):
    """Face split with edge + face points: 4 quads per quad, 3 per
    degenerate (triangle) quad (yocto_math.h:4034-4104).

    Divergence (documented, deliberate): we assign ONE face point per quad
    ROW. The reference's ``fmap[f] = fmap.size() + ...`` (4045-4046) keys
    by quad VALUE, so a mesh containing duplicate faces dedupes them —
    but re-assigning an existing key makes the stored id the CURRENT map
    size (evaluation-order-unspecified in C++14), which exceeds the
    ``resize`` at 4050 and writes out of bounds. Duplicate-face meshes are
    UB in the reference; for the well-defined (duplicate-free) case the
    two numberings agree.
    """
    q = np.asarray(quads, np.int32).reshape(-1, 4)
    nv = len(next(iter(verts.values())))
    edges, id_of = edge_map(q)
    ne = len(edges)
    degen = q[:, 2] == q[:, 3]

    out = {}
    for name, v in verts.items():
        v = np.asarray(v)
        face_pt = np.where(
            degen.reshape(-1, *([1] * (v.ndim - 1))),
            (v[q[:, 0]] + v[q[:, 1]] + v[q[:, 2]]) / 3.0,
            (v[q[:, 0]] + v[q[:, 1]] + v[q[:, 2]] + v[q[:, 3]]) / 4.0)
        nvert = np.concatenate([v, _midpoints(v, edges), face_pt])
        if name == "norm" and normalize_normals and nvert.ndim == 2:
            n = np.linalg.norm(nvert, axis=-1, keepdims=True)
            nvert = nvert / np.maximum(n, 1e-20)
        out[name] = nvert

    def e(a, b):
        return nv + np.asarray(
            [id_of[(int(min(x, y)), int(max(x, y)))]
             for x, y in zip(a, b)], np.int32)

    fid = nv + ne + np.arange(len(q), dtype=np.int32)
    new = []
    for k, row in enumerate(q):
        x, y, z, w = (int(v) for v in row)
        if z != w:
            new += [
                (x, e([x], [y])[0], fid[k], e([w], [x])[0]),
                (y, e([y], [z])[0], fid[k], e([x], [y])[0]),
                (z, e([z], [w])[0], fid[k], e([y], [z])[0]),
                (w, e([w], [x])[0], fid[k], e([z], [w])[0]),
            ]
        else:
            new += [
                (x, e([x], [y])[0], fid[k], e([z], [x])[0]),
                (y, e([y], [z])[0], fid[k], e([x], [y])[0]),
                (z, e([z], [x])[0], fid[k], e([y], [z])[0]),
            ]
    return np.asarray(new, np.int32).reshape(-1, 4), out


def tesselate_catmullclark(quads, verts: dict, normalize_normals=True):
    """One Catmull-Clark subdivision step (yocto_math.h:4106-4200): the
    quad face-split followed by the reference's averaging + correction
    pass ``v += (avg - v) * (4 / count)``."""
    new_q, out = tesselate_quads(quads, verts,
                                 normalize_normals=normalize_normals)
    sm = {}
    for name, v in out.items():
        v = np.array(v, np.float32)
        avg = np.zeros_like(v)
        count = np.zeros(len(v), np.int32)
        fc = (v[new_q[:, 0]] + v[new_q[:, 1]] + v[new_q[:, 2]]
              + v[new_q[:, 3]]) / 4.0
        for k in range(4):
            np.add.at(avg, new_q[:, k], fc)
            np.add.at(count, new_q[:, k], 1)
        cnt = np.maximum(count, 1).astype(np.float32)
        cshape = (-1,) + (1,) * (v.ndim - 1)
        avg = avg / cnt.reshape(cshape)
        sm[name] = v + (avg - v) * (4.0 / cnt.reshape(cshape))
    return new_q, sm


def make_faces(usteps: int, vsteps: int, pos_fn, norm_fn=None,
               texcoord_fn=None, as_triangles=True):
    """Parametric surface over a (usteps+1) x (vsteps+1) uv grid with the
    reference's face layout (make_faces, yocto_math.h:4204-4265):
    alternating triangle diagonals by ``(i + j) % 2``, or quads.

    Callbacks take uv arrays of shape (V, 2). Returns
    (elems, pos, norm, texcoord).
    """
    j, i = np.meshgrid(np.arange(vsteps + 1), np.arange(usteps + 1),
                       indexing="ij")
    uv = np.stack([i / usteps, j / vsteps], axis=-1).reshape(-1, 2)
    uv = uv.astype(np.float32)
    pos = np.asarray(pos_fn(uv), np.float32)
    norm = (np.asarray(norm_fn(uv), np.float32) if norm_fn
            else np.zeros_like(pos))
    tc = (np.asarray(texcoord_fn(uv), np.float32) if texcoord_fn
          else uv.copy())

    def vid(i, j):
        return j * (usteps + 1) + i

    jj, ii = np.meshgrid(np.arange(vsteps), np.arange(usteps),
                         indexing="ij")
    ii = ii.ravel()
    jj = jj.ravel()
    a = vid(ii, jj)
    b = vid(ii + 1, jj)
    c = vid(ii + 1, jj + 1)
    d = vid(ii, jj + 1)
    if not as_triangles:
        return (np.stack([a, b, c, d], axis=1).astype(np.int32), pos, norm,
                tc)
    odd = ((ii + jj) % 2) == 1
    f1 = np.where(odd[:, None], np.stack([a, b, c], 1),
                  np.stack([a, b, d], 1))
    f2 = np.where(odd[:, None], np.stack([c, d, a], 1),
                  np.stack([c, d, b], 1))
    tris = np.stack([f1, f2], axis=1).reshape(-1, 3).astype(np.int32)
    return tris, pos, norm, tc


def make_lines(num: int, usteps: int, pos_fn, tang_fn=None,
               texcoord_fn=None, radius_fn=None):
    """Parametric line set (make_lines, yocto_math.h:4334-4370): ``num``
    polylines of ``usteps`` segments. Callbacks take (line_idx (V,),
    u (V,)). Returns (lines, pos, tang, texcoord, radius)."""
    j, i = np.meshgrid(np.arange(num), np.arange(usteps + 1),
                       indexing="ij")
    jf = j.ravel()
    u = (i / usteps).ravel().astype(np.float32)
    pos = np.asarray(pos_fn(jf, u), np.float32)
    tang = (np.asarray(tang_fn(jf, u), np.float32) if tang_fn
            else np.zeros_like(pos))
    tc = (np.asarray(texcoord_fn(jf, u), np.float32) if texcoord_fn
          else np.stack([u, jf / max(num - 1, 1)], axis=-1)
          .astype(np.float32))
    rad = (np.asarray(radius_fn(jf, u), np.float32) if radius_fn
           else np.full(len(u), 0.001, np.float32))

    jj, ii = np.meshgrid(np.arange(num), np.arange(usteps), indexing="ij")
    a = jj.ravel() * (usteps + 1) + ii.ravel()
    lines = np.stack([a, a + 1], axis=1).astype(np.int32)
    return lines, pos, tang, tc, rad


def make_points(num: int, pos_fn, norm_fn=None, texcoord_fn=None,
                radius_fn=None):
    """Parametric point set (make_points, yocto_math.h:4379-4405)."""
    i = np.arange(num)
    pos = np.asarray(pos_fn(i), np.float32)
    norm = (np.asarray(norm_fn(i), np.float32) if norm_fn
            else np.tile(np.asarray([[0, 0, 1]], np.float32), (num, 1)))
    tc = (np.asarray(texcoord_fn(i), np.float32) if texcoord_fn
          else np.stack([i / max(num - 1, 1), np.zeros(num)], -1)
          .astype(np.float32))
    rad = (np.asarray(radius_fn(i), np.float32) if radius_fn
           else np.full(num, 0.001, np.float32))
    return np.arange(num, dtype=np.int32), pos, norm, tc, rad


def merge_meshes(elems_a, verts_a: dict, elems_b, verts_b: dict):
    """Append mesh B to mesh A with reindexed elements
    (merge_triangles/merge_quads, yocto_math.h:4410-4440)."""
    off = len(next(iter(verts_a.values())))
    elems = np.concatenate([np.asarray(elems_a, np.int32),
                            np.asarray(elems_b, np.int32) + off])
    verts = {k: np.concatenate([np.asarray(verts_a[k]),
                                np.asarray(verts_b[k])])
             for k in verts_a}
    return elems, verts
