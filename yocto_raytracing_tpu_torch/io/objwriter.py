"""Wavefront OBJ/MTL scene writer (Yocto extensions included).

``save_obj``-equivalent of the reference save path (yobj::save_obj,
src/ext/yocto_obj.h:423-491 + scene_to_obj, src/ext/yocto_scn.cpp:497-~690):
writes v/vn/vt/vr vertex data, f/l/p elements with full triplets, the Yocto
``c`` camera / ``e`` environment / ``i`` instance extension lines, a sidecar
.mtl with Ke/Kd/Ks/Kr/Ns and map_* slots, and the referenced texture image
files. Output round-trips through ``load_scene`` to the same render.

Conventions mirrored from the parser (io/objparser.py):
* texcoord V is un-flipped on write (``vt v = 1 - v``) so the parser's
  parse-time flip (src/ext/yocto_obj.cpp:409-411) round-trips.
* ``Ns`` is recovered from roughness with the reference's own inverse
  ``ns = 2/rs^4 - 2`` (scene_to_obj, src/ext/yocto_scn.cpp:531), the exact
  inverse of the loader's ``rs = (2/(ns+2))^(1/4)``.
* elements carry 1-based global indices with ``v/vt/vn`` triplets and a
  5th radius slot (``v/vt/vn//vr``) for points/lines.

This package's own copy of ``yocto_raytracing_tpu/io/objwriter.py``, code and
results unchanged.
"""

from __future__ import annotations

import os

import numpy as np


def _fmt(x: float) -> str:
    # repr of float32 round-trips exactly through the parser's float()
    return repr(float(np.float32(x)))


def _fmt3(v) -> str:
    return " ".join(_fmt(x) for x in np.asarray(v).reshape(-1)[:3])


def _frame12(axes: np.ndarray, o: np.ndarray) -> str:
    vals = list(np.asarray(axes, np.float32).reshape(-1)) + \
        list(np.asarray(o, np.float32).reshape(-1))
    return " ".join(_fmt(v) for v in vals)


def _ns_from_rs(rs: float) -> float:
    """Inverse roughness conversion (src/ext/yocto_scn.cpp:531)."""
    return 2.0 / float(rs) ** 4 - 2.0 if rs else 1e6


def save_obj(host, filename: str, save_textures: bool = True) -> None:
    """Write a ``HostScene`` to ``filename`` (.obj) + sidecar .mtl."""
    from .. import image as image_mod

    dirname = os.path.dirname(filename) or "."
    stem = os.path.splitext(os.path.basename(filename))[0]
    os.makedirs(dirname, exist_ok=True)

    # shape -> material binding comes from the first instance using it
    # (the load path gives every instance of a shape the same material)
    shape_mat = {}
    for ist in host.instances:
        shape_mat.setdefault(ist.shape, ist.material)

    # environments reference materials by name in the `e` line; synthesize
    # one when no existing material carries the environment's emission
    materials = list(host.materials)
    env_mat = []
    for i, env in enumerate(host.environments):
        found = -1
        for mid, m in enumerate(materials):
            if (np.array_equal(np.asarray(m.ke, np.float32),
                               np.asarray(env.ke, np.float32))
                    and m.ke_txt == env.ke_txt):
                found = mid
                break
        if found < 0:
            from .. import scene as scene_mod

            m = scene_mod.HostMaterial(name=f"env_{i}")
            m.ke = np.asarray(env.ke, np.float32)
            m.ke_txt = env.ke_txt
            materials.append(m)
            found = len(materials) - 1
        env_mat.append(found)

    # ---- textures ----
    if save_textures:
        for tex in host.textures:
            out = os.path.join(dirname, tex.name)
            os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
            if tex.hdr is not None:
                image_mod.save_image_hdr(out, tex.hdr)
            elif tex.ldr is not None:
                image_mod.save_image_png(out, tex.ldr)

    # ---- MTL ----
    def tex_name(tid: int) -> str:
        return host.textures[tid].name if 0 <= tid < len(host.textures) \
            else ""

    mtl_name = stem + ".mtl"
    with open(os.path.join(dirname, mtl_name), "wt") as f:
        for m in materials:
            f.write(f"newmtl {m.name}\n")
            f.write("  illum 2\n")
            f.write(f"  Ke {_fmt3(m.ke)}\n")
            f.write(f"  Kd {_fmt3(m.kd)}\n")
            f.write(f"  Ks {_fmt3(m.ks)}\n")
            f.write(f"  Kr {_fmt3(m.kr)}\n")
            f.write(f"  Ns {_fmt(_ns_from_rs(m.rs))}\n")
            for key, tid in (("map_Ke", m.ke_txt), ("map_Kd", m.kd_txt),
                             ("map_Ks", m.ks_txt), ("map_Kr", m.kr_txt),
                             ("map_norm", m.norm_txt),
                             ("map_disp", m.disp_txt)):
                name = tex_name(tid)
                if name:
                    f.write(f"  {key} {name}\n")
            f.write("\n")

    # ---- OBJ ----
    with open(filename, "wt") as f:
        f.write(f"mtllib {mtl_name}\n")
        for cam in host.cameras:
            f.write(f"c {cam.name or 'cam'} 0 {_fmt(cam.yfov)} "
                    f"{_fmt(cam.aspect)} {_fmt(cam.aperture)} "
                    f"{_fmt(cam.focus)} {_frame12(cam.axes, cam.o)}\n")
        for i, env in enumerate(host.environments):
            f.write(f"e {env.name or f'env_{i}'} "
                    f"{materials[env_mat[i]].name} "
                    f"{_frame12(env.axes, env.o)}\n")

        voff = toff = noff = roff = 1  # 1-based running offsets
        obj_names = []
        for sid, shp in enumerate(host.shapes):
            name = f"{shp.name or 'shape'}_{sid}"
            obj_names.append(name)
            f.write(f"o {name}\n")
            mid = shape_mat.get(sid, -1)
            if 0 <= mid < len(materials):
                f.write(f"usemtl {materials[mid].name}\n")
            for p in shp.pos:
                f.write(f"v {_fmt3(p)}\n")
            for n in shp.norm:
                f.write(f"vn {_fmt3(n)}\n")
            for t in shp.texcoord:
                # un-flip: the parser will apply v = 1 - v again
                f.write(f"vt {_fmt(t[0])} {_fmt(1.0 - float(t[1]))}\n")
            has_radius = len(shp.radius) and (len(shp.points)
                                              or len(shp.lines))
            if has_radius:
                for r in shp.radius:
                    f.write(f"vr {_fmt(r)}\n")

            def trip(i: int) -> str:
                s = f"{voff + i}/{toff + i}/{noff + i}"
                if has_radius:
                    s += f"//{roff + i}"
                return s

            for tri in shp.triangles:
                f.write(f"f {trip(tri[0])} {trip(tri[1])} {trip(tri[2])}\n")
            for line in shp.lines:
                f.write(f"l {trip(line[0])} {trip(line[1])}\n")
            for pt in shp.points:
                f.write(f"p {trip(int(pt))}\n")
            nv = len(shp.pos)
            voff += nv
            toff += nv
            noff += nv
            if has_radius:
                roff += nv

        for ist in host.instances:
            f.write(f"i {ist.name or 'instance'} {obj_names[ist.shape]} "
                    f"{_frame12(ist.axes, ist.o)}\n")
