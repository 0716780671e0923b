"""ctypes bindings for the native host runtime (kernels/host/yrt_native.cpp).

This package's own copy of ``yocto_raytracing_tpu/native.py`` and of its
C++ source, built with the same g++ flags so that BVHs and parsed meshes
stay identical. Compiled on demand into the git-ignored ``kernels/build/``
and reused while it is newer than the source; every entry point has a
pure-Python fallback (io/objparser.py, bvh.py) and the test suite asserts
bit-identical outputs. Set YRT_NO_NATIVE=1 to force the Python paths.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_KERNELS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "kernels")
_SRC = os.path.join(_KERNELS, "host", "yrt_native.cpp")
_BUILD = os.path.join(_KERNELS, "build")
_LIB_CACHE = None
_TRIED = False


def _compile(src: str, out: str) -> bool:
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC",
             "-std=c++17", src, "-o", out],
            check=True, capture_output=True, timeout=300)
        return True
    except (subprocess.SubprocessError, OSError):
        return False


def get_lib():
    """The loaded native library, or None (missing toolchain / opted out)."""
    global _LIB_CACHE, _TRIED
    if _TRIED:
        return _LIB_CACHE
    _TRIED = True
    if os.environ.get("YRT_NO_NATIVE") == "1" or not os.path.exists(_SRC):
        return None
    so = os.path.join(_BUILD, "yrt_native.so")
    if (not os.path.exists(so)
            or os.path.getmtime(so) < os.path.getmtime(_SRC)):
        os.makedirs(_BUILD, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        if not _compile(_SRC, tmp):
            return None
        os.replace(tmp, so)
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None

    i32, f32p, i32p, vp, cp = (ctypes.c_int32,
                               np.ctypeslib.ndpointer(np.float32),
                               np.ctypeslib.ndpointer(np.int32),
                               ctypes.c_void_p, ctypes.c_char_p)
    lib.yrt_bvh_build.restype = vp
    lib.yrt_bvh_build.argtypes = [i32, f32p, f32p]
    lib.yrt_bvh_num_nodes.restype = i32
    lib.yrt_bvh_num_nodes.argtypes = [vp]
    lib.yrt_bvh_height.restype = i32
    lib.yrt_bvh_height.argtypes = [vp]
    lib.yrt_bvh_data.argtypes = [vp, f32p, f32p, i32p, i32p, i32p, i32p]
    lib.yrt_bvh_free.argtypes = [vp]

    lib.yrt_obj_parse.restype = vp
    lib.yrt_obj_parse.argtypes = [cp, i32]
    lib.yrt_obj_num_shapes.restype = i32
    lib.yrt_obj_num_shapes.argtypes = [vp]
    lib.yrt_obj_num_objects.restype = i32
    lib.yrt_obj_num_objects.argtypes = [vp]
    lib.yrt_obj_shape_info.argtypes = [vp, i32, i32p]
    lib.yrt_obj_shape_names.argtypes = [vp, i32, ctypes.c_char_p,
                                        ctypes.c_char_p]
    lib.yrt_obj_shape_data.argtypes = [vp, i32, ctypes.c_void_p,
                                       ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_void_p]
    lib.yrt_obj_object_name_len.restype = i32
    lib.yrt_obj_object_name_len.argtypes = [vp, i32]
    lib.yrt_obj_object_name.argtypes = [vp, i32, ctypes.c_char_p]
    lib.yrt_obj_free.argtypes = [vp]
    _LIB_CACHE = lib
    return lib


def build_tree_native(bbox_min: np.ndarray, bbox_max: np.ndarray):
    """Native BVH build -> (bbox_min, bbox_max, start, count, isleaf,
    leaf_prims, height) or None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(bbox_min)
    bmin = np.ascontiguousarray(bbox_min, np.float32)
    bmax = np.ascontiguousarray(bbox_max, np.float32)
    h = lib.yrt_bvh_build(n, bmin, bmax)
    try:
        m = lib.yrt_bvh_num_nodes(h)
        height = lib.yrt_bvh_height(h)
        nb_min = np.empty((m, 3), np.float32)
        nb_max = np.empty((m, 3), np.float32)
        start = np.empty(m, np.int32)
        count = np.empty(m, np.int32)
        isleaf = np.empty(m, np.int32)
        leaf_prims = np.empty(n, np.int32)
        lib.yrt_bvh_data(h, nb_min, nb_max, start, count, isleaf, leaf_prims)
        return nb_min, nb_max, start, count, isleaf, leaf_prims, height
    finally:
        lib.yrt_bvh_free(h)


def parse_obj_native(path: str, flip_texcoord: bool = True):
    """Native OBJ geometry parse -> (shapes, object_names) or None.

    shapes: list of dicts with keys name, matname, object_id, pos, texcoord,
    norm, radius (None when absent), triangles, lines, points — mirroring
    io/objparser.ObjShape field semantics.
    """
    lib = get_lib()
    if lib is None:
        return None
    h = lib.yrt_obj_parse(path.encode(), 1 if flip_texcoord else 0)
    if not h:
        raise FileNotFoundError(path)
    try:
        shapes = []
        info = np.empty(12, np.int32)
        for i in range(lib.yrt_obj_num_shapes(h)):
            lib.yrt_obj_shape_info(h, i, info)
            (nv, ntris, nlines, npts, has_pos, has_tc, has_norm, has_rad,
             name_len, mat_len, object_id, ntets) = (int(x) for x in info)
            name_buf = ctypes.create_string_buffer(max(name_len, 1))
            mat_buf = ctypes.create_string_buffer(max(mat_len, 1))
            lib.yrt_obj_shape_names(h, i, name_buf, mat_buf)

            def arr(shape, dtype):
                return np.empty(shape, dtype)

            pos = arr((nv, 3), np.float32) if has_pos else None
            tc = arr((nv, 2), np.float32) if has_tc else None
            norm = arr((nv, 3), np.float32) if has_norm else None
            rad = arr(nv, np.float32) if has_rad else None
            tris = arr((ntris, 3), np.int32)
            lines = arr((nlines, 2), np.int32)
            points = arr(npts, np.int32)
            tets = arr((ntets, 4), np.int32)

            def ptr(a):
                return a.ctypes.data_as(ctypes.c_void_p) if a is not None \
                    else None

            lib.yrt_obj_shape_data(h, i, ptr(pos), ptr(tc), ptr(norm),
                                   ptr(rad), ptr(tris), ptr(lines),
                                   ptr(points), ptr(tets))
            shapes.append(dict(
                name=name_buf.raw[:name_len].decode(errors="replace"),
                matname=mat_buf.raw[:mat_len].decode(errors="replace"),
                object_id=object_id, pos=pos, texcoord=tc, norm=norm,
                radius=rad, triangles=tris, lines=lines, points=points,
                tetrahedra=tets))
        object_names = []
        for i in range(lib.yrt_obj_num_objects(h)):
            ln = lib.yrt_obj_object_name_len(h, i)
            buf = ctypes.create_string_buffer(max(ln, 1))
            lib.yrt_obj_object_name(h, i, buf)
            object_names.append(buf.raw[:ln].decode(errors="replace"))
        return shapes, object_names
    finally:
        lib.yrt_obj_free(h)
