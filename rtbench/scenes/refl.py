"""Scene generator ``refl``: the refl_pointlight stand-in.

refl_pointlight (graphics17a_hw02 ``in/refl_pointlight``) is the
simple_pointlight geometry with a reflective floor: two textured spheres
on a quad floor whose material has ``Kr 0.4``, two point lights of ``Ke
100``, sphere materials of ``Ns 198`` and ``Ns 19998``; its OBJ holds
13,824 faces (SURVEY.md, scene fixtures). The OBJ is not in the
repository, so this generator synthesizes the same counts and materials
from the builders of ``ref.shapes``: two lat-long spheres of
``sphere_segments`` = (nu, nv) cells, 2 x nu x nv triangles each, on a
two-triangle floor, two point lights and one look-at camera at aspect
16/9. Flat colours stand in for the textures. ``make(scene)`` takes the
configuration's ``scene`` object.
"""

from __future__ import annotations

import numpy as np

from rtbench.ref.flat import HostMaterial, HostScene
from rtbench.ref.shapes import (assemble, lookat_camera, point_light_shape,
                                quad_floor, uv_sphere)


def _rs(ns: float) -> float:
    """The roughness of a Blinn-Phong exponent (src/ext/yocto_scn.cpp:531,
    the inverse of ``ref.objwriter._ns_from_rs``)."""
    return float((2.0 / (ns + 2.0)) ** 0.25)


def make(scene: dict) -> HostScene:
    """The scene of a configuration's ``scene`` object."""
    nu, nv = scene["sphere_segments"]
    left = uv_sphere("sphere1", center=(-0.6, 0.5, 0.0), rad=0.5, nu=nu,
                     nv=nv)
    right = uv_sphere("sphere2", center=(0.6, 0.5, 0.0), rad=0.5, nu=nu,
                      nv=nv)
    floor = quad_floor("floor", half=4.0, y=0.0)
    l1 = point_light_shape("light1", (-3.0, 5.0, 4.0))
    l2 = point_light_shape("light2", (3.0, 5.0, 4.0))
    f32 = np.float32
    materials = [
        HostMaterial(name="floor", kd=np.full(3, 0.4, f32),
                     ks=np.zeros(3, f32), rs=_rs(198.0),
                     kr=np.full(3, 0.4, f32)),
        HostMaterial(name="colored", kd=np.asarray([0.5, 0.3, 0.1], f32),
                     ks=np.full(3, 0.04, f32), rs=_rs(198.0)),
        HostMaterial(name="rcolored", kd=np.asarray([0.1, 0.3, 0.5], f32),
                     ks=np.full(3, 0.04, f32), rs=_rs(19998.0)),
        HostMaterial(name="pointlight", ke=np.full(3, 100.0, f32),
                     kd=np.zeros(3, f32), ks=np.zeros(3, f32)),
    ]
    cam = lookat_camera("cam", eye=(0.0, 1.4, 3.6), target=(0.0, 0.45, 0.0))
    return assemble([floor, left, right, l1, l2], materials,
                    [0, 1, 2, 3, 3], [cam])
