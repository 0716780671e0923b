"""Scene generator ``hair``: the lines_pointlight stand-in.

Copied from yocto_raytracing_tpu_torch/testscenes.py::make_hair_scene at
commit 2bec3df, code unchanged: line strands (capsules) sprouting from a
triangulated sphere over a floor, two point lights, one look-at camera.
``make(scene)`` takes the configuration's ``scene`` object.
"""

from __future__ import annotations

import numpy as np

from rtbench.ref.flat import HostMaterial, HostScene
from rtbench.ref.shapes import (assemble, hair_strands, lookat_camera,
                                point_light_shape, quad_floor, uv_sphere)


def make(scene: dict) -> HostScene:
    """The scene of a configuration's ``scene`` object."""
    return make_hair_scene(scene["n_strands"])


def make_hair_scene(n_strands=256) -> HostScene:
    """The synthesized lines_pointlight stand-in (see module docstring)."""
    interior = uv_sphere("interior", center=(0, 1, 0), rad=0.5, nu=24, nv=12)
    hair = hair_strands("lines", center=(0, 1, 0), rad=0.5,
                        n_strands=n_strands)
    floor = quad_floor("floor", half=6.0, y=0.0)
    l1 = point_light_shape("light1", (2.0, 4.0, 3.0))
    l2 = point_light_shape("light2", (-2.5, 3.5, -1.0))
    shapes = [floor, interior, hair, l1, l2]
    materials = [
        HostMaterial(name="floor", kd=np.full(3, 0.3, np.float32),
                     ks=np.zeros(3, np.float32), rs=0.1),
        HostMaterial(name="interior",
                     kd=np.asarray([0.3, 0.2, 0.1], np.float32),
                     ks=np.full(3, 0.02, np.float32), rs=0.2),
        HostMaterial(name="lines",
                     kd=np.asarray([0.6, 0.4, 0.2], np.float32),
                     ks=np.full(3, 0.08, np.float32), rs=0.15),
        HostMaterial(name="pointlight", ke=np.full(3, 40.0, np.float32),
                     kd=np.zeros(3, np.float32), ks=np.zeros(3, np.float32)),
    ]
    shape_mat = [0, 1, 2, 3, 3]
    cam = lookat_camera("cam", eye=(0.0, 1.8, 3.2), target=(0, 0.9, 0))
    return assemble(shapes, materials, shape_mat, [cam])
