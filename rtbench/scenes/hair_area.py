"""Scene generator ``hair_area``: the lines_pointlight stand-in with area
lights and a thin-lens camera.

``lines.frame``'s hair scene (``hair.make_hair_scene``) with light1 an
emissive 1 m quad at (2, 4, 3) facing down, light2 an emissive 4-segment
polyline around (-2.5, 3.5, -1) (ke stays 40), and the camera's aperture
0.1 at its focus, the distance to the target: the changes of the
repository's ``chip_smoke.py::area_hair_scene(cells=1)`` at commit ad7840c,
its ``quad``, ``set_geometry`` and ``light_shape`` copied here unchanged.
The two light shapes then get what the port's ``scene.finalize_scene``
gives a shape without them: the default line radius and smooth normals.
``make(scene)`` takes the configuration's ``scene`` object.
"""

from __future__ import annotations

import numpy as np

from rtbench.ref.flat import (DEFAULT_POINTLINE_RADIUS, HostScene,
                              compute_smooth_normals)
from rtbench.scenes.hair import make_hair_scene

APERTURE = 0.1


def make(scene: dict) -> HostScene:
    """The scene of a configuration's ``scene`` object."""
    return make_area_hair_scene(scene["n_strands"])


def set_geometry(shp, pos, lines=(), triangles=()):
    """Give a host shape new vertices and elements (no points); normals,
    texcoords and radii as a loader would leave them."""
    shp.pos = np.asarray(pos, np.float32)
    shp.points = np.zeros(0, np.int32)
    shp.lines = np.asarray(lines, np.int32).reshape(-1, 2)
    shp.triangles = np.asarray(triangles, np.int32).reshape(-1, 3)
    shp.norm = np.zeros((0, 3), np.float32)
    shp.texcoord = np.zeros((len(shp.pos), 2), np.float32)
    shp.radius = np.zeros(0, np.float32)


def light_shape(host, name):
    ist = next(i for i in host.instances if i.name == name)
    return host.shapes[ist.shape]


def quad(center):
    """A 1 m square around ``center`` in its horizontal plane, two
    triangles facing down."""
    c = np.asarray(center, np.float32)
    return ([c + d for d in ([-0.5, 0, -0.5], [0.5, 0, -0.5],
                             [0.5, 0, 0.5], [-0.5, 0, 0.5])],
            [[0, 1, 2], [0, 2, 3]])


def _finalize(shp):
    """A loaded shape's defaults (the port's ``scene.finalize_scene``):
    line radius 0.001, no radius for triangles, smooth normals."""
    if len(shp.lines) and len(shp.radius) == 0:
        shp.radius = np.full(len(shp.pos), DEFAULT_POINTLINE_RADIUS,
                             np.float32)
    elif len(shp.radius) == 0:
        shp.radius = np.zeros(len(shp.pos), np.float32)
    if len(shp.norm) == 0:
        shp.norm = compute_smooth_normals(shp)


def make_area_hair_scene(n_strands=256) -> HostScene:
    """The area-light hair scene (see module docstring)."""
    host = make_hair_scene(n_strands)
    pos, tris = quad((2.0, 4.0, 3.0))
    set_geometry(light_shape(host, "light1"), pos, triangles=tris)
    c = np.asarray([-2.5, 3.5, -1.0], np.float32)
    set_geometry(light_shape(host, "light2"),
                 [c + [dx, 0.1 * dx * dx, 0.3 * dx]
                  for dx in (-0.8, -0.3, 0.0, 0.4, 0.9)],
                 lines=[[0, 1], [1, 2], [2, 3], [3, 4]])
    for name in ("light1", "light2"):
        _finalize(light_shape(host, name))
    host.cameras[0].aperture = APERTURE
    return host
