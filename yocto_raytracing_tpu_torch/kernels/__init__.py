"""Hand-written CUDA kernels of the port (sources in ``csrc/``).

* K1 ``hit.cu``     two-level BVH nearest/any hit  (ops/traverse.py)
* K2 ``camera.cu``  ray id -> uv -> camera ray     (render/camera.py)
* K3 ``pixel.cu``   per-pixel spp sum and tonemap  (render/renderer.py)
* K4 ``shade.cu``   one shading bounce, forward    (render/shade.py)
* K5 ``shade_bwd.cu``  its reverse                 (render/shade.py)
* K6 ``camera.cu``  reverse of the camera rays     (render/camera.py)

Nothing is compiled at import: ``build()`` runs nvcc on first use.
"""

from ._build import BuildInfo, build, launches, reset_launches

__all__ = ["BuildInfo", "build", "launches", "reset_launches"]
