"""Hand-written CUDA kernels of the port (sources in ``csrc/``).

* K1 ``hit.cu``     two-level BVH nearest/any hit on packed records
                                                   (ops/traverse.py,
                                                   ops/hit_records.py)
* K2 ``camera.cu``  ray id -> uv -> camera ray     (render/camera.py)
* K3 ``pixel.cu``   per-pixel spp sum and tonemap  (render/renderer.py)
* K4 ``shade.cu``   one shading bounce, forward    (render/shade.py,
                                                   ops/shade_records.py)
* K5 ``shade_bwd.cu``  its reverse                 (render/shade.py)
* K6 ``camera.cu``  reverse of the camera rays     (render/camera.py)
* K7 ``stochastic.cu``  ray id -> jittered uv -> thin-lens ray
                                                   (render/camera.py)
* K8 ``lights.cu``  area-light sample points       (render/lights.py)
* K9 ``stochastic.cu``  reverse of the thin-lens rays  (render/camera.py)
* K10 ``lights.cu`` reverse of the light points    (render/lights.py)
* K11 ``overlap.cu``  closest element within a distance, per query point
                                                   (ops/overlap.py)
* K12 ``bounce.cu`` the depth loop's state update and alive word
                                                   (render/renderer.py)
* K13 ``records.cu`` K1's and K4's records packed in place, a thread
                     a 16-byte quad                (ops/records.py)
* K14 ``bounce.cu`` the reverse of K12, in the training step's device loop
                                                   (render/renderer.py)

``host/yrt_native.cpp`` is the host-side OBJ parser and BVH builder (g++,
``native.py``). Nothing is compiled at import: ``build()`` runs nvcc on
first use.
"""

from ._build import (BuildInfo, build, last_frame, last_step, launches,
                     made_launches, reset_launches, skipped_launches)

__all__ = ["BuildInfo", "build", "last_frame", "last_step", "launches",
           "made_launches", "reset_launches", "skipped_launches"]
