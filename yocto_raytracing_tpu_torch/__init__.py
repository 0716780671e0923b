"""yocto_raytracing_tpu_torch: the PyTorch + CUDA port of yocto_raytracing_tpu.

The JAX package beside it is the reference; this package renders the same
deterministic Whitted frames with the same numerics, on the CPU (plain torch)
or on an NVIDIA Hopper card (hand-written CUDA kernels for the hot loops,
plain torch for the rest).

Layout (module names follow the JAX package):

* ``scene``      host scene model, OBJ loading, flat SoA arrays, ``TorchScene``
* ``testscenes`` procedural scenes (hair, gradient/mirror, random)
* ``ops``        ray-primitive math and the two-level BVH hit query (kernel K1)
* ``render``     camera rays (K2), texture, shading, the depth loop and the
                 per-pixel finish (K3)
* ``kernels``    CUDA sources and their nvcc/ctypes build

Every kernel wrapper runs its plain torch version for CPU tensors and
launches its kernel (or raises) for CUDA tensors.
"""
