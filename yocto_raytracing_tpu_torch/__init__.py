"""yocto_raytracing_tpu_torch: the PyTorch + CUDA port of yocto_raytracing_tpu.

The JAX package beside it is the reference; this package renders the same
Whitted frames (deterministic, or with jittered AA, thin-lens DOF and area
lights) and trains the same scene parameters with the same numerics, on the
CPU (plain torch) or on an NVIDIA Hopper card (hand-written CUDA kernels for
the hot loops, plain torch for the rest). It imports nothing of the JAX
package.

Layout (module names follow the JAX package):

* ``scene``      host scene model, OBJ and glTF/GLB loading and saving, the
                 tangent space, flat SoA arrays, ``TorchScene``
* ``bvh``, ``native``, ``image``, ``io``, ``geometry``, ``animation``,
  ``procedural``
                 copies of the JAX package's numpy host modules (BVH builder
                 with its g++ fast path, tonemap and image files, OBJ/HDR,
                 glTF with animation, skins and morphs, mesh tools,
                 keyframes, test images)
* ``testscenes`` procedural scenes (hair, gradient/mirror, random)
* ``ops``        ray-primitive math, the two-level BVH hit query (kernel K1)
                 and the Monte-Carlo samplers
* ``render``     camera rays (K2, stochastic K7), area lights (K8), texture,
                 shading (K4/K5), the depth loop and the per-pixel finish (K3)
* ``parallel``   ray-sharded rendering and training over torch.distributed
                 ranks (NCCL on the card, gloo on the CPU), and the one-device
                 training step
* ``kernels``    CUDA sources and their nvcc/ctypes build
* ``cli``, ``utils``
                 the command-line renderer (``python -m
                 yocto_raytracing_tpu_torch.cli``), its config and phase log

Every kernel wrapper runs its plain torch version for CPU tensors and
launches its kernel (or raises) for CUDA tensors.
"""
