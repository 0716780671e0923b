"""JAX reference hits computed by jitted JAX that rounds every operation.

Jitted XLA:CPU departs from the operation-by-operation arithmetic of the
JAX source in two ways the reference C++ (SSE2) and the port do not:

* it contracts a*b+c into fma() inside fused computations whenever the host
  has FMA3, and no XLA flag turns that off (``--xla_cpu_enable_fast_math``
  does not); that moves Möller-Trumbore's t by up to hundreds of ULP;
* its algebraic simplifier rewrites ``1 / sqrt(x)`` into ``rsqrt(x)``, a few
  ULP off the quotient (safe_normalize).

``--xla_cpu_max_isa=AVX`` (no FMA3) and ``--xla_disable_hlo_passes=algsimp``
remove both, and the jitted walk then agrees bit for bit with the same
functions run op by op (``jax.disable_jit``, far too slow for a BVH walk).
XLA reads its flags once per process, when the CPU backend starts, so the
reference runs in a child process: the test process's backend is shared with
the other tests and keeps its flags.

Usage from a test: ``hits("make_random_scene", {"seed": 0}, rays)`` returns
``jax traverse.intersect_scene``'s dict as numpy arrays. The child rebuilds
the scene with the JAX package's own ``testscenes``.
"""

import json
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
XLA_FLAGS = ("--xla_cpu_enable_fast_math=false --xla_cpu_max_isa=AVX "
             "--xla_disable_hlo_passes=algsimp "
             "--xla_force_host_platform_device_count=1")


def hits(scene_fn: str, scene_kwargs: dict, rays, any_hit: bool = False,
         timeout: float = 600.0) -> dict:
    """``traverse.intersect_scene`` of the JAX package on ``rays`` =
    (ro, rd, tmin, tmax) numpy arrays, for the scene
    ``testscenes.<scene_fn>(**scene_kwargs)``."""
    with tempfile.TemporaryDirectory() as tmp:
        ro, rd, tmin, tmax = rays
        np.savez(os.path.join(tmp, "in.npz"), ro=ro, rd=rd, tmin=tmin,
                 tmax=tmax)
        spec = json.dumps(dict(scene_fn=scene_fn, kwargs=scene_kwargs,
                               any_hit=any_hit))
        env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=XLA_FLAGS,
                   PYTHONPATH=os.pathsep.join(
                       [REPO] + [p for p in [os.environ.get("PYTHONPATH")]
                                 if p]))
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               spec, tmp], env=env, capture_output=True,
                              text=True, timeout=timeout)
        if proc.returncode != 0:
            raise RuntimeError(f"JAX reference failed:\n{proc.stderr}")
        with np.load(os.path.join(tmp, "out.npz")) as out:
            return {k: out[k] for k in out.files}


def _main(spec: str, tmp: str) -> None:
    import jax
    import jax.numpy as jnp

    from yocto_raytracing_tpu import scene as scene_lib, testscenes
    from yocto_raytracing_tpu.ops import traverse

    jax.config.update("jax_platforms", "cpu")
    cfg = json.loads(spec)
    host = getattr(testscenes, cfg["scene_fn"])(**cfg["kwargs"])
    dev, _ = scene_lib.build_device_scene(host)
    with np.load(os.path.join(tmp, "in.npz")) as f:
        rays = [jnp.asarray(f[k]) for k in ("ro", "rd", "tmin", "tmax")]
    out = traverse.intersect_scene(scene_lib.to_jax(dev), *rays,
                                   any_hit=cfg["any_hit"])
    np.savez(os.path.join(tmp, "out.npz"),
             **{k: np.asarray(v) for k, v in out.items()})


if __name__ == "__main__":
    _main(sys.argv[1], sys.argv[2])
