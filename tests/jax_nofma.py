"""JAX reference results computed by jitted JAX that rounds every operation.

Jitted XLA:CPU departs from the operation-by-operation arithmetic of the
JAX source in two ways the reference C++ (SSE2) and the port do not:

* it contracts a*b+c into fma() inside fused computations whenever the host
  has FMA3, and no XLA flag turns that off (``--xla_cpu_enable_fast_math``
  does not); that moves Möller-Trumbore's t by up to hundreds of ULP, and a
  hair-vertex gradient by ~5e-4 relative;
* its algebraic simplifier rewrites ``1 / sqrt(x)`` into ``rsqrt(x)``, a few
  ULP off the quotient (safe_normalize).

``--xla_cpu_max_isa=AVX`` (no FMA3) and ``--xla_disable_hlo_passes=algsimp``
remove both, and the jitted walk then agrees bit for bit with the same
functions run op by op (``jax.disable_jit``, far too slow for a BVH walk).
XLA reads its flags once per process, when the CPU backend starts, so the
reference runs in a child process: the test process's backend is shared with
the other tests and keeps its flags.

Usage from a test:

* ``hits("make_random_scene", {"seed": 0}, rays)``: ``jax
  traverse.intersect_scene``'s dict as numpy arrays; the child rebuilds the
  scene with the JAX package's own ``testscenes``;
* ``grads(leaves, ids, weights, amb, width=, height=, samples=,
  max_depth=, stochastic=, seed=, sampler=)``: ``jax.grad`` of
  ``sum(trace_rays(..., differentiable=True) * weights)`` with respect to
  every float leaf, ``{name: array}``, optionally with the stochastic
  modes;
* ``loss_grads(leaves, ids, target, amb, width=, height=, samples=,
  max_depth=)``: ``jax.value_and_grad`` of the JAX ``mesh.render_loss``,
  ``{name: gradient}`` per float leaf plus ``"loss"``;
* ``train_step(leaves, ids, target, amb, lr, width=, ..., trainable=)``: the
  JAX ``mesh.train_step``: ``{name: new leaf}`` plus ``"loss"``;
* ``radiance(leaves, ids, amb, width=, ..., stochastic=, seed=,
  sampler=)``: ``renderer.trace_rays`` (forward) with the stochastic modes,
  ``sampler`` the light tables of ``lights.build_light_sampler`` as numpy
  arrays; ``{"rgb": (N, 3)}``;
* ``overlap("make_random_scene", {"seed": 0}, queries, dist_max)``: the
  dict of ``ops.overlap.overlap_scene`` (jitted) as numpy arrays, for the
  scene ``testscenes.<scene_fn>(**scene_kwargs)``.

``leaves`` is ``{field name: numpy array}`` of a ``DeviceScene`` (equal to
the port's ``build_device_scene`` output).
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


def _run(job: str, arrays: dict, spec: dict, timeout: float) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        np.savez(os.path.join(tmp, "in.npz"), **arrays)
        env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=XLA_FLAGS,
                   PYTHONPATH=os.pathsep.join(
                       [REPO] + [p for p in [os.environ.get("PYTHONPATH")]
                                 if p]))
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               job, json.dumps(spec), tmp], env=env,
                              capture_output=True, text=True,
                              timeout=timeout)
        if proc.returncode != 0:
            raise RuntimeError(f"JAX reference failed:\n{proc.stderr}")
        with np.load(os.path.join(tmp, "out.npz")) as out:
            return {k: out[k] for k in out.files}


def hits(scene_fn: str, scene_kwargs: dict, rays, any_hit: bool = False,
         timeout: float = 600.0) -> dict:
    """``traverse.intersect_scene`` of the JAX package on ``rays`` =
    (ro, rd, tmin, tmax) numpy arrays, for the scene
    ``testscenes.<scene_fn>(**scene_kwargs)``."""
    ro, rd, tmin, tmax = rays
    return _run("hits", dict(ro=ro, rd=rd, tmin=tmin, tmax=tmax),
                dict(scene_fn=scene_fn, kwargs=scene_kwargs,
                     any_hit=any_hit), timeout)


def _scene_arrays(leaves: dict) -> dict:
    return {"leaf_" + k: np.asarray(v) for k, v in leaves.items()}


def _sampler_arrays(sampler) -> dict:
    return {} if sampler is None else {"sampler_" + k: np.asarray(v)
                                       for k, v in sampler.items()}


def grads(leaves: dict, ids, weights, amb, *, width: int, height: int,
          samples: int, max_depth: int, stochastic: bool = False,
          seed: int = 0, sampler: dict | None = None,
          timeout: float = 600.0) -> dict:
    """``jax.grad`` of the weighted radiance sum, per float leaf; with
    ``stochastic``, ``seed`` and the light tables ``sampler`` as in
    ``radiance``."""
    return _run("grads", dict(_scene_arrays(leaves), ids=ids,
                              weights=weights, amb=amb,
                              **_sampler_arrays(sampler)),
                dict(width=width, height=height, samples=samples,
                     max_depth=max_depth, stochastic=stochastic, seed=seed),
                timeout)


def loss_grads(leaves: dict, ids, target, amb, *, width: int, height: int,
               samples: int, max_depth: int, timeout: float = 600.0) -> dict:
    """``jax.value_and_grad`` of the JAX ``mesh.render_loss`` (the MSE of
    the differentiable radiance against ``target``), jitted, per float
    leaf; the loss under ``"loss"``."""
    return _run("loss_grads", dict(_scene_arrays(leaves), ids=ids,
                                   target=target, amb=amb),
                dict(width=width, height=height, samples=samples,
                     max_depth=max_depth), timeout)


def train_step(leaves: dict, ids, target, amb, lr: float, *, width: int,
               height: int, samples: int, max_depth: int, trainable=None,
               timeout: float = 600.0) -> dict:
    """The JAX ``mesh.train_step``: new leaves by name, and ``"loss"``."""
    return _run("train_step", dict(_scene_arrays(leaves), ids=ids,
                                   target=target, amb=amb),
                dict(lr=lr, width=width, height=height, samples=samples,
                     max_depth=max_depth,
                     trainable=None if trainable is None
                     else sorted(trainable)), timeout)


def radiance(leaves: dict, ids, amb, *, width: int, height: int,
             samples: int, max_depth: int, stochastic: bool, seed: int,
             sampler: dict | None = None, timeout: float = 600.0) -> dict:
    """Forward ``trace_rays`` radiance (N, 3) of the JAX package."""
    return _run("radiance", dict(_scene_arrays(leaves), ids=ids, amb=amb,
                                 **_sampler_arrays(sampler)),
                dict(width=width, height=height, samples=samples,
                     max_depth=max_depth, stochastic=stochastic, seed=seed),
                timeout)


def overlap(scene_fn: str, scene_kwargs: dict, queries, dist_max,
            timeout: float = 600.0) -> dict:
    """``ops.overlap.overlap_scene`` of the JAX package for ``queries``
    (Q, 3) and ``dist_max`` (a scalar or (Q,)), on the scene
    ``testscenes.<scene_fn>(**scene_kwargs)``."""
    dist_max = np.broadcast_to(np.asarray(dist_max, np.float32),
                               (len(queries),))
    return _run("overlap", dict(queries=queries, dist_max=dist_max),
                dict(scene_fn=scene_fn, kwargs=scene_kwargs), timeout)


def _main(job: str, spec: str, tmp: str) -> None:
    import dataclasses

    import jax
    import jax.numpy as jnp

    from yocto_raytracing_tpu import scene as scene_lib, testscenes
    from yocto_raytracing_tpu.ops import overlap as overlap_mod
    from yocto_raytracing_tpu.ops import traverse
    from yocto_raytracing_tpu.parallel import mesh
    from yocto_raytracing_tpu.render import renderer

    jax.config.update("jax_platforms", "cpu")
    cfg = json.loads(spec)
    with np.load(os.path.join(tmp, "in.npz")) as f:
        inp = {k: f[k] for k in f.files}
    if job == "hits":
        host = getattr(testscenes, cfg["scene_fn"])(**cfg["kwargs"])
        dev, _ = scene_lib.build_device_scene(host)
        rays = [jnp.asarray(inp[k]) for k in ("ro", "rd", "tmin", "tmax")]
        out = traverse.intersect_scene(scene_lib.to_jax(dev), *rays,
                                       any_hit=cfg["any_hit"])
        out = {k: np.asarray(v) for k, v in out.items()}
    elif job == "overlap":
        host = getattr(testscenes, cfg["scene_fn"])(**cfg["kwargs"])
        dev, meta = scene_lib.build_device_scene(host)
        out = overlap_mod.overlap_scene(
            scene_lib.to_jax(dev), meta, jnp.asarray(inp["queries"]),
            jnp.asarray(inp["dist_max"]))
        out = {k: np.asarray(v) for k, v in out.items()}
    else:
        dev = scene_lib.DeviceScene(**{
            k[5:]: jnp.asarray(v) for k, v in inp.items()
            if k.startswith("leaf_")})
        names = [fld.name for fld in dataclasses.fields(dev)]
        kw = dict(width=cfg["width"], height=cfg["height"],
                  samples=cfg["samples"], max_depth=cfg["max_depth"],
                  max_stack=64)
        ids = jnp.asarray(inp["ids"])
        amb = jnp.asarray(inp["amb"])
        if "stochastic" in cfg:   # radiance and grads
            kw.update(stochastic=cfg["stochastic"],
                      rng_key=jnp.uint32(cfg["seed"]),
                      light_sampler={k[8:]: jnp.asarray(v)
                                     for k, v in inp.items()
                                     if k.startswith("sampler_")} or None)
        if job == "radiance":
            rgb = renderer.trace_rays(dev, ids, amb, **kw)
            out = {"rgb": np.asarray(rgb)}
        elif job == "grads":
            diff, static, treedef = mesh.partition_scene(dev)

            def f(d):
                rgb = renderer.trace_rays(
                    mesh.combine_scene(d, static, treedef), ids, amb,
                    differentiable=True, **kw)
                return jnp.sum(rgb * inp["weights"])

            g = jax.grad(f)(diff)
            out = {k: np.asarray(v) for k, v in zip(names, g)
                   if v is not None}
        elif job == "loss_grads":
            diff, static, treedef = mesh.partition_scene(dev)
            target = jnp.asarray(inp["target"])

            @jax.jit
            def f(d):
                return mesh.render_loss(
                    mesh.combine_scene(d, static, treedef), ids, target, amb,
                    **kw)

            loss, g = jax.value_and_grad(f)(diff)
            out = {k: np.asarray(v) for k, v in zip(names, g)
                   if v is not None}
            out["loss"] = np.asarray(loss)
        else:
            tr = cfg["trainable"]
            new, loss = mesh.train_step(
                dev, ids, jnp.asarray(inp["target"]), amb, cfg["lr"],
                trainable=None if tr is None else tuple(tr), **kw)
            out = {k: np.asarray(getattr(new, k)) for k in names}
            out["loss"] = np.asarray(loss)
    np.savez(os.path.join(tmp, "out.npz"), **out)


if __name__ == "__main__":
    _main(sys.argv[1], sys.argv[2], sys.argv[3])
