"""Command-line renderer: ``python -m yocto_raytracing_tpu_torch.cli``.

Mirrors the reference executable's interface (src/raytrace.cpp:256-287):
``raytrace [options] scenein`` (``.obj``, ``.gltf`` or ``.glb``) with
--resolution/-r (720), --samples/-s (1,
the stratified grid side, spp = s^2), --ambient/-a (0.1 grey),
--output/-o (out.png; .hdr writes float Radiance), plus the JAX package's
knobs: --camera, --max-depth, --chunk-pixels, --sharded (rays sharded over
the ``torch.distributed`` ranks, e.g. under torchrun), --checkpoint
(accumulator snapshot for resume), --intersector, the stochastic modes, and
--device (``cuda``, the card, or ``cpu``).

Under ``--sharded`` every rank saves the frame it holds to ``--output``, as
the JAX CLI does: with more than one rank, that is a partial frame per
rank (the rows other ranks own are zero); nothing gathers them.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="yocto_raytracing_tpu_torch",
        description="Whitted raytracer on PyTorch and CUDA")
    p.add_argument("scenein", help="input scene (.obj, .gltf, .glb)")
    p.add_argument("--resolution", "-r", type=int, default=720,
                   help="vertical resolution (width = aspect * r)")
    p.add_argument("--samples", "-s", type=int, default=1,
                   help="stratified grid side; spp = s^2")
    p.add_argument("--ambient", "-a", type=float, default=0.1,
                   help="grey ambient level")
    p.add_argument("--output", "-o", default="out.png",
                   help="output image (.png tonemapped / .hdr float)")
    p.add_argument("--camera", type=int, default=0, help="camera index")
    p.add_argument("--max-depth", type=int, default=8,
                   help="mirror recursion cap")
    p.add_argument("--chunk-pixels", type=int, default=1 << 15,
                   help="pixels per chunk")
    p.add_argument("--sharded", action="store_true",
                   help="shard rays over the torch.distributed ranks "
                        "(torchrun's environment; one rank without it)")
    p.add_argument("--checkpoint", default="",
                   help="accumulator checkpoint path (resume if it exists)")
    p.add_argument("--intersector", choices=("stream", "bvh"),
                   default="stream",
                   help="the JAX package's hit queries; both give the same "
                        "answers and run the same kernel here")
    p.add_argument("--stochastic", action="store_true",
                   help="jittered AA + thin-lens DOF when the camera has "
                        "aperture > 0")
    p.add_argument("--seed", type=int, default=0,
                   help="RNG seed for the stochastic modes")
    p.add_argument("--area-lights", action="store_true",
                   help="sample emissive shapes by element CDF (soft "
                        "shadows; averages over spp)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the card; fails without one) or cpu")
    return p


def config_from_args(args):
    """Parsed argparse namespace -> the RenderConfig the render consumes."""
    from .utils import RenderConfig

    return RenderConfig(
        resolution=args.resolution, samples=args.samples,
        ambient=args.ambient, output=args.output, camera=args.camera,
        max_depth=args.max_depth, chunk_pixels=args.chunk_pixels,
        sharded=args.sharded, checkpoint=args.checkpoint,
        intersector=args.intersector, stochastic=args.stochastic,
        seed=args.seed, area_lights=args.area_lights, device=args.device)


def run(scenein: str, cfg) -> int:
    """Load + render + save under one config. Raises SceneLoadError.

    The scene is loaded before the first log line, so a load error is the
    first thing on stderr."""
    import torch.distributed as dist

    from . import image as image_mod
    from . import scene as scene_lib
    from .render import renderer
    from .utils import Timer, get_logger, log_phase

    renderer.check_intersector(cfg.intersector)
    t = Timer()
    host = scene_lib.load_scene(scenein)
    log = get_logger()
    log.info("loaded scene %s in %.3fs", scenein, t.stop())

    with log_phase("building bvh + device scene"):
        leaves, meta = scene_lib.build_device_scene(host, camera=cfg.camera)
        scene = scene_lib.to_torch(leaves, cfg.device)
        light_sampler = None
        if cfg.area_lights:
            from .render import lights as lights_mod

            light_sampler = lights_mod.build_light_sampler(
                host, leaves, meta, cfg.device)

    cam = host.cameras[cfg.camera]
    width = renderer.image_width(cam.aspect, cfg.resolution)
    height = cfg.resolution
    spp = cfg.samples * cfg.samples
    log.info("scene: %d instances, %d prims, %d bvh nodes, %d lights",
             meta.num_instances, meta.num_prims, meta.num_nodes,
             meta.num_lights)

    owns_group = cfg.sharded and not dist.is_initialized()
    try:
        with log_phase(f"rendering {width}x{height} @ {spp} spp",
                       rays=width * height * spp):
            if cfg.sharded:
                from . import parallel

                parallel.init_distributed(device=cfg.device)
                mesh = parallel.make_ray_mesh(cfg.device)
                log.info("ray mesh: rank %d of %d, %s", mesh.rank,
                         mesh.world_size,
                         "no group" if mesh.group is None
                         else f"backend {dist.get_backend(mesh.group)}")
                if mesh.world_size > 1:
                    log.info("rank %d of %d renders and saves its rows of "
                             "the frame only (the others are zero), as "
                             "the JAX CLI does", mesh.rank, mesh.world_size)
                img = parallel.render_image_sharded(
                    scene, meta, mesh, width, height, cfg.samples,
                    ambient=cfg.ambient, max_depth=cfg.max_depth,
                    chunk_pixels=cfg.chunk_pixels,
                    stochastic=cfg.stochastic, seed=cfg.seed,
                    light_sampler=light_sampler)
            else:
                img = renderer.render_image(
                    scene, meta, width, height, cfg.samples,
                    ambient=cfg.ambient, max_depth=cfg.max_depth,
                    chunk_pixels=cfg.chunk_pixels,
                    stochastic=cfg.stochastic, seed=cfg.seed,
                    light_sampler=light_sampler,
                    checkpoint=cfg.checkpoint or None)
    finally:
        if owns_group and dist.is_initialized():
            dist.destroy_process_group()

    with log_phase(f"saving image {cfg.output}"):
        image_mod.save_hdr_or_ldr(cfg.output, img)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from .scene import SceneLoadError

    try:
        return run(args.scenein, config_from_args(args))
    except SceneLoadError as e:
        # clean exit, mirroring the reference's printf+exit(1) on load
        # failure (src/scene.cpp:119-122): no traceback for a user error
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
