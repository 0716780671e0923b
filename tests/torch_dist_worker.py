"""One rank of the port's ray-sharded tests (tests/test_torch_sharding.py).

    python tests/torch_dist_worker.py <init method> <world size> <rank> <dir>

Joins a gloo group on the CPU through ``parallel.init_distributed``, reads
``<dir>/in.npz`` (the training batches, written by the test), and runs:

* ``render_image_sharded`` of the grad scene (16x16, 2x2 samples, depth 3),
  whole and in chunks of 24 pixels, and of its area-light variant with
  ``stochastic=True, seed=7``;
* ``loss_and_grads_sharded`` and ``train_step_sharded`` (8x8, 1 spp, depth
  3), every float leaf trainable, on the batch ``ids``/``target`` and on
  the batch ``dark_ids``/``dark_target``, whose second half reaches no
  geometry;
* ``loss_and_grads_sharded`` on ``ids`` with rank 1 taking the step
  through autograd (``mesh._loss_and_grads_autograd``) with ``mat_kd`` out of
  its graph, so that its autograd returns None there (zeros), and rank 0
  the device loop's tensor.

Every ``torch.distributed`` collective is counted per job. Writes
``<dir>/rank<r>.npz``; imports no JAX.
"""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from yocto_raytracing_tpu_torch import scene as scene_lib  # noqa: E402
from yocto_raytracing_tpu_torch import testscenes  # noqa: E402
from yocto_raytracing_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402
from yocto_raytracing_tpu_torch.render import lights  # noqa: E402

FRAME = dict(width=16, height=16, samples=2, max_depth=3)
TRAIN = dict(width=8, height=8, samples=1, max_depth=3)
LR = 0.05
AMB = 0.1
SEED = 7
GRAD_TRAINABLE = ("mat_kd", "light_ke", "cam_o")
COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor",
               "all_gather_object", "all_to_all", "all_to_all_single",
               "broadcast", "broadcast_object_list", "reduce",
               "reduce_scatter", "reduce_scatter_tensor", "gather",
               "scatter", "barrier", "send", "recv", "isend", "irecv")


def area_scene():
    """The grad scene with its point light replaced by an emissive triangle
    around the same point (tests/test_torch_lights.py::occluded_scene)."""
    host = testscenes.make_grad_scene()
    ist = next(i for i in host.instances if i.name == "light")
    shp = host.shapes[ist.shape]
    c = shp.pos[0].copy()
    shp.pos = np.asarray([c + [-0.6, 0, -0.6], c + [0.6, 0, -0.6],
                          c + [0.0, 0, 0.9]], np.float32)
    shp.points = np.zeros(0, np.int32)
    shp.lines = np.zeros((0, 2), np.int32)
    shp.triangles = np.asarray([[0, 1, 2]], np.int32)
    shp.norm = np.zeros((0, 3), np.float32)
    shp.texcoord = np.zeros((3, 2), np.float32)
    shp.radius = np.zeros(0, np.float32)
    scene_lib.finalize_scene(host)
    return host


class CountCollectives:
    """Counts every call of a ``torch.distributed`` collective while
    active; ``sizes`` lists the element counts of the all_reduce calls,
    ``ops`` their reduce ops."""

    def __init__(self):
        self.calls = {}
        self.sizes = []
        self.ops = []
        self._saved = {}

    def __enter__(self):
        for name in COLLECTIVES:
            fn = getattr(dist, name, None)
            if fn is None:
                continue
            self._saved[name] = fn

            def counted(*args, _name=name, _fn=fn, **kwargs):
                self.calls[_name] = self.calls.get(_name, 0) + 1
                if _name == "all_reduce":
                    self.sizes.append(args[0].numel())
                    self.ops.append(str(kwargs.get("op",
                                                   dist.ReduceOp.SUM)))
                return _fn(*args, **kwargs)

            setattr(dist, name, counted)
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(dist, name, fn)


def leaves_of(scene, prefix):
    return {prefix + k: getattr(scene, k).numpy()
            for k in scene_lib.LEAF_NAMES}


def main(init_method, world_size, rank, tmp):
    torch.set_num_threads(1)
    got = mesh_mod.init_distributed(init_method, world_size, rank,
                                    device="cpu")
    assert got == rank and dist.get_backend() == "gloo"
    mesh = mesh_mod.make_ray_mesh("cpu")
    assert (mesh.world_size, mesh.rank) == (world_size, rank)
    out = {}
    counts = {}
    with np.load(os.path.join(tmp, "in.npz")) as f:
        inp = {k: f[k] for k in f.files}

    leaves, meta = scene_lib.build_device_scene(testscenes.make_grad_scene())
    scene = scene_lib.to_torch(leaves, "cpu")
    host = area_scene()
    aleaves, ameta = scene_lib.build_device_scene(host)
    ascene = scene_lib.to_torch(aleaves, "cpu")
    sampler = lights.build_light_sampler(host, aleaves, ameta, "cpu")

    with CountCollectives() as c:
        out["frame"] = mesh_mod.render_image_sharded(scene, meta, mesh,
                                                     **FRAME)
        out["frame_chunked"] = mesh_mod.render_image_sharded(
            scene, meta, mesh, chunk_pixels=24, **FRAME)
        out["frame_stochastic"] = mesh_mod.render_image_sharded(
            ascene, ameta, mesh, stochastic=True, seed=SEED,
            light_sampler=sampler, **FRAME)
    counts["render"] = c

    amb = torch.full((3,), AMB)
    for job, ids, target in (("train", inp["ids"], inp["target"]),
                             ("dark", inp["dark_ids"], inp["dark_target"])):
        local_ids = mesh_mod.shard_rays(ids, mesh)
        local_target = mesh_mod.shard_rays(target, mesh)
        with CountCollectives() as c:
            new, loss = mesh_mod.train_step_sharded(
                scene, local_ids, local_target, amb, LR, mesh=mesh,
                **TRAIN)
        counts[job] = c
        out[f"{job}_loss"] = loss.numpy()
        out.update(leaves_of(new, f"{job}_new_"))
        with CountCollectives() as c:
            loss, grads, (diff, static) = mesh_mod.loss_and_grads_sharded(
                scene, local_ids, local_target, amb, mesh=mesh,
                trainable=GRAD_TRAINABLE, **TRAIN)
        counts[f"{job}_grads"] = c
        out[f"{job}_grads_loss"] = loss.numpy()
        for name, g, d, s in zip(scene_lib.LEAF_NAMES, grads, diff, static):
            assert (g is None) == (d is None) and (d is None) != (s is None)
            if g is not None:
                out[f"{job}_grad_{name}"] = g.numpy()

    # rank 1's rays never reach mat_kd: it takes the autograd step, whose
    # autograd gives None there; rank 0 the device loop
    ids = mesh_mod.shard_rays(inp["ids"], mesh)
    target = mesh_mod.shard_rays(inp["target"], mesh)
    render_loss = mesh_mod.render_loss
    loss_and_grads = mesh_mod._loss_and_grads

    def cut_loss(sc, *args, **kwargs):
        sc = mesh_mod.combine_scene(
            [getattr(sc, k).detach() if k == "mat_kd"
             else getattr(sc, k) for k in scene_lib.LEAF_NAMES],
            [None] * len(scene_lib.LEAF_NAMES))
        return render_loss(sc, *args, **kwargs)

    def autograd_on_rank_1(sc, ids, target, amb, kw, trainable):
        if rank != 1:
            return loss_and_grads(sc, ids, target, amb, kw, trainable)
        diff, static = mesh_mod.partition_scene(sc, trainable)
        return mesh_mod._loss_and_grads_autograd(diff, static, ids, target,
                                                 amb, kw)

    mesh_mod.render_loss = cut_loss
    mesh_mod._loss_and_grads = autograd_on_rank_1
    try:
        with CountCollectives() as c:
            _, grads, _ = mesh_mod.loss_and_grads_sharded(
                scene, ids, target, amb, mesh=mesh,
                trainable=("mat_kd", "light_ke"), **TRAIN)
    finally:
        mesh_mod.render_loss = render_loss
        mesh_mod._loss_and_grads = loss_and_grads
    counts["unreached"] = c
    out["unreached_mat_kd"] = grads[scene_lib.LEAF_NAMES.index(
        "mat_kd")].numpy()

    for job, c in counts.items():
        out[f"calls_{job}"] = np.asarray(
            [f"{k}={v}" for k, v in sorted(c.calls.items())], dtype=str)
        out[f"sizes_{job}"] = np.asarray(c.sizes, np.int64)
        out[f"ops_{job}"] = np.asarray(c.ops, dtype=str)
    dist.destroy_process_group()
    np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
