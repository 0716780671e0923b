"""Ray-sharded rendering and differentiable training over ranks.

Port of ``yocto_raytracing_tpu/parallel/mesh.py``. The scene (the
renderer's parameters) is replicated: every rank holds it whole. The flat
ray ids are sharded: rank r owns the contiguous slab
``[r*n/ws, (r+1)*n/ws)`` of each batch, the index of JAX's
``NamedSharding(P("rays"))``. Each rank traces its slab through the
one-device path (``trace_rays``: kernels K1-K10 on the card, their plain
versions on the CPU) as an independent program, so a forward render issues
no collective. A training step issues exactly one ``dist.all_reduce`` (sum)
for the loss and one per trainable leaf, in ``LEAF_NAMES`` order, each
scaled by ``1/ws`` afterwards: the JAX ``psum`` of equal-shard means over
the mesh. Ranks are ``torch.distributed`` processes (NCCL on the card, gloo
on the CPU); a process with no group is a world of one.

The one-device training step (JAX ``mesh.py:219-291``: ``partition_scene``,
``combine_scene``, ``render_loss``, ``train_step``) lives here too. Gradients
flow to every float leaf through the detached-traversal renderer; integer
topology (BVH nodes, prim ids, texture ids) and the packed texels are
static. ``train_step`` and the sharded step's per-rank loss and gradients
run the depth loop and its reverse as a device loop
(``renderer.loss_grads_device``: on CUDA one CUDA graph kept across calls,
the all_reduce outside it); ``render_loss`` keeps the eager loop under
autograd (``trace_rays(..., differentiable=True)``), and
``_train_step_autograd`` is the step's first form on it. The port always
saves the hits and recomputes shading in the backward, which is the JAX
package's ``remat=True``; the TPU-only keywords (``stream``, ``max_stack``,
``block_unroll``, ``remat``, ``axis_name``) have no counterpart.

Weights carry across from the JAX package as before:
``scene.from_jax_arrays`` turns its leaves, as numpy arrays, into the
``TorchScene`` that these functions take.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..render import renderer as renderer_mod
from ..scene import LEAF_NAMES, TorchScene
from ..utils import tracer

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def init_distributed(init_method: str | None = None,
                     world_size: int | None = None,
                     rank: int | None = None, *, device="cuda") -> int:
    """Start this process's ``torch.distributed`` group; returns its rank.

    Explicit arguments win; after them come torchrun's variables
    (``MASTER_ADDR`` and ``MASTER_PORT`` give ``init_method="env://"``,
    ``WORLD_SIZE``, ``RANK``), where the JAX function reads
    ``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES`` and
    ``JAX_PROCESS_ID``. With neither an init method nor a world size the
    call is a no-op that returns 0 and starts no group (one process), and
    it is a no-op that returns the rank once a group exists. A missing
    world size or rank is left to the init method (torch's -1).

    The backend follows ``device``: NCCL for "cuda", gloo for "cpu"; a
    backend that this torch lacks raises, there is no switch to another.
    On CUDA the process takes ``cuda:LOCAL_RANK`` (0 when unset) as its
    current device. JAX's TPU-pod auto-detection (``TPU_WORKER_HOSTNAMES``)
    has no torch counterpart and is dropped.
    """
    if dist.is_initialized():
        return dist.get_rank()
    if init_method is None and os.environ.get("MASTER_ADDR") \
            and os.environ.get("MASTER_PORT"):
        init_method = "env://"
    if world_size is None and os.environ.get("WORLD_SIZE"):
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None and os.environ.get("RANK"):
        rank = int(os.environ["RANK"])
    if init_method is None and world_size is None:
        return 0
    kind = torch.device(device).type
    if kind not in BACKENDS:
        raise ValueError(f"no distributed backend for device {device!r}")
    backend = BACKENDS[kind]
    available = (dist.is_nccl_available() if backend == "nccl"
                 else dist.is_gloo_available())
    if not available:
        raise RuntimeError(f"torch.distributed has no {backend} backend "
                           f"here (device {device!r})")
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is "
                               f"not available")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(
        backend, init_method=init_method,
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank)
    return dist.get_rank()


@dataclass(frozen=True)
class RayMesh:
    """The ray axis: this process's place in it and the group that joins
    the ranks (None in a world of one without a group)."""

    world_size: int
    rank: int
    device: torch.device
    group: object = None


def make_ray_mesh(device="cuda") -> RayMesh:
    """The 1-D ray mesh over every rank of the default group (world size 1
    without one). On CUDA, ``device`` becomes the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        return RayMesh(1, 0, device)
    return RayMesh(dist.get_world_size(), dist.get_rank(), device,
                   dist.group.WORLD)


def replicate_scene(scene, mesh: RayMesh):
    """A ``TorchScene`` (or a dict of tensors, such as a light sampler) on
    the mesh's device. Every rank builds the same scene from the same file,
    so nothing is broadcast, as JAX's ``device_put`` broadcasts nothing
    across hosts."""
    if isinstance(scene, TorchScene):
        return TorchScene(*(getattr(scene, n).to(mesh.device)
                            for n in LEAF_NAMES))
    return {k: v.to(mesh.device) for k, v in scene.items()}


def shard_rays(ray_ids, mesh: RayMesh) -> torch.Tensor:
    """This rank's contiguous slab ``[rank*n/ws, (rank+1)*n/ws)`` of a
    flat batch (ray ids, or any array whose rows follow them, such as a
    training target), on the mesh's device; raises where the world size
    does not divide the batch. The ids keep their global values."""
    n = len(ray_ids)
    if n % mesh.world_size:
        raise ValueError(f"{n} rays do not split over {mesh.world_size} "
                         f"ranks")
    per = n // mesh.world_size
    part = ray_ids[mesh.rank * per:(mesh.rank + 1) * per]
    return torch.as_tensor(part).to(mesh.device)


def _pad_to(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


def trace_rays_sharded(scene: TorchScene, meta, mesh: RayMesh, ray_ids,
                       ambient, *, width: int, height: int, samples: int,
                       max_depth: int, stochastic: bool = False,
                       seed: int = 0, light_sampler=None):
    """Radiance (n, 3) of this rank's slab ``ray_ids`` (from
    ``shard_rays``): one ``trace_rays`` call, no collective.

    The stochastic variates (jittered AA, thin-lens DOF, area-light
    samples) are keyed by the global ray id, so the slab must hold global
    ids: the sharded frame is then the one-device frame bit for bit,
    whatever the layout.
    """
    del mesh   # the slab already lives on this rank's device
    return renderer_mod.trace_rays(
        scene, ray_ids, ambient, width, height, samples, max_depth,
        has_kd_textures=meta.has_kd_textures,
        has_ks_textures=meta.has_ks_textures, stochastic=stochastic,
        seed=seed, light_sampler=light_sampler)


def render_image_sharded(scene: TorchScene, meta, mesh: RayMesh,
                         width: int, height: int, samples: int,
                         ambient: float = 0.1, max_depth: int = 8,
                         chunk_pixels: int | None = None,
                         stochastic: bool = False, seed: int = 0,
                         light_sampler=None) -> np.ndarray:
    """Full frame with the rays of each chunk sharded over the ranks ->
    (height, width, 4) f32 linear, alpha 1.

    JAX's chunking: chunks of ``chunk_pixels * spp`` rays (the whole frame
    without it) padded to a multiple of the world size, tail ids clamped
    to the last ray. Each rank fills its own slab of every chunk; rows that
    other ranks own stay zero (JAX's per-process ``addressable_shards``),
    so the ranks' frames sum to the whole one and no gather is issued. In
    a world of one every row is this rank's. The spp sum runs on the host
    in numpy, as in JAX; it adds the samples in order, as K3 does, so the
    frame equals ``render_image``'s.
    """
    spp = samples * samples
    npix = width * height
    nray = npix * spp
    ndev = mesh.world_size
    amb = torch.full((3,), ambient, dtype=torch.float32, device=mesh.device)
    scene = replicate_scene(scene, mesh)
    if light_sampler is not None:
        light_sampler = replicate_scene(light_sampler, mesh)
    if chunk_pixels is None:
        chunk_rays = _pad_to(nray, ndev)
    else:
        chunk_rays = _pad_to(min(chunk_pixels * spp, nray), ndev)
    per = chunk_rays // ndev
    nchunks = -(-nray // chunk_rays)
    out = np.zeros((nchunks * chunk_rays, 3), np.float32)
    for start in range(0, nray, chunk_rays):
        ids = np.minimum(np.arange(start, start + chunk_rays), nray - 1)
        local = shard_rays(ids.astype(np.int32), mesh)
        rgb = trace_rays_sharded(
            scene, meta, mesh, local, amb, width=width, height=height,
            samples=samples, max_depth=max_depth, stochastic=stochastic,
            seed=seed, light_sampler=light_sampler)
        lo = start + mesh.rank * per
        out[lo:lo + per] = rgb.cpu().numpy()
    out = out[:nray]
    rgb_pix = out.reshape(npix, spp, 3).sum(axis=1) / np.float32(spp)
    img = np.ones((npix, 4), np.float32)
    img[:, :3] = rgb_pix
    return img.reshape(height, width, 4)


def partition_scene(scene: TorchScene, trainable=None):
    """Split the leaves into (diff, static), two lists in ``LEAF_NAMES``
    order with ``None`` in the other list's slots.

    ``diff`` holds the float leaves, as the JAX package picks them
    (``jnp.issubdtype(dtype, floating)``: ``node_bbox_*``, ``radius`` and
    ``cam_aperture`` included, which get zero gradients), restricted to the
    names in ``trainable`` when it is given.
    """
    diff, static = [], []
    for name in LEAF_NAMES:
        leaf = getattr(scene, name)
        on = leaf.is_floating_point() and (trainable is None
                                           or name in trainable)
        diff.append(leaf if on else None)
        static.append(None if on else leaf)
    return diff, static


def combine_scene(diff, static) -> TorchScene:
    """Inverse of ``partition_scene``."""
    return TorchScene(*(d if d is not None else s
                        for d, s in zip(diff, static)))


def render_loss(scene: TorchScene, ray_ids, target_rgb, ambient, *,
                width: int, height: int, samples: int, max_depth: int,
                plain: bool = False, intersect=None):
    """Mean-squared error between the rendered radiance of ``ray_ids`` and
    ``target_rgb`` (N, 3), differentiable in every float leaf of ``scene``.
    ``plain`` renders through the plain versions of every kernel;
    ``intersect`` is ``trace_rays``'s hit-query override."""
    rgb = renderer_mod.trace_rays(scene, ray_ids, ambient, width, height,
                                  samples, max_depth, plain=plain,
                                  differentiable=True, intersect=intersect)
    return torch.mean((rgb - target_rgb) ** 2)


def _loss_and_grads(scene, ray_ids, target_rgb, ambient, kw, trainable,
                    lr=None):
    """``renderer.loss_grads_device``: the loss and the gradient of every
    trainable leaf (zeros where the loss does not reach it), or with ``lr``
    its updated value, in a list in LEAF_NAMES order with None in the
    static slots; the caller's own tensors."""
    return renderer_mod.loss_grads_device(
        scene, ray_ids, target_rgb, ambient, kw["width"], kw["height"],
        kw["samples"], kw["max_depth"], trainable=trainable, lr=lr)


def _loss_and_grads_autograd(diff, static, ray_ids, target_rgb, ambient,
                             kw):
    """The first form of ``_loss_and_grads``: ``render_loss`` (the eager
    loop, a host sync a bounce) and torch autograd; the same contract."""
    leaves = [None if d is None else d.detach().requires_grad_(True)
              for d in diff]
    on = [x for x in leaves if x is not None]
    loss = render_loss(combine_scene(leaves, static), ray_ids, target_rgb,
                       ambient, **kw)
    got = iter(torch.autograd.grad(loss, on, allow_unused=True))
    grads = []
    for x in leaves:
        g = None if x is None else next(got)
        if x is not None and g is None:
            g = torch.zeros_like(x)
        grads.append(g)
    return loss.detach(), grads


def _sgd(diff, grads, lr):
    return [None if d is None else d.detach() - lr * g
            for d, g in zip(diff, grads)]


def train_step(scene: TorchScene, ray_ids, target_rgb, ambient, lr, *,
               width: int, height: int, samples: int, max_depth: int,
               trainable=None, plain: bool = False):
    """One SGD step on the trainable float leaves: forward render, MSE loss,
    reverse-mode gradients, ``d - lr * g``. Returns (new TorchScene, loss);
    the input scene is left as it was, and the new scene's trained leaves
    are its own (static leaves are the input's). A leaf that the loss does
    not reach (zero gradient) comes back unchanged.

    The step runs as ``renderer.loss_grads_device`` with the update in it:
    on CUDA one CUDA graph kept across calls of a configuration, the depth
    loop and its reverse on the card with dead bounces skipped both ways;
    on the CPU the same structure through the plain versions. ``plain``
    runs the first form (``_train_step_autograd``) through the plain
    versions of every kernel.

    Spans (``utils/tracer.py``): ``train_step`` around
    ``partition_scene``, ``loss_grads_device`` (its stages as the frame's)
    and ``combine_scene``."""
    sp = tracer.begin("train_step")
    try:
        if plain:
            return _train_step_autograd(
                scene, ray_ids, target_rgb, ambient, lr, width=width,
                height=height, samples=samples, max_depth=max_depth,
                trainable=trainable, plain=True)
        s = tracer.begin("partition_scene")
        _, static = partition_scene(scene, trainable)
        tracer.end(s)
        loss, new = _loss_and_grads(
            scene, ray_ids, target_rgb, ambient,
            dict(width=width, height=height, samples=samples,
                 max_depth=max_depth), trainable, lr)
        s = tracer.begin("combine_scene")
        out = combine_scene(new, static)
        tracer.end(s)
        return out, loss
    finally:
        tracer.end(sp)


def _train_step_autograd(scene: TorchScene, ray_ids, target_rgb, ambient, lr,
                         *, width: int, height: int, samples: int,
                         max_depth: int, trainable=None,
                         plain: bool = False):
    """``train_step``'s first form, kept to hold the device loop against
    (only ``chip_smoke.py``, the tests and ablations call it): the eager
    loop (``render_loss``: ``trace_rays(differentiable=True)``, a host sync
    a bounce), torch autograd through K5 and K6 (their plain versions on
    the CPU, or with ``plain``), and the update on the host."""
    diff, static = partition_scene(scene, trainable)
    loss, grads = _loss_and_grads_autograd(
        diff, static, ray_ids, target_rgb, ambient,
        dict(width=width, height=height, samples=samples,
             max_depth=max_depth, plain=plain))
    return combine_scene(_sgd(diff, grads, lr), static), loss


def loss_and_grads_sharded(scene: TorchScene, ray_ids, target_rgb, ambient,
                           *, mesh: RayMesh, width: int, height: int,
                           samples: int, max_depth: int, trainable=None):
    """Global-batch (loss, grads, (diff, static)) for external optimizers.

    ``ray_ids`` and ``target_rgb`` are this rank's slabs (``shard_rays``),
    equal in size on every rank. Each rank takes the loss and gradients of
    its slab, then issues one ``all_reduce`` (sum) for the loss and one
    per trainable leaf in ``LEAF_NAMES`` order, each times
    ``float32(1/ws)``: the mean over the global batch, as JAX's
    ``psum(x) * scale``. A leaf that a rank's rays do not reach has a zero
    gradient there, so every rank issues the same collectives in the same
    order. ``grads`` holds None in the static slots; apply updates to
    ``diff`` and rebuild with ``combine_scene``.
    """
    diff, static = partition_scene(scene, trainable)
    loss, grads = _loss_and_grads(
        scene, ray_ids, target_rgb, ambient,
        dict(width=width, height=height, samples=samples,
             max_depth=max_depth), trainable)
    if mesh.group is not None:
        # a collective reduces a tensor's memory as if it were dense (the
        # gradients are the caller's own, dense tensors)
        grads = [None if g is None else g.contiguous() for g in grads]
        scale = torch.tensor(1.0 / mesh.world_size, dtype=torch.float32,
                             device=loss.device)
        for x in [loss] + [g for g in grads if g is not None]:
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.group)
            x.mul_(scale)
    return loss, grads, (diff, static)


def train_step_sharded(scene: TorchScene, ray_ids, target_rgb, ambient, lr,
                       *, mesh: RayMesh, width: int, height: int,
                       samples: int, max_depth: int, trainable=None):
    """``train_step`` on the ranks' slabs: ``loss_and_grads_sharded``, then
    ``d - lr * g`` on every rank, which keeps the replicas equal. Returns
    (new TorchScene, global loss); the same as ``train_step`` on the whole
    batch up to f32 reduction order."""
    loss, grads, (diff, static) = loss_and_grads_sharded(
        scene, ray_ids, target_rgb, ambient, mesh=mesh, width=width,
        height=height, samples=samples, max_depth=max_depth,
        trainable=trainable)
    return combine_scene(_sgd(diff, grads, lr), static), loss
