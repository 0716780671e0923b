"""Differentiable training step over the scene leaves, one device.

Port of ``yocto_raytracing_tpu/parallel/mesh.py:219-291``
(``partition_scene``, ``combine_scene``, ``render_loss``, ``train_step``).
Gradients flow to every float leaf through the detached-traversal renderer
(``trace_rays(..., differentiable=True)``); integer topology (BVH nodes, prim
ids, texture ids) and the packed texels are static. The port always saves
the hits and recomputes shading in the backward, which is the JAX package's
``remat=True``; the TPU-only keywords (``stream``, ``max_stack``,
``block_unroll``, ``remat``) have no counterpart. The ray-sharded functions
are not ported yet.
"""

from __future__ import annotations

import torch

from ..render import renderer as renderer_mod
from ..scene import LEAF_NAMES, TorchScene


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


def train_step(scene: TorchScene, ray_ids, target_rgb, ambient, lr, *,
               width: int, height: int, samples: int, max_depth: int,
               trainable=None, plain: bool = False):
    """One SGD step on the trainable float leaves: forward render, MSE loss,
    reverse-mode gradients, ``d - lr * g``. Returns (new TorchScene, loss);
    the input scene is left as it was. A leaf that the loss does not reach
    (zero gradient) comes back unchanged."""
    diff, static = partition_scene(scene, trainable)
    leaves = [None if d is None else d.detach().requires_grad_(True)
              for d in diff]
    on = [x for x in leaves if x is not None]
    loss = render_loss(combine_scene(leaves, static), ray_ids, target_rgb,
                       ambient, width=width, height=height, samples=samples,
                       max_depth=max_depth, plain=plain)
    grads = iter(torch.autograd.grad(loss, on, allow_unused=True))
    new = []
    for x in leaves:
        if x is None:
            new.append(None)
            continue
        g = next(grads)
        new.append(x.detach() if g is None else x.detach() - lr * g)
    return combine_scene(new, static), loss.detach()
