"""Ray-sharded rendering and training over ``torch.distributed`` ranks, and
the one-device training step (the JAX package's ``parallel``)."""

from . import mesh  # noqa: F401
from .mesh import (  # noqa: F401
    init_distributed,
    make_ray_mesh,
    trace_rays_sharded,
    replicate_scene,
    shard_rays,
    render_image_sharded,
    render_loss,
    train_step,
    train_step_sharded,
    loss_and_grads_sharded,
    combine_scene,
    partition_scene,
)
