"""Helpers every driver uses: clocks, the card, the sample of answers kept
from a window, the tail statistic, the loaded scene."""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass

import numpy as np
import torch

from . import spec

# the JAX stack and the JAX package, by whole top-level module name: the
# port's own name begins with the JAX package's
FORBIDDEN = ("jax", "jaxlib", "flax", "yocto_raytracing_tpu")


def process_start() -> float:
    """This process's start on the ``time.time()`` clock, from the kernel's
    record (/proc/self/stat's start time, in clock ticks since boot), so
    that the set-up time counts the interpreter's start too; the module's
    import time where /proc cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.time()


def forbidden_modules() -> list:
    """The loaded modules whose whole top-level name is that of JAX, its
    libraries or the JAX package."""
    return sorted({m for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN})


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def power_limit() -> str:
    """The card's power limit as nvidia-smi prints it, or "unknown"."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()
        return out[0] if out else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def p95(values) -> float:
    """The 95th percentile by nearest rank: the smallest value with at
    least 95% of all the values at or below it."""
    v = np.sort(np.asarray(values, np.float64))
    return float(v[max(0, int(np.ceil(0.95 * len(v))) - 1)])


class Reservoir:
    """A uniform sample of at most ``k`` of a stream's items, drawn from
    ``rng`` (reservoir sampling): the answers of a window kept for the
    comparison, without a copy and without knowing the window's length."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1


@dataclass
class Loaded:
    host: object          # the generator's scene (rtbench.ref.flat.HostScene)
    scene: object         # the port's TorchScene, as a user loads it
    meta: object
    width: int
    height: int


def load_config_scene(config: dict, device) -> Loaded:
    """The configuration's scene: made by its generator
    (``rtbench/scenes/<generator>.py``) from its ``scene`` object, written
    as OBJ/MTL into a temporary directory under ``TMPDIR``, and loaded by
    the port as a user loads a scene file: ``load_scene``,
    ``build_device_scene``, ``to_torch``."""
    from rtbench.ref import objwriter
    from yocto_raytracing_tpu_torch import scene as port_scene
    from yocto_raytracing_tpu_torch.render import renderer

    gen = spec.load_module(
        spec.BENCH / "scenes" / f"{config['scene']['generator']}.py",
        "rtbench_scene_" + config["scene"]["generator"])
    host = gen.make(config["scene"])
    with tempfile.TemporaryDirectory(prefix="rtbench-") as tmp:
        path = os.path.join(tmp, "scene.obj")
        objwriter.save_obj(host, path)
        loaded = port_scene.load_scene(path)
    leaves, meta = port_scene.build_device_scene(loaded)
    res = config["render"]["resolution"]
    return Loaded(host=host, scene=port_scene.to_torch(leaves, device),
                  meta=meta,
                  width=renderer.image_width(loaded.cameras[0].aspect, res),
                  height=res)


def reference_scene(host, device, dtype=torch.float32):
    """The reference's own leaves and meta, worked out from the generator's
    scene as the program loads it (``rtbench/ref/flat.py``)."""
    from rtbench.ref import flat

    leaves, meta = flat.build_device_scene(flat.as_loaded(host))
    return flat.to_device(leaves, device, dtype), meta, leaves


def leaves_bytes(leaves: dict, names) -> int:
    return int(sum(np.asarray(leaves[k]).nbytes for k in names))


HIT_LEAVES = ("node_bbox_min", "node_bbox_max", "node_start", "node_count",
              "node_isleaf", "node_kind", "node_skip", "leaf_items",
              "inst_axes", "inst_o", "inst_shape_root", "prim_v",
              "prim_type", "pos", "radius")
SHADE_LEAVES = ("pos", "norm", "texcoord", "prim_v", "prim_type",
                "inst_axes", "inst_o", "inst_mat", "inst_is_lines", "mat_kd",
                "mat_ks", "mat_kr", "mat_rs", "mat_kd_txt", "mat_ks_txt",
                "tex_quad", "tex_w", "tex_h", "light_pos", "light_axes",
                "light_o", "light_ke")
