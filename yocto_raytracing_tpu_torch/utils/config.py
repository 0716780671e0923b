"""Render configuration.

The reference's five CLI knobs (src/raytrace.cpp:258-270) plus the
execution knobs (depth cap, chunking, sharding, checkpoint, the stochastic
modes) and the device. A copy of the JAX package's ``utils/config.py``,
with ``device`` added.
"""

from __future__ import annotations

from dataclasses import dataclass, asdict


@dataclass
class RenderConfig:
    resolution: int = 720       # --resolution/-r (vertical; width = aspect*r)
    samples: int = 1            # --samples/-s (grid side; spp = s^2)
    ambient: float = 0.1        # --ambient/-a (grey ambient)
    output: str = "out.png"     # --output/-o (.png tonemapped / .hdr float)
    camera: int = 0             # reference always uses cameras.front()
    max_depth: int = 8          # mirror-recursion cap (ref: unbounded)
    chunk_pixels: int = 1 << 15  # pixels per chunk
    sharded: bool = False       # shard rays over the torch.distributed ranks
    checkpoint: str = ""        # accumulator checkpoint path ("" = off)
    intersector: str = "stream"  # "stream" / "bvh": the same answers (K1)
    stochastic: bool = False    # jittered AA + thin-lens DOF (aperture > 0)
    seed: int = 0               # RNG seed for the stochastic modes
    area_lights: bool = False   # element-CDF soft shadows
    device: str = "cuda"        # "cuda" (the card) or "cpu"

    def to_dict(self):
        return asdict(self)
