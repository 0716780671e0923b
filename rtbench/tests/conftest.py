"""Tests of the benchmark itself, on the CPU at small sizes.

Run from the repository's root:

    python -m pytest rtbench/tests -q -p no:cacheprovider

They import the port (``yocto_raytracing_tpu_torch``) and never JAX; none
needs a card: what only the card can show, the benchmark's runs show.
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


# small sizes of each kind of traffic, for runs on the CPU
SMALL = {
    "frames": dict(resolution=40, samples=1, keep_frames=2, check_pixels=384,
                   warm_hits=1),
    "steps": dict(resolution=40, samples=1, rays=1024, offsets=4, warm_steps=1,
                  check_within=4),
    "queries": dict(points=1024, keep_calls=2, check_queries=512,
                    warm_calls=1),
}


@pytest.fixture
def small():
    return SMALL
