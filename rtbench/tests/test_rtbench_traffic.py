"""Each traffic mix is deterministic for a seed, differs across seeds, and
gives every seed the same work in another order."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from rtbench.core import common, spec
from rtbench.drive import frames, steps
from rtbench.scenes import hair


def _poses(seed):
    cell = spec.cell("lines.frame")
    cam = hair.make(cell.config["scene"]).cameras[0]
    return frames.poses(cam, cell.traffic, seed)


def test_poses_deterministic_and_ordered_by_seed():
    a, b, c = _poses(2**31 + 11), _poses(2**31 + 11), _poses(12)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[1], c[1])
    # the same poses in another order
    key = lambda o: o[np.lexsort(o.T)]
    assert np.array_equal(key(a[1]), key(c[1]))


def test_poses_stay_on_the_orbit():
    cell = spec.cell("lines.frame")
    cam = hair.make(cell.config["scene"]).cameras[0]
    axes, o = frames.poses(cam, cell.traffic, 3)
    target = cam.o - cam.axes[2] * cam.focus
    r = np.linalg.norm(o - target, axis=1)
    assert np.allclose(r, cam.focus, rtol=1e-5)
    # each pose looks at the target: -z points at it
    look = (target - o) / r[:, None]
    assert np.allclose(-axes[:, 2], look, atol=1e-5)
    az = np.degrees(np.arctan2(o[:, 0] - target[0], o[:, 2] - target[2]))
    assert az.max() - az.min() <= 2 * cell.traffic["azimuth_deg"]


def test_offsets_deterministic_and_ordered_by_seed():
    p = spec.cell("refl.train").traffic
    total, n = 910 * 512 * 16, p["rays"]
    a = steps.offsets(total, n, p, 7)
    assert np.array_equal(a, steps.offsets(total, n, p, 7))
    b = steps.offsets(total, n, p, 3_000_000_019)
    assert not np.array_equal(a, b)
    assert np.array_equal(np.sort(a), np.sort(b))
    assert a.min() == 0 and a.max() + n <= total


def test_target_is_the_mix_s_own():
    p = spec.cell("refl.train").traffic
    a = steps.target_image(32, 18, p, "cpu")
    assert torch.equal(a, steps.target_image(32, 18, p, "cpu"))
    assert a.shape == (32 * 18, 3) and bool((a >= 0).all())
    assert float(a.std()) > 0.01


def test_query_points_follow_the_seed():
    def points(seed):
        g = torch.Generator()
        g.manual_seed(seed)
        return torch.rand((64, 3), generator=g)

    assert torch.equal(points(2**31 + 5), points(2**31 + 5))
    assert not torch.equal(points(2**31 + 5), points(5))


def test_reservoir_keeps_a_seeded_sample():
    def sample(seed):
        r = common.Reservoir(4, np.random.default_rng([seed, 2]))
        for k in range(1000):
            r.offer(k)
        return sorted(r.items)

    assert sample(9) == sample(9)
    assert sample(9) != sample(10)
    assert len(sample(9)) == 4


@pytest.mark.parametrize("workload", ["lines.frame", "refl.train",
                                      "refl.frame", "lines.overlap"])
def test_every_cell_finds_its_files(workload):
    cell = spec.cell(workload)
    assert cell.kind in ("frames", "steps", "queries")
    assert cell.driver().run
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    for m in cell.per_layer:
        assert spec.metric_reader(m["name"]).read
