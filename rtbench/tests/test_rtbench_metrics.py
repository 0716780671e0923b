"""The metric arithmetic on hand-made timings and traces."""

from __future__ import annotations

import math

import numpy as np
import pytest

from rtbench.core import common, profile, runner, spec
from rtbench.core.trace import TraceData, idle_percent, mean, mfu_percent
from rtbench.roofline import k1, k4, k5, k11, peaks

H100 = "NVIDIA H100 80GB HBM3"


def test_p95_is_the_nearest_rank_over_all_requests():
    values = [float(k) for k in range(1, 101)]   # 1..100 ms
    assert common.p95(values) == 95.0
    assert common.p95(list(reversed(values))) == 95.0
    assert common.p95([5.0] * 19 + [100.0]) == 5.0     # 1 of 20 beyond
    assert common.p95([5.0] * 18 + [100.0] * 2) == 100.0
    assert common.p95([3.0]) == 3.0


def test_union_of_device_intervals():
    iv = np.array([[0, 10], [5, 12], [20, 30], [30, 31], [40, 40]], float)
    u = profile._union(iv)
    assert u.tolist() == [[0, 12], [20, 31]]


def _profile(busy_s=0.6, window_s=1.0, by_name=None):
    by_name = by_name or {}
    return profile.Profile(busy_s, window_s, by_name,
                           {n: 1 for n in by_name}, [])


def test_idle_share_and_kernel_time():
    p = _profile(0.25, 1.0, {"yrt::hit_nearest_kernel(a)": 0.1,
                             "yrt::hit_any_kernel(b)": 0.05,
                             "yrt::hit_nearest_kernel_x(c)": 7.0})
    t = TraceData(p, H100, 4, {})
    assert idle_percent(t) == pytest.approx(75.0)
    assert p.kernel_s(k1.FUNCTIONS) == pytest.approx(0.15)
    assert p.kernel_launches("hit_nearest_kernel") == 1


def test_k1_share_from_counts():
    counts = {"nearest": dict(rays=1000, hits=600, nodes=10_000, frames=0,
                              point_tests=0, line_tests=0,
                              triangle_tests=0),
              "any": dict(rays=0, hits=0, nodes=0, frames=0, point_tests=0,
                          line_tests=0, triangle_tests=0)}
    p = _profile(by_name={"yrt::hit_nearest_kernel(x)": 1e-6})
    t = TraceData(p, H100, 1, {"hit_counts": counts, "hit_leaves_bytes": 0})
    ops, nbytes = k1.work(t)
    assert ops == 53 * 10_000 and nbytes == 45 * 1000
    want = 100 * max(ops / 67e12, nbytes / 3.35e12) / 1e-6
    assert k1.share(t) == pytest.approx(want)
    # K4 and K5: a hit lane's full record, a dead lane's mask byte
    t2 = TraceData(p, H100, 1, {"hit_counts": counts, "shade_lanes": 4000,
                                "shade_leaves_bytes": 100})
    assert k4.work(t2) == (360 * 600, 4000 + 80 * 600 + 100)
    assert k5.work(t2) == (1100 * 600, 4000 + 104 * 600 + 200)
    assert mfu_percent(t2, (k4,)) == pytest.approx(
        100 * 360 * 600 / 67e12 / 1.0)


def test_k11_share_from_counts():
    p = _profile(by_name={"yrt::overlap_kernel(x)": 2e-3,
                          "yrt::overlap_refit_kernel(y)": 1e-5})
    t = TraceData(p, H100, 2, {
        "walk_counts": dict(nodes=100, point_tests=1, line_tests=2,
                            triangle_tests=3),
        "queries": 10, "instances": 5, "call_bytes": 1000})
    ops, nbytes = k11.work(t)
    assert ops == 20 * 5 * 10 + 50 * 100 + 25 + 120 + 330
    assert nbytes == 45 * 10 + 1000
    assert k11.share(t) == pytest.approx(
        100 * max(ops / 67e12, nbytes / 3.35e12) / 2.01e-3)


def test_a_share_never_reads_zero_for_nothing_measured():
    assert peaks.share_percent(H100, 1e9, 1e9, 0.0) is None
    assert peaks.share_percent(H100, 0, 0, 1.0) is None
    with pytest.raises(KeyError):
        peaks.peak("a card with no data sheet")
    assert mean([]) is None and mean([1.0, 3.0]) == 2.0


def test_correct_needs_every_number_within_its_limit():
    assert runner.correct({"a": (0.0, 0.0), "b": (1e-3, 1e-2)})
    assert not runner.correct({"a": (0.02, 0.01)})
    assert not runner.correct({"a": (math.nan, 1.0)})
    assert not runner.correct({"a": (math.inf, 1.0)})


def test_result_line_orders_and_keys():
    cell = spec.cell("lines.overlap")
    out = runner.Outcome(metrics=dict(query_Mq_s=600.0, setup_s=9.0),
                         attempted=5, failed=0,
                         compared={"mismatch": (0.0, 1e-3),
                                   "answer_gap": (0.0, 1e-5)},
                         memory_peak_bytes=123)
    line = runner.result(cell, out, False, dict(platform="gpu", kind=H100,
                                                count=1))
    assert list(line)[-1] == "compared"
    assert set(line) >= {"correct", "attempted", "failed", "metrics",
                         "device"}
    assert line["metrics"] == {"query_Mq_s": {"value": 600.0,
                                              "unit": "Mq/s"},
                               "setup_s": {"value": 9.0, "unit": "s"}}
    assert line["device"]["memory_peak_bytes"] == 123
