"""Port's ray-primitive math == the JAX package's ops/intersect.py.

Both sides get the same seeded numpy inputs. Booleans must be equal and
floats within 1 ULP. The JAX side runs op by op (``jax.disable_jit``):
jitted XLA:CPU contracts a*b+c into fma() inside fusions (see
tests/test_stream.py), which moves Möller-Trumbore's t by hundreds of ULP
on near-degenerate inputs, while the port, like the reference C++, rounds
every operation.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from yocto_raytracing_tpu.ops import intersect as J
from yocto_raytracing_tpu_torch.ops import intersect as T

N = 4096
FLT_MAX = np.float32(3.4028235e38)


def _ordered(x):
    """f32 -> int64 whose order and differences count ULPs across zero."""
    i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
    return np.where(i < 0, -(i & 0x7FFFFFFF), i)


def assert_ulp(a, b, max_ulp=1, what=""):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    d = np.abs(_ordered(a) - _ordered(b))
    assert d.max() <= max_ulp, f"{what}: {d.max()} ULP at {d.argmax()}"


def _inputs(seed):
    rng = np.random.default_rng(seed)

    def r(*s):
        return rng.uniform(-2, 2, size=s).astype(np.float32)

    rd = r(N, 3)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return dict(ro=r(N, 3), rd=rd, v0=r(N, 3), v1=r(N, 3), v2=r(N, 3),
                axes=r(N, 3, 3), r0=rng.uniform(0.01, 0.5, N).astype(np.float32),
                r1=rng.uniform(0.01, 0.5, N).astype(np.float32),
                tmin=np.full(N, 1e-4, np.float32),
                tmax=np.full(N, FLT_MAX, np.float32))


def _both(jfn, tfn, *args):
    with jax.disable_jit():
        a = jfn(*(jnp.asarray(x) for x in args))
    b = tfn(*(torch.from_numpy(np.ascontiguousarray(x)) for x in args))
    return a, b


@pytest.mark.parametrize("seed", [0, 1])
def test_triangle(seed):
    x = _inputs(seed)
    (ha, ta, w1a, w2a), (hb, tb, w1b, w2b) = _both(
        J.intersect_triangle, T.intersect_triangle,
        x["ro"], x["rd"], x["tmin"], x["tmax"], x["v0"], x["v1"], x["v2"])
    np.testing.assert_array_equal(np.asarray(ha), hb.numpy())
    assert np.asarray(ha).sum() > 50
    for a, b, what in ((ta, tb, "t"), (w1a, w1b, "w1"), (w2a, w2b, "w2")):
        assert_ulp(a, b.numpy(), what=what)


@pytest.mark.parametrize("seed", [0, 1])
def test_line(seed):
    x = _inputs(seed)
    (ha, ta, sa), (hb, tb, sb) = _both(
        J.intersect_line, T.intersect_line, x["ro"], x["rd"], x["tmin"],
        x["tmax"], x["v0"], x["v1"], x["r0"], x["r1"])
    np.testing.assert_array_equal(np.asarray(ha), hb.numpy())
    assert np.asarray(ha).sum() > 50
    assert_ulp(ta, tb.numpy(), what="t")
    assert_ulp(sa, sb.numpy(), what="s")


@pytest.mark.parametrize("seed", [0, 1])
def test_point(seed):
    x = _inputs(seed)
    (ha, ta), (hb, tb) = _both(
        J.intersect_point, T.intersect_point, x["ro"], x["rd"], x["tmin"],
        x["tmax"], x["v0"], x["r0"])
    np.testing.assert_array_equal(np.asarray(ha), hb.numpy())
    assert np.asarray(ha).sum() > 10
    assert_ulp(ta, tb.numpy(), what="t")


@pytest.mark.parametrize("seed", [0, 1])
def test_bbox(seed):
    x = _inputs(seed)
    bmin = np.minimum(x["v0"], x["v1"])
    bmax = np.maximum(x["v0"], x["v1"])
    a, b = _both(J.intersect_bbox, T.intersect_bbox, x["ro"], x["rd"],
                 x["tmin"], x["tmax"], bmin, bmax)
    np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert 0 < np.asarray(a).sum() < N


def test_bbox_axis_parallel_ray_on_slab_plane():
    """0 * inf = NaN on the slab plane drops that axis's constraint
    (the reference's (x > y) ? x : y reduce) instead of missing."""
    ro = np.array([[0.0, 0.0, -5.0], [1.0, 0.5, -5.0], [1.5, 0.0, -5.0],
                   [0.0, 1.0, -5.0]], np.float32)
    rd = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (4, 1))
    bmin = np.tile(np.array([[0.0, 0.0, -1.0]], np.float32), (4, 1))
    bmax = np.tile(np.array([[1.0, 1.0, 1.0]], np.float32), (4, 1))
    tmin = np.full(4, 1e-4, np.float32)
    tmax = np.full(4, FLT_MAX, np.float32)
    a, b = _both(J.intersect_bbox, T.intersect_bbox, ro, rd, tmin, tmax,
                 bmin, bmax)
    np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(b.numpy(), [True, True, False, True])


def test_transforms_and_helpers():
    x = _inputs(3)
    axes, o, ro, rd = x["axes"], x["v0"], x["ro"], x["rd"]
    (loa, lda), (lob, ldb) = _both(J.transform_ray_inverse,
                                   T.transform_ray_inverse, axes, o, ro, rd)
    assert_ulp(loa, lob.numpy(), what="lo")
    assert_ulp(lda, ldb.numpy(), what="ld")
    a, b = _both(J.transform_point, T.transform_point, axes, o, ro)
    assert_ulp(a, b.numpy(), what="transform_point")
    a, b = _both(J.transform_vector, T.transform_vector, axes, rd)
    assert_ulp(a, b.numpy(), what="transform_vector")
    a, b = _both(J.cross, T.cross, ro, rd)
    assert_ulp(a, b.numpy(), what="cross")
    a, b = _both(J.dot, T.dot, ro, rd)
    assert_ulp(a, b.numpy(), what="dot")
    z = np.concatenate([ro, np.zeros((4, 3), np.float32)])
    a, b = _both(J.safe_normalize, T.safe_normalize, z)
    assert_ulp(a, b.numpy(), what="safe_normalize")
    s = np.concatenate([x["r0"], [0.0, -1.0]]).astype(np.float32)
    a, b = _both(J.safe_sqrt, T.safe_sqrt, s)
    assert_ulp(a, b.numpy(), what="safe_sqrt")
    e = np.full(s.shape, 7.5, np.float32)
    a, b = _both(J.safe_pow, T.safe_pow, s, e)
    assert_ulp(a, b.numpy(), what="safe_pow")
