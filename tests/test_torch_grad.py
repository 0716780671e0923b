"""Port's gradients (CPU, torch autograd of the plain versions) == JAX's.

* every float leaf against ``jax.grad`` of the same objective (test_grad.py's
  sin-weighted radiance sum) on the grad scene (8x8, 1 spp, depth 3: camera,
  triangle, mirror bounce), a small hair scene (hair BRDF) and the textured
  hair scene (d_uv through the bilinear weights): rtol 1e-4 and atol
  1e-5 * max|g| over all leaves (cam_focus's gradient is zero up to
  rounding: the ray directions do not depend on it), and relative L2 error
  <= 1e-4 per leaf. The JAX side runs in the no-FMA child process
  (tests/jax_nofma.py): jitted XLA:CPU's FMA contraction alone moves one
  hair-vertex gradient by ~5e-4 relative (ROADMAP section C);
* the visibility-boundary law of test_grad_scene.py on the port: no
  silhouette term, interior gradients survive the detached traversal;
* finite gradients on a scene with misses; the traversal records no graph;
* the differentiable forward is bit-equal to the forward-only one;
* ``partition_scene`` marks the JAX package's leaves.
"""

import dataclasses
import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import jax_nofma
from yocto_raytracing_tpu import scene as jscene
from yocto_raytracing_tpu.parallel import mesh as jmesh
from yocto_raytracing_tpu_torch import scene as tscene
from yocto_raytracing_tpu_torch import testscenes as tts
from yocto_raytracing_tpu_torch.ops import traverse as ttrav
from yocto_raytracing_tpu_torch.parallel import mesh as tmesh
from yocto_raytracing_tpu_torch.render import renderer as tren

AMB = np.full(3, 0.1, np.float32)

SCENES = {
    "grad": (tts.make_grad_scene, 8, 8, 1, 3),
    "hair": (lambda: tts.make_hair_scene(64), 24, 14, 1, 2),
    "textured": (lambda: tts.make_textured_hair_scene(64), 24, 14, 1, 2),
}


def _weights(n):
    return np.sin(np.arange(n * 3, dtype=np.float32)).reshape(n, 3)


def _port_grads(ts, w, h, s, depth, weights, trainable=None):
    """{leaf name: gradient} of sum(trace_rays * weights), torch autograd."""
    diff, static = tmesh.partition_scene(ts, trainable)
    leaves = [None if d is None else d.detach().requires_grad_(True)
              for d in diff]
    ids = torch.arange(w * h * s * s, dtype=torch.int32)
    rgb = tren.trace_rays(tmesh.combine_scene(leaves, static), ids,
                          torch.from_numpy(AMB), w, h, s, depth,
                          differentiable=True)
    loss = (rgb * torch.from_numpy(weights)).sum()
    on = [x for x in leaves if x is not None]
    got = torch.autograd.grad(loss, on, allow_unused=True)
    names = [n for n, x in zip(tscene.LEAF_NAMES, leaves) if x is not None]
    return {n: (torch.zeros_like(x) if g is None else g).numpy()
            for n, x, g in zip(names, on, got)}


@pytest.mark.parametrize("name", list(SCENES))
def test_grads_match_jax(name):
    make, w, h, s, depth = SCENES[name]
    leaves, _ = tscene.build_device_scene(make())
    ts = tscene.to_torch(leaves, "cpu")
    n = w * h * s * s
    weights = _weights(n)
    ref = jax_nofma.grads(leaves, np.arange(n, dtype=np.int32), weights, AMB,
                          width=w, height=h, samples=s, max_depth=depth)
    got = _port_grads(ts, w, h, s, depth, weights)
    assert sorted(got) == sorted(ref)
    gmax = max(float(np.abs(r).max(initial=0.0)) for r in ref.values())
    for leaf, g in got.items():
        r = ref[leaf]
        assert np.isfinite(g).all(), leaf
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-5 * gmax,
                                   err_msg=leaf)
        norm = np.linalg.norm(r)
        if norm > 1e-4 * gmax:   # leaves with a non-vanishing gradient
            assert np.linalg.norm(g - r) <= 1e-4 * norm, leaf
    for leaf in ("pos", "norm", "inst_axes", "mat_kd", "light_ke", "cam_o",
                 "cam_fovy"):
        assert np.abs(ref[leaf]).max() > 1e-3, leaf
    if name == "textured":
        assert np.abs(ref["texcoord"]).max() > 1e-3
    if name == "grad":
        assert np.abs(ref["mat_kr"]).max() > 1e-3   # the mirror bounce


def _edge_scene():
    """test_grad_scene.py's constant-colour triangle whose silhouette splits
    the image, built with the port's own classes."""
    host = tts.make_random_scene(seed=5, n_instances=1, n_shapes=1, n_tris=1,
                                 n_lines=0, n_points=0)
    shp = host.shapes[0]
    shp.pos = np.asarray([[-0.5, -2.0, 0.0], [0.5, 2.0, 0.0],
                          [2.5, 0.0, 0.0]], np.float32)
    shp.triangles = np.asarray([[0, 2, 1]], np.int32)
    shp.norm = np.zeros((0, 3), np.float32)
    shp.texcoord = np.zeros((3, 2), np.float32)
    shp.radius = np.zeros(3, np.float32)
    shp.points = np.zeros(0, np.int32)
    shp.lines = np.zeros((0, 2), np.int32)
    host.instances[0].axes = np.eye(3, dtype=np.float32)
    host.instances[0].o = np.zeros(3, np.float32)
    host.materials[0].kd = np.asarray([0.8, 0.8, 0.8], np.float32)
    host.materials[0].ks = np.zeros(3, np.float32)
    host.materials[0].kr = np.zeros(3, np.float32)
    host.cameras = [tts.lookat_camera("cam", eye=(0, 0, 4), target=(0, 0, 0))]
    tscene.finalize_scene(host)
    return host


def _lit_edge_scene():
    host = _edge_scene()
    host.shapes.append(tts._shape("lamp", pos=[[0.0, 0.0, 3.0]], points=[0]))
    host.materials.append(tscene.HostMaterial(
        name="lamp", ke=np.asarray([50.0, 50.0, 50.0], np.float32)))
    host.instances.append(tscene.HostInstance(
        name="lamp", axes=np.eye(3, dtype=np.float32),
        o=np.zeros(3, np.float32), shape=1, material=1))
    tscene.finalize_scene(host)
    return host


def _edge_objective(ts, w=12, h=12):
    ids = torch.arange(w * h, dtype=torch.int32)
    rgb = tren.trace_rays(ts, ids, torch.from_numpy(AMB), w, h, 1, 1,
                          differentiable=True)
    wgt = torch.cos(torch.arange(rgb.numel(), dtype=torch.float32) * 0.7)
    return torch.sum(rgb * wgt.reshape(rgb.shape))


def _autodiff_and_fd(host, leaf, idx, eps):
    leaves, _ = tscene.build_device_scene(host)
    ts = tscene.to_torch(leaves, "cpu")
    x = getattr(ts, leaf).detach().requires_grad_(True)
    (g,) = torch.autograd.grad(
        _edge_objective(dataclasses.replace(ts, **{leaf: x})), [x])

    def at(delta):
        arr = getattr(ts, leaf).clone()
        arr[idx] += delta
        with torch.no_grad():
            return float(_edge_objective(
                dataclasses.replace(ts, **{leaf: arr})))

    return float(g[idx]), (at(eps) - at(-eps)) / (2 * eps)


def test_visibility_boundary_gradient_is_dropped():
    """FD sees pixels flip across the silhouette; autodiff, which holds the
    hit topology fixed, reports ~0 (GRADIENTS.md)."""
    g, fd = _autodiff_and_fd(_edge_scene(), "pos", (0, 0), 2e-2)
    assert abs(fd) > 0.2, f"edge FD should be large, got {fd}"
    assert abs(g) < 1e-4, f"detached-traversal grad should be ~0, got {g}"


def test_interior_gradients_survive_detachment():
    g, fd = _autodiff_and_fd(_lit_edge_scene(), "pos", (0, 2), 1e-3)
    assert abs(g) > 1e-4, "interior shading gradient must flow"
    np.testing.assert_allclose(g, fd, rtol=0.15, atol=5e-3)


def test_grads_finite_with_misses_and_traversal_detached(monkeypatch):
    """Every float leaf requires grad on a scene where many rays miss: the
    hit queries see only detached tensors and return no graph, the loss's
    graph holds no op recorded in ops/traverse.py, and every gradient is
    finite."""
    leaves, _ = tscene.build_device_scene(_lit_edge_scene())
    ts = tscene.to_torch(leaves, "cpu")
    diff, static = tmesh.partition_scene(ts)
    on = [None if d is None else d.detach().requires_grad_(True)
          for d in diff]
    scene = tmesh.combine_scene(on, static)

    real = ttrav.intersect_scene
    calls = []

    def spy(sc, ro, rd, tmin, tmax, any_hit=False):
        inputs = [ro, rd, tmin, tmax] + [getattr(sc, k)
                                         for k in tscene.LEAF_NAMES]
        assert not any(t.requires_grad for t in inputs)
        out = real(sc, ro, rd, tmin, tmax, any_hit)
        assert all(v.grad_fn is None for v in out.values())
        calls.append((any_hit, out["hit"].float().mean().item()))
        return out

    monkeypatch.setattr(ttrav, "intersect_scene", spy)
    # anomaly mode records each graph node's forward traceback
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # "debugging only"
        anomaly = torch.autograd.detect_anomaly(check_nan=False)
    with anomaly:
        loss = _edge_objective(scene, 16, 16)
        nodes, stack, seen = 0, [loss.grad_fn], set()
        while stack:
            node = stack.pop()
            if node is None or node in seen:
                continue
            seen.add(node)
            nodes += 1
            trace = "".join(node.metadata.get("traceback_", []))
            assert "ops/traverse.py" not in trace, type(node).__name__
            stack.extend(nxt for nxt, _ in node.next_functions)
    assert nodes > 50
    assert {a for a, _ in calls} == {False, True}
    primary_hit = [f for a, f in calls if not a][0]
    assert 0.1 < primary_hit < 0.9           # hits and misses
    got = torch.autograd.grad(loss, [x for x in on if x is not None],
                              allow_unused=True)
    for name, g in zip([n for n, x in zip(tscene.LEAF_NAMES, on)
                        if x is not None], got):
        assert g is None or bool(torch.isfinite(g).all()), name


@pytest.mark.parametrize("name", ["grad", "hair"])
def test_differentiable_forward_is_bit_equal(name):
    make, w, h, _, _ = SCENES[name]
    leaves, meta = tscene.build_device_scene(make())
    ts = tscene.to_torch(leaves, "cpu")
    diff, static = tmesh.partition_scene(ts)
    grad_scene = tmesh.combine_scene(
        [None if d is None else d.detach().requires_grad_(True)
         for d in diff], static)
    ids = torch.arange(w * h * 4, dtype=torch.int32)
    amb = torch.from_numpy(AMB)
    fwd = tren.trace_rays(ts, ids, amb, w, h, 2, 4)
    dif = tren.trace_rays(grad_scene, ids, amb, w, h, 2, 4,
                          differentiable=True)
    assert fwd.grad_fn is None and dif.grad_fn is not None
    assert torch.equal(fwd, dif.detach())


@pytest.mark.parametrize("trainable", [None, ("mat_kd", "light_ke", "pos",
                                              "prim_v")])
def test_partition_scene_matches_jax(trainable):
    host = tts.make_hair_scene(16)
    leaves, _ = tscene.build_device_scene(host)
    jd = jscene.DeviceScene(**{k: jnp.asarray(v) for k, v in leaves.items()})
    jdiff, jstatic, _ = jmesh.partition_scene(jd, trainable)
    names = [f.name for f in dataclasses.fields(jscene.DeviceScene)]
    assert tuple(names) == tscene.LEAF_NAMES
    ts = tscene.to_torch(leaves, "cpu")
    diff, static = tmesh.partition_scene(ts, trainable)
    assert [d is None for d in diff] == [d is None for d in jdiff]
    assert [s is None for s in static] == [s is None for s in jstatic]
    marked = {n for n, d in zip(names, diff) if d is not None}
    if trainable is None:
        assert {"node_bbox_min", "radius", "cam_aperture", "cam_focus"} \
            <= marked
        assert "prim_v" not in marked
    else:
        assert marked == {"mat_kd", "light_ke", "pos"}
    back = tmesh.combine_scene(diff, static)
    assert all(getattr(back, n) is getattr(ts, n) for n in names)
