"""Port's gradients with the stochastic modes (CPU, torch autograd of the
plain versions) == JAX's.

``jax.grad`` of the weighted radiance sum of ``trace_rays(...,
differentiable=True, stochastic=, rng_key=, light_sampler=)``, run in the
no-FMA child (``tests/jax_nofma.py``), against torch autograd of the port's
``trace_rays`` with the same ``stochastic``, ``seed`` and light tables, on
the occluded triangle-light scene of ``tests/test_torch_lights.py`` at
24x24, 2x2 samples, depth 2:

* area lights only (the gradient reaches the light triangle's vertices
  through the sampled points);
* jittered thin-lens rays with aperture 0.2 and area lights (and
  ``cam_aperture`` and ``cam_focus``, which the lens makes move the rays);
* jittered thin-lens rays with aperture 0.2 and the point light.

Every float leaf within rtol 1e-4 and atol 1e-5 * max|g| over all leaves
(``test_torch_grad.py``'s bound: a leaf whose gradient is zero up to
rounding, ``cam_focus`` without a lens, is held by the atol), and relative
L2 error <= 1e-4 per leaf with a non-vanishing gradient.
"""

import numpy as np
import pytest
import torch

import jax_nofma
from test_torch_lights import occluded_scene
from yocto_raytracing_tpu_torch import scene as tscene
from yocto_raytracing_tpu_torch.parallel import mesh as tmesh
from yocto_raytracing_tpu_torch.render import lights as tlights
from yocto_raytracing_tpu_torch.render import renderer as tren

AMB = np.full(3, 0.1, np.float32)
W = H = 24
SAMPLES, DEPTH, SEED = 2, 2, 3
RTOL = 1e-4

# name: (triangle light, stochastic, aperture)
CASES = {
    "area": (True, False, 0.0),
    "area_stochastic": (True, True, 0.2),
    "point_stochastic": (False, True, 0.2),
}


def _weights(n):
    return np.sin(np.arange(n * 3, dtype=np.float32)).reshape(n, 3)


def _case(name):
    light_tri, stochastic, aperture = CASES[name]
    host = occluded_scene("torch", light_tri=light_tri)
    host.cameras[0].aperture = aperture
    leaves, meta = tscene.build_device_scene(host)
    sampler = (tlights.build_light_sampler(host, leaves, meta, "cpu")
               if light_tri else None)
    return leaves, meta, sampler, stochastic


def _port_grads(ts, ids, weights, stochastic, sampler):
    diff, static = tmesh.partition_scene(ts)
    leaves = [None if d is None else d.detach().requires_grad_(True)
              for d in diff]
    rgb = tren.trace_rays(tmesh.combine_scene(leaves, static), ids,
                          torch.from_numpy(AMB), W, H, SAMPLES, DEPTH,
                          differentiable=True, stochastic=stochastic,
                          seed=SEED, light_sampler=sampler)
    loss = (rgb * torch.from_numpy(weights)).sum()
    on = [x for x in leaves if x is not None]
    got = torch.autograd.grad(loss, on, allow_unused=True)
    names = [n for n, x in zip(tscene.LEAF_NAMES, leaves) if x is not None]
    return {n: (torch.zeros_like(x) if g is None else g).numpy()
            for n, x, g in zip(names, on, got)}


@pytest.mark.parametrize("name", list(CASES))
def test_stochastic_grads_match_jax(name):
    leaves, meta, sampler, stochastic = _case(name)
    n = W * H * SAMPLES * SAMPLES
    ids = np.arange(n, dtype=np.int32)
    weights = _weights(n)
    ref = jax_nofma.grads(
        leaves, ids, weights, AMB, width=W, height=H, samples=SAMPLES,
        max_depth=DEPTH, stochastic=stochastic, seed=SEED,
        sampler=None if sampler is None else {
            k: v.numpy() for k, v in sampler.items()})
    got = _port_grads(tscene.to_torch(leaves, "cpu"), torch.from_numpy(ids),
                      weights, stochastic, sampler)
    assert sorted(got) == sorted(ref)
    gmax = max(float(np.abs(r).max(initial=0.0)) for r in ref.values())
    for leaf, g in got.items():
        r = ref[leaf]
        assert np.isfinite(g).all(), leaf
        np.testing.assert_allclose(g, r, rtol=RTOL, atol=1e-5 * gmax,
                                   err_msg=leaf)
        norm = np.linalg.norm(r)
        if norm > 1e-4 * gmax:   # leaves with a non-vanishing gradient
            assert np.linalg.norm(g - r) <= RTOL * norm, leaf
    for leaf in ("pos", "mat_kd", "light_ke", "cam_o", "cam_fovy"):
        assert np.abs(ref[leaf]).max() > 1e-3, leaf
    light_rows = slice(meta.shape_vert_offset[2], None)   # the light's verts
    moved = np.abs(ref["pos"][light_rows]).max()
    if sampler is not None:
        assert moved > 1e-3                  # through the sampled points
        assert np.abs(ref["light_pos"]).max() == 0   # no deg light
    else:
        assert moved == 0 and np.abs(ref["light_pos"]).max() > 1e-3
    if stochastic:
        for leaf in ("cam_aperture", "cam_focus"):
            assert np.abs(ref[leaf]) > 1e-3 * gmax, leaf
    else:
        assert ref["cam_aperture"] == 0
