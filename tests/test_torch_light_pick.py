"""K8's binary-search element pick and K10's explicit f64 reverse, on the
CPU.

* ``cdf_search_plain`` (``render/lights.py``), the search written out as
  ``kernels/csrc/lights.cu::cdf_count`` runs it, equals the dense count
  ``sum(cdf[l, :] < x)`` that the plain version and the JAX package use, on
  rows with ties and zero-weight elements, ``x`` exactly on an entry and
  one ULP either side, ``r0 = 0`` and ``r0`` just below 1, a NaN weight, an
  inf weight, ``edge`` padding and a 2,048-element row (the rows are
  ``light_pick_rows.PICK_ROWS``, which the card tests run through K8 and
  K10 too);
* ``light_pick_rows.ids_for_r0``, the card tests' ray ids, reach the first
  variates they are made for;
* ``light_points_bwd_plain`` (both sums in f64, rounded once) within 1e-5
  relative L2 per leaf of torch autograd of ``sample_light_points_plain``
  and of ``jax.vjp`` of the JAX package's ``sample_light_points`` (op by
  op, ``jax.disable_jit``), which both sum in f32: on the occluded-triangle,
  polyline and mixed scenes of ``test_torch_lights.py``, a light whose
  shape has no element (``deg``), two emissive instances of one shape, and
  a 2,048-triangle lamp panel.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from light_pick_rows import (PICK_ROWS, R0_TARGETS, U, cdf_rows, ids_for_r0,
                             pcg_hash, pcg_unhash)
from test_torch_lights import (PKG, _both, _light_shape, _set_geometry,
                               mixed_scene, occluded_scene, polyline_scene)
from yocto_raytracing_tpu.render import camera as jcam
from yocto_raytracing_tpu.render import lights as jlights
from yocto_raytracing_tpu_torch import testscenes as tts
from yocto_raytracing_tpu_torch.render import camera as tcam
from yocto_raytracing_tpu_torch.render import lights as tlights

SEED = 9
BWD_RTOL = 1e-5


def _xs(cdf):
    """Per row: every entry, one ULP either side of it, ``r0 * total`` for
    r0 = 0, 2^-24, 0.5 and just below 1, and seeded variates."""
    rng = np.random.default_rng(0)
    out = []
    for row in cdf:
        r0 = np.concatenate([np.asarray([0.0, 2.0 ** -24, 0.5, U],
                                        np.float32),
                             (rng.integers(0, 1 << 24, 64)
                              * 2.0 ** -24).astype(np.float32)])
        with np.errstate(invalid="ignore", over="ignore"):
            x = np.concatenate([row, np.nextafter(row, np.float32(np.inf)),
                                np.nextafter(row, np.float32(-np.inf)),
                                r0 * row[-1]])
        out.append(x.astype(np.float32))
    return np.stack(out)


@pytest.mark.parametrize("name", list(PICK_ROWS))
def test_search_equals_dense_count(name):
    with np.errstate(invalid="ignore", over="ignore"):
        cdf = torch.from_numpy(cdf_rows(PICK_ROWS[name]))
        x = torch.from_numpy(_xs(cdf.numpy()))
    dense = (cdf[:, None, :] < x[..., None]).sum(dim=-1)
    search = tlights.cdf_search_plain(cdf, x)
    assert torch.equal(search, dense), name
    if name in ("nan_weight", "inf_weight"):
        # the NaN x of a NaN total (or of 0 * inf) counts nothing
        assert (dense[torch.isnan(x)] == 0).all()
        assert torch.isnan(x).any()


@pytest.mark.parametrize("seed", [0, 11, 2**32 - 1])
def test_ids_for_r0_reach_their_variates(seed):
    """The card tests' ray ids: ``per_ray_uniform`` gives each exactly the
    first light variate it was made for, and the inverse hash undoes the
    hash."""
    ids = ids_for_r0(seed, R0_TARGETS)
    assert (ids >= 0).all()
    ruv = tcam.per_ray_uniform((seed & tcam.U32) ^ 0x85EBCA6B,
                               torch.from_numpy(ids), 3)
    assert ruv[:, 0].tolist() == [np.float32(r) for r in R0_TARGETS]
    for x in (0, 1, 2**31, 2**32 - 1, seed & tcam.U32):
        assert pcg_unhash(pcg_hash(x)) == x


def _two_instances(pkg):
    """The occluded-triangle scene with a second emissive instance of the
    light's shape, moved and turned: two lights, one shape."""
    scene_lib, _ = PKG[pkg]
    host = occluded_scene(pkg)
    first = next(i for i in host.instances if i.name == "light")
    c, s = np.cos(0.4), np.sin(0.4)
    host.instances.append(scene_lib.HostInstance(
        name="light_b",
        axes=np.asarray([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32),
        o=np.asarray([-1.0, 0.5, 0.3], np.float32), shape=first.shape,
        material=first.material))
    scene_lib.finalize_scene(host)
    return host


def _panel(pkg):
    """The grad scene with its light a 32 x 32-cell emissive panel of 1 m
    around the light's point: 1,089 vertices, 2,048 triangles."""
    scene_lib, ts = PKG[pkg]
    host = ts.make_grad_scene()
    shp = _light_shape(host, "light")
    pos, tris = tts.panel_grid(shp.pos[0], cells=32)
    _set_geometry(shp, pos, triangles=tris)
    scene_lib.finalize_scene(host)
    return host


def _deg_last(sampler):
    """The tables, as numpy, with the last light marked as
    ``build_light_sampler`` marks a shape without elements: deg, one
    element, a row of ones."""
    s = {k: np.array(v) for k, v in sampler.items()}
    s["deg"][-1] = True
    s["cdf"][-1] = 1.0
    s["n"][-1] = 1
    return s


BWD_SCENES = {"occluded_triangle": (occluded_scene, False, 600),
              "polyline": (polyline_scene, False, 600),
              "mixed": (mixed_scene, False, 600),
              "zero_elements": (polyline_scene, True, 600),
              "two_instances_one_shape": (_two_instances, False, 600),
              "panel_2048": (_panel, False, 300)}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    nb = np.linalg.norm(b)
    return np.linalg.norm(a - b) / nb if nb else np.linalg.norm(a)


@pytest.mark.parametrize("name", list(BWD_SCENES))
def test_light_points_bwd_plain_matches_autograd_and_jax(name):
    make, deg, n = BWD_SCENES[name]
    jdev, ts, _, _, sj, st = _both(make("jax"), make("torch"))
    if deg:
        tables = _deg_last(st)
        st = {k: torch.from_numpy(v) for k, v in tables.items()}
        sj = {k: jnp.asarray(v) for k, v in tables.items()}
    nl = int(st["cdf"].shape[0])
    ids = (np.arange(n, dtype=np.int64) * 7919 % 1000003).astype(np.int32)
    g = np.random.default_rng(5).normal(size=(nl, n, 3)).astype(np.float32)
    tid, tg = torch.from_numpy(ids), torch.from_numpy(g)
    nv = ts.pos.shape[0]

    got = tlights.light_points_bwd_plain(ts, st, tid, SEED, tg, nv)
    assert all(x.dtype == torch.float32 for x in got)

    pos = ts.pos.detach().requires_grad_(True)
    lpos = ts.light_pos.detach().requires_grad_(True)
    pts = tlights.sample_light_points_plain(
        dataclasses.replace(ts, pos=pos, light_pos=lpos), st, tid, SEED)
    auto = torch.autograd.grad(pts, [pos, lpos], tg, allow_unused=True)
    auto = [torch.zeros_like(x) if a is None else a
            for a, x in zip(auto, (pos, lpos))]

    with jax.disable_jit():
        ruv = jcam.per_ray_uniform(jnp.uint32(SEED) ^ jnp.uint32(0x85EBCA6B),
                                   jnp.asarray(ids), 3)

        def points(p, lp):
            return jlights.sample_light_points(
                dataclasses.replace(jdev, pos=p, light_pos=lp), sj, ruv)

        _, vjp = jax.vjp(points, jdev.pos, jdev.light_pos)
        jgrads = vjp(jnp.asarray(g))

    for k, leaf in enumerate(("pos", "light_pos")):
        a = got[k].numpy()
        assert np.isfinite(a).all(), leaf
        assert _rel(a, auto[k].numpy()) <= BWD_RTOL, (leaf, "autograd")
        assert _rel(a, np.asarray(jgrads[k])) <= BWD_RTOL, (leaf, "jax")
    lights_deg = st["deg"].numpy()
    assert (np.abs(got[1].numpy()[lights_deg]).sum(-1) > 0).all()
    assert (got[1].numpy()[~lights_deg] == 0).all()
    if not lights_deg.all():
        assert np.abs(got[0].numpy()).sum() > 0
    if name == "two_instances_one_shape":
        assert np.array_equal(st["prim_lo"][0].numpy(),
                              st["prim_lo"][1].numpy())
    if name == "panel_2048":
        assert int(st["n"][0]) == 2048
        # the picks reach many of the panel's vertices
        assert int((np.abs(got[0].numpy()).sum(-1) > 0).sum()) > 400

