"""The camera reverses' per-ray terms, order of sums and divisors (K6 and
K9, ``render/camera.py``) against the JAX package, on the CPU.

* ``ordered_camera_sums`` of ``camera_bwd_terms_plain`` (K6) and of
  ``camera_stochastic_bwd_terms_plain`` (K9, apertures 0 and 0.3), their
  d_h and d_w taken through the port's ``camera_frame`` to ``cam_fovy``,
  ``cam_aspect`` and ``cam_focus`` as the kernels' wrappers do: within
  relative L2 error 1e-4 per camera leaf of ``jax.vjp`` of JAX
  ``eval_camera`` / ``eval_camera_dof`` (op by op, ``jax.disable_jit``),
  for numpy-seeded cotangents, at 24x24 with 2x2 samples and at ragged
  batches (not a multiple of a block's tile, and below 256 rays);
  ``cam_focus`` within 1e-5 |d cam_axes|: its sum cancels (a pinhole ray's
  direction does not depend on focus, so the pinhole's is zero up to
  rounding; at aperture 0.3 on the 24x24 frame it is -0.0116 against
  |d cam_axes| = 28.6, and JAX's own f32 value is 1.8e-4 and the port's
  3.0e-4 off their f64 reference, torch autograd in f64);
* at aperture 0, K9's 15 shared sums equal K6's on the same uv;
* ``ordered_camera_sums`` equals a step-by-step transcription of the
  kernels' reduction (a thread's rays, the warp's recursive halving with
  its lane trades, the block's warps, the last block's columns); the
  constants match ``common.cuh``; no ray gives 16 zeros;
* ``magic_divisor``: its quotients, as the kernels take them
  (``__umulhi(m, 2 n) >> l``) and as (m n) >> (31 + l), equal
  ``//`` and ``%`` on every ray id of several frame shapes, on 10^6 seeded
  ids in [0, 2^31) for those and seeded divisors, and at the edges
  (2^31 - 1, multiples of spp and their neighbours, the neighbours of
  multiples of width).
"""

import re
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from yocto_raytracing_tpu.ops import sampling as jsamp
from yocto_raytracing_tpu.render import camera as jcam
from yocto_raytracing_tpu_torch import scene as tscene, testscenes as tts
from yocto_raytracing_tpu_torch.kernels import _build
from yocto_raytracing_tpu_torch.render import camera as tcam

RTOL = 1e-4
W, H, S = 24, 24, 2
SEED = 7
LEAVES = ("cam_axes", "cam_o", "cam_fovy", "cam_aspect", "cam_focus")
# batches: the 24x24 frame at 2x2 samples, a ragged one, one below 256 rays
BATCHES = {"frame": W * H * S * S, "ragged": 1999, "small": 200}


def _scene(aperture):
    host = tts.make_grad_scene()
    host.cameras[0].aperture = aperture
    leaves, _ = tscene.build_device_scene(host)
    return tscene.to_torch(leaves, "cpu")


def _cotangents(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(n, 3)).astype(np.float32) for _ in range(2)]


def _jax_vjp(fn, ts, names, cots):
    """{leaf: gradient} of fn(camera namespace) -> (ro, rd), op by op."""
    vals = {k: jnp.asarray(getattr(ts, k).numpy()) for k in names}

    def f(*xs):
        return fn(types.SimpleNamespace(**dict(zip(names, xs))))

    with jax.disable_jit():
        _, pull = jax.vjp(f, *vals.values())
        got = pull(tuple(jnp.asarray(c) for c in cots))
    return {k: np.asarray(g) for k, g in zip(names, got)}


def _port_grads(ts, sums, names):
    """{leaf: gradient} from the 16 ordered sums, d_h and d_w through
    ``camera_frame`` by torch autograd, as ``CameraRaysFn`` hands them."""
    frame = {k: getattr(ts, k).detach().requires_grad_(True)
             for k in ("cam_fovy", "cam_aspect", "cam_focus")}
    h, w = tcam.camera_frame(types.SimpleNamespace(**frame))
    chain = torch.autograd.grad(h * sums[12] + w * sums[13]
                                + frame["cam_focus"] * sums[14],
                                list(frame.values()))
    out = dict(cam_axes=sums[0:9].reshape(3, 3), cam_o=sums[9:12],
               **dict(zip(frame, chain)))
    if "cam_aperture" in names:
        out["cam_aperture"] = sums[15]
    return {k: out[k].numpy() for k in names}


def _check(port, ref):
    for k, r in ref.items():
        if k == "cam_focus":   # a sum that cancels: held in absolute terms
            bound = 1e-5 * np.linalg.norm(ref["cam_axes"])
            assert abs(float(port[k]) - float(r)) <= bound, (k, port[k], r)
            continue
        rel = np.linalg.norm(port[k] - r) / np.linalg.norm(r)
        assert rel <= RTOL, (k, rel)


@pytest.mark.parametrize("batch", list(BATCHES))
def test_camera_bwd_sums_match_jax_vjp(batch):
    n = BATCHES[batch]
    ts = _scene(0.0)
    ids = torch.arange(n, dtype=torch.int32)
    _, uv = tcam.pixel_uv(W, H, S, ids)
    g_ro, g_rd = _cotangents(n, 1)
    h, w = tcam.camera_frame(ts)
    terms = tcam.camera_bwd_terms_plain(
        uv, torch.from_numpy(g_ro), torch.from_numpy(g_rd), ts.cam_axes,
        ts.cam_o, h, w, ts.cam_focus)
    assert terms.shape == (n, 16) and not terms[:, 15].any()
    sums = tcam.ordered_camera_sums(terms)
    ref = _jax_vjp(lambda sc: jcam.eval_camera(sc, jnp.asarray(uv.numpy())),
                   ts, LEAVES, (g_ro, g_rd))
    _check(_port_grads(ts, sums, LEAVES), ref)


@pytest.mark.parametrize("aperture", [0.0, 0.3])
@pytest.mark.parametrize("batch", list(BATCHES))
def test_camera_stochastic_bwd_sums_match_jax_vjp(batch, aperture):
    n = BATCHES[batch]
    ts = _scene(aperture)
    ids = np.arange(n, dtype=np.int32)
    g_ro, g_rd = _cotangents(n, 2)
    h, w = tcam.camera_frame(ts)
    terms = tcam.camera_stochastic_bwd_terms_plain(
        torch.from_numpy(ids), ts.cam_axes, ts.cam_o, h, w, ts.cam_focus,
        ts.cam_aperture, W, H, S, SEED, torch.from_numpy(g_ro),
        torch.from_numpy(g_rd))
    sums = tcam.ordered_camera_sums(terms)
    with jax.disable_jit():
        _, uv = jcam.pixel_uv_jittered(jnp.int32(W), jnp.int32(H),
                                       jnp.int32(S), jnp.asarray(ids),
                                       jnp.uint32(SEED))
        lens = jsamp.sample_disk(jcam.per_ray_uniform(
            jnp.uint32(SEED ^ tcam.LENS_SEED_XOR), jnp.asarray(ids),
            2))[:, :2]
    names = LEAVES + ("cam_aperture",)
    ref = _jax_vjp(lambda sc: jcam.eval_camera_dof(sc, uv, lens), ts, names,
                   (g_ro, g_rd))
    _check(_port_grads(ts, sums, names), ref)


def test_zero_aperture_shared_sums_equal_k6():
    n = BATCHES["ragged"]
    ts = _scene(0.0)
    ids = torch.arange(n, dtype=torch.int32)
    g_ro, g_rd = map(torch.from_numpy, _cotangents(n, 3))
    h, w = tcam.camera_frame(ts)
    k9 = tcam.ordered_camera_sums(tcam.camera_stochastic_bwd_terms_plain(
        ids, ts.cam_axes, ts.cam_o, h, w, ts.cam_focus, ts.cam_aperture, W,
        H, S, SEED, g_ro, g_rd))
    _, uv = tcam.pixel_uv_jittered(W, H, S, ids, SEED)
    k6 = tcam.ordered_camera_sums(tcam.camera_bwd_terms_plain(
        uv, g_ro, g_rd, ts.cam_axes, ts.cam_o, h, w, ts.cam_focus))
    assert torch.equal(k9[:15], k6[:15])
    assert k9[15] != 0


def _kernel_steps(terms):
    """The kernels' reduction (common.cuh) transcribed step by step in
    float32: per block, per thread its rays; per warp the recursive
    halving, lane by lane, with the lanes' trades; the block's warps; the
    last block's lanes and tree."""
    f = np.float32
    n = terms.shape[0]
    tile = tcam.CAM_THREADS * tcam.CAM_RAYS
    nb = max(1, -(-n // tile))
    partials = np.zeros((16, nb), f)
    lanes = np.arange(32)
    for b in range(nb):
        acc = np.zeros((tcam.CAM_THREADS, 16), f)
        for t in range(tcam.CAM_THREADS):
            for r in range(tcam.CAM_RAYS):
                k = b * tile + r * tcam.CAM_THREADS + t
                if k >= n:
                    break
                acc[t] = acc[t] + terms[k]
        warp_sums = np.zeros((tcam.CAM_THREADS // 32, 16), f)
        for wi in range(tcam.CAM_THREADS // 32):
            v = acc[32 * wi:32 * wi + 32].copy()
            for half in (8, 4, 2, 1):
                upper = (lanes & (2 * half)) != 0
                keep = np.where(upper[:, None], v[:, half:2 * half],
                                v[:, :half])
                send = np.where(upper[:, None], v[:, :half],
                                v[:, half:2 * half])
                v[:, :half] = keep + send[lanes ^ (2 * half)]
            s = v[:, 0] + v[lanes ^ 1, 0]
            warp_sums[wi] = s[0::2]
            assert np.array_equal(s[0::2], s[1::2])
        p = np.zeros(16, f)
        for wi in range(tcam.CAM_THREADS // 32):
            p = p + warp_sums[wi]
        partials[:, b] = p
    out = np.zeros(16, f)
    for c in range(16):
        t = np.zeros(32, f)
        for lane in range(32):
            for b in range(lane, nb, 32):
                t[lane] = t[lane] + partials[c, b]
        for off in (16, 8, 4, 2, 1):
            t = t + t[lanes ^ off]
        out[c] = t[0]
    return out


@pytest.mark.parametrize("n", [0, 1, 255, 2 * 256 * 8 + 1])
def test_ordered_sums_follow_the_kernel_steps(n):
    rng = np.random.default_rng(n)
    terms = (rng.normal(size=(n, 16))
             * rng.uniform(0, 1e3, size=(1, 16))).astype(np.float32)
    got = tcam.ordered_camera_sums(torch.from_numpy(terms)).numpy()
    np.testing.assert_array_equal(got.view(np.int32),
                                  _kernel_steps(terms).view(np.int32))
    if n == 0:
        assert not got.any()


def test_constants_match_the_kernels():
    text = (_build.CSRC / "common.cuh").read_text()
    for name, value in (("kCamSlots", tcam.CAM_SLOTS),
                        ("kCamThreads", tcam.CAM_THREADS),
                        ("kCamRays", tcam.CAM_RAYS)):
        m = re.search(rf"constexpr int {name} = (\d+);", text)
        assert m and int(m.group(1)) == value, name


def _device_quotient(n, d):
    """n // d as the kernels take it: __umulhi(m, 2 n) >> l (u64 here)."""
    m, l = tcam.magic_divisor(d)
    prod = np.uint64(m) * (n.astype(np.uint64) << np.uint64(1))
    return ((prod >> np.uint64(32)) >> np.uint64(l)).astype(np.int64)


def _check_divisor(n, d):
    q = _device_quotient(n, d)
    np.testing.assert_array_equal(q, n // d)
    m, l = tcam.magic_divisor(d)
    np.testing.assert_array_equal((n * m) >> (31 + l), n // d)   # < 2^63
    assert np.all((n - q * d) == n % d)


# (width, height, samples): the smoke run's frames, odd sizes, one sample,
# a sample grid larger than the frame's width
FRAMES = [(910, 512, 4), (512, 512, 4), (171, 96, 3), (24, 24, 2), (1, 1, 1),
          (7, 5, 70)]


@pytest.mark.parametrize("frame", FRAMES, ids=lambda f: "x".join(map(str, f)))
def test_magic_divisors_on_every_frame_id(frame):
    width, height, samples = frame
    spp = samples * samples
    ids = np.arange(width * height * spp, dtype=np.int64)
    pix = _device_quotient(ids, spp)
    sample = ids - pix * spp
    jj = _device_quotient(sample, samples)
    row = _device_quotient(pix, width)
    np.testing.assert_array_equal(pix, ids // spp)
    np.testing.assert_array_equal(jj, (ids % spp) // samples)
    np.testing.assert_array_equal(sample - jj * samples,
                                  (ids % spp) % samples)
    np.testing.assert_array_equal(row, pix // width)
    np.testing.assert_array_equal(pix - row * width, pix % width)


def test_magic_divisors_on_seeded_ids_and_edges():
    rng = np.random.default_rng(12)
    ids = rng.integers(0, 2 ** 31, size=10 ** 6, dtype=np.int64)
    divisors = sorted({d for w, _, s in FRAMES for d in (w, s, s * s)}
                      | set(rng.integers(1, 2 ** 31, size=8).tolist())
                      | {2 ** 31 - 1, 2 ** 30, 2 ** 30 + 1, 3, 641})
    top = 2 ** 31 - 1
    for d in divisors:
        k = np.unique(np.concatenate([
            np.arange(0, 64), (top // d - np.arange(8)).clip(0),
            rng.integers(0, top // d + 1, size=64)])) * d
        edges = np.concatenate([k - 1, k, k + 1, [0, top, top - 1]])
        edges = np.unique(edges[(edges >= 0) & (edges <= top)])
        _check_divisor(np.concatenate([ids, edges]), d)
    for bad in (0, -3, 2 ** 31):
        with pytest.raises(ValueError):
            tcam.magic_divisor(bad)
