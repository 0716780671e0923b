"""The port's ray-sharded rendering and training (``parallel/mesh.py``)
against its one-device path and the JAX package's contracts.

* ``init_distributed``'s decision logic with ``dist.init_process_group``
  mocked (the port's tests/test_distributed.py): one process is a no-op,
  explicit arguments win over torchrun's variables, a second call is a
  no-op, the backend follows the device (NCCL on the card, with
  ``LOCAL_RANK`` as the card; gloo on the CPU) and a missing one raises;
* ``shard_rays`` covers every id once for world sizes 1-4 and raises where
  the size does not divide;
* real gloo groups of 1, 2 and 4 processes on the CPU
  (tests/torch_dist_worker.py, a free port and a timeout each): every
  rank's frame is zero outside the rows it owns, the ranks' frames sum to
  ``render_image``'s bit for bit (whole, chunked, and stochastic with area
  lights, seed 7), and that frame is within 1 u8 step of the JAX
  package's ``trace_rays`` on the same ids (tests/test_sharding.py:39-46);
* the sharded loss equals the unsharded one (rtol 1e-6), and
  ``train_step_sharded`` equals ``train_step`` (loss rtol 1e-6, leaves
  rtol 1e-5 / atol 1e-7, tests/test_sharding.py:228-241), also where one
  rank's rays reach no geometry and where one rank's autograd returns None
  for a leaf that the other reaches;
* the collectives (tests/test_sharding.py:157-225): a render issues none,
  a training step exactly one sum all_reduce for the loss and one per
  trainable leaf, in ``LEAF_NAMES`` order, and nothing else.
"""

import dataclasses
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax_nofma
import torch_dist_worker as worker
from yocto_raytracing_tpu import image as image_mod
from yocto_raytracing_tpu_torch import scene as tscene, testscenes as tts
from yocto_raytracing_tpu_torch.ops import traverse
from yocto_raytracing_tpu_torch.parallel import mesh as tmesh
from yocto_raytracing_tpu_torch.render import camera, lights
from yocto_raytracing_tpu_torch.render import renderer as tren

WORKER = os.path.abspath(worker.__file__)
SPAWN_TIMEOUT = 300.0
FLT_MAX = np.float32(3.4028235e38)


# --------------------------------------------------------------------------
# init_distributed, mocked
# --------------------------------------------------------------------------


@pytest.fixture
def init_spy(monkeypatch):
    """dist.init_process_group replaced by a spy; after it, the group
    reads as initialized with the rank it was given."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    calls = []
    state = {}

    def fake_init(backend, init_method=None, world_size=-1, rank=-1):
        calls.append(dict(backend=backend, init_method=init_method,
                          world_size=world_size, rank=rank))
        state["rank"] = max(rank, 0)

    monkeypatch.setattr(dist, "init_process_group", fake_init)
    monkeypatch.setattr(dist, "is_initialized", lambda: "rank" in state)
    monkeypatch.setattr(dist, "get_rank", lambda: state["rank"])
    return calls


def test_single_process_is_noop(init_spy):
    assert tmesh.init_distributed(device="cpu") == 0
    assert init_spy == []
    mesh = tmesh.make_ray_mesh("cpu")
    assert (mesh.world_size, mesh.rank, mesh.group) == (1, 0, None)


def test_explicit_args(init_spy, monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "8")   # explicit arguments win
    monkeypatch.setenv("RANK", "5")
    assert tmesh.init_distributed("tcp://10.0.0.1:1234", 4, 2,
                                  device="cpu") == 2
    assert init_spy == [dict(backend="gloo",
                             init_method="tcp://10.0.0.1:1234",
                             world_size=4, rank=2)]


def test_env_var_fallback(init_spy, monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "coord")
    monkeypatch.setenv("MASTER_PORT", "9999")
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("RANK", "3")
    assert tmesh.init_distributed(device="cpu") == 3
    assert init_spy == [dict(backend="gloo", init_method="env://",
                             world_size=8, rank=3)]


def test_idempotent(init_spy):
    tmesh.init_distributed("tcp://c:1", 2, 1, device="cpu")
    assert tmesh.init_distributed("tcp://c:1", 2, 1, device="cpu") == 1
    assert len(init_spy) == 1      # the second call is a no-op


def test_backend_follows_device(init_spy, monkeypatch):
    monkeypatch.setattr(dist, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match="no nccl backend"):
        tmesh.init_distributed("tcp://c:1", 2, 0, device="cuda")
    assert init_spy == []          # no quiet switch to gloo
    monkeypatch.setattr(dist, "is_nccl_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmesh.init_distributed("tcp://c:1", 2, 0, device="cuda")
    cards = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device", cards.append)
    monkeypatch.setenv("LOCAL_RANK", "3")
    tmesh.init_distributed("tcp://c:1", 8, 7, device="cuda")
    assert cards == [3]
    assert init_spy == [dict(backend="nccl", init_method="tcp://c:1",
                             world_size=8, rank=7)]


def test_parallel_exports_the_jax_names():
    from yocto_raytracing_tpu import parallel as jparallel
    from yocto_raytracing_tpu_torch import parallel as tparallel

    def public(m):
        return {n for n in vars(m) if not n.startswith("_")}

    assert public(tparallel) == public(jparallel)
    assert len(public(tparallel) - {"mesh"}) == 12


# --------------------------------------------------------------------------
# shard_rays and the world of one without a group
# --------------------------------------------------------------------------


@pytest.mark.parametrize("ws", [1, 2, 3, 4])
def test_shard_rays_covers_every_id(ws):
    ids = np.arange(ws * 6, dtype=np.int32)[::-1].copy()
    parts = [tmesh.shard_rays(ids, tmesh.RayMesh(ws, r, torch.device("cpu")))
             for r in range(ws)]
    for r, p in enumerate(parts):   # contiguous slabs of global ids
        assert p.dtype == torch.int32
        np.testing.assert_array_equal(p.numpy(), ids[r * 6:(r + 1) * 6])
    np.testing.assert_array_equal(torch.cat(parts).numpy(), ids)
    if ws > 1:
        with pytest.raises(ValueError, match="do not split"):
            tmesh.shard_rays(ids[:-1], tmesh.RayMesh(ws, 0,
                                                     torch.device("cpu")))


def _grad_scene():
    leaves, meta = tscene.build_device_scene(tts.make_grad_scene())
    return leaves, tscene.to_torch(leaves, "cpu"), meta


def test_world_of_one_without_group():
    """A plain process: every row is this rank's, no collective, and the
    frame and the step are the one-device ones bit for bit."""
    _, ts, meta = _grad_scene()
    mesh = tmesh.make_ray_mesh("cpu")
    got = tmesh.render_image_sharded(ts, meta, mesh, chunk_pixels=40,
                                     **worker.FRAME)
    np.testing.assert_array_equal(got, tren.render_image(ts, meta,
                                                         **worker.FRAME))
    ids, target = _train_batch(ts)
    amb = torch.full((3,), worker.AMB)
    a, la = tmesh.train_step(ts, ids, target, amb, worker.LR, **worker.TRAIN)
    b, lb = tmesh.train_step_sharded(ts, tmesh.shard_rays(ids, mesh),
                                     tmesh.shard_rays(target, mesh), amb,
                                     worker.LR, mesh=mesh, **worker.TRAIN)
    assert float(la) == float(lb)
    for name in tscene.LEAF_NAMES:
        np.testing.assert_array_equal(getattr(a, name).numpy(),
                                      getattr(b, name).numpy(), name)


# --------------------------------------------------------------------------
# gloo groups of 1, 2 and 4 processes
# --------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _train_batch(ts):
    """8x8 ids and a target rendered with perturbed mat_kd and light_ke."""
    w, h = worker.TRAIN["width"], worker.TRAIN["height"]
    ids = torch.arange(w * h, dtype=torch.int32)
    rng = np.random.default_rng(11)
    pert = {}
    for name in ("mat_kd", "light_ke"):
        x = getattr(ts, name)
        pert[name] = x * torch.from_numpy(rng.uniform(
            0.7, 1.3, tuple(x.shape)).astype(np.float32))
    target = tren.trace_rays(dataclasses.replace(ts, **pert), ids,
                             torch.full((3,), worker.AMB), w, h, 1,
                             worker.TRAIN["max_depth"])
    return ids, target


def _dark_batch(ts, target):
    """28 ids that hit the scene, then 28 that miss it: with two ranks,
    rank 1's rays reach no geometry."""
    w, h = worker.TRAIN["width"], worker.TRAIN["height"]
    ids = torch.arange(w * h, dtype=torch.int32)
    _, ro, rd = camera.camera_rays(ts, ids, w, h, 1)
    hit = traverse.intersect_scene(
        ts, ro.contiguous(), rd.contiguous(), torch.full((w * h,), 1e-4),
        torch.full((w * h,), float(FLT_MAX)))["hit"]
    assert int((~hit).sum()) >= 28 and int(hit.sum()) >= 28
    dark = torch.cat([ids[hit][:28], ids[~hit][:28]])
    return dark, target[dark.long()]


@pytest.fixture(scope="module")
def inputs():
    leaves, ts, meta = _grad_scene()
    ids, target = _train_batch(ts)
    dark_ids, dark_target = _dark_batch(ts, target)
    return dict(leaves=leaves, ts=ts, meta=meta, ids=ids, target=target,
                dark_ids=dark_ids, dark_target=dark_target)


@pytest.fixture(scope="module")
def world(inputs, tmp_path_factory):
    """world(ws) -> the ranks' outputs of tests/torch_dist_worker.py in a
    gloo group of ``ws`` processes (spawned once per size)."""
    done = {}

    def run(ws):
        if ws in done:
            return done[ws]
        tmp = str(tmp_path_factory.mktemp(f"world{ws}"))
        np.savez(os.path.join(tmp, "in.npz"),
                 **{k: inputs[k].numpy() for k in ("ids", "target",
                                                   "dark_ids",
                                                   "dark_target")})
        init = f"tcp://127.0.0.1:{_free_port()}"
        env = dict(os.environ, OMP_NUM_THREADS="1")
        procs = [subprocess.Popen(
            [sys.executable, WORKER, init, str(ws), str(r), tmp],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env) for r in range(ws)]
        deadline = time.monotonic() + SPAWN_TIMEOUT
        try:
            logs = [p.communicate(timeout=max(1.0, deadline
                                              - time.monotonic()))[0]
                    for p in procs]
        finally:
            for p in procs:   # a hung rank is killed, never left behind
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            assert p.returncode == 0, f"rank {r} of {ws}:\n{log}"
        ranks = []
        for r in range(ws):
            with np.load(os.path.join(tmp, f"rank{r}.npz")) as f:
                ranks.append({k: f[k] for k in f.files})
        done[ws] = ranks
        return ranks

    return run


def _owned_pixels(ws, rank, chunk_pixels=None):
    """Pixels whose rays lie in ``rank``'s slabs under JAX's chunking (the
    layouts here keep each pixel's rays on one rank)."""
    spp = worker.FRAME["samples"] ** 2
    npix = worker.FRAME["width"] * worker.FRAME["height"]
    nray = npix * spp
    pad = lambda n: -(-n // ws) * ws   # noqa: E731
    chunk = pad(nray if chunk_pixels is None
                else min(chunk_pixels * spp, nray))
    per = chunk // ws
    owner = np.zeros(-(-nray // chunk) * chunk, np.int64)
    for start in range(0, nray, chunk):
        for r in range(ws):
            owner[start + r * per:start + (r + 1) * per] = r
    owner = owner[:nray].reshape(npix, spp)
    assert (owner == owner[:, :1]).all()
    return owner[:, 0] == rank


def _area_scene():
    host = worker.area_scene()
    leaves, meta = tscene.build_device_scene(host)
    sampler = lights.build_light_sampler(host, leaves, meta, "cpu")
    return leaves, tscene.to_torch(leaves, "cpu"), meta, sampler


FRAMES = {  # worker output: (chunk_pixels, stochastic)
    "frame": (None, False), "frame_chunked": (24, False),
    "frame_stochastic": (None, True)}


def _unsharded(inputs, key):
    chunk, stochastic = FRAMES[key]
    if stochastic:
        _, ts, meta, sampler = _area_scene()
        return tren.render_image(ts, meta, stochastic=True, seed=worker.SEED,
                                 light_sampler=sampler, **worker.FRAME)
    return tren.render_image(inputs["ts"], inputs["meta"], **worker.FRAME)


@pytest.mark.parametrize("ws", [1, 2, 4])
def test_sharded_frames_bit_identical(world, inputs, ws):
    ranks = world(ws)
    for key, (chunk, _) in FRAMES.items():
        total = np.zeros_like(ranks[0][key])
        for r, out in enumerate(ranks):
            img = out[key].reshape(-1, 4)
            owned = _owned_pixels(ws, r, chunk)
            assert (img[:, 3] == 1).all()
            assert (img[~owned, :3] == 0).all(), (key, r)
            total[..., :3] += out[key][..., :3]
        total[..., 3] = 1
        want = _unsharded(inputs, key)
        np.testing.assert_array_equal(total, want, err_msg=key)
        assert want[..., :3].max() > 0.05
    # the stochastic frame is not the deterministic one
    assert np.abs(_unsharded(inputs, "frame_stochastic")
                  - _unsharded(inputs, "frame")).max() > 1e-3


@pytest.mark.parametrize("stochastic", [False, True],
                         ids=["deterministic", "stochastic"])
def test_sharded_frame_matches_jax(world, inputs, stochastic):
    """The 2-rank frame within 1 u8 step of the JAX package's radiance of
    the same ids, summed per pixel on the host."""
    ranks = world(2)
    key = "frame_stochastic" if stochastic else "frame"
    got = ranks[0][key].copy()
    got[..., :3] += ranks[1][key][..., :3]
    if stochastic:
        leaves, _, _, sampler = _area_scene()
        sampler = {k: v.numpy() for k, v in sampler.items()}
    else:
        leaves, sampler = inputs["leaves"], None
    w, h, s = (worker.FRAME[k] for k in ("width", "height", "samples"))
    spp = s * s
    rgb = jax_nofma.radiance(
        leaves, np.arange(w * h * spp, dtype=np.int32),
        np.full(3, worker.AMB, np.float32), width=w, height=h, samples=s,
        max_depth=worker.FRAME["max_depth"], stochastic=stochastic,
        seed=worker.SEED, sampler=sampler)["rgb"]
    want = np.ones((w * h, 4), np.float32)
    want[:, :3] = rgb.reshape(-1, spp, 3).sum(axis=1) / np.float32(spp)
    d = np.abs(image_mod.tonemap(got).astype(np.int32)
               - image_mod.tonemap(want.reshape(h, w, 4)))
    assert d.max() <= 1, d.max()


def _leaf_sizes(trainable=None):
    ts = _grad_scene()[1]
    return [getattr(ts, n).numel() for n in tscene.LEAF_NAMES
            if getattr(ts, n).is_floating_point()
            and (trainable is None or n in trainable)]


@pytest.mark.parametrize("ws", [1, 2, 4])
def test_collectives(world, ws):
    """Render: no collective. Training: one all_reduce (sum) of the loss,
    then one per trainable leaf in LEAF_NAMES order, nothing else."""
    sum_op = str(dist.ReduceOp.SUM)
    for out in world(ws):
        assert list(out["calls_render"]) == []
        for job, trainable in (("train", None), ("dark", None),
                               ("train_grads", worker.GRAD_TRAINABLE),
                               ("dark_grads", worker.GRAD_TRAINABLE),
                               ("unreached", ("mat_kd", "light_ke"))):
            sizes = [1] + _leaf_sizes(trainable)
            assert list(out[f"calls_{job}"]) == [f"all_reduce={len(sizes)}"]
            assert list(out[f"sizes_{job}"]) == sizes, job
            assert set(out[f"ops_{job}"]) == {sum_op}


@pytest.mark.parametrize("ws", [1, 2, 4])
def test_sharded_loss_matches_unsharded(world, inputs, ws):
    ref = tmesh.render_loss(inputs["ts"], inputs["ids"], inputs["target"],
                            torch.full((3,), worker.AMB), **worker.TRAIN)
    for out in world(ws):
        for key in ("train_loss", "train_grads_loss"):
            np.testing.assert_allclose(float(out[key]), float(ref),
                                       rtol=1e-6)
    assert float(ref) > 1e-5


@pytest.mark.parametrize("job", ["train", "dark"])
@pytest.mark.parametrize("ws", [2, 4])
def test_train_step_sharded_matches_train_step(world, inputs, ws, job):
    """``dark``: with two ranks, rank 1's rays reach no geometry."""
    ids = inputs["dark_ids" if job == "dark" else "ids"]
    target = inputs["dark_target" if job == "dark" else "target"]
    amb = torch.full((3,), worker.AMB)
    new, loss = tmesh.train_step(inputs["ts"], ids, target, amb, worker.LR,
                                 **worker.TRAIN)
    ranks = world(ws)
    for out in ranks:
        np.testing.assert_allclose(float(out[f"{job}_loss"]), float(loss),
                                   rtol=1e-6)
        for name in tscene.LEAF_NAMES:
            np.testing.assert_allclose(out[f"{job}_new_{name}"],
                                       getattr(new, name).numpy(),
                                       rtol=1e-5, atol=1e-7, err_msg=name)
            # the replicas stay equal
            np.testing.assert_array_equal(out[f"{job}_new_{name}"],
                                          ranks[0][f"{job}_new_{name}"])
    moved = [n for n in tscene.LEAF_NAMES if not np.array_equal(
        ranks[0][f"{job}_new_{n}"], inputs["leaves"][n])]
    assert {"mat_kd", "light_ke", "cam_o", "pos"} <= set(moved)


def test_loss_and_grads_sharded_returns(world, inputs):
    """(loss, grads, (diff, static)) with gradients of the trainable leaves
    only, each the global-batch gradient; ``diff - lr * grads`` rebuilt
    with ``combine_scene`` is the step."""
    trainable = worker.GRAD_TRAINABLE
    amb = torch.full((3,), worker.AMB)
    mesh = tmesh.make_ray_mesh("cpu")
    loss, grads, (diff, static) = tmesh.loss_and_grads_sharded(
        inputs["ts"], inputs["ids"], inputs["target"], amb, mesh=mesh,
        trainable=trainable, **worker.TRAIN)
    assert loss.shape == () and loss.grad_fn is None
    names = [n for n, g in zip(tscene.LEAF_NAMES, grads) if g is not None]
    assert names == list(trainable)
    assert [n for n, d in zip(tscene.LEAF_NAMES, diff)
            if d is not None] == names
    assert all((d is None) != (s is None) for d, s in zip(diff, static))
    new = tmesh.combine_scene(
        [None if d is None else d - worker.LR * g
         for d, g in zip(diff, grads)], static)
    ref, _ = tmesh.train_step(inputs["ts"], inputs["ids"], inputs["target"],
                              amb, worker.LR, trainable=trainable,
                              **worker.TRAIN)
    for name in tscene.LEAF_NAMES:
        np.testing.assert_array_equal(getattr(new, name).numpy(),
                                      getattr(ref, name).numpy(), name)
    for out in world(2):
        for name in names:
            g = grads[tscene.LEAF_NAMES.index(name)].numpy()
            np.testing.assert_allclose(out[f"train_grad_{name}"], g,
                                       rtol=1e-5, atol=1e-8, err_msg=name)


def test_leaf_unreached_on_one_rank(world, inputs):
    """Rank 1 takes the step through autograd, which returns None for
    mat_kd (zeros), rank 0 the device loop's tensor: both reduce it (no
    hang), and the mean is rank 0's gradient / 2."""
    amb = torch.full((3,), worker.AMB)
    half = len(inputs["ids"]) // 2
    _, grads, _ = tmesh.loss_and_grads_sharded(
        inputs["ts"], inputs["ids"][:half], inputs["target"][:half], amb,
        mesh=tmesh.make_ray_mesh("cpu"), trainable=("mat_kd",),
        **worker.TRAIN)
    g0 = grads[tscene.LEAF_NAMES.index("mat_kd")].numpy()
    assert np.abs(g0).max() > 0
    for out in world(2):
        np.testing.assert_allclose(out["unreached_mat_kd"],
                                   g0 * np.float32(0.5), rtol=1e-6,
                                   atol=1e-12)
