"""The training step's device loop (``renderer.loss_grads_device``) on the
CPU: the structure of its CUDA graph run bounce by bounce through the plain
versions, against the JAX package, the step through autograd and itself.

* Against JAX (``jax_nofma.train_step``): the grad scene (16x16, 1 spp)
  at depth 6 with every float leaf trainable, where bounces 2-5 are dead
  (the step skips them forward and back); the updated leaves and the loss
  within rtol 1e-5 / atol 1e-7. ``tests/test_torch_train.py`` holds the
  same step at depth 3, every leaf and a subset, through
  ``mesh.train_step``, which runs this loop. The step through autograd
  (``mesh._train_step_autograd``) against the same JAX result, and the
  loss bit-equal to it.
* The kept entry: a second call with the same key hits and gives the same
  bits; a leaf edited in place gives its own step (also where the edit
  kills a bounce that ran in the call before: the reverse then reads zero
  cotangents, not the last call's); a new trainable set, depth or batch is
  a miss that frees the old entry; returned tensors do not change when the
  next step runs; ``step_key`` holds no value.
* K12's out-of-place form equals the in-place one; K14's plain version
  (``bounce_update_bwd_plain``) equals torch autograd of
  ``bounce_update_plain`` on random states with dead lanes, kr of 0 and
  -0.0 and masked lanes, and its wrapper writes the same in place; on
  lanes with an infinite thr or a NaN kr both have the NaN positions and
  the finite values of ``jax.vjp`` of the JAX body's update.

About 20 s alone, most of it the JAX child:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_train_device.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import jax_nofma
from bounce_states import random_bounce
from yocto_raytracing_tpu_torch import kernels
from yocto_raytracing_tpu_torch import scene as tscene
from yocto_raytracing_tpu_torch import testscenes as tts
from yocto_raytracing_tpu_torch.parallel import mesh as tmesh
from yocto_raytracing_tpu_torch.render import renderer as tren

W = H = 16
SAMPLES = 1
LR = 0.05
AMB = np.full(3, 0.1, np.float32)
# depth and trainable set of the JAX comparison: the grad scene's mirror
# keeps bounce 1 alive; bounce 2 and later are dead
DEPTH, TRAINABLE = 6, None


def _setup():
    leaves, _ = tscene.build_device_scene(tts.make_grad_scene())
    ts = tscene.to_torch(leaves, "cpu")
    rng = np.random.default_rng(11)
    perturbed = dict(leaves)
    for name in ("mat_kd", "light_ke"):
        perturbed[name] = (leaves[name] * rng.uniform(
            0.7, 1.3, leaves[name].shape)).astype(np.float32)
    ids = torch.arange(W * H * SAMPLES * SAMPLES, dtype=torch.int32)
    target = tren.trace_rays(tscene.to_torch(perturbed, "cpu"), ids,
                             torch.from_numpy(AMB), W, H, SAMPLES, 3)
    return leaves, ts, ids, target


@pytest.fixture(scope="module")
def jax_step():
    leaves, _, ids, target = _setup()
    return jax_nofma.train_step(leaves, ids.numpy(), target.numpy(), AMB,
                                LR, trainable=TRAINABLE, width=W, height=H,
                                samples=SAMPLES, max_depth=DEPTH)


def _kw(depth):
    return dict(width=W, height=H, samples=SAMPLES, max_depth=depth)


def _check_against(new, loss, ref, leaves, trainable):
    np.testing.assert_allclose(float(loss), float(ref["loss"]), rtol=1e-5)
    moved = set()
    for name in tscene.LEAF_NAMES:
        got = getattr(new, name).numpy()
        np.testing.assert_allclose(got, ref[name], rtol=1e-5, atol=1e-7,
                                   err_msg=name)
        if not np.array_equal(got, leaves[name]):
            moved.add(name)
    if trainable is not None:
        assert moved == set(trainable)
    else:
        assert {"mat_kd", "mat_kr", "light_ke", "pos", "cam_o",
                "cam_fovy"} <= moved


def test_device_step_matches_jax(jax_step):
    depth, trainable = DEPTH, TRAINABLE
    leaves, ts, ids, target = _setup()
    loss, out = tren.loss_grads_device(
        ts, ids, target, torch.from_numpy(AMB), W, H, SAMPLES, depth,
        trainable=trainable, lr=LR)
    trained = tren.trained_leaves(ts, trainable)
    assert [n for n, x in zip(tscene.LEAF_NAMES, out)
            if x is not None] == list(trained)
    _, static = tmesh.partition_scene(ts, trainable)
    new = tmesh.combine_scene(out, static)
    assert loss.shape == () and float(loss) > 1e-5
    _check_against(new, loss, jax_step, leaves, trainable)
    # bounces 0 and 1 ran (the mirror), the rest were skipped both ways
    ran = kernels.last_step()["ran"].tolist()
    assert ran == [1, 1] + [0] * (depth - 1)
    # the input scene is left as it was
    for name in tscene.LEAF_NAMES:
        assert np.array_equal(getattr(ts, name).numpy(), leaves[name]), name


def test_autograd_step_matches_jax(jax_step):
    """``_train_step_autograd`` (the eager loop under autograd) against the
    same JAX result, and the device loop's loss bit-equal to it."""
    depth, trainable = DEPTH, TRAINABLE
    leaves, ts, ids, target = _setup()
    amb = torch.from_numpy(AMB)
    new, loss = tmesh._train_step_autograd(ts, ids, target, amb, LR,
                                           trainable=trainable, **_kw(depth))
    _check_against(new, loss, jax_step, leaves, trainable)
    _, loss_dev = tmesh.train_step(ts, ids, target, amb, LR,
                                   trainable=trainable, **_kw(depth))
    assert float(loss_dev) == float(loss)


def _step(ts, ids, target, depth=3, trainable=None, lr=None):
    loss, out = tren.loss_grads_device(ts, ids, target,
                                       torch.from_numpy(AMB), W, H, SAMPLES,
                                       depth, trainable=trainable, lr=lr)
    return loss, {n: x for n, x in zip(tscene.LEAF_NAMES, out)
                  if x is not None}


def _autograd_grads(ts, ids, target, depth=3, trainable=None):
    diff, static = tmesh.partition_scene(ts, trainable)
    loss, grads = tmesh._loss_and_grads_autograd(
        diff, static, ids, target, torch.from_numpy(AMB), _kw(depth))
    return loss, {n: g for n, g in zip(tscene.LEAF_NAMES, grads)
                  if g is not None}


def _assert_close_grads(got, want):
    assert got.keys() == want.keys()
    for name in got:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=1e-9, err_msg=name)


def test_second_call_hits_with_the_same_bits():
    _, ts, ids, target = _setup()
    loss1, g1 = _step(ts, ids, target)
    assert kernels.last_step()["cache_hit"] is False
    loss2, g2 = _step(ts, ids, target)
    assert kernels.last_step()["cache_hit"] is True
    assert len(tren._steps) == 1
    assert torch.equal(loss1, loss2)
    for name in g1:
        assert torch.equal(g1[name], g2[name]), name
    want_loss, want = _autograd_grads(ts, ids, target)
    assert float(loss1) == float(want_loss)
    _assert_close_grads(g1, want)


@pytest.mark.parametrize("edit", ["kd_halved", "mirror_off"])
def test_leaf_edited_in_place_gives_its_own_step(edit):
    """A hit after an edit in place is the edited scene's step. With the
    mirror's kr set to 0 the call before ran bounce 1 and this one does
    not: bounce 0's reverse reads zero cotangents from it."""
    _, ts, ids, target = _setup()
    loss1, g1 = _step(ts, ids, target)
    assert kernels.last_step()["ran"].tolist()[:2] == [1, 1]
    if edit == "kd_halved":
        ts.mat_kd.mul_(0.5)
    else:
        ts.mat_kr.zero_()
    loss2, g2 = _step(ts, ids, target)
    assert kernels.last_step()["cache_hit"] is True
    if edit == "mirror_off":
        assert kernels.last_step()["ran"].tolist() == [1, 0, 0, 0]
    want_loss, want = _autograd_grads(ts, ids, target)
    assert float(loss2) == float(want_loss) != float(loss1)
    _assert_close_grads(g2, want)


@pytest.mark.parametrize("change", ["trainable", "depth", "batch", "update"])
def test_a_new_key_is_a_miss_and_frees_the_entry(change):
    _, ts, ids, target = _setup()
    _step(ts, ids, target)
    old = next(iter(tren._steps.values()))
    kw = dict(depth=3, trainable=None, lr=None)
    if change == "trainable":
        kw["trainable"] = ("mat_kd",)
    elif change == "depth":
        kw["depth"] = 4
    elif change == "update":
        kw["lr"] = LR
    else:
        ids, target = ids[:128], target[:128]
    loss, got = _step(ts, ids, target, **kw)
    assert kernels.last_step()["cache_hit"] is False
    assert len(tren._steps) == 1 and next(iter(tren._steps.values())) is not old
    if change == "trainable":
        assert list(got) == ["mat_kd"]
    diff, static = tmesh.partition_scene(ts, kw["trainable"])
    want_loss, want = tmesh._loss_and_grads_autograd(
        diff, static, ids, target, torch.from_numpy(AMB), _kw(kw["depth"]))
    assert float(loss) == float(want_loss)
    if change != "update":
        _assert_close_grads(got, {n: g for n, g in zip(tscene.LEAF_NAMES,
                                                       want)
                                  if g is not None})


def test_returned_tensors_do_not_change_on_the_next_step():
    _, ts, ids, target = _setup()
    amb = torch.from_numpy(AMB)
    new1, loss1 = tmesh.train_step(ts, ids, target, amb, LR, **_kw(3))
    kept = {n: getattr(new1, n).clone() for n in tscene.LEAF_NAMES}
    loss_kept = loss1.clone()
    new2, loss2 = tmesh.train_step(new1, ids, target, amb, LR, **_kw(3))
    assert kernels.last_step()["cache_hit"] is True
    assert float(loss2) < float(loss1)
    for n in tscene.LEAF_NAMES:
        assert torch.equal(getattr(new1, n), kept[n]), n
    assert torch.equal(loss1, loss_kept)
    # trained leaves are new tensors; static ones are the caller's own
    assert new2.mat_kd.data_ptr() != new1.mat_kd.data_ptr()
    assert new2.prim_v is ts.prim_v


def test_step_key_holds_no_value():
    _, ts, _, _ = _setup()
    other = dataclasses.replace(ts, mat_kd=torch.rand_like(ts.mat_kd),
                                cam_o=torch.rand_like(ts.cam_o))
    args = (256, W, H, SAMPLES, 3, True, True)
    assert tren.step_key(ts, *args, None, True) == tren.step_key(
        other, *args, None, True)
    assert tren.step_key(ts, *args, None, True) != tren.step_key(
        ts, *args, None, False)
    assert tren.step_key(ts, *args, None, True) == tren.step_key(
        ts, *args, tren.trained_leaves(ts), True)
    assert tren.step_key(ts, *args, ("mat_kd", "prim_v"), True)[8] == (
        "mat_kd",)


@pytest.mark.parametrize("seed", [0, 1])
def test_bounce_update_out_equals_in_place(seed):
    acc, thr, color, kr, p, refl, mask = (torch.from_numpy(a)
                                          for a in random_bounce(seed))
    n = acc.shape[0]

    def state():
        return [acc.clone(), torch.full((n, 3), 7.0),
                torch.full((n, 3), 7.0), torch.zeros(n)]

    a_in, ro_in, rd_in, tmax_in = state()
    thr_in = thr.clone()
    alive = torch.tensor([1, 0], dtype=torch.int32)
    tren.bounce_update(a_in, thr_in, ro_in, rd_in, tmax_in, color, kr, p,
                       refl, mask, alive[0:1], alive[1:2])
    a_out, ro_out, rd_out, tmax_out = state()
    thr_out = torch.full((n, 3), 5.0)
    words = torch.tensor([1, 0], dtype=torch.int32)
    tren.bounce_update_out(a_out, thr, thr_out, ro_out, rd_out, tmax_out,
                           color, kr, p, refl, mask, words[0:1], words[1:2])
    for a, b in ((a_in, a_out), (thr_in, thr_out), (ro_in, ro_out),
                 (rd_in, rd_out), (tmax_in, tmax_out)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert torch.equal(thr, torch.from_numpy(random_bounce(seed)[1]))
    assert words.tolist() == alive.tolist() == [1, 1]


def _finite_bounce(seed, n=4096):
    """``random_bounce`` with its NaN kr and colors and infinite thr
    replaced by finite values (torch autograd multiplies a lane's zero
    cotangent by them), keeping dead lanes, kr of 0 and -0.0 and masked
    lanes."""
    acc, thr, color, kr, _, _, mask = random_bounce(seed, n)
    rng = np.random.default_rng(seed + 100)
    kr = np.where(np.isnan(kr), np.float32(0.25), kr)
    color = np.where(np.isnan(color), np.float32(0.5), color)
    thr = np.where(np.isinf(thr), np.float32(2.0), thr)
    cots = [rng.normal(size=(n, 3)).astype(np.float32) for _ in range(4)]
    return acc, thr, color, kr, mask, cots


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bounce_update_bwd_plain_is_autograd(seed):
    acc, thr, color, kr, mask, cots = _finite_bounce(seed)
    rng = np.random.default_rng(seed)
    p = rng.normal(size=acc.shape).astype(np.float32)
    refl = rng.normal(size=acc.shape).astype(np.float32)
    assert (np.signbit(kr) & (kr == 0)).any() and (kr == 0).any()
    assert 0 < mask.sum() < len(mask)
    leaves = [torch.from_numpy(x).requires_grad_(True)
              for x in (thr, color, kr, p, refl)]
    mask_t = torch.from_numpy(mask)
    out = tren.bounce_update_plain(torch.from_numpy(acc), leaves[0],
                                   leaves[1], leaves[2], leaves[3],
                                   leaves[4], mask_t)
    g_acc, g_thr, g_ro, g_rd = (torch.from_numpy(c) for c in cots)
    want = torch.autograd.grad(out[:4], leaves, (g_acc, g_thr, g_ro, g_rd))
    g_color, g_kr, g_p, g_refl, g_thr_k = tren.bounce_update_bwd_plain(
        g_acc, g_thr, g_ro, g_rd, *(torch.from_numpy(x)
                                    for x in (thr, color, kr)), mask_t)
    for name, got, w in (("thr", g_thr_k, want[0]), ("color", g_color,
                                                     want[1]),
                         ("kr", g_kr, want[2]), ("p", g_p, want[3]),
                         ("refl_dir", g_refl, want[4])):
        assert torch.equal(got, w), name   # -0.0 == 0.0
    cont = mask_t & (torch.from_numpy(kr) > 0).any(-1)
    assert 0 < int(cont.sum()) < int(mask_t.sum())
    # the wrapper: the four cotangents written, g_thr overwritten
    bufs = [torch.full((len(mask), 3), 9.0) for _ in range(4)]
    carry = g_thr.clone()
    tren.bounce_update_bwd(g_acc, carry, g_ro, g_rd, *(
        torch.from_numpy(x) for x in (thr, color, kr)), mask_t, bufs)
    for got, w in zip((*bufs, carry), (g_color, g_kr, g_p, g_refl, g_thr_k)):
        assert torch.equal(got.view(torch.int32), w.view(torch.int32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bounce_update_bwd_finite_lanes_keep_their_values(seed):
    """On finite states, selecting the cotangent before the products (as
    JAX's transpose does) gives the values of selecting after them: only
    the sign of a zero may differ, so a step's gradients keep their
    values."""
    acc, thr, color, kr, mask, cots = _finite_bounce(seed)
    g_acc, g_thr, g_ro, g_rd = (torch.from_numpy(c) for c in cots)
    thr_t, color_t, kr_t = (torch.from_numpy(x) for x in (thr, color, kr))
    mask_t = torch.from_numpy(mask)
    got = tren.bounce_update_bwd_plain(g_acc, g_thr, g_ro, g_rd, thr_t,
                                       color_t, kr_t, mask_t)
    cont = (mask_t & (kr_t > 0).any(dim=-1))[:, None]
    after = (g_acc * thr_t, torch.where(cont, g_thr * thr_t, 0.0),
             torch.where(cont, g_ro, 0.0), torch.where(cont, g_rd, 0.0),
             g_acc * color_t + torch.where(cont, g_thr * kr_t, g_thr))
    for name, a, b in zip(("color", "kr", "p", "refl_dir", "thr"), got,
                          after):
        assert torch.equal(a, b), name   # -0.0 == 0.0


def _jax_update_vjp(acc, thr, color, kr, p, refl, mask, cots):
    """``jax.vjp`` of the JAX depth loop body's state update: a
    transcription of JAX ``render/renderer.py:297-304`` (acc, cont, thr,
    the next ray), since the body is a closure inside ``trace_rays`` that
    no state reaches, run op by op (``jax.disable_jit``). Returns the
    cotangents of thr, color, kr, p and refl_dir for the cotangents
    ``cots`` of the next acc, thr, ro and rd."""
    m = jnp.asarray(mask)

    def update(thr, color, kr, p, refl_dir):
        acc2 = jnp.asarray(acc) + thr * color
        cont = m & jnp.any(kr > 0, axis=-1)
        thr2 = jnp.where(cont[:, None], thr * kr, thr)
        p2 = jnp.where(cont[:, None], p, 0.0)
        rd2 = jnp.where(cont[:, None], refl_dir, 1.0)
        return acc2, thr2, p2, rd2

    with jax.disable_jit():
        _, vjp = jax.vjp(update, *(jnp.asarray(x)
                                   for x in (thr, color, kr, p, refl)))
        return [np.asarray(g) for g in vjp(tuple(jnp.asarray(c)
                                                 for c in cots))]


def _port_update_grads(acc, thr, color, kr, p, refl, mask, cots):
    """The same cotangents from the port: ``bounce_update_bwd_plain`` and
    torch autograd of ``bounce_update_plain``, each in JAX's order."""
    g_acc, g_thr, g_ro, g_rd = (torch.from_numpy(c) for c in cots)
    mask_t = torch.from_numpy(mask)
    g_color, g_kr, g_p, g_refl, g_thr_k = tren.bounce_update_bwd_plain(
        g_acc, g_thr, g_ro, g_rd, *(torch.from_numpy(x)
                                    for x in (thr, color, kr)), mask_t)
    leaves = [torch.from_numpy(x).requires_grad_(True)
              for x in (thr, color, kr, p, refl)]
    out = tren.bounce_update_plain(torch.from_numpy(acc), *leaves, mask_t)
    auto = torch.autograd.grad(out[:4], leaves, (g_acc, g_thr, g_ro, g_rd))
    return ([t.numpy() for t in (g_thr_k, g_color, g_kr, g_p, g_refl)],
            [t.numpy() for t in auto])


def _same_values(got, want, name):
    """NaN where ``want`` is NaN, and equal finite and infinite values
    elsewhere (-0.0 == 0.0)."""
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan), name
    assert np.array_equal(got[~nan], want[~nan]), name


NAMES = ("thr", "color", "kr", "p", "refl_dir")


def test_bounce_update_bwd_where_autograd_makes_nan():
    """On a lane that does not go on, JAX's transpose multiplies the
    selected zero cotangent by thr and by kr, so an infinite thr or a NaN
    kr makes NaN there: the lane of thr [inf, 1, 1], kr [nan, 0, 0], mask
    true and unit cotangents gets g_thr [nan, 2, 2] and g_kr [nan, 0, 0]
    from ``jax.vjp``. K14's plain version and torch autograd of
    ``bounce_update_plain`` give the same."""
    ones = np.ones((1, 3), np.float32)
    thr = np.array([[np.inf, 1.0, 1.0]], np.float32)
    kr = np.array([[np.nan, 0.0, 0.0]], np.float32)
    state = (ones, thr, ones, kr, ones, ones, np.array([True]))
    cots = [ones] * 4
    want = _jax_update_vjp(*state, cots)
    assert np.isnan(want[0][0, 0]) and list(want[0][0, 1:]) == [2.0, 2.0]
    assert np.isnan(want[2][0, 0]) and list(want[2][0, 1:]) == [0.0, 0.0]
    plain, auto = _port_update_grads(*state, cots)
    for name, a, b, w in zip(NAMES, plain, auto, want):
        _same_values(a, w, "plain " + name)
        _same_values(b, w, "autograd " + name)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bounce_update_bwd_nonfinite_is_jax(seed):
    """On random states with infinite throughputs, NaN kr and NaN colors
    (``random_bounce``) and normal cotangents: K14's plain version and
    torch autograd of ``bounce_update_plain`` have JAX's NaN positions and
    its finite values, and the dead lanes do make NaN."""
    state = random_bounce(seed, 2048)
    acc, thr, color, kr, p, refl, mask = state
    rng = np.random.default_rng(seed + 200)
    cots = [rng.normal(size=acc.shape).astype(np.float32) for _ in range(4)]
    want = _jax_update_vjp(*state, cots)
    cont = mask & (kr > 0).any(-1)
    assert np.isnan(want[2][~cont]).any() and np.isinf(thr[~cont]).any()
    plain, auto = _port_update_grads(*state, cots)
    for name, a, b, w in zip(NAMES, plain, auto, want):
        _same_values(a, w, "plain " + name)
        _same_values(b, w, "autograd " + name)
