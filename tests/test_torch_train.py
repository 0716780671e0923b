"""Port's training step (CPU) == the JAX package's ``mesh.train_step``.

One SGD step on the grad scene (16x16, 1 spp, depth 3, so the mirror bounce
carries gradients) towards a target rendered with perturbed ``mat_kd`` and
``light_ke``: the loss and every leaf of the updated scene agree with JAX's
(run in the no-FMA child process, tests/jax_nofma.py) to rtol 1e-5 and
atol 1e-7, with every float leaf trainable and with a ``trainable`` subset.
Then a few port steps on the materials and lights lower the loss.
"""

import numpy as np
import pytest
import torch

import jax_nofma
from yocto_raytracing_tpu_torch import scene as tscene
from yocto_raytracing_tpu_torch import testscenes as tts
from yocto_raytracing_tpu_torch.kernels import parity
from yocto_raytracing_tpu_torch.ops import traverse
from yocto_raytracing_tpu_torch.parallel import mesh as tmesh
from yocto_raytracing_tpu_torch.render import renderer as tren

W = H = 16
SAMPLES = 1
DEPTH = 3
LR = 0.05
AMB = np.full(3, 0.1, np.float32)
KW = dict(width=W, height=H, samples=SAMPLES, max_depth=DEPTH)


def _setup():
    leaves, _ = tscene.build_device_scene(tts.make_grad_scene())
    ts = tscene.to_torch(leaves, "cpu")
    rng = np.random.default_rng(11)
    perturbed = dict(leaves)
    perturbed["mat_kd"] = (leaves["mat_kd"] * rng.uniform(
        0.7, 1.3, leaves["mat_kd"].shape)).astype(np.float32)
    perturbed["light_ke"] = (leaves["light_ke"] * rng.uniform(
        0.7, 1.3, leaves["light_ke"].shape)).astype(np.float32)
    ids = torch.arange(W * H * SAMPLES * SAMPLES, dtype=torch.int32)
    target = tren.trace_rays(tscene.to_torch(perturbed, "cpu"), ids,
                             torch.from_numpy(AMB), W, H, SAMPLES, DEPTH)
    return leaves, ts, ids, target


@pytest.mark.parametrize("trainable", [None, ("mat_kd", "mat_ks", "light_ke",
                                              "pos", "cam_o")],
                         ids=["all", "subset"])
def test_train_step_matches_jax(trainable):
    leaves, ts, ids, target = _setup()
    ref = jax_nofma.train_step(leaves, ids.numpy(), target.numpy(), AMB, LR,
                               trainable=trainable, **KW)
    new, loss = tmesh.train_step(ts, ids, target, torch.from_numpy(AMB), LR,
                                 trainable=trainable, **KW)
    assert loss.shape == () and loss.grad_fn is None
    np.testing.assert_allclose(float(loss), float(ref["loss"]), rtol=1e-5)
    assert float(loss) > 1e-5
    moved = set()
    for name in tscene.LEAF_NAMES:
        got = getattr(new, name)
        assert got.grad_fn is None and not got.requires_grad, name
        np.testing.assert_allclose(got.numpy(), ref[name], rtol=1e-5,
                                   atol=1e-7, err_msg=name)
        if not np.array_equal(got.numpy(), leaves[name]):
            moved.add(name)
    # the input scene is left as it was
    for name in tscene.LEAF_NAMES:
        assert np.array_equal(getattr(ts, name).numpy(), leaves[name]), name
    if trainable is None:
        assert {"mat_kd", "mat_kr", "light_ke", "pos", "cam_o",
                "cam_fovy"} <= moved
        assert not moved & {"radius", "node_bbox_min", "mat_ke",
                            "cam_aperture"}
    else:
        assert moved == set(trainable)


def test_train_steps_lower_the_loss():
    _, ts, ids, target = _setup()
    amb = torch.from_numpy(AMB)
    losses = []
    for _ in range(4):
        ts, loss = tmesh.train_step(ts, ids, target, amb, LR,
                                    trainable=("mat_kd", "mat_ks",
                                               "light_ke"), **KW)
        losses.append(float(loss))
    assert all(b < a for a, b in zip(losses, losses[1:])), losses
    final = tmesh.render_loss(ts, ids, target, amb, **KW)
    assert float(final) < losses[-1]


def test_f64_reference_on_recorded_hits():
    """``parity.loss_grads`` and its f64 reference (the reference of the
    card's training check): replaying the recorded hits gives the recorded
    run's loss and gradients again, and the plain path in f64 on those hits
    is within relative L2 1e-4 of the f32 gradients, leaf by leaf
    (``cam_focus`` apart: its gradient is zero up to rounding)."""
    _, ts, ids, target = _setup()
    amb = torch.from_numpy(AMB)
    hits = []
    loss, grads = parity.loss_grads(
        ts, ids, target, amb,
        intersect=parity.recorder(traverse.intersect_scene, hits), **KW)
    # nearest + shadow queries of the camera rays and of the mirror bounce
    assert len(hits) == 4
    again, regrads = parity.loss_grads(ts, ids, target, amb,
                                       intersect=parity.replayer(hits), **KW)
    assert float(again) == float(loss)
    ref_loss, ref = parity.loss_grads(
        parity.as_dtype(ts, torch.float64), ids, target.double(),
        amb.double(), plain=True, intersect=parity.replayer(hits), **KW)
    assert ref["mat_kd"].dtype == torch.float64
    np.testing.assert_allclose(float(ref_loss), float(loss), rtol=1e-6)
    ref.pop("cam_focus")
    # the CPU's threaded scatter sums may differ in their last bits
    rep = parity.relative_errors(regrads, grads, per_element=False)
    parity.check_grads(rep, 1e-6, "replayed f32")
    rep = parity.relative_errors({k: grads[k].double() for k in ref}, ref,
                                 per_element=False)
    parity.check_grads(rep, 1e-4, "f32 vs f64 reference")
    assert rep["radius"]["norm"] == 0 and rep["radius"]["zeros_kept"]
    assert {"mat_kd", "mat_kr", "pos", "cam_o"} <= {
        k for k, r in rep.items() if r["norm"] > 0}
    with pytest.raises(ValueError, match="out of step"):
        parity.loss_grads(ts, ids[:8], target[:8], amb,
                          intersect=parity.replayer(hits), **KW)


def test_relative_errors_zero_rules():
    """Exact zeros of the reference: held element by element, or with
    ``per_element=False`` only for a leaf that is zero as a whole."""
    ref = {"a": torch.tensor([0.0, 1.0]), "b": torch.zeros(2)}
    got = {"a": torch.tensor([1e-9, 1.0]), "b": torch.tensor([0.0, 1e-9])}
    each = parity.relative_errors(got, ref)
    whole = parity.relative_errors(got, ref, per_element=False)
    assert not each["a"]["zeros_kept"] and whole["a"]["zeros_kept"]
    assert not each["b"]["zeros_kept"] and not whole["b"]["zeros_kept"]
    assert whole["a"]["rel"] == pytest.approx(1e-9)
