"""The port's BlazeFace trainer (``fire_tpu_torch.train.detect_blaze``)
against ``fire_tpu.train.detect_blaze``: targets, both score losses, the
pool step, the deploy transform, and JAX's learning smoke test.

Tolerances: targets exactly equal; losses at rtol 1e-5; the pool step's
loss at rtol 1e-4 (a whole BlazeFace forward in float32 on both sides)."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fire_tpu.models.blazeface import BlazeFace as JaxBlazeFace
from fire_tpu.ops.image import letterbox as jax_letterbox
from fire_tpu.train import detect_blaze as jax_blaze
from fire_tpu_torch.models.blazeface import BlazeFace, decode_blazeface
from fire_tpu_torch.ops.image import bgr_to_rgb, letterbox
from fire_tpu_torch.train import detect_blaze as blaze
from fire_tpu_torch.train import optim
from fire_tpu_torch.train.detect import pad_gt
from fire_tpu_torch.train.scenes import compose_scene, make_identities
from fire_tpu_torch.weights import flax_shapes, load_flax, materialize
from tests.torch_threads import one_torch_thread  # noqa: F401


def _pad(boxes, lms, f=2):
    b, l, v = pad_gt(boxes, lms, f)
    return b[None], l[None], v[None]


def _gt_scene():
    boxes = np.array([[20.0, 30.0, 44.0, 52.0], [78.0, 70.0, 36.0, 40.0]], np.float32)
    lms = np.stack([
        np.array([[52, 48], [32, 48], [42, 58], [50, 68], [34, 68]], np.float32),
        np.array([[106, 84], [86, 84], [96, 92], [104, 100], [88, 100]], np.float32),
    ])
    return boxes, lms


def _batch(n=6, input_px=192, seed=0):
    """Padded GT of rendered scenes scaled into an ``input_px``² input:
    faces of every size band, overlapping ones included, and empty slots."""
    idents = make_identities(6, seed=seed)
    out = []
    for s in range(n):
        _, b, l = compose_scene(np.random.default_rng(seed + s), idents, hw=(input_px, input_px),
                                n_faces=(0, 3), face_px=(20, input_px // 2))
        out.append(pad_gt(b, l, 4))
    return [np.stack([o[i] for o in out]) for i in range(3)]


@pytest.mark.parametrize("input_px", [128, 192])
def test_targets_equal_jax(input_px):
    args = _batch(input_px=input_px)
    ours = blaze.blaze_targets(*map(torch.tensor, args), input_px)
    theirs = jax_blaze.blaze_targets(*map(jnp.asarray, args), input_px)
    assert float(ours[0].sum()) > 10
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_targets_round_trip_through_production_decode():
    boxes, lms = _gt_scene()
    cls_t, reg_t, _, _ = blaze.blaze_targets(*map(torch.tensor, _pad(boxes, lms)))
    scores = torch.where(cls_t > 0, 20.0, -20.0)
    dets = decode_blazeface(scores, reg_t, 1.0, conf_threshold=0.8, nms_threshold=0.3)
    m = dets.mask[0].numpy()
    got, got_lms = dets.boxes_xywh[0].numpy()[m], dets.landmarks[0].numpy()[m]
    assert got.shape[0] == 2
    for gt_box, gt_lm in zip(boxes, lms):
        k = int(np.argmin(np.abs(got[:, :2] - gt_box[:2]).sum(1)))
        np.testing.assert_allclose(got[k], gt_box, atol=0.5)
        np.testing.assert_allclose(got_lms[k][:3], gt_lm[:3], atol=0.5)
        mouth = (gt_lm[3] + gt_lm[4]) / 2
        np.testing.assert_allclose(got_lms[k][3:], [mouth, mouth], atol=0.5)


def test_invalid_faces_produce_no_positives():
    z = [np.zeros((1, 2, 4), np.float32), np.zeros((1, 2, 5, 2), np.float32),
         np.zeros((1, 2), bool)]
    cls_t, reg_t, wgt, mask = blaze.blaze_targets(*map(torch.tensor, z))
    assert float(cls_t.sum()) == 0 and bool((reg_t == 0).all()) and bool((wgt == 1).all())
    assert mask.tolist() == [1.0] * 12 + [0.0] * 4


@pytest.mark.parametrize("cls_loss", ["ohem", "focal"])
def test_loss_matches_jax(cls_loss):
    args = _batch(n=4, input_px=128, seed=3)
    targets = blaze.blaze_targets(*map(torch.tensor, args), 128)
    jtargets = jax_blaze.blaze_targets(*map(jnp.asarray, args), 128)
    rng = np.random.default_rng(4)
    a = targets[0].shape[1]
    scores = (rng.standard_normal((4, a)) * 4).astype(np.float32)
    scores[0, :3] = (30.0, -30.0, 0.0)  # through the probability clip
    regs = (rng.standard_normal((4, a, 16)) * 10).astype(np.float32)
    kw = dict(cls_loss=cls_loss, neg_pos_ratio=5.0, box_weight=1.5)
    loss, metrics = blaze.blaze_detection_loss(torch.tensor(scores), torch.tensor(regs),
                                               targets, **kw)
    jloss, jmetrics = jax_blaze.blaze_detection_loss(jnp.asarray(scores), jnp.asarray(regs),
                                                     jtargets, **kw)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-5)


def _pool(n=4, hw=(64, 64), max_faces=2):
    idents = make_identities(4, seed=5)
    scenes = [compose_scene(np.random.default_rng(s), idents, hw=hw, n_faces=(1, max_faces),
                            face_px=(20, 40)) for s in range(n)]
    padded = [pad_gt(b, l, max_faces) for _, b, l in scenes]
    return [np.stack([s[0].astype(np.uint8) for s in scenes])] + [
        np.stack([p[i] for p in padded]) for i in range(3)]


def test_pool_step_matches_jax():
    """One pool step from one state.  The scenes are rendered at the
    64² input, so the step's letterbox passes them through: the bf16
    letterbox of the two packages differs by up to a quarter of a pixel
    level (:func:`test_trainer_transform_matches_engine_and_jax`), which
    alone moves this loss by 2e-4."""
    pool, idx = _pool(hw=(64, 64)), np.array([0, 2, 3, 1])
    model = BlazeFace()
    variables = materialize(flax_shapes(model), seed=0)
    load_flax(model, variables)
    opt = optim.adam(1e-3)
    params = list(model.parameters())
    before = params[0].detach().clone()
    step = blaze.make_blaze_pool_train_step(model, opt, input_px=64)
    state, loss, metrics = step((params, opt.init(params)), *map(torch.tensor, pool),
                                torch.tensor(idx))
    jopt = optax.adam(1e-3)
    jstep = jax_blaze.make_blaze_pool_train_step(JaxBlazeFace(dtype=jnp.float32), jopt,
                                                 input_px=64)
    _, jloss, jmetrics = jstep((variables["params"], jopt.init(variables["params"])),
                               *map(jnp.asarray, pool), jnp.asarray(idx, jnp.int32))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    assert float(metrics["n_pos"]) == pytest.approx(float(jmetrics["n_pos"]))
    assert not torch.equal(before, state[0][0])


def test_short_training_reduces_loss():
    """JAX's wiring check: 30 Adam steps on one fixed batch of four 128²
    scenes halve the loss."""
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 255, (4, 128, 128, 3), np.uint8)
    b, l, v = (np.repeat(a, 4, axis=0) for a in _pad(*_gt_scene()))
    model = BlazeFace()
    load_flax(model, materialize(flax_shapes(model), seed=0))
    opt = optim.adam(3e-3)
    params = list(model.parameters())
    state = (params, opt.init(params))
    step = blaze.make_blaze_pool_train_step(model, opt)
    pool = [torch.tensor(a) for a in (imgs, b, l, v)]
    idx = torch.arange(4)
    losses = []
    for _ in range(30):
        state, loss, _ = step(state, *pool, idx)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.5, losses[::10]


def test_trainer_transform_matches_engine_and_jax():
    """The step feeds the network what ``DeviceEngine._build_detect``
    feeds the BlazeFace slot (bf16 letterbox, RGB, /255), and what JAX's
    step feeds it."""
    frame = np.random.default_rng(3).integers(0, 255, (480, 640, 3), np.uint8)
    canvas, scale = blaze.deploy_transform(torch.tensor(frame[None]), (128, 128))
    x_train = bgr_to_rgb(canvas) / 255.0
    canvas_e, scale_e = letterbox(torch.tensor(frame[None]).to(torch.bfloat16), (128, 128))
    x_engine = bgr_to_rgb(canvas_e.float() / 255.0)
    assert scale == scale_e
    torch.testing.assert_close(x_train, x_engine, rtol=0, atol=0)
    jc, js = jax_letterbox(jnp.asarray(frame[None]).astype(jnp.bfloat16), (128, 128))
    x_jax = np.asarray(jc.astype(jnp.float32)[..., ::-1] / 255.0)
    assert float(js) == pytest.approx(scale)
    # the two packages' bf16 resamplers round apart by up to one bf16 ulp (1/255 after /255)
    np.testing.assert_allclose(x_train.numpy(), x_jax, rtol=0, atol=1.0 / 255.0 + 1e-6)
