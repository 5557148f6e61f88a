"""The port's RetinaFace trainer (``fire_tpu_torch.train.detect_retina``)
against ``fire_tpu.train.detect_retina``: targets, both score losses,
the pool step, the deploy transform, and JAX's learning smoke test.

Tolerances: classification targets and weights exactly equal; the
regression targets within 1e-6 of their magnitude (they divide by the
anchor size and take ``log``, each package's float32 ``log`` rounding
its own way); losses at rtol 1e-5; the pool step's loss at rtol 1e-4 (a
whole RetinaFace forward in float32 on both sides)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fire_tpu.models.retinaface import RetinaFace as JaxRetinaFace
from fire_tpu.ops.image import letterbox as jax_letterbox
from fire_tpu.train import detect_retina as jax_retina
from fire_tpu_torch.models.retinaface import RetinaFace, decode_retinaface
from fire_tpu_torch.ops.anchors import RETINAFACE_STRIDES
from fire_tpu_torch.ops.image import bgr_to_rgb, letterbox
from fire_tpu_torch.train import detect_retina as retina
from fire_tpu_torch.train import optim
from fire_tpu_torch.train.detect import pad_gt
from fire_tpu_torch.train.scenes import compose_scene, make_identities
from fire_tpu_torch.train.trainer import model_batch_stats
from fire_tpu_torch.weights import flax_shapes, load_flax, materialize
from tests.torch_threads import one_torch_thread  # noqa: F401

HW = (320, 320)
_jax_targets = jax.jit(jax_retina.retina_targets, static_argnums=3)


def _pad(boxes, lms, f=3):
    b, l, v = pad_gt(boxes, lms, f)
    return b[None], l[None], v[None]


def _gt_scene():
    # one small (stride-8 shapes), one mid, one large face
    boxes = np.array([[30.0, 40.0, 28.0, 32.0], [150.0, 60.0, 70.0, 80.0],
                      [60.0, 160.0, 140.0, 150.0]], np.float32)
    lms = [[[x + 0.7 * w, y + 0.35 * h], [x + 0.3 * w, y + 0.35 * h],
            [x + 0.5 * w, y + 0.55 * h], [x + 0.65 * w, y + 0.75 * h],
            [x + 0.35 * w, y + 0.75 * h]] for x, y, w, h in boxes]
    return boxes, np.asarray(lms, np.float32)


def _batch(n=4, hw=HW, seed=0):
    idents = make_identities(6, seed=seed)
    out = []
    for s in range(n):
        _, b, l = compose_scene(np.random.default_rng(seed + s), idents, hw=hw,
                                n_faces=(0, 3), face_px=(20, hw[0] // 2))
        out.append(pad_gt(b, l, 4))
    return [np.stack([o[i] for o in out]) for i in range(3)]


def test_targets_match_jax():
    args = _batch()
    ours = retina.retina_targets(*map(torch.tensor, args), HW)
    theirs = _jax_targets(*map(jnp.asarray, args), HW)
    assert sum(float(ours[st][0].sum()) for st in ours) > 10
    for st in RETINAFACE_STRIDES:
        (c, b, k, w), (jc, jb, jk, jw) = ours[st], theirs[st]
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
        for a, r in ((b, jb), (k, jk)):
            r = np.asarray(r)
            np.testing.assert_allclose(a.numpy(), r, rtol=0, atol=1e-6 * max(np.abs(r).max(), 1))


def test_targets_round_trip_through_production_decode():
    boxes, lms = _gt_scene()
    targets = retina.retina_targets(*map(torch.tensor, _pad(boxes, lms)), HW)
    heads = {}
    for st in RETINAFACE_STRIDES:
        cls_t, box_t, kps_t, _ = targets[st]
        h, w, a = cls_t.shape[1:]
        heads[st] = (cls_t * 0.99, box_t.reshape(1, h, w, 4 * a), kps_t.reshape(1, h, w, 10 * a))
    dets = decode_retinaface(heads, HW, 1.0, threshold=0.9, nms_threshold=0.4)
    m = dets.mask[0].numpy()
    got, got_lms = dets.boxes_xywh[0].numpy()[m], dets.landmarks[0].numpy()[m]
    assert got.shape[0] == 3
    for gt_box, gt_lm in zip(boxes, lms):
        k = int(np.argmin(np.abs(got[:, :2] - gt_box[:2]).sum(1)))
        # the legacy +1 pixel conventions cost about a pixel on the edges
        np.testing.assert_allclose(got[k], gt_box, atol=1.5)
        np.testing.assert_allclose(got_lms[k], gt_lm, atol=0.5)


def test_invalid_faces_produce_no_positives():
    z = [np.zeros((1, 3, 4), np.float32), np.zeros((1, 3, 5, 2), np.float32),
         np.zeros((1, 3), bool)]
    targets = retina.retina_targets(*map(torch.tensor, z), HW)
    for st in RETINAFACE_STRIDES:
        cls_t, box_t, _, wgt = targets[st]
        assert float(cls_t.sum()) == 0 and bool((box_t == 0).all()) and bool((wgt == 1).all())


@pytest.mark.parametrize("cls_loss", ["ohem", "focal"])
def test_loss_matches_jax(cls_loss):
    hw = (128, 128)
    args = _batch(n=3, hw=hw, seed=7)
    targets = retina.retina_targets(*map(torch.tensor, args), hw)
    jtargets = _jax_targets(*map(jnp.asarray, args), hw)
    rng = np.random.default_rng(8)
    heads = {}
    for st in (8, 16, 32):  # the forward's order
        b, h, w, a = targets[st][0].shape
        prob = rng.random((b, h, w, a)).astype(np.float32)
        prob[0, 0, 0] = (1.0, 0.0)  # through the clip
        heads[st] = (prob, rng.standard_normal((b, h, w, 4 * a)).astype(np.float32),
                     rng.standard_normal((b, h, w, 10 * a)).astype(np.float32))
    kw = dict(cls_loss=cls_loss, neg_pos_ratio=6.0, box_weight=2.5)
    loss, metrics = retina.retina_detection_loss(
        {st: tuple(map(torch.tensor, h)) for st, h in heads.items()}, targets, **kw)
    jloss, jmetrics = jax.jit(functools.partial(jax_retina.retina_detection_loss, **kw))(
        {st: tuple(map(jnp.asarray, h)) for st, h in heads.items()}, jtargets)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-5)


def _tiny():
    return RetinaFace(stage_sizes=(1, 1, 1, 1), width=16)


def test_pool_step_matches_jax():
    """One pool step from one state on 128² scenes (the input size, so
    the letterbox passes them through; see the BlazeFace test)."""
    hw = (128, 128)
    idents = make_identities(4, seed=9)
    scenes = [compose_scene(np.random.default_rng(s), idents, hw=hw, n_faces=(1, 2),
                            face_px=(24, 80)) for s in range(3)]
    padded = [pad_gt(b, l, 2) for _, b, l in scenes]
    pool = [np.stack([s[0].astype(np.uint8) for s in scenes])] + [
        np.stack([p[i] for p in padded]) for i in range(3)]
    idx = np.array([2, 0])
    model = _tiny()
    variables = materialize(flax_shapes(model), seed=0)
    load_flax(model, variables)
    opt = optim.adam(2e-3)
    params = list(model.parameters())
    before = params[0].detach().clone()
    step = retina.make_retina_pool_train_step(model, opt, hw)
    state, loss, metrics = step((params, model_batch_stats(model), opt.init(params)),
                                *map(torch.tensor, pool), torch.tensor(idx))
    jopt = optax.adam(2e-3)
    jstep = jax_retina.make_retina_pool_train_step(
        JaxRetinaFace(stage_sizes=(1, 1, 1, 1), width=16, dtype=jnp.float32), jopt, hw)
    _, jloss, jmetrics = jstep(
        (variables["params"], variables["batch_stats"], jopt.init(variables["params"])),
        *map(jnp.asarray, pool), jnp.asarray(idx, jnp.int32))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    assert float(metrics["n_pos"]) == pytest.approx(float(jmetrics["n_pos"]))
    assert not torch.equal(before, state[0][0])


def test_short_training_reduces_loss():
    """JAX's wiring check: a tiny RetinaFace, 25 Adam steps on one fixed
    batch of two 128² scenes, halves the loss."""
    hw = (128, 128)
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 255, (2, *hw, 3), np.uint8)
    boxes = np.array([[20.0, 30.0, 40.0, 44.0]], np.float32)
    lms = np.array([[[50, 45], [30, 45], [40, 52], [48, 62], [32, 62]]], np.float32)
    b, l, v = (np.repeat(a, 2, axis=0) for a in _pad(boxes, lms, f=1))
    model = _tiny()
    load_flax(model, materialize(flax_shapes(model), seed=0))
    opt = optim.adam(2e-3)
    params = list(model.parameters())
    state = (params, model_batch_stats(model), opt.init(params))
    step = retina.make_retina_pool_train_step(model, opt, hw)
    pool = [torch.tensor(a) for a in (imgs, b, l, v)]
    idx = torch.arange(2)
    losses = []
    for _ in range(25):
        state, loss, _ = step(state, *pool, idx)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.5, losses[::8]


def test_trainer_transform_matches_engine_and_jax():
    """Raw-pixel RGB after the bf16 letterbox, as the engine's RetinaFace
    branch (``/255``, flip, ``×255``) and JAX's step compute it."""
    frame = np.random.default_rng(4).integers(0, 255, (480, 640, 3), np.uint8)
    canvas, scale = retina.deploy_transform(torch.tensor(frame[None]), (512, 512))
    x_train = bgr_to_rgb(canvas)
    canvas_e, scale_e = letterbox(torch.tensor(frame[None]).to(torch.bfloat16), (512, 512))
    x_engine = bgr_to_rgb(canvas_e.float() / 255.0) * 255.0
    assert scale == scale_e
    torch.testing.assert_close(x_train, x_engine, rtol=0, atol=1e-4)
    jc, js = jax_letterbox(jnp.asarray(frame[None]).astype(jnp.bfloat16), (512, 512))
    assert float(js) == pytest.approx(scale)
    # the two packages' bf16 resamplers round apart by one bf16 ulp (1.0 at 128-255)
    np.testing.assert_allclose(x_train.numpy(), np.asarray(jc.astype(jnp.float32)[..., ::-1]),
                               rtol=0, atol=1.0)
