"""RetinaFace in the port against ``fire_tpu.models.retinaface`` and
``fire_tpu.ops.{anchors,boxes}`` on the CPU, float32 on both sides.

Tolerances:
* heads at reduced width (stages (1, 1, 1, 1), width 8) from the same
  random weights: 1e-4 of each head's largest magnitude, or 1e-4 where
  that is below 1;
* heads of the committed full-width weights at 256²: 1e-3 relative;
* decoded boxes and landmarks within 1e-3 px; the kept indices
  identical, including a pair of boxes at IoU exactly 0.4 (the legacy
  ``>=`` suppresses it);
* the engine's ``detect_faces`` on a rendered frame: the same dicts,
  integer boxes and landmarks within ±1.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fire_tpu.config import EngineConfig as JE
from fire_tpu.config import RecognizerConfig as JR
from fire_tpu.models.facenet import tiny_facenet as j_tiny
from fire_tpu.models.retinaface import RetinaFace as JRetinaFace
from fire_tpu.models.retinaface import decode_retinaface as j_decode
from fire_tpu.ops import anchors as JA
from fire_tpu.ops import boxes as JB
from fire_tpu.pipeline.engine import DeviceEngine as JEngine
from fire_tpu.pipeline.engine import _materialize
from fire_tpu_torch import weights as W
from fire_tpu_torch.config import EngineConfig, RecognizerConfig
from fire_tpu_torch.models.facenet import tiny_facenet
from fire_tpu_torch.models.retinaface import RetinaFace, decode_retinaface
from fire_tpu_torch.ops import anchors as TA
from fire_tpu_torch.ops import boxes as TB
from fire_tpu_torch.pipeline.engine import DeviceEngine
from fire_tpu_torch.train.scenes import compose_scene, make_identities

WT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "weights_trained",
                  "retinaface_synth.msgpack")
SMALL = dict(stage_sizes=(1, 1, 1, 1), width=8)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pair(seed, hw, **kw):
    """Flax and port RetinaFace with the same random weights: the
    random init with non-trivial BatchNorm statistics."""
    jm = JRetinaFace(dtype=jnp.float32, **kw)
    v = _materialize(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, *hw, 3))), seed)
    rng = np.random.default_rng(seed)
    v = jax.tree_util.tree_map_with_path(
        lambda p, x: np.asarray(x) + (rng.uniform(0.0, 0.5, x.shape).astype(np.float32)
                                      if p[-1].key in ("mean", "var", "scale", "bias") else 0.0),
        v)
    tm = RetinaFace(**kw).eval()
    W.load_into(tm, W.from_flax_retinaface(v))
    return jm, v, tm


def _heads(jm, v, tm, x):
    jo = jm.apply(v, jnp.asarray(x))
    with torch.no_grad():
        to = tm(torch.from_numpy(x))
    return ({s: tuple(np.asarray(a) for a in jo[s]) for s in jo},
            {s: tuple(a.numpy() for a in to[s]) for s in to})


@pytest.mark.parametrize("seed,hw", [(0, (64, 64)), (1, (96, 128)), (2, (128, 96))])
def test_heads_match_jax_reduced_width(seed, hw):
    jm, v, tm = _pair(seed, hw, **SMALL)
    # inputs in [0, 1]: random weights on raw pixels saturate the softmax,
    # where a 1e-6 relative difference in a logit of ~30 moves the probability
    x = np.random.default_rng(seed + 10).uniform(0, 1, (2, *hw, 3)).astype(np.float32)
    jo, to = _heads(jm, v, tm, x)
    assert sorted(jo) == sorted(to) == [8, 16, 32]
    for s in (8, 16, 32):
        h, w = hw[0] // s, hw[1] // s
        for a, b, c in zip(jo[s], to[s], (2, 8, 20)):
            assert a.shape == b.shape == (2, h, w, c)
            assert np.abs(a - b).max() <= 1e-4 * max(1.0, float(np.abs(a).max()))


def test_heads_match_jax_committed_weights_full_width():
    tree = W.read_msgpack(WT)
    jm = JRetinaFace(dtype=jnp.float32)
    tm = RetinaFace().eval()
    W.load_into(tm, W.from_flax_retinaface(tree))
    idents = make_identities(4, seed=3)
    x = compose_scene(np.random.default_rng(4), idents, hw=(256, 256), n_faces=(1, 2),
                      face_px=(60, 120))[0][None, :, :, ::-1].astype(np.float32)  # raw RGB
    jo, to = _heads(jm, tree, tm, np.ascontiguousarray(x))
    for s in (8, 16, 32):
        for a, b in zip(jo[s], to[s]):
            np.testing.assert_allclose(b, a, rtol=1e-3, atol=1e-3 * float(np.abs(a).max()))
    # the same heads decode to the same detections
    jd = j_decode({s: tuple(jnp.asarray(t) for t in jo[s]) for s in jo}, (256, 256), 0.5)
    td = decode_retinaface({s: tuple(torch.from_numpy(t) for t in to[s]) for s in to},
                           (256, 256), 0.5)
    np.testing.assert_array_equal(np.asarray(jd.mask), td.mask[0].numpy())
    assert np.asarray(jd.mask).any()
    np.testing.assert_allclose(td.boxes_xywh[0].numpy(), np.asarray(jd.boxes_xywh), atol=0.05)


@pytest.mark.parametrize("kernel,stride,before,after", [(7, 2, 2, 3), (3, 2, 0, 1), (1, 2, 0, 0),
                                                        (3, 1, 1, 1)])
def test_same_padding_of_the_stem_c2_and_proj(kernel, stride, before, after):
    """XLA's SAME on an even side: the stem 2 / 3, ``c2`` 0 / 1, ``proj``
    none; the max-pool pads with -inf."""
    from fire_tpu_torch.models.layers import max_pool_same, same_pad

    x = torch.arange(1, 65, dtype=torch.float32).reshape(1, 1, 8, 8)
    p = same_pad(x, kernel, stride)
    assert tuple(p.shape) == (1, 1, 8 + before + after, 8 + before + after)
    assert torch.equal(p[0, 0, before : before + 8, before : before + 8], x[0, 0])
    y = -x  # all negative: a zero pad would win the max
    jy = jax.lax.reduce_window(jnp.asarray(y.numpy()), -jnp.inf, jax.lax.max, (1, 1, 3, 3),
                               (1, 1, 2, 2), "SAME")
    np.testing.assert_array_equal(max_pool_same(y, 3, 2).numpy(), np.asarray(jy))


@pytest.mark.parametrize("stride,h,w", [(8, 4, 6), (16, 3, 2), (32, 1, 5)])
def test_anchor_tables_and_plane(stride, h, w):
    assert TA.RETINAFACE_STRIDES == JA.RETINAFACE_STRIDES
    for s in (8, 16, 32):
        np.testing.assert_array_equal(TA.RETINAFACE_ANCHORS[s], JA.RETINAFACE_ANCHORS[s])
    base = TA.RETINAFACE_ANCHORS[stride]
    np.testing.assert_array_equal(TA.anchors_plane(h, w, stride, base),
                                  JA.anchors_plane(h, w, stride, base))


def test_bbox_landmark_decode_and_clip():
    rng = np.random.default_rng(5)
    anchors = JA.anchors_plane(4, 5, 16, JA.RETINAFACE_ANCHORS[16])
    deltas = rng.normal(0, 0.5, (len(anchors), 4)).astype(np.float32)
    ldeltas = rng.normal(0, 1.0, (len(anchors), 5, 2)).astype(np.float32)
    ta = torch.from_numpy(anchors)
    jb = np.array(JA.bbox_decode(jnp.asarray(anchors), jnp.asarray(deltas)))
    tb = TA.bbox_decode(ta, torch.from_numpy(deltas)[None])[0].numpy()
    np.testing.assert_allclose(tb, jb, atol=1e-3)
    jl = np.asarray(JA.landmark_decode(jnp.asarray(anchors), jnp.asarray(ldeltas)))
    tl = TA.landmark_decode(ta, torch.from_numpy(ldeltas))
    np.testing.assert_allclose(tl.numpy(), jl, atol=1e-3)
    np.testing.assert_array_equal(
        TA.clip_boxes_xyxy(torch.from_numpy(jb), (40, 60)).numpy(),
        np.asarray(JA.clip_boxes_xyxy(jnp.asarray(jb), (40, 60))))


def test_nms_plus_one_suppresses_at_exactly_the_threshold():
    # +1 areas: a is 10×10 = 100 px, b (inside a) 8×5 = 40: IoU = 40 / 100
    boxes = np.array([[0, 0, 9, 9], [1, 1, 8, 5], [50, 50, 60, 60], [0, 0, 9, 9.5]], np.float32)
    scores = np.array([0.95, 0.93, 0.92, 0.91], np.float32)
    iou_j = np.asarray(JB.iou_matrix(jnp.asarray(boxes), jnp.asarray(boxes), plus_one=True))
    iou_t = TB.iou_matrix(torch.from_numpy(boxes), torch.from_numpy(boxes), plus_one=True).numpy()
    np.testing.assert_array_equal(iou_t, iou_j)
    assert iou_t[0, 1] == np.float32(0.4)
    for equal in (True, False):
        ji, jm = JB.nms(jnp.asarray(boxes), jnp.asarray(scores), 0.4, max_out=4,
                        score_threshold=0.5, plus_one=True, suppress_equal=equal)
        ti, tm = TB.nms(torch.from_numpy(boxes), torch.from_numpy(scores), 0.4, max_out=4,
                        score_threshold=0.5, plus_one=True, suppress_equal=equal)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(ti.numpy()[tm.numpy()], np.asarray(ji)[np.asarray(jm)])
        assert (1 in ti.numpy()[tm.numpy()]) is (not equal)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decode_matches_jax(seed):
    """Random heads with saturated (tied) scores: the same kept indices,
    boxes and landmarks within 1e-3 px, through the 256 pre-NMS top-k."""
    rng = np.random.default_rng(seed)
    hw = (128, 160)
    heads = {}
    for s in (8, 16, 32):
        h, w = hw[0] // s, hw[1] // s
        prob = rng.uniform(0.0, 1.0, (1, h, w, 2)).astype(np.float32)
        prob[prob > 0.7] = 1.0  # trained softmax scores saturate
        heads[s] = (prob, rng.normal(0, 0.3, (1, h, w, 8)).astype(np.float32),
                    rng.normal(0, 1.0, (1, h, w, 20)).astype(np.float32))
    scale = 0.625
    jd = j_decode({s: tuple(jnp.asarray(t) for t in heads[s]) for s in heads}, hw, scale,
                  threshold=0.6, nms_threshold=0.4, max_faces=16)
    td = decode_retinaface({s: tuple(torch.from_numpy(t) for t in heads[s]) for s in heads},
                           hw, scale, threshold=0.6, nms_threshold=0.4, max_faces=16)
    np.testing.assert_array_equal(td.mask[0].numpy(), np.asarray(jd.mask))
    assert 0 < int(np.asarray(jd.mask).sum())
    np.testing.assert_allclose(td.boxes_xywh[0].numpy(), np.asarray(jd.boxes_xywh), atol=1e-3)
    np.testing.assert_allclose(td.landmarks[0].numpy(), np.asarray(jd.landmarks), atol=1e-3)
    np.testing.assert_array_equal(td.scores[0].numpy(), np.asarray(jd.scores))


def test_decode_is_batched_frame_by_frame():
    jm, v, tm = _pair(3, (64, 96), **SMALL)
    x = np.random.default_rng(3).uniform(0, 255, (3, 64, 96, 3)).astype(np.float32)
    with torch.no_grad():
        heads = tm(torch.from_numpy(x))
    both = decode_retinaface(heads, (64, 96), 0.5, threshold=0.5)
    for i in range(3):
        one = decode_retinaface({s: tuple(t[i : i + 1] for t in heads[s]) for s in heads},
                                (64, 96), 0.5, threshold=0.5)
        for a, b in zip(both, one):
            assert torch.equal(a[i], b[0])


def test_engine_detect_faces_matches_jax():
    """The RetinaFace slot end to end (letterbox, raw-pixel RGB, decode):
    committed weights at full width, 256² input, a rendered frame."""
    ekw = dict(retinaface_size=(256, 256), compute_dtype="float32", strict_f32_preprocess=True)
    jcfg = JR(detector_type="retinaface", weights_dir=None, engine=JE(**ekw)).with_embedding_dim()
    jeng = JEngine(jcfg, detector=JRetinaFace(dtype=jnp.float32),
                   encoder=j_tiny(128, dtype=jnp.float32))
    jeng.load_trained_detector(WT)
    tcfg = RecognizerConfig(detector_type="retinaface", weights_dir=None,
                            engine=EngineConfig(**ekw)).with_embedding_dim()
    teng = DeviceEngine(tcfg, device="cpu", encoder=tiny_facenet(128))
    teng.load_trained_detector(WT)
    assert teng.weight_source["detector"] == f"trained:{WT}"
    frame = compose_scene(np.random.default_rng(12), make_identities(4, seed=12), hw=(240, 320),
                          n_faces=(2, 2), face_px=(80, 120), occlusion_prob=0.0)[0]
    a, b = jeng.detect_faces(frame), teng.detect_faces(frame)
    assert len(a) == len(b) >= 1
    for x, y in zip(a, b):
        assert np.abs(np.subtract(x["bbox"], y["bbox"])).max() <= 1
        assert np.abs(x["landmarks"] - y["landmarks"]).max() <= 1
        assert x["confidence"] == pytest.approx(y["confidence"], abs=1e-3)
