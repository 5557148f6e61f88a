"""BlazeFace of the port vs ``fire_tpu.models.blazeface`` on the
committed weights, float32.

Tolerances: anchors exact; raw heads 1e-4 on [0, 1] inputs (scores are
pre-sigmoid logits); ``weighted_blend`` 1e-4 px; decoded boxes and
landmarks 0.5 px with the same keep order and mask; scores 1e-4.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fire_tpu.models import blazeface as JB
from fire_tpu.models.detections import Detections as JDetections
from fire_tpu.ops import boxes as JBox
from fire_tpu_torch import weights as W
from fire_tpu_torch.models import blazeface as TB
from fire_tpu_torch.models.detections import Detections
from fire_tpu_torch.models.layers import same_pad
from fire_tpu_torch.ops import boxes as TBox
from fire_tpu_torch.train.scenes import compose_scene, make_identities

WT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "weights_trained")
FILES = {128: "blazeface_synth.msgpack", 192: "blazeface192_synth.msgpack"}


def test_blocks_and_anchors_equal_jax():
    assert TB.BLAZE_BLOCKS == JB.BLAZE_BLOCKS
    for px, n in ((128, 896), (192, 2016)):
        a = TB.blaze_anchors(px)
        assert a.shape == (n, 2)
        np.testing.assert_array_equal(a, JB.blaze_anchors(px))


def _models(px):
    tree = W.read_msgpack(os.path.join(WT, FILES[px]))
    jv = {"params": jax.tree_util.tree_map(jnp.asarray, tree["params"])}
    tm = TB.BlazeFace().eval()
    W.load_into(tm, W.from_flax_blazeface(tree))
    return JB.BlazeFace(dtype=jnp.float32), jv, tm


def _canvas(px, seed, n):
    """Rendered scenes at the model's input size, RGB in [0, 1]."""
    idents = make_identities(6, seed=seed)
    rng = np.random.default_rng(seed)
    imgs = [compose_scene(rng, idents, hw=(px, px), n_faces=(1, 2), face_px=(px // 4, px // 2),
                          occlusion_prob=0.0)[0] for _ in range(n)]
    return (np.stack(imgs)[..., ::-1] / 255.0).astype(np.float32)


@pytest.mark.parametrize("px", [128, 192])
def test_heads_match_jax_on_committed_weights(px):
    jm, jv, tm = _models(px)
    x = _canvas(px, seed=px, n=2)
    js, jr = jm.apply(jv, jnp.asarray(x))
    with torch.no_grad():
        ts, tr = tm(torch.from_numpy(x))
    assert tuple(ts.shape) == js.shape and tuple(tr.shape) == jr.shape
    assert ts.dtype == tr.dtype == torch.float32
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-4)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-4)


def test_same_padding_is_one_before_two_after():
    """Stride 2, 5×5, even input: XLA's SAME pads (1, 2), not (2, 2)."""
    x = torch.arange(36, dtype=torch.float32).reshape(1, 1, 6, 6)
    p = same_pad(x, 5, 2)
    assert tuple(p.shape) == (1, 1, 9, 9)
    assert torch.equal(p[0, 0, 1:7, 1:7], x[0, 0])
    assert tuple(same_pad(x, 5, 1).shape) == (1, 1, 10, 10)  # stride 1: (2, 2)


@pytest.mark.parametrize("px,conf", [(128, 0.5), (192, 0.8), (192, 0.5)])
def test_decode_matches_jax(px, conf):
    jm, jv, tm = _models(px)
    x = _canvas(px, seed=px + 1, n=3)
    scale = 0.4  # letterbox factor: canvas px = source px × scale
    with torch.no_grad():
        ts, tr = tm(torch.from_numpy(x))
        td = TB.decode_blazeface(ts, tr, scale, conf_threshold=conf, max_faces=8, input_px=px)
    n_found = 0
    for i in range(x.shape[0]):
        js, jr = jm.apply(jv, jnp.asarray(x[i : i + 1]))
        jd = JB.decode_blazeface(js, jr, scale, conf_threshold=conf, max_faces=8, input_px=px)
        jmask = np.asarray(jd.mask)
        np.testing.assert_array_equal(td.mask[i].numpy(), jmask)
        np.testing.assert_allclose(td.boxes_xywh[i].numpy(), np.asarray(jd.boxes_xywh), atol=0.5)
        np.testing.assert_allclose(td.landmarks[i].numpy(), np.asarray(jd.landmarks), atol=0.5)
        np.testing.assert_allclose(td.scores[i].numpy(), np.asarray(jd.scores), atol=1e-4)
        n_found += int(jmask.sum())
    assert n_found >= 3  # the trained detector finds the rendered faces


def test_decode_clips_the_logit():
    """±1e4 logits must give probabilities 1 and 0, not NaN."""
    a = TB.blaze_anchors(128).shape[0]
    scores = torch.full((1, a), -1e4)
    scores[0, 10] = 1e4
    regs = torch.zeros((1, a, 16))
    regs[0, :, 2:4] = 20.0
    d = TB.decode_blazeface(scores, regs, 1.0, input_px=128)
    assert int(d.mask.sum()) == 1 and float(d.scores[0, 0]) == 1.0
    assert bool(torch.isfinite(d.boxes_xywh).all())


@pytest.mark.parametrize("seed", range(3))
def test_weighted_blend_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n, k = 40, 6
    centres = rng.uniform(20, 200, (5, 2))
    c = centres[rng.integers(0, 5, n)] + rng.normal(0, 4, (n, 2))
    wh = rng.uniform(30, 50, (n, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], 1).astype(np.float32)
    scores = rng.uniform(0.3, 1.0, n).astype(np.float32)
    payload = rng.normal(0, 1, (n, 5, 2)).astype(np.float32)
    ji, jm = JBox.nms(jnp.asarray(boxes), jnp.asarray(scores), 0.3, max_out=k, score_threshold=0.5)
    jb, jp = JBox.weighted_blend(jnp.asarray(boxes), jnp.asarray(scores), ji, jm, 0.3, 0.5,
                                 payload=jnp.asarray(payload))
    # batched: the same problem twice, the second with its rows reversed
    b2 = np.stack([boxes, boxes[::-1]])
    s2 = np.stack([scores, scores[::-1]])
    p2 = np.stack([payload, payload[::-1]])
    ti, tm = TBox.nms(torch.from_numpy(b2), torch.from_numpy(s2), 0.3, max_out=k,
                      score_threshold=0.5)
    tb, tp = TBox.weighted_blend(torch.from_numpy(b2), torch.from_numpy(s2), ti, tm, 0.3, 0.5,
                                 payload=torch.from_numpy(p2))
    np.testing.assert_array_equal(ti[0].numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tm[0].numpy(), np.asarray(jm))
    np.testing.assert_allclose(tb[0].numpy(), np.asarray(jb), atol=1e-4)
    np.testing.assert_allclose(tp[0].numpy(), np.asarray(jp), atol=1e-4)
    live = np.asarray(jm)
    np.testing.assert_allclose(tb[1].numpy()[live], np.asarray(jb)[live], atol=1e-4)
    only, none = TBox.weighted_blend(torch.from_numpy(boxes), torch.from_numpy(scores), ti[0],
                                     tm[0], 0.3, 0.5)
    assert none is None
    np.testing.assert_allclose(only.numpy(), np.asarray(jb), atol=1e-4)


def test_landmarks3_order():
    lm = np.arange(2 * 4 * 5 * 2, dtype=np.float32).reshape(2, 4, 5, 2)
    z = np.zeros((2, 4), np.float32)
    t = Detections(torch.zeros(2, 4, 4), torch.from_numpy(lm), torch.from_numpy(z),
                   torch.zeros(2, 4, dtype=torch.bool)).landmarks3
    assert tuple(t.shape) == (2, 4, 3, 2)
    for b in range(2):
        j = JDetections(jnp.zeros((4, 4)), jnp.asarray(lm[b]), jnp.asarray(z[b]),
                        jnp.zeros((4,), bool)).landmarks3
        np.testing.assert_array_equal(t[b].numpy(), np.asarray(j))
    np.testing.assert_array_equal(t[0, 0].numpy(), lm[0, 0][[1, 0, 2]])
