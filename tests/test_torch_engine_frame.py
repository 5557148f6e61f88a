"""Per-frame half of ``DeviceEngine`` vs ``fire_tpu.pipeline.engine`` on
the same frames and weights: trained YuNet at 320² or trained BlazeFace
at 128², a tiny FaceNet with shared random weights, float32, 240×320
rendered frames.

Tolerances: ``detect_faces`` gives the same number of dicts in the same
order, integer boxes and landmarks within ±1 (truncation of floats that
differ in the last bits), confidence 1e-3; embeddings of the same boxes
or landmarks have cosine ≥ 0.9999; a face's embedding does not depend
on how many other faces share the call (1e-5); extracted crops 1e-4.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fire_tpu.config import EngineConfig as JE
from fire_tpu.config import RecognizerConfig as JR
from fire_tpu.models.blazeface import BlazeFace as JBlazeFace
from fire_tpu.models.facenet import tiny_facenet as j_tiny
from fire_tpu.models.yunet import YuNet as JYuNet
from fire_tpu.pipeline.engine import DeviceEngine as JEngine
from fire_tpu_torch.config import EngineConfig, RecognizerConfig
from fire_tpu_torch.models.facenet import tiny_facenet
from fire_tpu_torch.pipeline.engine import DeviceEngine
from fire_tpu_torch.train.scenes import compose_scene, make_identities

WT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "weights_trained")
EKW = dict(detect_size=(320, 320), blazeface_size=(128, 128), compute_dtype="float32",
           strict_f32_preprocess=True)
DET = {"yunet": "yunet_synth.msgpack", "mediapipe": "blazeface_synth.msgpack"}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """These tests run beside other workers on shared cores: more
    intra-op threads than that only make them wait for each other."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def engines(detector_type):
    """(JAX engine, port engine) with the same weights."""
    jcfg = JR(detector_type=detector_type, weights_dir=None, engine=JE(**EKW)).with_embedding_dim()
    jdet = JYuNet(dtype=jnp.float32) if detector_type == "yunet" else JBlazeFace(dtype=jnp.float32)
    jeng = JEngine(jcfg, detector=jdet, encoder=j_tiny(128, dtype=jnp.float32))
    jeng.load_trained_detector(os.path.join(WT, DET[detector_type]))
    tcfg = RecognizerConfig(detector_type=detector_type,
                            engine=EngineConfig(**EKW)).with_embedding_dim()
    teng = DeviceEngine(tcfg, device="cpu", encoder=tiny_facenet(128))
    teng.load_trained_detector(os.path.join(WT, DET[detector_type]))
    teng.load_encoder_variables(jax.tree_util.tree_map(np.asarray, jeng.enc_vars), "shared random")
    return jeng, teng


@pytest.fixture(scope="module", params=["yunet", "mediapipe"])
def pair(request):
    return engines(request.param)


def scenes(seed, n, n_faces=(1, 3)):
    idents = make_identities(6, seed=seed)
    rng = np.random.default_rng(seed + 1)
    return [compose_scene(rng, idents, hw=(240, 320), n_faces=n_faces, face_px=(60, 130),
                          occlusion_prob=0.0)[0] for _ in range(n)]


def _cos(a, b):
    return (a * b).sum(1) / np.linalg.norm(a, axis=1) / np.linalg.norm(b, axis=1)


def test_detect_faces_dict_for_dict(pair):
    jeng, teng = pair
    n = 0
    for frame in scenes(40, 4):
        jd, td = jeng.detect_faces(frame), teng.detect_faces(frame)
        assert len(jd) == len(td)
        for a, b in zip(jd, td):
            assert sorted(a) == sorted(b) == ["bbox", "confidence", "landmarks"]
            assert all(isinstance(v, int) for v in b["bbox"])
            assert b["landmarks"].shape == (5, 2) and b["landmarks"].dtype == np.int32
            assert np.abs(np.subtract(a["bbox"], b["bbox"])).max() <= 1
            assert np.abs(a["landmarks"] - b["landmarks"]).max() <= 1
            assert a["confidence"] == pytest.approx(b["confidence"], abs=1e-3)
            n += 1
    assert n >= 4


def test_detect_faces_truncates():
    """``astype(int32)`` truncates toward zero; it does not round."""
    import torch

    from fire_tpu_torch.models.detections import Detections

    _, teng = engines("yunet")
    d = Detections(torch.tensor([[10.9, -0.7, 30.5, 40.99]]), torch.full((1, 5, 2), 7.9),
                   torch.tensor([0.95]), torch.tensor([True]))
    teng.detect = lambda frame: d
    (face,) = teng.detect_faces(np.zeros((8, 8, 3), np.uint8))
    assert face["bbox"] == [10, 0, 30, 40] and int(face["landmarks"][0, 0]) == 7


def test_encode_boxes_matches_and_ignores_the_pad(pair):
    jeng, teng = pair
    frame = scenes(41, 1)[0]
    boxes = np.array([[30, 40, 80, 90], [150, 60, 100, 120], [-10, 5, 70, 70],
                      [260, 180, 90, 90], [100, 100, 40, 52]], np.float32)
    j = jeng.encode_boxes(frame, boxes)      # padded to a bucket of 8
    t = teng.encode_boxes(frame, boxes)
    assert t.shape == j.shape == (5, 128) and t.dtype == np.float32
    assert _cos(j, t).min() >= 0.9999
    np.testing.assert_allclose(np.linalg.norm(t, axis=1), 1.0, atol=1e-5)
    for k in (1, 3):  # the first k rows do not depend on the rest
        np.testing.assert_allclose(teng.encode_boxes(frame, boxes[:k]), t[:k], atol=1e-5)
    assert teng.encode_boxes(frame, boxes[:0]).shape == (0, 128)


def test_encode_boxes_chunks_past_max_encode(pair):
    jeng, teng = pair
    frame = scenes(42, 1)[0]
    rng = np.random.default_rng(0)
    n = teng.cfg.engine.max_encode + 3
    boxes = np.concatenate([rng.uniform(0, 200, (n, 2)), rng.uniform(30, 100, (n, 2))], 1)
    boxes = boxes.astype(np.float32)
    t, j = teng.encode_boxes(frame, boxes), jeng.encode_boxes(frame, boxes)
    assert t.shape == (n, 128) and _cos(j, t).min() >= 0.9999


def test_encode_landmarks_matches_and_ignores_the_pad(pair):
    jeng, teng = pair
    frame = scenes(43, 1)[0]
    lms3 = np.array([[[60, 70], [95, 72], [78, 95]],
                     [[200, 100], [240, 96], [222, 130]],
                     [[5, 30], [30, 28], [15, 50]]], np.float32)  # the last hangs over the edge
    j = jeng.encode_landmarks(frame, lms3)
    t = teng.encode_landmarks(frame, lms3)
    assert t.shape == (3, 128) and _cos(j, t).min() >= 0.9999
    np.testing.assert_allclose(teng.encode_landmarks(frame, lms3[:1]), t[:1], atol=1e-5)
    assert np.isfinite(t).all()
    assert teng.encode_landmarks(frame, lms3[:0]).shape == (0, 128)


def test_encode_faces_matches(pair):
    jeng, teng = pair
    crops = np.random.default_rng(3).uniform(0, 1, (3, 160, 160, 3)).astype(np.float32)
    j, t = jeng.encode_faces(crops), teng.encode_faces(crops)
    assert t.shape == (3, 128) and _cos(j, t).min() >= 0.9999
    assert teng.encode_faces(crops[:0]).shape == (0, 128)


@pytest.mark.parametrize("align", [True, False])
def test_extract_faces_matches(pair, align):
    jeng, teng = pair
    n = 0
    for frame in scenes(44, 3):
        j, t = jeng.extract_faces(frame, align=align), teng.extract_faces(frame, align=align)
        assert len(j) == len(t)
        for a, b in zip(j, t):
            assert b.shape == (160, 160, 3) and b.dtype == np.float32
            # crops are a function of the float detections, which agree to
            # a fraction of a pixel: compare at the blur of that shift
            assert np.abs(a - b).mean() < 5e-3
            n += 1
    assert n >= 3
    assert teng.extract_faces(np.zeros((240, 320, 3), np.uint8), align=align) == []


def test_extract_faces_equal_on_equal_detections():
    """With the detections pinned, aligned and plain crops agree to 1e-4."""
    import torch

    from fire_tpu.models.detections import Detections as JD
    from fire_tpu_torch.models.detections import Detections

    jeng, teng = engines("yunet")
    frame = scenes(45, 1)[0]
    boxes = np.array([[40, 50, 90, 100], [180, 80, 70, 80]], np.float32)
    lms = np.array([[[95, 85], [60, 84], [78, 108], [62, 125], [92, 126]],
                    [[232, 110], [200, 112], [215, 130], [203, 142], [228, 141]]], np.float32)
    mask, scores = np.array([True, True]), np.array([0.9, 0.8], np.float32)
    jeng.detect = lambda f, variant="detect": JD(jnp.asarray(boxes), jnp.asarray(lms),
                                                 jnp.asarray(scores), jnp.asarray(mask))
    teng.detect = lambda f, variant="detect": Detections(
        torch.from_numpy(boxes), torch.from_numpy(lms), torch.from_numpy(scores),
        torch.from_numpy(mask))
    for align in (True, False):
        j, t = jeng.extract_faces(frame, align=align), teng.extract_faces(frame, align=align)
        assert len(j) == len(t) == 2
        np.testing.assert_allclose(np.stack(t), np.stack(j), atol=1e-4)


def test_blazeface_extract_variant_lowers_the_threshold():
    _, teng = engines("mediapipe")
    frames = scenes(46, 6, n_faces=(2, 3))
    found = {v: sum(int(teng.detect(f, variant=v).mask.sum()) for f in frames)
             for v in ("detect", "extract")}
    assert found["extract"] >= found["detect"] > 0
    kept = [float(s) for f in frames for d in [teng.detect(f, variant="extract")]
            for s in d.scores[d.mask]]
    assert min(kept) > teng.cfg.blazeface_extract_conf_threshold


def test_one_copy_serves_detect_and_encode():
    """A frame already on the device is used as it is."""
    import torch

    _, teng = engines("yunet")
    frame = scenes(47, 1)[0]
    dev = teng.to_device(frame)
    assert teng.to_device(dev) is dev
    a, b = teng.detect_faces(frame), teng.detect_faces(dev)
    assert [d["bbox"] for d in a] == [d["bbox"] for d in b]
    boxes = np.array([[30, 40, 80, 90]], np.float32)
    np.testing.assert_array_equal(teng.encode_boxes(frame, boxes), teng.encode_boxes(dev, boxes))
    assert isinstance(dev, torch.Tensor)


def test_detector_slots():
    from fire_tpu_torch.models.retinaface import RetinaFace

    cfg = RecognizerConfig(detector_type="retinaface", weights_dir=None)
    eng = DeviceEngine(cfg, device="cpu", detector=RetinaFace((1, 1, 1, 1), width=8),
                       encoder=tiny_facenet(128))
    assert isinstance(eng.detector, RetinaFace)
    assert eng._detect_input == cfg.engine.retinaface_size
    assert eng.weight_source == {"detector": "random-init", "encoder": "random-init"}
    with pytest.raises(ValueError, match="Invalid detector_type"):
        DeviceEngine(RecognizerConfig(detector_type="haar"), device="cpu")
    from fire_tpu_torch.models.blazeface import BlazeFace

    for slot in ("mediapipe", "blazeface"):
        eng = DeviceEngine(RecognizerConfig(detector_type=slot), device="cpu",
                           encoder=tiny_facenet(128))
        assert isinstance(eng.detector, BlazeFace)
        assert eng._detect_input == eng.cfg.engine.blazeface_size
        # random-init weights run (what they find is noise)
        assert eng.weight_source["detector"] == "random-init"
        found = eng.detect_faces(np.zeros((64, 64, 3), np.uint8))
        assert isinstance(found, list) and len(found) <= eng.cfg.engine.max_faces
