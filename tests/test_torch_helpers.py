"""The reference-shaped helpers of the port against the JAX package:
``utils.legacy_align`` (exactly equal), ``pipeline.factories`` (the
contract of ``tests/test_image_mode_and_cli.py`` and the same
preprocessing and embeddings as JAX's) and
``DeviceGallery.get_current_count``.

Tolerances: ``preprocess_for_encoder`` of a float image equals JAX's to
1e-6 (OpenCV's and the port's area resize sum in other orders); of a
uint8 image it is equal when the image is shrunk, and within one grey
level (1/255) where it is enlarged (OpenCV rounds its fixed-point
enlarging, the port rounds the float result half up).  ``encode`` agrees
to 1e-4 with the same tiny FaceNet weights in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fire_tpu.config import EngineConfig as JE
from fire_tpu.config import RecognizerConfig as JR
from fire_tpu.gallery.index import DeviceGallery as JGallery
from fire_tpu.models.facenet import tiny_facenet as j_tiny
from fire_tpu.pipeline import factories as JF
from fire_tpu.pipeline.engine import DeviceEngine as JEngine
from fire_tpu.utils import legacy_align as JA
from fire_tpu_torch.config import EngineConfig, RecognizerConfig
from fire_tpu_torch.gallery.index import DeviceGallery
from fire_tpu_torch.models.facenet import tiny_facenet
from fire_tpu_torch.models.yunet import YuNet
from fire_tpu_torch.pipeline import factories as TF
from fire_tpu_torch.pipeline.engine import DeviceEngine
from fire_tpu_torch.utils import legacy_align as TA

EYES = [((30, 40), (70, 50)), ((70, 50), (30, 40)), ((30, 40), (70, 40)), ((10, 80), (12, 20)),
        ((50.5, 20.25), (49.5, 60.75)), ((5, 5), (5, 5))]


@pytest.mark.parametrize("left,right", EYES)
def test_legacy_align_equal_to_jax(left, right):
    assert TA.find_euclidean_distance(left, right) == JA.find_euclidean_distance(left, right)
    assert TA.eye_angle(left, right) == JA.eye_angle(left, right)
    angle, direction = JA.eye_angle(left, right)
    for box, size in [((20, 20, 60, 60), (100, 100)), ((0, 0, 90, 70), (120, 80))]:
        assert TA.rotate_facial_area(box, angle, direction, size) == \
            JA.rotate_facial_area(box, angle, direction, size)
    img = np.random.default_rng(0).integers(0, 255, (100, 100, 3)).astype(np.uint8)
    ti, ta, td = TA.alignment_procedure(img, left, right)
    ji, ja, jd = JA.alignment_procedure(img, left, right)
    assert (ta, td) == (ja, jd)
    np.testing.assert_array_equal(ti, ji)


def test_initialize_tracker_contract():
    s = TF.initialize_tracker(device="cpu")
    j = JF.initialize_tracker()
    for cfg in (s.cfg, j.cfg):
        assert cfg.max_age == 4 and cfg.min_hits == 4 and cfg.iou_threshold == 0.3
    assert s.update([{"bbox": [10, 10, 50, 50], "confidence": 1.0}]) == []  # unconfirmed
    assert s.device.type == "cpu"


def test_initialize_detector_returns_one_engines_pair():
    detect, extract = TF.initialize_detector("YuNet", device="cpu")
    assert detect.__self__ is extract.__self__
    eng = detect.__self__
    assert isinstance(eng, DeviceEngine) and eng.cfg.detector_type == "yunet"
    assert eng.device.type == "cpu"
    for bad in ("haar", "ssd"):
        with pytest.raises(ValueError, match="Invalid detector_type"):
            TF.initialize_detector(bad, device="cpu")
        with pytest.raises(ValueError, match="Invalid detector_type"):
            JF.initialize_detector(bad)


@pytest.fixture(scope="module")
def encoders():
    """(JAX Encoder, port Encoder) on the same tiny FaceNet weights."""
    jcfg = JR(weights_dir=None, engine=JE(compute_dtype="float32")).with_embedding_dim()
    jeng = JEngine(jcfg, encoder=j_tiny(128, dtype=jnp.float32))
    tcfg = RecognizerConfig(weights_dir=None,
                            engine=EngineConfig(compute_dtype="float32")).with_embedding_dim()
    teng = DeviceEngine(tcfg, device="cpu", detector=YuNet(width=8), encoder=tiny_facenet(128))
    teng.load_encoder_variables(jax.tree_util.tree_map(np.asarray, jeng.enc_vars), "shared")
    return JF.Encoder("128", engine=jeng), TF.Encoder("128", engine=teng)


SHAPES = [(93, 71), (320, 320), (480, 400), (200, 150), (50, 300), (160, 160), (161, 400)]


@pytest.mark.parametrize("hw", SHAPES)
def test_preprocess_for_encoder_matches_jax(encoders, hw):
    je, te = encoders
    rng = np.random.default_rng(hw[0] * 1000 + hw[1])
    face = rng.integers(0, 255, (*hw, 3)).astype(np.uint8)
    got, ref = te.preprocess_for_encoder(face), je.preprocess_for_encoder(face)
    assert got.shape == ref.shape == (1, 160, 160, 3) and got.dtype == np.float32
    assert got.max() <= 1.0
    if min(hw) >= 160:  # shrunk: OpenCV's area average, rounded as OpenCV rounds
        np.testing.assert_array_equal(got, ref)
    else:
        assert np.abs(got - ref).max() <= 1.0 / 255 + 1e-7
    flt = face.astype(np.float32)
    np.testing.assert_allclose(te.preprocess_for_encoder(flt), je.preprocess_for_encoder(flt),
                               atol=1e-6)
    for bad in (face[..., 0], np.concatenate([face, face[..., :1]], axis=2)):
        with pytest.raises(ValueError, match="incorrect shape"):
            te.preprocess_for_encoder(bad)


def test_encode_matches_jax(encoders):
    je, te = encoders
    faces = np.concatenate([te.preprocess_for_encoder(
        np.random.default_rng(s).integers(0, 255, (90, 80, 3)).astype(np.uint8))
        for s in range(3)])
    got, ref = te.encode(faces), je.encode(faces)
    assert got.shape == (3, te.output_shape) == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_encoder_contract_with_a_stand_in_engine():
    """The JAX test's fake engine, as the port's engine surface."""
    import torch

    class FakeEng:
        device = torch.device("cpu")

        @staticmethod
        def encode(x):
            return torch.zeros((x.shape[0], 128))

    e = TF.Encoder("128", engine=FakeEng())
    face = np.random.default_rng(0).integers(0, 255, (93, 71, 3)).astype(np.uint8)
    pre = e.preprocess_for_encoder(face)
    assert pre.shape == (1, 160, 160, 3) and pre.dtype == np.float32 and pre.max() <= 1.0
    emb = e.encode(pre)
    assert emb.shape == (1, 128) and e.output_shape == 128 and e.input_shape == (160, 160)


def test_get_current_count_equal_to_jax():
    rng = np.random.default_rng(2)
    j, t = JGallery(16, capacity=64), DeviceGallery(16, capacity=64, device="cpu")
    assert t.get_current_count() == j.get_current_count() == 0
    for i in range(5):
        row = rng.standard_normal(16).astype(np.float32)
        j.add(row, f"id{i}", i + 1), t.add(row, f"id{i}", i + 1)
    assert t.get_current_count() == j.get_current_count() == 5 == t.count
