"""Random-init engines and the params cache against the JAX engine.

* ``materialize(flax_shapes(module), seed)`` is bitwise equal to
  ``_materialize(jax.eval_shape(init), seed)`` for every model family at
  full width (FaceNet-128 and -512, YuNet, BlazeFace at 128² and 192²,
  RetinaFace), seeds 0 and 1: one missed leaf name or one transposed
  draw gives other weights that still look plausible, so only a bitwise
  test catches it.
* The msgpack writer gives the bytes of ``flax.serialization.to_bytes``.
* A params cache written by the JAX engine loads in the port, and the
  port's loads in ``flax.serialization.from_bytes``; an unreadable cache
  is regenerated with a warning.
* A random-init engine embeds a frame as the JAX one does (tiny models,
  float32, cosine ≥ 0.9999).
"""

import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax.traverse_util import flatten_dict

from fire_tpu.config import EngineConfig as JE
from fire_tpu.config import RecognizerConfig as JR
from fire_tpu.models.blazeface import BlazeFace as JBlazeFace
from fire_tpu.models.facenet import FaceNet as JFaceNet
from fire_tpu.models.facenet import tiny_facenet as j_tiny
from fire_tpu.models.retinaface import RetinaFace as JRetinaFace
from fire_tpu.models.yunet import YuNet as JYuNet
from fire_tpu.pipeline.engine import DeviceEngine as JEngine
from fire_tpu.pipeline.engine import _materialize
from fire_tpu_torch import weights as W
from fire_tpu_torch.config import EngineConfig, RecognizerConfig
from fire_tpu_torch.models.blazeface import BlazeFace
from fire_tpu_torch.models.facenet import FaceNet, tiny_facenet
from fire_tpu_torch.models.retinaface import RetinaFace
from fire_tpu_torch.models.yunet import YuNet
from fire_tpu_torch.pipeline.engine import DeviceEngine
from fire_tpu_torch.train.scenes import compose_scene, make_identities

# family → (Flax module, its init input size, port module, FaceNet's scale-less BatchNorm)
FAMILIES = {
    "facenet128": (lambda: JFaceNet(embed_dim=128), 160, lambda: FaceNet(128), True),
    "facenet512": (lambda: JFaceNet(embed_dim=512), 160, lambda: FaceNet(512), True),
    "yunet": (JYuNet, 640, YuNet, False),
    "blazeface128": (JBlazeFace, 128, BlazeFace, False),
    "blazeface192": (JBlazeFace, 192, BlazeFace, False),
    "retinaface": (JRetinaFace, 512, RetinaFace, False),
}


def _shapes(family):
    jmod, px, tmod, unit = FAMILIES[family]
    jshapes = jax.eval_shape(jmod().init, jax.random.PRNGKey(0), jnp.zeros((1, px, px, 3)))
    return jshapes, W.flax_shapes(tmod(), unit_bn_scale=unit)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_flax_shapes_equal_eval_shape(family):
    jshapes, tshapes = _shapes(family)
    j = {k: (tuple(v.shape), np.dtype(v.dtype)) for k, v in flatten_dict(jshapes).items()}
    t = {k: (v.shape, v.dtype) for k, v in W.flatten(tshapes).items()}
    assert j == t
    assert set(tshapes) == set(jshapes)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_materialize_bitwise_equal_at_full_width(family, seed):
    jshapes, tshapes = _shapes(family)
    a = {k: np.asarray(v) for k, v in flatten_dict(_materialize(jshapes, seed)).items()}
    b = W.flatten(W.materialize(tshapes, seed))
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert np.array_equal(a[k].view(np.uint32), b[k].view(np.uint32)), k
    # the port's converter takes the tree whole: nothing left over or missing
    _, _, tmod, unit = FAMILIES[family]
    convert = W.from_flax_facenet if unit else W.from_flax_yunet
    W.load_into(tmod(), convert(W.materialize(tshapes, seed)))


def test_materialize_takes_eval_shape_leaves_directly():
    jshapes, _ = _shapes("blazeface128")
    a = flatten_dict(_materialize(jshapes, 3))
    b = W.flatten(W.materialize(jshapes, 3))
    assert all(np.array_equal(np.asarray(a[k]), b[k]) for k in a)


def test_msgpack_writer_gives_flax_bytes():
    rng = np.random.default_rng(0)
    tree = {
        "enc": {"params": {"conv": {"kernel": rng.standard_normal((3, 3, 3, 8)).astype(np.float32),
                                    "bias": np.zeros(8, np.float32)}},
                "batch_stats": {"bn": {"mean": np.zeros(300, np.float32),
                                       "var": np.ones(70_000, np.float32)}}},
        "det": {"params": {"a" * 40: {"kernel": np.arange(6, dtype=np.int32).reshape(2, 3)},
                           "w": np.float32(rng.standard_normal((1,))).reshape(1),
                           "scalar": np.zeros((), np.float32)}},
    }
    blob = W.msgpack_serialize(tree)
    assert blob == flax.serialization.to_bytes(tree)
    back = W.msgpack_restore(blob)
    for k, v in W.flatten(tree).items():
        got = W.flatten(back)[k]
        assert got.dtype == v.dtype and np.array_equal(got, v)


def _tiny_pair(tmp_path, seed=0):
    """JAX and port engines with the same tiny models and params dir."""
    ekw = dict(detect_size=(320, 320), compute_dtype="float32", strict_f32_preprocess=True)
    jcfg = JR(weights_dir=None, engine=JE(**ekw)).with_embedding_dim()
    tcfg = RecognizerConfig(weights_dir=None, engine=EngineConfig(**ekw)).with_embedding_dim()
    params = str(tmp_path / "params")
    jeng = JEngine(jcfg, params_dir=params, seed=seed, detector=JYuNet(width=8, dtype=jnp.float32),
                   encoder=j_tiny(128, dtype=jnp.float32))
    teng = DeviceEngine(tcfg, device="cpu", params_dir=params, seed=seed,
                        detector=YuNet(width=8), encoder=tiny_facenet(128))
    return jeng, teng


def _state(module):
    return {k: v.detach().float().numpy().copy() for k, v in module.state_dict().items()}


def test_port_reads_the_jax_params_cache(tmp_path):
    jeng, teng = _tiny_pair(tmp_path, seed=5)  # JAX writes, the port (seed 5 too) reads
    path = tmp_path / "params" / "params_yunet_128.msgpack"
    assert path.exists()
    assert teng.weight_source == {"detector": "random-init", "encoder": "random-init"}
    jenc = W.from_flax_facenet(jax.tree_util.tree_map(np.asarray, jeng.enc_vars))
    jdet = W.from_flax_yunet(jax.tree_util.tree_map(np.asarray, jeng.det_vars))
    for mod, ref in ((teng.encoder, jenc), (teng.detector, jdet)):
        got = _state(mod)
        assert set(got) == set(ref)
        assert all(np.array_equal(got[k], ref[k].numpy()) for k in ref)
    # a port engine of another seed loads the same cache: the file wins
    other = DeviceEngine(teng.cfg, device="cpu", params_dir=str(tmp_path / "params"), seed=9,
                         detector=YuNet(width=8), encoder=tiny_facenet(128))
    assert all(np.array_equal(_state(other.encoder)[k], v) for k, v in _state(teng.encoder).items())


def test_jax_reads_the_port_params_cache(tmp_path):
    tcfg = RecognizerConfig(weights_dir=None, engine=EngineConfig(
        detect_size=(320, 320), compute_dtype="float32")).with_embedding_dim()
    params = str(tmp_path / "params")
    teng = DeviceEngine(tcfg, device="cpu", params_dir=params, seed=2,
                        detector=YuNet(width=8), encoder=tiny_facenet(128))
    path = os.path.join(params, "params_yunet_128.msgpack")
    with open(path, "rb") as f:
        blob = f.read()
    jeng = JEngine(JR(weights_dir=None, engine=JE(detect_size=(320, 320))).with_embedding_dim(),
                   seed=11, detector=JYuNet(width=8, dtype=jnp.float32),
                   encoder=j_tiny(128, dtype=jnp.float32))
    state = flax.serialization.from_bytes({"enc": jeng.enc_vars, "det": jeng.det_vars}, blob)
    enc = W.from_flax_facenet(jax.tree_util.tree_map(np.asarray, state["enc"]))
    det = W.from_flax_yunet(jax.tree_util.tree_map(np.asarray, state["det"]))
    for mod, ref in ((teng.encoder, enc), (teng.detector, det)):
        got = _state(mod)
        assert all(np.array_equal(got[k], ref[k].numpy()) for k in ref)
    # and the JAX engine pointed at that directory loads it (no rewrite)
    mtime = os.path.getmtime(path)
    jeng2 = JEngine(JR(weights_dir=None, engine=JE(detect_size=(320, 320))).with_embedding_dim(),
                    params_dir=params, seed=11, detector=JYuNet(width=8, dtype=jnp.float32),
                    encoder=j_tiny(128, dtype=jnp.float32))
    assert os.path.getmtime(path) == mtime
    got = W.from_flax_facenet(jax.tree_util.tree_map(np.asarray, jeng2.enc_vars))
    assert all(np.array_equal(got[k].numpy(), v.numpy()) for k, v in enc.items())


def test_same_seed_same_weights_without_a_cache(tmp_path):
    ekw = dict(detect_size=(320, 320), compute_dtype="float32")
    jeng = JEngine(JR(weights_dir=None, engine=JE(**ekw)).with_embedding_dim(), seed=4,
                   detector=JYuNet(width=8, dtype=jnp.float32), encoder=j_tiny(128, dtype=jnp.float32))
    teng = DeviceEngine(RecognizerConfig(weights_dir=None, engine=EngineConfig(**ekw)).with_embedding_dim(),
                        device="cpu", seed=4, detector=YuNet(width=8), encoder=tiny_facenet(128))
    enc = W.from_flax_facenet(jax.tree_util.tree_map(np.asarray, jeng.enc_vars))
    det = W.from_flax_yunet(jax.tree_util.tree_map(np.asarray, jeng.det_vars))
    assert all(np.array_equal(_state(teng.encoder)[k], v.numpy()) for k, v in enc.items())
    assert all(np.array_equal(_state(teng.detector)[k], v.numpy()) for k, v in det.items())
    assert not any(os.scandir(tmp_path))  # no params_dir, no file


@pytest.mark.parametrize("damage", ["truncated", "other model"])
def test_unreadable_cache_is_regenerated(tmp_path, caplog, damage):
    params = tmp_path / "params"
    params.mkdir()
    path = params / "params_yunet_128.msgpack"
    if damage == "truncated":
        path.write_bytes(b"\x82\xa3enc")
    else:  # a readable cache of another model
        path.write_bytes(W.msgpack_serialize({"enc": {"params": {}}, "det": {"params": {}}}))
    cfg = RecognizerConfig(weights_dir=None).with_embedding_dim()
    eng = DeviceEngine(cfg, device="cpu", params_dir=str(params), seed=0,
                       detector=YuNet(width=8), encoder=tiny_facenet(128))
    assert "unreadable" in caplog.text and "regenerating" in caplog.text
    fresh = DeviceEngine(cfg, device="cpu", seed=0, detector=YuNet(width=8),
                         encoder=tiny_facenet(128))
    assert all(np.array_equal(_state(eng.encoder)[k], v) for k, v in _state(fresh.encoder).items())
    assert W.flatten(W.read_msgpack(str(path)))  # rewritten whole
    assert not (params / "params_yunet_128.msgpack.tmp").exists()


def test_random_init_engines_embed_alike(tmp_path):
    """The whole random-init path: the same frame, detected by the
    trained YuNet and embedded by the random-init tiny FaceNet of seed 0,
    in both packages."""
    jeng, teng = _tiny_pair(tmp_path)
    wt = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "weights_trained", "yunet_synth.msgpack")
    jeng.detector = JYuNet(dtype=jnp.float32)
    jeng.load_trained_detector(wt)
    teng.detector = teng._place(YuNet(), teng.cfg.engine.cdtype)
    teng.load_trained_detector(wt)
    frame = compose_scene(np.random.default_rng(8), make_identities(4, seed=8), hw=(240, 320),
                          n_faces=(2, 2), face_px=(70, 110), occlusion_prob=0.0)[0]
    boxes = np.asarray([d["bbox"] for d in teng.detect_faces(frame)], np.float32)
    assert len(boxes) == 2
    a, b = jeng.encode_boxes(frame, boxes), teng.encode_boxes(frame, boxes)
    cos = (a * b).sum(1) / np.linalg.norm(a, axis=1) / np.linalg.norm(b, axis=1)
    assert cos.min() >= 0.9999


@pytest.mark.parametrize("detector", ["yunet", "mediapipe", "retinaface"])
def test_weights_dir_probe(tmp_path, detector):
    """Git-LFS pointers are ignored, as JAX ignores them; a file that is
    not ONNX where the probe looks last does what it does in JAX: YuNet's
    executor fallback cannot parse it either and raises, BlazeFace's probe
    stops at the first file it finds, RetinaFace's logs it and keeps the
    random init."""
    names = {"yunet": ["face_detection_yunet_2023mar.onnx"],
             "mediapipe": ["face_detection_short_range.tflite", "blazeface.tflite",
                           "blazeface.onnx", "face_detection_short_range.onnx"],
             "retinaface": ["retinaface.onnx"]}[detector]
    wdir = tmp_path / "weights"
    wdir.mkdir()
    cfg = RecognizerConfig(detector_type=detector, weights_dir=str(wdir)).with_embedding_dim()
    files = [str(wdir / n) for n in ["facenet128.onnx"] + names]
    small = dict(detector=RetinaFace((1, 1, 1, 1), width=8) if detector == "retinaface"
                 else YuNet(width=8) if detector == "yunet" else None,
                 encoder=tiny_facenet(128))
    for path in files:
        with open(path, "wb") as f:
            f.write(b"version https://git-lfs.github.com/spec/v1\noid sha256:00\nsize 9\n")
    eng = DeviceEngine(cfg, device="cpu", **small)
    assert eng.weight_source == {"detector": "random-init", "encoder": "random-init"}
    with open(files[-1], "wb") as f:
        f.write(b"\x08\x07" + bytes(200))
    if detector == "yunet":
        with pytest.raises(ValueError, match="no GraphProto"):
            DeviceEngine(cfg, device="cpu", **small)
    else:
        assert DeviceEngine(cfg, device="cpu", **small).weight_source["detector"] == "random-init"
