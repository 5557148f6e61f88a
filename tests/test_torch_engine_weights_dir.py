"""The port's probe of ``weights_dir`` against the JAX engine's, file by
file: the same outcome (import, executor fallback, Git-LFS stub, absent
file), the same ``weight_source`` strings, bitwise the same imported
variable trees, and the executor slots giving the JAX executor's
outputs.  The files are written by the exporters from numpy-seeded
trees."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fire_tpu.config import EngineConfig as JE
from fire_tpu.config import RecognizerConfig as JR
from fire_tpu.models import onnx_export as oe
from fire_tpu.models.facenet import tiny_facenet as j_tiny
from fire_tpu.models.yunet import YuNet as JYuNet
from fire_tpu.pipeline.engine import DeviceEngine as JEngine
from fire_tpu_torch.config import EngineConfig, RecognizerConfig
from fire_tpu_torch.models.facenet import FaceNet, tiny_facenet
from fire_tpu_torch.models.tflite_import import write_tflite_blazeface
from fire_tpu_torch.models.yunet import YuNet
from fire_tpu_torch.pipeline import engine as TE
from fire_tpu_torch.pipeline.engine import DeviceEngine
from fire_tpu_torch.weights import flatten, flax_shapes, materialize, msgpack_serialize, read_msgpack
from tests.test_onnx_import import _tiny_facenet_vars

WT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "weights_trained")
LFS = b"version https://git-lfs.github.com/spec/v1\noid sha256:0\nsize 1\n"
F32 = dict(compute_dtype="float32", strict_f32_preprocess=True)


def _cfgs(wdir, detector="yunet", **engine_kw):
    kw = dict(detector_type=detector, encoder_model_type="128", weights_dir=str(wdir))
    return (JR(**kw, engine=JE(**F32, **engine_kw)).with_embedding_dim(),
            RecognizerConfig(**kw, engine=EngineConfig(**F32, **engine_kw)).with_embedding_dim())


def _same_tree(t, j):
    ft, fj = flatten(t), flatten(jax.tree.map(np.asarray, j))
    assert set(ft) == set(fj)
    for k in fj:
        np.testing.assert_array_equal(np.asarray(ft[k]), fj[k], err_msg=str(k))


def _write(wdir, name, blob):
    os.makedirs(wdir, exist_ok=True)
    with open(os.path.join(wdir, name), "wb") as f:
        f.write(blob)
    return os.path.join(wdir, name)


def _crops(n=2, seed=4):
    return np.random.default_rng(seed).uniform(0, 1, (n, 160, 160, 3)).astype(np.float32)


def test_absent_and_lfs_stubs_keep_the_random_init(tmp_path):
    wdir = tmp_path / "weights"
    for make_stubs in (False, True):
        if make_stubs:
            for name in ("facenet128.onnx", "face_detection_yunet_2023mar.onnx"):
                _write(wdir, name, LFS)
        jcfg, tcfg = _cfgs(wdir if make_stubs else tmp_path / "absent")
        jeng = JEngine(jcfg, detector=JYuNet(width=8, dtype=jnp.float32),
                       encoder=j_tiny(128, dtype=jnp.float32))
        teng = DeviceEngine(tcfg, device="cpu", detector=YuNet(width=8), encoder=tiny_facenet(128))
        assert teng.weight_source == jeng.weight_source == {"detector": "random-init",
                                                           "encoder": "random-init"}
        _same_tree(teng.enc_vars, jeng.enc_vars)
        _same_tree(teng.det_vars, jeng.det_vars)


def test_matching_files_import_onto_the_same_trees(tmp_path):
    """A full-width FaceNet-128 and YuNet file: both engines report
    ``onnx-import:`` and hold bitwise the same variables, which differ
    from their own random init; the port's encoder embeds as JAX's."""
    src = materialize(flax_shapes(FaceNet(embed_dim=128), unit_bn_scale=True), seed=5)
    wdir = str(tmp_path / "weights")
    enc = _write(wdir, "facenet128.onnx", oe.export_facenet(src, embed_dim=128))
    det = _write(wdir, "face_detection_yunet_2023mar.onnx",
                 oe.export_yunet(read_msgpack(os.path.join(WT, "yunet_synth.msgpack"))))
    jcfg, tcfg = _cfgs(wdir)
    jeng, teng = JEngine(jcfg), DeviceEngine(tcfg, device="cpu")
    assert teng.weight_source == jeng.weight_source == {
        "encoder": f"onnx-import:{enc}", "detector": f"onnx-import:{det}"}
    _same_tree(teng.enc_vars, jeng.enc_vars)
    _same_tree(teng.det_vars, jeng.det_vars)
    np.testing.assert_allclose(flatten(teng.enc_vars)[("params", "stem0", "conv", "kernel")],
                               flatten(src)[("params", "stem0", "conv", "kernel")])
    a, b = jeng.encode_faces(_crops()), teng.encode_faces(_crops())
    assert ((a * b).sum(1)).min() >= 0.9999


def test_mismatched_files_run_the_executor(tmp_path, rng):
    """A tiny FaceNet file for the full encoder and a width-8 YuNet file
    for the full detector: both engines fall back to executing the
    files, and the port's slots give JAX's embeddings and detections."""
    _, tiny_vars = _tiny_facenet_vars(seed=1, embed_dim=128)
    yv = jax.tree.map(np.asarray, JYuNet(width=8, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    wdir = str(tmp_path / "weights")
    enc = _write(wdir, "facenet128.onnx",
                 oe.export_facenet(tiny_vars, embed_dim=128, depths=(1, 1, 1), stem_width=8))
    det = _write(wdir, "face_detection_yunet_2023mar.onnx",
                 oe.export_yunet(yv, width=8, image_hw=(64, 64)))
    jcfg, tcfg = _cfgs(wdir, detect_size=(64, 64))
    object.__setattr__(jcfg, "yunet_conf_threshold", 0.05)
    object.__setattr__(tcfg, "yunet_conf_threshold", 0.05)
    jeng, teng = JEngine(jcfg), DeviceEngine(tcfg, device="cpu")
    assert teng.weight_source == jeng.weight_source == {
        "encoder": f"onnx-exec:{enc}", "detector": f"onnx-exec:{det}"}
    assert isinstance(teng.encoder, TE.OnnxEncoder) and isinstance(teng.detector, TE.OnnxYuNet)
    assert teng.enc_vars is None and teng.det_vars is None
    np.testing.assert_allclose(teng.encode_faces(_crops()), jeng.encode_faces(_crops()),
                               atol=1e-4)
    frames = (rng.random((2, 48, 60, 3)) * 255).astype(np.uint8)
    for frame in frames:
        jd, td = jeng.detect(frame), teng.detect(frame)
        mask = np.asarray(jd.mask)
        np.testing.assert_array_equal(td.mask.numpy(), mask)
        np.testing.assert_allclose(td.boxes_xywh.numpy()[mask], np.asarray(jd.boxes_xywh)[mask],
                                   atol=1e-3)
        np.testing.assert_allclose(td.scores.numpy()[mask], np.asarray(jd.scores)[mask],
                                   atol=1e-4)
    # the batched detect runs the graph frame by frame, as JAX's vmap does
    batched = teng._build_detect((48, 60))(torch.from_numpy(frames))
    np.testing.assert_array_equal(batched.mask[1].numpy(), teng.detect(frames[1]).mask.numpy())
    # trained variables take the slot back from the executor
    tree = materialize(flax_shapes(teng._encoder_net, unit_bn_scale=True), seed=9)
    path = tmp_path / "enc.msgpack"
    path.write_bytes(msgpack_serialize(tree))
    teng.load_trained_encoder(str(path))
    assert teng.encoder is teng._encoder_net and isinstance(teng.encoder, FaceNet)
    assert teng.weight_source["encoder"] == f"trained:{path}"
    assert teng.encode_faces(_crops(1)).shape == (1, 128)


def _blaze_tree(seed=3):
    from fire_tpu.models.blazeface import BlazeFace

    v = BlazeFace(dtype=jnp.float32).init(jax.random.PRNGKey(seed), jnp.zeros((1, 128, 128, 3)))
    return jax.tree.map(np.asarray, v)


def _odd_blazeface_graph():
    """BlazeFace's four outputs from four strided convs: the names fit,
    the topology does not, so the import fails and the executor runs."""
    rng = np.random.default_rng(6)
    g = oe.GraphBuilder("odd")
    g.add_input("input", (1, 3, 128, 128))
    for head, ch, k in (("classifier_8", 2, 8), ("regressor_8", 32, 8),
                        ("classifier_16", 6, 16), ("regressor_16", 96, 16)):
        w = g.add_init(head + "/W", rng.normal(0, 0.05, (ch, 3, k, k)).astype(np.float32))
        b = g.add_init(head + "/b", rng.normal(0, 0.5, ch).astype(np.float32))
        g.add_node("Conv", ["input", w, b], outputs=[head], strides=[k, k], kernel_shape=[k, k])
        g.add_output(head, (1, ch, 128 // k, 128 // k))
    return g.model_bytes()


@pytest.mark.parametrize("case", ["tflite", "onnx", "onnx_mismatch", "stubs"])
def test_blazeface_probe_equals_jax(tmp_path, case):
    wdir = str(tmp_path / "weights")
    tree = _blaze_tree()
    if case == "tflite":
        path = _write(wdir, "face_detection_short_range.tflite",
                      write_tflite_blazeface(tree["params"]))
        _write(wdir, "blazeface.onnx", oe.export_blazeface(_blaze_tree(4)))  # never reached
        want = f"tflite-import:{path}"
    elif case == "onnx":
        path = _write(wdir, "blazeface.onnx", oe.export_blazeface(tree))
        want = f"onnx-import:{path}"
    elif case == "onnx_mismatch":
        path = _write(wdir, "face_detection_short_range.onnx", _odd_blazeface_graph())
        want = f"onnx-exec:{path}"
    else:
        for name in ("face_detection_short_range.tflite", "blazeface.tflite", "blazeface.onnx",
                     "face_detection_short_range.onnx"):
            _write(wdir, name, LFS)
        want = "random-init"
    jcfg, tcfg = _cfgs(wdir, detector="mediapipe", blazeface_size=(192, 192))
    object.__setattr__(jcfg, "blazeface_conf_threshold", 0.3)
    object.__setattr__(tcfg, "blazeface_conf_threshold", 0.3)
    jeng = JEngine(jcfg, encoder=j_tiny(128, dtype=jnp.float32))
    teng = DeviceEngine(tcfg, device="cpu", encoder=tiny_facenet(128))
    assert teng.weight_source["detector"] == jeng.weight_source["detector"] == want
    assert tuple(teng._detect_input) == tuple(jeng._detect_input) == (
        (192, 192) if case == "stubs" else (128, 128))
    if case in ("tflite", "onnx"):
        _same_tree(teng.det_vars, jeng.det_vars)
        _same_tree(teng.det_vars["params"], tree["params"])
    frame = np.random.default_rng(1).integers(0, 255, (96, 128, 3), np.uint8)
    jd, td = jeng.detect(frame), teng.detect(frame)
    mask = np.asarray(jd.mask)
    np.testing.assert_array_equal(td.mask.numpy(), mask)
    np.testing.assert_allclose(td.boxes_xywh.numpy()[mask], np.asarray(jd.boxes_xywh)[mask],
                               atol=1e-3)
    if case == "onnx_mismatch":
        assert mask.any() and isinstance(teng.detector, TE.OnnxBlazeFace)


def test_retinaface_executor_equals_jax(tmp_path):
    """The reference RetinaFace contract (NHWC raw-pixel input, nine
    outputs in the export's order), with one planted face; then a file
    that is not ONNX keeps the random init, as in JAX."""
    from tests.test_engine_weights import test_retinaface_onnx_executor_fallback as jax_case

    jax_case(tmp_path)  # writes tmp_path/weights/retinaface.onnx and checks JAX
    wdir = tmp_path / "weights"
    kw = dict(detect_size=(64, 64), retinaface_size=(64, 64), max_faces=8, max_encode=4)
    jcfg, tcfg = _cfgs(wdir, detector="retinaface", **kw)
    from fire_tpu_torch.models.retinaface import RetinaFace

    small = dict(detector=RetinaFace((1, 1, 1, 1), width=8), encoder=tiny_facenet(128))
    teng = DeviceEngine(tcfg, device="cpu", **small)
    jeng = JEngine(jcfg, encoder=j_tiny(128, dtype=jnp.float32))
    assert teng.weight_source["detector"] == jeng.weight_source["detector"] == (
        f"onnx-exec:{wdir / 'retinaface.onnx'}")
    frame = np.zeros((64, 64, 3), np.uint8)
    jd, td = jeng.detect(frame), teng.detect(frame)
    mask = np.asarray(jd.mask)
    assert mask.sum() == 1
    np.testing.assert_array_equal(td.mask.numpy(), mask)
    np.testing.assert_allclose(td.boxes_xywh.numpy(), np.asarray(jd.boxes_xywh), atol=1e-3)
    np.testing.assert_allclose(td.scores.numpy(), np.asarray(jd.scores), atol=1e-5)
    (wdir / "retinaface.onnx").write_bytes(b"\x08\x07" * 64)
    assert DeviceEngine(tcfg, device="cpu", **small).weight_source["detector"] == "random-init"
