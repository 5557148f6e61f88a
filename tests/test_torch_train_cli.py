"""The port's training command lines on the CPU at tiny sizes
(counterparts of ``tests/test_train_cli.py`` and of the JAX trainers'
``main``): each writes a Flax msgpack that ``flax.serialization.
from_bytes`` restores against JAX's own variable template and that both
packages' ``DeviceEngine.load_trained_*`` load; the ArcFace CLI resumes
from its checkpoints; the data pipeline reads PNGs without OpenCV and
gives JAX's batches; and without a card every CLI raises unless given
``--device cpu``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from fire_tpu.config import EngineConfig as JaxEngineConfig
from fire_tpu.config import RecognizerConfig as JaxRecognizerConfig
from fire_tpu.models.blazeface import BlazeFace as JaxBlazeFace
from fire_tpu.models.facenet import tiny_facenet as jax_tiny_facenet
from fire_tpu.models.retinaface import RetinaFace as JaxRetinaFace
from fire_tpu.models.yunet import YuNet as JaxYuNet
from fire_tpu.pipeline.engine import DeviceEngine as JaxDeviceEngine
from fire_tpu.train import data as jax_data
from fire_tpu_torch.config import EngineConfig, RecognizerConfig
from fire_tpu_torch.models import facenet as facenet_mod
from fire_tpu_torch.models.yunet import YuNet
from fire_tpu_torch.pipeline.engine import DeviceEngine
from fire_tpu_torch.train import __main__ as arcface_cli
from fire_tpu_torch.train import data, detect, detect_blaze, detect_retina
from fire_tpu_torch.utils import imageio
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dataset(root, rng, n_ids=2, per_id=4, hw=(96, 96)):
    for ident in ("a", "b", "c")[:n_ids]:
        d = root / ident
        d.mkdir(parents=True)
        for i in range(per_id):
            imageio.imwrite(str(d / f"{i}.png"), rng.integers(0, 255, (*hw, 3)).astype(np.uint8))
    return root


def _restore(path, module, sample_hw, collections=("params", "batch_stats")):
    """``from_bytes`` of ``path`` against JAX's template for ``module``."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.zeros((1, *sample_hw, 3)))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    with open(path, "rb") as f:
        return serialization.from_bytes({c: template[c] for c in collections}, f.read())


@pytest.fixture
def tiny_facenet_cli(monkeypatch):
    """The CLI's FaceNet at tiny depth and width (same layer types)."""
    real = facenet_mod.FaceNet
    monkeypatch.setattr(facenet_mod, "FaceNet", lambda embed_dim, dropout_rate=0.0, **_: real(
        embed_dim=embed_dim, depths=(1, 1, 1), stem_width=8, dropout_rate=dropout_rate))


def test_arcface_cli_end_to_end(tmp_path, tiny_facenet_cli):
    _dataset(tmp_path / "data", np.random.default_rng(0))
    out = tmp_path / "enc.msgpack"
    arcface_cli.main(["--data", str(tmp_path / "data"), "--encoder", "128", "--epochs", "1",
                      "--batch", "8", "--image_size", "96", "--out", str(out),
                      "--log_every", "1", "--device", "cpu"])
    assert out.exists() and out.stat().st_size > 1000
    jax_model = jax_tiny_facenet(128, dtype=jnp.float32)
    restored = _restore(out, jax_model, (96, 96))
    assert restored["params"]["bottleneck"]["kernel"].shape[1] == 128
    assert restored["batch_stats"]["bottleneck_bn"]["var"].shape == (128,)

    # both engines load it and embed a crop alike
    face = np.random.default_rng(1).random((2, 160, 160, 3)).astype(np.float32)
    jcfg = JaxRecognizerConfig(weights_dir=None, engine=JaxEngineConfig(
        compute_dtype="float32")).with_embedding_dim()
    jeng = JaxDeviceEngine(jcfg, encoder=jax_model)
    jeng.load_trained_encoder(str(out))
    cfg = RecognizerConfig(weights_dir=None, engine=EngineConfig(
        compute_dtype="float32")).with_embedding_dim()
    eng = DeviceEngine(cfg, device="cpu", encoder=facenet_mod.tiny_facenet(128))
    eng.load_trained_encoder(str(out))
    ours, theirs = eng.encode_faces(face), np.asarray(jeng.encode_faces(face))
    np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=1e-4)


def test_arcface_cli_checkpoint_resume(tmp_path, tiny_facenet_cli):
    """``--checkpoint_dir`` saves ``step_<N>`` checkpoints and a second
    run resumes from the newest one, its step counter going on."""
    _dataset(tmp_path / "data", np.random.default_rng(0))
    ckpt = tmp_path / "ckpt"
    argv = ["--data", str(tmp_path / "data"), "--encoder", "128", "--epochs", "1",
            "--batch", "4", "--image_size", "96", "--out", str(tmp_path / "enc.msgpack"),
            "--log_every", "1", "--checkpoint_dir", str(ckpt), "--device", "cpu"]

    def steps():
        return {int(p.name.split("_")[1]) for p in ckpt.iterdir() if p.name.startswith("step_")}

    arcface_cli.main(argv)
    first = steps()
    assert first == {1, 2}
    assert all((ckpt / f"step_{s}" / "state.msgpack").exists() for s in first)
    arcface_cli.main(argv)
    assert max(steps()) > max(first) and steps() == {1, 2, 3, 4}


def test_identity_folder_batches_equal_jax(tmp_path):
    """PNGs read without OpenCV: the same shuffled batches as JAX's
    OpenCV loader (the images are stored at the train size), each epoch
    dropping its partial batch."""
    _dataset(tmp_path, np.random.default_rng(2), n_ids=3, per_id=3, hw=(32, 32))
    ds = data.IdentityFolderDataset(str(tmp_path))
    jds = jax_data.IdentityFolderDataset(str(tmp_path))
    assert ds.samples == jds.samples and ds.num_classes == 3 and len(ds) == 9
    ours = list(data.batches(ds, 4, (32, 32), seed=3, epochs=2))
    theirs = list(jax_data.batches(jds, 4, (32, 32), seed=3, epochs=2))
    assert len(ours) == len(theirs) == 4
    for (a, la), (b, lb) in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)
        assert a.dtype == np.uint8 and la.dtype == np.int32
    # a smaller train size resamples (INTER_AREA, here an exact 2×2 mean)
    small = next(data.batches(ds, 4, (16, 16), seed=3))[0]
    assert small.shape == (4, 16, 16, 3)
    empty = tmp_path.parent / (tmp_path.name + "_empty")
    empty.mkdir()
    with pytest.raises(ValueError, match="no images"):
        data.IdentityFolderDataset(str(empty))


def test_batches_raise_a_decode_error_and_stop_on_close(tmp_path):
    ds = data.IdentityFolderDataset(str(_dataset(tmp_path / "ok", np.random.default_rng(4),
                                                 n_ids=2, per_id=2, hw=(16, 16))))
    gen = data.batches(ds, 1, (16, 16), epochs=50, prefetch=1)
    next(gen)
    gen.close()  # the decode thread stops instead of blocking on a full queue
    (tmp_path / "ok" / "a" / "9.png").write_bytes(b"not a png")
    with pytest.raises(ValueError, match="cannot decode"):
        list(data.batches(data.IdentityFolderDataset(str(tmp_path / "ok")), 1, (16, 16)))


def _detector_args(tmp_path, name, *extra):
    return ["--steps", "2", "--batch", "2", "--identities", "2", "--pool", "4",
            "--device_pool", "4", "--gen_threads", "1", "--refresh_every", "1",
            "--refresh_block", "2", "--log_every", "1", "--out", str(tmp_path / name),
            "--device", "cpu", *extra]


def test_yunet_cli_writes_jax_loadable_variables(tmp_path):
    out = tmp_path / "yunet.msgpack"
    pr = detect.main(_detector_args(tmp_path, "yunet.msgpack", "--size", "64", "--width", "8",
                                    "--max_faces", "2", "--face_px", "16", "40",
                                    "--eval_scenes", "0"))
    assert pr is None
    restored = _restore(out, JaxYuNet(width=8, dtype=jnp.float32), (64, 64))
    assert restored["params"]["model0"]["conv1"]["kernel"].shape == (3, 3, 3, 2)
    jeng = JaxDeviceEngine(JaxRecognizerConfig(weights_dir=None).with_embedding_dim(),
                           detector=JaxYuNet(width=8), encoder=jax_tiny_facenet(128))
    jeng.load_trained_detector(str(out))
    eng = DeviceEngine(RecognizerConfig(weights_dir=None).with_embedding_dim(), device="cpu",
                       detector=YuNet(width=8), encoder=facenet_mod.tiny_facenet(128))
    eng.load_trained_detector(str(out))
    assert eng.weight_source["detector"] == f"trained:{out}"
    assert isinstance(eng.detect_faces(np.zeros((96, 128, 3), np.uint8)), list)


def test_blazeface_cli_fine_tunes_and_evaluates(tmp_path):
    """``--init_from`` the committed BlazeFace-192 weights, a 64² input,
    and the held-out evaluation through ``detect_faces``."""
    out = tmp_path / "blaze.msgpack"
    init = os.path.join(REPO, "weights_trained", "blazeface192_synth.msgpack")
    pr = detect_blaze.main(_detector_args(
        tmp_path, "blaze.msgpack", "--input_px", "64", "--scene_hw", "96", "128",
        "--face_px", "30", "90", "--init_from", init, "--lr", "1e-5", "--eval_scenes", "2"))
    assert set(pr) >= {"precision", "recall", "tp", "fp", "fn"}
    restored = _restore(out, JaxBlazeFace(dtype=jnp.float32), (64, 64), ("params",))
    assert restored["params"]["conv1"]["kernel"].shape == (5, 5, 3, 24)
    jeng = JaxDeviceEngine(JaxRecognizerConfig(detector_type="mediapipe", weights_dir=None)
                           .with_embedding_dim(), encoder=jax_tiny_facenet(128))
    jeng.load_trained_detector(str(out))
    # lr 1e-5 for 2 steps: the fine-tune stays next to its start
    start = serialization.msgpack_restore(open(init, "rb").read())
    got = np.asarray(restored["params"]["conv1"]["kernel"])
    assert np.abs(got - np.asarray(start["params"]["conv1"]["kernel"], np.float32)).max() < 1e-3


def test_retinaface_cli_saves_periodically_and_loads(tmp_path):
    out = tmp_path / "retina.msgpack"
    detect_retina.main(_detector_args(
        tmp_path, "retina.msgpack", "--size", "64", "--scene_hw", "48", "64", "--batch", "1",
        "--steps", "2", "--face_px", "16", "40", "--save_every", "1", "--eval_scenes", "0"))
    assert out.exists() and not (tmp_path / "retina.msgpack.tmp").exists()
    restored = _restore(out, JaxRetinaFace(dtype=jnp.float32), (64, 64))
    assert restored["batch_stats"]["stem_bn"]["var"].shape == (64,)
    jeng = JaxDeviceEngine(JaxRecognizerConfig(detector_type="retinaface", weights_dir=None)
                           .with_embedding_dim(), encoder=jax_tiny_facenet(128))
    jeng.load_trained_detector(str(out))
    eng = DeviceEngine(RecognizerConfig(detector_type="retinaface", weights_dir=None)
                       .with_embedding_dim(), device="cpu", encoder=facenet_mod.tiny_facenet(128))
    eng.load_trained_detector(str(out))


@pytest.mark.parametrize("main", [arcface_cli.main, detect.main, detect_blaze.main,
                                  detect_retina.main],
                         ids=["arcface", "yunet", "blazeface", "retinaface"])
def test_cli_without_a_card_raises_unless_cpu(main, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--data", str(tmp_path)] if main is arcface_cli.main else []
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(argv)
