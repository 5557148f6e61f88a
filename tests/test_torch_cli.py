"""The port's command line: its parser against ``fire_tpu.cli`` flag for
flag, and ``main(argv)`` in process on the CPU (trained YuNet at 640² /
BlazeFace at 192², FaceNet-512 in bf16, a 480×640 rendered scene: the
sizes the committed default weights need; one image each).
"""

import os
import sqlite3

import numpy as np
import pytest

import fire_tpu.cli as JCLI
from fire_tpu_torch import cli
from fire_tpu_torch.train.scenes import compose_scene, make_identities
from fire_tpu_torch.utils import imageio


def _flags(parser):
    return {a.dest: a for a in parser._actions if a.option_strings and a.dest != "help"}


J, T = _flags(JCLI.build_parser()), _flags(cli.build_parser())


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """These tests run beside other workers on shared cores: more
    intra-op threads than that only make them wait for each other."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_parser_has_the_same_flags_plus_device():
    assert set(T) - set(J) == {"device"} and set(J) <= set(T)
    assert T["device"].default == "cuda" and T["device"].option_strings == ["--device"]


# choices the port has beyond JAX's: encoders only the port serves
PORT_ONLY_CHOICES = {"encoder": ["iresnet100"]}


@pytest.mark.parametrize("dest", sorted(J))
def test_parser_flag_equals_jax(dest):
    j, t = J[dest], T[dest]
    for field in ("option_strings", "choices", "default", "nargs", "type", "const", "required"):
        want = getattr(j, field)
        if field == "choices" and dest in PORT_ONLY_CHOICES:
            want = list(want) + PORT_ONLY_CHOICES[dest]
        assert getattr(t, field) == want, (dest, field)
    assert type(t).__name__ == type(j).__name__  # store / store_true / store_false


def test_parser_defaults_equal_jax():
    j, t = vars(JCLI.build_parser().parse_args([])), vars(cli.build_parser().parse_args([]))
    assert t.pop("device") == "cuda"
    assert j == t
    assert t["mode"] == "image" and t["detector"] == "mediapipe" and t["annotate"] is True
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["--annotate", "--no-annotate"])


def test_trained_defaults_table_equals_jax():
    assert cli._TRAINED_DEFAULTS == JCLI._TRAINED_DEFAULTS
    assert cli._TRAINED_BLAZE_128 == JCLI._TRAINED_BLAZE_128
    for name in set(cli._TRAINED_DEFAULTS.values()) | {cli._TRAINED_BLAZE_128}:
        assert os.path.exists(os.path.join(cli._weights_trained_dir(), name))


@pytest.fixture
def scene(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # storage/ is made under the working directory
    idents = make_identities(6, seed=31)
    img, boxes = compose_scene(np.random.default_rng(32), idents, hw=(480, 640), n_faces=(1, 1),
                               face_px=(230, 270), occlusion_prob=0.0)[:2]
    imageio.imwrite("scene.bmp", img)
    return img, boxes


def _labels(stem):
    con = sqlite3.connect(f"storage/{stem}_512_unencrypted/db/face_embeddings_{stem}_512.db")
    rows = [r[0] for r in con.execute("SELECT label FROM faces ORDER BY id")]
    con.close()
    return rows


BASE = ["--mode", "image", "--input", "scene.bmp", "--encoder", "512", "--device", "cpu"]


def test_main_image_mode_yunet_enrol_recognise_relabel(scene, capsys):
    img, _ = scene
    cli.main(BASE + ["--detector", "yunet", "--save", "out.bmp"])
    first = _labels("yunet")
    assert len(first) == 1 and first[0].startswith("Unknown_")
    out = imageio.imread("out.bmp")
    assert out.shape == img.shape and (out != img).any()
    assert "Image Processing Timings" in capsys.readouterr().out
    cli.main(BASE + ["--detector", "yunet", "--no-annotate", "--save", "plain.bmp"])
    assert _labels("yunet") == first  # recognised, nothing enrolled
    np.testing.assert_array_equal(imageio.imread("plain.bmp"), img)
    cli.main(BASE + ["--detector", "yunet", "--label", "alice"])  # relabel + shrink_db_ids
    assert _labels("yunet") == ["alice"]


def test_main_default_detector_is_blazeface_192(scene):
    _, boxes = scene
    from fire_tpu_torch.pipeline import recognizer as R

    seen = {}
    real = R.FaceRecognition.process_image

    def spy(self, **kw):
        seen["cfg"], seen["src"] = self.cfg, dict(self.engine.weight_source)
        seen["faces"] = real(self, **kw)

    R.FaceRecognition.process_image = spy
    try:
        cli.main(BASE)
    finally:
        R.FaceRecognition.process_image = real
    cfg = seen["cfg"]
    assert cfg.detector_type == "mediapipe" and cfg.engine.blazeface_size == (192, 192)
    assert cfg.similarity_threshold == 0.7 and cfg.unknown_trigger_count == 1
    assert cfg.detection_interval == 1
    assert seen["src"]["detector"].endswith("blazeface192_synth.msgpack")
    assert seen["src"]["encoder"].endswith("facenet512_synth.msgpack")
    assert len(seen["faces"]) == 1
    x, y, w, h = seen["faces"][0]["bbox"]
    gx, gy, gw, gh = boxes[0]
    iw = min(x + w, gx + gw) - max(x, gx)
    ih = min(y + h, gy + gh) - max(y, gy)
    assert iw > 0 and ih > 0 and iw * ih / (w * h + gw * gh - iw * ih) >= 0.5
    assert len(_labels("mediapipe")) == 1


def _spy(argv):
    """Run ``cli.main(argv)``; return what ``process_image`` saw: the
    config, the weight sources, the faces, the storage layout."""
    from fire_tpu_torch.pipeline import recognizer as R

    seen = {}
    real = R.FaceRecognition.process_image

    def spy(self, **kw):
        seen["cfg"], seen["src"] = self.cfg, dict(self.engine.weight_source)
        seen["encryptor"] = self.encryptor
        seen["faces"] = real(self, **kw)
        return seen["faces"]

    R.FaceRecognition.process_image = spy
    try:
        cli.main(argv)
    finally:
        R.FaceRecognition.process_image = real
    return seen


@pytest.mark.parametrize("what", ["inputs", "weights_dir"])
def test_main_exits_on_what_is_not_ported(scene, monkeypatch, what):
    """Named for the two commands that once ended the run; both are
    ported now: ``--inputs`` reaches ``process_videos`` with the JAX
    CLI's batch of 8, and a real ``facenet512.onnx`` in ``--weights_dir``
    (the committed weights, exported) is imported."""
    from fire_tpu_torch.pipeline import recognizer as R

    if what == "inputs":
        seen = {}
        monkeypatch.setattr(R.FaceRecognition, "process_videos",
                            lambda self, **kw: seen.update(kw, fr=self))
        cli.main(["--mode", "video", "--inputs", "a.avi", "b.avi", "--encoder", "512",
                  "--device", "cpu", "--label", "bob"])
        assert seen["video_paths"] == ["a.avi", "b.avi"] and seen["batch_size"] == 8
        assert seen["name"] == "bob" and seen["annotate"] is True and seen["save_path"] is None
        return
    from fire_tpu_torch.models.onnx_export import export_facenet
    from fire_tpu_torch.weights import read_msgpack

    os.makedirs("ref")
    tree = read_msgpack(os.path.join(cli._weights_trained_dir(), "facenet512_synth.msgpack"))
    with open("ref/facenet512.onnx", "wb") as f:
        f.write(export_facenet(tree, embed_dim=512))
    seen = _spy(BASE + ["--weights_dir", "ref"])
    assert seen["src"]["encoder"] == "onnx-import:ref/facenet512.onnx"
    assert len(seen["faces"]) == 1 and len(_labels("mediapipe")) == 1


def test_main_ignores_git_lfs_pointers_in_weights_dir(scene):
    os.makedirs("ref")
    for name in ("facenet512.onnx", "face_detection_yunet_2023mar.onnx"):
        with open(f"ref/{name}", "wb") as f:
            f.write(b"version https://git-lfs.github.com/spec/v1\noid sha256:0\nsize 1\n")
    seen = _spy(BASE + ["--detector", "yunet", "--weights_dir", "ref"])
    assert seen["cfg"].weights_dir == "ref"
    assert seen["src"]["detector"].endswith("yunet_synth.msgpack") and len(seen["faces"]) == 1


@pytest.mark.parametrize("argv", [
    ["--password", "pw"],
    ["--detector", "retinaface"],
    ["--no_default_weights"],
], ids=["password", "retinaface", "no_default_weights"])
def test_main_runs_what_is_now_ported(scene, argv):
    """The three commands that ended the run before this slice."""
    _, boxes = scene
    seen = _spy(BASE + argv + ["--save", "out.bmp"])
    cfg = seen["cfg"]
    if "--password" in argv:
        from fire_tpu_torch.gallery.crypto import Encryptor

        assert seen["encryptor"] is not None and cfg.encryption_password == "pw"
        assert os.path.exists("storage/mediapipe_512_encrypted/db/face_embeddings_mediapipe_512.db.enc")
        assert not os.path.exists("storage/mediapipe_512_unencrypted")
        plain = Encryptor("pw").read_and_decrypt("out.bmp")
        assert plain[:2] == b"\xff\xd8" and len(seen["faces"]) == 1  # JPEG, as JAX saves
    elif "retinaface" in argv:
        # no size given and no reference file: the committed 512² weights
        assert cfg.engine.retinaface_size == (512, 512)
        assert seen["src"]["detector"].endswith("retinaface_synth.msgpack")
        assert len(seen["faces"]) == 1
        x, y, w, h = seen["faces"][0]["bbox"]
        gx, gy, gw, gh = boxes[0]
        iw = min(x + w, gx + gw) - max(x, gx)
        ih = min(y + h, gy + gh) - max(y, gy)
        assert iw > 0 and ih > 0 and iw * ih / (w * h + gw * gh - iw * ih) >= 0.5
        assert len(_labels("retinaface")) == 1
    else:
        # both models random-init from the params cache, at the JAX sizes
        assert seen["src"] == {"detector": "random-init", "encoder": "random-init"}
        assert cfg.engine.blazeface_size == (128, 128)
        assert os.path.exists("storage/mediapipe_512_unencrypted/params/params_mediapipe_512.msgpack")


def test_main_retinaface_off_its_trained_size_runs_random_init(scene, caplog):
    seen = _spy(BASE + ["--detector", "retinaface", "--retinaface_size", "256"])
    assert seen["cfg"].engine.retinaface_size == (256, 256)
    assert seen["src"]["detector"] == "random-init"
    assert "needs --retinaface_size 512" in caplog.text


def test_main_without_encoder_512_names_the_missing_weights(scene):
    """No 128-d weights are committed: the 128-d encoder is the random
    init, kept in the params cache, as in JAX."""
    argv = [a for a in BASE if a not in ("--encoder", "512")] + ["--detector", "yunet"]
    seen = _spy(argv)
    assert seen["cfg"].encoder_model_type == "128"
    assert seen["src"]["encoder"] == "random-init"
    assert seen["src"]["detector"].endswith("yunet_synth.msgpack")
    cache = "storage/yunet_128_unencrypted/params/params_yunet_128.msgpack"
    first = os.path.getmtime(cache)
    con = sqlite3.connect("storage/yunet_128_unencrypted/db/face_embeddings_yunet_128.db")
    enrolled = [r[0] for r in con.execute("SELECT label FROM faces")]
    con.close()
    assert len(enrolled) == 1
    again = _spy(argv)  # reads the cache: the same embedding, so recognised
    assert os.path.getmtime(cache) == first
    assert [f["label"] for f in again["faces"]] == enrolled


def test_main_names_a_format_that_needs_opencv(scene, monkeypatch, caplog):
    """Image mode logs the error and goes on, as JAX's ``process_image``
    does; the message names the format and OpenCV."""
    import builtins

    real = builtins.__import__
    monkeypatch.setattr(builtins, "__import__", lambda name, *a, **k: (_ for _ in ()).throw(
        ImportError(name)) if name == "cv2" else real(name, *a, **k))
    with caplog.at_level("ERROR"):
        cli.main(BASE + ["--detector", "yunet", "--save", "out.jpg", "--no-annotate"])
    errors = [r.getMessage() for r in caplog.records if r.levelname == "ERROR"]
    assert len(errors) == 1 and ".jpg" in errors[0] and "OpenCV" in errors[0]
    assert not os.path.exists("out.jpg")


def test_main_defaults_to_cuda_and_does_not_fall_back(scene):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this box has a card: the refusal cannot be shown here")
    argv = [a for a in BASE if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(argv + ["--detector", "yunet"])


def test_main_profile_writes_a_chrome_trace(scene):
    cli.main(BASE + ["--detector", "yunet", "--profile", "prof"])
    assert os.path.getsize("prof/trace.json") > 1000


def test_python_dash_m_entry_point():
    import runpy

    with pytest.raises(SystemExit) as e:  # argparse --help exits 0
        import sys

        old = sys.argv
        sys.argv = ["fire_tpu_torch", "--help"]
        try:
            runpy.run_module("fire_tpu_torch", run_name="__main__")
        finally:
            sys.argv = old
    assert e.value.code == 0


def test_encoder_iresnet100_warns_without_weights(monkeypatch, caplog, tmp_path):
    """``--encoder iresnet100`` asks the recognizer for that encoder and
    nothing else (the recognizer takes its 112² crops from the encoder)
    and warns that its encoder is the random init unless ``--trained``
    gives weights (none is committed).  The recognizer is stood in for:
    the full network is not built here."""
    import logging
    from types import SimpleNamespace

    made = []

    class Stand:
        def __init__(self, **kw):
            made.append(kw)
            source = "trained:x" if kw.get("trained_encoder") else "random-init"
            self.engine = SimpleNamespace(weight_source={"detector": "trained:y",
                                                         "encoder": source})
            self.cfg = SimpleNamespace(encoder_model_type=kw["encoder_model_type"])

        def process_image(self, **kw):
            pass

        def close(self):
            pass

    monkeypatch.setattr(cli, "FaceRecognition", Stand)
    argv = ["--mode", "image", "--input", str(tmp_path / "x.bmp"), "--detector", "yunet",
            "--encoder", "iresnet100", "--device", "cpu", "--no_default_weights"]
    with caplog.at_level(logging.WARNING, logger=cli.log.name):
        cli.main(argv)
    assert made[-1]["engine_cfg"] is None
    assert made[-1]["encoder_model_type"] == "iresnet100"
    assert "RANDOM-INIT" in caplog.text
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger=cli.log.name):
        cli.main(argv + ["--trained", str(tmp_path / "w.msgpack")])
    assert "RANDOM-INIT" not in caplog.text
