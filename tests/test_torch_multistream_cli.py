"""``FaceRecognition.process_videos`` and ``--inputs`` of the port against
``tests/test_multistream_cli.py``'s cases, both packages reading the same
video files: JAX on its eight CPU devices, the port on a mesh of eight
``"cpu"`` entries (``fr.mesh``), each with its fake engine."""

import logging
import os

import numpy as np
import pytest

import fire_tpu.pipeline.batch_engine as JBE
import fire_tpu_torch.pipeline.batch_engine as TBE
from fire_tpu.config import TrackerConfig as JT
from fire_tpu.pipeline.recognizer import FaceRecognition as JFR
from fire_tpu_torch.config import TrackerConfig
from fire_tpu_torch.gallery.index import ShardedGalleryView
from fire_tpu_torch.parallel.mesh import make_mesh
from fire_tpu_torch.pipeline.recognizer import FaceRecognition
from tests.test_batch_engine import _fake_engine
from tests.test_multistream_cli import _scene_frame, _write_video
from tests.test_torch_multistream import fake_engine

KW = dict(detector_type="yunet", encoder_model_type="128", similarity_threshold=0.7,
          unknown_trigger_count=1, detection_interval=1, enable_logging=False)


def _jfr(root, **kw):
    eng = _fake_engine()
    eng.detect_faces = lambda img: []
    eng.extract_faces = lambda img, align=True: []
    return JFR(**KW, storage_root=str(root), engine=eng, tracker_cfg=JT(), **kw)


def _tfr(root, n_devices=8, **kw):
    eng = fake_engine()
    eng.detect_faces = lambda img: []
    eng.extract_faces = lambda img, align=True: []
    fr = FaceRecognition(**KW, storage_root=str(root), engine=eng, tracker_cfg=TrackerConfig(),
                         **kw)
    if n_devices:
        fr.mesh = make_mesh(devices=["cpu"] * n_devices)
    return fr


def _spy(monkeypatch, module):
    """Record every frame's faces as ``stream_results`` yields them."""
    seen = []
    real = module.stream_results

    def spy(*args, **kw):
        for faces in real(*args, **kw):
            seen.append(faces)
            yield faces

    monkeypatch.setattr(module, "stream_results", spy)
    return seen


def test_process_videos_shared_gallery_equals_jax(tmp_path, monkeypatch):
    """Two streams: identity 5 in both, 7 in stream 1 only.  The shared
    identity enrols once; both packages give the same faces frame by
    frame (up to the random labels) and the same gallery; per-stream
    outputs are written."""
    frames_a = [_scene_frame([([8, 8, 12, 12], 5)]) for _ in range(12)]
    frames_b = [_scene_frame([([30, 20, 12, 12], 5), ([4, 30, 12, 12], 7)]) for _ in range(12)]
    va, vb = str(tmp_path / "a.avi"), str(tmp_path / "b.avi")
    _write_video(va, frames_a)
    _write_video(vb, frames_b)

    j_seen, t_seen = _spy(monkeypatch, JBE), _spy(monkeypatch, TBE)
    jfr = _jfr(tmp_path / "jax", sharded_gallery=True)
    jfr.process_videos([va, vb], annotate=True, save_path=str(tmp_path / "j.avi"), batch_size=4)
    jfr.close()
    tfr = _tfr(tmp_path / "torch", sharded_gallery=True)
    tfr.process_videos([va, vb], annotate=True, save_path=str(tmp_path / "t.avi"), batch_size=4)
    tfr.close()

    for s in (0, 1):
        assert os.path.getsize(tmp_path / f"t_stream{s}.avi") > 0
    assert tfr.gallery.count == jfr.gallery.count and 1 <= tfr.gallery.count <= 4
    assert len(t_seen) >= 24 and len(t_seen) == len(j_seen)
    labels = {"Unknown": "Unknown"}
    for jf, tf in zip(j_seen, t_seen):
        assert [d["bbox"] for d in tf] == [d["bbox"] for d in jf]
        for jd, td in zip(jf, tf):
            assert labels.setdefault(jd["label"], td["label"]) == td["label"]
    # identity 5, seen in both streams, has one label everywhere
    fives = {d["label"] for f in t_seen for d in f if d["bbox"][:2] in ([8, 8], [30, 20])}
    assert len(fives - {"Unknown"}) == 1
    assert tfr.timer.totals.get("device step (S streams)", 0) > 0


def test_process_videos_encrypted_outputs(tmp_path):
    """``--password`` with ``--inputs``: every stream's output is
    encrypted at rest, and either package decrypts it."""
    from fire_tpu.gallery.crypto import Encryptor as JEncryptor
    from fire_tpu_torch.gallery import crypto

    frames = [_scene_frame([]) for _ in range(8)]
    va, vb = str(tmp_path / "a.avi"), str(tmp_path / "b.avi")
    _write_video(va, frames)
    _write_video(vb, frames)
    fr = _tfr(tmp_path / "storage", encryption_password="s3cret")
    fr.process_videos([va, vb], annotate=True, save_path=str(tmp_path / "out.avi"), batch_size=4)
    fr.close()
    for s in range(2):
        with open(tmp_path / f"out_stream{s}.avi", "rb") as f:
            blob = f.read()
        assert not blob.startswith(b"RIFF")
        assert crypto.Encryptor("s3cret").decrypt_data(blob).startswith(b"RIFF")
        assert JEncryptor("s3cret").decrypt_data(blob).startswith(b"RIFF")


@pytest.fixture(autouse=True)
def _fast_kdf(monkeypatch):
    import fire_tpu.gallery.crypto as JC
    from fire_tpu_torch.gallery import crypto

    monkeypatch.setattr(crypto, "PBKDF2_ITERATIONS", 1_000)
    if hasattr(JC, "PBKDF2_ITERATIONS"):
        monkeypatch.setattr(JC, "PBKDF2_ITERATIONS", 1_000)


def test_process_videos_resolution_mismatch_rejected(tmp_path, caplog):
    va, vb = str(tmp_path / "a.avi"), str(tmp_path / "b.avi")
    _write_video(va, [_scene_frame([]) for _ in range(4)])
    _write_video(vb, [np.zeros((96, 96, 3), np.uint8) for _ in range(4)])
    fr = _tfr(tmp_path / "storage")
    with caplog.at_level(logging.ERROR):
        fr.process_videos([va, vb], annotate=False, batch_size=4)
    assert "must share one resolution" in caplog.text and fr.gallery.count == 0
    fr.close()


def test_more_streams_than_the_mesh_is_an_error(tmp_path, caplog):
    """On a one-device mesh two inputs end with JAX's logged error."""
    va, vb = str(tmp_path / "a.avi"), str(tmp_path / "b.avi")
    for v in (va, vb):
        _write_video(v, [_scene_frame([([8, 8, 12, 12], 5)]) for _ in range(4)])
    fr = _tfr(tmp_path / "storage", n_devices=1)
    with caplog.at_level(logging.ERROR):
        fr.process_videos([va, vb], batch_size=4)
    assert "2 streams exceed the 1-device dp mesh; run in groups of 1." in caplog.text
    assert fr.gallery.count == 0
    with caplog.at_level(logging.ERROR):
        fr.process_videos([va, str(tmp_path / "missing.avi")])
    assert "Cannot open video file" in caplog.text
    fr.close()


def test_batch_rounded_up_to_the_detection_interval(tmp_path, caplog):
    va = str(tmp_path / "a.avi")
    _write_video(va, [_scene_frame([([8, 8, 12, 12], 5)]) for _ in range(9)])
    import cv2

    fr = _tfr(tmp_path / "storage", n_devices=2)
    fr.detection_interval = 3
    seen = []
    with caplog.at_level(logging.WARNING):
        fr._process_streams_batched(
            [cv2.VideoCapture(va)], [va], annotate=False, save_path=None,
            batch_size=4, on_frame=lambda i, f, faces: seen.append(i))
    assert "batch_size 4 rounded up to 6" in caplog.text and seen == [0] * 9
    fr.close()


def test_sharded_view_routes_queries(tmp_path):
    """``sharded_gallery=True``: the matcher is the row-sharded view (on
    the engine's device here) and answers as the gallery does."""
    fr = _tfr(tmp_path / "storage", n_devices=0, sharded_gallery=True)
    assert isinstance(fr._matcher, ShardedGalleryView) and fr.mesh.shape == {"dp": 1, "mp": 1}
    plain = _tfr(tmp_path / "other", n_devices=0)
    assert plain._matcher is plain.gallery and plain.mesh is None  # the CPU never adopts it
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((5, 128)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    for i, v in enumerate(vecs):
        fr.gallery.add(v, f"p{i}", fr.db_manager.add(f"p{i}", v))
    ids_v, d_v = fr._matcher.query_batch(vecs, k=2)
    ids_g, d_g = fr.gallery.query_batch(vecs, k=2)
    np.testing.assert_array_equal(ids_v, ids_g)
    np.testing.assert_allclose(d_v, d_g, atol=1e-5)
    # enrolment goes through the view: a face the gallery holds is not added
    assert fr.enroll_unknown_now(vecs[2]) == "p2" and fr.gallery.count == 5
    fr.close()


def test_cli_inputs_flag(monkeypatch):
    """``--inputs``: video mode calls ``process_videos`` with the list and
    the batch size (8 when none is given), as ``fire_tpu.cli`` does."""
    import fire_tpu_torch.cli as cli

    calls = {}

    class StubFR:
        def __init__(self, **kw):
            calls["init"] = kw
            self.engine = type("E", (), {"weight_source": {"detector": "x", "encoder": "x"}})()

        def process_videos(self, video_paths, **kw):
            calls.setdefault("videos", []).append((video_paths, kw))

        def process_video(self, *a, **kw):
            calls["video"] = (a, kw)

        def shrink_db_ids(self):
            calls["shrunk"] = True

        def close(self):
            calls["closed"] = True

    monkeypatch.setattr(cli, "FaceRecognition", StubFR)
    cli.main(["--mode", "video", "--inputs", "x.avi", "y.avi", "--batch_size", "4",
              "--no_default_weights"])
    cli.main(["--mode", "video", "--inputs", "x.avi", "y.avi", "--label", "bob",
              "--no_default_weights"])
    (p1, kw1), (p2, kw2) = calls["videos"]
    assert p1 == p2 == ["x.avi", "y.avi"] and kw1["batch_size"] == 4 and kw2["batch_size"] == 8
    assert kw2["name"] == "bob" and "video" not in calls and calls["closed"]


def test_cli_two_inputs_on_a_one_device_mesh(tmp_path, monkeypatch, caplog):
    """``python -m fire_tpu_torch --mode video --inputs a b --device cpu``:
    the CPU is a one-device mesh, so the run ends with JAX's logged error
    (and closes the store)."""
    import fire_tpu_torch.cli as cli

    monkeypatch.chdir(tmp_path)
    for v in ("a.avi", "b.avi"):
        _write_video(v, [_scene_frame([]) for _ in range(4)])
    with caplog.at_level(logging.ERROR):
        cli.main(["--mode", "video", "--inputs", "a.avi", "b.avi", "--device", "cpu", "--log",
                  "--no_default_weights"])
    assert "2 streams exceed the 1-device dp mesh; run in groups of 1." in caplog.text
    assert os.path.exists("storage/mediapipe_128_unencrypted/db/face_embeddings_mediapipe_128.db")
