"""End to end: ``FaceRecognition.process_frames(batch_size=8)`` through
both packages on the same frames and weights (trained YuNet + tiny
FaceNet with shared random weights, float32).

Labels are random uuids, so the check is structural: the same
partition of tracked faces into identities frame by frame (a bijection
between the two label sets), boxes within ±1 px, the same gallery
count and the same SQLite rows up to that relabelling."""

import os
import sqlite3

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import fire_tpu.pipeline.batch_engine as JBE
from fire_tpu.config import EngineConfig as JE
from fire_tpu.config import RecognizerConfig as JR
from fire_tpu.models.facenet import tiny_facenet as j_tiny
from fire_tpu.models.yunet import YuNet as JYuNet
from fire_tpu.pipeline.engine import DeviceEngine as JEngine
from fire_tpu.pipeline.recognizer import FaceRecognition as JFR
from fire_tpu_torch.config import EngineConfig, RecognizerConfig
from fire_tpu_torch.models.facenet import tiny_facenet
from fire_tpu_torch.pipeline.engine import DeviceEngine
from fire_tpu_torch.pipeline.recognizer import FaceRecognition
from fire_tpu_torch.train.scenes import compose_scene, make_identities

WT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "weights_trained")
EKW = dict(detect_size=(320, 320), compute_dtype="float32", strict_f32_preprocess=True)
FR_KW = dict(detector_type="yunet", encoder_model_type="128", similarity_threshold=0.7,
             unknown_trigger_count=1, detection_interval=1, enable_logging=False)


def _engines():
    jcfg = JR(weights_dir=None, engine=JE(**EKW)).with_embedding_dim()
    jeng = JEngine(jcfg, detector=JYuNet(dtype=jnp.float32), encoder=j_tiny(128, dtype=jnp.float32))
    jeng.load_trained_detector(os.path.join(WT, "yunet_synth.msgpack"))
    teng = DeviceEngine(RecognizerConfig(engine=EngineConfig(**EKW)).with_embedding_dim(),
                        device="cpu", encoder=tiny_facenet(128))
    teng.load_trained_detector(os.path.join(WT, "yunet_synth.msgpack"))
    teng.load_encoder_variables(jax.tree_util.tree_map(np.asarray, jeng.enc_vars), "shared random")
    return jeng, teng


def _rows(db):
    con = sqlite3.connect(db)
    rows = list(con.execute("SELECT id, label, embedding FROM faces ORDER BY id"))
    con.close()
    return rows


def _run_both(tmp_path, monkeypatch, frames, jkw=None, tkw=None):
    """``process_frames(batch_size=8)`` through both packages; returns
    (per-frame faces and recognizer) for JAX, then for the port."""
    jeng, teng = _engines()
    j_out = []
    real = JBE.stream_results

    def spy(*args, **kw):
        for faces in real(*args, **kw):
            j_out.append(faces)
            yield faces

    monkeypatch.setattr(JBE, "stream_results", spy)
    jfr = JFR(**FR_KW, storage_root=str(tmp_path / "jax"), engine=jeng, weights_dir=None,
              **(jkw or {}))
    jfr.process_frames(frames, annotate=False, batch_size=8)
    j_out = j_out[: len(frames)]
    jfr.close()

    t_out = []
    tfr = FaceRecognition(**FR_KW, storage_root=str(tmp_path / "torch"), engine=teng,
                          **(tkw or {}))
    tfr.process_frames(frames, annotate=False, batch_size=8,
                       on_frame=lambda f, faces: t_out.append(faces))
    tfr.close()
    return j_out, jfr, t_out, tfr


def _same_faces(j_out, t_out):
    """Frame by frame the same boxes (±1 px) and a bijection between the
    two packages' labels; returns it."""
    assert len(j_out) == len(t_out)
    label_map = {"Unknown": "Unknown"}
    n_faces = 0
    for f, (jf, tf) in enumerate(zip(j_out, t_out)):
        assert len(jf) == len(tf), f
        for jd, td in zip(sorted(jf, key=lambda d: d["bbox"]), sorted(tf, key=lambda d: d["bbox"])):
            assert np.abs(np.subtract(jd["bbox"], td["bbox"])).max() <= 1
            assert label_map.setdefault(jd["label"], td["label"]) == td["label"], f
            assert jd["confidence"] == pytest.approx(td["confidence"], abs=1e-3)
            n_faces += 1
    assert len(set(label_map.values())) == len(label_map)  # a bijection
    assert n_faces > 0 and len(label_map) > 1
    return label_map


def _scenes(n=2, seed=32):
    idents = make_identities(6, seed=31)
    rng = np.random.default_rng(seed)
    return [compose_scene(rng, idents, hw=(240, 320), n_faces=(1, 2), face_px=(70, 150),
                          occlusion_prob=0.0)[0] for _ in range(n)]


def test_process_frames_same_identities(tmp_path, monkeypatch):
    a, b = _scenes()
    frames = [a] * 8 + [b] * 8 + [a] * 8 + [b] * 3  # tail batch padded
    j_out, jfr, t_out, tfr = _run_both(tmp_path, monkeypatch, frames)
    assert len(j_out) == len(t_out) == len(frames)
    label_map = _same_faces(j_out, t_out)

    assert jfr.gallery.count == tfr.gallery.count
    stem = "yunet_128_unencrypted/db/face_embeddings_yunet_128.db"
    jr, tr = _rows(tmp_path / "jax" / stem), _rows(tmp_path / "torch" / stem)
    assert len(jr) == len(tr) > 0
    for (ji, jl, je), (ti, tl, te) in zip(jr, tr):
        assert ji == ti and label_map[jl] == tl
        np.testing.assert_allclose(np.frombuffer(te, np.float32), np.frombuffer(je, np.float32),
                                   atol=1e-3)


def test_batched_path_tracks_with_the_default_tracker_config(tmp_path, monkeypatch):
    """JAX builds the batched step without the recognizer's
    ``tracker_cfg`` (``recognizer.py:958``); the port does the same, so a
    non-default ``TrackerConfig`` gives the same tracks in both."""
    from fire_tpu.config import TrackerConfig as JT
    from fire_tpu_torch.config import TrackerConfig
    from fire_tpu_torch.pipeline import batch_engine as TB

    seen = []
    real_init = TB.BatchStreamEngine.__init__

    def noting(self, *args, **kw):
        real_init(self, *args, **kw)
        seen.append(self.tcfg)

    monkeypatch.setattr(TB.BatchStreamEngine, "__init__", noting)
    a, b = _scenes(seed=33)
    blank = np.zeros_like(a)
    frames = [a] * 6 + [blank] * 2 + [a] * 6 + [b] * 6 + [blank, b, b, blank]
    j_out, _, t_out, tfr = _run_both(tmp_path, monkeypatch, frames,
                                     jkw={"tracker_cfg": JT(max_age=1)},
                                     tkw={"tracker_cfg": TrackerConfig(max_age=1)})
    assert tfr.tracker_cfg.max_age == 1 and seen == [TrackerConfig()]
    _same_faces(j_out, t_out)


def test_unported_options_raise(tmp_path):
    """Nothing raises for being unported any more: encryption, random-init
    engines, multi-stream and the importers run (their own tests are in
    test_torch_encrypted_storage.py, test_torch_random_init.py,
    test_torch_multistream_cli.py and test_torch_engine_weights_dir.py);
    a weights file that is not ONNX raises what it raises in JAX."""
    _, teng = _engines()
    enc = FaceRecognition(**FR_KW, storage_root=str(tmp_path), engine=teng,
                          encryption_password="pw")
    assert os.path.isdir(tmp_path / "yunet_128_encrypted" / "db")
    enc.close()
    assert os.path.exists(tmp_path / "yunet_128_encrypted/db/face_embeddings_yunet_128.db.enc")
    fr = FaceRecognition(**FR_KW, storage_root=str(tmp_path), engine=teng)
    fr.process_videos([str(tmp_path / "a.avi"), str(tmp_path / "b.avi")])  # logs, returns
    # ported since: annotate defaults to True and the per-frame loop runs
    frame = np.zeros((64, 64, 3), np.uint8)
    seen = []
    fr.process_frames([frame], batch_size=8, on_frame=lambda f, faces: seen.append(faces))
    fr.process_frames([frame], annotate=False, batch_size=0,
                      on_frame=lambda f, faces: seen.append(faces))
    assert seen == [[], []]
    from fire_tpu_torch.models.yunet import YuNet
    from fire_tpu_torch.pipeline.batch_engine import BatchStreamEngine

    random_init = DeviceEngine(RecognizerConfig(weights_dir=None).with_embedding_dim(),
                               device="cpu", detector=YuNet(width=8), encoder=tiny_facenet(128))
    assert random_init.weight_source == {"detector": "random-init", "encoder": "random-init"}
    res = BatchStreamEngine(random_init, fr.gallery, fr.cfg).process_batch(np.stack([frame] * 2))
    assert res.tid.shape == (2, fr.cfg.tracker.max_tracks)
    wdir = tmp_path / "weights"
    wdir.mkdir()
    (wdir / "face_detection_yunet_2023mar.onnx").write_bytes(b"\x08\x07" * 100)
    with pytest.raises(ValueError, match="no GraphProto"):
        DeviceEngine(RecognizerConfig(weights_dir=str(wdir)), device="cpu")
    fr.close()
