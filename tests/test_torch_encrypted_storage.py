"""Encrypted storage across the two packages on the CPU: the SQLite
store, the gallery's snapshot triplet and journal, the recognizer's
storage layout and saved outputs, and the command line with
``--password``.  Files written encrypted by either package are read by
the other; a wrong password leaves an empty store and gallery, not a
crash.  PBKDF2 runs at 1,000 iterations in both packages here.
"""

import os
import shutil

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import fire_tpu.gallery.crypto as JC
from fire_tpu.config import EngineConfig as JE
from fire_tpu.config import RecognizerConfig as JR
from fire_tpu.gallery.index import DeviceGallery as JGallery
from fire_tpu.gallery.store import FaceStore as JStore
from fire_tpu.models.facenet import tiny_facenet as j_tiny
from fire_tpu.models.yunet import YuNet as JYuNet
from fire_tpu.pipeline.engine import DeviceEngine as JEngine
from fire_tpu.pipeline.recognizer import FaceRecognition as JFR
from fire_tpu_torch import cli
from fire_tpu_torch.config import EngineConfig, RecognizerConfig
from fire_tpu_torch.gallery import crypto as TC
from fire_tpu_torch.gallery.index import DeviceGallery
from fire_tpu_torch.gallery.store import FaceStore
from fire_tpu_torch.models.facenet import tiny_facenet
from fire_tpu_torch.pipeline.engine import DeviceEngine
from fire_tpu_torch.pipeline.recognizer import FaceRecognition
from fire_tpu_torch.train.scenes import compose_scene, make_identities
from fire_tpu_torch.utils import imageio

DIM = 16
WT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "weights_trained")


@pytest.fixture(autouse=True)
def _fast_kdf(monkeypatch):
    monkeypatch.setattr(JC, "PBKDF2_ITERATIONS", 1000)
    monkeypatch.setattr(TC, "PBKDF2_ITERATIONS", 1000)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    return [(f"person_{seed}_{i}", rng.standard_normal(DIM).astype(np.float32)) for i in range(n)]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_encrypted_sqlite_crosses(tmp_path, writer):
    path = str(tmp_path / "db" / "faces.db.enc")
    W = (lambda: JStore(None, path, JC.Encryptor("pw"), DIM)) if writer == "jax" else \
        (lambda: FaceStore(None, path, TC.Encryptor("pw"), DIM))
    R = (lambda pw: FaceStore(None, path, TC.Encryptor(pw), DIM)) if writer == "jax" else \
        (lambda pw: JStore(None, path, JC.Encryptor(pw), DIM))
    store = W()
    rows = _rows(5, 1)
    ids = [store.add(label, emb) for label, emb in rows]
    store.update_label(ids[2], "alice")
    store.save()
    with open(path, "rb") as f:
        assert b"SQLite format" not in f.read()  # encrypted at rest
    other = R("pw")
    got = other.load_all()
    assert [r[0] for r in got] == ids
    assert [r[1] for r in got] == ["person_1_0", "person_1_1", "alice", "person_1_3", "person_1_4"]
    for (_, _, blob), (_, emb) in zip(got, rows):
        np.testing.assert_array_equal(np.frombuffer(blob, np.float32), emb)
    other.add("bob", rows[0][1])
    other.save()
    assert W().count() == 6  # and back again
    wrong = R("wrong")
    assert wrong.count() == 0  # logged, not raised


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_encrypted_gallery_snapshot_and_journal_cross(tmp_path, writer):
    d = tmp_path / "hnsw"
    paths = [str(d / "index.bin"), str(d / "labels.pkl"), str(d / "db_ids.pkl")]

    def make(pkg, pw):
        if pkg == "jax":
            return JGallery(DIM, *paths, JC.Encryptor(pw), capacity=200)
        return DeviceGallery(DIM, *paths, TC.Encryptor(pw), capacity=200, device="cpu")

    reader = "port" if writer == "jax" else "jax"
    g = make(writer, "pw")
    first, more = _rows(6, 2), _rows(3, 3)
    for i, (label, emb) in enumerate(first):
        g.add(emb, label, 100 + i)
    g.save()  # snapshot triplet
    for i, (label, emb) in enumerate(more):
        g.add(emb, label, 200 + i)
    g.save()  # one journal record
    assert os.path.getsize(paths[0] + ".journal") > 0
    with pytest.raises(ValueError):  # not a plain .npy any more
        np.load(paths[0])
    r = make(reader, "pw")
    assert r.count == 9
    assert list(r.labels) == [label for label, _ in first + more]
    assert list(r.db_ids) == list(range(100, 106)) + list(range(200, 203))
    want = np.stack([e / np.linalg.norm(e) for _, e in first + more])
    got = np.asarray(r._gal[:9]) if reader == "jax" else r._gal[:9].numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    q = want[4] + 0.01
    ids, dists = r.query(q, k=1)
    assert int(ids[0][0]) == 4
    # the reader appends to the journal, and the writer's package reads that
    r.add(more[0][1], "again", 300)
    r.save()
    assert make(writer, "pw").count == 10
    assert make(reader, "wrong").count == 0  # unreadable: a fresh gallery


def _engines():
    """JAX and port engines with the same weights (trained YuNet at 320²,
    a tiny FaceNet with shared random weights), float32."""
    ekw = dict(detect_size=(320, 320), compute_dtype="float32", strict_f32_preprocess=True)
    jeng = JEngine(JR(weights_dir=None, engine=JE(**ekw)).with_embedding_dim(),
                   detector=JYuNet(dtype=jnp.float32), encoder=j_tiny(128, dtype=jnp.float32))
    jeng.load_trained_detector(os.path.join(WT, "yunet_synth.msgpack"))
    teng = DeviceEngine(RecognizerConfig(weights_dir=None, engine=EngineConfig(**ekw)).with_embedding_dim(),
                        device="cpu", encoder=tiny_facenet(128))
    teng.load_trained_detector(os.path.join(WT, "yunet_synth.msgpack"))
    teng.load_encoder_variables(jax.tree_util.tree_map(np.asarray, jeng.enc_vars), "shared random")
    return jeng, teng


FR_KW = dict(detector_type="yunet", encoder_model_type="128", similarity_threshold=0.7,
             unknown_trigger_count=1, detection_interval=1, enable_logging=False)


def test_recognizers_share_encrypted_storage(tmp_path):
    jeng, teng = _engines()
    img = compose_scene(np.random.default_rng(42), make_identities(4, seed=42), hw=(240, 320),
                        n_faces=(1, 1), face_px=(90, 130), occlusion_prob=0.0)[0]
    src = str(tmp_path / "scene.bmp")
    imageio.imwrite(src, img)
    root = str(tmp_path / "storage")
    stem = "yunet_128_encrypted"

    jfr = JFR(**FR_KW, storage_root=root, engine=jeng, weights_dir=None,
              encryption_password="pw")
    jfr.process_image(src, annotate=False)
    jfr.close()
    assert jfr.gallery.count == 1
    assert os.path.exists(os.path.join(root, stem, "db", "face_embeddings_yunet_128.db.enc"))

    tfr = FaceRecognition(**FR_KW, storage_root=root, engine=teng, encryption_password="pw")
    assert tfr.gallery.count == 1 and tfr.db_manager.count() == 1
    assert tfr.gallery.labels == jfr.gallery.labels
    faces = tfr.process_image(src, annotate=False, save_path=str(tmp_path / "out.bmp"))
    assert [f["label"] for f in faces] == jfr.gallery.labels  # recognised, not enrolled
    tfr.close()
    # the encrypted save decrypts to the JPEG of the (unannotated) image,
    # whatever the path's name, as JAX writes it
    jpeg = cv2.imencode(".jpg", img)[1].tobytes()
    assert TC.Encryptor("pw").read_and_decrypt(str(tmp_path / "out.bmp")) == jpeg

    again = JFR(**FR_KW, storage_root=root, engine=jeng, weights_dir=None,
                encryption_password="pw")
    assert again.gallery.count == 1 and again.db_manager.count() == 1
    again.close()

    # a wrong password, on a copy (its close would overwrite the files)
    shutil.copytree(root, tmp_path / "copy")
    wrong = FaceRecognition(**FR_KW, storage_root=str(tmp_path / "copy"), engine=teng,
                            encryption_password="wrong")
    assert wrong.gallery.count == 0 and wrong.db_manager.count() == 0


def test_encrypted_video_save(tmp_path, monkeypatch):
    import tempfile

    _, teng = _engines()
    spool = tmp_path / "spool"
    spool.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(spool))
    frames = [np.full((64, 96, 3), v, np.uint8) for v in (10, 60, 110, 160)]
    fr = FaceRecognition(**FR_KW, storage_root=str(tmp_path / "s"), engine=teng,
                         encryption_password="pw")
    out = str(tmp_path / "saved" / "out.avi")
    fr.process_frames(frames, annotate=False, save_path=out, batch_size=0)
    fr.process_frames(frames, annotate=False, save_path=out + "2", batch_size=4)
    fr.close()
    for path in (out, out + "2"):
        data = TC.Encryptor("pw").read_and_decrypt(path)
        assert data[:4] == b"RIFF" and b"AVI " in data[:16]
    assert not any(p.suffix == ".avi" for p in spool.iterdir())  # the plain copies are gone


def test_cli_password_retinaface_default_encoder(tmp_path, monkeypatch):
    """``--password`` with ``--detector retinaface`` and no ``--encoder``:
    committed RetinaFace at 512², random-init FaceNet-128 from its
    params cache, everything at rest encrypted; the second run
    recognises the face the first enrolled."""
    monkeypatch.chdir(tmp_path)
    img = compose_scene(np.random.default_rng(32), make_identities(6, seed=31), hw=(480, 640),
                        n_faces=(1, 1), face_px=(230, 270), occlusion_prob=0.0)[0]
    imageio.imwrite("scene.bmp", img)
    argv = ["--mode", "image", "--input", "scene.bmp", "--device", "cpu", "--password", "pw",
            "--detector", "retinaface", "--save", "out.bmp"]
    cli.main(argv)
    base = "storage/retinaface_128_encrypted"
    assert os.path.exists(f"{base}/params/params_retinaface_128.msgpack")
    assert not os.path.exists("storage/retinaface_128_unencrypted")
    store = FaceStore(None, f"{base}/db/face_embeddings_retinaface_128.db.enc",
                      TC.Encryptor("pw"), 128)
    labels = [r[1] for r in store.load_all()]
    store.save()
    assert len(labels) == 1 and labels[0].startswith("Unknown_")
    assert TC.Encryptor("pw").read_and_decrypt("out.bmp")[:2] == b"\xff\xd8"  # JPEG, as JAX
    cli.main(argv + ["--no-annotate"])
    store = FaceStore(None, f"{base}/db/face_embeddings_retinaface_128.db.enc",
                      TC.Encryptor("pw"), 128)
    assert [r[1] for r in store.load_all()] == labels  # recognised, nothing enrolled
    assert TC.Encryptor("pw").read_and_decrypt("out.bmp") == cv2.imencode(".jpg", img)[1].tobytes()
    # nothing unencrypted was left beside it
    assert not any(name.endswith(".db") for _, _, files in os.walk("storage") for name in files)
