"""The per-frame path and image mode as wholes: ``recognize_faces``,
``process_frames(batch_size=0)``, ``process_image``, ``add_face`` and
``shrink_db_ids`` through both packages on the same frames and weights
(trained YuNet at 320², a tiny FaceNet with shared random weights,
float32, 240×320 rendered frames).

Labels are random uuids, so identities are compared structurally: the
same partition of faces into identities frame by frame (a bijection
between the two label sets), boxes within ±1 px, confidences to 1e-3,
the same tier counters, the same gallery count and the same SQLite rows
up to that relabelling (embeddings to 1e-3).
"""

import functools
import os
import sqlite3

import numpy as np
import pytest

from fire_tpu.pipeline.recognizer import FaceRecognition as JFR
from fire_tpu_torch.pipeline.recognizer import FaceRecognition
from fire_tpu_torch.train.scenes import compose_scene, make_identities
from fire_tpu_torch.utils import imageio
from tests.test_torch_engine_frame import engines

FR_KW = dict(detector_type="yunet", encoder_model_type="128", similarity_threshold=0.7,
             unknown_trigger_count=1, enable_logging=False)
STEM = "yunet_128_unencrypted/db/face_embeddings_yunet_128.db"


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """These tests run beside other workers on shared cores: more
    intra-op threads than that only make them wait for each other."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _scenes(seed, n):
    idents = make_identities(6, seed=seed)
    rng = np.random.default_rng(seed + 1)
    return [compose_scene(rng, idents, hw=(240, 320), n_faces=(1, 2), face_px=(70, 150),
                          occlusion_prob=0.0)[0] for _ in range(n)]


@functools.lru_cache(maxsize=None)
def _engines():
    """One pair of engines for the whole file: they hold weights and the
    JAX side's compiled graphs, nothing of a run."""
    return engines("yunet")


def _pair(tmp_path, **kw):
    jeng, teng = _engines()
    args = {**FR_KW, "detection_interval": 1, **kw}
    jfr = JFR(**args, storage_root=str(tmp_path / "jax"), engine=jeng, weights_dir=None)
    tfr = FaceRecognition(**args, storage_root=str(tmp_path / "torch"), engine=teng)
    return jfr, tfr


def _rows(db):
    con = sqlite3.connect(db)
    rows = list(con.execute("SELECT id, label, embedding FROM faces ORDER BY id"))
    con.close()
    return rows


def _same_faces(jf, tf, label_map, where):
    assert len(jf) == len(tf), where
    for jd, td in zip(sorted(jf, key=lambda d: d["bbox"]), sorted(tf, key=lambda d: d["bbox"])):
        assert np.abs(np.subtract(jd["bbox"], td["bbox"])).max() <= 1, where
        assert label_map.setdefault(jd["label"], td["label"]) == td["label"], where
        assert jd["confidence"] == pytest.approx(td["confidence"], abs=1e-3), where


def _same_store(tmp_path, jfr, tfr, label_map):
    assert jfr.gallery.count == tfr.gallery.count
    jr, tr = _rows(tmp_path / "jax" / STEM), _rows(tmp_path / "torch" / STEM)
    assert len(jr) == len(tr)
    for (ji, jl, je), (ti, tl, te) in zip(jr, tr):
        assert ji == ti and label_map.setdefault(jl, tl) == tl
        np.testing.assert_allclose(np.frombuffer(te, np.float32), np.frombuffer(je, np.float32),
                                   atol=1e-3)
    return len(tr)


BLANK = np.zeros((240, 320, 3), np.uint8)


@pytest.mark.parametrize("align_video", [False, True], ids=["box_crop", "align_video"])
@pytest.mark.parametrize("interval", [1, 3])
def test_recognize_faces_frame_by_frame(tmp_path, interval, align_video):
    jfr, tfr = _pair(tmp_path, detection_interval=interval, align_video=align_video)
    a, b = _scenes(31, 2)
    # blank stretches outlast max_age, so every scene change starts new tracks
    frames = [f for f in [a] * 6 + [BLANK] * 6 + [b] * 6 + [BLANK] * 6 + [a] * 6
              for _ in range(interval)]
    label_map = {"Unknown": "Unknown"}
    n_faces = 0
    for f, frame in enumerate(frames):
        jf, tf = jfr.recognize_faces(frame), tfr.recognize_faces(frame)
        _same_faces(jf, tf, label_map, f)
        n_faces += len(tf)
    assert len(set(label_map.values())) == len(label_map)  # a bijection
    assert n_faces > 0 and len(label_map) > 1
    assert jfr.counters == tfr.counters
    assert tfr.counters["tier1_track_cache"] > 0 and tfr.counters["unknown_enrolled"] > 0
    # scene a came back on new tracks: matched again, not enrolled twice
    assert tfr.counters["tier2_recent_cache"] + tfr.counters["tier3_gallery"] > 0
    assert set(tfr.timer.totals) >= {"detection", "tracker", "encoding", "match"}
    assert tfr.timer.frame_count == len(frames)
    jfr.close(), tfr.close()
    assert _same_store(tmp_path, jfr, tfr, label_map) == tfr.counters["unknown_enrolled"]


def test_unknown_trigger_count_above_one_keeps_the_track_unknown(tmp_path):
    """As in the JAX class, a track's first label is cached, "Unknown"
    included: with ``unknown_trigger_count=2`` the track is never encoded
    a second time, so nothing is enrolled while it lives."""
    jfr, tfr = _pair(tmp_path, unknown_trigger_count=2)
    (a,) = _scenes(33, 1)
    label_map = {"Unknown": "Unknown"}
    seen = []
    for f in range(10):
        jf, tf = jfr.recognize_faces(a), tfr.recognize_faces(a)
        _same_faces(jf, tf, label_map, f)
        seen += [d["label"] for d in tf]
    assert seen and set(seen) == {"Unknown"}
    assert jfr.counters == tfr.counters and tfr.counters["unknown_enrolled"] == 0
    assert tfr.gallery.count == jfr.gallery.count == 0
    assert {k: v["count"] for k, v in tfr.unknown_faces.items()} == \
        {k: v["count"] for k, v in jfr.unknown_faces.items()}
    jfr.close(), tfr.close()


def test_rename_label_relabels_the_matched_gallery_rows(tmp_path):
    """A new recognizer (empty recent cache) that sees an enrolled face with
    ``rename_label`` set renames its gallery rows through tier 3."""
    (a,) = _scenes(33, 1)
    jfr, tfr = _pair(tmp_path)
    for _ in range(6):
        jfr.recognize_faces(a), tfr.recognize_faces(a)
    jfr.close(), tfr.close()
    assert tfr.gallery.count == jfr.gallery.count > 0
    jfr, tfr = _pair(tmp_path)  # same storage: the gallery loads from disk
    label_map = {"dana": "dana"}
    for f in range(6):
        _same_faces(jfr.recognize_faces(a, rename_label="dana"),
                    tfr.recognize_faces(a, rename_label="dana"), label_map, f)
    assert tfr.counters == jfr.counters and tfr.counters["tier3_gallery"] > 0
    assert tfr.gallery.labels == jfr.gallery.labels and "dana" in tfr.gallery.labels
    jfr.close(), tfr.close()
    _same_store(tmp_path, jfr, tfr, label_map)


def test_interested_label_filters(tmp_path):
    _, tfr = _pair(tmp_path)
    (a,) = _scenes(35, 1)
    out = [tfr.recognize_faces(a) for _ in range(6)]
    labels = {d["label"] for faces in out for d in faces}
    assert labels
    tfr.interested_label = sorted(labels)[0]
    assert {d["label"] for d in tfr.recognize_faces(a)} == {tfr.interested_label}
    tfr.interested_label = "nobody"
    assert tfr.recognize_faces(a) == []
    tfr.close()


def test_process_frames_per_frame_loop(tmp_path, monkeypatch):
    """``process_frames(batch_size=0)`` drives ``recognize_faces`` on
    every frame in both packages; ``duration`` and an empty source end it."""
    jfr, tfr = _pair(tmp_path)
    a, b = _scenes(37, 2)
    frames = [a] * 7 + [b] * 7
    j_out, t_out = [], []
    real = jfr.recognize_faces
    monkeypatch.setattr(jfr, "recognize_faces",
                        lambda *args, **kw: j_out.append(real(*args, **kw)) or j_out[-1])
    jfr.process_frames(frames, annotate=False, batch_size=0)
    tfr.process_frames(frames, batch_size=0, on_frame=lambda f, faces: t_out.append(faces))
    assert len(j_out) == len(t_out) == len(frames)
    label_map = {"Unknown": "Unknown"}
    for f, (jf, tf) in enumerate(zip(j_out, t_out)):
        _same_faces(jf, tf, label_map, f)
    assert jfr.counters == tfr.counters
    tfr.process_frames([], batch_size=0)  # logs and returns
    jfr.close(), tfr.close()
    _same_store(tmp_path, jfr, tfr, label_map)


@pytest.mark.parametrize("batch_size", [0, 8], ids=["per_frame", "batched"])
def test_process_video_reads_and_writes_through_opencv(tmp_path, batch_size):
    """A video file in, an annotated XVID file out, on both loops (video
    I/O is OpenCV's, imported at the call)."""
    import cv2

    _, tfr = _pair(tmp_path)
    (a,) = _scenes(41, 1)
    src, out = str(tmp_path / "in.avi"), str(tmp_path / "saved" / "out.avi")
    writer = imageio.open_video_writer(src, 25, (320, 240))
    for _ in range(12):
        writer.write(a)
    writer.release()
    tfr.process_video(src, annotate=True, save_path=out, batch_size=batch_size)
    tfr.process_video(str(tmp_path / "missing.avi"))  # logs and returns
    cap = cv2.VideoCapture(out)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    assert len(frames) == 12 and frames[0].shape == a.shape
    assert tfr.timer.frame_count == 12 and "host writer.write" in tfr.timer.totals
    # the face is confirmed after min_hits frames: the last frame carries a green box
    assert tfr.gallery.count > 0
    green = (frames[-1][..., 1] > 200) & (frames[-1][..., 0] < 90) & (frames[-1][..., 2] < 90)
    assert green.sum() > 100 > ((a[..., 1] > 200) & (a[..., 0] < 90) & (a[..., 2] < 90)).sum()
    tfr.close()


def test_mixed_paths_share_the_recent_enrollment_window(tmp_path):
    """A face enrolled by the per-frame path is not enrolled again by the
    batched path of the same recognizer (``_enroll_now`` feeds the window
    on every path).  ``unknown_enrolled`` counts as JAX counts: the
    per-frame path's labelled unknown tracks only, so the batched run
    leaves it as it was."""
    _, tfr = _pair(tmp_path)
    (a,) = _scenes(41, 1)
    for _ in range(6):
        tfr.recognize_faces(a)
    n = tfr.gallery.count
    assert n > 0 and tfr.counters["unknown_enrolled"] == n == len(tfr._recent_enrollments)
    out = []
    tfr.process_frames([a] * 8, batch_size=8, on_frame=lambda f, faces: out.append(faces))
    assert tfr.gallery.count == n and any(out)
    assert tfr.counters["unknown_enrolled"] == n
    tfr.close()


@pytest.mark.parametrize("annotate", [True, False])
def test_process_image_enrols_then_recognises(tmp_path, annotate):
    jfr, tfr = _pair(tmp_path)
    (scene,) = _scenes(41, 1)
    src, out = str(tmp_path / "scene.bmp"), str(tmp_path / "out" / "o.bmp")
    imageio.imwrite(src, scene)
    jfr.process_image(src, annotate=False)
    first = tfr.process_image(src, annotate=annotate, save_path=out)
    assert len(first) == tfr.gallery.count == jfr.gallery.count > 0
    saved = imageio.imread(out)
    assert saved.shape == scene.shape
    if annotate:
        for face in first:
            x, y, w, h = face["bbox"]
            box = np.s_[y : y + h + 2, x : x + w + 2]
            assert (saved[box] != scene[box]).any()
    else:
        np.testing.assert_array_equal(saved, scene)
    # second run: the same labels, nothing enrolled
    jfr.process_image(src, annotate=False)
    second = tfr.process_image(src, annotate=False)
    assert [d["label"] for d in second] == [d["label"] for d in first]
    assert tfr.gallery.count == len(first) == jfr.gallery.count
    assert tfr.process_image(str(tmp_path / "missing.bmp")) == []
    jfr.close(), tfr.close()
    _same_store(tmp_path, jfr, tfr, {})


def test_process_image_label_relabels_and_never_enrols(tmp_path):
    jfr, tfr = _pair(tmp_path)
    (known,) = _scenes(43, 1)
    src = str(tmp_path / "a.bmp")
    imageio.imwrite(src, known)
    for fr in (jfr, tfr):
        # nothing to match yet: a face is only warned about, never enrolled
        fr.process_image(src, annotate=False, label="bob")
        assert fr.gallery.count == 0
        fr.process_image(src, annotate=False)
        n = fr.gallery.count
        fr.process_image(src, annotate=False, label="alice", save_path=str(tmp_path / "l.bmp"))
        assert fr.gallery.count == n and set(fr.gallery.labels) == {"alice"}
        fr.shrink_db_ids()
    np.testing.assert_array_equal(imageio.imread(str(tmp_path / "l.bmp")), known)
    assert tfr.gallery.labels == jfr.gallery.labels
    jfr.close(), tfr.close()
    _same_store(tmp_path, jfr, tfr, {})


@pytest.mark.parametrize("align", [True, False])
def test_add_face_dedup(tmp_path, align):
    jfr, tfr = _pair(tmp_path, align=align)
    (scene,) = _scenes(45, 1)
    for fr in (jfr, tfr):
        assert fr.add_face(BLANK, "nobody") is False
        assert fr.add_face(scene, "bob") is True
        assert fr.gallery.count == 0 and len(fr.new_embeddings) > 0  # buffered
        fr.save_database_to_sqlite()
        assert fr.gallery.count > 0 and fr.new_embeddings == []
        assert fr.add_face(scene, "bob again") is False  # too similar to the stored rows
    assert tfr.gallery.labels == jfr.gallery.labels
    jfr.close(), tfr.close()
    _same_store(tmp_path, jfr, tfr, {})


def test_add_face_flushes_at_max_new(tmp_path):
    _, tfr = _pair(tmp_path, max_new=1)
    (scene,) = _scenes(45, 1)
    assert tfr.add_face(scene, "bob") is True
    assert tfr.gallery.count > 0 and tfr.new_embeddings == []
    tfr.close()


def _unit(rng, n, d=128):
    v = rng.standard_normal((n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _near(rng, v, eps=0.05):
    w = v + eps * _unit(rng, 1, v.shape[0])[0]
    return w / np.linalg.norm(w)


def test_shrink_db_ids_merges_like_jax(tmp_path):
    """Groups of near-duplicates: all unknown → one label; one known name
    → that name; two known names → left alone; a loner → untouched."""
    jfr, tfr = _pair(tmp_path)
    rng = np.random.default_rng(0)
    base = _unit(rng, 4)
    plan = [("Unknown_aaaa0001", base[0]), ("Unknown_aaaa0002", _near(rng, base[0])),
            ("Unknown_aaaa0003", _near(rng, base[0])),
            ("Unknown_bbbb0001", base[1]), ("carol", _near(rng, base[1])),
            ("erin", base[2]), ("frank", _near(rng, base[2])),
            ("Unknown_cccc0001", _near(rng, base[2])),
            ("Unknown_dddd0001", base[3])]
    for fr in (jfr, tfr):
        for label, emb in plan:
            fr._enroll_now(label, emb)
        fr.gallery.save()
        fr.shrink_db_ids()
    assert tfr.gallery.labels == jfr.gallery.labels
    got = tfr.gallery.labels
    assert len(set(got[:3])) == 1 and got[0].startswith("Unknown_aaaa")
    assert got[3:5] == ["carol", "carol"]
    assert got[5:8] == ["erin", "frank", "Unknown_cccc0001"]
    assert got[8] == "Unknown_dddd0001"
    jfr.close(), tfr.close()
    assert [r[1] for r in _rows(tmp_path / "torch" / STEM)] == got
    assert [r[1] for r in _rows(tmp_path / "jax" / STEM)] == got


def test_query_batch_chunks_do_not_change_the_answer(tmp_path):
    _, tfr = _pair(tmp_path)
    rng = np.random.default_rng(1)
    gal = tfr.gallery
    for i, v in enumerate(_unit(rng, 40)):
        gal.add(v, f"p{i}", i + 1)
    q = _unit(rng, 11)
    ids, dists = gal.query_batch(q, k=5)
    gal.QUERY_ROWS = 3
    ids3, dists3 = gal.query_batch(q, k=5)
    np.testing.assert_array_equal(ids3, ids)
    np.testing.assert_allclose(dists3, dists, atol=1e-6)
    assert ids.shape == (11, 5)
    one, _ = gal.query_batch(q, k=1)
    np.testing.assert_array_equal(one[:, 0], ids[:, 0])
    tfr.close()
    empty_shrink = FaceRecognition(**FR_KW, storage_root=str(tmp_path / "e"), engine=tfr.engine)
    empty_shrink.shrink_db_ids()  # no rows: logs and returns
    empty_shrink.close()


def test_close_flushes_the_add_face_buffer(tmp_path):
    _, tfr = _pair(tmp_path)
    (scene,) = _scenes(45, 1)
    assert tfr.add_face(scene, "bob")
    tfr.close()
    rows = _rows(tmp_path / "torch" / STEM)
    assert rows and {r[1] for r in rows} == {"bob"}
    assert os.path.exists(tmp_path / "torch" / "yunet_128_unencrypted" / "hnsw" /
                          "hnsw_index_yunet_128.bin")
