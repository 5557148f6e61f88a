"""The three places where the port once differed from the JAX package,
each fed to both packages on the same input (trained YuNet at 320², a
tiny FaceNet with shared random weights, float32):

* errors are logged and the work goes on: a frame whose
  ``recognize_faces`` raises gives no faces and the per-frame loop goes
  on, an error that ends the loop is logged, ``process_image`` logs and
  ``add_face`` returns ``False``;
* an encrypted image save holds JPEG bytes whatever the path's name
  (without OpenCV: BMP / PPM bytes for those names, one warning, and an
  error naming ``cv2`` for other names);
* ``unknown_enrolled`` counts the per-frame path's labelled unknown
  tracks, "too similar" included, and nothing on the batched path.
"""

import builtins

import numpy as np
import pytest

import fire_tpu.gallery.crypto as JC
import fire_tpu.pipeline.batch_engine as JBE
import fire_tpu.pipeline.recognizer as JRec
import fire_tpu_torch.gallery.crypto as TC
import fire_tpu_torch.pipeline.recognizer as TRec
from fire_tpu_torch.utils import imageio
from tests.test_torch_frame_path import BLANK, _pair, _same_faces, _scenes


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


def _errors(caplog, logger):
    return [r.getMessage() for r in caplog.records if r.name == logger and r.levelname == "ERROR"]


def _failing_on(fr, bad_frames, monkeypatch):
    """``recognize_faces`` raises on the given (1-based) frames; returns
    the list of what each frame gave (``None`` for a raise)."""
    real, seen = fr.recognize_faces, []

    def wrapped(frame, rename_label=None):
        if fr.frame_index + 1 in bad_frames:
            fr.frame_index += 1
            seen.append(None)
            raise RuntimeError("device lost for this frame")
        out = real(frame, rename_label=rename_label)
        seen.append(out)
        return out

    monkeypatch.setattr(fr, "recognize_faces", wrapped)
    return seen


def test_a_frame_that_raises_is_logged_and_the_stream_goes_on(tmp_path, monkeypatch, caplog):
    jfr, tfr = _pair(tmp_path)
    a, b = _scenes(37, 2)
    frames = [a] * 6 + [b] * 6
    bad = {3, 8}
    j_seen, t_seen = _failing_on(jfr, bad, monkeypatch), _failing_on(tfr, bad, monkeypatch)
    t_out = []
    with caplog.at_level("ERROR"):
        jfr.process_frames(frames, annotate=False, batch_size=0)
        tfr.process_frames(frames, batch_size=0, on_frame=lambda f, faces: t_out.append(faces))
    assert len(j_seen) == len(t_seen) == len(t_out) == len(frames)  # both went on
    assert [i + 1 for i, s in enumerate(t_seen) if s is None] == sorted(bad)
    assert [i + 1 for i, s in enumerate(j_seen) if s is None] == sorted(bad)
    label_map = {"Unknown": "Unknown"}
    for f, (js, ts, emitted) in enumerate(zip(j_seen, t_seen, t_out)):
        _same_faces(js or [], ts or [], label_map, f)
        assert emitted == (ts or [])  # a failed frame emits no faces
    assert jfr.counters == tfr.counters
    want = [f"Error recognizing frame {k}: device lost for this frame" for k in sorted(bad)]
    assert _errors(caplog, "fire_tpu_torch.pipeline.recognizer") == want
    assert _errors(caplog, "fire_tpu.pipeline.recognizer") == want
    jfr.close(), tfr.close()


def test_an_error_that_ends_the_loop_is_logged(tmp_path, monkeypatch, caplog):
    jfr, tfr = _pair(tmp_path)
    (a,) = _scenes(41, 1)

    def broken(*args, **kw):
        raise ValueError("annotation failed")

    monkeypatch.setattr(JRec, "annotate_faces", broken)
    monkeypatch.setattr(TRec, "annotate_faces", broken)
    out = str(tmp_path / "never.avi")
    with caplog.at_level("ERROR"):
        jfr.process_frames([a] * 3, annotate=True, save_path=out, batch_size=0)
        tfr.process_frames([a] * 3, annotate=True, save_path=str(tmp_path / "t.avi"),
                           batch_size=0)
    assert _errors(caplog, "fire_tpu.pipeline.recognizer") == \
        ["Error in _process_stream: annotation failed"]
    assert _errors(caplog, "fire_tpu_torch.pipeline.recognizer") == \
        ["Error in _process_stream: annotation failed"]
    assert jfr.frame_index == tfr.frame_index == 1  # the loop ended at the first frame
    jfr.close(), tfr.close()


def test_process_image_and_add_face_log_their_errors(tmp_path, monkeypatch, caplog):
    jfr, tfr = _pair(tmp_path)
    (a,) = _scenes(43, 1)
    src = str(tmp_path / "in.bmp")
    imageio.imwrite(src, a)

    def boom(*args, **kw):
        raise RuntimeError("detector failed")

    for fr in (jfr, tfr):
        monkeypatch.setattr(fr, "detect_faces", boom)
        monkeypatch.setattr(fr, "extract_faces", boom)
    with caplog.at_level("ERROR"):
        assert jfr.process_image(src) is None
        assert tfr.process_image(src) == []
        assert jfr.add_face(a, "alice") is False
        assert tfr.add_face(a, "alice") is False
    want = ["Error in process_image: detector failed", "Error in add_face: detector failed"]
    assert _errors(caplog, "fire_tpu.pipeline.recognizer") == want
    assert _errors(caplog, "fire_tpu_torch.pipeline.recognizer") == want
    jfr.close(), tfr.close()


@pytest.mark.parametrize("name", ["out.png", "out.jpg", "out.bmp", "noext"])
def test_encrypted_save_holds_the_same_jpeg_bytes(tmp_path, name):
    pw = "s3cret"
    jfr, tfr = _pair(tmp_path, encryption_password=pw)
    (a,) = _scenes(45, 1)
    src = str(tmp_path / "in.bmp")
    imageio.imwrite(src, a)
    jout, tout = str(tmp_path / "j" / name), str(tmp_path / "t" / name)
    jfr.process_image(src, annotate=False, save_path=jout)
    tfr.process_image(src, annotate=False, save_path=tout)
    jbytes = JC.Encryptor(pw).read_and_decrypt(jout)
    tbytes = TC.Encryptor(pw).read_and_decrypt(tout)
    assert tbytes == jbytes and tbytes[:3] == b"\xff\xd8\xff"  # JPEG
    assert TC.Encryptor(pw).read_and_decrypt(jout) == JC.Encryptor(pw).read_and_decrypt(tout)
    jfr.close(), tfr.close()


@pytest.fixture
def no_cv2(monkeypatch):
    real = builtins.__import__

    def fake(name, *args, **kw):
        if name == "cv2":
            raise ImportError("No module named 'cv2'")
        return real(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", fake)
    TRec._warn_not_jpeg.cache_clear()
    yield
    TRec._warn_not_jpeg.cache_clear()


def test_encrypted_save_without_cv2(tmp_path, no_cv2, caplog):
    """The card's case: BMP / PPM bytes for those names, with one
    warning; any other name is an error that names cv2."""
    pw = "s3cret"
    _, tfr = _pair(tmp_path, encryption_password=pw)
    (a,) = _scenes(45, 1)
    src = str(tmp_path / "in.bmp")
    imageio.imwrite(src, a)
    with caplog.at_level("WARNING"):
        for k in range(2):
            tfr.process_image(src, annotate=False, save_path=str(tmp_path / f"o{k}.bmp"))
        tfr.process_image(src, annotate=False, save_path=str(tmp_path / "o.ppm"))
        tfr.process_image(src, annotate=False, save_path=str(tmp_path / "o.png"))
    for out, ext in (("o0.bmp", ".bmp"), ("o1.bmp", ".bmp"), ("o.ppm", ".ppm")):
        assert TC.Encryptor(pw).read_and_decrypt(str(tmp_path / out)) == imageio.imencode(ext, a)
    msgs = [r.getMessage() for r in caplog.records if r.name == "fire_tpu_torch.pipeline.recognizer"]
    assert sum("not the JPEG bytes" in m for m in msgs) == 2  # once per format
    errors = _errors(caplog, "fire_tpu_torch.pipeline.recognizer")
    assert len(errors) == 1 and "cv2" in errors[0] and "o.png" in errors[0]
    assert not (tmp_path / "o.png").exists()
    tfr.close()


def test_unknown_enrolled_counts_as_jax_on_the_per_frame_path(tmp_path):
    """Two copies of one face in a frame, with the recent cache off: the
    second track misses the frame's gallery query (made before the first
    track enrolled), and its unknown embedding is then "too similar" to
    that fresh enrolment.  JAX counts that label too."""
    jfr, tfr = _pair(tmp_path, max_recent=0)
    (a,) = _scenes(47, 1)
    twin = np.concatenate([a, a], axis=1)
    label_map = {"Unknown": "Unknown"}
    for f, frame in enumerate([twin] * 6 + [BLANK] * 6 + [twin] * 6):
        _same_faces(jfr.recognize_faces(frame), tfr.recognize_faces(frame), label_map, f)
    assert jfr.counters == tfr.counters
    assert tfr.counters["unknown_enrolled"] > tfr.gallery.count == jfr.gallery.count > 0
    jfr.close(), tfr.close()


def test_unknown_enrolled_is_not_counted_on_the_batched_path(tmp_path, monkeypatch):
    jfr, tfr = _pair(tmp_path)
    (a,) = _scenes(47, 1)
    frames = [np.concatenate([a, a], axis=1)] * 8
    jfr.process_frames(frames, annotate=False, batch_size=8)
    tfr.process_frames(frames, annotate=False, batch_size=8)
    assert tfr.gallery.count == jfr.gallery.count > 0
    assert tfr.counters["unknown_enrolled"] == jfr.counters["unknown_enrolled"] == 0
    jfr.close(), tfr.close()
