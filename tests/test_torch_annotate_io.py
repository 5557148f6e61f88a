"""Drawing and image files of the port vs OpenCV: everything here is
pixel-exact (uint8 equality), except ``resize_frame_to_screen``, whose
antialiased fallback is held to a mean error of 2 grey levels.
"""

import builtins
import struct

import cv2
import numpy as np
import pytest

from fire_tpu.pipeline import annotate as JAnn
from fire_tpu_torch.pipeline import annotate as TAnn
from fire_tpu_torch.utils import imageio

GREEN, RED = (0, 255, 0), (0, 0, 255)


def _canvas(seed=0, hw=(90, 120)):
    return np.random.default_rng(seed).integers(0, 256, (*hw, 3), dtype=np.uint8)


RECTS = [((10, 12), (60, 50)), ((60, 50), (10, 12)), ((0, 0), (119, 89)), ((-8, -5), (30, 40)),
         ((100, 70), (140, 120)), ((20, 20), (20, 20)), ((30, 10), (31, 60)), ((5, 5), (6, 6)),
         ((200, 200), (260, 260)), ((-30, 20), (150, 21))]


@pytest.mark.parametrize("pt1,pt2", RECTS)
def test_rectangle_pixel_equal_to_cv2(pt1, pt2):
    ours, ref = _canvas(), _canvas()
    TAnn.draw_rectangle(ours, pt1, pt2, GREEN)
    cv2.rectangle(ref, pt1, pt2, GREEN, 2)
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("centre", [(40, 30), (0, 0), (1, 88), (119, 89), (-2, 10), (121, 40),
                                    (300, 300)])
def test_dot_pixel_equal_to_cv2(centre):
    ours, ref = _canvas(1), _canvas(1)
    TAnn.draw_dot(ours, centre, RED)
    cv2.circle(ref, centre, 2, RED, 2)
    np.testing.assert_array_equal(ours, ref)


FACES = [{"label": "alice", "confidence": 0.93, "bbox": [20, 30, 40, 45],
          "landmarks": np.array([[30, 40], [50, 41], [40, 50], [33, 60], [48, 61]])},
         {"label": "Unknown_1a2b3c4d", "confidence": 1.0, "bbox": [90, 5, 50, 60],
          "landmarks": {"left_eye": (100, 20), "right_eye": (125, 22)}}]


@pytest.mark.parametrize("with_confidence", [False, True])
def test_annotate_faces_equal_to_jax(with_confidence):
    """With OpenCV present the text is drawn too, so whole frames match."""
    frame = _canvas(2)
    ours = TAnn.annotate_faces(frame, FACES, with_confidence=with_confidence)
    ref = JAnn.annotate_faces(frame, FACES, with_confidence=with_confidence)
    np.testing.assert_array_equal(ours, ref)
    assert (ours != frame).any() and ours is not frame


def test_visualize_detections_equal_to_jax():
    frame = _canvas(3)
    np.testing.assert_array_equal(TAnn.visualize_detections(frame, FACES),
                                  JAnn.visualize_detections(frame, FACES))


@pytest.fixture
def no_cv2(monkeypatch):
    real = builtins.__import__

    def fake(name, *args, **kw):
        if name == "cv2":
            raise ImportError("No module named 'cv2'")
        return real(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", fake)


def test_without_cv2_boxes_are_drawn_and_text_is_left_off(no_cv2, caplog):
    """Without OpenCV the boxes and, since the glyph atlas, the label
    text too are drawn: whole frames equal the JAX package's (OpenCV's),
    and nothing is logged."""
    frame = _canvas(4)
    with caplog.at_level("WARNING"):
        out = TAnn.annotate_faces(frame, FACES, with_confidence=True)
        vis = TAnn.visualize_detections(frame, FACES)
    ref = frame.copy()
    for f in FACES:
        x, y, w, h = f["bbox"]
        cv2.rectangle(ref, (x, y), (x + w, y + h), GREEN, 2)
    assert (out != ref).any(axis=2)[: 30].sum() > 50  # text above the boxes
    np.testing.assert_array_equal(out, JAnn.annotate_faces(frame, FACES, with_confidence=True))
    np.testing.assert_array_equal(vis, JAnn.visualize_detections(frame, FACES))
    assert not caplog.records


def test_without_cv2_file_and_window_calls_name_what_they_need(no_cv2, tmp_path):
    img = _canvas(5)
    with pytest.raises(ImportError, match=r"\.jpg"):
        imageio.imwrite(str(tmp_path / "a.jpg"), img)
    (tmp_path / "b.png").write_bytes(b"\x89PNG....")
    with pytest.raises(ImportError, match=r"\.png"):
        imageio.imread(str(tmp_path / "b.png"))
    with pytest.raises(ImportError, match="VideoCapture"):
        imageio.open_video("clip.avi")
    with pytest.raises(ImportError, match="VideoWriter"):
        imageio.open_video_writer("out.avi", 30, (64, 48))
    with pytest.raises(ImportError, match="imshow"):
        imageio.imshow("t", img, 1)
    # BMP and PPM need nothing
    for name in ("c.bmp", "c.ppm"):
        imageio.imwrite(str(tmp_path / name), img)
        np.testing.assert_array_equal(imageio.imread(str(tmp_path / name)), img)


@pytest.mark.parametrize("ext", [".bmp", ".ppm", ".png"])
@pytest.mark.parametrize("hw", [(48, 64), (37, 53), (5, 1), (1, 7)])
def test_round_trip_equal_to_cv2(tmp_path, ext, hw):
    """Widths that need BMP row padding included."""
    img = _canvas(6, hw)
    ours, theirs = str(tmp_path / f"ours{ext}"), str(tmp_path / f"cv{ext}")
    imageio.imwrite(ours, img)
    assert cv2.imwrite(theirs, img)
    np.testing.assert_array_equal(cv2.imread(ours), img)       # OpenCV reads what the port wrote
    np.testing.assert_array_equal(imageio.imread(theirs), img)  # the port reads what OpenCV wrote
    np.testing.assert_array_equal(imageio.imread(ours), img)


def test_imread_variants_and_failures(tmp_path):
    img = _canvas(7, (6, 5))
    # a top-down BMP (negative height)
    stride = (5 * 3 + 3) & ~3
    rows = np.zeros((6, stride), np.uint8)
    rows[:, :15] = img.reshape(6, 15)
    head = struct.pack("<2sIHHI", b"BM", 54 + rows.size, 0, 0, 54)
    info = struct.pack("<IiiHHIIiiII", 40, 5, -6, 1, 24, 0, rows.size, 0, 0, 0, 0)
    (tmp_path / "td.bmp").write_bytes(head + info + rows.tobytes())
    np.testing.assert_array_equal(imageio.imread(str(tmp_path / "td.bmp")), img)
    # a PPM with a comment in its header
    (tmp_path / "c.ppm").write_bytes(b"P6\n# made by hand\n5 6\n255\n"
                                     + img[:, :, ::-1].tobytes())
    np.testing.assert_array_equal(imageio.imread(str(tmp_path / "c.ppm")), img)
    assert imageio.imread(str(tmp_path / "missing.bmp")) is None
    # other formats go through OpenCV when it is there
    assert cv2.imwrite(str(tmp_path / "x.png"), img)
    np.testing.assert_array_equal(imageio.imread(str(tmp_path / "x.png")), img)
    imageio.imwrite(str(tmp_path / "y.png"), img)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "y.png")), img)
    with pytest.raises(ValueError, match="uint8"):
        imageio.imwrite(str(tmp_path / "f.bmp"), img.astype(np.float32))


@pytest.mark.parametrize("hw,screen", [((2160, 3840), None), ((300, 400), (200, 200)),
                                       ((1080, 1920), None), ((0, 10), None)])
def test_resize_frame_to_screen(hw, screen):
    frame = _canvas(8, hw) if hw[0] else np.zeros((*hw, 3), np.uint8)
    ours = TAnn.resize_frame_to_screen(frame, screen)
    ref = JAnn.resize_frame_to_screen(frame, screen)
    assert ours.shape == ref.shape and ours.dtype == np.uint8
    if ours.size:
        assert np.abs(ours.astype(int) - ref.astype(int)).mean() <= 2.0
