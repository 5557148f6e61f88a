"""Label text without OpenCV: ``fire_tpu_torch.pipeline.text_atlas``
against ``cv2.putText`` (FONT_HERSHEY_SIMPLEX, scale 0.5, thickness 1 and
2, the annotators' two calls) and the annotators without OpenCV against
the JAX package's: whole strings, pixel-equal (uint8 equality), on noisy
backgrounds, in colour and in grey, clipped at all four frame edges."""

import builtins

import cv2
import numpy as np
import pytest

from fire_tpu.pipeline import annotate as JAnn
from fire_tpu_torch.pipeline import annotate as TAnn
from fire_tpu_torch.pipeline import text_atlas

F = cv2.FONT_HERSHEY_SIMPLEX
PRINTABLE = "".join(chr(c) for c in range(32, 127))
STRINGS = ["Unknown_1a2b3c4d (0.93)", "0.9876", "alice", PRINTABLE[:48], PRINTABLE[48:],
           "WWW mmm ||| ...", "Person_7 (1.00)"]


def _bg(seed, hw=(60, 220)):
    return np.random.default_rng(seed).integers(0, 256, (*hw, 3), dtype=np.uint8)


def _both(text, org, color, thickness, bg):
    ref, got = bg.copy(), bg.copy()
    cv2.putText(ref, text, org, F, 0.5, color, thickness)
    text_atlas.put_text(got, text, org, color, thickness)
    return ref, got


@pytest.mark.parametrize("thickness", [1, 2])
@pytest.mark.parametrize("text", STRINGS)
def test_whole_strings_equal_cv2(thickness, text):
    for k, color in enumerate([(0, 255, 0), (0, 0, 255), (17, 200, 93)]):
        ref, got = _both(text, (4, 30), color, thickness, _bg(k))
        np.testing.assert_array_equal(got, ref)


EDGES = {"left": (-23, 30), "right": (180, 30), "top": (4, 6), "bottom": (4, 64),
         "corner": (-5, 3), "outside": (-500, 30)}


@pytest.mark.parametrize("thickness", [1, 2])
@pytest.mark.parametrize("edge", sorted(EDGES))
def test_clipped_at_frame_edges_as_cv2_clips(thickness, edge):
    for text in STRINGS[:3]:
        ref, got = _both(text, EDGES[edge], (0, 255, 0), thickness, _bg(5))
        np.testing.assert_array_equal(got, ref)


def test_grey_images_and_random_cases_equal_cv2():
    assert text_atlas.check_atlas(cv2, text_atlas.load_atlas(), trials=200, seed=11) == 0
    grey = _bg(6)[..., 0].copy()
    ref, got = grey.copy(), grey.copy()
    cv2.putText(ref, "grey 0.42", (3, 20), F, 0.5, 200, 2)
    text_atlas.put_text(got, "grey 0.42", (3, 20), (200,), 2)
    np.testing.assert_array_equal(got, ref)


def test_control_characters_draw_as_cv2_draws_them():
    """OpenCV draws a control character as ``?``; so does the atlas (and
    any non-ASCII character, which OpenCV draws from its own font)."""
    for text in ["a\tb", "x\x7fy"]:
        ref, got = _both(text, (4, 30), (0, 255, 0), 2, _bg(7))
        np.testing.assert_array_equal(got, ref)
    got = _bg(8)
    text_atlas.put_text(got, "é", (4, 30), (0, 255, 0), 1)
    ref = _bg(8)
    cv2.putText(ref, "?", (4, 30), F, 0.5, (0, 255, 0), 1)
    np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError, match="thickness"):
        text_atlas.put_text(got, "a", (4, 30), (0, 255, 0), 3)


def test_committed_atlas_is_what_the_generator_writes():
    built = text_atlas.build_atlas(cv2)
    committed = text_atlas.load_atlas()
    assert sorted(built) == sorted(committed) == ["advance", "alpha", "opencv", "origin"]
    for k in ("alpha", "advance", "origin"):
        np.testing.assert_array_equal(built[k], committed[k])
    assert str(committed["opencv"]) == cv2.__version__
    assert committed["alpha"].shape[:2] == (2, 95) and committed["alpha"].dtype == np.uint8


@pytest.fixture
def no_cv2(monkeypatch):
    real = builtins.__import__

    def fake(name, *args, **kw):
        if name == "cv2":
            raise ImportError("No module named 'cv2'")
        return real(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", fake)


FACES = [{"label": "alice", "confidence": 0.93, "bbox": [20, 30, 40, 45],
          "landmarks": np.array([[30, 40], [50, 41], [40, 50], [33, 60], [48, 61]])},
         {"label": "Unknown_1a2b3c4d", "confidence": 1.0, "bbox": [90, 5, 50, 60]},
         {"label": "edge_right", "confidence": 0.5, "bbox": [150, 40, 30, 30]},
         {"label": "edge_left", "confidence": 0.71, "bbox": [-10, 70, 25, 15]},
         {"label": "edge_bottom", "confidence": 0.66, "bbox": [60, 88, 20, 10]}]


@pytest.mark.parametrize("with_confidence", [False, True])
def test_annotators_without_cv2_equal_jax(no_cv2, with_confidence):
    frame = _bg(9, (96, 170))
    np.testing.assert_array_equal(
        TAnn.annotate_faces(frame, FACES, with_confidence=with_confidence),
        JAnn.annotate_faces(frame, FACES, with_confidence=with_confidence))
    np.testing.assert_array_equal(TAnn.visualize_detections(frame, FACES),
                                  JAnn.visualize_detections(frame, FACES))
