"""Host-side frame annotation (counterpart of
``fire_tpu.pipeline.annotate``: ``annotate_faces``,
``visualize_detections``, ``resize_frame_to_screen``).

Rectangles and landmark dots are drawn with numpy, pixel for pixel what
``cv2.rectangle(..., thickness=2)`` and ``cv2.circle(..., 2, color, 2)``
draw, so frames can be annotated where OpenCV is not installed.  The
label text is ``cv2.putText`` when OpenCV can be imported, and otherwise
its pixels replayed from the committed glyph atlas
(:mod:`fire_tpu_torch.pipeline.text_atlas`, made with OpenCV 5).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from fire_tpu_torch.ops.image import resize_area
from fire_tpu_torch.pipeline import text_atlas

GREEN = (0, 255, 0)
RED = (0, 0, 255)


def _fill(img: np.ndarray, x0: int, y0: int, x1: int, y1: int, color) -> None:
    """Fill the inclusive pixel box, clipped to the image."""
    h, w = img.shape[:2]
    x0, y0 = max(x0, 0), max(y0, 0)
    x1, y1 = min(x1, w - 1), min(y1, h - 1)
    if x0 <= x1 and y0 <= y1:
        img[y0 : y1 + 1, x0 : x1 + 1] = color


def draw_rectangle(img: np.ndarray, pt1: Tuple[int, int], pt2: Tuple[int, int], color) -> None:
    """``cv2.rectangle(img, pt1, pt2, color, 2)`` in place: each edge is
    a 3-pixel band between its corners, capped at both ends by a
    plus-shaped dot (OpenCV's radius-1 disc)."""
    xa, xb = sorted((int(pt1[0]), int(pt2[0])))
    ya, yb = sorted((int(pt1[1]), int(pt2[1])))
    for y in (ya, yb):
        _fill(img, xa, y - 1, xb, y + 1, color)
        _fill(img, xa - 1, y, xb + 1, y, color)
    for x in (xa, xb):
        _fill(img, x - 1, ya, x + 1, yb, color)
        _fill(img, x, ya - 1, x, yb + 1, color)


_DY, _DX = np.mgrid[-3:4, -3:4]
_DOT = (np.abs(_DX) + np.abs(_DY)) <= 4  # OpenCV's radius-2, thickness-2 circle


def draw_dot(img: np.ndarray, centre: Tuple[int, int], color) -> None:
    """``cv2.circle(img, centre, 2, color, 2)`` in place."""
    h, w = img.shape[:2]
    ys, xs = _DY[_DOT] + int(centre[1]), _DX[_DOT] + int(centre[0])
    ok = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
    img[ys[ok], xs[ok]] = color


def _put_text(img: np.ndarray, text: str, org: Tuple[int, int], color, thickness: int) -> None:
    try:
        import cv2
    except ImportError:
        text_atlas.put_text(img, text, org, color, thickness)
        return
    cv2.putText(img, text, org, cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, thickness)


def annotate_faces(frame: np.ndarray, faces: List[dict],
                   with_confidence: bool = False) -> np.ndarray:
    """Green rectangle + label text above each box, on a copy."""
    out = frame.copy()
    for face in faces:
        x, y, w, h = [int(v) for v in face["bbox"]]
        draw_rectangle(out, (x, y), (x + w, y + h), GREEN)
        if with_confidence and "confidence" in face:
            text = f"{face['label']} ({face['confidence']:.2f})"
        else:
            text = f"{face['label']}"
        _put_text(out, text, (x, y - 10), GREEN, 2)
    return out


def visualize_detections(image: np.ndarray, faces, box_color=GREEN,
                         landmark_color=RED) -> np.ndarray:
    """Draw raw detections (bbox + landmarks + confidence) on a copy."""
    out = image.copy()
    for face in faces:
        x, y, w, h = [int(v) for v in face["bbox"]]
        draw_rectangle(out, (x, y), (x + w, y + h), box_color)
        lms = face.get("landmarks")
        if lms is not None:
            for p in (lms.values() if isinstance(lms, dict) else lms):
                draw_dot(out, (int(p[0]), int(p[1])), landmark_color)
        if "confidence" in face:
            _put_text(out, f"{face['confidence']:.4f}", (x, y - 10), RED, 1)
    return out


def resize_frame_to_screen(frame: np.ndarray,
                           screen_wh: Optional[tuple] = None) -> np.ndarray:
    """Aspect-preserving fit to the display (default 1920×1080), by the
    port's area resize on the host."""
    sw, sh = screen_wh or (1920, 1080)
    h, w = frame.shape[:2]
    if h == 0 or w == 0:
        return frame
    fa, sa = w / h, sw / sh
    if fa > sa:
        nw, nh = sw, int(sw / fa)
    else:
        nh, nw = sh, int(sh * fa)
    if nw <= 0 or nh <= 0:
        return frame
    if (nh, nw) == (h, w):
        return frame
    out = resize_area(torch.from_numpy(np.ascontiguousarray(frame)).float(), (nh, nw))
    return out.round().clamp(0, 255).to(torch.uint8).numpy()
