"""Legacy eye-angle alignment helpers (counterpart of
``fire_tpu.utils.legacy_align``).

The reference carries an older 2-point alignment path (rotate the whole
image by the eye-line angle, then rotate the facial box) that its main
pipeline no longer uses; the 3-point affine
(:mod:`fire_tpu_torch.ops.affine`) replaced it.  Kept for API
completeness: host-side numpy and math, with OpenCV imported at the call
in ``alignment_procedure``, as in JAX.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def find_euclidean_distance(a, b) -> float:
    """processing/postprocess.py:10-30."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.sum((a - b) ** 2)))


def eye_angle(left_eye, right_eye) -> Tuple[float, int]:
    """Rotation angle (degrees) + direction from the eye line — the
    cosine-rule computation of processing/postprocess.py:48-86."""
    lx, ly = left_eye
    rx, ry = right_eye
    if ly > ry:
        point3 = (rx, ly)
        direction = -1
    else:
        point3 = (lx, ry)
        direction = 1
    a = find_euclidean_distance(left_eye, point3)
    b = find_euclidean_distance(right_eye, point3)
    c = find_euclidean_distance(right_eye, left_eye)
    if b == 0 or c == 0:
        return 0.0, direction
    cos_a = (b * b + c * c - a * a) / (2 * b * c)
    cos_a = min(1.0, max(-1.0, cos_a))  # fp guard (postprocess.py:73-77)
    angle = math.degrees(math.acos(cos_a))
    if direction == -1:
        angle = 90 - angle
    return angle, direction


def alignment_procedure(img: np.ndarray, left_eye, right_eye, nose=None):
    """Rotate the whole image so the eye line is horizontal
    (processing/postprocess.py:33-95; PIL-rotate equivalent via cv2)."""
    import cv2

    angle, direction = eye_angle(left_eye, right_eye)
    if angle == 0.0:
        return img, 0.0, direction
    h, w = img.shape[:2]
    m = cv2.getRotationMatrix2D((w / 2.0, h / 2.0), direction * angle, 1.0)
    rotated = cv2.warpAffine(img, m, (w, h))
    return rotated, angle, direction


def rotate_facial_area(
    facial_area: Tuple[int, int, int, int], angle: float, direction: int,
    size: Tuple[int, int],
) -> Tuple[int, int, int, int]:
    """Project an (x1,y1,x2,y2) box through the rotation
    (processing/postprocess.py:98-143)."""
    rad = math.radians(angle)
    width, height = size
    x = (facial_area[0] + facial_area[2]) / 2 - width / 2
    y = (facial_area[1] + facial_area[3]) / 2 - height / 2
    x_new = x * math.cos(rad) + y * direction * math.sin(rad)
    y_new = -x * direction * math.sin(rad) + y * math.cos(rad)
    x_new += width / 2
    y_new += height / 2
    hw = (facial_area[2] - facial_area[0]) / 2
    hh = (facial_area[3] - facial_area[1]) / 2
    return (
        max(int(x_new - hw), 0),
        max(int(y_new - hh), 0),
        min(int(x_new + hw), width),
        min(int(y_new + hh), height),
    )
