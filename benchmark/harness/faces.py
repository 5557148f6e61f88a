"""The synthetic faces the traffic shows: an identity's parameters and
its rendered patch with the face's box.  A frozen copy of the scene
generator the detectors and the encoder were trained on
(``identity_params``, ``render_face_patch`` and OpenCV's area resize in
numpy), so that the traffic does not change when the program's copy
does.
"""

from __future__ import annotations

import numpy as np


def identity_params(rng: np.random.Generator) -> dict:
    return {
        "skin": rng.uniform(90, 220, 3),
        "hair": rng.uniform(10, 120, 3),
        "face_w": rng.uniform(0.30, 0.42),
        "face_h": rng.uniform(0.40, 0.52),
        "eye_dx": rng.uniform(0.10, 0.17),
        "eye_y": rng.uniform(-0.12, -0.04),
        "eye_r": rng.uniform(0.025, 0.05),
        "iris": rng.uniform(20, 160, 3),
        "brow_t": rng.uniform(0.01, 0.035),
        "brow_tilt": rng.uniform(-0.03, 0.03),
        "nose_w": rng.uniform(0.015, 0.045),
        "nose_l": rng.uniform(0.08, 0.16),
        "mouth_w": rng.uniform(0.08, 0.16),
        "mouth_y": rng.uniform(0.14, 0.24),
        "mouth_t": rng.uniform(0.012, 0.035),
        "lip": rng.uniform(60, 180, 3) * np.array([1.4, 0.7, 0.7]),
        "hair_top": rng.uniform(0.05, 0.22),
        "tex_seed": int(rng.integers(0, 2**31)),
        "tex_amp": rng.uniform(3, 14),
    }


def _area_weights(src: int, dst: int, linear: bool) -> np.ndarray:
    """(dst, src) weights of ``cv2.resize(..., INTER_AREA)`` along one
    axis (float images): the area average, or with ``linear`` (OpenCV's
    choice for both axes when either one is enlarged) its area-mode
    linear coefficients."""
    w = np.zeros((dst, src), np.float64)
    scale = src / dst
    if not linear:  # shrink: area average (computeResizeAreaTab)
        for dx in range(dst):
            fsx1 = dx * scale
            fsx2 = fsx1 + scale
            cell = min(scale, src - fsx1)
            sx1 = int(np.ceil(fsx1))
            sx2 = min(int(np.floor(fsx2)), src - 1)
            sx1 = min(sx1, sx2)
            if sx1 - fsx1 > 1e-3:
                w[dx, sx1 - 1] += (sx1 - fsx1) / cell
            for sx in range(sx1, sx2):
                w[dx, sx] += 1.0 / cell
            if fsx2 - sx2 > 1e-3:
                w[dx, sx2] += min(min(fsx2 - sx2, 1.0), cell) / cell
        return w
    inv = dst / src  # OpenCV's area-mode linear coefficients
    for dx in range(dst):
        sx = int(np.floor(dx * scale))
        fx = np.float32((dx + 1) - (sx + 1) * inv)
        fx = 0.0 if fx <= 0 else float(fx - np.floor(fx))
        if sx >= src - 1:
            sx, fx = src - 1, 0.0
        w[dx, sx] += 1.0 - fx
        w[dx, min(sx + 1, src - 1)] += fx
    return w


def resize_area(img: np.ndarray, size) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=INTER_AREA)`` of a float
    (H, W[, C]) image; ``size`` is ``(h, w)``, or one int for a square."""
    oh, ow = (size, size) if isinstance(size, int) else size
    linear = img.shape[0] < oh or img.shape[1] < ow
    wy = _area_weights(img.shape[0], oh, linear).astype(np.float32)
    wx = _area_weights(img.shape[1], ow, linear).astype(np.float32)
    out = np.tensordot(wy, img.astype(np.float32), axes=(1, 0))
    out = np.tensordot(wx, out, axes=(1, 1))  # (size_x, size_y, ...)
    return np.swapaxes(out, 0, 1).astype(np.float32)


def render_face_patch(p: dict, rng: np.random.Generator, size: int = 160,
                      max_rot: float = 0.35):
    """One identity as an alpha-masked patch with analytic ground truth:
    ``(img (size,size,3) f32 RGB, mask (size,size) bool, bbox (4,) xywh,
    lm5 (5,2))``."""
    s = size
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / s - 0.5
    dx, dy = rng.uniform(-0.04, 0.04, 2)
    scale = rng.uniform(0.85, 1.10)
    rot = rng.uniform(-max_rot, max_rot)
    light = rng.uniform(0.6, 1.4) * rng.uniform(0.85, 1.15, 3)

    ca, sa = np.cos(rot), np.sin(rot)
    u = (ca * (xx - dx) + sa * (yy - dy)) / scale
    v = (-sa * (xx - dx) + ca * (yy - dy)) / scale

    face = (u / p["face_w"]) ** 2 + (v / p["face_h"]) ** 2 <= 1.0

    trng = np.random.default_rng(p["tex_seed"])
    fr = trng.uniform(0, 2 * np.pi, 6)
    tex = (
        np.sin(u * trng.uniform(18, 42) + fr[0]) * np.sin(v * trng.uniform(18, 42) + fr[1])
        + np.sin((u + v) * trng.uniform(12, 30) + fr[2])
    )
    img = np.zeros((s, s, 3), np.float32)
    skin = p["skin"][None, None, :] + p["tex_amp"] * tex[..., None]
    img = np.where(face[..., None], skin, img)

    hair = face & (v < -p["face_h"] + p["hair_top"])
    img = np.where(hair[..., None], p["hair"][None, None, :], img)

    for side in (-1.0, 1.0):
        ex = side * p["eye_dx"]
        eye = (u - ex) ** 2 + (v - p["eye_y"]) ** 2 <= p["eye_r"] ** 2
        img = np.where(eye[..., None], np.float32(235.0), img)
        iris = (u - ex) ** 2 + (v - p["eye_y"]) ** 2 <= (p["eye_r"] * 0.5) ** 2
        img = np.where(iris[..., None], p["iris"][None, None, :], img)
        brow = (
            (np.abs(u - ex) <= p["eye_r"] * 1.6)
            & (np.abs(v - (p["eye_y"] - 2.2 * p["eye_r"]) - p["brow_tilt"] * side * (u - ex) / p["eye_r"]) <= p["brow_t"])
        )
        img = np.where(brow[..., None], p["hair"][None, None, :] * 0.8, img)

    nose = (np.abs(u) <= p["nose_w"]) & (v >= p["eye_y"]) & (v <= p["eye_y"] + p["nose_l"])
    img = np.where(nose[..., None], skin * 0.82, img)

    mouth = (np.abs(u) <= p["mouth_w"]) & (np.abs(v - p["mouth_y"]) <= p["mouth_t"])
    img = np.where(mouth[..., None], p["lip"][None, None, :], img)

    img = np.clip(img * light, 0, 255) * face[..., None]

    def to_px(fu: float, fv: float) -> np.ndarray:
        cx = dx + scale * (ca * fu - sa * fv)
        cy = dy + scale * (sa * fu + ca * fv)
        return np.array([(cx + 0.5) * s, (cy + 0.5) * s], np.float32)

    hx = scale * np.sqrt((p["face_w"] * ca) ** 2 + (p["face_h"] * sa) ** 2)
    hy = scale * np.sqrt((p["face_w"] * sa) ** 2 + (p["face_h"] * ca) ** 2)
    c = to_px(0.0, 0.0)
    bbox = np.array([c[0] - hx * s, c[1] - hy * s, 2 * hx * s, 2 * hy * s], np.float32)
    lm5 = np.stack([
        to_px(+p["eye_dx"], p["eye_y"]),
        to_px(-p["eye_dx"], p["eye_y"]),
        to_px(0.0, p["eye_y"] + p["nose_l"]),
        to_px(+p["mouth_w"], p["mouth_y"]),
        to_px(-p["mouth_w"], p["mouth_y"]),
    ]).astype(np.float32)
    return img, face, bbox, lm5
