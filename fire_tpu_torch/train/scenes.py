"""Synthetic detection scenes with exact ground truth (numpy-only copy
of ``fire_tpu.train.scenes``: ``render_face_patch``, ``compose_scene``,
``make_identities`` and ``render_scene_video``).

The JAX package composes scenes with OpenCV (``cv2.resize`` with
``INTER_AREA`` and ``cv2.GaussianBlur``); the machine with the card has
no OpenCV, so both are written here in numpy with OpenCV's float
semantics: area averaging when shrinking, OpenCV's area-mode linear
weights when enlarging, and the fixed 3- and 5-tap Gaussian kernels
with reflect-101 borders.  Random draws happen in the same order, so a
seed gives the same scene as the JAX package up to float rounding.

A ground-truth video's frames come from :func:`scene_video` without
OpenCV; :func:`render_scene_video` writes them to an XVID file, which
needs OpenCV, as in JAX.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import numpy as np

from fire_tpu_torch.train.synth import _identity_params


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


def resize_area_u8(img: np.ndarray, size) -> np.ndarray:
    """:func:`resize_area` of a uint8 image, rounded back to uint8 as
    OpenCV returns it (half up; OpenCV's fixed-point enlarging can land
    one level away)."""
    return np.clip(np.floor(resize_area(img.astype(np.float32), size) + 0.5),
                   0, 255).astype(np.uint8)


_SMALL_GAUSS = {3: (0.25, 0.5, 0.25), 5: (0.0625, 0.25, 0.375, 0.25, 0.0625)}


def gaussian_blur(img: np.ndarray, k: int) -> np.ndarray:
    """``cv2.GaussianBlur(img, (k, k), 0)`` for k ∈ {3, 5}: OpenCV's
    fixed small kernels, reflect-101 borders, separable."""
    taps = np.asarray(_SMALL_GAUSS[k], np.float32)
    r = k // 2
    pad = [(r, r), (r, r)] + [(0, 0)] * (img.ndim - 2)
    p = np.pad(img.astype(np.float32), pad, mode="reflect")
    h, w = img.shape[:2]
    rows = sum(taps[i] * p[i : i + h] for i in range(k))
    return sum(taps[i] * rows[:, i : i + w] for i in range(k)).astype(np.float32)


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


def _iou_xywh(a: np.ndarray, b: np.ndarray) -> float:
    ax2, ay2 = a[0] + a[2], a[1] + a[3]
    bx2, by2 = b[0] + b[2], b[1] + b[3]
    iw = max(0.0, min(ax2, bx2) - max(a[0], b[0]))
    ih = max(0.0, min(ay2, by2) - max(a[1], b[1]))
    inter = iw * ih
    union = a[2] * a[3] + b[2] * b[3] - inter
    return inter / union if union > 0 else 0.0


def _distractor(canvas: np.ndarray, rng: np.random.Generator) -> None:
    """Skin-tone ellipse without facial structure (a hard negative)."""
    h, w = canvas.shape[:2]
    r = rng.integers(8, max(9, min(h, w) // 4))
    cy, cx = rng.integers(r, h - r + 1), rng.integers(r, w - r + 1)
    ry = int(r * rng.uniform(0.7, 1.4))
    yy, xx = np.mgrid[max(0, cy - ry) : min(h, cy + ry), max(0, cx - r) : min(w, cx + r)]
    m = ((xx - cx) / r) ** 2 + ((yy - cy) / max(ry, 1)) ** 2 <= 1.0
    tone = rng.uniform(90, 220, 3).astype(np.float32)
    noise = rng.normal(0, rng.uniform(3, 14), (*m.shape, 1)).astype(np.float32)
    region = canvas[max(0, cy - ry) : min(h, cy + ry), max(0, cx - r) : min(w, cx + r)]
    region[m] = np.clip(tone[None, :] + noise[m], 0, 255)


def compose_scene(
    rng: np.random.Generator,
    identities: List[dict],
    hw: Tuple[int, int] = (480, 640),
    n_faces: Tuple[int, int] = (1, 3),
    face_px: Tuple[int, int] = (24, 192),
    n_distractors: Tuple[int, int] = (0, 3),
    occlusion_prob: float = 0.25,
    patch: int = 160,
):
    """One scene: ``(img_bgr_u8 (H, W, 3), boxes (N, 4) xywh,
    lm5s (N, 5, 2))``.  Faces never overlap above IoU 0.3."""
    h, w = hw
    canvas = np.empty((h, w, 3), np.float32)
    canvas[:] = rng.uniform(50, 220, 3)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    gdir = rng.uniform(-1, 1, 2)
    canvas += 40 * (gdir[0] * xx / w + gdir[1] * yy / h)[..., None]
    for _ in range(rng.integers(0, 5)):
        bx, by = rng.integers(0, w), rng.integers(0, h)
        bw, bh = rng.integers(w // 10, w // 3), rng.integers(h // 10, h // 3)
        canvas[by : by + bh, bx : bx + bw] = rng.uniform(25, 235, 3)
    for _ in range(rng.integers(n_distractors[0], n_distractors[1] + 1)):
        _distractor(canvas, rng)

    boxes, lms = [], []
    lo = max(n_faces[0], 0)
    hi = max(n_faces[1], lo)
    target_n = int(rng.integers(lo, hi + 1))
    attempts = 0
    while len(boxes) < target_n and attempts < target_n * 8:
        attempts += 1
        ident = int(rng.integers(0, len(identities)))
        img, mask, bbox, lm5 = render_face_patch(identities[ident], rng, patch)
        fp_hi = min(face_px[1], h - 2, w - 2)
        fp = int(rng.integers(face_px[0], max(fp_hi, face_px[0]) + 1))
        s = fp / patch
        ph = max(int(round(patch * s)), 4)
        x0 = int(rng.integers(0, max(w - ph, 1)))
        y0 = int(rng.integers(0, max(h - ph, 1)))
        box = np.array([x0 + bbox[0] * s, y0 + bbox[1] * s, bbox[2] * s, bbox[3] * s], np.float32)
        if any(_iou_xywh(box, b) > 0.3 for b in boxes):
            continue
        small = resize_area(img, ph)
        a = np.clip(resize_area(mask.astype(np.float32), ph), 0.0, 1.0)[..., None]
        region = canvas[y0 : y0 + ph, x0 : x0 + ph]
        canvas[y0 : y0 + ph, x0 : x0 + ph] = region * (1 - a) + small[:, :, ::-1] * a
        boxes.append(box)
        lms.append(np.stack([lm5[:, 0] * s + x0, lm5[:, 1] * s + y0], axis=-1))

    if rng.random() < occlusion_prob and boxes:
        i = int(rng.integers(0, len(boxes)))
        bx, by, bw, bh = boxes[i]
        ow, oh = int(bw * rng.uniform(0.2, 0.45)), int(bh * rng.uniform(0.2, 0.45))
        ox = int(np.clip(bx + rng.uniform(0, bw - ow), 0, w - 1))
        oy = int(np.clip(by + rng.uniform(0, bh - oh), 0, h - 1))
        canvas[oy : oy + max(oh, 1), ox : ox + max(ow, 1)] = rng.uniform(20, 235, 3)
    canvas += rng.normal(0, rng.uniform(2, 8), canvas.shape)
    if rng.random() < 0.3:
        canvas = gaussian_blur(canvas, int(rng.integers(1, 3)) * 2 + 1)

    img_u8 = np.clip(canvas, 0, 255).astype(np.uint8)
    if boxes:
        return img_u8, np.stack(boxes), np.stack(lms)
    return img_u8, np.zeros((0, 4), np.float32), np.zeros((0, 5, 2), np.float32)


def make_identities(n: int, seed: int = 0) -> List[dict]:
    rng = np.random.default_rng(seed)
    return [_identity_params(rng) for _ in range(n)]


def scene_video(identities: List[dict], hw: Tuple[int, int] = (1080, 1920),
                n_frames: int = 120, face_px: int = 140, seed: int = 0,
                labels: Optional[List[str]] = None) -> Iterator[tuple]:
    """The frames of :func:`render_scene_video`: one moving actor per
    identity on a linear trajectory that bounces off the frame's edges.
    Yields ``(frame_bgr_u8 (H, W, 3), boxes (N, 4), ident_keys)`` per
    frame."""
    h, w = hw
    rng = np.random.default_rng(seed)
    n_id = len(identities)
    pos = np.stack([
        rng.uniform([0, 0], [w - face_px - 1, h - face_px - 1]) for _ in range(n_id)
    ])
    vel = rng.uniform(-4, 4, (n_id, 2))
    bg = np.empty((h, w, 3), np.float32)
    bg[:] = rng.uniform(60, 200, 3)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    bg += 35 * ((xx / w - 0.5) + 0.3 * (yy / h - 0.5))[..., None]
    for _ in range(6):
        bx, by = rng.integers(0, w), rng.integers(0, h)
        bw, bh = rng.integers(w // 10, w // 3), rng.integers(h // 10, h // 3)
        bg[by : by + bh, bx : bx + bw] = rng.uniform(30, 225, 3)
    # each actor's patch is drawn from a generator seeded per identity, so
    # it is the same in every frame: rendered once
    actors = []
    for i in range(n_id):
        img, mask, bbox, _lm = render_face_patch(
            identities[i], np.random.default_rng(seed * 997 + i),
            face_px if face_px <= 160 else 160, max_rot=0.12)
        s = face_px / img.shape[0]
        ph = int(round(img.shape[0] * s))
        small = resize_area(img, ph)
        msk = np.clip(resize_area(mask.astype(np.float32), ph), 0, 1)[..., None]
        actors.append((small[:, :, ::-1], msk, bbox, s, ph))
    for _f in range(n_frames):
        canvas = bg.copy()
        frame_boxes, frame_ids = [], []
        for i, (small_bgr, msk, bbox, s, ph) in enumerate(actors):
            pos[i] += vel[i]
            for d, limit in ((0, w - face_px - 1), (1, h - face_px - 1)):
                if pos[i, d] < 0 or pos[i, d] > limit:
                    vel[i, d] = -vel[i, d]
                    pos[i, d] = np.clip(pos[i, d], 0, limit)
            x0, y0 = int(pos[i, 0]), int(pos[i, 1])
            region = canvas[y0 : y0 + ph, x0 : x0 + ph]
            canvas[y0 : y0 + ph, x0 : x0 + ph] = region * (1 - msk) + small_bgr * msk
            frame_boxes.append(
                np.array([x0 + bbox[0] * s, y0 + bbox[1] * s, bbox[2] * s, bbox[3] * s]))
            frame_ids.append(labels[i] if labels else i)
        noisy = np.clip(canvas + rng.normal(0, 3, canvas.shape), 0, 255).astype(np.uint8)
        yield noisy, np.stack(frame_boxes), frame_ids


def render_scene_video(path: str, identities: List[dict], hw: Tuple[int, int] = (1080, 1920),
                       n_frames: int = 120, fps: int = 30, face_px: int = 140, seed: int = 0,
                       labels: Optional[List[str]] = None):
    """Write :func:`scene_video`'s frames to ``path`` as XVID (needs
    OpenCV) and return the per-frame GT ``[(boxes (N, 4), ident_keys)]``."""
    from fire_tpu_torch.utils import imageio

    writer = imageio.open_video_writer(path, fps, (hw[1], hw[0]))
    gt = []
    try:
        for frame, boxes, ids in scene_video(identities, hw, n_frames, face_px, seed, labels):
            writer.write(frame)
            gt.append((boxes, ids))
    finally:
        writer.release()
    return gt
