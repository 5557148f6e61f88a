"""Synthetic multi-identity face-like dataset (numpy-only copy of
``fire_tpu.train.synth``: ``_identity_params``, ``render_identity``,
``generate`` and ``main``).

Each **identity** is a fixed draw of geometry and appearance parameters;
each **image** re-renders it under augmentation (pose, scale, rotation,
illumination, clutter, occlusion, noise, blur).  Random draws happen in
the same order as in the JAX package, so a seed gives the same images,
byte for byte.

``python -m fire_tpu_torch.train.synth --out DIR`` writes the
identity-folder layout (``DIR/train/<id>/*.png`` and the held-out
``DIR/test/<id>/*.png``) that ``python -m fire_tpu_torch.eval`` reads.
The PNGs are written by :mod:`fire_tpu_torch.utils.imageio`, without
OpenCV.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from fire_tpu_torch.utils import imageio


def _identity_params(rng: np.random.Generator) -> dict:
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


def render_identity(
    p: dict,
    rng: np.random.Generator,
    size: int = 160,
) -> np.ndarray:
    """One augmented RGB uint8 image of identity ``p``."""
    s = size
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / s - 0.5

    # augmentation draw — deliberately harsh (pose, scale, rotation,
    # color cast, clutter, occlusion) so an untrained random-feature
    # encoder scores near chance and the AUC gain is attributable to
    # training
    dx, dy = rng.uniform(-0.12, 0.12, 2)
    scale = rng.uniform(0.70, 1.30)
    rot = rng.uniform(-0.35, 0.35)
    light = rng.uniform(0.55, 1.45) * rng.uniform(0.8, 1.2, 3)
    grad_dir = rng.uniform(-1, 1, 2)

    # rotate/scale/shift the canvas coordinates into face space
    ca, sa = np.cos(rot), np.sin(rot)
    u = (ca * (xx - dx) + sa * (yy - dy)) / scale
    v = (-sa * (xx - dx) + ca * (yy - dy)) / scale

    img = np.empty((s, s, 3), np.float32)
    img[:] = rng.uniform(60, 220, 3)  # background tone
    img += 40 * (grad_dir[0] * xx + grad_dir[1] * yy)[..., None]  # bg gradient
    for _ in range(rng.integers(0, 4)):  # background clutter blocks
        bx, by = rng.integers(0, s, 2)
        bw, bh = rng.integers(s // 8, s // 2, 2)
        img[by : by + bh, bx : bx + bw] = rng.uniform(30, 230, 3)

    face = (u / p["face_w"]) ** 2 + (v / p["face_h"]) ** 2 <= 1.0
    # per-identity stable texture, sampled in face coordinates
    trng = np.random.default_rng(p["tex_seed"])
    fr = trng.uniform(0, 2 * np.pi, 6)
    tex = (
        np.sin(u * trng.uniform(18, 42) + fr[0]) * np.sin(v * trng.uniform(18, 42) + fr[1])
        + np.sin((u + v) * trng.uniform(12, 30) + fr[2])
    )
    skin = p["skin"][None, None, :] + p["tex_amp"] * tex[..., None]
    img = np.where(face[..., None], skin, img)

    # hair: cap above the face ellipse
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

    img *= light
    if rng.random() < 0.35:  # partial occlusion (hand/object/crop edge)
        ox = rng.integers(0, s - s // 5)
        oy = rng.integers(0, s - s // 5)
        ow, oh = rng.integers(s // 6, s // 3, 2)
        img[oy : oy + oh, ox : ox + ow] = rng.uniform(20, 235, 3)
    img += rng.normal(0, 7.0, img.shape)  # sensor noise
    if rng.random() < 0.3:  # light blur ~ defocus
        img = (img + np.roll(img, 1, 0) + np.roll(img, 1, 1) + np.roll(np.roll(img, 1, 0), 1, 1)) / 4.0
    return np.clip(img, 0, 255).astype(np.uint8)


def generate(
    out_dir: str,
    n_identities: int = 48,
    images_per_id: int = 24,
    holdout_per_id: int = 6,
    size: int = 160,
    seed: int = 0,
) -> Tuple[str, str]:
    """Write ``out_dir/train`` and ``out_dir/test`` identity folders.
    Held-out images are fresh augmentation draws of the SAME identities
    (verification AUC is a same/different-identity task, eval.py)."""
    id_rng = np.random.default_rng(seed)
    train_root = os.path.join(out_dir, "train")
    test_root = os.path.join(out_dir, "test")
    for i in range(n_identities):
        p = _identity_params(id_rng)
        aug = np.random.default_rng(seed * 77_003 + i)
        for split, root, n in (
            ("train", train_root, images_per_id),
            ("test", test_root, holdout_per_id),
        ):
            d = os.path.join(root, f"id{i:04d}")
            os.makedirs(d, exist_ok=True)
            for k in range(n):
                img = render_identity(p, aug, size)
                imageio.imwrite(os.path.join(d, f"{split}_{k:03d}.png"), img[..., ::-1])
    return train_root, test_root


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description="FIRE-TPU synthetic identity dataset (PyTorch port)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--identities", type=int, default=48)
    ap.add_argument("--images", type=int, default=24)
    ap.add_argument("--holdout", type=int, default=6)
    ap.add_argument("--size", type=int, default=160)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args()
    tr, te = generate(a.out, a.identities, a.images, a.holdout, a.size, a.seed)
    print(f"train: {tr}\ntest:  {te}")


if __name__ == "__main__":
    main()
