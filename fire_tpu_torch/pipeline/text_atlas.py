"""Label text without OpenCV: ``cv2.putText`` at the two settings the
annotators use, replayed from a committed glyph atlas.

``annotate_faces`` and ``visualize_detections`` call
``cv2.putText(img, text, org, FONT_HERSHEY_SIMPLEX, 0.5, color, t)``
with thickness ``t`` = 2 and 1.  OpenCV 5 renders it antialiased: glyph
by glyph, left to right, each glyph an 8-bit coverage mask ``a`` placed
at a whole-pixel pen position and blended into the image as
``round((dst·(255 − a) + color·a) / 255)``, clipped at the image's
edges; the pen then moves by the glyph's whole-pixel advance (no
kerning).  ``text_atlas.npz`` beside this module holds, for each
printable ASCII character and each thickness, that mask and that
advance, as the OpenCV release recorded in the file (``opencv``)
rendered them; :func:`put_text` replays them.  OpenCV 4 draws these
fonts as unantialiased Hershey strokes, so its pixels differ from the
atlas's; where any OpenCV is installed the annotators call it instead.
Characters outside printable ASCII are drawn as ``?`` (OpenCV 5 draws
``?`` for control characters; for other Unicode it draws a glyph the
atlas does not hold).

The atlas is made with OpenCV on a machine that has it, and checked
there against ``cv2.putText`` on random strings, backgrounds, colours
and origins, edges included::

    python -m fire_tpu_torch.pipeline.text_atlas   # rewrites text_atlas.npz
"""

from __future__ import annotations

import functools
import os
from typing import Dict, Tuple

import numpy as np

ATLAS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "text_atlas.npz")
FIRST, LAST = 32, 126  # printable ASCII
THICKNESSES = (1, 2)
SCALE = 0.5


@functools.lru_cache(maxsize=None)
def load_atlas() -> Dict[str, np.ndarray]:
    with np.load(ATLAS_PATH, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def put_text(img: np.ndarray, text: str, org: Tuple[int, int], color, thickness: int) -> None:
    """``cv2.putText(img, text, org, FONT_HERSHEY_SIMPLEX, 0.5, color,
    thickness)`` in place, for thickness 1 or 2 and an (H, W) or
    (H, W, C) uint8 image."""
    _blit(load_atlas(), img, text, org, color, thickness)


def _blit(atlas: Dict[str, np.ndarray], img: np.ndarray, text: str, org: Tuple[int, int],
          color, thickness: int) -> None:
    if thickness not in THICKNESSES:
        raise ValueError(f"the text atlas holds thickness 1 and 2, not {thickness}")
    t = THICKNESSES.index(thickness)
    alpha, advance = atlas["alpha"][t], atlas["advance"][t]
    oy, ox = (int(v) for v in atlas["origin"])
    gh, gw = alpha.shape[1:]
    pix = img if img.ndim == 3 else img[..., None]
    h, w, ch = pix.shape
    col = np.asarray(color, np.int64).reshape(-1)[:ch]
    pen_x, top = int(org[0]) - ox, int(org[1]) - oy
    y0, y1 = max(top, 0), min(top + gh, h)
    for c in text:
        code = ord(c)
        i = (code if FIRST <= code <= LAST else ord("?")) - FIRST
        x0, x1 = max(pen_x, 0), min(pen_x + gw, w)
        if y0 < y1 and x0 < x1:
            a = alpha[i, y0 - top : y1 - top, x0 - pen_x : x1 - pen_x, None].astype(np.int64)
            dst = pix[y0:y1, x0:x1].astype(np.int64)
            pix[y0:y1, x0:x1] = (dst * (255 - a) + col * a + 127) // 255
        pen_x += int(advance[i])


# ------------------------------------------------------------- generator --


def build_atlas(cv2) -> Dict[str, np.ndarray]:
    """Render every glyph alone with ``cv2.putText`` and read its mask and
    its advance."""
    canvas_h, canvas_w, oy, ox = 64, 96, 40, 32
    chars = [chr(c) for c in range(FIRST, LAST + 1)]

    def render(text, thickness):
        img = np.zeros((canvas_h, canvas_w), np.uint8)
        cv2.putText(img, text, (ox, oy), cv2.FONT_HERSHEY_SIMPLEX, SCALE, 255, thickness)
        return img.astype(np.int64)

    masks = np.stack([np.stack([render(c, t) for c in chars]) for t in THICKNESSES])
    ys, xs = np.nonzero(masks.any(axis=(0, 1)))
    if ys.min() == 0 or xs.min() == 0 or ys.max() == canvas_h - 1 or xs.max() == canvas_w - 1:
        raise RuntimeError("a glyph reaches the edge of the rendering canvas")
    box = masks[:, :, ys.min() : ys.max() + 1, xs.min() : xs.max() + 1]

    probe = chars.index("H")
    advance = np.zeros((len(THICKNESSES), len(chars)), np.int16)
    for t, thickness in enumerate(THICKNESSES):
        for i, c in enumerate(chars):
            pair = render(c + "H", thickness)
            hits = []
            for dx in range(canvas_w - ox):
                a = np.roll(masks[t, probe], dx, axis=1)
                if np.array_equal((masks[t, i] * (255 - a) + 255 * a + 127) // 255, pair):
                    hits.append(dx)
            if len(hits) != 1:
                raise RuntimeError(f"no single advance fits {c!r} at thickness {thickness}: {hits}")
            advance[t, i] = hits[0]
    return {"alpha": box.astype(np.uint8), "advance": advance,
            "origin": np.array([oy - ys.min(), ox - xs.min()], np.int16),
            "opencv": np.array(cv2.__version__)}


def check_atlas(cv2, atlas: Dict[str, np.ndarray], trials: int = 400, seed: int = 0) -> int:
    """Strings, backgrounds, colours and origins (edges included) drawn
    both ways; returns how many of them differ from ``cv2.putText``."""
    rng = np.random.default_rng(seed)
    chars = [chr(c) for c in range(FIRST, LAST + 1)]
    bad = 0
    for n in range(trials):
        thickness = THICKNESSES[n % 2]
        text = "".join(rng.choice(chars, int(rng.integers(1, 25))))
        shape = (int(rng.integers(5, 60)), int(rng.integers(5, 200)), 3)
        bg = rng.integers(0, 256, shape).astype(np.uint8)
        org = (int(rng.integers(-60, shape[1] + 5)), int(rng.integers(-10, shape[0] + 15)))
        color = tuple(int(v) for v in rng.integers(0, 256, 3))
        ref, got = bg.copy(), bg.copy()
        cv2.putText(ref, text, org, cv2.FONT_HERSHEY_SIMPLEX, SCALE, color, thickness)
        _blit(atlas, got, text, org, color, thickness)
        bad += int(not np.array_equal(ref, got))
    return bad


def main() -> None:
    import cv2

    atlas = build_atlas(cv2)
    bad = check_atlas(cv2, atlas)
    if bad:
        raise SystemExit(f"the atlas differs from cv2.putText on {bad} strings; not written")
    np.savez_compressed(ATLAS_PATH, **atlas)
    print(f"wrote {ATLAS_PATH}: alpha {atlas['alpha'].shape}, OpenCV {cv2.__version__}")


if __name__ == "__main__":
    main()
