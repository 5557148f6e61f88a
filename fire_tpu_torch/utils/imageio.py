"""Image and video files ↔ BGR uint8 arrays without OpenCV where the
format allows it (counterpart of the ``cv2.imread`` / ``cv2.imwrite`` /
``cv2.VideoCapture`` / ``cv2.VideoWriter`` / ``cv2.imshow`` calls in
``fire_tpu.pipeline.recognizer`` and of ``fire_tpu.utils.imageio``).

Uncompressed 24-bit **BMP** and binary **PPM** (``P6``, maxval 255) are
read and written here in numpy; both are formats ``cv2.imread`` reads.
Every other format, and every video or window call, needs OpenCV, which
is imported at the call: without it they raise an ``ImportError`` that
names the format or the call.
"""

from __future__ import annotations

import os
import struct
from typing import Optional

import numpy as np


def require_cv2(what: str):
    """Import OpenCV for ``what`` (a format or a call) or raise an
    ImportError that names it."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            f"{what} needs OpenCV (cv2), which is not installed; without it the port reads "
            "and writes 24-bit BMP and binary PPM images only") from e
    return cv2


# --------------------------------------------------------------------- BMP --


def _read_bmp(data: bytes) -> np.ndarray:
    if len(data) < 54:
        raise ValueError("truncated BMP header")
    offset, = struct.unpack_from("<I", data, 10)
    header, width, height, planes, bpp, compression = struct.unpack_from("<IiiHHI", data, 14)
    if header < 40 or planes != 1:
        raise ValueError("unsupported BMP header")
    if bpp != 24 or compression != 0:
        raise ValueError(f"only uncompressed 24-bit BMP is read here (got {bpp} bpp, "
                         f"compression {compression})")
    h = abs(height)
    stride = (width * 3 + 3) & ~3
    if width <= 0 or h == 0 or offset + stride * h > len(data):
        raise ValueError("BMP pixel data out of range")
    rows = np.frombuffer(data, np.uint8, stride * h, offset).reshape(h, stride)
    img = rows[:, : width * 3].reshape(h, width, 3)
    return np.ascontiguousarray(img[::-1] if height > 0 else img)  # bottom-up unless h < 0


def _write_bmp(img: np.ndarray) -> bytes:
    h, w = img.shape[:2]
    stride = (w * 3 + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, : w * 3] = img[::-1].reshape(h, w * 3)
    head = struct.pack("<2sIHHI", b"BM", 54 + stride * h, 0, 0, 54)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, stride * h, 0, 0, 0, 0)
    return head + info + rows.tobytes()


# --------------------------------------------------------------------- PPM --


def _read_ppm(data: bytes) -> np.ndarray:
    """Binary ``P6`` with maxval 255; ``#`` comments in the header."""
    fields, pos = [], 2
    while len(fields) < 3:
        while pos < len(data) and data[pos : pos + 1].isspace():
            pos += 1
        if data[pos : pos + 1] == b"#":
            while pos < len(data) and data[pos : pos + 1] != b"\n":
                pos += 1
            continue
        end = pos
        while end < len(data) and not data[end : end + 1].isspace():
            end += 1
        if end == pos:
            raise ValueError("truncated PPM header")
        fields.append(int(data[pos:end]))
        pos = end
    pos += 1  # the single whitespace byte after maxval
    w, h, maxval = fields
    if maxval != 255 or w <= 0 or h <= 0 or pos + w * h * 3 > len(data):
        raise ValueError("only 8-bit binary PPM (P6, maxval 255) is read here")
    rgb = np.frombuffer(data, np.uint8, w * h * 3, pos).reshape(h, w, 3)
    return np.ascontiguousarray(rgb[:, :, ::-1])


def _write_ppm(img: np.ndarray) -> bytes:
    h, w = img.shape[:2]
    return b"P6\n%d %d\n255\n" % (w, h) + np.ascontiguousarray(img[:, :, ::-1]).tobytes()


# ------------------------------------------------------------ entry points --


def imread(path: str) -> Optional[np.ndarray]:
    """File → (H, W, 3) BGR uint8, or ``None`` when the file is missing
    or cannot be decoded (as ``cv2.imread``)."""
    if not os.path.isfile(path):
        return None
    with open(path, "rb") as f:
        data = f.read()
    try:
        if data[:2] == b"BM":
            return _read_bmp(data)
        if data[:2] == b"P6":
            return _read_ppm(data)
    except (ValueError, struct.error):
        pass  # a variant of the format this reader does not cover: OpenCV's turn
    ext = os.path.splitext(path)[1].lower() or "this image format"
    return require_cv2(f"reading {ext} ({path})").imread(path)


def imencode(ext: str, image: np.ndarray) -> bytes:
    """(H, W, 3) BGR uint8 → the bytes of an image file of type ``ext``
    (``".bmp"``, ``".ppm"``, or any format OpenCV writes)."""
    ext = ext.lower()
    img = np.asarray(image)
    if ext in (".bmp", ".ppm"):
        if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"imencode expects (H, W, 3) uint8, got {img.dtype} {img.shape}")
        return _write_bmp(img) if ext == ".bmp" else _write_ppm(img)
    ok, buf = require_cv2(f"writing {ext or 'this image format'}").imencode(ext, img)
    if not ok:
        raise OSError(f"could not encode an image as {ext}")
    return buf.tobytes()


def imwrite(path: str, image: np.ndarray) -> None:
    """(H, W, 3) BGR uint8 → file, by the path's extension."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".bmp", ".ppm"):
        data = imencode(ext, image)
        with open(path, "wb") as f:
            f.write(data)
        return
    if not require_cv2(f"writing {ext or 'this image format'} ({path})").imwrite(path, np.asarray(image)):
        raise OSError(f"could not write {path}")


def open_video(source):
    """``cv2.VideoCapture(source)`` for a file path or a camera index."""
    return require_cv2(f"cv2.VideoCapture({source!r})").VideoCapture(source)


def open_video_writer(path: str, fps: float, wh):
    """XVID ``cv2.VideoWriter`` at ``wh`` = (width, height)."""
    cv2 = require_cv2(f"cv2.VideoWriter({path!r})")
    return cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"XVID"), fps, wh)


def imshow(title: str, image: np.ndarray, wait_ms: int) -> int:
    """Show ``image`` and return ``cv2.waitKey(wait_ms) & 0xFF``."""
    cv2 = require_cv2("show=True (cv2.imshow)")
    cv2.imshow(title, image)
    return cv2.waitKey(wait_ms) & 0xFF


def destroy_windows() -> None:
    require_cv2("show=True (cv2.destroyAllWindows)").destroyAllWindows()
