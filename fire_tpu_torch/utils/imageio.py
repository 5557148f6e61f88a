"""Image and video files ↔ BGR uint8 arrays without OpenCV where the
format allows it (counterpart of the ``cv2.imread`` / ``cv2.imwrite`` /
``cv2.imdecode`` / ``cv2.VideoCapture`` / ``cv2.VideoWriter`` /
``cv2.imshow`` calls in ``fire_tpu.pipeline.recognizer`` and of
``fire_tpu.utils.imageio``: ``get_image``, ``load_base64_image`` and
``load_image_from_web``).

Uncompressed 24-bit **BMP**, binary **PPM** (``P6``, maxval 255) and
8-bit non-interlaced **PNG** (gray, RGB or RGBA, any of the five row
filters; written as RGB with filter 0, through the standard library's
``zlib``) are read and written here; all three are formats
``cv2.imread`` reads, and a gray or RGBA PNG decodes to the BGR that
``cv2.imread`` gives.  Every other format, and every video or window
call, needs OpenCV, which is imported at the call: without it they raise
an ``ImportError`` that names the format or the call.
"""

from __future__ import annotations

import base64
import os
import struct
import zlib
from pathlib import Path
from typing import Optional, Union

import numpy as np


def has_cv2() -> bool:
    try:
        import cv2  # noqa: F401
    except ImportError:
        return False
    return True


def require_cv2(what: str):
    """Import OpenCV for ``what`` (a format or a call) or raise an
    ImportError that names it."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            f"{what} needs OpenCV (cv2), which is not installed; without it the port reads "
            "and writes 24-bit BMP, binary PPM and 8-bit PNG images only") from e
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


# --------------------------------------------------------------------- PNG --

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type → samples per pixel


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _write_png(img: np.ndarray) -> bytes:
    """8-bit RGB, filter 0 on every row."""
    h, w = img.shape[:2]
    rows = np.zeros((h, 1 + w * 3), np.uint8)
    rows[:, 1:] = img[:, :, ::-1].reshape(h, w * 3)
    head = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (_PNG_MAGIC + _png_chunk(b"IHDR", head)
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _png_chunk(b"IEND", b""))


def _unfilter(kind: int, line: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    """One scanline's bytes before filtering (PNG spec §9)."""
    if kind == 0:
        return line
    if kind == 2:
        return line + prior  # uint8 wraps mod 256
    n = line.shape[0]
    if kind == 1:
        px = line.reshape(-1, bpp).astype(np.int64)
        return (np.cumsum(px, axis=0) & 0xFF).astype(np.uint8).reshape(n)
    out = np.zeros(n + bpp, np.int64)  # bpp zero bytes stand left of the row
    up = np.concatenate([np.zeros(bpp, np.int64), prior.astype(np.int64)])
    raw = line.astype(np.int64)
    for x in range(bpp, n + bpp, bpp):
        a, b = out[x - bpp : x], up[x : x + bpp]
        if kind == 3:
            pred = (a + b) >> 1
        elif kind == 4:
            c = up[x - bpp : x]
            p = a + b - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        else:
            raise ValueError(f"PNG filter type {kind}")
        out[x : x + bpp] = (raw[x - bpp : x] + pred) & 0xFF
    return out[bpp:].astype(np.uint8)


def _read_png(data: bytes) -> np.ndarray:
    pos, head, idat = 8, None, []
    while pos + 8 <= len(data):
        size, kind = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8 : pos + 8 + size]
        crc, = struct.unpack_from(">I", data, pos + 8 + size)
        if len(body) != size or zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError("PNG chunk truncated or CRC mismatch")
        if kind == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + size
    if head is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, colour, _, _, interlace = head
    if depth != 8 or colour not in _PNG_CHANNELS or interlace != 0 or w == 0 or h == 0:
        raise ValueError("only 8-bit non-interlaced gray, RGB or RGBA PNG is read here")
    ch = _PNG_CHANNELS[colour]
    stride = w * ch
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.shape[0] < h * (stride + 1):
        raise ValueError("PNG pixel data truncated")
    raw = raw[: h * (stride + 1)].reshape(h, stride + 1)
    img = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        prior = img[y] = _unfilter(int(raw[y, 0]), raw[y, 1:], prior, ch)
    img = img.reshape(h, w, ch)
    if ch == 1:
        return np.ascontiguousarray(np.repeat(img, 3, axis=2))
    return np.ascontiguousarray(img[:, :, 2::-1])  # RGB(A) → BGR, alpha dropped


# ------------------------------------------------------------ entry points --


def _decode(data: bytes) -> Optional[np.ndarray]:
    """BMP, PPM or PNG bytes → BGR uint8, or ``None`` for another format
    (or a variant of these three that is not read here)."""
    try:
        if data[:2] == b"BM":
            return _read_bmp(data)
        if data[:2] == b"P6":
            return _read_ppm(data)
        if data[:8] == _PNG_MAGIC:
            return _read_png(data)
    except (ValueError, struct.error, zlib.error):
        pass  # OpenCV's turn
    return None


def imread(path: str) -> Optional[np.ndarray]:
    """File → (H, W, 3) BGR uint8, or ``None`` when the file is missing
    or cannot be decoded (as ``cv2.imread``)."""
    if not os.path.isfile(path):
        return None
    with open(path, "rb") as f:
        data = f.read()
    img = _decode(data)
    if img is not None:
        return img
    ext = os.path.splitext(path)[1].lower() or "this image format"
    return require_cv2(f"reading {ext} ({path})").imread(path)


def imdecode(data: bytes) -> Optional[np.ndarray]:
    """Image file bytes → (H, W, 3) BGR uint8, or ``None`` when they
    cannot be decoded (as ``cv2.imdecode(..., cv2.IMREAD_COLOR)``)."""
    img = _decode(data)
    if img is not None:
        return img
    cv2 = require_cv2("decoding this image format")
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)


def load_base64_image(uri: str) -> Optional[np.ndarray]:
    """``data:image/...;base64,...`` → BGR ndarray."""
    return imdecode(base64.b64decode(uri.split(",")[1]))


def load_image_from_web(url: str) -> Optional[np.ndarray]:
    """HTTP(S) URL → BGR ndarray (needs the optional ``requests``)."""
    import requests

    response = requests.get(url, stream=True, timeout=60)
    response.raise_for_status()
    return imdecode(response.raw.read())


def get_image(img_uri: Union[str, Path, np.ndarray]) -> np.ndarray:
    """Load an image from a file path, a loaded BGR ndarray (copied), a
    base64 data-URI or an HTTP(S) URL."""
    if isinstance(img_uri, np.ndarray):
        img = img_uri.copy()
    elif isinstance(img_uri, str) and img_uri.startswith("data:image/"):
        img = load_base64_image(img_uri)
    elif isinstance(img_uri, str) and img_uri.startswith("http"):
        img = load_image_from_web(img_uri)
    elif isinstance(img_uri, (str, Path)):
        path = str(img_uri)
        if not os.path.isfile(path):
            raise ValueError(f"No image file found at {path!r}.")
        img = imread(path)
    else:
        raise ValueError(
            f"Unsupported image source {type(img_uri).__name__!r}: pass a "
            "file path, a loaded BGR ndarray, a base64 data-URI, or an "
            "HTTP(S) URL."
        )
    if img is None or len(img.shape) != 3 or np.prod(img.shape) == 0:
        raise ValueError("Decoded image must be non-empty with 3 channels (BGR).")
    return img


_WRITERS = {".bmp": _write_bmp, ".ppm": _write_ppm, ".png": _write_png}


def imencode(ext: str, image: np.ndarray) -> bytes:
    """(H, W, 3) BGR uint8 → the bytes of an image file of type ``ext``
    (``".bmp"``, ``".ppm"``, ``".png"``, or any format OpenCV writes)."""
    ext = ext.lower()
    img = np.asarray(image)
    if ext in _WRITERS:
        if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"imencode expects (H, W, 3) uint8, got {img.dtype} {img.shape}")
        return _WRITERS[ext](img)
    ok, buf = require_cv2(f"writing {ext or 'this image format'}").imencode(ext, img)
    if not ok:
        raise OSError(f"could not encode an image as {ext}")
    return buf.tobytes()


def imwrite(path: str, image: np.ndarray) -> None:
    """(H, W, 3) BGR uint8 → file, by the path's extension."""
    ext = os.path.splitext(path)[1].lower()
    if ext in _WRITERS:
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
