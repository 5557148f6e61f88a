"""``fire_tpu_torch.utils.imageio``'s ``get_image`` / ``load_base64_image``
/ ``load_image_from_web`` against ``fire_tpu.utils.imageio`` on the same
sources, and the port's PNG codec against OpenCV's: every decoded image
is pixel-equal (uint8 equality)."""

import base64
import builtins
import sys
import types

import cv2
import numpy as np
import pytest

from fire_tpu.utils import imageio as jio
from fire_tpu_torch.utils import imageio


def _img(seed=0, hw=(20, 30)):
    return np.random.default_rng(seed).integers(0, 256, (*hw, 3), dtype=np.uint8)


def _smooth(hw=(37, 53)):
    """Slow gradients, where each PNG filter predicts something."""
    yy, xx = np.mgrid[0 : hw[0], 0 : hw[1]]
    return np.stack([(xx * 3 + yy) % 256, (yy * 5) % 256, (xx * yy) % 256], -1).astype(np.uint8)


def _uri(kind, data: bytes) -> str:
    return f"data:image/{kind};base64," + base64.b64encode(data).decode()


@pytest.fixture
def no_cv2(monkeypatch):
    real = builtins.__import__

    def fake(name, *args, **kw):
        if name == "cv2":
            raise ImportError("No module named 'cv2'")
        return real(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", fake)


@pytest.mark.parametrize("ext", [".png", ".bmp", ".ppm", ".jpg"])
def test_get_image_sources_equal_to_jax(tmp_path, ext):
    """A path, an ndarray (copied) and a data-URI, as
    ``tests/test_eval_and_utils.py`` drives JAX's ``get_image``."""
    img = _img(1)
    path = str(tmp_path / f"x{ext}")
    assert cv2.imwrite(path, img)
    np.testing.assert_array_equal(imageio.get_image(path), jio.get_image(path))
    out = imageio.get_image(img)
    np.testing.assert_array_equal(out, jio.get_image(img))
    out[0, 0, 0] ^= 0xFF
    assert out[0, 0, 0] != img[0, 0, 0]  # a copy, the caller's array is untouched
    ok, buf = cv2.imencode(ext, img)
    uri = _uri(ext[1:], buf.tobytes())
    np.testing.assert_array_equal(imageio.get_image(uri), jio.get_image(uri))
    with pytest.raises(ValueError, match="No image file found"):
        imageio.get_image(str(tmp_path / f"nope{ext}"))
    with pytest.raises(ValueError, match="No image file found"):
        jio.get_image(str(tmp_path / f"nope{ext}"))


def test_get_image_rejects_what_jax_rejects(tmp_path):
    for bad in (3.5, None, ["a.png"]):
        with pytest.raises(ValueError, match="Unsupported image source"):
            imageio.get_image(bad)
        with pytest.raises(ValueError, match="Unsupported image source"):
            jio.get_image(bad)
    gray = np.zeros((4, 5), np.uint8)
    for get in (imageio.get_image, jio.get_image):
        with pytest.raises(ValueError, match="3 channels"):
            get(gray)
        with pytest.raises(ValueError, match="non-empty"):
            get(_uri("png", b"not an image at all"))


@pytest.mark.parametrize("ext", [".png", ".bmp", ".ppm"])
def test_without_cv2_paths_and_data_uris_decode(tmp_path, no_cv2, ext):
    """BMP, PPM and PNG need no OpenCV, from a path or a data-URI; other
    formats name what they need."""
    img = _img(2, (9, 13))
    data = imageio.imencode(ext, img)
    (tmp_path / f"a{ext}").write_bytes(data)
    np.testing.assert_array_equal(imageio.get_image(str(tmp_path / f"a{ext}")), img)
    np.testing.assert_array_equal(imageio.get_image(_uri(ext[1:], data)), img)
    with pytest.raises(ImportError, match="cv2"):
        imageio.get_image(_uri("jpeg", b"\xff\xd8\xff\xe0 a JPEG"))


def test_load_image_from_web_is_gated_on_requests(monkeypatch):
    """The URL branch imports ``requests`` at the call: a stand-in module
    serves PNG bytes (no network is touched)."""
    img = _img(3)
    png = imageio.imencode(".png", img)
    seen = []

    class Response:
        raw = types.SimpleNamespace(read=lambda: png)

        def raise_for_status(self):
            pass

    def get(url, stream, timeout):
        seen.append((url, stream, timeout))
        return Response()

    monkeypatch.setitem(sys.modules, "requests", types.SimpleNamespace(get=get))
    np.testing.assert_array_equal(imageio.get_image("http://localhost/face.png"), img)
    np.testing.assert_array_equal(jio.get_image("http://localhost/face.png"), img)
    assert seen == [("http://localhost/face.png", True, 60)] * 2
    monkeypatch.setitem(sys.modules, "requests", None)
    with pytest.raises(ImportError):
        imageio.load_image_from_web("http://localhost/face.png")


FILTERS = ["NONE", "SUB", "UP", "AVG", "PAETH"]


@pytest.mark.parametrize("flt", FILTERS)
@pytest.mark.parametrize("image", ["noise", "gradient"])
def test_png_written_by_cv2_reads_equal(tmp_path, flt, image):
    """All five row filters, as OpenCV writes them."""
    img = _img(4, (37, 53)) if image == "noise" else _smooth()
    ok, buf = cv2.imencode(".png", img, [cv2.IMWRITE_PNG_FILTER,
                                         getattr(cv2, f"IMWRITE_PNG_FILTER_{flt}")])
    (tmp_path / "cv.png").write_bytes(buf.tobytes())
    np.testing.assert_array_equal(imageio.imread(str(tmp_path / "cv.png")), img)


@pytest.mark.parametrize("channels", [1, 4])
def test_png_gray_and_rgba_read_as_cv2_reads_them(tmp_path, channels):
    img = _smooth()
    src = img[..., 0] if channels == 1 else np.concatenate([img, img[..., 1:2]], axis=2)
    ok, buf = cv2.imencode(".png", src)
    (tmp_path / "g.png").write_bytes(buf.tobytes())
    np.testing.assert_array_equal(imageio.imread(str(tmp_path / "g.png")),
                                  cv2.imread(str(tmp_path / "g.png")))


@pytest.mark.parametrize("hw", [(37, 53), (1, 1), (160, 160)])
def test_png_written_by_the_port_reads_equal_in_cv2(tmp_path, hw):
    img = _img(5, hw)
    imageio.imwrite(str(tmp_path / "ours.png"), img)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "ours.png")), img)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "ours.png"), cv2.IMREAD_UNCHANGED),
                                  img)
    np.testing.assert_array_equal(imageio.imread(str(tmp_path / "ours.png")), img)


def test_png_damage_is_not_decoded_here(tmp_path, no_cv2):
    """A broken CRC, an interlaced or a 16-bit PNG is OpenCV's to read."""
    data = bytearray(imageio.imencode(".png", _img(6, (4, 4))))
    data[-20] ^= 1  # inside the IDAT body: the chunk's CRC no longer matches
    (tmp_path / "bad.png").write_bytes(bytes(data))
    with pytest.raises(ImportError, match=r"\.png"):
        imageio.imread(str(tmp_path / "bad.png"))
