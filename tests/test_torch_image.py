"""Image ops of the port vs fire_tpu.ops.image on the same arrays.

letterbox in f32 agrees to 1e-4 (both are half-pixel bilinear without
antialias); in bf16 the resample rounds to bf16, whose unit in the last
place is a whole intensity level above 128, so ±1 level.  The crop
resamplers keep bf16 intermediates on both sides; their sums run in a
different order, so ±1.0 of 255."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from fire_tpu.ops import image as J
from fire_tpu_torch.ops import image as T


@pytest.mark.parametrize("hw,out", [((1080, 1920), (640, 640)), ((1000, 1000), (640, 640)),
                                    ((720, 1280), (360, 640)), ((300, 500), (640, 640)),
                                    ((108, 192), (64, 64))])
def test_letterbox_f32(hw, out):
    img = np.random.default_rng(0).integers(0, 256, (*hw, 3)).astype(np.float32)
    jc, js = J.letterbox(jnp.asarray(img), out)
    tcv, ts = T.letterbox(torch.from_numpy(img), out)
    assert float(js) == pytest.approx(ts)
    np.testing.assert_allclose(tcv.numpy(), np.asarray(jc), atol=1e-4)


def test_letterbox_batched_equals_per_frame():
    img = np.random.default_rng(1).integers(0, 256, (3, 90, 160, 3)).astype(np.float32)
    tb, _ = T.letterbox(torch.from_numpy(img), (64, 64))
    for i in range(3):
        np.testing.assert_array_equal(tb[i].numpy(), T.letterbox(torch.from_numpy(img[i]), (64, 64))[0].numpy())


def test_letterbox_bf16_within_one_level():
    u8 = np.random.default_rng(2).integers(0, 256, (216, 384, 3)).astype(np.uint8)
    jc, _ = J.letterbox(jnp.asarray(u8).astype(jnp.bfloat16), (128, 128))
    tcv, _ = T.letterbox(torch.from_numpy(u8).to(torch.bfloat16), (128, 128))
    assert tcv.dtype == torch.bfloat16
    d = np.abs(tcv.float().numpy() - np.asarray(jc, np.float32))
    assert d.max() <= 1.0, d.max()


def test_bgr_to_rgb():
    x = np.arange(24, dtype=np.float32).reshape(2, 4, 3)
    np.testing.assert_array_equal(T.bgr_to_rgb(torch.from_numpy(x)).numpy(),
                                  np.asarray(J.bgr_to_rgb(jnp.asarray(x))))


BOXES = np.array([[10.3, 20.7, 40.0, 50.0], [0.0, 0.0, 8.0, 8.0], [60.5, 30.2, 30.0, 25.0],
                  [-5.0, -3.0, 20.0, 30.0], [70.0, 40.0, 0.0, 0.0]], np.float32)


def test_crop_and_resize_mm():
    img = np.random.default_rng(3).integers(0, 256, (72, 96, 3)).astype(np.uint8)
    j = np.asarray(J.crop_and_resize_mm(jnp.asarray(img), jnp.asarray(BOXES), (32, 32)))
    t = T.crop_and_resize_mm(torch.from_numpy(img), torch.from_numpy(BOXES), (32, 32))
    assert t.shape == j.shape and t.dtype == torch.float32
    assert np.abs(t.numpy() - j).max() <= 1.0


@pytest.mark.parametrize("chunk", [2, 64])
def test_crop_selected_rows(chunk):
    frames = np.random.default_rng(4).integers(0, 256, (3, 72, 96, 3)).astype(np.uint8)
    fi = np.array([2, 0, 1, 2, 0], np.int32)
    j = np.asarray(J.crop_selected_rows(jnp.asarray(frames), jnp.asarray(fi), jnp.asarray(BOXES),
                                        (32, 32), chunk=chunk))
    t = T.crop_selected_rows(torch.from_numpy(frames), torch.from_numpy(fi),
                             torch.from_numpy(BOXES), (32, 32), chunk=chunk)
    assert t.shape == j.shape
    assert np.abs(t.numpy() - j).max() <= 1.0
