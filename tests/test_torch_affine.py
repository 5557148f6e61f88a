"""Alignment and gather crops of the port vs ``fire_tpu.ops`` on the same
numpy inputs, float32.

Tolerances: the affine matrices agree to 1e-3 relative (the port solves
in closed form, JAX by LU); warped and cropped [0, 1] images agree to
1e-4, including faces that lie partly outside the frame; the box-average
``resize_area`` agrees to 1e-6 and its antialiased fallback to 2e-2 (two
different antialias filters; it is used for display only).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fire_tpu.ops import affine as JA
from fire_tpu.ops import image as JI
from fire_tpu_torch.config import ALIGN_TEMPLATE_160
from fire_tpu_torch.ops import affine as TA
from fire_tpu_torch.ops import image as TI


def _image(seed, hw=(120, 160)):
    rng = np.random.default_rng(seed)
    # smooth + noise, so that a one-pixel shift of a tap shows
    yy, xx = np.mgrid[: hw[0], : hw[1]]
    base = 0.5 + 0.25 * np.sin(xx / 7.0)[..., None] + 0.2 * np.cos(yy / 5.0)[..., None]
    return np.clip(base + rng.uniform(-0.1, 0.1, (*hw, 3)), 0.0, 1.0).astype(np.float32)


def _landmarks(rng, n, hw, outside):
    """(n, 3, 2) (left_eye, right_eye, nose): a jittered, rotated,
    scaled template placed inside the frame, or hanging over its edge."""
    t = np.asarray(ALIGN_TEMPLATE_160, np.float32) - 80.0
    out = []
    for _ in range(n):
        ang, s = rng.uniform(-0.5, 0.5), rng.uniform(0.25, 0.9)
        rot = np.array([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]], np.float32)
        if outside:
            c = np.array([rng.choice([-5.0, hw[1] + 5.0]), rng.uniform(0, hw[0])], np.float32)
        else:
            c = np.array([rng.uniform(50, hw[1] - 50), rng.uniform(45, hw[0] - 45)], np.float32)
        out.append((t * s) @ rot.T + c + rng.normal(0, 1.0, (3, 2)).astype(np.float32))
    return np.stack(out).astype(np.float32)


def test_template_equals_jax():
    from fire_tpu.config import ALIGN_TEMPLATE_160 as J

    assert ALIGN_TEMPLATE_160 == J


@pytest.mark.parametrize("seed", range(3))
def test_affine_from_3pts_and_invert(seed):
    rng = np.random.default_rng(seed)
    src = _landmarks(rng, 5, (120, 160), outside=False)
    dst = np.broadcast_to(np.asarray(ALIGN_TEMPLATE_160, np.float32), src.shape).copy()
    m_t = TA.affine_from_3pts(torch.from_numpy(src), torch.from_numpy(dst))
    i_t = TA.invert_affine(m_t)
    for k in range(src.shape[0]):
        m_j = JA.affine_from_3pts(jnp.asarray(src[k]), jnp.asarray(dst[k]))
        np.testing.assert_allclose(m_t[k].numpy(), np.asarray(m_j), rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(i_t[k].numpy(), np.asarray(JA.invert_affine(m_j)),
                                   rtol=1e-3, atol=1e-3)
        # the solve is exact on its three points
        mapped = src[k] @ m_t[k, :, :2].numpy().T + m_t[k, :, 2].numpy()
        np.testing.assert_allclose(mapped, dst[k], atol=1e-3)


def test_warp_affine_matches_jax():
    img = _image(3)
    m = np.array([[0.9, -0.3, 12.5], [0.25, 1.1, -20.0]], np.float32)  # reads outside the frame
    t = TA.warp_affine(torch.from_numpy(img), torch.from_numpy(m), (64, 80))
    j = JA.warp_affine(jnp.asarray(img), jnp.asarray(m), (64, 80))
    assert tuple(t.shape) == (64, 80, 3)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-4)
    assert (np.asarray(j) == 0).any() and (np.asarray(j) > 0).any()


@pytest.mark.parametrize("outside", [False, True], ids=["inside", "partly_outside"])
@pytest.mark.parametrize("seed", range(2))
def test_align_faces_160_matches_jax(seed, outside):
    img = _image(10 + seed)
    lms = _landmarks(np.random.default_rng(seed), 4, img.shape[:2], outside)
    t = TA.align_faces_160(torch.from_numpy(img), torch.from_numpy(lms)).numpy()
    j = np.asarray(JA.align_faces_160(jnp.asarray(img), jnp.asarray(lms)))
    assert t.shape == j.shape == (4, 160, 160, 3)
    np.testing.assert_allclose(t, j, atol=1e-4)
    if outside:
        assert (j == 0).mean() > 0.05  # the constant border really shows


def _boxes(rng, n, hw):
    b = np.stack([rng.uniform(-20, hw[1] - 10, n), rng.uniform(-15, hw[0] - 10, n),
                  rng.uniform(8, 90, n), rng.uniform(8, 90, n)], 1).astype(np.float32)
    b[0] = [hw[1] - 30, hw[0] - 25, 60, 50]  # hangs over the bottom-right corner
    b[1] = [10.3, 12.7, 0.0, 0.0]            # degenerate: widened to 1 px
    return b


@pytest.mark.parametrize("out_hw", [(160, 160), (32, 48)])
def test_crop_and_resize_matches_jax(out_hw):
    img = _image(5)
    boxes = _boxes(np.random.default_rng(6), 6, img.shape[:2])
    t = TI.crop_and_resize(torch.from_numpy(img), torch.from_numpy(boxes), out_hw).numpy()
    j = np.asarray(JI.crop_and_resize(jnp.asarray(img), jnp.asarray(boxes), out_hw))
    assert t.shape == j.shape == (6, *out_hw, 3)
    np.testing.assert_allclose(t, j, atol=1e-4)


def test_crop_and_resize_rows_matches_jax():
    """Row gather + bf16 column product: the column weights are rounded
    to bf16 on both sides, hence 1e-2."""
    img = _image(7)
    boxes = _boxes(np.random.default_rng(8), 5, img.shape[:2])
    t = TI.crop_and_resize_rows(torch.from_numpy(img), torch.from_numpy(boxes), (40, 40)).numpy()
    j = np.asarray(JI.crop_and_resize_rows(jnp.asarray(img), jnp.asarray(boxes), (40, 40)),
                   np.float32)
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, atol=1e-2)


@pytest.mark.parametrize("out_hw,atol", [((30, 40), 1e-6), ((60, 160), 1e-6), ((50, 70), 2e-2)])
def test_resize_area_matches_jax(out_hw, atol):
    img = _image(9)
    t = TI.resize_area(torch.from_numpy(img), out_hw).numpy()
    j = np.asarray(JI.resize_area(jnp.asarray(img), out_hw))
    assert t.shape == j.shape == (*out_hw, 3)
    np.testing.assert_allclose(t, j, atol=atol)
