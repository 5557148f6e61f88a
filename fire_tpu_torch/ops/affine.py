"""Batched 3-point affine face alignment (counterpart of
``fire_tpu.ops.affine``: ``affine_from_3pts``, ``invert_affine``,
``warp_affine``, ``align_faces_160``).

Every function takes leading batch axes where the JAX version is
vmapped over the faces of a frame.  The 3×3 solve of
``affine_from_3pts`` is closed form (a 2×2 inverse of the point
differences), so no LAPACK / cuSOLVER call and no host sync sits on the
per-frame path; differences of nearby points also lose less precision
in float32 than an LU of the raw ``[x, y, 1]`` rows.  The warp is the
JAX version's 4-tap gather: taps clipped for the read, zero outside the
image (``cv2.warpAffine``'s constant border).
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from fire_tpu_torch.config import ALIGN_TEMPLATE_160


def _inv2(a: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of (..., 2, 2)."""
    det = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    adj = torch.stack([
        torch.stack([a[..., 1, 1], -a[..., 0, 1]], dim=-1),
        torch.stack([-a[..., 1, 0], a[..., 0, 0]], dim=-1),
    ], dim=-2)
    return adj / det[..., None, None]


def affine_from_3pts(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """M (..., 2, 3) with ``M @ [src_i, 1] = dst_i``
    (``cv2.getAffineTransform``).  ``src`` / ``dst``: (..., 3, 2)."""
    # columns = the two edge vectors from point 0
    ds = (src[..., 1:, :] - src[..., :1, :]).transpose(-1, -2)
    dd = (dst[..., 1:, :] - dst[..., :1, :]).transpose(-1, -2)
    a = dd @ _inv2(ds)
    b = dst[..., 0, :] - (a @ src[..., 0, :, None])[..., 0]
    return torch.cat([a, b[..., None]], dim=-1)


def invert_affine(m: torch.Tensor) -> torch.Tensor:
    """Invert (..., 2, 3) affines ``[A|b]`` → ``[A⁻¹ | −A⁻¹ b]``."""
    inv_a = _inv2(m[..., :2])
    inv_b = -(inv_a @ m[..., 2:])
    return torch.cat([inv_a, inv_b], dim=-1)


def _warp(image: torch.Tensor, m: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """warpAffine of one (H, W, C) float image with forward affines
    ``m`` (N, 2, 3): sample the source at ``M⁻¹ ·`` the output grid.
    Returns (N, oh, ow, C)."""
    oh, ow = out_hw
    h, w = image.shape[0], image.shape[1]
    dev = image.device
    minv = invert_affine(m.float())[:, :, :, None, None]  # (N, 2, 3, 1, 1)
    gy, gx = torch.meshgrid(torch.arange(oh, dtype=torch.float32, device=dev),
                            torch.arange(ow, dtype=torch.float32, device=dev), indexing="ij")
    sx = minv[:, 0, 0] * gx + minv[:, 0, 1] * gy + minv[:, 0, 2]
    sy = minv[:, 1, 0] * gx + minv[:, 1, 1] * gy + minv[:, 1, 2]

    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    wx = (sx - x0)[..., None]
    wy = (sy - y0)[..., None]
    x0i = x0.long()
    y0i = y0.long()

    def tap(yi, xi):
        inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        v = image[torch.clamp(yi, 0, h - 1), torch.clamp(xi, 0, w - 1)]
        return torch.where(inb[..., None], v, torch.zeros_like(v))

    v00 = tap(y0i, x0i)
    v01 = tap(y0i, x0i + 1)
    v10 = tap(y0i + 1, x0i)
    v11 = tap(y0i + 1, x0i + 1)
    top = v00 * (1.0 - wx) + v01 * wx
    bot = v10 * (1.0 - wx) + v11 * wx
    return top * (1.0 - wy) + bot * wy


def warp_affine(image: torch.Tensor, m: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Single-image forward-affine warp: ``m`` (2, 3) → (oh, ow, C)."""
    return _warp(image.float(), m[None], out_hw)[0]


def template(out_hw: Tuple[int, int] = (160, 160)):
    """``ALIGN_TEMPLATE_160`` scaled to an ``out_hw`` canvas (x by
    ``ow / 160``, y by ``oh / 160``): the same face framing at any crop
    size, and the template itself, bit for bit, at 160 × 160."""
    sy, sx = out_hw[0] / 160.0, out_hw[1] / 160.0
    return tuple((x * sx, y * sy) for x, y in ALIGN_TEMPLATE_160)


@functools.lru_cache(maxsize=16)
def _template_on(device: torch.device, out_hw: Tuple[int, int]) -> torch.Tensor:
    """:func:`template` on ``device``, made once: a captured graph cannot
    copy from host memory."""
    return torch.tensor(template(out_hw), dtype=torch.float32, device=device)


def align_faces_160(image: torch.Tensor, landmarks3: torch.Tensor,
                    out_hw: Tuple[int, int] = (160, 160)) -> torch.Tensor:
    """Align every face of a frame to the canonical template, scaled to
    the ``out_hw`` canvas (:func:`template`).

    ``image``: (H, W, C) float frame; ``landmarks3``: (N, 3, 2) per-face
    (left_eye, right_eye, nose) pixels.  Returns (N, oh, ow, C)."""
    tpl = _template_on(image.device, tuple(out_hw))
    m = affine_from_3pts(landmarks3.float(), tpl.expand(landmarks3.shape[0], 3, 2))
    return _warp(image.float(), m, out_hw)
