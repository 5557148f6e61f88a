"""Anchor grids and box / landmark decoding (counterpart of
``fire_tpu.ops.anchors``): the RetinaFace anchor tables and legacy
``+1`` delta decode (``anchors.py:16-91``) and the YuNet anchor-free
grid decode (``anchors.py:94``).  The decode functions take any leading
batch dims."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

# RetinaFace base anchors: strides 32 / 16 / 8, two anchors each, in the
# order the decode concatenates them.
RETINAFACE_STRIDES = (32, 16, 8)
RETINAFACE_ANCHORS: Dict[int, np.ndarray] = {
    32: np.array([[-248.0, -248.0, 263.0, 263.0], [-120.0, -120.0, 135.0, 135.0]], np.float32),
    16: np.array([[-56.0, -56.0, 71.0, 71.0], [-24.0, -24.0, 39.0, 39.0]], np.float32),
    8: np.array([[-8.0, -8.0, 23.0, 23.0], [0.0, 0.0, 15.0, 15.0]], np.float32),
}


def anchors_plane(height: int, width: int, stride: int, base: np.ndarray) -> np.ndarray:
    """Dense anchor grid, (H*W*A, 4) xyxy, row-major (y, x, anchor)."""
    xs = np.arange(width, dtype=np.float32) * stride
    ys = np.arange(height, dtype=np.float32) * stride
    shift = np.stack([np.tile(xs[None, :], (height, 1)), np.tile(ys[:, None], (1, width)),
                      np.tile(xs[None, :], (height, 1)), np.tile(ys[:, None], (1, width))],
                     axis=-1)  # (H, W, 4)
    out = shift[:, :, None, :] + base[None, None, :, :]
    return out.reshape(height * width * base.shape[0], 4)


def _centres(anchors: torch.Tensor):
    widths = anchors[:, 2] - anchors[:, 0] + 1.0
    heights = anchors[:, 3] - anchors[:, 1] + 1.0
    return widths, heights, anchors[:, 0] + 0.5 * (widths - 1.0), anchors[:, 1] + 0.5 * (heights - 1.0)


def bbox_decode(anchors: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Anchor-relative box decode with the legacy ``+1`` / ``-1`` pixel
    conventions: ``anchors`` (N, 4) xyxy, ``deltas`` (..., N, 4)
    ``[dx, dy, dw, dh]`` → (..., N, 4) xyxy."""
    widths, heights, ctr_x, ctr_y = _centres(anchors)
    pred_ctr_x = deltas[..., 0] * widths + ctr_x
    pred_ctr_y = deltas[..., 1] * heights + ctr_y
    pred_w = torch.exp(deltas[..., 2]) * widths
    pred_h = torch.exp(deltas[..., 3]) * heights
    return torch.stack([pred_ctr_x - 0.5 * (pred_w - 1.0), pred_ctr_y - 0.5 * (pred_h - 1.0),
                        pred_ctr_x + 0.5 * (pred_w - 1.0), pred_ctr_y + 0.5 * (pred_h - 1.0)],
                       dim=-1)


def landmark_decode(anchors: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """5-point landmark decode: ``deltas`` (..., N, 5, 2) anchor-relative
    → (..., N, 5, 2) pixels."""
    widths, heights, ctr_x, ctr_y = _centres(anchors)
    px = deltas[..., 0] * widths[:, None] + ctr_x[:, None]
    py = deltas[..., 1] * heights[:, None] + ctr_y[:, None]
    return torch.stack([px, py], dim=-1)


def clip_boxes_xyxy(boxes: torch.Tensor, im_hw) -> torch.Tensor:
    """Clip xyxy boxes to ``[0, dim - 1]``."""
    h, w = im_hw
    return torch.stack([torch.clamp(boxes[..., 0], 0.0, w - 1.0),
                        torch.clamp(boxes[..., 1], 0.0, h - 1.0),
                        torch.clamp(boxes[..., 2], 0.0, w - 1.0),
                        torch.clamp(boxes[..., 3], 0.0, h - 1.0)], dim=-1)


def yunet_grid_decode(cls, obj, box, kps, stride: int):
    """Per grid cell: score = sqrt(cls·obj); centre = (cell + offset)·
    stride; size = exp(pred)·stride; 5 landmarks cell-relative.

    Args (any leading batch dims ``...``):
      cls, obj: (..., H, W, 1) sigmoid scores; box: (..., H, W, 4);
      kps: (..., H, W, 10).
    Returns:
      (boxes_xyxy (..., H*W, 4), landmarks (..., H*W, 5, 2), scores (..., H*W))
    """
    h, w = cls.shape[-3], cls.shape[-2]
    lead = cls.shape[:-3]
    dev = cls.device
    score = torch.sqrt(torch.clamp(cls[..., 0] * obj[..., 0], 0.0, 1.0))
    cols = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    rows = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    cx = (cols + box[..., 0]) * stride
    cy = (rows + box[..., 1]) * stride
    bw = torch.exp(box[..., 2]) * stride
    bh = torch.exp(box[..., 3]) * stride
    boxes = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], dim=-1)
    k = kps.reshape(*lead, h, w, 5, 2)
    lx = (cols[..., None] + k[..., 0]) * stride
    ly = (rows[..., None] + k[..., 1]) * stride
    lm = torch.stack([lx, ly], dim=-1)
    return (boxes.reshape(*lead, h * w, 4), lm.reshape(*lead, h * w, 5, 2),
            score.reshape(*lead, h * w))
