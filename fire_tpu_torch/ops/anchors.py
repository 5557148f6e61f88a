"""YuNet anchor-free grid decode (counterpart of
``fire_tpu.ops.anchors.yunet_grid_decode``, ``anchors.py:94``)."""

from __future__ import annotations

import torch


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
