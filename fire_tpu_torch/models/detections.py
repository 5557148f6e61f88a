"""Fixed-shape detection output shared by the detector path
(counterpart of ``fire_tpu.models.detections``)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class Detections(NamedTuple):
    """Padded detections (optionally with a leading batch axis).

    boxes_xywh: (..., N, 4) pixel ``[x, y, w, h]`` in the SOURCE frame.
    landmarks:  (..., N, 5, 2) (right_eye, left_eye, nose, mouth_right,
                mouth_left).
    scores:     (..., N) confidence.
    mask:       (..., N) bool — True for real detections.
    """

    boxes_xywh: torch.Tensor
    landmarks: torch.Tensor
    scores: torch.Tensor
    mask: torch.Tensor

    @property
    def landmarks3(self) -> torch.Tensor:
        """(..., N, 3, 2) (left_eye, right_eye, nose) for 3-point
        alignment."""
        lm = self.landmarks
        return torch.stack([lm[..., 1, :], lm[..., 0, :], lm[..., 2, :]], dim=-2)


def pad_detections(boxes, landmarks, scores, keep_idx, keep_mask) -> Detections:
    """Gather NMS survivors into the padded struct (masked slots zeroed).
    Batched over leading axes: ``boxes`` (..., N, 4), ``keep_idx``
    (..., K)."""
    m = keep_mask.to(boxes.dtype)
    b = torch.gather(boxes, -2, keep_idx[..., None].expand(*keep_idx.shape, 4)) * m[..., None]
    lidx = keep_idx[..., None, None].expand(*keep_idx.shape, 5, 2)
    l = torch.gather(landmarks, -3, lidx) * m[..., None, None]
    s = torch.gather(scores, -1, keep_idx) * m
    return Detections(b, l, s, keep_mask)
