"""BlazeFace short-range detector (counterpart of
``fire_tpu.models.blazeface``: ``BLAZE_BLOCKS``, ``blaze_anchors``,
``BlazeBlock``, ``BlazeFace``, ``blazeface_layer_order``,
``decode_blazeface``).

Same topology and module names as the Flax model, so the committed
weights load key for key (:func:`fire_tpu_torch.weights.
from_flax_blazeface`): a 5×5 stride-2 stem to 24 channels, sixteen
BlazeBlocks, and four 1×1 heads on the stride-8 (2 anchors per cell)
and stride-16 (6 per cell) maps.  Fully convolutional: 896 anchors at
128², 2016 at 192².

Details kept from the Flax model: ``padding="SAME"`` with stride 2 on an
even input pads 1 before and 2 after (so the convs here take explicit
padding); a stride-2 block max-pools its shortcut and a wider block
zero-pads it in channels; the input is RGB in [0, 1] and is mapped to
[-1, 1] inside; heads are cast to float32 and flattened from NHWC, cell
by cell.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fire_tpu_torch.models.detections import Detections
from fire_tpu_torch.models.layers import same_pad
from fire_tpu_torch.ops import boxes as fbox

# (features, stride) per BlazeBlock: the published short-range progression
BLAZE_BLOCKS: Tuple[Tuple[int, int], ...] = (
    (24, 1), (28, 1), (32, 2), (36, 1), (42, 1), (48, 2),
    (56, 1), (64, 1), (72, 1), (80, 1), (88, 1),
    (96, 2), (96, 1), (96, 1), (96, 1), (96, 1),
)


def blaze_anchors(input_px: int = 128) -> np.ndarray:
    """(A, 2) anchor centres in [0, 1]: 2 per stride-8 cell, then 6 per
    stride-16 cell, row-major."""
    anchors = []
    for grid, per_cell in ((input_px // 8, 2), (input_px // 16, 6)):
        step = 1.0 / grid
        for y in range(grid):
            for x in range(grid):
                cx, cy = (x + 0.5) * step, (y + 0.5) * step
                anchors.extend([(cx, cy)] * per_cell)
    return np.asarray(anchors, np.float32)


@functools.lru_cache(maxsize=16)
def _anchors_on(input_px: int, device: torch.device) -> torch.Tensor:
    """:func:`blaze_anchors` on ``device``, made once: a captured graph
    cannot copy from host memory."""
    return torch.from_numpy(blaze_anchors(input_px)).to(device)


class BlazeBlock(nn.Module):
    """Depthwise 5×5 + pointwise 1×1 with a residual shortcut."""

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.cin, self.features, self.stride = cin, features, stride
        self.dw = nn.Conv2d(cin, cin, 5, stride=stride, groups=cin, bias=True)
        self.pw = nn.Conv2d(cin, features, 1, bias=True)

    def forward(self, x):
        y = self.pw(self.dw(same_pad(x, 5, self.stride)))
        if self.stride == 2:
            x = F.max_pool2d(x, 2, 2)
        if self.features > self.cin:
            x = F.pad(x, (0, 0, 0, 0, 0, self.features - self.cin))
        elif self.features < self.cin:
            x = x[:, : self.features]
        return torch.relu(x + y)


class BlazeFace(nn.Module):
    """Short-range face detector; returns the raw SSD head tensors."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 24, 5, stride=2, bias=True)
        cin = 24
        for i, (feats, stride) in enumerate(BLAZE_BLOCKS):
            setattr(self, f"b{i + 1}", BlazeBlock(cin, feats, stride))
            cin = feats
        self.classifier_8 = nn.Conv2d(88, 2, 1, bias=True)
        self.regressor_8 = nn.Conv2d(88, 32, 1, bias=True)
        self.classifier_16 = nn.Conv2d(96, 6, 1, bias=True)
        self.regressor_16 = nn.Conv2d(96, 96, 1, bias=True)

    @property
    def dtype(self) -> torch.dtype:
        return self.conv1.weight.dtype

    def forward(self, x01_nhwc: torch.Tensor):
        """x: (B, S, S, 3) RGB in [0, 1], S divisible by 16.  Returns
        ``(scores (B, A), regressions (B, A, 16))`` float32 in anchor
        order."""
        x = ((x01_nhwc.to(self.dtype) - 0.5) * 2.0).permute(0, 3, 1, 2)
        x = torch.relu(self.conv1(same_pad(x, 5, 2)))
        f16 = None
        for i, (feats, stride) in enumerate(BLAZE_BLOCKS):
            if stride == 2 and feats == 96:
                f16 = x  # the 88-channel map feeds the stride-8 heads
            x = getattr(self, f"b{i + 1}")(x)
        f8 = x
        b = x.shape[0]

        def head(conv, feat):  # NCHW → NHWC float32, flattened cell by cell
            return conv(feat).float().permute(0, 2, 3, 1)

        c8, r8 = head(self.classifier_8, f16), head(self.regressor_8, f16)
        c16, r16 = head(self.classifier_16, f8), head(self.regressor_16, f8)
        scores = torch.cat([c8.reshape(b, -1), c16.reshape(b, -1)], dim=1)
        regs = torch.cat([r8.reshape(b, -1, 16), r16.reshape(b, -1, 16)], dim=1)
        return scores, regs


def blazeface_layer_order() -> List[Tuple]:
    """Parameterised layers in execution order for weight import (all
    plain biased convs: the TFLite file ships BN folded), as
    ``fire_tpu.models.blazeface.blazeface_layer_order`` lists them."""
    order: List[Tuple] = [("conv", ("conv1",))]
    for i in range(1, len(BLAZE_BLOCKS) + 1):
        order.append(("conv", (f"b{i}", "dw")))
        order.append(("conv", (f"b{i}", "pw")))
    for head in ("classifier_8", "regressor_8", "classifier_16", "regressor_16"):
        order.append(("conv", (head,)))
    return order


def decode_blazeface(
    scores: torch.Tensor,
    regs: torch.Tensor,
    scale: float,
    conf_threshold: float = 0.8,
    nms_threshold: float = 0.3,
    max_faces: int = 32,
    input_px: int = 128,
) -> Detections:
    """SSD decode + weighted NMS → padded `Detections` in source-frame
    pixels, batched over the leading axis (the JAX version decodes one
    frame and is vmapped by its caller).

    The raw score is clipped to ±100 and passed through a sigmoid;
    regressions are anchor-relative in units of the ``input_px`` model
    input, and ``scale`` is the letterbox factor (source px × scale =
    canvas px).  The 6 keypoints (right_eye, left_eye, nose, mouth,
    right_ear, left_ear) map to the 5-point layout with the mouth in
    both mouth slots."""
    anchors = _anchors_on(input_px, scores.device) * input_px
    prob = torch.sigmoid(torch.clamp(scores, -100.0, 100.0))
    r = regs / scale
    apx = anchors / scale
    cx = apx[:, 0] + r[..., 0]
    cy = apx[:, 1] + r[..., 1]
    bw, bh = r[..., 2], r[..., 3]
    boxes = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], dim=-1)
    kp = r[..., 4:16].reshape(*r.shape[:-1], 6, 2)
    kps6 = torch.stack([apx[:, None, 0] + kp[..., 0], apx[:, None, 1] + kp[..., 1]], dim=-1)
    lms = torch.cat([kps6[..., :4, :], kps6[..., 3:4, :]], dim=-2)  # no host index list

    keep_idx, keep_mask = fbox.nms(boxes, prob, nms_threshold, max_out=max_faces,
                                   score_threshold=conf_threshold, pre_top_k=256)
    bb, ll = fbox.weighted_blend(boxes, prob, keep_idx, keep_mask, nms_threshold,
                                 conf_threshold, payload=lms)
    m = keep_mask.to(bb.dtype)
    return Detections(fbox.xyxy_to_xywh(bb) * m[..., None], ll * m[..., None, None],
                      torch.gather(prob, -1, keep_idx) * m, keep_mask)
