"""YuNet 2023mar (OpenCV Zoo ``face_detection_yunet``): the detector
with its anchor-free decode."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from reference.nets import BatchNorm, QConv2d, draw, up2

ROLE = "detector"
CHANNELS, SCALE = "bgr", 255.0
UNIT_BN_SCALE = False
NMS = {"plus_one": False, "suppress_equal": False}


class DPUnit(nn.Module):
    """1x1 conv -> 3x3 depthwise conv [-> BN -> ReLU]."""

    def __init__(self, cin: int, f: int, bn_relu: bool = True):
        super().__init__()
        self.conv1 = QConv2d(cin, f, 1, bias=True)
        self.conv2 = QConv2d(f, f, 3, padding=1, groups=f, bias=True)
        self.bn = BatchNorm(f, 1e-5) if bn_relu else None

    def forward(self, x):
        x = self.conv2(self.conv1(x))
        return torch.relu(self.bn(x)) if self.bn is not None else x


class YuHead(nn.Module):
    def __init__(self, mid: int, f: int):
        super().__init__()
        self.conv1 = QConv2d(3, mid, 3, stride=2, padding=1, bias=True)
        self.bn1 = BatchNorm(mid, 1e-5)
        self.conv2 = DPUnit(mid, f)

    def forward(self, x):
        return self.conv2(torch.relu(self.bn1(self.conv1(x))))


class YuBlock(nn.Module):
    def __init__(self, cin: int, f: int):
        super().__init__()
        self.conv1 = DPUnit(cin, cin)
        self.conv2 = DPUnit(cin, f)

    def forward(self, x):
        return self.conv2(self.conv1(x))


class YuOut(nn.Module):
    def __init__(self, w: int):
        super().__init__()
        self.feat = DPUnit(w, w)
        self.cls = DPUnit(w, 1, False)
        self.obj = DPUnit(w, 1, False)
        self.box = DPUnit(w, 4, False)
        self.kps = DPUnit(w, 10, False)

    def forward(self, x):
        f = self.feat(x)
        return torch.sigmoid(self.cls(f)), torch.sigmoid(self.obj(f)), self.box(f), self.kps(f)


class YuNet(nn.Module):
    """YuNet: (B, H, W, 3) BGR in [0, 1] -> ``{stride: (cls, obj, box,
    kps)}`` NHWC at strides 8 / 16 / 32."""

    def __init__(self, width: int = 64):
        super().__init__()
        w = width
        stem = max(w // 4, 2)
        self.model0 = YuHead(stem, stem)
        self.model1 = YuBlock(stem, w)
        for i in range(2, 6):
            setattr(self, f"model{i}", YuBlock(w, w))
        for n in ("neck2", "neck1", "neck0"):
            setattr(self, n, DPUnit(w, w))
        for s in (8, 16, 32):
            setattr(self, f"head_s{s}", YuOut(w))

    def forward(self, x01):
        x = (x01 * 255.0).permute(0, 3, 1, 2)
        x = F.max_pool2d(self.model0(x), 2, 2)
        x = F.max_pool2d(self.model2(self.model1(x)), 2, 2)
        c3 = self.model3(x)
        c4 = self.model4(F.max_pool2d(c3, 2, 2))
        c5 = self.model5(F.max_pool2d(c4, 2, 2))
        p5 = self.neck2(c5)
        p4 = self.neck1(c4 + up2(p5))
        p3 = self.neck0(c3 + up2(p4))
        return {s: tuple(t.permute(0, 2, 3, 1) for t in getattr(self, f"head_s{s}")(f))
                for s, f in ((8, p3), (16, p4), (32, p5))}


def build() -> nn.Module:
    return YuNet()


def init(net: nn.Module, generator: torch.Generator) -> None:
    draw(net, generator, (160, 160), SCALE, UNIT_BN_SCALE)


def candidates(heads, input_hw) -> Tuple[np.ndarray, np.ndarray]:
    """YuNet's anchor-free decode: score sqrt(cls * obj), centre (cell +
    offset) * stride, size exp(pred) * stride."""
    boxes, scores = [], []
    for stride, (cls, obj, box, _kps) in heads.items():
        cls, obj, box = (t[0].double().cpu().numpy() for t in (cls, obj, box))
        h, w = cls.shape[:2]
        cols, rows = np.arange(w)[None, :], np.arange(h)[:, None]
        cx = (cols + box[..., 0]) * stride
        cy = (rows + box[..., 1]) * stride
        bw, bh = np.exp(box[..., 2]) * stride, np.exp(box[..., 3]) * stride
        boxes.append(np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2],
                              -1).reshape(-1, 4))
        scores.append(np.sqrt(np.clip(cls[..., 0] * obj[..., 0], 0, 1)).reshape(-1))
    return np.concatenate(boxes), np.concatenate(scores)
