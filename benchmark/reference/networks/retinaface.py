"""RetinaFace (ResNet-50 + FPN + SSH): the detector with its anchor
decode."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from reference.nets import BatchNorm, QConv2d, draw, same_pad, up2

ROLE = "detector"
CHANNELS, SCALE = "rgb", 1.0
UNIT_BN_SCALE = False
NMS = {"plus_one": True, "suppress_equal": True}

# RetinaFace base anchors (xyxy) per stride, two per cell.
RETINA_ANCHORS = {
    32: ((-248.0, -248.0, 263.0, 263.0), (-120.0, -120.0, 135.0, 135.0)),
    16: ((-56.0, -56.0, 71.0, 71.0), (-24.0, -24.0, 39.0, 39.0)),
    8: ((-8.0, -8.0, 23.0, 23.0), (0.0, 0.0, 15.0, 15.0)),
}


class Bottleneck(nn.Module):
    def __init__(self, cin: int, f: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        if cin != f * 4 or stride != 1:
            self.proj = QConv2d(cin, f * 4, 1, stride=stride, bias=False)
            self.proj_bn = BatchNorm(f * 4, 1e-5)
        else:
            self.proj = None
        self.c1 = QConv2d(cin, f, 1, bias=False)
        self.bn1 = BatchNorm(f, 1e-5)
        self.c2 = QConv2d(f, f, 3, stride=stride, bias=False)
        self.bn2 = BatchNorm(f, 1e-5)
        self.c3 = QConv2d(f, f * 4, 1, bias=False)
        self.bn3 = BatchNorm(f * 4, 1e-5)

    def forward(self, x):
        sc = x if self.proj is None else self.proj_bn(self.proj(x))
        y = torch.relu(self.bn1(self.c1(x)))
        y = torch.relu(self.bn2(self.c2(same_pad(y, 3, self.stride))))
        return torch.relu(self.bn3(self.c3(y)) + sc)


class SSH(nn.Module):
    def __init__(self, cin: int, f: int = 256):
        super().__init__()
        for name, a, b in (("b3", cin, f // 2), ("m", cin, f // 4), ("b5", f // 4, f // 4),
                           ("m2", f // 4, f // 4), ("b7", f // 4, f // 4)):
            setattr(self, name, QConv2d(a, b, 3, padding=1, bias=False))
            setattr(self, name + "_bn", BatchNorm(b, 1e-5))

    def _cb(self, x, name, relu):
        y = getattr(self, name + "_bn")(getattr(self, name)(x))
        return torch.relu(y) if relu else y

    def forward(self, x):
        m = self._cb(x, "m", True)
        m2 = self._cb(m, "m2", True)
        return torch.relu(torch.cat([self._cb(x, "b3", False), self._cb(m, "b5", False),
                                     self._cb(m2, "b7", False)], dim=1))


class RetinaFace(nn.Module):
    """RetinaFace: (B, H, W, 3) raw-pixel RGB -> ``{stride: (face prob
    (B,h,w,A), box deltas (B,h,w,4A), landmark deltas (B,h,w,10A))}``."""

    def __init__(self, stages: Sequence[int] = (3, 4, 6, 3), width: int = 64, anchors: int = 2):
        super().__init__()
        self.stages, self.anchors = tuple(stages), anchors
        w, a = width, anchors
        self.stem = QConv2d(3, w, 7, stride=2, bias=False)
        self.stem_bn = BatchNorm(w, 1e-5)
        cin = w
        for i, n in enumerate(self.stages):
            f = w * 2 ** i
            for j in range(n):
                setattr(self, f"stage{i}_block{j}",
                        Bottleneck(cin, f, 2 if (i > 0 and j == 0) else 1))
                cin = f * 4
        c8, c16, c32 = (w * 2 ** i * 4 for i in (1, 2, 3))
        self.lat32 = QConv2d(c32, 256, 1, bias=False)
        self.lat16 = QConv2d(c16, 256, 1, bias=False)
        self.smooth16 = QConv2d(256, 256, 3, padding=1, bias=False)
        self.lat8 = QConv2d(c8, 256, 1, bias=False)
        self.smooth8 = QConv2d(256, 256, 3, padding=1, bias=False)
        for s in (8, 16, 32):
            setattr(self, f"ssh_s{s}", SSH(256, 256))
            setattr(self, f"cls_s{s}", QConv2d(256, 2 * a, 1, bias=True))
            setattr(self, f"bbox_s{s}", QConv2d(256, 4 * a, 1, bias=True))
            setattr(self, f"lmk_s{s}", QConv2d(256, 10 * a, 1, bias=True))

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        x = torch.relu(self.stem_bn(self.stem(same_pad(x, 7, 2))))
        x = F.max_pool2d(same_pad(x, 3, 2, float("-inf")), 3, 2)
        feats = {}
        for i, n in enumerate(self.stages):
            for j in range(n):
                x = getattr(self, f"stage{i}_block{j}")(x)
            if i >= 1:
                feats[2 ** (i + 2)] = x
        p5 = self.lat32(feats[32])
        p4 = self.smooth16(self.lat16(feats[16]) + up2(p5))
        p3 = self.smooth8(self.lat8(feats[8]) + up2(p4))
        out = {}
        for s, feat in ((8, p3), (16, p4), (32, p5)):
            ctx = getattr(self, f"ssh_s{s}")(feat)

            def head(name):
                return getattr(self, f"{name}_s{s}")(ctx).permute(0, 2, 3, 1)

            logits = head("cls")
            b, h, w = logits.shape[:3]
            prob = torch.softmax(logits.reshape(b, h, w, 2, self.anchors), dim=-2)[..., 1, :]
            out[s] = (prob, head("bbox"), head("lmk"))
        return out


def build() -> nn.Module:
    return RetinaFace()


def init(net: nn.Module, generator: torch.Generator) -> None:
    draw(net, generator, (160, 160), SCALE, UNIT_BN_SCALE)


def candidates(heads, input_hw) -> Tuple[np.ndarray, np.ndarray]:
    """RetinaFace's anchor decode (legacy +1 widths), clipped to the
    network input, strides 32, 16, 8 in that order."""
    boxes, scores = [], []
    for stride in (32, 16, 8):
        prob, bbox = (t[0].double().cpu().numpy() for t in heads[stride][:2])
        h, w, a = prob.shape
        base = np.asarray(RETINA_ANCHORS[stride], np.float64)
        xs, ys = np.meshgrid(np.arange(w) * stride, np.arange(h) * stride)
        shift = np.stack([xs, ys, xs, ys], -1)[:, :, None, :]
        anc = (shift + base[None, None]).reshape(-1, 4)
        d = bbox.reshape(-1, 4)
        aw, ah = anc[:, 2] - anc[:, 0] + 1.0, anc[:, 3] - anc[:, 1] + 1.0
        acx, acy = anc[:, 0] + 0.5 * (aw - 1.0), anc[:, 1] + 0.5 * (ah - 1.0)
        px, py = d[:, 0] * aw + acx, d[:, 1] * ah + acy
        pw, ph = np.exp(d[:, 2]) * aw, np.exp(d[:, 3]) * ah
        b = np.stack([px - 0.5 * (pw - 1.0), py - 0.5 * (ph - 1.0),
                      px + 0.5 * (pw - 1.0), py + 0.5 * (ph - 1.0)], -1)
        b[:, 0::2] = np.clip(b[:, 0::2], 0, input_hw[1] - 1.0)
        b[:, 1::2] = np.clip(b[:, 1::2], 0, input_hw[0] - 1.0)
        boxes.append(b)
        scores.append(prob.reshape(-1))
    return np.concatenate(boxes), np.concatenate(scores)
