"""YuNet 2023mar face detector (counterpart of ``fire_tpu.models.yunet``).

Same topology and module names as the Flax model, so the committed
Flax weights load key for key (:func:`fire_tpu_torch.weights.
from_flax_yunet`).  The public forward takes NHWC ``[0, 1]`` input and
returns NHWC head maps, like the JAX model; inside it runs NCHW with
channels-last memory (a permuted NHWC tensor), the layout cuDNN prefers.

Details kept from the JAX model: the stem conv pads (1, 1), not SAME
(``yunet.py:82-85``); ``_up2`` is a nearest ×2 upsample (``:126``); the
input is multiplied by 255 and cast to the compute dtype (``:150``);
the heads apply sigmoid in float32 (``:118-123``).  BatchNorm eps 1e-5,
Flax's default momentum 0.99.  ``forward(x, train=False)`` serves with
the running statistics; ``train=True`` (the trainer's) normalises with
the batch's and updates them.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn

from fire_tpu_torch.models.detections import Detections, pad_detections
from fire_tpu_torch.models.layers import BatchNorm, max_pool_valid
from fire_tpu_torch.ops import anchors as fanch
from fire_tpu_torch.ops import boxes as fbox

_BN_EPS = 1e-5


class ConvDPUnit(nn.Module):
    """1×1 conv (bias) → 3×3 depthwise conv (bias) [→ BN → ReLU]."""

    def __init__(self, cin: int, features: int, with_bn_relu: bool = True):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, features, 1, bias=True)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1, groups=features, bias=True)
        self.bn = BatchNorm(features, _BN_EPS) if with_bn_relu else None

    def forward(self, x, train: bool = False):
        x = self.conv2(self.conv1(x))
        if self.bn is not None:
            x = self.bn(x, train, relu=True)
        return x


class ConvHead(nn.Module):
    """Stem: 3×3 s2 conv(bias, pad 1)+BN+ReLU, then a ConvDPUnit."""

    def __init__(self, mid: int, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(3, mid, 3, stride=2, padding=1, bias=True)
        self.bn1 = BatchNorm(mid, _BN_EPS)
        self.conv2 = ConvDPUnit(mid, features)

    def forward(self, x, train: bool = False):
        return self.conv2(self.bn1(self.conv1(x), train, relu=True), train)


class Conv4LayerBlock(nn.Module):
    """Two stacked ConvDPUnits (in→in, in→out)."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.conv1 = ConvDPUnit(cin, cin)
        self.conv2 = ConvDPUnit(cin, features)

    def forward(self, x, train: bool = False):
        return self.conv2(self.conv1(x, train), train)


class YuNetHead(nn.Module):
    """Per-level head: shared DP feature + cls/obj/box/kps outputs."""

    def __init__(self, width: int):
        super().__init__()
        self.feat = ConvDPUnit(width, width)
        self.cls = ConvDPUnit(width, 1, with_bn_relu=False)
        self.obj = ConvDPUnit(width, 1, with_bn_relu=False)
        self.box = ConvDPUnit(width, 4, with_bn_relu=False)
        self.kps = ConvDPUnit(width, 10, with_bn_relu=False)

    def forward(self, x, train: bool = False):
        f = self.feat(x, train)
        return (
            torch.sigmoid(self.cls(f).float()),
            torch.sigmoid(self.obj(f).float()),
            self.box(f).float(),
            self.kps(f).float(),
        )


def _up2(x):
    """Nearest ×2 upsample (NCHW)."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class YuNet(nn.Module):
    """yunet_n backbone + TFPN + anchor-free heads at strides 8/16/32.
    ``width`` scales the 64-channel trunk (stem = max(width//4, 2))."""

    def __init__(self, width: int = 64):
        super().__init__()
        w = width
        stem = max(w // 4, 2)
        self.width = w
        # registration order = execution order (yunet_layer_order)
        self.model0 = ConvHead(stem, stem)
        self.model1 = Conv4LayerBlock(stem, w)
        self.model2 = Conv4LayerBlock(w, w)
        self.model3 = Conv4LayerBlock(w, w)
        self.model4 = Conv4LayerBlock(w, w)
        self.model5 = Conv4LayerBlock(w, w)
        self.neck2 = ConvDPUnit(w, w)
        self.neck1 = ConvDPUnit(w, w)
        self.neck0 = ConvDPUnit(w, w)
        self.head_s8 = YuNetHead(w)
        self.head_s16 = YuNetHead(w)
        self.head_s32 = YuNetHead(w)

    @property
    def dtype(self) -> torch.dtype:
        return self.model0.conv1.weight.dtype

    def forward(self, x01_nhwc: torch.Tensor, train: bool = False
                ) -> Dict[int, Tuple[torch.Tensor, ...]]:
        """x: (B, H, W, 3) float in [0, 1]; H, W divisible by 32.
        Returns ``{8: (cls, obj, box, kps), 16: ..., 32: ...}`` NHWC f32."""
        x = (x01_nhwc * 255.0).to(self.dtype).permute(0, 3, 1, 2)
        x = self.model0(x, train)
        x = max_pool_valid(x, 2, 2)
        x = self.model2(self.model1(x, train), train)
        x = max_pool_valid(x, 2, 2)
        c3 = self.model3(x, train)
        c4 = self.model4(max_pool_valid(c3, 2, 2), train)
        c5 = self.model5(max_pool_valid(c4, 2, 2), train)
        p5 = self.neck2(c5, train)
        p4 = self.neck1(c4 + _up2(p5), train)
        p3 = self.neck0(c3 + _up2(p4), train)
        out = {}
        for stride, feat, head in ((8, p3, self.head_s8), (16, p4, self.head_s16),
                                   (32, p5, self.head_s32)):
            out[stride] = tuple(t.permute(0, 2, 3, 1) for t in head(feat, train))
        return out


def yunet_layer_order() -> List[Tuple]:
    """Parameterised layers in execution order, as
    ``fire_tpu.models.yunet.yunet_layer_order`` lists them."""
    order: List[Tuple] = []

    def dp(path, bn=True):
        order.append(("conv", path + ("conv1",)))
        order.append(("conv", path + ("conv2",)))
        if bn:
            order.append(("bn", path + ("bn",), _BN_EPS))

    order.append(("conv", ("model0", "conv1")))
    order.append(("bn", ("model0", "bn1"), _BN_EPS))
    dp(("model0", "conv2"))
    for i in range(1, 6):
        dp((f"model{i}", "conv1"))
        dp((f"model{i}", "conv2"))
    for neck in ("neck2", "neck1", "neck0"):
        dp((neck,))
    for s in (8, 16, 32):
        dp((f"head_s{s}", "feat"))
        for o in ("cls", "obj", "box", "kps"):
            dp((f"head_s{s}", o), bn=False)
    return order


def decode_yunet(
    head_outputs,
    scale,
    conf_threshold: float = 0.90,
    nms_threshold: float = 0.3,
    max_faces: int = 32,
) -> Detections:
    """Heads → padded `Detections` in source-frame pixels, batched over
    the heads' leading axis (the JAX version decodes one frame; its
    vmap becomes this batch axis).  ``scale`` is the letterbox scale."""
    all_boxes, all_lms, all_scores = [], [], []
    for stride, (cls, obj, box, kps) in head_outputs.items():
        b, l, s = fanch.yunet_grid_decode(cls, obj, box, kps, stride)
        all_boxes.append(b)
        all_lms.append(l)
        all_scores.append(s)
    boxes = torch.cat(all_boxes, dim=-2)
    lms = torch.cat(all_lms, dim=-3)
    scores = torch.cat(all_scores, dim=-1)
    keep_idx, keep_mask = fbox.nms(
        boxes, scores, nms_threshold, max_out=max_faces,
        score_threshold=conf_threshold, pre_top_k=256,
    )
    return pad_detections(fbox.xyxy_to_xywh(boxes) / scale, lms / scale, scores,
                          keep_idx, keep_mask)
