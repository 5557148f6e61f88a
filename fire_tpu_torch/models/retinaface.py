"""RetinaFace detector: ResNet-50 + FPN + SSH heads (counterpart of
``fire_tpu.models.retinaface``: ``Bottleneck``, ``SSH``, ``RetinaFace``,
``decode_retinaface``).

Same topology and module names as the Flax model, so the committed
``weights_trained/retinaface_synth.msgpack`` loads key for key
(:func:`fire_tpu_torch.weights.from_flax_retinaface`).  Full width by
default: stages (3, 4, 6, 3) of bottlenecks at width 64, FPN and SSH at
256 channels, two anchors per cell at strides 8, 16 and 32.

Details kept from the Flax model:

* ``padding="SAME"`` at stride 2 on an even side pads less before than
  after: 2 / 3 for the 7×7 stem, 0 / 1 for the 3×3 ``c2``, none for the
  1×1 ``proj``; the stem's 3×3 max-pool pads 0 / 1 with ``-inf``.
* The FPN upsamples by repeating each pixel 2×2 (nearest).
* Heads are cast to float32 and laid out NHWC before any reshape: the
  class logits become ``(b, h, w, 2, A)`` with a softmax over the pair,
  so their channels are ``[bg_a0, bg_a1, face_a0, face_a1]``; boxes and
  landmarks flatten in ``(h, w, A, ·)`` order.
* The decode concatenates strides 32, 16, 8, divides boxes and
  landmarks by the letterbox scale before NMS, and suppresses with the
  legacy ``+1`` area and ``>=``; ties keep the lower index (stable
  sorts, as ``lax.top_k``).
"""

from __future__ import annotations

import functools
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fire_tpu_torch.models.detections import Detections, pad_detections
from fire_tpu_torch.models.layers import BatchNorm, max_pool_same, same_pad
from fire_tpu_torch.ops import anchors as fanch
from fire_tpu_torch.ops import boxes as fbox

_BN_EPS = 1e-5

Heads = Dict[int, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


class Bottleneck(nn.Module):
    """ResNet-v1 bottleneck: 1×1 → 3×3 (stride) → 1×1 (×4), with a
    projected shortcut where the width or the stride changes."""

    def __init__(self, cin: int, features: int, strides: int = 1):
        super().__init__()
        self.strides = strides
        f = features
        if cin != f * 4 or strides != 1:
            self.proj = nn.Conv2d(cin, f * 4, 1, stride=strides, bias=False)
            self.proj_bn = BatchNorm(f * 4, _BN_EPS)
        else:
            self.proj = None
        self.c1 = nn.Conv2d(cin, f, 1, bias=False)
        self.bn1 = BatchNorm(f, _BN_EPS)
        self.c2 = nn.Conv2d(f, f, 3, stride=strides, bias=False)
        self.bn2 = BatchNorm(f, _BN_EPS)
        self.c3 = nn.Conv2d(f, f * 4, 1, bias=False)
        self.bn3 = BatchNorm(f * 4, _BN_EPS)

    def forward(self, x, train: bool = False):
        sc = x if self.proj is None else self.proj_bn(self.proj(x), train)
        y = torch.relu(self.bn1(self.c1(x), train))
        y = torch.relu(self.bn2(self.c2(same_pad(y, 3, self.strides)), train))
        y = self.bn3(self.c3(y), train)
        return torch.relu(y + sc)


class SSH(nn.Module):
    """SSH context module: 3×3 ∥ 5×5 (two 3×3) ∥ 7×7 (three 3×3) → concat."""

    def __init__(self, cin: int, features: int = 256):
        super().__init__()
        f = features
        for name, a, b in (("b3", cin, f // 2), ("m", cin, f // 4), ("b5", f // 4, f // 4),
                           ("m2", f // 4, f // 4), ("b7", f // 4, f // 4)):
            setattr(self, name, nn.Conv2d(a, b, 3, padding=1, bias=False))
            setattr(self, name + "_bn", BatchNorm(b, _BN_EPS))

    def _conv_bn(self, x, name: str, relu: bool, train: bool):
        y = getattr(self, name + "_bn")(getattr(self, name)(x), train)
        return torch.relu(y) if relu else y

    def forward(self, x, train: bool = False):
        b3 = self._conv_bn(x, "b3", False, train)
        m = self._conv_bn(x, "m", True, train)
        b5 = self._conv_bn(m, "b5", False, train)
        m2 = self._conv_bn(m, "m2", True, train)
        b7 = self._conv_bn(m2, "b7", False, train)
        return torch.relu(torch.cat([b3, b5, b7], dim=1))


def _up2(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2× upsampling (``jnp.repeat`` on both axes)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class RetinaFace(nn.Module):
    """ResNet-50 + FPN + SSH with 2-anchor heads at strides 8 / 16 / 32."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3), width: int = 64,
                 num_anchors: int = 2):
        super().__init__()
        self.stage_sizes, self.num_anchors = tuple(stage_sizes), num_anchors
        w, a = width, num_anchors
        self.stem = nn.Conv2d(3, w, 7, stride=2, bias=False)
        self.stem_bn = BatchNorm(w, _BN_EPS)
        cin = w
        for i, n_blocks in enumerate(self.stage_sizes):
            f = w * (2 ** i)
            for j in range(n_blocks):
                strides = 2 if (i > 0 and j == 0) else 1
                setattr(self, f"stage{i}_block{j}", Bottleneck(cin, f, strides))
                cin = f * 4
        c8, c16, c32 = (w * (2 ** i) * 4 for i in (1, 2, 3))
        self.lat32 = nn.Conv2d(c32, 256, 1, bias=False)
        self.lat16 = nn.Conv2d(c16, 256, 1, bias=False)
        self.smooth16 = nn.Conv2d(256, 256, 3, padding=1, bias=False)
        self.lat8 = nn.Conv2d(c8, 256, 1, bias=False)
        self.smooth8 = nn.Conv2d(256, 256, 3, padding=1, bias=False)
        for s in (8, 16, 32):
            setattr(self, f"ssh_s{s}", SSH(256, 256))
            setattr(self, f"cls_s{s}", nn.Conv2d(256, 2 * a, 1, bias=True))
            setattr(self, f"bbox_s{s}", nn.Conv2d(256, 4 * a, 1, bias=True))
            setattr(self, f"lmk_s{s}", nn.Conv2d(256, 10 * a, 1, bias=True))

    @property
    def dtype(self) -> torch.dtype:
        return self.stem.weight.dtype

    def forward(self, x_nhwc: torch.Tensor, train: bool = False) -> Heads:
        """x: (B, H, W, 3) raw-pixel RGB, H and W divisible by 32.
        Returns ``{stride: (face_prob (B,h,w,A), bbox (B,h,w,4A),
        lmk (B,h,w,10A))}`` float32, NHWC, for strides 8 / 16 / 32.
        ``train=True`` normalises with the batch's statistics and
        updates the running ones (Flax's momentum 0.99)."""
        x = x_nhwc.to(self.dtype).permute(0, 3, 1, 2)
        x = torch.relu(self.stem_bn(self.stem(same_pad(x, 7, 2)), train))
        x = max_pool_same(x, 3, 2)
        feats = {}
        for i, n_blocks in enumerate(self.stage_sizes):
            for j in range(n_blocks):
                x = getattr(self, f"stage{i}_block{j}")(x, train)
            if i >= 1:
                feats[2 ** (i + 2)] = x  # strides 8, 16, 32

        p5 = self.lat32(feats[32])
        p4 = self.smooth16(self.lat16(feats[16]) + _up2(p5))
        p3 = self.smooth8(self.lat8(feats[8]) + _up2(p4))

        a = self.num_anchors
        out = {}
        for stride, feat in ((8, p3), (16, p4), (32, p5)):
            ctx = getattr(self, f"ssh_s{stride}")(feat, train)

            def head(name):  # NCHW → NHWC float32
                return getattr(self, f"{name}_s{stride}")(ctx).float().permute(0, 2, 3, 1)

            logits = head("cls")
            b, h, w = logits.shape[:3]
            prob = torch.softmax(logits.reshape(b, h, w, 2, a), dim=-2)[:, :, :, 1, :]
            out[stride] = (prob, head("bbox"), head("lmk"))
        return out


@functools.lru_cache(maxsize=32)
def _anchors(h: int, w: int, stride: int, device: torch.device) -> torch.Tensor:
    plane = fanch.anchors_plane(h, w, stride, fanch.RETINAFACE_ANCHORS[stride])
    return torch.from_numpy(plane).to(device)


def decode_retinaface(
    head_outputs: Heads,
    im_hw,
    scale,
    threshold: float = 0.9,
    nms_threshold: float = 0.4,
    max_faces: int = 32,
) -> Detections:
    """Heads → padded `Detections` in source pixels, batched over the
    leading axis (the JAX version decodes one frame and is vmapped by
    its caller).  ``im_hw`` is the network input size (boxes are clipped
    to it); ``scale`` the letterbox scale back to source pixels."""
    all_boxes, all_lms, all_scores = [], [], []
    for stride in fanch.RETINAFACE_STRIDES:
        prob, bbox, lmk = head_outputs[stride]
        b, h, w = prob.shape[:3]
        anchors = _anchors(h, w, stride, prob.device)
        boxes = fanch.clip_boxes_xyxy(fanch.bbox_decode(anchors, bbox.reshape(b, -1, 4)), im_hw)
        all_boxes.append(boxes)
        all_lms.append(fanch.landmark_decode(anchors, lmk.reshape(b, -1, 5, 2)))
        all_scores.append(prob.reshape(b, -1))

    boxes = torch.cat(all_boxes, dim=1) / scale
    lms = torch.cat(all_lms, dim=1) / scale
    scores = torch.cat(all_scores, dim=1)
    keep_idx, keep_mask = fbox.nms(boxes, scores, nms_threshold, max_out=max_faces,
                                   score_threshold=threshold, plus_one=True,
                                   suppress_equal=True, pre_top_k=256)
    return pad_detections(fbox.xyxy_to_xywh(boxes), lms, scores, keep_idx, keep_mask)
