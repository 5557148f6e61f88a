"""ArcFace IResNet (InsightFace ``arcface_torch/backbones/iresnet.py``;
Deng et al., "ArcFace: Additive Angular Margin Loss for Deep Face
Recognition", arXiv:1801.07698): the encoder ``iresnet100``, 112×112
RGB in ``[0, 1]`` to an unnormalised float32 512-d embedding.

The equations, as arcface_torch writes them:

* input ``(x − 0.5) / 0.5`` (arcface_torch's ``(x / 255 − 0.5) / 0.5``
  on pixels in ``[0, 1]``);
* stem: conv3×3 3 → 64, stride 1, pad 1, no bias; BN; PReLU (a slope a
  channel);
* body: four stages of 64, 128, 256 and 512 channels, of ``layers``
  :class:`IBasicBlock` s (``(3, 13, 30, 3)`` for IResNet-100);
* a block: ``BN3(conv2(PReLU(BN2(conv1(BN1(x)))))) + shortcut(x)``, no
  activation after the add; conv1 3×3 stride 1, conv2 3×3 with stride 2
  in a stage's first block, both pad 1 (PyTorch's symmetric pad, not
  XLA's ``SAME``: at stride 2 on an even side ``SAME`` pads 0 before
  and 1 after) and no bias; the shortcut of a stage's first block is
  conv1×1 stride 2 (no bias), BN; elsewhere ``x``;
* head: BN2d over 512×7×7; flatten in (C, H, W) order; Linear 25,088 →
  512 with bias; ``features``, a BN1d whose weight is 1 (trained so, it
  is an ordinary scale in the weight files);
* every BN has eps 1e-5.

The body runs in the module's dtype (bf16 on the card, channels-last);
``fc`` and ``features`` stay float32 when the module is cast, as
arcface_torch runs them under fp16.  Every BatchNorm is the port's
:class:`~fire_tpu_torch.models.layers.BatchNorm` with scale, so an eval
bf16 call on the card is kernel K3, the PReLU after BN of the stem and
of each block K3's PReLU route: 153 launches an encode, 50 of them
PReLU.

Departures from arcface_torch, none of which changes what a trained
network computes in eval mode:

* module names are the weight files' Flax paths: ``layer1_0`` for
  ``layer1.0``, ``downsample_conv`` / ``downsample_bn`` for
  ``downsample.0`` / ``.1``; a PReLU's slope is ``negative_slope``
  (``weight`` in torch's ``nn.PReLU``);
* arcface_torch's ``dropout`` before ``fc`` (p = 0 in ``iresnet100``,
  and a no-op in eval) is left out, and so is ``fp16`` autocast: the
  dtype is the module's;
* ``forward(x, train=False)`` serves with the running statistics, as
  the port's other networks do (``train=True`` normalises with the
  batch's, in the port's Flax-shaped training form).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from fire_tpu_torch.models.layers import BatchNorm, PReLU

EPS = 1e-5
WIDTHS = (64, 128, 256, 512)
PX = 112  # the crop side: the fc takes exactly 7 × 7 × 512 (112 / 2⁴)


def _conv3x3(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False)


class IBasicBlock(nn.Module):
    """The pre-activation block: BN → conv3×3 → BN → PReLU → conv3×3
    (stride ``stride``) → BN, plus the shortcut; no activation after the
    add."""

    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.bn1 = BatchNorm(cin, EPS)
        self.conv1 = _conv3x3(cin, cout)
        self.bn2 = BatchNorm(cout, EPS)
        self.prelu = PReLU(cout)
        self.conv2 = _conv3x3(cout, cout, stride)
        self.bn3 = BatchNorm(cout, EPS)
        self.down = stride != 1 or cin != cout
        if self.down:
            self.downsample_conv = nn.Conv2d(cin, cout, 1, stride=stride, bias=False)
            self.downsample_bn = BatchNorm(cout, EPS)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        sc = self.downsample_bn(self.downsample_conv(x), train) if self.down else x
        y = self.conv1(self.bn1(x, train))
        y = self.conv2(self.bn2(y, train, slope=self.prelu.negative_slope))
        return self.bn3(y, train, residual=sc)


class Float32Linear(nn.Linear):
    """A linear layer that stays float32 when its module is cast and
    computes in float32 whatever the input's dtype."""

    def _apply(self, fn, recurse=True):
        super()._apply(fn, recurse)
        for p in (self.weight, self.bias):
            if p is not None:
                p.data = p.data.float()
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float())


class IResNet(nn.Module):
    """IResNet with ``layers`` blocks a stage at the published widths:
    (B, 112, 112, 3) RGB in [0, 1] → (B, ``embed_dim``) float32."""

    def __init__(self, layers: Sequence[int], embed_dim: int = 512):
        super().__init__()
        self.layers = tuple(layers)
        self.embed_dim = embed_dim
        self.conv1 = _conv3x3(3, WIDTHS[0])
        self.bn1 = BatchNorm(WIDTHS[0], EPS)
        self.prelu = PReLU(WIDTHS[0])
        cin = WIDTHS[0]
        for s, (n, width) in enumerate(zip(self.layers, WIDTHS)):
            for i in range(n):
                self.add_module(f"layer{s + 1}_{i}",
                                IBasicBlock(cin, width, 2 if i == 0 else 1))
                cin = width
        side = PX // 2 ** len(WIDTHS)
        self.bn2 = BatchNorm(cin, EPS)
        self.fc = Float32Linear(cin * side * side, embed_dim)
        self.features = BatchNorm(embed_dim, EPS)

    @property
    def dtype(self) -> torch.dtype:
        return self.conv1.weight.dtype

    def forward(self, x01_nhwc: torch.Tensor, train: bool = False) -> torch.Tensor:
        """x: (B, H, W, 3) float in [0, 1] → (B, embed_dim) float32."""
        x = ((x01_nhwc.float() - 0.5) / 0.5).to(self.dtype).permute(0, 3, 1, 2)
        x = self.bn1(self.conv1(x), train, slope=self.prelu.negative_slope)
        for s, n in enumerate(self.layers):
            for i in range(n):
                x = getattr(self, f"layer{s + 1}_{i}")(x, train)
        x = self.bn2(x, train)
        x = self.fc(x.flatten(1))  # (C, H, W) order, whatever the memory layout
        return self.features(x, train).float()


def iresnet100(embed_dim: int = 512) -> IResNet:
    """ArcFace IResNet-100 (arcface_torch ``iresnet100``; the backbone of
    InsightFace's ``glintr100``)."""
    return IResNet((3, 13, 30, 3), embed_dim)
