"""ArcFace IResNet-100 (Deng et al., arXiv:1801.07698; InsightFace
``recognition/arcface_torch/backbones/iresnet.py``, ``iresnet100``; the
backbone of InsightFace's ``glintr100``): the encoder, 112 x 112 RGB in
[0, 1] to an unnormalised 512-d embedding, in plain float32.

The equations, arcface_torch's:

* input ``(x - 0.5) / 0.5`` (arcface_torch's ``(x / 255 - 0.5) / 0.5``
  on pixels in [0, 1]);
* stem: conv3x3 3 -> 64, stride 1, pad 1, no bias; BN; PReLU (a slope a
  channel);
* body: stages of 64, 128, 256 and 512 channels of 3, 13, 30 and 3
  blocks; a block is ``BN3(conv2(PReLU(BN2(conv1(BN1(x)))))) +
  shortcut(x)`` with no activation after the add, conv1 3x3 stride 1,
  conv2 3x3 with stride 2 in a stage's first block, both pad 1 on each
  side and no bias; a stage's first block's shortcut is conv1x1 stride
  2 (no bias), BN, elsewhere ``x``;
* head: BN2d over 512 x 7 x 7, flatten in (C, H, W) order, Linear 25,088
  -> 512 with bias, ``features`` a BN1d whose weight is 1;
* every BN eps 1e-5.

Departures from arcface_torch, none of which changes what it computes
in eval mode: module names are the weight files' paths (``layer1_0``
for ``layer1.0``, ``downsample_conv`` / ``downsample_bn`` for
``downsample.0`` / ``.1``, a PReLU's slope ``negative_slope`` where
``nn.PReLU`` says ``weight``); the dropout before ``fc`` (p = 0, a no-op
in eval) and the fp16 autocast are left out: everything is float32.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from reference.nets import BatchNorm, QConv2d, QLinear, draw

ROLE = "encoder"
CHANNELS, SCALE = "rgb", 255.0
UNIT_BN_SCALE = False

EPS = 1e-5
WIDTHS = (64, 128, 256, 512)
PX = (112, 112)


class PReLU(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.negative_slope = nn.Parameter(torch.full((c,), 0.25))

    def forward(self, x):
        return torch.where(x > 0, x, x * self.negative_slope.view(1, -1, 1, 1))


class Block(nn.Module):
    """``IBasicBlock``: BN, conv3x3, BN, PReLU, conv3x3 (stride), BN, plus
    the shortcut."""

    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.bn1 = BatchNorm(cin, EPS)
        self.conv1 = QConv2d(cin, cout, 3, stride=1, padding=1, bias=False)
        self.bn2 = BatchNorm(cout, EPS)
        self.prelu = PReLU(cout)
        self.conv2 = QConv2d(cout, cout, 3, stride=stride, padding=1, bias=False)
        self.bn3 = BatchNorm(cout, EPS)
        self.down = stride != 1 or cin != cout
        if self.down:
            self.downsample_conv = QConv2d(cin, cout, 1, stride=stride, bias=False)
            self.downsample_bn = BatchNorm(cout, EPS)

    def forward(self, x):
        sc = self.downsample_bn(self.downsample_conv(x)) if self.down else x
        y = self.conv2(self.prelu(self.bn2(self.conv1(self.bn1(x)))))
        return self.bn3(y) + sc


class IResNet(nn.Module):
    """(B, 112, 112, 3) RGB in [0, 1] -> (B, 512) unnormalised
    embedding, ``layers`` blocks a stage at the published widths."""

    def __init__(self, layers: Sequence[int] = (3, 13, 30, 3), embed_dim: int = 512):
        super().__init__()
        self.layers = tuple(layers)
        self.conv1 = QConv2d(3, WIDTHS[0], 3, stride=1, padding=1, bias=False)
        self.bn1 = BatchNorm(WIDTHS[0], EPS)
        self.prelu = PReLU(WIDTHS[0])
        cin = WIDTHS[0]
        for s, (n, width) in enumerate(zip(self.layers, WIDTHS)):
            for i in range(n):
                setattr(self, f"layer{s + 1}_{i}", Block(cin, width, 2 if i == 0 else 1))
                cin = width
        side = PX[0] // 2 ** len(WIDTHS)
        self.bn2 = BatchNorm(cin, EPS)
        self.fc = QLinear(cin * side * side, embed_dim, bias=True)
        self.features = BatchNorm(embed_dim, EPS)

    def forward(self, x01):
        x = ((x01 - 0.5) / 0.5).permute(0, 3, 1, 2)
        x = self.prelu(self.bn1(self.conv1(x)))
        for s, n in enumerate(self.layers):
            for i in range(n):
                x = getattr(self, f"layer{s + 1}_{i}")(x)
        x = self.bn2(x).flatten(1)
        return self.features(self.fc(x))


def build() -> nn.Module:
    return IResNet()


def init(net: nn.Module, generator: torch.Generator) -> None:
    """Seeded weights: every PReLU slope 0.25 (arcface_torch's init),
    then :func:`reference.nets.draw` at 112 x 112, then ``features``'
    weight back to 1 (``draw`` gives every BatchNorm a scale; arcface_torch
    fixes this one at 1)."""
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, PReLU):
                m.negative_slope.fill_(0.25)
    draw(net, generator, PX, SCALE, UNIT_BN_SCALE)
    with torch.no_grad():
        net.features.weight.fill_(1.0)
