"""FaceNet-512 (Inception-ResNet-v1, deepface ``Facenet512``): the
encoder, 160 x 160 RGB in [0, 1] to an unnormalised 512-d embedding."""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from reference.nets import BatchNorm, QConv2d, QLinear, draw

ROLE = "encoder"
CHANNELS, SCALE = "rgb", 255.0
UNIT_BN_SCALE = True


class ConvBn(nn.Module):
    def __init__(self, cin: int, f: int, k: Tuple[int, int], stride: int = 1,
                 same: bool = True, relu: bool = True):
        super().__init__()
        pad = ((k[0] - 1) // 2, (k[1] - 1) // 2) if same else (0, 0)
        self.conv = QConv2d(cin, f, k, stride=stride, padding=pad, bias=False)
        self.bn = BatchNorm(f, 1e-3)
        self.relu = relu

    def forward(self, x):
        x = self.bn(self.conv(x))
        return torch.relu(x) if self.relu else x


class Block(nn.Module):
    """Inception-ResNet residual block: branches of ConvBn chains,
    concatenated, a 1x1 ``up`` projection, ``x + scale * up``."""

    def __init__(self, cin: int, branches: Dict[str, Tuple[int, int, Tuple[int, int]]],
                 order: Sequence[Sequence[str]], scale: float, relu: bool = True):
        super().__init__()
        for name, (a, b, k) in branches.items():
            setattr(self, name, ConvBn(a, b, k))
        self.order = [list(o) for o in order]
        width = sum(branches[o[-1]][1] for o in order)
        self.up = QConv2d(width, cin, 1, bias=True)
        self.scale, self.relu = scale, relu

    def forward(self, x):
        outs = []
        for chain in self.order:
            y = x
            for name in chain:
                y = getattr(self, name)(y)
            outs.append(y)
        out = x + self.scale * self.up(torch.cat(outs, dim=1))
        return torch.relu(out) if self.relu else out


def block35(c: int, w: int) -> Block:
    return Block(c, {"b0": (c, w, (1, 1)), "b1_0": (c, w, (1, 1)), "b1_1": (w, w, (3, 3)),
                     "b2_0": (c, w, (1, 1)), "b2_1": (w, w, (3, 3)), "b2_2": (w, w, (3, 3))},
                 (("b0",), ("b1_0", "b1_1"), ("b2_0", "b2_1", "b2_2")), 0.17)


def block17(c: int, w: int) -> Block:
    return Block(c, {"b0": (c, w, (1, 1)), "b1_0": (c, w, (1, 1)), "b1_1": (w, w, (1, 7)),
                     "b1_2": (w, w, (7, 1))}, (("b0",), ("b1_0", "b1_1", "b1_2")), 0.10)


def block8(c: int, w: int, scale: float = 0.20, relu: bool = True) -> Block:
    return Block(c, {"b0": (c, w, (1, 1)), "b1_0": (c, w, (1, 1)), "b1_1": (w, w, (1, 3)),
                     "b1_2": (w, w, (3, 1))}, (("b0",), ("b1_0", "b1_1", "b1_2")), scale, relu)


class Reduction(nn.Module):
    """Strided branches (the last of each chain is a 3x3 VALID stride-2
    ConvBn) beside a 3x3 stride-2 max-pool, concatenated."""

    def __init__(self, chains):
        super().__init__()
        self.chains = [[n for n, *_ in chain] for chain in chains]
        for chain in chains:
            for i, (name, a, b, k) in enumerate(chain):
                last = i == len(chain) - 1
                setattr(self, name, ConvBn(a, b, k, 2 if last else 1, same=not last))

    def forward(self, x):
        outs = []
        for chain in self.chains:
            y = x
            for name in chain:
                y = getattr(self, name)(y)
            outs.append(y)
        return torch.cat(outs + [F.max_pool2d(x, 3, 2)], dim=1)


class FaceNet(nn.Module):
    """Inception-ResNet-v1: (B, 160, 160, 3) RGB in [0, 1] -> (B, D)
    unnormalised embedding."""

    def __init__(self, embed_dim: int = 512, depths: Sequence[int] = (5, 10, 5), sw: int = 32):
        super().__init__()
        self.depths = tuple(depths)
        self.stem0 = ConvBn(3, sw, (3, 3), 2, same=False)
        self.stem1 = ConvBn(sw, sw, (3, 3), 1, same=False)
        self.stem2 = ConvBn(sw, sw * 2, (3, 3))
        self.stem3 = ConvBn(sw * 2, int(sw * 2.5), (1, 1), 1, same=False)
        self.stem4 = ConvBn(int(sw * 2.5), sw * 6, (3, 3), 1, same=False)
        self.stem5 = ConvBn(sw * 6, sw * 8, (3, 3), 2, same=False)
        c = sw * 8
        for i in range(depths[0]):
            setattr(self, f"block35_{i}", block35(c, sw))
        w = sw * 8
        self.reduction_a = Reduction([[("b0", c, w * 3 // 2, (3, 3))],
                                      [("b1_0", c, w * 3 // 4, (1, 1)),
                                       ("b1_1", w * 3 // 4, w * 3 // 4, (3, 3)),
                                       ("b1_2", w * 3 // 4, w, (3, 3))]])
        c = w * 3 // 2 + w + c
        for i in range(depths[1]):
            setattr(self, f"block17_{i}", block17(c, sw * 4))
        self.reduction_b = Reduction([[("b0_0", c, w, (1, 1)), ("b0_1", w, w * 3 // 2, (3, 3))],
                                      [("b1_0", c, w, (1, 1)), ("b1_1", w, w, (3, 3))],
                                      [("b2_0", c, w, (1, 1)), ("b2_1", w, w, (3, 3)),
                                       ("b2_2", w, w, (3, 3))]])
        c = w * 3 // 2 + w + w + c
        for i in range(depths[2]):
            setattr(self, f"block8_{i}", block8(c, sw * 6))
        self.block8_final = block8(c, sw * 6, scale=1.0, relu=False)
        self.bottleneck = QLinear(c, embed_dim, bias=False)
        self.bottleneck_bn = BatchNorm(embed_dim, 1e-3)

    def forward(self, x01):
        x = x01.permute(0, 3, 1, 2)
        x = self.stem2(self.stem1(self.stem0(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.stem5(self.stem4(self.stem3(x)))
        for i in range(self.depths[0]):
            x = getattr(self, f"block35_{i}")(x)
        x = self.reduction_a(x)
        for i in range(self.depths[1]):
            x = getattr(self, f"block17_{i}")(x)
        x = self.reduction_b(x)
        for i in range(self.depths[2]):
            x = getattr(self, f"block8_{i}")(x)
        x = self.block8_final(x).mean(dim=(2, 3))
        return self.bottleneck_bn(self.bottleneck(x))


def build() -> nn.Module:
    return FaceNet(512)


def init(net: nn.Module, generator: torch.Generator) -> None:
    draw(net, generator, (160, 160), SCALE, UNIT_BN_SCALE)
