"""FaceNet embedding network — Inception-ResNet-v1 (counterpart of
``fire_tpu.models.facenet``).

Module names equal the Flax model's, so the committed Flax weights load
key for key (:func:`fire_tpu_torch.weights.from_flax_facenet`).  Input
is NHWC float ``[0, 1]``, 160×160×3; output the unnormalised float32
bottleneck embedding.

Padding: Flax "SAME" at stride 1 with odd kernels — (3,3), (1,7),
(7,1), (1,3), (3,1) — is symmetric, ``(k-1)//2`` per side.  Flax
"VALID" max-pool is torch's floor mode.  BatchNorm has no scale
(weight 1), eps 1e-3 and momentum 0.995.  ``forward(x, train=False)``
serves with the running statistics; ``train=True`` (the trainer's)
normalises with the batch's and updates them, as Flax's
``__call__(x, train)`` does.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fire_tpu_torch.models.layers import BatchNorm, max_pool_valid


class ConvBn(nn.Module):
    """Conv(no bias) → BatchNorm(no scale, eps 1e-3) → optional ReLU."""

    def __init__(self, cin: int, features: int, kernel: Tuple[int, int],
                 strides: int = 1, padding: str = "SAME", relu: bool = True):
        super().__init__()
        if padding == "SAME":
            if strides != 1:
                raise ValueError("SAME padding is only used at stride 1 here")
            pad = ((kernel[0] - 1) // 2, (kernel[1] - 1) // 2)
        else:
            pad = (0, 0)
        self.conv = nn.Conv2d(cin, features, kernel, stride=strides, padding=pad, bias=False)
        self.bn = BatchNorm(features, 1e-3, momentum=0.995, use_scale=False)
        self.relu = relu

    def forward(self, x, train: bool = False):
        x = self.bn(self.conv(x), train)
        return torch.relu(x) if self.relu else x


class Block35(nn.Module):
    """Inception-ResNet-A residual block (scale 0.17)."""

    def __init__(self, cin: int, width: int, scale: float = 0.17):
        super().__init__()
        w = width
        self.scale = scale
        self.b0 = ConvBn(cin, w, (1, 1))
        self.b1_0 = ConvBn(cin, w, (1, 1))
        self.b1_1 = ConvBn(w, w, (3, 3))
        self.b2_0 = ConvBn(cin, w, (1, 1))
        self.b2_1 = ConvBn(w, w, (3, 3))
        self.b2_2 = ConvBn(w, w, (3, 3))
        self.up = nn.Conv2d(3 * w, cin, 1, bias=True)

    def forward(self, x, train: bool = False):
        b0 = self.b0(x, train)
        b1 = self.b1_1(self.b1_0(x, train), train)
        b2 = self.b2_2(self.b2_1(self.b2_0(x, train), train), train)
        up = self.up(torch.cat([b0, b1, b2], dim=1))
        return torch.relu(x + self.scale * up)


class Block17(nn.Module):
    """Inception-ResNet-B residual block (scale 0.10)."""

    def __init__(self, cin: int, width: int, scale: float = 0.10):
        super().__init__()
        w = width
        self.scale = scale
        self.b0 = ConvBn(cin, w, (1, 1))
        self.b1_0 = ConvBn(cin, w, (1, 1))
        self.b1_1 = ConvBn(w, w, (1, 7))
        self.b1_2 = ConvBn(w, w, (7, 1))
        self.up = nn.Conv2d(2 * w, cin, 1, bias=True)

    def forward(self, x, train: bool = False):
        b0 = self.b0(x, train)
        b1 = self.b1_2(self.b1_1(self.b1_0(x, train), train), train)
        up = self.up(torch.cat([b0, b1], dim=1))
        return torch.relu(x + self.scale * up)


class Block8(nn.Module):
    """Inception-ResNet-C residual block (scale 0.20; the final copy is
    scale 1.0 with no activation)."""

    def __init__(self, cin: int, width: int, scale: float = 0.20, relu: bool = True):
        super().__init__()
        w = width
        self.scale = scale
        self.relu = relu
        self.b0 = ConvBn(cin, w, (1, 1))
        self.b1_0 = ConvBn(cin, w, (1, 1))
        self.b1_1 = ConvBn(w, w, (1, 3))
        self.b1_2 = ConvBn(w, w, (3, 1))
        self.up = nn.Conv2d(2 * w, cin, 1, bias=True)

    def forward(self, x, train: bool = False):
        b0 = self.b0(x, train)
        b1 = self.b1_2(self.b1_1(self.b1_0(x, train), train), train)
        up = self.up(torch.cat([b0, b1], dim=1))
        out = x + self.scale * up
        return torch.relu(out) if self.relu else out


class ReductionA(nn.Module):
    def __init__(self, cin: int, width: int):
        super().__init__()
        w = width
        self.b0 = ConvBn(cin, w * 3 // 2, (3, 3), 2, "VALID")
        self.b1_0 = ConvBn(cin, w * 3 // 4, (1, 1))
        self.b1_1 = ConvBn(w * 3 // 4, w * 3 // 4, (3, 3))
        self.b1_2 = ConvBn(w * 3 // 4, w, (3, 3), 2, "VALID")
        self.cout = w * 3 // 2 + w + cin

    def forward(self, x, train: bool = False):
        b0 = self.b0(x, train)
        b1 = self.b1_2(self.b1_1(self.b1_0(x, train), train), train)
        b2 = max_pool_valid(x, 3, 2)
        return torch.cat([b0, b1, b2], dim=1)


class ReductionB(nn.Module):
    def __init__(self, cin: int, width: int):
        super().__init__()
        w = width
        self.b0_0 = ConvBn(cin, w, (1, 1))
        self.b0_1 = ConvBn(w, w * 3 // 2, (3, 3), 2, "VALID")
        self.b1_0 = ConvBn(cin, w, (1, 1))
        self.b1_1 = ConvBn(w, w, (3, 3), 2, "VALID")
        self.b2_0 = ConvBn(cin, w, (1, 1))
        self.b2_1 = ConvBn(w, w, (3, 3))
        self.b2_2 = ConvBn(w, w, (3, 3), 2, "VALID")
        self.cout = w * 3 // 2 + w + w + cin

    def forward(self, x, train: bool = False):
        b0 = self.b0_1(self.b0_0(x, train), train)
        b1 = self.b1_1(self.b1_0(x, train), train)
        b2 = self.b2_2(self.b2_1(self.b2_0(x, train), train), train)
        b3 = max_pool_valid(x, 3, 2)
        return torch.cat([b0, b1, b2, b3], dim=1)


class FaceNet(nn.Module):
    """Inception-ResNet-v1 producing an ``embed_dim`` bottleneck.
    ``dropout_rate`` drops the pooled features before the bottleneck in
    ``train`` mode only (0 by default, as in JAX)."""

    def __init__(self, embed_dim: int = 128, depths: Sequence[int] = (5, 10, 5),
                 stem_width: int = 32, dropout_rate: float = 0.0):
        super().__init__()
        sw = stem_width
        self.embed_dim = embed_dim
        self.depths = tuple(depths)
        self.dropout_rate = dropout_rate
        self.stem0 = ConvBn(3, sw, (3, 3), 2, "VALID")
        self.stem1 = ConvBn(sw, sw, (3, 3), 1, "VALID")
        self.stem2 = ConvBn(sw, sw * 2, (3, 3))
        self.stem3 = ConvBn(sw * 2, int(sw * 2.5), (1, 1), 1, "VALID")
        self.stem4 = ConvBn(int(sw * 2.5), sw * 6, (3, 3), 1, "VALID")
        self.stem5 = ConvBn(sw * 6, sw * 8, (3, 3), 2, "VALID")
        c = sw * 8
        for i in range(depths[0]):
            self.add_module(f"block35_{i}", Block35(c, sw))
        self.reduction_a = ReductionA(c, sw * 8)
        c = self.reduction_a.cout
        for i in range(depths[1]):
            self.add_module(f"block17_{i}", Block17(c, sw * 4))
        self.reduction_b = ReductionB(c, sw * 8)
        c = self.reduction_b.cout
        for i in range(depths[2]):
            self.add_module(f"block8_{i}", Block8(c, sw * 6))
        self.block8_final = Block8(c, sw * 6, scale=1.0, relu=False)
        self.bottleneck = nn.Linear(c, embed_dim, bias=False)
        self.bottleneck_bn = BatchNorm(embed_dim, 1e-3, momentum=0.995, use_scale=False)

    @property
    def dtype(self) -> torch.dtype:
        return self.stem0.conv.weight.dtype

    def forward(self, x01_nhwc: torch.Tensor, train: bool = False) -> torch.Tensor:
        """x: (B, H, W, 3) float in [0, 1] → (B, embed_dim) float32."""
        x = x01_nhwc.to(self.dtype).permute(0, 3, 1, 2)
        x = self.stem2(self.stem1(self.stem0(x, train), train), train)
        x = max_pool_valid(x, 3, 2)
        x = self.stem5(self.stem4(self.stem3(x, train), train), train)
        for i in range(self.depths[0]):
            x = getattr(self, f"block35_{i}")(x, train)
        x = self.reduction_a(x, train)
        for i in range(self.depths[1]):
            x = getattr(self, f"block17_{i}")(x, train)
        x = self.reduction_b(x, train)
        for i in range(self.depths[2]):
            x = getattr(self, f"block8_{i}")(x, train)
        x = self.block8_final(x, train)
        x = x.mean(dim=(2, 3))
        if train and self.dropout_rate > 0.0:
            x = F.dropout(x, self.dropout_rate)
        x = self.bottleneck_bn(self.bottleneck(x), train)
        return x.float()


def facenet_layer_order(depths: Sequence[int] = (5, 10, 5)):
    """Parameterised layers in execution order, as
    ``fire_tpu.models.facenet.facenet_layer_order`` lists them."""
    order = [("convbn", (f"stem{i}",)) for i in range(6)]

    def block(name, branches):
        for sub in branches:
            order.append(("convbn", (name, sub)))
        order.append(("conv", (name, "up")))

    for i in range(depths[0]):
        block(f"block35_{i}", ["b0", "b1_0", "b1_1", "b2_0", "b2_1", "b2_2"])
    for sub in ("b0", "b1_0", "b1_1", "b1_2"):
        order.append(("convbn", ("reduction_a", sub)))
    for i in range(depths[1]):
        block(f"block17_{i}", ["b0", "b1_0", "b1_1", "b1_2"])
    for sub in ("b0_0", "b0_1", "b1_0", "b1_1", "b2_0", "b2_1", "b2_2"):
        order.append(("convbn", ("reduction_b", sub)))
    for i in range(depths[2]):
        block(f"block8_{i}", ["b0", "b1_0", "b1_1", "b1_2"])
    block("block8_final", ["b0", "b1_0", "b1_1", "b1_2"])
    order.append(("dense", ("bottleneck",)))
    order.append(("bn", ("bottleneck_bn",)))
    return order


def facenet_128() -> FaceNet:
    """FaceNet-128d (``fire_tpu.models.facenet.facenet_128``)."""
    return FaceNet(embed_dim=128)


def facenet_512() -> FaceNet:
    """FaceNet-512d (``fire_tpu.models.facenet.facenet_512``)."""
    return FaceNet(embed_dim=512)


def tiny_facenet(embed_dim: int = 128) -> FaceNet:
    """Reduced depth/width variant with the same layer types."""
    return FaceNet(embed_dim=embed_dim, depths=(1, 1, 1), stem_width=8)
