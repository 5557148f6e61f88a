"""Plain float32 forward passes of the three networks the cells run:
YuNet 2023mar, RetinaFace (ResNet-50 + FPN + SSH) and FaceNet-512
(Inception-ResNet-v1).

Frozen copies of the layer equations of the port's models, written as
plain ``torch.nn`` modules in inference form only (BatchNorm from its
running statistics), with module names equal to the trained files' Flax
paths so that :func:`reference.msgpack.state_dict` loads them key for
key.  Nothing here imports the program.

Every convolution and linear layer goes through :class:`QConv2d` /
:class:`QLinear`.  With ``quant`` left ``None`` they are the plain
layers; the control sets ``quant`` to a rounding function (float8 e4m3
with a per-tensor scale) that both the input and the weight pass
through, the way a lower-precision kernel would read them.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


class QConv2d(nn.Conv2d):
    quant: Quant = None

    def forward(self, x):
        q = self.quant
        if q is None:
            return super().forward(x)
        return self._conv_forward(q(x), q(self.weight), self.bias)


class QLinear(nn.Linear):
    quant: Quant = None

    def forward(self, x):
        q = self.quant
        if q is None:
            return super().forward(x)
        return F.linear(q(x), q(self.weight), self.bias)


def set_quant(module: nn.Module, quant: Quant) -> None:
    """Route every convolution and linear layer of ``module`` through
    ``quant`` (None: plain float32)."""
    for m in module.modules():
        if isinstance(m, (QConv2d, QLinear)):
            m.quant = quant


class BatchNorm(nn.Module):
    """Inference BatchNorm over dim 1 from the running statistics
    (FaceNet's has no scale: its file's converter sets the weight to 1)."""

    def __init__(self, features: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, self.eps)


def same_pad(x, kernel: int, stride: int, value: float = 0.0):
    """XLA ``SAME`` padding of NCHW ``x``: the odd pixel goes after."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value)


def up2(x):
    """Nearest 2x upsampling of NCHW ``x``."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


# ------------------------------------------------------------------ YuNet --

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


# ------------------------------------------------------------- RetinaFace --

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


# ---------------------------------------------------------------- FaceNet --

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


def build(kind: str) -> nn.Module:
    """The full-width network of ``kind`` (``yunet``, ``retinaface``,
    ``facenet512``)."""
    return {"yunet": YuNet, "retinaface": RetinaFace,
            "facenet512": lambda: FaceNet(512)}[kind]()
