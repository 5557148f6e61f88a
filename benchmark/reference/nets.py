"""The layers the reference networks share, and where the networks are
found: each network is a file of its own, ``networks/<kind>.py``, that
:func:`network` finds by the kind a configuration names.

A network file states, as module attributes:

* ``ROLE``: ``"detector"`` or ``"encoder"``;
* ``CHANNELS`` and ``SCALE``, its input convention: the colour order it
  reads (``"bgr"``, the frames' own, or ``"rgb"``) and the divisor of
  the pixels (a detector reads the letterboxed frame / ``SCALE``, an
  encoder the crops of the frame / ``SCALE``);
* ``UNIT_BN_SCALE``: its BatchNorms have no scale in the weight files
  (:func:`reference.msgpack.state_dict`);
* ``build()``: the network at full width, a plain ``torch.nn`` module in
  inference form (BatchNorm from its running statistics) whose module
  names are the weight files' Flax paths;
* ``init(net, generator)``: seeded weights drawn into ``net`` in place;
* a detector also ``candidates(heads, input_hw)`` (its decode of the
  network's output to xyxy boxes and scores in input pixels) and
  ``NMS`` (the ``plus_one`` and ``suppress_equal`` conventions of its
  greedy NMS).

The networks are frozen copies of the layer equations of the port's
models.  Nothing here imports the program.

Every convolution and linear layer goes through :class:`QConv2d` /
:class:`QLinear`.  With ``quant`` left ``None`` they are the plain
layers; the control sets ``quant`` to a rounding function (float8 e4m3
with a per-tensor scale) that both the input and the weight pass
through, the way a lower-precision kernel would read them.
"""

from __future__ import annotations

import contextlib
import importlib
from types import ModuleType
from typing import Callable, Optional, Tuple

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
    (under a network's ``UNIT_BN_SCALE`` its file has no scale and the
    weight is 1)."""

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


@contextlib.contextmanager
def _exact():
    """Float32 convolutions and products without TF32, by an algorithm
    that cuDNN picks the same way every time."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    old = cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32, matmul.allow_tf32
    cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32, matmul.allow_tf32 = (
        True, False, False, False)
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32, matmul.allow_tf32 = old


def draw(net: nn.Module, generator: torch.Generator, sample_px: Tuple[int, int],
         scale: float, unit_bn_scale: bool) -> None:
    """Seeded weights for ``net``, in place, from ``generator`` (on the
    net's device), in one draw for each kind of leaf: every convolution
    and linear weight from N(0, 2 / fan-in), every bias from
    N(0, 1e-4), every BatchNorm's scale from U(0.75, 1.25) (1 under
    ``unit_bn_scale``) and its shift from N(0, 1e-2).  Then each
    BatchNorm's running mean and variance are set, layer after layer, to
    the mean and variance of what reaches it when two noise images of
    ``sample_px`` (uniform pixels in [0, 255], divided by ``scale``)
    pass through the net, so that every BatchNorm normalises its input
    and the activations stay in range at any depth.  That pass runs by
    :func:`_exact`: a seed gives the same weights in every run on one
    machine."""
    layers = [m for m in net.modules() if isinstance(m, (nn.Conv2d, nn.Linear))]
    bns = [m for m in net.modules() if isinstance(m, BatchNorm)]
    dev = generator.device

    def fill(leaves, sample, scale_of):
        flat = sample(sum(p.numel() for p in leaves))
        off = 0
        for p in leaves:
            p.copy_(flat[off : off + p.numel()].view_as(p) * scale_of(p))
            off += p.numel()

    def randn(n):
        return torch.randn(n, generator=generator, device=dev)

    def hook(bn, args):
        x = args[0]
        dims = [d for d in range(x.dim()) if d != 1]
        bn.running_mean.copy_(x.mean(dim=dims))
        bn.running_var.copy_(x.var(dim=dims, unbiased=False))

    with torch.no_grad():
        fill([m.weight for m in layers], randn, lambda p: (2.0 / p[0].numel()) ** 0.5)
        fill([m.bias for m in layers if m.bias is not None], randn, lambda p: 1e-2)
        if unit_bn_scale:
            for m in bns:
                m.weight.fill_(1.0)
        else:
            fill([m.weight for m in bns],
                 lambda n: 0.75 + 0.5 * torch.rand(n, generator=generator, device=dev),
                 lambda p: 1.0)
        fill([m.bias for m in bns], randn, lambda p: 0.1)
        x = torch.rand((2, *sample_px, 3), generator=generator, device=dev) * (255.0 / scale)
        handles = [m.register_forward_pre_hook(hook) for m in bns]
        try:
            with _exact():
                net(x)
        finally:
            for h in handles:
                h.remove()


def network(kind: str) -> ModuleType:
    """The network file of ``kind``: ``networks/<kind>.py``."""
    if not kind.isidentifier():
        raise ValueError(f"network kind {kind!r} is not a module name")
    return importlib.import_module(f"reference.networks.{kind}")


def build(kind: str) -> nn.Module:
    """The full-width network of ``kind``."""
    return network(kind).build()
