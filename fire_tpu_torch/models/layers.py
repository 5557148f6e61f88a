"""Layers shared by the port's networks."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from fire_tpu_torch.ops import bn_act
from fire_tpu_torch.parallel.mesh import sum_to
from fire_tpu_torch.parallel.shards import ShardList


class BatchNorm(nn.Module):
    """BatchNorm over dim 1 as ``flax.linen.BatchNorm(dtype=bf16)`` does
    it: normalised in float32 and cast back to the input dtype.

    ``forward(x, train=False)`` takes the mode as an argument, as Flax's
    ``__call__(x, train=False)`` does, and never reads
    ``nn.Module.training``: a module built and called without
    ``.eval()`` serves with its running statistics.  ``train=True``
    normalises with the batch's statistics over (N, H, W): the mean and
    Flax's fast variance ``max(E[x²] − E[x]², 0)``, biased, in float32.
    It then updates the running statistics in place as Flax does,
    ``ra = m·ra + (1 − m)·batch`` with ``momentum`` m (the weight of the
    old value; ``torch.nn.BatchNorm2d``'s momentum is ``1 − m``), and
    stores that same biased variance.

    Given a :class:`~fire_tpu_torch.parallel.shards.ShardList` (a batch
    split over the ``dp`` shards of a mesh, the sharded ArcFace step)
    the statistics are those of the whole batch, as JAX's SPMD step
    takes them: the shards' float32 sums, sums of squares and counts
    are added up before the mean and variance are formed, on the
    module's device, and the running statistics are updated once.

    ``relu`` and ``residual`` finish the layer as the networks do after
    it: ``y + residual`` (same shape and dtype as ``x``), then ReLU;
    ``slope`` (a :class:`PReLU`'s float32 ``negative_slope``, one a
    channel), with neither, ends it in that PReLU instead.  The route is chosen by mode
    and dtype alone.  In eval mode on the card a
    bf16 call that wants no gradient runs all of it as kernel K3
    (:mod:`fire_tpu_torch.ops.bn_act`), Flax's formula in one pass, which
    raises on a layout it does not take (channels-last 4-D or rows × C).
    The train path, a call that wants a gradient, a ``ShardList``, the
    CPU and float32 compute run it as below, op by op.

    ``weight`` and ``bias`` are the trainable ``scale`` and ``bias``;
    with ``use_scale=False`` (FaceNet) ``weight`` is a buffer fixed at
    1.  ``running_mean`` / ``running_var`` are buffers.  All four stay
    float32 when the module is cast to bf16."""

    def __init__(self, features: int, eps: float, momentum: float = 0.99,
                 use_scale: bool = True):
        super().__init__()
        self.eps, self.momentum, self.use_scale = eps, momentum, use_scale
        if use_scale:
            self.weight = nn.Parameter(torch.ones(features))
        else:
            self.register_buffer("weight", torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def _apply(self, fn, recurse=True):
        super()._apply(fn, recurse)
        for name in ("weight", "bias", "running_mean", "running_var"):
            t = getattr(self, name)
            if isinstance(t, nn.Parameter):
                t.data = t.data.float()
            else:
                setattr(self, name, t.float())
        return self

    def forward(self, x: torch.Tensor, train: bool = False, relu: bool = False,
                residual: Optional[torch.Tensor] = None,
                slope: Optional[torch.Tensor] = None) -> torch.Tensor:
        if isinstance(x, ShardList):
            return _finish(self._forward_shards(x, train), relu, residual, slope)
        params = (self.running_mean, self.running_var, self.weight, self.bias)
        if (not train and x.device.type == "cuda" and x.dtype == torch.bfloat16
                and not (torch.is_grad_enabled() and any(
                    t is not None and t.requires_grad for t in (x, residual, slope, *params)))):
            return bn_act.bn_act(x, *params, self.eps, residual, relu, slope)
        return _finish(self._forward(x, train), relu, residual, slope)

    def _forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        xf = x.float()
        if not train:
            y = F.batch_norm(xf, self.running_mean, self.running_var, self.weight,
                             self.bias, False, 0.0, self.eps)
            return y.to(x.dtype)
        dims = [0] + list(range(2, x.dim()))
        mean = xf.mean(dims)
        var = torch.clamp((xf * xf).mean(dims) - mean * mean, min=0.0)
        self._update_running(mean, var)
        shape = [1, -1] + [1] * (x.dim() - 2)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)
        return y.to(x.dtype)

    @torch.no_grad()
    def _update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        m = self.momentum
        self.running_mean.mul_(m).add_(mean.detach(), alpha=1.0 - m)
        self.running_var.mul_(m).add_(var.detach(), alpha=1.0 - m)

    def _forward_shards(self, x: ShardList, train: bool) -> ShardList:
        """The layer over a batch split into shards: in train mode the
        statistics of the whole batch, reduced on this module's device
        and copied back to each shard's."""
        xs = [s.float() for s in x.shards]
        dims = [0] + list(range(2, xs[0].dim()))
        if train:
            count = sum(s.numel() // s.shape[1] for s in xs)
            moments = sum_to([torch.stack([s.sum(dims), (s * s).sum(dims)]) for s in xs],
                             self.running_mean.device) / count
            mean = moments[0]
            var = torch.clamp(moments[1] - mean * mean, min=0.0)
            self._update_running(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        shape = [1, -1] + [1] * (xs[0].dim() - 2)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ShardList([
            ((xf - mean.to(s.device).reshape(shape)) * mul.to(s.device).reshape(shape)
             + self.bias.to(s.device).reshape(shape)).to(s.dtype)
            for xf, s in zip(xs, x.shards)])


def _finish(y, relu: bool, residual, slope=None):
    """``y + residual``, then ReLU, or the PReLU of ``slope``, where
    asked: the plain route's end of the layer."""
    bn_act.check_end(relu, residual, slope)
    if slope is not None:
        return bn_act.prelu(y, slope)
    if residual is not None:
        y = y + residual
    return torch.relu(y) if relu else y


class PReLU(nn.Module):
    """PReLU over dim 1 with one learnt slope a channel,
    ``negative_slope`` (its name in the weight files), kept in float32
    when the module is cast, as :class:`BatchNorm`'s parameters are.
    A network passes it to the :class:`BatchNorm` before it
    (``bn(x, slope=prelu.negative_slope)``), which ends in it on either
    route; called alone it is :func:`~fire_tpu_torch.ops.bn_act.prelu`."""

    def __init__(self, features: int, init: float = 0.25):
        super().__init__()
        self.negative_slope = nn.Parameter(torch.full((features,), float(init)))

    def _apply(self, fn, recurse=True):
        super()._apply(fn, recurse)
        self.negative_slope.data = self.negative_slope.data.float()
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return bn_act.prelu(x, self.negative_slope)


def same_pad(x: torch.Tensor, kernel: int, stride: int, value: float = 0.0) -> torch.Tensor:
    """Pad NCHW ``x`` the way XLA's ``SAME`` does: the total a
    ``ceil(n / stride)`` output needs, the odd pixel going after (so a
    stride-2 layer on an even side pads less before than after)."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):  # F.pad takes the last axis first
        total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value)


def max_pool_same(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """Flax ``max_pool(padding="SAME")``: the pad is ``-inf``, not zero."""
    return F.max_pool2d(same_pad(x, k, s, value=float("-inf")), k, s)


def max_pool_valid(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """Flax ``max_pool(padding="VALID")`` = torch floor mode, no pad."""
    return F.max_pool2d(x, k, s)
