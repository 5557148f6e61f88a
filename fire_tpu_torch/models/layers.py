"""Layers shared by the port's networks."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm(nn.Module):
    """Inference BatchNorm over dim 1, computed in float32 and cast back
    to the input dtype — what ``flax.linen.BatchNorm(dtype=bf16)``
    does (its normalisation promotes to the f32 statistics).  All four
    tensors are buffers: the port runs inference only.  ``use_scale=
    False`` (FaceNet) keeps ``weight`` at 1."""

    def __init__(self, features: int, eps: float):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def _apply(self, fn, recurse=True):
        # statistics stay float32 when the module is cast to bf16
        super()._apply(fn, recurse)
        for name in ("weight", "bias", "running_mean", "running_var"):
            setattr(self, name, getattr(self, name).float())
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.batch_norm(
            x.float(), self.running_mean, self.running_var, self.weight,
            self.bias, False, 0.0, self.eps,
        )
        return y.to(x.dtype)


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
