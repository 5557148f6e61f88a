"""Metric-learning losses for face embedding training (counterpart of
``fire_tpu.train.losses``)."""

from __future__ import annotations

from typing import Sequence

import torch

from fire_tpu_torch.ops.gallery_match import l2_normalize
from fire_tpu_torch.parallel.mesh import sum_to


def arcface_logits(embeddings: torch.Tensor, weights: torch.Tensor, labels: torch.Tensor,
                   margin: float = 0.5, scale: float = 64.0,
                   column_offset: int = 0) -> torch.Tensor:
    """Additive-angular-margin logits (ArcFace).

    ``embeddings`` (B, D) unnormalised, ``weights`` (D, C) class centres,
    ``labels`` (B,) int.  Returns (B, C) scaled logits with the margin on
    the target class: ``cos(arccos(clip(cos)) + m·onehot)·s``, no "easy
    margin".  The cosine product is float32 (JAX's ``HIGHEST``), with
    autocast off whatever the caller's compute dtype.

    ``weights`` may be one column block of a larger classifier, whose
    first column is class ``column_offset``: the margin then lands only
    on rows whose label falls in the block."""
    with torch.autocast(embeddings.device.type, enabled=False):
        emb = l2_normalize(embeddings.float())
        w = l2_normalize(weights.float().T).T  # normalise class columns
        cos = torch.clamp(emb @ w, -1.0 + 1e-7, 1.0 - 1e-7)
        theta = torch.arccos(cos)
        classes = torch.arange(column_offset, column_offset + weights.shape[1],
                               device=labels.device)
        onehot = (labels.long()[:, None] == classes).to(cos.dtype)
        return torch.cos(theta + margin * onehot) * scale


def column_sharded_cross_entropy(logits: Sequence[torch.Tensor], labels: torch.Tensor,
                                 column_offsets: Sequence[int],
                                 denominator: int) -> torch.Tensor:
    """Softmax cross-entropy of rows whose logits are split by columns:
    block j (on its own device) holds classes ``column_offsets[j]`` on.
    Returns the sum over the rows divided by ``denominator`` (the global
    batch, so that the ``dp`` shards' results add up to the mean), on
    the first block's device.

    Optax's formula over the blocks: the row max over every block (held
    constant) is subtracted, each block gives its ``Σ exp(l − max)``, the
    sums are added into the log-sum-exp, and the target logit comes from
    the one block that holds the label."""
    home = logits[0].device
    row_max = torch.stack([l.detach().amax(1).to(home) for l in logits]).amax(0)
    exp_sum, target = [], []
    for block, off in zip(logits, column_offsets):
        m = row_max.to(block.device)
        exp_sum.append(torch.exp(block - m[:, None]).sum(1))
        local = labels.to(block.device).long() - off
        held = (local >= 0) & (local < block.shape[1])
        picked = block.gather(1, local.clamp(0, block.shape[1] - 1)[:, None])[:, 0]
        target.append(torch.where(held, picked - m, torch.zeros_like(picked)))
    per_row = torch.log(sum_to(exp_sum, home)) - sum_to(target, home)
    return per_row.sum() / denominator


def triplet_loss(anchor: torch.Tensor, positive: torch.Tensor, negative: torch.Tensor,
                 margin: float = 0.2) -> torch.Tensor:
    """FaceNet's triplet loss on L2-normalised embeddings."""
    a, p, n = map(l2_normalize, (anchor, positive, negative))
    d_ap = torch.sum(torch.square(a - p), dim=-1)
    d_an = torch.sum(torch.square(a - n), dim=-1)
    return torch.mean(torch.clamp(d_ap - d_an + margin, min=0.0))
