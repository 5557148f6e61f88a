"""Metric-learning losses for face embedding training (counterpart of
``fire_tpu.train.losses``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fire_tpu_torch.ops.gallery_match import l2_normalize


def arcface_logits(embeddings: torch.Tensor, weights: torch.Tensor, labels: torch.Tensor,
                   margin: float = 0.5, scale: float = 64.0) -> torch.Tensor:
    """Additive-angular-margin logits (ArcFace).

    ``embeddings`` (B, D) unnormalised, ``weights`` (D, C) class centres,
    ``labels`` (B,) int.  Returns (B, C) scaled logits with the margin on
    the target class: ``cos(arccos(clip(cos)) + m·onehot)·s``, no "easy
    margin".  The cosine product is float32 (JAX's ``HIGHEST``), with
    autocast off whatever the caller's compute dtype."""
    with torch.autocast(embeddings.device.type, enabled=False):
        emb = l2_normalize(embeddings.float())
        w = l2_normalize(weights.float().T).T  # normalise class columns
        cos = torch.clamp(emb @ w, -1.0 + 1e-7, 1.0 - 1e-7)
        theta = torch.arccos(cos)
        onehot = F.one_hot(labels.long(), weights.shape[1]).to(cos.dtype)
        return torch.cos(theta + margin * onehot) * scale


def triplet_loss(anchor: torch.Tensor, positive: torch.Tensor, negative: torch.Tensor,
                 margin: float = 0.2) -> torch.Tensor:
    """FaceNet's triplet loss on L2-normalised embeddings."""
    a, p, n = map(l2_normalize, (anchor, positive, negative))
    d_ap = torch.sum(torch.square(a - p), dim=-1)
    d_an = torch.sum(torch.square(a - n), dim=-1)
    return torch.mean(torch.clamp(d_ap - d_an + margin, min=0.0))
