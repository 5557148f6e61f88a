"""Exact cosine top-k gallery matching, plain PyTorch (counterpart of
``fire_tpu.ops.gallery_match``).

:func:`cosine_topk` with ``k=1`` is the plain version of kernel K1
(:mod:`fire_tpu_torch.ops.cosine_top1`).  Ties break the JAX way —
``lax.top_k`` puts the lower index first — through a stable descending
sort.
"""

from __future__ import annotations

from typing import Tuple

import torch

from fire_tpu_torch.ops.boxes import top_k_stable

NEG = -2.0  # below any cosine similarity


def cosine_topk(queries: torch.Tensor, gallery: torch.Tensor, valid: torch.Tensor,
                k: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of bf16(q)·bf16(g) accumulated in float32; rows with
    ``valid`` False score ``NEG``.  Returns ``(sims (B,k), idx (B,k))``."""
    q = queries.to(torch.bfloat16).float()
    g = gallery.to(torch.bfloat16).float()
    sims = q @ g.T
    sims = torch.where(valid[None, :], sims, torch.full_like(sims, NEG))
    return top_k_stable(sims, k)


def cosine_topk_f32(queries: torch.Tensor, gallery: torch.Tensor, valid: torch.Tensor,
                    k: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-precision variant (strict matching)."""
    sims = queries.float() @ gallery.float().T
    sims = torch.where(valid[None, :], sims, torch.full_like(sims, NEG))
    return top_k_stable(sims, k)


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Row-normalise; zero rows stay zero."""
    n = torch.linalg.norm(x, dim=-1, keepdim=True)
    return torch.where(n > eps, x / torch.clamp(n, min=eps), torch.zeros_like(x))
