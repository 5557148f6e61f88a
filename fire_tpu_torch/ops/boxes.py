"""Box math and mask-based NMS (counterpart of ``fire_tpu.ops.boxes``).

Fixed shapes throughout; NMS is batched over leading axes (the JAX
version is vmapped per frame).  Ties break the JAX way: the pre-NMS
top-k is a stable descending sort (``lax.top_k`` puts the lower index
first) and the per-round pick is ``argmax`` (first maximum).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG = -1e9


def xywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    return torch.cat([b[..., :2], b[..., :2] + b[..., 2:4]], dim=-1)


def xyxy_to_xywh(b: torch.Tensor) -> torch.Tensor:
    return torch.cat([b[..., :2], b[..., 2:4] - b[..., :2]], dim=-1)


def iou_matrix(a: torch.Tensor, b: torch.Tensor, plus_one: bool = False) -> torch.Tensor:
    """Pairwise IoU of xyxy boxes ``a`` (..., N, 4) × ``b`` (..., M, 4).
    ``plus_one`` counts a box's pixels inclusively (the legacy ``+1``
    area of the RetinaFace decode)."""
    off = 1.0 if plus_one else 0.0
    ax1, ay1, ax2, ay2 = (a[..., :, None, i] for i in range(4))
    bx1, by1, bx2, by2 = (b[..., None, :, i] for i in range(4))
    iw = torch.clamp(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1) + off, min=0.0)
    ih = torch.clamp(torch.minimum(ay2, by2) - torch.maximum(ay1, by1) + off, min=0.0)
    inter = iw * ih
    area_a = (ax2 - ax1 + off) * (ay2 - ay1 + off)
    area_b = (bx2 - bx1 + off) * (by2 - by1 + off)
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / torch.where(union > 0, union, 1.0),
                       torch.zeros_like(inter))


def iou_matrix_xywh(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of xywh boxes; degenerate boxes get IoU 0."""
    valid_a = (a[:, 2:3] > 0) & (a[:, 3:4] > 0)
    valid_b = (b[None, :, 2] > 0) & (b[None, :, 3] > 0)
    m = iou_matrix(xywh_to_xyxy(a), xywh_to_xyxy(b))
    return torch.where(valid_a & valid_b, m, torch.zeros_like(m))


def top_k_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` along the last axis: descending, lower index first
    among equal values (``torch.topk`` promises no order on ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def nms(
    boxes_xyxy: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    max_out: int,
    score_threshold: float = 0.0,
    plus_one: bool = False,
    suppress_equal: bool = False,
    pre_top_k: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS over a fixed candidate set, batched over leading axes.

    ``boxes_xyxy`` (..., N, 4), ``scores`` (..., N).  Strict ``>``
    suppression by default; ``plus_one`` and ``suppress_equal`` (``>=``)
    give RetinaFace's legacy rule.  ``pre_top_k`` restricts
    suppression to the highest-scoring candidates first (exact whenever
    no more than that many clear ``score_threshold``).
    Returns ``(keep_idx (..., max_out) int64, keep_mask (..., max_out))``;
    masked slots point at index 0.
    """
    n = boxes_xyxy.shape[-2]
    if pre_top_k and n > pre_top_k:
        top_scores, top_idx = top_k_stable(scores, pre_top_k)
        sub = torch.gather(boxes_xyxy, -2, top_idx[..., None].expand(*top_idx.shape, 4))
        keep_idx, keep_mask = nms(sub, top_scores, iou_threshold, max_out, score_threshold,
                                  plus_one, suppress_equal)
        return torch.gather(top_idx, -1, keep_idx), keep_mask

    ious = iou_matrix(boxes_xyxy, boxes_xyxy, plus_one=plus_one)
    live = torch.where(scores > score_threshold, scores, torch.full_like(scores, NEG))
    lead = scores.shape[:-1]
    keep_idx = torch.zeros((*lead, max_out), dtype=torch.int64, device=scores.device)
    keep_mask = torch.zeros((*lead, max_out), dtype=torch.bool, device=scores.device)
    n_kept = torch.zeros(lead, dtype=torch.int64, device=scores.device)
    ar = torch.arange(n, device=scores.device)
    slots = torch.arange(max_out, device=scores.device)
    for _ in range(max_out):
        best = torch.argmax(live, dim=-1)
        ok = torch.gather(live, -1, best[..., None])[..., 0] > NEG / 2
        at = ok[..., None] & (slots == n_kept[..., None])
        keep_idx = torch.where(at, best[..., None], keep_idx)
        keep_mask = keep_mask | at
        overl = torch.gather(ious, -2, best[..., None, None].expand(*lead, 1, n))[..., 0, :]
        over = overl >= iou_threshold if suppress_equal else overl > iou_threshold
        sup = over | (ar == best[..., None])
        live = torch.where(ok[..., None] & sup, torch.full_like(live, NEG), live)
        n_kept = n_kept + ok.long()
    return keep_idx, keep_mask


def weighted_blend(
    boxes_xyxy: torch.Tensor,
    scores: torch.Tensor,
    keep_idx: torch.Tensor,
    keep_mask: torch.Tensor,
    iou_threshold: float,
    score_threshold: float,
    payload: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """MediaPipe-style weighted overlap resolution after greedy NMS,
    batched over leading axes.

    Each kept box (``keep_idx`` (..., K) into ``boxes_xyxy`` (..., N, 4))
    becomes the score-weighted mean of every candidate with
    ``IoU >= iou_threshold`` against it and ``score > score_threshold``;
    the kept box itself always takes part.  ``payload`` (..., N, *rest)
    is blended with the same weights.  Masked slots keep their gathered
    values."""
    def take(x):
        idx = keep_idx.reshape(*keep_idx.shape, *([1] * (x.dim() - keep_idx.dim())))
        return torch.gather(x, keep_idx.dim() - 1, idx.expand(*keep_idx.shape, *x.shape[keep_idx.dim():]))

    kept = take(boxes_xyxy)  # (..., K, 4)
    ious = iou_matrix(kept, boxes_xyxy)  # (..., K, N)
    live = (ious >= iou_threshold) & (scores > score_threshold)[..., None, :]
    w = torch.where(live, scores[..., None, :], torch.zeros_like(ious))
    denom = torch.clamp(w.sum(-1, keepdim=True), min=1e-6)
    blended = torch.where(keep_mask[..., None], (w @ boxes_xyxy) / denom, kept)
    if payload is None:
        return blended, None
    lead = scores.dim()
    flat = payload.reshape(*payload.shape[:lead], -1)
    out = ((w @ flat) / denom).reshape(*keep_idx.shape, *payload.shape[lead:])
    mask = keep_mask.reshape(*keep_mask.shape, *([1] * (payload.dim() - lead)))
    return blended, torch.where(mask, out, take(payload))
