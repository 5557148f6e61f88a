"""Row-sharded gallery search over a mesh (counterpart of
``fire_tpu.parallel.sharded_gallery``).

The (N, D) matrix is split by rows over the ``dp`` axis, one shard per
mesh device.  Each shard computes an exact local top-k (bf16 operands,
float32 products and sums, as ``cosine_topk``), the (B, k) candidate sets
are gathered to the first device in shard order, and one more top-k
reduces them: B·k·n values cross devices instead of N·D.  Ties keep the
lower index at both levels (``top_k_stable``), so after the shard-major
gather a tie resolves to the lowest shard, which is the lowest global
row, as ``lax.top_k`` over the tiled ``all_gather`` does in JAX.

A sharded matrix is a list of per-shard tensors, each on its device.
"""

from __future__ import annotations

from typing import List, Tuple, Union

import torch

from fire_tpu_torch.ops.boxes import top_k_stable
from fire_tpu_torch.ops.gallery_match import cosine_topk
from fire_tpu_torch.parallel.mesh import Mesh

Sharded = List[torch.Tensor]


def shard_gallery(mesh: Mesh, gallery: torch.Tensor, axis: str = "dp") -> Sharded:
    """Split a gallery matrix (or row mask) by rows over ``axis``: shard
    i is a copy of rows ``[i·N/n, (i+1)·N/n)`` on the axis's i-th device."""
    devs = mesh.axis_devices(axis)
    n = len(devs)
    if gallery.shape[0] % n:
        raise ValueError(f"gallery rows {gallery.shape[0]} not divisible by {n} shards")
    rows_per = gallery.shape[0] // n
    return [gallery[i * rows_per : (i + 1) * rows_per].to(dev, copy=True)
            for i, dev in enumerate(devs)]


def sharded_cosine_topk(
    mesh: Mesh,
    queries: torch.Tensor,
    gallery: Union[torch.Tensor, Sharded],
    valid: Union[torch.Tensor, int],
    k: int = 1,
    axis: str = "dp",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact global cosine top-k with the gallery sharded by rows.

    ``queries`` (B, D) normalised; ``gallery`` (N, D) normalised, as one
    tensor (sharded here) or as :func:`shard_gallery`'s shards; ``valid``
    an (N,) bool row mask, or a row count (each shard then derives its
    mask from its index, so enrolment only changes one number).
    Returns ``(sims (B, k), global row idx (B, k))`` on the first shard's
    device."""
    shards = gallery if isinstance(gallery, list) else shard_gallery(mesh, gallery, axis)
    n_shards = mesh.shape[axis]
    if len(shards) != n_shards:
        raise ValueError(f"{len(shards)} shards for a {n_shards}-way '{axis}' axis")
    rows_per = shards[0].shape[0]
    count_form = not isinstance(valid, torch.Tensor) or valid.ndim == 0
    if not count_form:
        masks = shard_gallery(mesh, valid, axis)
    kk = min(k, rows_per)
    sims, idx = [], []
    for s, g in enumerate(shards):
        if count_form:
            mask = torch.arange(rows_per, device=g.device) + s * rows_per < int(valid)
        else:
            mask = masks[s]
        l_sims, l_idx = cosine_topk(queries.to(g.device), g, mask, kk)
        sims.append(l_sims)
        idx.append(l_idx + s * rows_per)
    home = shards[0].device
    all_sims = torch.cat([t.to(home) for t in sims], dim=1)
    all_idx = torch.cat([t.to(home) for t in idx], dim=1)
    top_sims, pos = top_k_stable(all_sims, k)
    return top_sims, torch.gather(all_idx, 1, pos)


def update_sharded_rows(gal_sharded: Sharded, block: torch.Tensor, start: int) -> Sharded:
    """Write ``block`` into the row-sharded gallery at row ``start`` in
    place: each shard the block touches gets its part, straight from the
    block's device, so a block that straddles two shards writes both.  The
    start is clamped so the block fits, as ``lax.dynamic_update_slice``
    clamps it."""
    rows_per = gal_sharded[0].shape[0]
    n_rows, bk = rows_per * len(gal_sharded), block.shape[0]
    start = max(0, min(int(start), n_rows - bk))
    for s, shard in enumerate(gal_sharded):
        lo, hi = max(start, s * rows_per), min(start + bk, (s + 1) * rows_per)
        if lo < hi:
            shard[lo - s * rows_per : hi - s * rows_per] = (
                block[lo - start : hi - start].to(shard.device, shard.dtype))
    return gal_sharded
