"""Detection↔track assignment (counterpart of
``fire_tpu.track.assignment``: ``cost_matrix``, ``lap_assign`` with
``_solve_with_fast_path`` and the float32 Jonker-Volgenant
``_lap_solve``, ``greedy_assign``, and ``hungarian_assign``, the same
optimum solved on the host by the native Jonker-Volgenant LAP of
:mod:`fire_tpu_torch.runtime.native`, SciPy where it cannot be built).

JAX's ``lax.while_loop`` / ``lax.cond`` become Python control flow over
device tensors: the fast-path conflict test costs one host read per
frame, and a conflicted frame one read per Dijkstra step.  This is the
plain version; on the card the tracker runs kernel K2
(:mod:`fire_tpu_torch.track.scan`), which takes both branches inside.  The
arithmetic is the JAX version's, in float32, with ``argmin`` / ``argmax``
taking the first extremum as JAX does.
"""

from __future__ import annotations

import numpy as np
import torch

from fire_tpu_torch.ops.boxes import iou_matrix_xywh

BIG = 1e9
# Padding cost for masked rows/columns (see fire_tpu/track/assignment.py:80).
_PAD = 2.0**14


def cost_matrix(det_boxes: torch.Tensor, trk_boxes: torch.Tensor,
                max_distance: float = 200.0) -> torch.Tensor:
    """(D, T) cost = (1 − IoU) + centre_dist / max_distance."""
    iou = iou_matrix_xywh(det_boxes, trk_boxes)
    dc = det_boxes[:, :2] + det_boxes[:, 2:4] / 2.0
    tc = trk_boxes[:, :2] + trk_boxes[:, 2:4] / 2.0
    dist = torch.linalg.norm(dc[:, None, :] - tc[None, :, :], dim=-1)
    return (1.0 - iou) + dist / max_distance


def hungarian_assign(cost: np.ndarray, det_mask: np.ndarray, trk_mask: np.ndarray,
                     gate: float) -> np.ndarray:
    """Exact assignment on the host → ``match`` (T,) int32: detection
    index matched to each track, or −1.  Invalid rows and columns are
    masked with a large cost before solving and filtered after, so
    padding never changes the optimum over real pairs."""
    from fire_tpu_torch.runtime.native import linear_sum_assignment

    match = np.full((cost.shape[1],), -1, np.int32)
    if det_mask.sum() == 0 or trk_mask.sum() == 0:
        return match
    c = np.array(cost, np.float64)
    c[~det_mask, :] = BIG
    c[:, ~trk_mask] = BIG
    for r, cidx in zip(*linear_sum_assignment(c)):
        if det_mask[r] and trk_mask[cidx] and cost[r, cidx] <= gate:
            match[cidx] = r
    return match


def _lap_solve(c: torch.Tensor, row_valid: torch.Tensor) -> torch.Tensor:
    """Shortest-augmenting-path LAP: assign every valid row of ``c``
    (R, C), R ≤ C, to a distinct column.  Returns ``col4row`` (R,)
    int64, −1 for skipped rows."""
    r_cap, c_cap = c.shape
    assert r_cap <= c_cap, "internal: LAP expects R <= C (caller transposes)"
    dev = c.device
    inf = float("inf")
    u = torch.zeros(r_cap, dtype=torch.float32, device=dev)
    v = torch.zeros(c_cap, dtype=torch.float32, device=dev)
    col4row = torch.full((r_cap,), -1, dtype=torch.int64, device=dev)
    row4col = torch.full((c_cap,), -1, dtype=torch.int64, device=dev)
    rows = torch.arange(r_cap, device=dev)
    valid_rows = row_valid.tolist()
    for i in range(r_cap):
        if not valid_rows[i]:
            continue
        shortest = torch.full((c_cap,), inf, dtype=torch.float32, device=dev)
        path = torch.full((c_cap,), -1, dtype=torch.int64, device=dev)
        seen = torch.zeros(c_cap, dtype=torch.bool, device=dev)
        minval = torch.zeros((), dtype=torch.float32, device=dev)
        cur = i
        while True:  # Dijkstra over columns until a free column is reached
            red = minval + c[cur] - u[cur] - v
            upd = ~seen & (red < shortest)
            shortest = torch.where(upd, red, shortest)
            path = torch.where(upd, torch.full_like(path, cur), path)
            masked = torch.where(seen, torch.full_like(shortest, inf), shortest)
            j = int(torch.argmin(masked))
            minval = masked[j]
            seen[j] = True
            rj = int(row4col[j])
            if rj < 0:
                sink = j
                break
            cur = rj
        # dual update over the alternating tree
        u[i] += minval
        j_of = torch.clamp(col4row, 0, c_cap - 1)
        in_tree = (col4row >= 0) & seen[j_of] & (rows != i)
        u = u + torch.where(in_tree, minval - shortest[j_of], torch.zeros_like(u))
        v = v - torch.where(seen, minval - shortest, torch.zeros_like(v))
        # augment: walk predecessors from the free column back to row i
        path_h = path.tolist()
        col4row_h = col4row.tolist()
        j = sink
        while True:
            rr = path_h[j]
            row4col[j] = rr
            j_next = col4row_h[rr]
            col4row_h[rr] = j
            if rr == i:
                break
            j = j_next
        col4row = torch.tensor(col4row_h, dtype=torch.int64, device=dev)
    return col4row


def _solve_with_fast_path(c: torch.Tensor, row_valid: torch.Tensor) -> torch.Tensor:
    """Exact LAP; if every valid row's cheapest column is distinct, the
    row minima are the optimum and no loop runs (one host read)."""
    r_cap, c_cap = c.shape
    jmin = torch.argmin(c, dim=1)
    onehot = row_valid[:, None] & (jmin[:, None] == torch.arange(c_cap, device=c.device)[None, :])
    conflict = bool(torch.any(onehot.sum(dim=0) > 1))
    if conflict:
        return _lap_solve(c, row_valid)
    return torch.where(row_valid, jmin, torch.full_like(jmin, -1))


def lap_assign(cost: torch.Tensor, det_mask: torch.Tensor, trk_mask: torch.Tensor,
               gate: float) -> torch.Tensor:
    """Exact assignment → ``match`` (T,) int64: detection index matched
    to each track, or −1.  Masked rows are skipped; masked columns cost
    ``_PAD``; pairs above ``gate`` are dropped."""
    d, t = cost.shape
    cost = cost.float()
    pad = torch.full_like(cost, _PAD)
    if d <= t:
        c = torch.where(trk_mask[None, :], cost, pad)
        col4row = _solve_with_fast_path(c, det_mask)  # (d,) track per det
        j = torch.clamp(col4row, 0, t - 1)
        ok = (det_mask & (col4row >= 0) & trk_mask[j]
              & (cost[torch.arange(d, device=cost.device), j] <= gate))
        hit = ok[:, None] & (j[:, None] == torch.arange(t, device=cost.device)[None, :])
        return torch.where(hit.any(dim=0), torch.argmax(hit.to(torch.int8), dim=0),
                           torch.full((t,), -1, dtype=torch.int64, device=cost.device))
    c = torch.where(det_mask[None, :], cost.T, pad.T)
    col4row = _solve_with_fast_path(c, trk_mask)  # (t,) det per track
    j = torch.clamp(col4row, 0, d - 1)
    ok = (trk_mask & (col4row >= 0) & det_mask[j]
          & (cost[j, torch.arange(t, device=cost.device)] <= gate))
    return torch.where(ok, j, torch.full_like(j, -1))


def greedy_assign(cost: torch.Tensor, det_mask: torch.Tensor, trk_mask: torch.Tensor,
                  gate: float, max_pairs: int) -> torch.Tensor:
    """Greedy matching: repeatedly take the global minimum-cost valid
    pair under the gate.  Returns ``match`` (T,) int64."""
    d, t = cost.shape
    big = torch.full_like(cost, BIG)
    c = torch.where(det_mask[:, None] & trk_mask[None, :], cost, big)
    c = torch.where(c <= gate, c, big)
    match = torch.full((t,), -1, dtype=torch.int64, device=cost.device)
    tr = torch.arange(t, device=cost.device)
    dr = torch.arange(d, device=cost.device)
    for _ in range(max_pairs):
        flat = torch.argmin(c)
        di, ti = flat // t, flat % t
        ok = c[di, ti] < BIG / 2
        ti_hot = tr == ti
        di_hot = dr == di
        match = torch.where(ok & ti_hot, di, match)
        c = torch.where(ok & (di_hot[:, None] | ti_hot[None, :]), big, c)
    return match
