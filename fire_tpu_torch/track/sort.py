"""Fixed-capacity SORT tracker on device (counterpart of
``fire_tpu.track.sort``: ``TrackTable``, ``make_table``,
``predict_tracks``, ``apply_assignment``, ``sort_step`` and the host
class ``Sort``).

The track table is a structure of arrays with an ``active`` mask; one
frame step is predict (batched KF) → associate (exact LAP) →
update / spawn / prune / emit, with the JAX version's one-hot spawn
pairing and clamps, so ids, masks and provenance match it exactly.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from fire_tpu_torch.config import TrackerConfig
from fire_tpu_torch.device import DeviceLike, resolve_device
from fire_tpu_torch.pipeline.timing import span
from fire_tpu_torch.runtime.graphs import GraphCache, HostStaging, indexed, replay
from fire_tpu_torch.track import assignment as assign
from fire_tpu_torch.track.ukf import kf_predict, kf_update_tracker, tracker_f_matrix


class TrackTable(NamedTuple):
    """SoA track state (T = cfg.max_tracks)."""

    x: torch.Tensor        # (T, 10) KF mean
    p: torch.Tensor        # (T, 10, 10) KF covariance
    tid: torch.Tensor      # (T,) int32 track ids
    age: torch.Tensor      # (T,) int32
    tsu: torch.Tensor      # (T,) int32 time since update
    hits: torch.Tensor     # (T,) int32
    streak: torch.Tensor   # (T,) int32 hit streak
    active: torch.Tensor   # (T,) bool
    next_id: torch.Tensor  # () int32


class TrackOutputs(NamedTuple):
    """Padded per-frame confirmed tracks."""

    tid: torch.Tensor      # (T,) int32
    boxes: torch.Tensor    # (T, 4) int32 xywh (truncated like int())
    age: torch.Tensor      # (T,) int32
    mask: torch.Tensor     # (T,) bool — confirmed & active
    src_det: torch.Tensor  # (T,) int32 — detection that fed the track, else -1


def make_table(cfg: TrackerConfig, device=None) -> TrackTable:
    t = cfg.max_tracks
    i32 = dict(dtype=torch.int32, device=device)
    return TrackTable(
        x=torch.zeros((t, 10), dtype=torch.float32, device=device),
        p=torch.eye(10, dtype=torch.float32, device=device).repeat(t, 1, 1),
        tid=torch.zeros(t, **i32),
        age=torch.zeros(t, **i32),
        tsu=torch.zeros(t, **i32),
        hits=torch.zeros(t, **i32),
        streak=torch.zeros(t, **i32),
        active=torch.zeros(t, dtype=torch.bool, device=device),
        next_id=torch.zeros((), **i32),
    )


@functools.lru_cache(maxsize=16)
def _q_matrix(cfg: TrackerConfig, device=None) -> torch.Tensor:
    """The process noise on ``device``, made once: a captured graph
    cannot copy from host memory."""
    return torch.diag(torch.tensor(
        [cfg.q_pos, cfg.q_pos, cfg.q_acc, cfg.q_acc, cfg.q_vel, cfg.q_vel,
         cfg.q_acc, cfg.q_acc, cfg.q_acc, cfg.q_acc],
        dtype=torch.float32, device=device))


@functools.lru_cache(maxsize=16)
def _f_matrix(device=None) -> torch.Tensor:
    """The transition on ``device``, made once: a captured graph cannot
    copy from host memory, and its element writes copy host scalars."""
    return tracker_f_matrix(device=device)


def _clamp_state(x: torch.Tensor, cfg: TrackerConfig) -> torch.Tensor:
    v = torch.clamp(x[..., 4:7], -cfg.max_velocity, cfg.max_velocity)
    a = torch.clamp(x[..., 7:10], -cfg.max_acceleration, cfg.max_acceleration)
    return torch.cat([x[..., :4], v, a], dim=-1)


def _bbox_to_z(box: torch.Tensor, cfg: TrackerConfig) -> torch.Tensor:
    """[x,y,w,h] → [cx, cy, log_s, log_r] with the reference's guards."""
    x, y, w, h = box[..., 0], box[..., 1], box[..., 2], box[..., 3]
    s = w * h
    one = torch.ones_like(h)
    r = torch.where(h != 0, w / torch.where(h != 0, h, one), one)
    log_s = torch.where(s > 0, torch.log(torch.clamp(s, min=1e-20)),
                        torch.full_like(s, cfg.min_log_area))
    log_r = torch.where(r > 0, torch.log(torch.clamp(r, min=1e-20)),
                        torch.full_like(r, cfg.min_log_aspect))
    return torch.stack([x + w / 2.0, y + h / 2.0, log_s, log_r], dim=-1)


def _state_to_box(x: torch.Tensor, cfg: TrackerConfig) -> torch.Tensor:
    """State → int-truncated [x,y,w,h] (float holding integer values)."""
    cx, cy = x[..., 0], x[..., 1]
    log_s = torch.clamp(x[..., 2], min=cfg.min_log_area)
    log_r = torch.clamp(x[..., 3], min=cfg.min_log_aspect)
    s = torch.exp(log_s)
    r = torch.exp(log_r)
    w = torch.sqrt(s * r)
    h = s / w
    w = torch.clamp(w, cfg.min_wh, cfg.max_wh)
    h = torch.clamp(h, cfg.min_wh, cfg.max_wh)
    bx = torch.trunc(cx - w / 2.0)
    by = torch.trunc(cy - h / 2.0)
    return torch.stack([bx, by, torch.trunc(w), torch.trunc(h)], dim=-1)


def predict_tracks(table: TrackTable, cfg: TrackerConfig) -> Tuple[TrackTable, torch.Tensor]:
    """KF predict over active tracks; returns the table and the
    predicted boxes used for association."""
    dev = table.x.device
    xp, pp = kf_predict(table.x, table.p, _f_matrix(dev), _q_matrix(cfg, dev))
    xp = _clamp_state(xp, cfg)
    act = table.active
    x = torch.where(act[:, None], xp, table.x)
    p = torch.where(act[:, None, None], pp, table.p)
    age = table.age + act.to(torch.int32)
    tsu = table.tsu + act.to(torch.int32)
    table = table._replace(x=x, p=p, age=age, tsu=tsu)
    return table, _state_to_box(table.x, cfg)


def apply_assignment(table: TrackTable, det_boxes: torch.Tensor, det_mask: torch.Tensor,
                     match: torch.Tensor, cfg: TrackerConfig) -> Tuple[TrackTable, TrackOutputs]:
    """Update matched tracks, prune, spawn unmatched detections, emit.
    ``match`` (T,) is the detection index per track or −1."""
    d_cap = det_boxes.shape[0]
    dev = det_boxes.device

    matched = (match >= 0) & table.active
    safe_match = torch.clamp(match, 0, d_cap - 1).long()
    z = _bbox_to_z(det_boxes[safe_match], cfg)
    xn, pn = kf_update_tracker(table.x, table.p, z, cfg.r_diag)
    xn = _clamp_state(xn, cfg)
    x = torch.where(matched[:, None], xn, table.x)
    p = torch.where(matched[:, None, None], pn, table.p)
    zero = torch.zeros_like(table.tsu)
    tsu = torch.where(matched, zero, table.tsu)
    hits = table.hits + matched.to(torch.int32)
    streak = torch.where(matched, table.streak + 1, table.streak)

    # prune BEFORE spawning so freed slots are reusable this frame
    active = table.active & (tsu <= cfg.max_age)

    # spawn: pair the rank-i unmatched detection with the rank-i free slot
    det_ids = torch.arange(d_cap, device=dev)
    det_matched = torch.any(matched[None, :] & (safe_match[None, :] == det_ids[:, None]), dim=1)
    unmatched = det_mask & ~det_matched
    free = ~active
    det_rank = torch.cumsum(unmatched.to(torch.int32), 0) - 1
    free_rank = torch.cumsum(free.to(torch.int32), 0) - 1
    n_free = free.sum()
    can_spawn = unmatched & (det_rank < n_free)
    pair = free[:, None] & can_spawn[None, :] & (free_rank[:, None] == det_rank[None, :])
    spawned = torch.any(pair, dim=1)

    z0 = _bbox_to_z(det_boxes, cfg)
    x0 = torch.cat([z0, torch.zeros((d_cap, 6), dtype=torch.float32, device=dev)], dim=-1)
    x = torch.where(spawned[:, None], pair.float() @ x0, x)
    p = torch.where(spawned[:, None, None], torch.eye(10, dtype=torch.float32, device=dev)[None], p)
    tid = torch.where(spawned, table.next_id + free_rank, table.tid).to(torch.int32)
    age = torch.where(spawned, zero, table.age)
    tsu = torch.where(spawned, zero, tsu)
    hits = torch.where(spawned, zero, hits)
    streak = torch.where(spawned, zero, streak)
    active = active | spawned
    next_id = (table.next_id + can_spawn.sum()).to(torch.int32)

    table = TrackTable(x, p, tid, age, tsu, hits, streak, active, next_id)

    confirmed = active & (hits >= cfg.min_hits)
    boxes = _state_to_box(x, cfg).to(torch.int32)
    spawn_src = (pair.to(torch.int64) * det_ids[None, :]).sum(dim=1)
    src_det = torch.where(spawned, spawn_src,
                          torch.where(matched, safe_match, torch.full_like(safe_match, -1)))
    out = TrackOutputs(tid=tid, boxes=boxes, age=age, mask=confirmed,
                       src_det=src_det.to(torch.int32))
    return table, out


def sort_step(table: TrackTable, det_boxes: torch.Tensor, det_mask: torch.Tensor,
              cfg: TrackerConfig) -> Tuple[TrackTable, TrackOutputs]:
    """One frame: predict → cost → exact (or greedy) assignment → apply."""
    table, trk_boxes = predict_tracks(table, cfg)
    det_boxes = det_boxes.float()
    cost = assign.cost_matrix(det_boxes, trk_boxes, max_distance=cfg.max_distance)
    gate = (1.0 - cfg.iou_threshold) + 1.0
    if cfg.assignment == "greedy":
        match = assign.greedy_assign(cost, det_mask, table.active, gate,
                                     max_pairs=min(det_boxes.shape[0], table.x.shape[0]))
    else:
        match = assign.lap_assign(cost, det_mask, table.active, gate)
    return apply_assignment(table, det_boxes, det_mask, match, cfg)


def copy_into(dst, src) -> None:
    """Write each tensor of ``src`` into the one of ``dst`` (a table or
    state updated in place)."""
    for d, s in zip(dst, src):
        d.copy_(s)


def _pack_outputs(out: TrackOutputs) -> torch.Tensor:
    """(8T,) int32: tid ‖ boxes(4) ‖ age ‖ mask ‖ src_det, one readback."""
    return torch.cat([out.tid, out.boxes.reshape(-1).to(torch.int32), out.age,
                      out.mask.to(torch.int32), out.src_det])


def _pack_cost_active(cost: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """(D·T + T,) float32: cost matrix ‖ active mask in one transfer."""
    return torch.cat([cost.reshape(-1), active.float()])


class Sort:
    """Host API of the tracker: ``update(detections)`` takes a list of
    ``{'bbox': [x, y, w, h], ...}`` dicts and returns
    ``[{'id', 'bbox', 'age', 'src_det'}, ...]`` for the confirmed tracks.
    The track table lives on ``device``; a frame is one ``sort_scan``
    (:mod:`fire_tpu_torch.track.scan`) at B = 1, one K2 launch on the
    card, and one packed int32 readback (plus one of cost ‖ active under
    ``assignment="hungarian_host"``, which solves the LAP on the host by
    design).

    On a card a frame runs the way JAX's jitted pieces run
    (``sort.py:297-325``): one CUDA graph of K2 and ``_pack_outputs`` per
    ``(device, cfg, max_dets)``, captured at the first frame, its static
    inputs the (max_dets, 4) boxes and (max_dets,) mask, uploaded from
    pinned memory; under ``hungarian_host`` two graphs around the host
    solve (predict, cost and ``_pack_cost_active``; then apply and
    ``_pack_outputs``).  The table is the graphs' static state: every
    frame updates its tensors in place, on either path, and
    :meth:`reset` writes a fresh table into them.  The eager frame is the
    graphs' plain version."""

    def __init__(self, cfg: Optional[TrackerConfig] = None, max_dets: int = 32,
                 device: DeviceLike = None):
        self.cfg = cfg or TrackerConfig()
        self.max_dets = max_dets
        self.device = resolve_device(device)
        self.table = make_table(self.cfg, self.device)
        self.graphs = GraphCache(limit=None)  # one or two graphs, for the one key
        self._staging = HostStaging()

    def reset(self) -> None:
        """A fresh table, written into the table's own tensors (the
        graphs hold them)."""
        copy_into(self.table, make_table(self.cfg, self.device))

    def release_graphs(self) -> None:
        """Drop the captured graphs; the next frame on a card captures
        again."""
        self.graphs.clear()

    def _graphed(self, device: torch.device) -> bool:
        """Whether a frame replays captured graphs: on a CUDA device."""
        return torch.device(device).type == "cuda"

    def _host_match(self, packed: np.ndarray, det_mask: np.ndarray) -> np.ndarray:
        """The exact LAP on the host from one (cost ‖ active) readback."""
        d_cap, t_cap = self.max_dets, self.table.x.shape[0]
        cost = packed[: d_cap * t_cap].reshape(d_cap, t_cap)
        active = packed[d_cap * t_cap :] > 0.5
        gate = (1.0 - self.cfg.iou_threshold) + 1.0
        return assign.hungarian_assign(cost, det_mask, active, gate)

    # the frame's pieces, as functions of their device operands; each
    # writes the new table into ``table``'s tensors

    def _step(self, boxes, mask, *table):
        from fire_tpu_torch.track.scan import sort_scan  # scan imports this module

        _, outs = sort_scan(TrackTable(*table), boxes[None], mask[None], self.cfg)
        return _pack_outputs(TrackOutputs(*(x[0] for x in outs)))

    def _predict_cost(self, boxes, *table):
        new, trk_boxes = predict_tracks(TrackTable(*table), self.cfg)
        copy_into(table, new)
        return _pack_cost_active(
            assign.cost_matrix(boxes, trk_boxes, max_distance=self.cfg.max_distance), new.active)

    def _apply(self, boxes, mask, match, *table):
        new, out = apply_assignment(TrackTable(*table), boxes, mask, match, self.cfg)
        copy_into(table, new)
        return _pack_outputs(out)

    @torch.no_grad()
    def update(self, detections: List[dict]) -> List[dict]:
        cfg = self.cfg
        d_cap = self.max_dets
        det_boxes = np.zeros((d_cap, 4), np.float32)
        det_mask = np.zeros((d_cap,), bool)
        for i, det in enumerate(detections[:d_cap]):
            det_boxes[i] = np.asarray(det["bbox"], np.float32)
            det_mask[i] = True

        if self._graphed(self.device):
            key = (indexed(self.device), cfg, d_cap)

            def run(name, fn, *args):
                return replay(self.graphs, (*key, name), fn, args, self._staging,
                              state=self.table)[0]
        else:
            def run(name, fn, *args):
                return fn(*(torch.from_numpy(a).to(self.device) for a in args), *self.table)

        if cfg.assignment == "hungarian_host":
            # exact LAP solved on the host (SciPy): one packed readback
            packed = run("predict", self._predict_cost, det_boxes)
            with span("readback"):
                packed = packed.cpu().numpy()
            buf = run("apply", self._apply, det_boxes, det_mask,
                      self._host_match(packed, det_mask))
        else:
            buf = run("step", self._step, det_boxes, det_mask)
        with span("readback"):
            buf = buf.cpu().numpy()
        t = buf.shape[0] // 8
        tids, boxes, ages = buf[:t], buf[t : 5 * t].reshape(t, 4), buf[5 * t : 6 * t]
        mask = buf[6 * t : 7 * t] > 0
        src = buf[7 * t :]
        return [
            {"id": int(tids[i]), "bbox": [int(v) for v in boxes[i]],
             "age": int(ages[i]), "src_det": int(src[i])}
            for i in np.nonzero(mask)[0]
        ]
