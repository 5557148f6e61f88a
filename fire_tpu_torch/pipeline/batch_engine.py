"""Batched device-resident stream pipeline (counterpart of
``fire_tpu.pipeline.batch_engine``) — B frames per device step:

    detect:  letterbox → detector (YuNet, RetinaFace or BlazeFace) → decode
             + NMS, batched over the frames
    encode:  the batch's detections compacted into the smallest encoder
             bucket that holds them all, cropped, FaceNet, L2-normalised
    match:   every embedding against the gallery in one K1 launch
    track:   every frame of the batch in one K2 launch (``track_scan``),
             identity bookkeeping included

Semantics are the JAX step's: the same top-k pick (stable sorts, so
ties keep the lower index as ``lax.top_k`` / ``argsort`` do), the same
exact bucketed compaction with ``encode_full`` as the top rung, the same
identity bookkeeping and ``MAX_ENROLL`` starvation guard, and the same
packed int32 result buffer.

Where JAX compiles control flow, the port reads the device once a
batch: the batch's real-detection count selects the encoder bucket
(``lax.switch`` in JAX).  With ``encode_budget`` or a single rung it
reads nothing.  The tracker's branches (the LAP fast path, the JV solve)
run inside K2, and the epilogue scatters over padded indices where a
boolean index would read a count back.  On the card the frames go up
from pinned host memory and the result buffer comes back to it, both
asynchronously, so :meth:`BatchStreamEngine.submit` returns once the
batch is queued and :meth:`BatchStreamEngine.collect` waits for it.
"""

from __future__ import annotations

import bisect
import contextlib
import logging
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from fire_tpu_torch.config import RecognizerConfig, TrackerConfig
from fire_tpu_torch.ops.boxes import top_k_stable
from fire_tpu_torch.ops.cosine_top1 import cosine_top1
from fire_tpu_torch.ops.gallery_match import l2_normalize
from fire_tpu_torch.ops.image import bgr_to_rgb, crop_and_resize_mm, crop_selected_rows
from fire_tpu_torch.track.scan import IdentityState, gather_emb, track_scan
from fire_tpu_torch.track.sort import TrackTable, make_table

log = logging.getLogger(__name__)

MAX_ENROLL = 8  # enrollment candidates surfaced to the host per batch


class StreamState(NamedTuple):
    """Device-resident tracker + identity state."""

    table: TrackTable
    gid: torch.Tensor       # (T,) int32 gallery row per track; -1 = none yet
    sim: torch.Tensor       # (T,) f32 similarity at assignment time
    unk: torch.Tensor       # (T,) int32 consecutive no-match sightings
    pending: torch.Tensor   # (T,) bool — enrollment flagged, host not yet applied
    last_emb: torch.Tensor  # (T, D) f32 last embedding per track


class BatchResults(NamedTuple):
    """Per-batch results (leading axis = frame), packed into one int32
    buffer on the device and read back once per batch."""

    tid: np.ndarray           # (B, T) int32
    boxes: np.ndarray         # (B, T, 4) int32
    gid: np.ndarray           # (B, T) int32 (-1 = unlabelled)
    sim: np.ndarray           # (B, T) f32
    mask: np.ndarray          # (B, T) bool confirmed tracks
    enroll: np.ndarray        # (B, T) bool — crossed the unknown trigger
    enroll_emb: np.ndarray    # (MAX_ENROLL, D) f32
    enroll_frame: np.ndarray  # (MAX_ENROLL,) int32 (-1 = empty slot)
    enroll_slot: np.ndarray   # (MAX_ENROLL,) int32


class ReadbackPool:
    """Host buffers for packed results, each owned by the token that holds
    it: :meth:`take` hands out a free buffer of ``n`` int32 for ``slot``
    (a stream), or makes one with ``alloc(n)`` when none is free, and a
    buffer is free again only after :meth:`give`, which ``collect`` calls
    once it has copied the results out.  So any number of tokens may be
    outstanding, and a token never collected keeps its buffer.  On the
    card ``alloc`` makes pinned memory; the tests pass ``torch.empty``."""

    def __init__(self, alloc: Callable[[int], torch.Tensor]):
        self._alloc = alloc
        self._free: Dict[Tuple[int, int], List[torch.Tensor]] = {}

    def take(self, n: int, slot: int = 0) -> torch.Tensor:
        free = self._free.get((slot, n))
        return free.pop() if free else self._alloc(n)

    def give(self, buf: torch.Tensor, slot: int = 0) -> None:
        self._free.setdefault((slot, buf.numel()), []).append(buf)


class Readback(NamedTuple):
    """One packed result on its way to the host: ``host`` (a pool buffer
    of ``slot``, or the tensor itself off the card, ``slot`` None) and
    the event its copy records (None off the card)."""

    host: torch.Tensor
    done: Optional[torch.cuda.Event]
    slot: Optional[int]


def _bucket_ladder(nk: int, buckets_opt) -> Tuple[int, ...]:
    """Encoder bucket sizes for the exact compaction: ascending, ending
    at ``nk``.  None → ≈[nk/8, nk/2, nk] rounded up to multiples of 8;
    ``()`` → compaction disabled."""
    if buckets_opt is not None and len(buckets_opt) == 0:
        return ()
    cand = [-(-nk // 8), -(-nk // 2)] if buckets_opt is None else list(buckets_opt)
    up8 = lambda v: -(-int(v) // 8) * 8  # noqa: E731
    rungs = sorted({min(nk, max(8, up8(v))) for v in cand if v > 0})
    if not rungs or rungs[-1] != nk:
        rungs.append(nk)
    return tuple(r for r in rungs if r <= nk)


def make_stream_state(tcfg: TrackerConfig, dim: int, device=None) -> StreamState:
    t = tcfg.max_tracks
    return StreamState(
        table=make_table(tcfg, device),
        gid=torch.full((t,), -1, dtype=torch.int32, device=device),
        sim=torch.zeros(t, dtype=torch.float32, device=device),
        unk=torch.zeros(t, dtype=torch.int32, device=device),
        pending=torch.zeros(t, dtype=torch.bool, device=device),
        last_emb=torch.zeros((t, dim), dtype=torch.float32, device=device),
    )


def _track_scan(state: StreamState, det_boxes, det_mask, det_gid, det_sim, det_emb,
                det_has_emb, tcfg: TrackerConfig, similarity_threshold: float,
                unknown_trigger: int):
    """Serial tracking over the frame batch with identity bookkeeping
    (``batch_engine.py:131``): one :func:`track_scan` (K2 on the card),
    then the enrolment compaction.  The state's table and identity
    tensors are updated in place.  Returns the new state and the
    per-frame device tensors ``(tid, boxes, gid, sim, mask, enroll,
    enroll_emb, enroll_frame, enroll_slot)``."""
    t_cap = state.table.x.shape[0]
    ident = IdentityState(state.gid, state.sim, state.unk, state.pending)
    table, ident, out, iout = track_scan(state.table, ident, det_boxes, det_mask, det_gid,
                                         det_sim, det_has_emb, tcfg, similarity_threshold,
                                         unknown_trigger)
    enroll = iout.enroll

    # compact the (rare) enrollment candidates to a fixed-size buffer
    flat_enroll = enroll.reshape(-1)
    _, top = top_k_stable(flat_enroll.to(torch.int32), MAX_ENROLL)
    valid = flat_enroll[top]
    e_frame = torch.where(valid, top // t_cap, torch.full_like(top, -1)).to(torch.int32)
    e_slot = (top % t_cap).to(torch.int32)
    e_emb = gather_emb(iout.emb_src.reshape(-1)[top], det_emb, state.last_emb,
                       slot=top % t_cap) * valid[:, None]
    last_emb = gather_emb(iout.emb_src[-1], det_emb, state.last_emb)

    # starvation guard: a track that fired but was compacted out keeps
    # pending=False so enroll re-fires next batch
    fired = enroll.any(dim=0)
    pending = ident.pending & ~(fired & ~delivered_slots(valid, e_slot, t_cap))
    state = StreamState(table=table, gid=ident.gid, sim=ident.sim, unk=ident.unk,
                        pending=pending, last_emb=last_emb)
    return state, (out.tid, out.boxes, iout.gid, iout.sim, out.mask, enroll, e_emb, e_frame,
                   e_slot)


def delivered_slots(valid: torch.Tensor, e_slot: torch.Tensor, t_cap: int) -> torch.Tensor:
    """(T,) bool: the slots whose enrolment made the compacted buffer.
    A scatter over a padded index (undelivered entries go to a spare slot
    past T), where a boolean index would read a count back."""
    out = torch.zeros(t_cap + 1, dtype=torch.bool, device=valid.device)
    out.index_fill_(0, torch.where(valid, e_slot, t_cap).long(), True)
    return out[:t_cap]


def pack_results(res) -> torch.Tensor:
    """Flatten results into one int32 vector: integer lanes by value,
    f32 lanes bit-cast (lossless both ways)."""
    parts = []
    for x in res:
        if x.dtype.is_floating_point:
            parts.append(x.float().reshape(-1).view(torch.int32))
        else:
            parts.append(x.reshape(-1).to(torch.int32))
    return torch.cat(parts)


def unpack_results(buf: np.ndarray, b: int, t: int, d: int) -> BatchResults:
    """Host-side inverse of :func:`pack_results` (buf: int32)."""
    sizes = [b * t, b * t * 4, b * t, b * t, b * t, b * t, MAX_ENROLL * d, MAX_ENROLL, MAX_ENROLL]
    shapes = [(b, t), (b, t, 4), (b, t), (b, t), (b, t), (b, t), (MAX_ENROLL, d),
              (MAX_ENROLL,), (MAX_ENROLL,)]
    dtypes = [np.int32, np.int32, np.int32, np.float32, bool, bool, np.float32, np.int32, np.int32]
    out, off = [], 0
    for n, shp, dt in zip(sizes, shapes, dtypes):
        chunk = buf[off : off + n]
        if dt == np.float32:
            out.append(chunk.view(np.float32).reshape(shp))
        elif dt == bool:
            out.append((chunk != 0).reshape(shp))
        else:
            out.append(chunk.reshape(shp))
        off += n
    return BatchResults(*out)


class BatchStreamEngine:
    """Runs the batched pipeline on the engine's device."""

    def __init__(self, engine, gallery, cfg: RecognizerConfig,
                 tracker_cfg: Optional[TrackerConfig] = None,
                 encode_k: int = 8, detection_interval: int = 1,
                 encode_budget: Optional[int] = None,
                 encode_buckets: Optional[Tuple[int, ...]] = None,
                 timer=None):
        """Arguments as in the JAX engine (``batch_engine.py:276``);
        ``timer`` (a :class:`~fire_tpu_torch.pipeline.timing.StageTimer`)
        records per-stage device time when given."""
        self.engine = engine
        self.gallery = gallery
        self.cfg = cfg
        self.tcfg = tracker_cfg or TrackerConfig()
        self.encode_k = encode_k
        self.encode_budget = encode_budget
        self.encode_buckets = encode_buckets
        self.interval = max(1, detection_interval)
        self.device = engine.device
        self.timer = timer
        self.state = make_stream_state(self.tcfg, cfg.embedding_dim, self.device)
        self._detect_cache = {}
        # pinned readback buffers, owned by their tokens until collected
        self.readback_pool = ReadbackPool(
            lambda n: torch.empty(n, dtype=torch.int32, pin_memory=True))
        self._staging = {}  # pinned upload buffers and their copies' events, by slot and shape

    def reset(self):
        self.state = make_stream_state(self.tcfg, self.cfg.embedding_dim, self.device)

    def _stage(self, name: str):
        if self.timer is None:
            return contextlib.nullcontext()
        return self.timer.stage(name, self.device)

    def _step(self, frames_u8: torch.Tensor) -> torch.Tensor:
        """One batch: (B, H, W, 3) uint8 on the device → packed int32."""
        self.state, packed = self.step(self.engine, self.gallery.gal_matmul, self.gallery.count,
                                       self.state, frames_u8)
        return packed

    def step(self, engine, gal: torch.Tensor, count: int, state: StreamState,
             frames_u8: torch.Tensor) -> Tuple[StreamState, torch.Tensor]:
        """The step as a function of its operands, as the JAX step is of
        ``(det_vars, enc_vars, gal, count, state, frames)``: ``engine``
        holds the models on the frames' device, ``gal`` the gallery matrix
        there with ``count`` live rows.  Returns the new state and the
        packed int32 results."""
        cfg, k_enc = self.cfg, self.encode_k
        batch, h, w = frames_u8.shape[:3]
        interval = self.interval
        if batch % interval != 0:
            raise ValueError(f"batch {batch} not a multiple of detection_interval {interval}")
        n_det = batch // interval
        size = cfg.engine.encode_size
        detect = self._detect_cache.get((engine.device, h, w))
        if detect is None:
            detect = engine._build_detect((h, w), self.timer)
            self._detect_cache[(engine.device, h, w)] = detect

        # ---- detect every interval-th frame (frame-skip phase as in JAX)
        det_frames = frames_u8[interval - 1 :: interval] if interval > 1 else frames_u8
        dets = detect(det_frames)
        k = min(k_enc, dets.mask.shape[1])
        scores_raw = torch.where(dets.mask, dets.scores.float(), torch.full_like(dets.scores, -1.0))
        pick = torch.sort(-scores_raw, dim=1, stable=True).indices[:, :k]
        boxes = torch.gather(dets.boxes_xywh, 1, pick[..., None].expand(n_det, k, 4))
        mask = torch.gather(dets.mask, 1, pick)
        nk = n_det * k
        scores = torch.gather(scores_raw, 1, pick)
        flat_scores = torch.where(mask, scores, torch.full_like(scores, -1.0)).reshape(-1)
        boxes_flat = boxes.reshape(-1, 4)

        def embed(crops):
            with self._stage("facenet"):
                flat = bgr_to_rgb(crops / 255.0).reshape(-1, *size, 3)
                emb_q = l2_normalize(engine.encode(flat).float())
            with self._stage("K1"):
                sims, idx = cosine_top1(emb_q, gal, count)
            return emb_q, sims, idx

        def encode_compacted(m):
            """Crop+encode+match the top-m detections, scattered back to
            (n_det, k) slots; unencoded slots carry emb 0 / sim 0 /
            gid -1 and has_emb False."""
            top_s, top_idx = top_k_stable(flat_scores, m)
            sel_valid = top_s >= 0.0
            with self._stage("crop"):
                crops = crop_selected_rows(det_frames, top_idx // k, boxes_flat[top_idx], size)
            emb_q, sims, idx = embed(crops)
            dim_e = emb_q.shape[-1]
            emb = torch.zeros((nk, dim_e), dtype=emb_q.dtype, device=emb_q.device)
            emb[top_idx] = emb_q * sel_valid[:, None]
            det_sim = torch.zeros(nk, dtype=torch.float32, device=emb_q.device)
            det_sim[top_idx] = sims * sel_valid
            det_gid = torch.full((nk,), -1, dtype=torch.int32, device=emb_q.device)
            det_gid[top_idx] = torch.where(sel_valid, idx, torch.full_like(idx, -1))
            has_emb = torch.zeros(nk, dtype=torch.bool, device=emb_q.device)
            has_emb[top_idx] = sel_valid
            return (emb.reshape(n_det, k, dim_e), det_sim.reshape(n_det, k),
                    det_gid.reshape(n_det, k), has_emb.reshape(n_det, k))

        def encode_full():
            """Full n_det·k path: one crop per slot (the ladder's top rung)."""
            with self._stage("crop"):
                crops = torch.stack([crop_and_resize_mm(det_frames[i], boxes[i], size)
                                     for i in range(n_det)])
            emb_q, sims, idx = embed(crops)
            emb = emb_q.reshape(n_det, k, -1) * mask[..., None]
            det_sim = torch.where(mask, sims.reshape(n_det, k), torch.zeros_like(scores))
            det_gid = torch.where(mask, idx.reshape(n_det, k), torch.full_like(pick, -1).int())
            return emb, det_sim, det_gid, mask

        if self.encode_budget is not None:
            emb, det_sim, det_gid, has_emb = encode_compacted(max(1, min(self.encode_budget, nk)))
        else:
            buckets = _bucket_ladder(nk, self.encode_buckets)
            if buckets == (nk,) or not buckets:
                emb, det_sim, det_gid, has_emb = encode_full()
            else:
                # lax.switch on device → one read of the real-detection count
                sel = bisect.bisect_left(buckets, int(mask.sum()))
                if sel >= len(buckets) - 1:
                    emb, det_sim, det_gid, has_emb = encode_full()
                else:
                    emb, det_sim, det_gid, has_emb = encode_compacted(buckets[sel])

        boxes = boxes.float()
        if interval > 1:
            # coast frames carry an all-False mask
            def expand(x, fill=0):
                full = torch.full((batch, *x.shape[1:]), fill, dtype=x.dtype, device=x.device)
                full[interval - 1 :: interval] = x
                return full

            boxes = expand(boxes)
            mask = expand(mask, fill=False)
            det_gid = expand(det_gid)
            det_sim = expand(det_sim)
            emb = expand(emb)
            has_emb = expand(has_emb, fill=False)

        with self._stage("tracker scan"):
            state, res = _track_scan(
                state, boxes, mask, det_gid, det_sim, emb, has_emb, self.tcfg,
                cfg.similarity_threshold, cfg.unknown_trigger_count)
            return state, pack_results(res)

    def _upload(self, frames, device: torch.device, slot: int = 0) -> torch.Tensor:
        """Frames (a host array or tensor) on ``device``.  To a card, host
        frames go through one of two pinned buffers of ``slot`` (a
        stream) and up asynchronously, so the call does not wait for the
        work already queued on the card."""
        device = torch.device(device)
        if isinstance(frames, np.ndarray):
            frames = torch.from_numpy(np.ascontiguousarray(frames))
        if device.type != "cuda" or frames.device.type != "cpu":
            return frames.to(device)
        key = (slot, tuple(frames.shape), frames.dtype)
        ring = self._staging.get(key)
        if ring is None:
            ring = self._staging[key] = [
                [torch.empty(frames.shape, dtype=frames.dtype, pin_memory=True), None]
                for _ in range(2)]
        entry = ring.pop(0)
        ring.append(entry)
        buf, done = entry
        if done is not None:
            done.synchronize()  # the upload out of this buffer, two batches ago, has left it
        buf.copy_(frames)
        out = buf.to(device, non_blocking=True)
        entry[1] = torch.cuda.Event()
        entry[1].record(torch.cuda.current_stream(device))
        return out

    def submit(self, frames):
        """Enqueue one batch; returns a token for :meth:`collect`.  On
        the card nothing here waits for the device except the one read
        that picks the encoder bucket (none with ``encode_budget`` or a
        single rung): the upload goes through pinned memory, the step
        queues, and the result copy to pinned host memory is
        asynchronous."""
        b = frames.shape[0]
        with self._stage("H2D"):
            frames = self._upload(frames, self.device)
        with torch.inference_mode():
            packed = self._step(frames)
        return self._readback(packed), b

    def _readback(self, packed: torch.Tensor, slot: int = 0) -> Readback:
        """Start the copy of one packed result to host memory.  On the
        card it goes asynchronously into a pinned buffer of ``slot`` that
        the returned token owns until :meth:`_unpack` gives it back."""
        if packed.device.type != "cuda":
            return Readback(packed, None, None)
        host = self.readback_pool.take(packed.numel(), slot)
        host.copy_(packed, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return Readback(host, done, slot)

    def _unpack(self, read: Readback, b: int) -> BatchResults:
        """Wait for one readback, unpack it, and give its buffer back."""
        if read.done is not None:
            read.done.synchronize()
        res = unpack_results(read.host.numpy().copy(), b, self.tcfg.max_tracks,
                             self.cfg.embedding_dim)
        if read.slot is not None:
            self.readback_pool.give(read.host, read.slot)
        return res

    def collect(self, token) -> BatchResults:
        """Wait for one submitted batch and unpack its results."""
        read, b = token
        res = self._unpack(read, b)
        if self.timer is not None:
            self.timer.resolve()
        return res

    def process_batch(self, frames) -> BatchResults:
        return self.collect(self.submit(frames))


def stream_results(recognizer, batch_results: BatchResults, rename_label: Optional[str] = None):
    """Host-side interpretation of one BatchResults: label lookup,
    unknown enrollment (dedup + SQLite + gallery append), rename and
    ``interested_label``.  Yields one ``[{'label','confidence','bbox'}]``
    list per frame (``batch_engine.py:529``)."""
    res = batch_results
    b = res.tid.shape[0]
    gal = recognizer.gallery
    enroll_embs = {
        (int(fr), int(sl)): res.enroll_emb[i]
        for i, (fr, sl) in enumerate(zip(res.enroll_frame, res.enroll_slot))
        if fr >= 0
    }
    enrolled_labels = {}
    for f in range(b):
        frame_out = []
        for slot in np.nonzero(res.mask[f])[0]:
            gid = int(res.gid[f, slot])
            tid = int(res.tid[f, slot])
            if 0 <= gid < gal.count:
                label = gal.labels[gid]
                conf = float(res.sim[f, slot])
                if rename_label and label != rename_label:
                    recognizer.update_label(gid, rename_label)
                    label = rename_label
            elif tid in enrolled_labels:
                label, conf = enrolled_labels[tid], 1.0
            elif res.enroll[f, slot] and (f, int(slot)) in enroll_embs:
                emb = enroll_embs[(f, int(slot))]
                n = np.linalg.norm(emb)
                if n == 0:
                    continue
                # the enroll flag proves the embedding scored at most the
                # threshold against the step's gallery snapshot; only
                # later enrollments need a host-side dedup
                label = recognizer.enroll_unknown_now(emb / n, rename_label, device_checked=True)
                enrolled_labels[tid] = label
                conf = 1.0
            else:
                label, conf = "Unknown", 0.0
            if recognizer.interested_label is not None and label != recognizer.interested_label:
                continue
            frame_out.append({"label": label, "confidence": conf,
                              "bbox": [int(v) for v in res.boxes[f, slot]]})
        yield frame_out
