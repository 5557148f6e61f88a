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
exact bucketed compaction with the full path as the top rung, the same
identity bookkeeping and ``MAX_ENROLL`` starvation guard, and the same
packed int32 result buffer.

It also runs the way the JAX step runs.  On a CUDA device
:meth:`BatchStreamEngine.submit` replays one CUDA graph a batch
(:class:`StepGraph`, captured at the first batch of each shape and
gallery matrix), the counterpart of ``jax.jit(step)``:

* the encoder rung is chosen on the card: ``searchsorted`` of the
  batch's real-detection count over the ladder, then one conditional
  node a rung (``jnp.searchsorted`` + ``lax.switch``);
* the top rung crops every frame in one batched pass
  (:func:`~fire_tpu_torch.ops.image.crop_and_resize_mm_batched`,
  ``jax.vmap(crop_and_resize_mm)``);
* K1 reads the gallery's live rows from its device count, so an
  enrolment needs no new capture (JAX passes ``count`` as an operand);
* the stream state lives in static tensors that every replay updates.

The frames go up from pinned host memory into the graph's input and the
result comes back to pinned memory, both asynchronously, so ``submit``
reads nothing from the card and returns once the batch is queued;
:meth:`BatchStreamEngine.collect` waits for it.  The eager
:meth:`BatchStreamEngine.step` is the graph's plain version: the CPU runs
it, and on the card the tests and ``chip_smoke.py`` hold the replay
against it.  The tracker's branches (the LAP fast path, the JV solve)
run inside K2, and the epilogue scatters over padded indices where a
boolean index would read a count back.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from fire_tpu_torch.config import RecognizerConfig, TrackerConfig
from fire_tpu_torch.ops.boxes import top_k_stable
from fire_tpu_torch.ops.cosine_top1 import cosine_top1
from fire_tpu_torch.ops.gallery_match import l2_normalize
from fire_tpu_torch.ops.image import bgr_to_rgb, crop_and_resize_mm_batched, crop_selected_rows
from fire_tpu_torch.runtime.graphs import (GraphCache, HostStaging, check_graph_runtime,
                                           count_replayed, launch_counts, set_launch_counts,
                                           side_stream)
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


def state_tensors(state: StreamState) -> Tuple[torch.Tensor, ...]:
    return (*state.table, state.gid, state.sim, state.unk, state.pending, state.last_emb)


def copy_state(dst: StreamState, src: StreamState) -> None:
    """Write ``src`` into ``dst``'s own tensors (those it shares are
    skipped)."""
    for d, s in zip(state_tensors(dst), state_tensors(src)):
        if d is not s:
            d.copy_(s)


def clone_state(state: StreamState) -> StreamState:
    return StreamState(TrackTable(*(t.clone() for t in state.table)),
                       *(t.clone() for t in state[1:]))


def rung_index(ladder: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The encoder rung of a batch, on the batch's device: the first
    bucket of ``ladder`` (ascending int64) that holds its real detections
    (``mask.sum()``), ``jnp.searchsorted(side="left")`` as JAX picks the
    ``lax.switch`` branch.  A 0-d int64 tensor; nothing is read back."""
    n_real = mask.sum().reshape(1).to(ladder.dtype)
    return torch.searchsorted(ladder, n_real, side="left")[0]


class _Front(NamedTuple):
    """What the encoder rungs and the tracker take from detection."""

    det_frames: torch.Tensor   # (n_det, H, W, 3) uint8
    boxes: torch.Tensor        # (n_det, k, 4) the top-k boxes by score
    mask: torch.Tensor         # (n_det, k) bool
    flat_scores: torch.Tensor  # (n_det·k,) f32, −1 where masked
    batch: int
    n_det: int
    k: int


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


class StepGraph:
    """The batched steps of one or more streams on one CUDA device as one
    CUDA graph, replayed per batch: the counterpart of ``jax.jit(step)``.
    ``frames`` are its static inputs (one (B, H, W, 3) uint8 batch a
    stream), ``states`` its static stream states, updated in place by
    every replay, and ``packed`` its outputs, overwritten by every replay
    (so a replay's readback is queued right after it, in stream order).
    ``count`` is the gallery's device count: an enrolment between two
    replays needs no new capture.

    Building it: the first batch is copied into ``frames``; each encoder
    rung runs eagerly once on a side stream, on scratch copies of the
    first state, so that cuDNN's choice of algorithm, the cuBLAS
    workspace and the allocator's blocks are settled before the capture
    (torch's ``ControlFlowOpWarmupDispatchMode`` idea).  Then each
    stream's step is captured on that stream in parts, all into ``pool``
    (:meth:`BatchStreamEngine._capture_parts`), and the parts are chained
    into one graph (:class:`~fire_tpu_torch.runtime.step_graph.
    ComposedGraph`) in which the rung bodies sit behind conditional nodes.
    A capture that fails raises: nothing falls back to eager dispatch.

    K1's, K2's and K3's launch counters count what runs: the warm-up and
    the capture add nothing, and each replay adds the launches its graph
    holds (K1 and K2 once a stream, K3 once a BatchNorm of the networks,
    whatever the rung)."""

    def __init__(self, owner: "BatchStreamEngine", engine, gal: torch.Tensor,
                 count: torch.Tensor, states: List[StreamState], frames: List[torch.Tensor],
                 pool):
        """``frames``: the first batch of each stream on the device, kept
        as the static inputs."""
        from fire_tpu_torch.runtime.step_graph import ComposedGraph

        check_graph_runtime()
        dev = gal.device
        self.device = dev
        self.states = states
        self.frames = frames
        self.pool = pool
        self.parts: List[torch.cuda.CUDAGraph] = []  # they hold the graph's memory
        counts = launch_counts()
        cur = torch.cuda.current_stream(dev)
        side = side_stream(dev)
        side.wait_stream(cur)
        try:
            with torch.cuda.device(dev), torch.cuda.stream(side), torch.inference_mode():
                owner.warm_up(engine, gal, count, states[0], frames[0])
                # the warm-up's blocks back to the card, where the capture's
                # pool can take them (as torch.cuda.graph does before a capture)
                torch.cuda.synchronize(dev)
                torch.cuda.empty_cache()
                reserved = torch.cuda.memory_reserved(dev)
                t0 = time.perf_counter()
                items, self.packed, self.rungs, self._held = [], [], [], []
                # K1's, K2's and K3's launches (and K3's PReLU route's) in one replay
                self.launches_per_replay = (0,) * len(counts)
                for state, x in zip(states, frames):
                    got = owner._capture_parts(self._part, engine, gal, count, state, x)
                    stream_items, packed, rung, per_replay, held = got
                    items += stream_items
                    self.packed.append(packed)
                    # each stream's rung of the last replay, a 0-d tensor on the
                    # card (None for a single rung): for checks, never read on the path
                    self.rungs.append(rung)
                    self._held.append(held)
                    self.launches_per_replay = tuple(
                        a + b for a, b in zip(self.launches_per_replay, per_replay))
                self.graph = ComposedGraph(items, dev)
                self.capture_s = time.perf_counter() - t0
                # what this capture added to the device's shared pool
                self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
            cur.wait_stream(side)
        finally:
            set_launch_counts(counts)

    @contextlib.contextmanager
    def _part(self):
        """Capture the enclosed work on the current stream as one part."""
        part = torch.cuda.CUDAGraph(keep_graph=True)
        part.capture_begin(pool=self.pool)
        try:
            yield part
        finally:
            part.capture_end()
        self.parts.append(part)

    def replay(self) -> List[torch.Tensor]:
        """Queue one run of the graph on the current stream (its inputs
        already copied into ``frames``); returns ``packed``."""
        self.graph.launch()
        count_replayed(self.launches_per_replay)
        return self.packed


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
        records device time when given: per stage in the eager step, the
        whole replay on the card."""
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
        self._ladders = {}
        self.graphs = GraphCache()
        # pinned readback buffers, owned by their tokens until collected
        self.readback_pool = ReadbackPool(
            lambda n: torch.empty(n, dtype=torch.int32, pin_memory=True))
        self._staging = HostStaging()  # pinned upload buffers, by slot and shape

    def reset(self):
        """A fresh tracker and identity state, written into the state's
        own tensors (the step graphs hold them)."""
        copy_state(self.state, make_stream_state(self.tcfg, self.cfg.embedding_dim, self.device))

    def _stage(self, name: str, timer):
        if timer is None:
            return contextlib.nullcontext()
        return timer.stage(name, self.device)

    def rungs(self, nk: int) -> Tuple[Optional[Tuple[int, ...]], Tuple[Tuple[int, bool], ...]]:
        """The encoder rungs of a batch of ``nk`` detection slots as
        ``(m, full)`` pairs, with the ladder that picks one (None for a
        single rung): ``encode_budget``'s one compacted rung, else the
        bucket ladder's, compacted at each bucket but the top one, which is
        the full path (``batch_engine.py:424-468``)."""
        if self.encode_budget is not None:
            return None, ((max(1, min(self.encode_budget, nk)), False),)
        buckets = _bucket_ladder(nk, self.encode_buckets)
        if buckets == (nk,) or not buckets:
            return None, ((nk, True),)
        return buckets, tuple((m, False) for m in buckets[:-1]) + ((nk, True),)

    def _ladder_on(self, ladder: Tuple[int, ...], device) -> torch.Tensor:
        key = (ladder, torch.device(device))
        if key not in self._ladders:
            self._ladders[key] = torch.tensor(ladder, dtype=torch.int64, device=device)
        return self._ladders[key]

    def _front(self, engine, frames_u8: torch.Tensor, timer) -> _Front:
        """Detect every interval-th frame and keep each one's top-k
        detections (``batch_engine.py:340-396``)."""
        batch, h, w = frames_u8.shape[:3]
        interval = self.interval
        if batch % interval != 0:
            raise ValueError(f"batch {batch} not a multiple of detection_interval {interval}")
        n_det = batch // interval
        key = (engine.device, h, w, timer)
        detect = self._detect_cache.get(key)
        if detect is None:
            detect = self._detect_cache[key] = engine._build_detect((h, w), timer)
        # frame-skip phase as in JAX
        det_frames = frames_u8[interval - 1 :: interval] if interval > 1 else frames_u8
        dets = detect(det_frames)
        k = min(self.encode_k, dets.mask.shape[1])
        scores_raw = torch.where(dets.mask, dets.scores.float(), torch.full_like(dets.scores, -1.0))
        pick = torch.sort(-scores_raw, dim=1, stable=True).indices[:, :k]
        boxes = torch.gather(dets.boxes_xywh, 1, pick[..., None].expand(n_det, k, 4))
        mask = torch.gather(dets.mask, 1, pick)
        scores = torch.gather(scores_raw, 1, pick)
        flat_scores = torch.where(mask, scores, torch.full_like(scores, -1.0)).reshape(-1)
        return _Front(det_frames, boxes, mask, flat_scores, batch, n_det, k)

    def _encode(self, engine, gal: torch.Tensor, count, front: _Front, m: int, full: bool,
                timer) -> Tuple[torch.Tensor, ...]:
        """One encoder rung: crop, FaceNet and K1 over ``m`` compacted
        detections (``full``: every slot, one batched crop), scattered
        back to the (n_det, k) slots as ``(emb, det_sim, det_gid,
        has_emb)``; unencoded slots carry emb 0 / sim 0 / gid -1 and
        has_emb False (``batch_engine.py:398-447``)."""
        size = self.cfg.engine.encode_size
        n_det, k = front.n_det, front.k
        nk = n_det * k

        def embed(crops):
            with self._stage("facenet", timer):
                flat = bgr_to_rgb(crops / 255.0).reshape(-1, *size, 3)
                emb_q = l2_normalize(engine.encode(flat).float())
            with self._stage("K1", timer):
                sims, idx = cosine_top1(emb_q, gal, count)
            return emb_q, sims, idx

        if full:
            with self._stage("crop", timer):
                crops = crop_and_resize_mm_batched(front.det_frames, front.boxes, size)
            emb_q, sims, idx = embed(crops)
            mask = front.mask
            emb = emb_q.reshape(n_det, k, -1) * mask[..., None]
            det_sim = torch.where(mask, sims.reshape(n_det, k), 0.0)
            det_gid = torch.where(mask, idx.reshape(n_det, k), -1)
            return emb, det_sim, det_gid, mask
        top_s, top_idx = top_k_stable(front.flat_scores, m)
        sel_valid = top_s >= 0.0
        with self._stage("crop", timer):
            crops = crop_selected_rows(front.det_frames, top_idx // k,
                                       front.boxes.reshape(-1, 4)[top_idx], size)
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

    def _back(self, state: StreamState, front: _Front, enc, timer
              ) -> Tuple[StreamState, torch.Tensor]:
        """Coast frames filled in, then the tracker scan and the packed
        results (``batch_engine.py:470-489``)."""
        emb, det_sim, det_gid, has_emb = enc
        boxes, mask = front.boxes.float(), front.mask
        interval = self.interval
        if interval > 1:
            # coast frames carry an all-False mask
            def expand(x, fill=0):
                full = torch.full((front.batch, *x.shape[1:]), fill, dtype=x.dtype,
                                  device=x.device)
                full[interval - 1 :: interval] = x
                return full

            boxes = expand(boxes)
            mask = expand(mask, fill=False)
            det_gid = expand(det_gid)
            det_sim = expand(det_sim)
            emb = expand(emb)
            has_emb = expand(has_emb, fill=False)
        with self._stage("tracker scan", timer):
            state, res = _track_scan(
                state, boxes, mask, det_gid, det_sim, emb, has_emb, self.tcfg,
                self.cfg.similarity_threshold, self.cfg.unknown_trigger_count)
            return state, pack_results(res)

    def step(self, engine, gal: torch.Tensor, count, state: StreamState,
             frames_u8: torch.Tensor, rung: Optional[int] = None
             ) -> Tuple[StreamState, torch.Tensor]:
        """The step as a function of its operands, as the JAX step is of
        ``(det_vars, enc_vars, gal, count, state, frames)``: ``engine``
        holds the models on the frames' device, ``gal`` the gallery matrix
        there with ``count`` live rows (an int, or the gallery's 0-d
        device count).  Returns the new state and the packed int32
        results.

        Run eagerly, it is the plain version of the captured graph: the
        batch's real-detection count picks the rung by the same
        ``searchsorted`` on its device, then read to the host (the graph
        branches on the card).  ``rung`` forces a rung instead."""
        timer = self.timer
        front = self._front(engine, frames_u8, timer)
        ladder, rungs = self.rungs(front.n_det * front.k)
        if rung is None:
            rung = 0 if ladder is None else int(
                rung_index(self._ladder_on(ladder, frames_u8.device), front.mask))
        return self._back(state, front, self._encode(engine, gal, count, front, *rungs[rung],
                                                     timer), timer)

    def warm_up(self, engine, gal: torch.Tensor, count, state: StreamState,
                frames_u8: torch.Tensor) -> None:
        """Every rung of the step once, eagerly, on scratch copies of
        ``state``: what a capture needs settled first."""
        front = self._front(engine, frames_u8, None)
        ladder, rungs = self.rungs(front.n_det * front.k)
        if ladder is not None:
            rung_index(self._ladder_on(ladder, frames_u8.device), front.mask)
        for m, full in rungs:
            enc = self._encode(engine, gal, count, front, m, full, None)
            self._back(clone_state(state), front, enc, None)

    def _capture_parts(self, part, engine, gal: torch.Tensor, count: torch.Tensor,
                       state: StreamState, frames_u8: torch.Tensor):
        """One stream's step captured in parts by ``part()`` (a context
        that captures what it encloses as one graph): the front, whose
        last work is the rung index (``jnp.searchsorted`` in JAX), each
        encoder rung's body (all writing the same four tensors), and the
        back, which writes the new state into ``state``'s own tensors.
        Returns the items to compose (the bodies behind the rung index:
        ``lax.switch``), the packed results, the rung index (None for a
        single rung), the kernels' launches in one run of the step (K1,
        K2, K3), and the tensors that pass between parts, which must
        outlive the graph."""
        start = launch_counts()
        with part() as front_part:
            front = self._front(engine, frames_u8, None)
            ladder, rungs = self.rungs(front.n_det * front.k)
            sel = None
            if ladder is not None:
                sel = rung_index(self._ladder_on(ladder, frames_u8.device), front.mask)
                shape, dev = (front.n_det, front.k), frames_u8.device
                enc = (torch.empty((*shape, self.cfg.embedding_dim), dtype=torch.float32,
                                   device=dev),
                       torch.empty(shape, dtype=torch.float32, device=dev),
                       torch.empty(shape, dtype=torch.int32, device=dev),
                       torch.empty(shape, dtype=torch.bool, device=dev))
        bodies, per_rung = [], []
        for m, full in rungs:
            counts = launch_counts()
            with part() as body:
                out = self._encode(engine, gal, count, front, m, full, None)
                if ladder is None:
                    enc = out
                else:
                    for dst, src in zip(enc, out):
                        dst.copy_(src)
            bodies.append(body)
            per_rung.append(tuple(a - b for a, b in zip(launch_counts(), counts)))
        if len(set(per_rung)) != 1:
            raise RuntimeError(f"step graph: the rungs launch K1, K2 and K3 {per_rung} times")
        with part() as back_part:
            new, packed = self._back(state, front, enc, None)
            copy_state(state, new)
        # the capture ran every rung's body; a run of the step runs one
        per_replay = tuple(a - s - (len(rungs) - 1) * r
                           for a, s, r in zip(launch_counts(), start, per_rung[0]))
        items = [([front_part], None), (bodies, sel), ([back_part], None)]
        return items, packed, sel, per_replay, (front, enc, sel, packed)

    def _graph_key(self, engine, gal: torch.Tensor, count: torch.Tensor, n_streams: int,
                   frames_shape) -> tuple:
        """What a step graph is captured for: the device, the streams and
        the frames' shape, the gallery matrix and its count, and the
        models (a module put in another's slot needs a new capture)."""
        return (gal.device, n_streams, tuple(frames_shape), gal.dtype, gal.data_ptr(),
                count.data_ptr(), getattr(self.gallery, "matrix_version", None),
                id(getattr(engine, "detector", None)), id(getattr(engine, "encoder", None)))

    def _graphed(self, device: torch.device) -> bool:
        """Whether ``submit`` replays a captured graph: on a CUDA device."""
        return torch.device(device).type == "cuda"

    def _upload(self, frames, device: torch.device, slot: int = 0,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Frames (a host array or tensor) on ``device``, in ``out`` (a
        graph's static input) when given.  To a card, host frames go
        through one of two pinned buffers of ``slot`` (a stream) and up
        asynchronously (:class:`~fire_tpu_torch.runtime.graphs.HostStaging`),
        so the call does not wait for the work already queued on the card."""
        return self._staging.upload(frames, device, slot, out)

    def submit(self, frames):
        """Enqueue one batch; returns a token for :meth:`collect`.  On the
        card this reads nothing back and waits for nothing queued there:
        the frames go up from pinned memory into the graph's static
        input, the step graph for this shape and gallery matrix replays
        (captured at its first batch), and the result is copied to pinned
        host memory asynchronously.  Elsewhere the eager step runs."""
        b = frames.shape[0]
        dev = self.device
        if not self._graphed(dev):
            with self._stage("H2D", self.timer):
                frames = self._upload(frames, dev)
            with torch.inference_mode():
                new, packed = self.step(self.engine, self.gallery.gal_matmul,
                                        self.gallery.count, self.state, frames)
            copy_state(self.state, new)
            return self._readback(packed), b
        gal, count = self.gallery.gal_matmul, self.gallery.count_dev
        key = self._graph_key(self.engine, gal, count, 1, frames.shape)
        graph = self.graphs.get(key, lambda pool: StepGraph(
            self, self.engine, gal, count, [self.state],
            [self._upload(frames, dev)], pool))
        with self._stage("H2D", self.timer):
            self._upload(frames, dev, out=graph.frames[0])
        with self._stage("step (graph replay)", self.timer):
            packed = graph.replay()[0]
        return self._readback(packed), b

    def _readback(self, packed: torch.Tensor, slot: int = 0) -> Readback:
        """Start the copy of one packed result to host memory.  On the
        card it goes asynchronously into a pinned buffer of ``slot`` that
        the returned token owns until :meth:`_unpack` gives it back."""
        if packed.device.type != "cuda":
            return Readback(packed, None, None)
        host = self.readback_pool.take(packed.numel(), slot)
        with torch.cuda.device(packed.device):
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
            self.timer.resolve(wait=False)
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
