"""Kernel K2: the tracker scan, B frames of SORT for one stream in one
launch (CUDA C++, sm_90a), with its plain version beside it.

It replaces what the JAX package leaves to XLA: the batched step's
``lax.scan`` (``fire_tpu/pipeline/batch_engine.py:131-230``), the
per-frame ``sort_step`` (``fire_tpu/track/sort.py:229``) and the device
LAP and greedy assignment (``fire_tpu/track/assignment.py:89-237``).
The source, its bound and its design are in
``fire_tpu_torch/csrc/track_scan.cu``.

* :func:`sort_scan` runs ``sort_step`` over the frames of ``boxes``
  (B, K, 4); :func:`track_scan` adds the batched step's identity
  bookkeeping.  Each dispatches on where its tensors lie: on the CPU the
  plain version (:func:`sort_scan_plain`, :func:`track_scan_plain`, a
  Python loop over ``sort_step``); on a CUDA device one launch of the
  kernel, or an exception.
* Both update the track table (and the identity state) in place and
  return them, where JAX returns new arrays; the outputs are new
  tensors with a leading frame axis.
* Identity outputs carry no embeddings: ``emb_src`` names, for each
  (frame, track), the flat index ``f * K + k`` of the detection whose
  embedding the track carries, or −1 for the one it carried into the
  scan; :func:`gather_emb` builds them.
* Any T and K: :func:`launch_plan` keeps the kernel's arrays in shared
  memory where they fit and places the rest in a scratch buffer (or, for
  P and x, the table itself); it never refuses a shape.

The kernel is compiled with ``nvcc`` at its first launch into
``fire_tpu_torch/_build/`` (named by the hash of the source and the
flags) and bound with ``ctypes``; nothing here builds or imports CUDA
code at module import.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
import os
from typing import NamedTuple, Optional, Tuple

import torch

from fire_tpu_torch.config import TrackerConfig
from fire_tpu_torch.device import raw_stream
from fire_tpu_torch.runtime.build import build_cuda, cuda_library_path
from fire_tpu_torch.track.sort import TrackOutputs, TrackTable, copy_into, sort_step

NAME = "track_scan"
SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc",
                      "track_scan.cu")
# -fmad=false: no multiply-add contraction, so the float32 arithmetic
# rounds where the plain version's does
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

MAX_SHARED_BYTES = 232_448    # dynamic shared memory one block may use on sm_90
MAX_WARPS = 8
MISC_BYTES = 128              # the mbarriers and counters before the first array
XS, PS = 11, 101              # a track's words of x and of P in shared memory
N_TRACK_FIELDS = 16           # per-track int fields, after the predicted boxes
MAX_CHUNK_FRAMES = 32         # frames a staging chunk holds at most
# The arrays a launch places, in the order of the source's enum, and the
# order in which they leave shared memory when it is short.
ARRAYS = ("cost", "p", "x", "tracks", "dets", "lap", "chunks")
SPILL_ORDER = ("cost", "p", "x", "tracks", "lap", "dets")
_WHERE = {"shared": 0, "scratch": 1, "table": 2}

# What a launch adds into its ``stats`` tensor, in order: counts, then
# thread 0's clock64 cycles by phase and over the whole launch.
STATS = ("jv_frames", "predicted", "updated", "dijkstra_steps", "greedy_rounds",
         "cyc_load", "cyc_predict", "cyc_cost", "cyc_fast_path", "cyc_solve", "cyc_spawn",
         "cyc_update", "cyc_emit", "cyc_total")

# Launch count: one per call that launches the kernel, and one per replay of
# a CUDA graph that holds a launch (runtime/graphs.py count_replayed); nowhere else.
launches = 0
# nvcc's output of the last build (ptxas register / spill report).
build_log = ""

_fn = None


class IdentityState(NamedTuple):
    """The batched step's per-track identity state (T,)."""

    gid: torch.Tensor      # int32 gallery row; −1 = none yet
    sim: torch.Tensor      # float32 similarity at assignment
    unk: torch.Tensor      # int32 consecutive no-match sightings
    pending: torch.Tensor  # bool enrolment flagged, host not yet applied


class IdentityOutputs(NamedTuple):
    """Per-frame identity outputs (B, T)."""

    gid: torch.Tensor      # int32
    sim: torch.Tensor      # float32, 0 where gid < 0
    enroll: torch.Tensor   # bool crossed the unknown trigger (confirmed tracks)
    emb_src: torch.Tensor  # int32 flat detection index of the carried embedding, −1 = carried in


class _Args(ctypes.Structure):
    """``FireScanArgs`` of csrc/track_scan.cu, field for field."""

    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "x", "p", "tid", "age", "tsu", "hits", "streak", "active", "next_id", "boxes", "mask",
        "det_gid", "det_sim", "det_has_emb", "gid", "sim", "unk", "pending", "o_tid", "o_boxes",
        "o_age", "o_mask", "o_src", "o_gid", "o_sim", "o_enroll", "o_emb_src", "stats",
        "scratch")]
        + [("off", ctypes.c_longlong * len(ARRAYS)), ("where", ctypes.c_int * len(ARRAYS))]
        + [(n, ctypes.c_int) for n in (
            "B", "K", "T", "greedy", "max_age", "min_hits", "unknown_trigger", "chunk_frames")]
        + [("q", ctypes.c_float * 10)]
        + [(n, ctypes.c_float) for n in (
            "r_diag", "max_velocity", "max_acceleration", "min_log_area", "min_log_aspect",
            "min_wh", "max_wh", "max_distance", "gate", "similarity_threshold")])


class LaunchPlan(NamedTuple):
    """Where a launch over T tracks and K detection slots keeps each of
    :data:`ARRAYS`: ``where[i]`` is "shared" (dynamic shared memory),
    "scratch" (a device buffer of ``scratch_bytes`` the wrapper
    allocates) or "table" (P and x, updated in the table itself), at byte
    ``offsets[i]`` of its space.  ``chunk_frames`` frames of detections
    are staged at a time, 0 for none (then read where they lie)."""

    threads: int
    shared_bytes: int
    scratch_bytes: int
    chunk_frames: int
    where: Tuple[str, ...]
    offsets: Tuple[int, ...]

    def placed(self, where: str) -> Tuple[str, ...]:
        """The arrays kept at ``where``."""
        return tuple(n for n, w in zip(ARRAYS, self.where) if w == where)

def library_path() -> str:
    return cuda_library_path(SOURCE, f"lib{NAME}", NVCC_FLAGS)


def build() -> str:
    """Compile the kernel for sm_90a unless this source's library
    exists.  Returns the library's path."""
    global build_log
    path, log = build_cuda(SOURCE, f"lib{NAME}", NVCC_FLAGS)
    build_log = log or build_log
    return path


def _kernel():
    global _fn
    if _fn is None:
        fn = ctypes.CDLL(build()).fire_track_scan
        fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _r16(n: int) -> int:
    return -(-n // 16) * 16


def chunk_bytes(f: int, k: int) -> int:
    """One staging buffer: boxes, det_gid, det_sim, mask and det_has_emb
    of ``f`` frames (``chunk_bytes`` in the source)."""
    n = f * k
    return 16 * n + 2 * _r16(4 * n) + 2 * _r16(n)


def _array_bytes(name: str, t: int, k: int, f: int, where: str) -> int:
    """Bytes of one array at ``where`` (``array_bytes`` in the source)."""
    if name in ("p", "x") and where == "table":
        return 0
    r, c = min(t, k), max(t, k)
    return {"cost": _r16(4 * k * t), "p": _r16(4 * t * PS), "x": _r16(4 * t * XS),
            "tracks": _r16(16 * t + 4 * t * N_TRACK_FIELDS), "dets": _r16(44 * k),
            "lap": _r16(4 * (2 * r + 5 * c + (c + 31) // 32 + 2 * k)),
            "chunks": 2 * chunk_bytes(f, k) if f > 0 else 0}[name]


@functools.lru_cache(maxsize=64)
def launch_plan(t: int, k: int) -> LaunchPlan:
    """The launch over T tracks and K detection slots.  Every array stays
    in shared memory where they all fit with the smallest staging chunk
    (the frames whose K detection bytes make a multiple of 16); else the
    arrays leave it in :data:`SPILL_ORDER` (P and x into the table, the
    rest into scratch) until the others fit; then the chunk grows to
    :data:`MAX_CHUNK_FRAMES` within what is left.  Raises ValueError for
    T or K below 1 only.  Pure (it touches no device), and cached: the
    per-frame path asks for the same plan every frame."""
    if t < 1 or k < 1:
        raise ValueError(f"track_scan: T={t} and K={k} must be at least 1")
    step = 16 // math.gcd(k, 16)
    spilled = []

    def where(name):
        if name not in spilled:
            return "shared"
        return "table" if name in ("p", "x") else "scratch"

    def shared(f):
        return MISC_BYTES + sum(_array_bytes(n, t, k, f, "shared") for n in ARRAYS
                                if where(n) == "shared")

    frames = step
    for name in SPILL_ORDER:
        if shared(frames) <= MAX_SHARED_BYTES:
            break
        spilled.append(name)
    if shared(frames) > MAX_SHARED_BYTES:
        frames = 0
    while 0 < frames + step <= MAX_CHUNK_FRAMES and shared(frames + step) <= MAX_SHARED_BYTES:
        frames += step
    ends = {"shared": MISC_BYTES, "scratch": 0, "table": 0}
    offsets = []
    for name in ARRAYS:
        w = where(name)
        offsets.append(ends[w])
        ends[w] += _array_bytes(name, t, k, frames, w)
    warps = min(MAX_WARPS, max(1, -(-max(t, k) // 8)))
    return LaunchPlan(32 * warps, ends["shared"], ends["scratch"], frames,
                      tuple(where(n) for n in ARRAYS), tuple(offsets))


# ------------------------------------------------------------ plain version --


def sort_scan_plain(table: TrackTable, boxes: torch.Tensor, mask: torch.Tensor,
                    cfg: TrackerConfig) -> Tuple[TrackTable, TrackOutputs]:
    """``sort_step`` frame by frame: the new table and the stacked
    per-frame outputs.  Pure."""
    outs = []
    for f in range(boxes.shape[0]):
        table, out = sort_step(table, boxes[f], mask[f], cfg)
        outs.append(out)
    return table, TrackOutputs(*(torch.stack(x) for x in zip(*outs)))


def track_scan_plain(table: TrackTable, ident: IdentityState, boxes: torch.Tensor,
                     mask: torch.Tensor, det_gid: torch.Tensor, det_sim: torch.Tensor,
                     det_has_emb: torch.Tensor, cfg: TrackerConfig, similarity_threshold: float,
                     unknown_trigger: int
                     ) -> Tuple[TrackTable, IdentityState, TrackOutputs, IdentityOutputs]:
    """The batched step's scan (``batch_engine.py:131``): ``sort_step``
    per frame with the identity bookkeeping.  Pure."""
    t_cap, k = table.x.shape[0], boxes.shape[1]
    dev = boxes.device
    minus1 = torch.full((t_cap,), -1, dtype=torch.int32, device=dev)
    zero_f = torch.zeros(t_cap, dtype=torch.float32, device=dev)
    gid, sim, unk, pending = ident
    emb_src = minus1
    outs, iouts = [], []
    for f in range(boxes.shape[0]):
        new, out = sort_step(table, boxes[f], mask[f], cfg)
        has_det = (out.src_det >= 0) & new.active
        dft = torch.clamp(out.src_det, 0, k - 1).long()
        has_emb = has_det & det_has_emb[f][dft]
        tgid = torch.where(has_det, det_gid[f][dft], minus1)
        tsim = torch.where(has_det, det_sim[f][dft], zero_f)
        emb_src = torch.where(has_emb, (f * k + dft).to(torch.int32), emb_src)

        fresh = new.tid != table.tid
        gid = torch.where(fresh, minus1, gid)
        sim = torch.where(fresh, zero_f, sim)
        unk = torch.where(fresh, torch.zeros_like(unk), unk)
        pending = pending & ~fresh

        take = has_det & (tsim > similarity_threshold) & (gid < 0)
        gid = torch.where(take, tgid, gid)
        sim = torch.where(take, tsim, sim)
        pending = pending & (gid < 0)

        sighted = has_emb & (gid < 0) & out.mask
        unk = torch.where(sighted, unk + 1, unk)
        enroll = sighted & (unk >= unknown_trigger) & ~pending
        pending = pending | enroll

        table = new
        outs.append(out)
        iouts.append((gid, torch.where(gid >= 0, sim, zero_f), enroll & out.mask, emb_src))
    return (table, IdentityState(gid, sim, unk, pending),
            TrackOutputs(*(torch.stack(x) for x in zip(*outs))),
            IdentityOutputs(*(torch.stack(x) for x in zip(*iouts))))


def gather_emb(emb_src: torch.Tensor, det_emb: torch.Tensor, last_emb: torch.Tensor,
               slot: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The embeddings ``emb_src`` names: row ``i`` of ``det_emb``
    flattened to (B·K, D) where ``i >= 0``, else the carried-in
    ``last_emb[slot]`` (``slot`` defaults to the position on the last
    axis of ``emb_src``, (…, T)).  One gather; reads nothing back."""
    flat = det_emb.reshape(-1, det_emb.shape[-1])
    if slot is None:
        slot = torch.arange(emb_src.shape[-1], device=emb_src.device).expand(emb_src.shape)
    src = emb_src.long()
    return torch.where((src >= 0)[..., None], flat[src.clamp(min=0)], last_emb[slot])


# ------------------------------------------------------------------ wrapper --


_TABLE_TYPES = (torch.float32, torch.float32) + (torch.int32,) * 5 + (torch.bool, torch.int32)
_IDENT_TYPES = (torch.int32, torch.float32, torch.int32, torch.bool)


def _check(name: str, x: torch.Tensor, dtype, shape, device) -> None:
    if x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(f"track_scan: {name} is {x.dtype} {tuple(x.shape)}, "
                         f"needs {dtype} {tuple(shape)}")
    if x.device != device:
        raise ValueError(f"track_scan: {name} is on {x.device}, the boxes on {device}")
    if not x.is_contiguous():
        raise ValueError(f"track_scan: {name} is not contiguous")


def _check_args(table: TrackTable, boxes, mask, ident=None, det=None) -> None:
    if boxes.dim() != 3 or boxes.shape[2] != 4 or boxes.shape[0] < 1:
        raise ValueError(f"track_scan: boxes {tuple(boxes.shape)} must be (B, K, 4), B >= 1")
    b, k, _ = boxes.shape
    t = table.x.shape[0]
    dev = boxes.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"track_scan: tensors on {dev}; the CPU or a CUDA device")
    _check("boxes", boxes, torch.float32, (b, k, 4), dev)
    _check("mask", mask, torch.bool, (b, k), dev)
    shapes = ((t, 10), (t, 10, 10)) + ((t,),) * 6 + ((),)
    for name, x, dt, shp in zip(TrackTable._fields, table, _TABLE_TYPES, shapes):
        _check(f"table.{name}", x, dt, shp, dev)
    if ident is not None:
        for name, x, dt in zip(IdentityState._fields, ident, _IDENT_TYPES):
            _check(name, x, dt, (t,), dev)
        for name, x, dt in zip(("det_gid", "det_sim", "det_has_emb"), det,
                               (torch.int32, torch.float32, torch.bool)):
            _check(name, x, dt, (b, k), dev)


def _launch(table: TrackTable, boxes, mask, cfg: TrackerConfig, ident=None, det=None,
            similarity_threshold: float = 0.0, unknown_trigger: int = 0,
            stats: Optional[torch.Tensor] = None):
    global launches
    b, k, t = boxes.shape[0], boxes.shape[1], table.x.shape[0]
    plan = launch_plan(t, k)
    dev = boxes.device
    if plan.chunk_frames:
        # the bulk copies read from 16-byte boundaries: a view that starts
        # elsewhere is copied once
        boxes, mask = _aligned(boxes), _aligned(mask)
        det = None if det is None else tuple(_aligned(x) for x in det)
    scratch = (torch.empty(plan.scratch_bytes, dtype=torch.uint8, device=dev)
               if plan.scratch_bytes else None)
    i32 = dict(dtype=torch.int32, device=dev)
    out = TrackOutputs(torch.empty((b, t), **i32), torch.empty((b, t, 4), **i32),
                       torch.empty((b, t), **i32),
                       torch.empty((b, t), dtype=torch.bool, device=dev),
                       torch.empty((b, t), **i32))
    iout = None
    a = _Args(B=b, K=k, T=t, greedy=int(cfg.assignment == "greedy"), max_age=cfg.max_age,
              min_hits=cfg.min_hits, unknown_trigger=int(unknown_trigger),
              r_diag=cfg.r_diag, max_velocity=cfg.max_velocity,
              max_acceleration=cfg.max_acceleration, min_log_area=cfg.min_log_area,
              min_log_aspect=cfg.min_log_aspect, min_wh=cfg.min_wh, max_wh=cfg.max_wh,
              max_distance=cfg.max_distance, gate=(1.0 - cfg.iou_threshold) + 1.0,
              similarity_threshold=float(similarity_threshold),
              chunk_frames=plan.chunk_frames)
    a.off[:] = plan.offsets
    a.where[:] = [_WHERE[w] for w in plan.where]
    if scratch is not None:
        a.scratch = scratch.data_ptr()
    a.q[:] = [cfg.q_pos, cfg.q_pos, cfg.q_acc, cfg.q_acc, cfg.q_vel, cfg.q_vel,
              cfg.q_acc, cfg.q_acc, cfg.q_acc, cfg.q_acc]
    for name, x in zip(TrackTable._fields, table):
        setattr(a, name, x.data_ptr())
    a.boxes, a.mask = boxes.data_ptr(), mask.data_ptr()
    for name, x in zip(("o_tid", "o_boxes", "o_age", "o_mask", "o_src"), out):
        setattr(a, name, x.data_ptr())
    if ident is not None:
        iout = IdentityOutputs(torch.empty((b, t), **i32),
                               torch.empty((b, t), dtype=torch.float32, device=dev),
                               torch.empty((b, t), dtype=torch.bool, device=dev),
                               torch.empty((b, t), **i32))
        for name, x in zip(IdentityState._fields, ident):
            setattr(a, name, x.data_ptr())
        for name, x in zip(("det_gid", "det_sim", "det_has_emb"), det):
            setattr(a, name, x.data_ptr())
        for name, x in zip(("o_gid", "o_sim", "o_enroll", "o_emb_src"), iout):
            setattr(a, name, x.data_ptr())
    if stats is not None:
        _check("stats", stats, torch.int64, (len(STATS),), dev)
        a.stats = stats.data_ptr()
    fn = _kernel()
    other = dev.index != torch.cuda.current_device()  # the launch goes to the current device
    with torch.cuda.device(dev) if other else contextlib.nullcontext():
        err = fn(ctypes.byref(a), plan.threads, plan.shared_bytes, plan.scratch_bytes,
                 raw_stream(dev.index))
    if err != 0:
        raise RuntimeError(f"track_scan kernel launch failed: code {err} (a cudaError_t, or "
                           f"the kernel's own above 20000) at B={b}, K={k}, T={t}")
    launches += 1
    return out, iout


def _aligned(x: torch.Tensor) -> torch.Tensor:
    return x if x.data_ptr() % 16 == 0 else x.clone()


def sort_scan(table: TrackTable, boxes: torch.Tensor, mask: torch.Tensor, cfg: TrackerConfig,
              stats: Optional[torch.Tensor] = None) -> Tuple[TrackTable, TrackOutputs]:
    """``sort_step`` over the B frames of ``boxes`` (B, K, 4) float32 and
    ``mask`` (B, K) bool: the table, updated in place, and the per-frame
    outputs (B, T).

    CPU tensors → :func:`sort_scan_plain`.  CUDA tensors → one launch
    of the kernel on the current stream, or an exception.  ``stats``
    ((14,) int64 on the card) gets the launch's work counts and cycles
    (:data:`STATS`) added to it; the kernel alone counts them."""
    _check_args(table, boxes, mask)
    if boxes.device.type == "cpu":
        if stats is not None:
            raise ValueError("track_scan: stats are counted by the kernel, on a CUDA device")
        new, out = sort_scan_plain(table, boxes, mask, cfg)
        copy_into(table, new)
        return table, out
    out, _ = _launch(table, boxes, mask, cfg, stats=stats)
    return table, out


def track_scan(table: TrackTable, ident: IdentityState, boxes: torch.Tensor, mask: torch.Tensor,
               det_gid: torch.Tensor, det_sim: torch.Tensor, det_has_emb: torch.Tensor,
               cfg: TrackerConfig, similarity_threshold: float, unknown_trigger: int,
               stats: Optional[torch.Tensor] = None
               ) -> Tuple[TrackTable, IdentityState, TrackOutputs, IdentityOutputs]:
    """:func:`sort_scan` with the batched step's identity bookkeeping:
    ``det_gid`` (B, K) int32, ``det_sim`` float32 and ``det_has_emb``
    bool per detection.  The table and ``ident`` are updated in place;
    returns them with the per-frame track and identity outputs."""
    det = (det_gid, det_sim, det_has_emb)
    _check_args(table, boxes, mask, ident, det)
    if boxes.device.type == "cpu":
        if stats is not None:
            raise ValueError("track_scan: stats are counted by the kernel, on a CUDA device")
        new, new_ident, out, iout = track_scan_plain(table, ident, boxes, mask, *det, cfg,
                                                     similarity_threshold, unknown_trigger)
        copy_into(table, new)
        copy_into(ident, new_ident)
        return table, ident, out, iout
    out, iout = _launch(table, boxes, mask, cfg, ident, det, similarity_threshold,
                        unknown_trigger, stats)
    return table, ident, out, iout


def reset_launches() -> None:
    global launches
    launches = 0
