"""Drives the system under test: builds the recognizer of a
configuration, warms up every shape the cell's traffic uses, runs the
measured window, and records what the timed path hands back.

The program is reached only through its public entry points
(``FaceRecognition``, ``recognize_faces``, ``process_frames``) and the
public calls they make.  :class:`Recorder` wraps five of those calls
(detection, the box encoder, the gallery's batched top-1, the batched
engine's ``submit`` / ``collect``) and the gallery's ``add``: during the
window it keeps host copies of what they return, and of the labels each
frame's entry hands back, for the comparison with the reference after
the window.  Around each call it also opens a
``torch.profiler`` span, so a traced run can say what the host was
doing when the card sat idle.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import os
import shutil
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch


_ACTIVE: list = [None]  # the recorder the wrapped calls report to
SEED_LABEL = "person_"  # the label of the seed's gallery row i is SEED_LABEL + str(i)


class Recorder:
    """Host copies of the timed path's answers, taken while ``on``."""

    def __init__(self):
        self.on = False
        self.frame = -1          # loop index of the frame in progress (per-frame path)
        self.step = -1           # its number in the window
        self.dets: List[tuple] = []      # (frame, boxes (N, 4) int, scores (N,))
        self.encs: List[tuple] = []      # (frame, boxes (K, 4), embeddings (K, D), step)
        self.queries: List[tuple] = []   # (step, ids (K,), sims (K,), rows added before)
        self.added: List[np.ndarray] = []  # unit rows the gallery appended, in order
        self.added_labels: List[str] = []  # their labels
        self.labels: List[tuple] = []    # (frame, [(box xywh, label), ...], rows added by then)
        self.warm_labels: List[tuple] = []  # the same, of the warm-up's pass of the loop
        self.submits: List[int] = []     # rows added before each batched submit
        self.batches: list = []          # BatchResults of each batch collected

    def install(self) -> None:
        """Make this the recorder the program's calls report to, wrapping
        them at the first install in a process."""
        first = _ACTIVE[0] is None
        _ACTIVE[0] = self
        if first:
            _wrap()


class _Current:
    """Attribute access on the active recorder."""

    def __getattr__(self, name):
        return getattr(_ACTIVE[0], name)


def _wrap() -> None:
    """Wrap the program's calls that the recorder reads."""
    from fire_tpu_torch.gallery.index import DeviceGallery, ShardedGalleryView
    from fire_tpu_torch.pipeline import batch_engine
    from fire_tpu_torch.pipeline.engine import DeviceEngine
    from fire_tpu_torch.track.sort import Sort

    rec = _Current()

    def span(name, fn):
        @functools.wraps(fn)
        def inner(*a, **k):
            with torch.profiler.record_function(name):
                return fn(*a, **k)
        return inner

    def detect_faces(orig):
        def f(self, frame):
            out = orig(self, frame)
            if rec.on:
                rec.dets.append((rec.frame,
                                 np.asarray([d["bbox"] for d in out], np.float64).reshape(-1, 4),
                                 np.asarray([d["confidence"] for d in out], np.float64)))
            return out
        return f

    def encode_boxes(orig):
        def f(self, frame, boxes):
            out = orig(self, frame, boxes)
            if rec.on:
                rec.encs.append((rec.frame, np.array(boxes, np.float32), np.array(out),
                                 rec.step))
            return out
        return f

    def query_batch(orig):
        def f(self, embeddings, k=1):
            ids, dists = orig(self, embeddings, k)
            if rec.on and k == 1 and ids is not None:
                rec.queries.append((rec.step, np.array(ids[:, 0]),
                                    1.0 - np.asarray(dists[:, 0], np.float64),
                                    len(rec.added)))
            return ids, dists
        return f

    def add(orig):
        def f(self, embedding, label, db_id):
            ok = orig(self, embedding, label, db_id)
            if ok:
                v = np.asarray(embedding, np.float64).reshape(-1)
                n = np.linalg.norm(v)
                rec.added.append(v / n if n > 0 else v)
                rec.added_labels.append(label)
            return ok
        return f

    def submit(orig):
        def f(self, frames):
            if rec.on:
                rec.submits.append(len(rec.added))
            return orig(self, frames)
        return f

    def collect(orig):
        def f(self, token):
            res = orig(self, token)
            if rec.on:
                rec.batches.append(res)
            return res
        return f

    DeviceEngine.detect_faces = span("detect", detect_faces(DeviceEngine.detect_faces))
    DeviceEngine.encode_boxes = span("encode", encode_boxes(DeviceEngine.encode_boxes))
    for cls in (DeviceGallery, ShardedGalleryView):
        cls.query_batch = span("match", query_batch(cls.query_batch))
    DeviceGallery.add = span("enrol", add(DeviceGallery.add))
    Sort.update = span("tracker", Sort.update)
    bse = batch_engine.BatchStreamEngine
    bse.submit = span("submit", submit(bse.submit))
    bse.collect = span("collect (wait + readback)", collect(bse.collect))
    batch_engine.stream_results = span("stream_results", batch_engine.stream_results)


class ErrorCount(logging.Handler):
    """Counts ERROR records of the program's loggers (a frame whose
    recognition failed is logged and skipped)."""

    def __init__(self):
        super().__init__(logging.ERROR)
        self.n = 0
        self.last = ""

    def emit(self, record):
        self.n += 1
        self.last = record.getMessage()[:300]


def gallery_rows(seed: int, rows: int, dim: int, device) -> np.ndarray:
    """``rows`` unit gallery rows drawn from the seed on ``device``, in
    one call, as host float32."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2**63))
    x = torch.randn((rows, dim), generator=g, device=device, dtype=torch.float32)
    return torch.nn.functional.normalize(x, dim=1).cpu().numpy()


class System:
    """The configuration's ``FaceRecognition`` with its trained weights
    and the seed's gallery, storage in a fresh directory under
    ``TMPDIR`` (the engine's parameter cache in a fixed one beside it)."""

    def __init__(self, cfg: dict, chips: int, seed: int, root: str, device,
                 engine_overrides: Optional[dict] = None):
        from fire_tpu_torch.config import EngineConfig, TrackerConfig
        from fire_tpu_torch.pipeline.recognizer import FaceRecognition

        tmp = tempfile.gettempdir()
        self.store = tempfile.mkdtemp(prefix="fire-bench-", dir=tmp)
        params_root = os.path.join(tmp, "fire-bench-params")
        size_key = "retinaface_size" if cfg["detector"] == "retinaface" else "detect_size"
        eng = dict(max_faces=cfg["max_faces"], compute_dtype=cfg["compute_dtype"],
                   **{size_key: tuple(cfg["input_px"])})
        eng.update(engine_overrides or {})
        paths = {f"{k}_path": os.path.join(self.store, f"{k}.bin")
                 for k in ("hnsw_index", "hnsw_labels", "hnsw_db_ids")}
        self.rec = FaceRecognition(
            detector_type=cfg["detector"], encoder_model_type="512",
            similarity_threshold=cfg["similarity_threshold"],
            unknown_trigger_count=cfg["unknown_trigger_count"],
            detection_interval=cfg["detection_interval"], enable_logging=False,
            storage_root=params_root, weights_dir=None,
            sqlite_db_path=os.path.join(self.store, "faces.db"),
            tracker_cfg=TrackerConfig(max_tracks=cfg["max_tracks"], max_age=cfg["max_age"],
                                      max_distance=cfg["max_distance"],
                                      assignment=cfg["assignment"]),
            engine_cfg=EngineConfig(**eng), sharded_gallery=chips > 1, device=device, **paths)
        self.rec.engine.load_trained_detector(os.path.join(root, cfg["detector_weights"]))
        self.rec.engine.load_trained_encoder(os.path.join(root, cfg["encoder_weights"]))
        self.rows = gallery_rows(seed, cfg["gallery_rows"], 512, device)
        self.rec.gallery.load_rows((i + 1, f"{SEED_LABEL}{i}", r.tobytes())
                                   for i, r in enumerate(self.rows))
        self.rec.gallery.save(compact=True)

    def close(self) -> None:
        """Drop the recognizer (its graphs and pools with it) and the
        run's storage, without writing a final snapshot."""
        self.rec = None
        shutil.rmtree(self.store, ignore_errors=True)


def warm_up(system: System, loop, mix: dict, rec: Recorder) -> None:
    """Every shape the window will use: one pass of the loop through the
    cell's entry (which also enrols the loop's identities; the labels it
    hands back are kept, as the window's are), and for the per-frame
    path each encoder bucket up to the most faces a frame."""
    fr = system.rec
    n = len(loop.frames)

    def keep(i, faces):
        rec.warm_labels.append((i % n, [(f["bbox"], f["label"]) for f in faces],
                                len(rec.added)))

    if mix["mode"] == "batched":
        done = [0]

        def on_frame(_frame, faces):
            keep(done[0], faces)
            done[0] += 1
        fr.process_frames(loop.frames, annotate=False, batch_size=mix["batch_size"],
                          on_frame=on_frame)
        return
    for i, f in enumerate(loop.frames):
        keep(i, fr.recognize_faces(f))
    frame = loop.frames[0]
    h, w = frame.shape[:2]
    for k in range(1, int(loop.faces_per_frame().max()) + 1):
        boxes = np.tile(np.asarray([[w // 4, h // 4, w // 8, h // 8]], np.float32), (k, 1))
        fr.gallery.query_batch(fr.engine.encode_boxes(frame, boxes), k=1)


def _sync_all() -> None:
    if torch.cuda.is_available():
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)


class Tracer:
    """A ``torch.profiler`` run started and stopped inside the window."""

    def __init__(self, enabled: bool):
        self.enabled, self.prof, self.t0, self.t1 = enabled, None, None, None
        self.timer_at_start: Dict[str, float] = {}

    def start(self) -> None:
        if not self.enabled or self.prof is not None:
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        _sync_all()
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        if self.prof is None or self.t1 is not None:
            return
        _sync_all()
        self.t1 = time.perf_counter()
        self.prof.stop()


def window_per_frame(system: System, loop, rec: Recorder, seconds: float, tracer: Tracer,
                     trace_frames: int) -> dict:
    """Closed loop: frame after frame into ``recognize_faces`` for
    ``seconds``; per frame its latency and the timer's stage deltas.
    With tracing, ``trace_frames`` more frames follow the window under
    the profiler."""
    fr = system.rec
    timer = fr.timer
    stages = ("detection", "tracker", "encoding", "match")
    lat, per_stage, loop_idx = [], {s: [] for s in stages}, []
    n_loop = len(loop.frames)
    failed = 0
    rec.on = True
    t0 = time.perf_counter()
    t_end = t0 + seconds
    window = traced_from = None
    i = 0
    while True:
        if window is None and time.perf_counter() >= t_end:
            window = time.perf_counter() - t0
            if not tracer.enabled:
                break
            traced_from = len(lat)
            tracer.start()
        if traced_from is not None and len(lat) >= traced_from + trace_frames:
            break
        idx = i % n_loop
        rec.frame, rec.step = idx, i
        before = dict(timer.totals)
        ts = time.perf_counter()
        try:
            with torch.profiler.record_function("frame"):
                faces = fr.recognize_faces(loop.frames[idx])
        except Exception as e:  # a frame that fails is counted, as the program logs it
            failed += 1
            faces = []
            logging.getLogger("benchmark").error("frame %d failed: %s", i, e)
        lat.append(time.perf_counter() - ts)
        rec.labels.append((idx, [(f["bbox"], f["label"]) for f in faces], len(rec.added)))
        for s in stages:
            per_stage[s].append(timer.totals.get(s, 0.0) - before.get(s, 0.0))
        loop_idx.append(idx)
        i += 1
    tracer.stop()
    rec.on = False
    n = traced_from if traced_from is not None else len(lat)
    return {"window_s": window, "attempted": len(lat), "measured": n,
            "failed": failed, "latency_s": lat[:n],
            "stages_s": {k: v[:n] for k, v in per_stage.items()},
            "loop_idx": loop_idx, "traced_from": traced_from}


def window_batched(system: System, loop, rec: Recorder, seconds: float, batch: int,
                   tracer: Tracer, trace_batches: int) -> dict:
    """Closed loop into ``process_frames(batch_size=batch)``: the loop's
    frames in order, stopped at a batch boundary once ``seconds`` have
    passed; the rate counts the frames whose labels came back by the
    time the last of them did.  With tracing, ``trace_batches`` more
    batches follow under the profiler."""
    fr = system.rec
    n_loop = len(loop.frames)
    state = {"handed": 0, "delivered": 0, "measured": None, "t_measured": None,
             "stamps": []}
    extra = trace_batches * batch if tracer.enabled else 0
    t0 = time.perf_counter()
    t_end = t0 + seconds

    def frames():
        n = 0
        while True:
            if n % batch == 0 and state["measured"] is None and time.perf_counter() >= t_end:
                state["measured"] = n
            if state["measured"] is not None and n >= state["measured"] + extra:
                return
            state["handed"] = n + 1
            yield loop.frames[n % n_loop]
            n += 1

    def on_frame(_frame, faces):
        rec.labels.append((state["delivered"] % n_loop,
                           [(f["bbox"], f["label"]) for f in faces], len(rec.added)))
        state["delivered"] += 1
        if state["delivered"] % batch == 0 and state["t_measured"] is None:
            state["stamps"].append(time.perf_counter())
        if state["delivered"] == state["measured"]:
            state["t_measured"] = time.perf_counter()
            if tracer.enabled:
                fr.timer.resolve()
                tracer.timer_at_start = dict(fr.timer.totals)
                tracer.start()

    rec.on = True
    fr.process_frames(frames(), annotate=False, batch_size=batch, on_frame=on_frame)
    tracer.stop()
    rec.on = False
    fr.timer.resolve()
    totals = tracer.timer_at_start if tracer.prof is not None else dict(fr.timer.totals)
    measured = state["measured"] or state["delivered"]
    t_meas = state["t_measured"] or time.perf_counter()
    return {"window_s": t_meas - t0, "attempted": state["handed"],
            "measured": measured, "failed": state["handed"] - state["delivered"],
            "batch_s": [b - a for a, b in zip([t0] + state["stamps"], state["stamps"])],
            "timer_s": totals, "timed_batches": measured // batch,
            "traced_from": measured if tracer.prof is not None else None,
            "loop_idx": [n % n_loop for n in range(state["delivered"])]}


def memory_peak_bytes() -> int:
    if not torch.cuda.is_available():
        return 0
    return max(torch.cuda.max_memory_allocated(d) for d in range(torch.cuda.device_count()))


@contextlib.contextmanager
def quiet_program_logs(counter: ErrorCount):
    """The program's INFO logs off, its ERROR records counted."""
    lg = logging.getLogger("fire_tpu_torch")
    old = lg.level
    lg.setLevel(logging.WARNING)
    lg.addHandler(counter)
    try:
        yield
    finally:
        lg.removeHandler(counter)
        lg.setLevel(old)
