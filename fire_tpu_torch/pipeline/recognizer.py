"""FaceRecognition orchestrator, batched video path (counterpart of
``fire_tpu.pipeline.recognizer.FaceRecognition`` in the subset that
``process_frames(..., batch_size > 0)`` needs: storage layout, SQLite
hydrate, enrollment, relabel, the batched stream loop and ``close``).

Not ported yet, and raising ``NotImplementedError`` when asked for
(ROADMAP.md, PyTorch/CUDA port queue): the per-frame path and image
mode, annotation / video writing / ``show``, landmark alignment,
encryption, the ONNX weight probe of ``weights_dir``, multi-stream and
the sharded gallery.
"""

from __future__ import annotations

import logging
import os
import time
import uuid
from typing import Callable, List, Optional

import numpy as np

from fire_tpu_torch.config import EngineConfig, GalleryConfig, RecognizerConfig, TrackerConfig
from fire_tpu_torch.device import DeviceLike
from fire_tpu_torch.gallery.index import DeviceGallery
from fire_tpu_torch.gallery.store import FaceStore
from fire_tpu_torch.pipeline.engine import DeviceEngine
from fire_tpu_torch.pipeline.stream import FrameSequenceCapture, PrefetchReader
from fire_tpu_torch.pipeline.timing import StageTimer

log = logging.getLogger(__name__)

_NOT_PORTED = "not ported yet (ROADMAP.md, PyTorch/CUDA port queue)"
ENCRYPTION_TODO = ("encryption_password: encryption is not ported yet (ROADMAP.md, "
                   "PyTorch/CUDA port queue: 'gallery/crypto.py')")


class FaceRecognition:
    def __init__(
        self,
        detector_type: str = "yunet",
        align: bool = True,
        align_video: bool = False,
        encoder_model_type: str = "128",
        encoder_mode: str = "gpu_optimized",
        similarity_threshold: float = 0.5,
        unknown_similarity_threshold: float = 0.6,
        unknown_trigger_count: int = 3,
        enable_logging: bool = True,
        show: bool = False,
        detection_interval: int = 3,
        hnsw_index_path: Optional[str] = None,
        hnsw_labels_path: Optional[str] = None,
        hnsw_db_ids_path: Optional[str] = None,
        max_recent: int = 200,
        max_new: int = 250,
        sqlite_db_path: Optional[str] = None,
        encryption_password: Optional[str] = None,
        interested_label: Optional[str] = None,
        storage_root: str = "storage",
        engine: Optional[DeviceEngine] = None,
        tracker_cfg: Optional[TrackerConfig] = None,
        trained_encoder: Optional[str] = None,
        trained_detector: Optional[str] = None,
        engine_cfg: Optional[EngineConfig] = None,
        encode_budget: Optional[int] = None,
        device: DeviceLike = None,
    ):
        if encryption_password:
            raise NotImplementedError(ENCRYPTION_TODO)
        if show:
            raise NotImplementedError(f"show=True: display is {_NOT_PORTED}")
        if align_video:
            raise NotImplementedError(f"align_video=True: alignment is {_NOT_PORTED}")
        encoder_model_type = encoder_model_type or "128"
        self.cfg = RecognizerConfig(
            detector_type=detector_type.lower(),
            align=align,
            encoder_model_type=encoder_model_type,
            encoder_mode=encoder_mode,
            similarity_threshold=similarity_threshold,
            unknown_similarity_threshold=unknown_similarity_threshold,
            unknown_trigger_count=unknown_trigger_count,
            enable_logging=enable_logging,
            detection_interval=detection_interval,
            encode_budget=encode_budget,
            interested_label=interested_label,
            storage_root=storage_root,
            weights_dir=None,
            gallery=GalleryConfig(max_recent=max_recent, max_new=max_new),
            engine=engine_cfg or EngineConfig(),
        ).with_embedding_dim()
        cfg = self.cfg
        self.similarity_threshold = similarity_threshold
        self.unknown_trigger_count = unknown_trigger_count
        self.detection_interval = detection_interval
        self.enable_logging = enable_logging
        self.interested_label = interested_label
        self.embedding_dim = cfg.embedding_dim
        self.tracker_cfg = tracker_cfg or TrackerConfig()

        # storage layout: storage/<detector>_<encoder>_unencrypted/{db,hnsw}
        pipeline_dir = os.path.join(storage_root, f"{cfg.detector_type}_{encoder_model_type}_unencrypted")
        db_dir = os.path.join(pipeline_dir, "db")
        hnsw_dir = os.path.join(pipeline_dir, "hnsw")
        os.makedirs(db_dir, exist_ok=True)
        os.makedirs(hnsw_dir, exist_ok=True)
        stem = f"{cfg.detector_type}_{encoder_model_type}"
        hnsw_index_path = hnsw_index_path or os.path.join(hnsw_dir, f"hnsw_index_{stem}.bin")
        hnsw_labels_path = hnsw_labels_path or os.path.join(hnsw_dir, f"hnsw_labels_{stem}.pkl")
        hnsw_db_ids_path = hnsw_db_ids_path or os.path.join(hnsw_dir, f"hnsw_db_ids_{stem}.pkl")
        sqlite_db_path = sqlite_db_path or os.path.join(db_dir, f"face_embeddings_{stem}.db")

        self.engine = engine or DeviceEngine(cfg, device=device)
        if trained_encoder:
            self.engine.load_trained_encoder(trained_encoder)
        if trained_detector:
            self.engine.load_trained_detector(trained_detector)
        self.device = self.engine.device

        self.db_manager = FaceStore(sqlite_db_path, embedding_dim=self.embedding_dim)
        self.gallery = DeviceGallery(
            self.embedding_dim, hnsw_index_path, hnsw_labels_path, hnsw_db_ids_path,
            capacity=cfg.gallery.capacity, strict_f32_match=cfg.engine.strict_f32_match,
            device=self.device,
        )
        # cold-start hydrate from SQLite
        if self.gallery.count == 0:
            self.gallery.load_rows(self.db_manager.load_all())
            self.gallery.save()

        # host-side window of recent enrollments: covers gallery rows
        # added after a batched step's device snapshot
        self._recent_enrollments: list = []
        self.timer = StageTimer()
        self.counters = {"faces_detected": 0, "unknown_enrolled": 0}

    # ---------------------------------------------------------- enrollment --

    @staticmethod
    def _generate_unique_label() -> str:
        return f"Unknown_{uuid.uuid4().hex[:8]}"

    def _enroll_now(self, label: str, emb: np.ndarray) -> None:
        if self.gallery.count < self.gallery.capacity:
            db_id = self.db_manager.add(label, emb)
            if db_id != -1 and self.gallery.add(emb, label, db_id):
                vec = np.asarray(emb, np.float32).reshape(-1)
                n = np.linalg.norm(vec)
                self._recent_enrollments.append((vec / n if n > 0 else vec, self.gallery.count - 1))
                del self._recent_enrollments[:-64]
                self.counters["unknown_enrolled"] += 1
        else:
            log.warning("Gallery has reached its maximum capacity. Cannot add more embeddings.")

    def enroll_unknown_now(self, emb: np.ndarray, rename_label: Optional[str] = None,
                           device_checked: bool = False) -> str:
        """Immediate enrollment for the batched path: dedup, then enroll
        under ``rename_label`` or a fresh ``Unknown_*`` label.
        ``device_checked`` skips the gallery query: the batched step
        already compared the embedding against its gallery snapshot, so
        only rows enrolled since (the recent window) are checked."""
        if rename_label:
            self._enroll_now(rename_label, emb)
            self.gallery.save()
            return rename_label
        if device_checked:
            for vec, gid in self._recent_enrollments:
                if float(vec @ emb) > self.similarity_threshold and gid < self.gallery.count:
                    return self.gallery.labels[gid]
        elif self.gallery.count > 0:
            ids, dists = self.gallery.query(emb, k=1)
            if ids is not None and 1.0 - dists[0][0] > self.similarity_threshold:
                return self.gallery.labels[int(ids[0][0])]
        label = self._generate_unique_label()
        self._enroll_now(label, emb)
        self.gallery.save()
        return label

    def update_label(self, gallery_id: int, new_label: str) -> None:
        self.gallery.update_label(gallery_id, new_label, self.db_manager,
                                  similarity_threshold=self.similarity_threshold)

    # -------------------------------------------------------- stream modes --

    def process_frames(
        self,
        frames,
        annotate: bool = True,
        save_path: Optional[str] = None,
        batch_size: int = 0,
        duration: int = 0,
        name: Optional[str] = None,
        fps: float = 30.0,
        on_frame: Optional[Callable[[np.ndarray, List[dict]], None]] = None,
    ) -> None:
        """Run the batched video pipeline over in-RAM BGR uint8 frames.
        ``on_frame(frame, faces)`` receives each frame's
        ``[{'label','confidence','bbox'}]`` list (the JAX package hands
        them to annotation and the video writer, not ported yet)."""
        if batch_size <= 0:
            raise NotImplementedError(f"batch_size=0: the per-frame path is {_NOT_PORTED}")
        if annotate or save_path:
            raise NotImplementedError(
                f"annotate/save_path: annotation and video writing are {_NOT_PORTED}; "
                "pass annotate=False")
        cap = FrameSequenceCapture(frames, fps=fps)
        if not cap.isOpened():
            log.error("process_frames received no frames.")
            return
        self._process_stream_batched(cap, batch_size, duration, name, on_frame)

    def _process_stream_batched(self, cap, batch_size: int, duration: int = 0,
                                name: Optional[str] = None, on_frame=None) -> None:
        """Batched loop with one batch in flight: batch i+1 is submitted
        before batch i is collected."""
        from fire_tpu_torch.pipeline.batch_engine import BatchStreamEngine, stream_results

        interval = max(self.detection_interval, 1)
        if batch_size % interval != 0:
            rounded = ((batch_size + interval - 1) // interval) * interval
            log.warning("batch_size %d is not a multiple of detection_interval %d; "
                        "rounding batch up to %d.", batch_size, interval, rounded)
            batch_size = rounded
        self.timer = StageTimer()
        self.timer.start()
        bse = BatchStreamEngine(self.engine, self.gallery, self.cfg,
                                tracker_cfg=self.tracker_cfg, detection_interval=interval,
                                encode_budget=self.cfg.encode_budget, timer=self.timer)
        reader = PrefetchReader(cap)

        def emit(token, frames) -> bool:
            t0 = time.perf_counter()
            res = bse.collect(token)
            self.timer.add("readback (wait + D2H)", time.perf_counter() - t0)
            self.counters["faces_detected"] += int(res.mask[: len(frames)].sum())
            t0 = time.perf_counter()
            labelled = list(stream_results(self, res, rename_label=name))
            self.timer.add("host stream_results", time.perf_counter() - t0)
            for frame, faces in zip(frames, labelled):
                self.timer.tick_frame()
                if on_frame is not None:
                    on_frame(frame, faces)
            if duration > 0 and (time.time() - self.timer.start_time) >= duration:
                log.info("Duration of %d seconds reached. Stopping.", duration)
                return False
            return True

        inflight = None
        try:
            batch = []
            stopped = False
            frame_iter = reader.frames()
            while True:
                t0 = time.perf_counter()
                frame = next(frame_iter, None)
                self.timer.add("read (prefetch stall)", time.perf_counter() - t0)
                if frame is None:
                    break
                batch.append(frame)
                if len(batch) == batch_size:
                    t0 = time.perf_counter()
                    stacked = np.stack(batch)
                    t1 = time.perf_counter()
                    token = bse.submit(stacked)
                    self.timer.add("stack (host)", t1 - t0)
                    self.timer.add("submit (H2D + step)", time.perf_counter() - t1)
                    prev, inflight = inflight, (token, batch)
                    batch = []
                    if prev is not None and not emit(*prev):
                        stopped = True
                        break
            if not stopped and batch:
                # tail: pad by repeating the last frame; drop pad outputs
                pad = batch + [batch[-1]] * (batch_size - len(batch))
                token = bse.submit(np.stack(pad))
                if inflight is not None:
                    stopped = not emit(*inflight)
                inflight = (token, batch)
            if not stopped and inflight is not None:
                emit(*inflight)
        finally:
            reader.close()
            cap.release()

    # -------------------------------------------------------------- close --

    def close(self) -> None:
        """Persist the gallery snapshot and the SQLite store."""
        try:
            self.gallery.save(compact=True)
            self.db_manager.save()
        except Exception as e:
            log.error("Error closing FaceRecognition system: %s", e)
        if self.enable_logging:
            self.timer.log_stream_report()
            log.info("Counters: %s; gallery size: %d", self.counters, self.gallery.count)
