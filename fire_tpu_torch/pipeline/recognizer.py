"""FaceRecognition orchestrator (counterpart of
``fire_tpu.pipeline.recognizer.FaceRecognition``): storage layout,
SQLite hydrate, the three-tier per-frame matcher (track-label cache →
recent-embedding cache → gallery query), the unknown-face lifecycle,
enrollment with dedup, rename / merge (``shrink_db_ids``), image mode,
the per-frame and the batched stream loops, and ``close``.

Differences from the JAX class, all deliberate:

* every tensor lives on an explicit ``device`` (the engine's);
* files and windows go through :mod:`fire_tpu_torch.utils.imageio`, so
  BMP / PPM images need no OpenCV and anything else imports it at the
  call;
* the timer also records ``tracker`` and ``match`` stages, and the
  per-frame path is timed in nested spans (``frame``, ``upload``,
  ``labels``, each device-to-host wait as ``<stage>.readback``, the
  sharded view's ``match.refresh`` and ``match.shard<s>``), which show
  by name in a ``torch.profiler`` trace (``--profile DIR``);
* an encrypted image save encodes JPEG whatever the path's name, as JAX
  does, when OpenCV is installed; without it a ``.bmp`` or ``.ppm`` path
  is encoded in its own format (one logged warning) and any other name
  raises.

As in JAX, errors are logged and the work goes on: a frame whose
``recognize_faces`` raises gives no faces and the per-frame loop moves to
the next frame, an error that ends the loop is logged, ``process_image``
logs its error and ``add_face`` returns ``False``.  The batched loops
propagate, as JAX's do.  ``unknown_enrolled`` counts the per-frame
path's tracks that ``_handle_unknown_embedding`` gave a label (the
"too similar" label included), as JAX counts it; the batched paths do
not count.

With ``encryption_password`` the storage directory is
``<detector>_<encoder>_encrypted``, the SQLite database, the gallery
files and the saved outputs are encrypted
(:mod:`fire_tpu_torch.gallery.crypto`, the JAX package's format), and a
saved video is written to a temporary file first and encrypted when it
is closed.

Several videos run at once through ``process_videos``: one stream per
device of the ``dp`` axis of ``self.mesh``
(:class:`fire_tpu_torch.parallel.multistream.MultiStreamEngine`); a mesh
of one card repeated S times runs S streams on it.  With
``sharded_gallery`` the identity queries go through a row-sharded view
of the gallery (:class:`fire_tpu_torch.gallery.index.ShardedGalleryView`).
"""

from __future__ import annotations

import functools
import logging
import os
import tempfile
import time
import uuid
from typing import Callable, List, Optional

import numpy as np
import torch

from fire_tpu_torch.config import EngineConfig, GalleryConfig, RecognizerConfig, TrackerConfig
from fire_tpu_torch.device import DeviceLike
from fire_tpu_torch.gallery.crypto import Encryptor
from fire_tpu_torch.gallery.index import DeviceGallery, ShardedGalleryView
from fire_tpu_torch.gallery.store import FaceStore
from fire_tpu_torch.parallel.mesh import make_mesh
from fire_tpu_torch.pipeline.annotate import annotate_faces, resize_frame_to_screen
from fire_tpu_torch.pipeline.engine import DeviceEngine
from fire_tpu_torch.pipeline.stream import (CAP_PROP_FPS, CAP_PROP_FRAME_HEIGHT,
                                            CAP_PROP_FRAME_WIDTH, FrameSequenceCapture,
                                            PrefetchReader)
from fire_tpu_torch.pipeline.timing import StageTimer
from fire_tpu_torch.runtime import graphs
from fire_tpu_torch.track.sort import Sort
from fire_tpu_torch.utils import imageio

log = logging.getLogger(__name__)

OnFrame = Optional[Callable[[np.ndarray, List[dict]], None]]


@functools.lru_cache(maxsize=None)
def _warn_not_jpeg(ext: str) -> None:
    log.warning("OpenCV (cv2) is not installed: encrypted image saves hold %s bytes, not the "
                "JPEG bytes the JAX package writes.", ext.lstrip(".").upper())


def _ensure_parent_dir(path: str) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)


class _StreamSink:
    """What both stream loops do with a finished frame: annotate, show,
    write to the video file, hand to ``on_frame``.  ``emit`` returns
    False when the user asked to quit."""

    def __init__(self, cap, annotate: bool, save_path: Optional[str], show: bool,
                 stream_type: str, on_frame: OnFrame, timer: StageTimer,
                 encryptor: Optional[Encryptor] = None, title: Optional[str] = None):
        self.annotate, self.show, self.on_frame, self.timer = annotate, show, on_frame, timer
        self.title = title or f"Face Recognition - {stream_type.capitalize()}"
        self.stream_type = stream_type
        self.save_path = save_path
        self.encryptor = encryptor
        self.temp_path = None  # the plain video, encrypted into save_path at close
        self.writer = None
        if save_path:
            _ensure_parent_dir(save_path)
            fps = cap.get(CAP_PROP_FPS) or 30
            wh = (int(cap.get(CAP_PROP_FRAME_WIDTH)), int(cap.get(CAP_PROP_FRAME_HEIGHT)))
            target = save_path
            if encryptor:
                fd, self.temp_path = tempfile.mkstemp(suffix=".avi")
                os.close(fd)
                target = self.temp_path
            self.writer = imageio.open_video_writer(target, fps, wh)
            if not self.writer.isOpened():
                if self.temp_path is not None:
                    os.remove(self.temp_path)
                raise OSError(f"Failed to open video writer for {target}")

    def emit(self, frame: np.ndarray, faces: List[dict]) -> bool:
        if self.on_frame is not None:
            self.on_frame(frame, faces)
        if not self.show and self.writer is None:
            return True
        t0 = time.perf_counter()
        out = annotate_faces(frame, faces, with_confidence=True) if self.annotate else frame
        self.timer.add("host annotate", time.perf_counter() - t0)
        if self.show:
            if imageio.imshow(self.title, resize_frame_to_screen(out), 1) == ord("q"):
                log.info("User requested to quit %s processing.", self.stream_type)
                return False
        if self.writer is not None:
            t0 = time.perf_counter()
            self.writer.write(out)
            self.timer.add("host writer.write", time.perf_counter() - t0)
        return True

    def close(self) -> None:
        if self.writer is not None:
            self.writer.release()
            if self.temp_path is not None:
                try:
                    with open(self.temp_path, "rb") as f:
                        self.encryptor.encrypt_and_write(self.save_path, f.read())
                finally:
                    os.remove(self.temp_path)
                log.info("Encrypted video saved to %s", self.save_path)
            else:
                log.info("Annotated video saved to %s", self.save_path)
        if self.show:
            imageio.destroy_windows()


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
        sqlite_db_encrypted_path: Optional[str] = None,
        encryption_password: Optional[str] = None,
        interested_label: Optional[str] = None,
        storage_root: str = "storage",
        engine: Optional[DeviceEngine] = None,
        tracker_cfg: Optional[TrackerConfig] = None,
        weights_dir: Optional[str] = "weights",
        trained_encoder: Optional[str] = None,
        trained_detector: Optional[str] = None,
        engine_cfg: Optional[EngineConfig] = None,
        encode_budget: Optional[int] = None,
        sharded_gallery: Optional[bool] = None,
        device: DeviceLike = None,
    ):
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
            show=show,
            detection_interval=detection_interval,
            encode_budget=encode_budget,
            encryption_password=encryption_password,
            interested_label=interested_label,
            storage_root=storage_root,
            weights_dir=weights_dir,
            gallery=GalleryConfig(max_recent=max_recent, max_new=max_new),
            engine=engine_cfg or EngineConfig(),
        ).with_embedding_dim()
        cfg = self.cfg
        self.similarity_threshold = similarity_threshold
        self.unknown_similarity_threshold = unknown_similarity_threshold
        self.unknown_trigger_count = unknown_trigger_count
        self.detection_interval = detection_interval
        self.align = align
        # landmark-aligned crops in the video loop too (off = the raw
        # track-box crop)
        self.align_video = align_video
        self.show = show
        self.enable_logging = enable_logging
        self.interested_label = interested_label
        self.embedding_dim = cfg.embedding_dim
        self.tracker_cfg = tracker_cfg or TrackerConfig()
        self.frame_index = 0

        self.encryption_password = encryption_password
        self.encryptor = Encryptor(encryption_password) if encryption_password else None
        status = "encrypted" if encryption_password else "unencrypted"
        log.info("Encryption is %s.",
                 "enabled for file operations" if self.encryptor else "disabled")

        # storage layout: storage/<detector>_<encoder>_<status>/{db,hnsw,params}
        pipeline_dir = os.path.join(storage_root,
                                    f"{cfg.detector_type}_{encoder_model_type}_{status}")
        db_dir = os.path.join(pipeline_dir, "db")
        hnsw_dir = os.path.join(pipeline_dir, "hnsw")
        os.makedirs(db_dir, exist_ok=True)
        os.makedirs(hnsw_dir, exist_ok=True)
        stem = f"{cfg.detector_type}_{encoder_model_type}"
        hnsw_index_path = hnsw_index_path or os.path.join(hnsw_dir, f"hnsw_index_{stem}.bin")
        hnsw_labels_path = hnsw_labels_path or os.path.join(hnsw_dir, f"hnsw_labels_{stem}.pkl")
        hnsw_db_ids_path = hnsw_db_ids_path or os.path.join(hnsw_dir, f"hnsw_db_ids_{stem}.pkl")
        if encryption_password:
            sqlite_db_encrypted_path = sqlite_db_encrypted_path or os.path.join(
                db_dir, f"face_embeddings_{stem}.db.enc")
            sqlite_db_path = None
        else:
            sqlite_db_path = sqlite_db_path or os.path.join(db_dir, f"face_embeddings_{stem}.db")
            sqlite_db_encrypted_path = None

        # an engine given by the caller stays the caller's, graphs and all
        self._owns_engine = engine is None
        self.engine = engine or DeviceEngine(cfg, device=device,
                                             params_dir=os.path.join(pipeline_dir, "params"))
        if trained_encoder:
            self.engine.load_trained_encoder(trained_encoder)
        if trained_detector:
            self.engine.load_trained_detector(trained_detector)
        self.device = self.engine.device
        self.detect_faces = self.engine.detect_faces
        self.extract_faces = self.engine.extract_faces

        self.db_manager = FaceStore(sqlite_db_path, sqlite_db_encrypted_path, self.encryptor,
                                    self.embedding_dim)
        self.gallery = DeviceGallery(
            self.embedding_dim, hnsw_index_path, hnsw_labels_path, hnsw_db_ids_path,
            self.encryptor, capacity=cfg.gallery.capacity, strict_f32_match=cfg.engine.strict_f32_match,
            device=self.device,
        )
        # cold-start hydrate from SQLite
        if self.gallery.count == 0:
            self.gallery.load_rows(self.db_manager.load_all())
            self.gallery.save()

        # identity queries through a row-sharded view of the gallery:
        # adopted by default when more than one card is present; True
        # forces it (a mesh of the engine's device when that is not a card)
        self.mesh = None
        self._matcher = self.gallery
        use_sharded = sharded_gallery
        if use_sharded is None:
            use_sharded = self.device.type == "cuda" and torch.cuda.device_count() > 1
        if use_sharded:
            self.mesh = self._default_mesh()
            self._matcher = ShardedGalleryView(self.gallery, self.mesh)
            log.info("Sharded gallery view active over %d device(s).",
                     self.mesh.shape["dp"])

        # caches + buffers of the per-frame path
        self.recent_embeddings = np.empty((0, self.embedding_dim), np.float32)
        self.recent_labels: List[str] = []
        self.max_recent = max_recent
        self.new_embeddings: List[np.ndarray] = []
        self.new_labels: List[str] = []
        self.max_new = max_new
        self.unknown_faces: dict = {}
        self.track_id_to_label: dict = {}
        # host-side window of recent enrollments: covers gallery rows
        # added after a batched step's device snapshot.  Every enrollment
        # path feeds it through _enroll_now, so mixing paths in one
        # process cannot slip a duplicate past the device-checked dedup.
        self._recent_enrollments: list = []

        self.face_tracker = Sort(self.tracker_cfg, device=self.device)
        self.timer = StageTimer()
        # the batched paths' engines (by detection interval and encode
        # budget, and the mesh for several streams): kept, with their
        # captured step graphs, from one call to the next
        self._batch_engines = {}
        self.counters = {
            "faces_detected": 0, "tier1_track_cache": 0,
            "tier2_recent_cache": 0, "tier3_gallery": 0,
            "unknown_enrolled": 0,
        }

    def _default_mesh(self):
        """Every CUDA device on ``dp``; the engine's device alone when that
        is not a card."""
        return make_mesh(devices=None if self.device.type == "cuda" else [self.device])

    # ------------------------------------------------------------- buffers --

    def _flush_new_embeddings(self) -> None:
        """Write the ``add_face`` buffer to SQLite and the gallery."""
        for label, emb in zip(self.new_labels, self.new_embeddings):
            db_id = self.db_manager.add(label, emb)
            if db_id == -1:
                continue
            self.gallery.add(emb, label, db_id)
        self.new_embeddings, self.new_labels = [], []
        self.gallery.save()

    def save_database_to_sqlite(self) -> None:
        if self.new_embeddings:
            self._flush_new_embeddings()
        log.info("Saved new embeddings to SQLite and the gallery index.")

    # ---------------------------------------------------------- enrollment --

    def add_face(self, image: np.ndarray, label: str) -> bool:
        """Buffered enrollment with dedup: every face of ``image`` that is
        not within the threshold of a gallery row is queued under
        ``label``; the queue is flushed at ``max_new`` and at close.  An
        error is logged and gives ``False``."""
        try:
            return self._add_face(image, label)
        except Exception as e:
            log.error("Error in add_face: %s", e)
            return False

    def _add_face(self, image: np.ndarray, label: str) -> bool:
        faces = self.extract_faces(image, align=self.align)
        if not faces:
            log.warning("No faces detected to add.")
            return False
        t0 = time.perf_counter()
        embs = self.engine.encode_faces(np.stack(faces))
        self.timer.add("encoding", time.perf_counter() - t0)
        success = False
        for emb in embs:
            if np.linalg.norm(emb) == 0:
                log.error("Received zero vector from encoder. Skipping this face.")
                continue
            if self.gallery.count > 0:
                ids, dists = self._matcher.query(emb, k=1)
                if ids is not None and 1.0 - dists[0][0] > self.similarity_threshold:
                    log.info("Face is too similar to an existing face (Label: %s). Not adding.",
                             self.gallery.labels[ids[0][0]])
                    continue
            self.new_embeddings.append(emb)
            self.new_labels.append(label)
            log.info("Added face for label '%s' to the new embeddings buffer.", label)
            success = True
        if len(self.new_embeddings) >= self.max_new:
            self._flush_new_embeddings()
        return success

    def _add_to_recent(self, emb: np.ndarray, label: str) -> None:
        """FIFO recent cache."""
        self.recent_embeddings = np.vstack([self.recent_embeddings, emb[None]])
        self.recent_labels.append(label)
        if self.recent_embeddings.shape[0] > self.max_recent:
            self.recent_embeddings = self.recent_embeddings[1:]
            self.recent_labels.pop(0)

    # ----------------------------------------------------- rename / shrink --

    def update_label(self, gallery_id: int, new_label: str) -> None:
        self.gallery.update_label(gallery_id, new_label, self.db_manager,
                                  similarity_threshold=self.similarity_threshold)

    def shrink_db_ids(self, similarity_threshold: float = 0.75) -> None:
        """Unify similar groups unless known labels conflict.

        All N neighbour sets come from one batched query (taken in row
        chunks by the gallery); they depend only on the stored vectors
        (one SQLite read, renormalised), while the conflict check reads
        labels at visit time, like a sequential loop over the ids."""
        n = len(self.gallery.labels)
        if n == 0:
            log.info("DB ID shrinking completed with 0 unification operations.")
            return
        by_id = {}
        for db_id, _, blob in self.db_manager.load_all():
            emb = np.frombuffer(blob, np.float32)
            norm = np.linalg.norm(emb)
            if emb.shape[0] == self.embedding_dim and norm > 0:
                by_id[int(db_id)] = emb / norm
        embs = np.zeros((n, self.embedding_dim), np.float32)
        have = np.zeros(n, bool)
        for gid in range(n):
            vec = by_id.get(int(self.gallery.db_ids[gid]))
            if vec is not None:
                embs[gid] = vec
                have[gid] = True
        k = min(self.cfg.gallery.group_k, n)
        ids, dists = self._matcher.query_batch(embs, k=k)
        processed = set()
        total = 0
        for gid in range(n):
            if gid in processed or not have[gid]:
                continue
            similar = [int(i) for i, d in zip(ids[gid], dists[gid])
                       if 1.0 - d >= similarity_threshold]
            if len(similar) <= 1:
                processed.add(gid)
                continue
            labels = [self.gallery.labels[s] for s in similar]
            known = [l for l in labels if not l.lower().startswith("unknown")]
            if len(set(known)) > 1:
                processed.update(similar)
                continue
            final = known[0] if known else self.gallery.labels[gid]
            self.gallery.unify_labels(similar, final, self.db_manager, save=False)
            total += 1
            processed.update(similar)
        if total:
            self.gallery.save()  # one compaction for the whole pass
        log.info("DB ID shrinking completed with %d unification operations.", total)

    # ------------------------------------------------------------ unknowns --

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
        else:
            log.warning("Gallery has reached its maximum capacity. Cannot add more embeddings.")

    def _handle_unknown_embedding(self, track_id: int, emb: np.ndarray,
                                  rename_label: Optional[str] = None) -> str:
        """Accumulate a track's unknown sightings; at
        ``unknown_trigger_count`` enroll their mean as ``Unknown_*``
        unless it is within the threshold of a gallery row."""
        if rename_label:
            log.info("Enrolling face with label '%s'.", rename_label)
            self._enroll_now(rename_label, emb)
            self._flush_new_embeddings()
            return rename_label

        entry = self.unknown_faces.setdefault(track_id, {"embeddings": [], "count": 0})
        entry["embeddings"].append(emb)
        entry["count"] += 1
        if entry["count"] < self.unknown_trigger_count:
            return "Unknown"

        avg = np.mean(entry["embeddings"], axis=0)
        if self.gallery.count > 0:
            ids, dists = self._matcher.query(avg, k=1)
            if ids is not None and 1.0 - dists[0][0] > self.similarity_threshold:
                gid = int(ids[0][0])
                log.info("Unknown face is too similar to an existing face. Not adding.")
                return self.gallery.labels[gid] if gid < len(self.gallery.labels) else "Unknown"
        label = self._generate_unique_label()
        log.info("Enrolling unknown face as '%s'.", label)
        self._enroll_now(label, avg)
        self._flush_new_embeddings()
        del self.unknown_faces[track_id]
        return label

    # ----------------------------------------------------------- hot path --

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
            ids, dists = self._matcher.query(emb, k=1)
            if ids is not None and 1.0 - dists[0][0] > self.similarity_threshold:
                return self.gallery.labels[int(ids[0][0])]
        label = self._generate_unique_label()
        self._enroll_now(label, emb)
        self.gallery.save()
        return label

    def recognize_faces(self, image, rename_label: Optional[str] = None) -> List[dict]:
        """Per-frame recognition: detect (every ``detection_interval``-th
        frame) → track → encode every track that has no label yet in one
        pass → recent cache → one batched gallery query → unknown
        lifecycle.  Each stage ends in a readback, so the host clock
        around it times synchronised work.  On a card detect, the tracker
        and each encode replay their captured graphs, and those readbacks
        and the gallery query's two are the frame's only waits.

        The frame is the timer's span ``frame`` (carrying ``frame_index``
        to the profiler), tiled by the spans ``upload``, ``detection``,
        ``tracker``, ``labels`` (before the encode and after the match),
        ``encoding`` and ``match``; every wait is a ``readback`` span
        inside its stage."""
        self.timer.start()
        self.frame_index += 1
        with self.timer.span("frame", frame=self.frame_index):
            return self._recognize_frame(image, rename_label)

    def _recognize_frame(self, image, rename_label: Optional[str]) -> List[dict]:
        timer = self.timer
        detecting = self.frame_index % self.detection_interval == 0

        # one host→device copy per frame, shared by detect and encode: on a
        # card through pinned memory into the static frame input that the
        # detect and encode graphs of this size read
        with timer.span("upload"):
            image_dev = self.engine.to_device(image)

        detected: List[dict] = []
        if detecting:
            with timer.span("detection"):
                detected = self.detect_faces(image_dev)
            self.counters["faces_detected"] += len(detected)
        with timer.span("tracker"):
            tracks = self.face_tracker.update(
                [{"bbox": d["bbox"], "confidence": d["confidence"]} for d in detected])

        with timer.span("labels"):
            # drop state of dead tracks
            active = {t["id"] for t in tracks}
            for tid in set(self.track_id_to_label) - active:
                del self.track_id_to_label[tid]
                self.unknown_faces.pop(tid, None)

            # split cached / to-encode tracks
            h, w = image.shape[:2]
            to_encode = []
            for trk in tracks:
                if trk["id"] in self.track_id_to_label:
                    continue
                x, y, bw, bh = trk["bbox"]
                x, y = max(0, x), max(0, y)
                bw, bh = max(0, bw), max(0, bh)
                bw, bh = min(bw, w - x), min(bh, h - y)
                if bw <= 0 or bh <= 0:
                    log.warning("Face image has zero size for track ID %s. Skipping.",
                                trk["id"])
                    continue
                to_encode.append((trk["id"], [x, y, bw, bh], trk.get("src_det", -1)))

        # one encode for every new face of the frame.  With align_video
        # on, a track updated by a detection this frame encodes a
        # landmark-aligned crop (src_det → that detection's landmarks);
        # a coasting track falls back to the raw box crop.
        embs = {}
        if to_encode:
            with timer.span("encoding"):
                lms_of = {}
                if self.align_video and detecting:
                    for si, d in enumerate(detected):
                        lm = np.asarray(d.get("landmarks", ()), np.float32)
                        if lm.shape == (5, 2) and np.abs(lm).sum() > 0:
                            # (left_eye, right_eye, nose) from the
                            # (right, left, nose, ...) layout: landmarks3's swap
                            lms_of[si] = lm[[1, 0, 2]]
                ali = [i for i, (_, _, src) in enumerate(to_encode) if src in lms_of]
                rest = [i for i in range(len(to_encode)) if i not in set(ali)]
                batch = np.zeros((len(to_encode), self.embedding_dim), np.float32)
                if ali:
                    lms3 = np.stack([lms_of[to_encode[i][2]] for i in ali])
                    batch[ali] = self.engine.encode_landmarks(image_dev, lms3)
                if rest:
                    boxes = np.asarray([to_encode[i][1] for i in rest], np.float32)
                    batch[rest] = self.engine.encode_boxes(image_dev, boxes)
            # one batched gallery query for the same faces
            with timer.span("match"):
                gal_ids, gal_dists = (None, None)
                if self.gallery.count > 0:
                    gal_ids, gal_dists = self._matcher.query_batch(batch, k=1)
            for i, (tid, _, _src) in enumerate(to_encode):
                embs[tid] = (
                    batch[i],
                    None if gal_ids is None else int(gal_ids[i][0]),
                    None if gal_dists is None else float(1.0 - gal_dists[i][0]),
                )

        with timer.span("labels"):
            results = self._labels(tracks, embs, rename_label)
        timer.tick_frame()
        return results

    def _labels(self, tracks: List[dict], embs: dict, rename_label: Optional[str]) -> List[dict]:
        """The frame's labels: the track cache, then for each encoded
        track the recent cache, the gallery's answer and the unknown
        lifecycle (its enrolment the span ``labels.enrol``)."""
        results = []
        for trk in tracks:
            tid = trk["id"]
            if tid in self.track_id_to_label:
                label = self.track_id_to_label[tid]
                confidence = 1.0
                self.counters["tier1_track_cache"] += 1
            elif tid in embs:
                emb, gal_gid, gal_sim = embs[tid]
                if np.linalg.norm(emb) == 0:
                    log.error("Received zero vector from encoder. Skipping this face.")
                    continue
                label, confidence = "Unknown", 0.0
                # tier 2: recent-embedding cache
                if self.recent_embeddings.shape[0] > 0:
                    sims = self.recent_embeddings @ emb
                    mi = int(np.argmax(sims))
                    if sims[mi] > self.similarity_threshold:
                        label = self.recent_labels[mi]
                        confidence = float(sims[mi])
                        self.counters["tier2_recent_cache"] += 1
                # tier 3: gallery
                if label == "Unknown" and gal_gid is not None:
                    if gal_sim > self.similarity_threshold:
                        label = self.gallery.labels[gal_gid]
                        confidence = gal_sim
                        self.counters["tier3_gallery"] += 1
                        if rename_label:
                            self.update_label(gal_gid, rename_label)
                            label = rename_label
                if label == "Unknown":
                    with self.timer.span("enrol"):
                        label = self._handle_unknown_embedding(tid, emb, rename_label)
                    confidence = 1.0
                    if label != "Unknown":
                        self.counters["unknown_enrolled"] += 1
                self.track_id_to_label[tid] = label
                self._add_to_recent(emb, label)
            else:
                continue  # degenerate box skipped above

            if self.interested_label is not None and label != self.interested_label:
                continue
            results.append({"label": self.track_id_to_label[tid], "confidence": float(confidence),
                            "bbox": trk["bbox"]})
        return results

    # --------------------------------------------------------- image mode --

    def process_image(self, image_path: str, annotate: bool = True,
                      save_path: Optional[str] = None, label: Optional[str] = None) -> List[dict]:
        """One still image, no tracker: detect, encode every face in one
        pass, then either relabel the matched gallery rows (``label``) or
        recognise and enroll.  Returns the recognised
        ``[{'label', 'bbox'}]`` list (empty on the relabel path, and when
        an error was logged)."""
        try:
            return self._process_image(image_path, annotate, save_path, label)
        except Exception as e:
            log.error("Error in process_image: %s", e)
            return []

    def _process_image(self, image_path: str, annotate: bool, save_path: Optional[str],
                       label: Optional[str]) -> List[dict]:
        timer = StageTimer()
        t0 = time.perf_counter()
        image = imageio.imread(image_path)
        if image is None:
            log.error("Image not found at path: %s", image_path)
            return []
        timer.add("Image Loading", time.perf_counter() - t0)

        image_dev = self.engine.to_device(image)
        t0 = time.perf_counter()
        detected = self.detect_faces(image_dev)
        timer.add("Face Detection", time.perf_counter() - t0)
        self.counters["faces_detected"] += len(detected)

        # clamp boxes, drop degenerates
        h, w = image.shape[:2]
        valid = []
        for fd in detected:
            x, y, bw, bh = [max(0, int(v)) for v in fd.get("bbox", [0, 0, 0, 0])]
            bw, bh = min(bw, w - x), min(bh, h - y)
            if bw <= 0 or bh <= 0:
                log.warning("Detected face with zero width or height.")
                continue
            valid.append({"bbox": [x, y, bw, bh]})

        embs = np.zeros((0, self.embedding_dim), np.float32)
        if valid:
            t0 = time.perf_counter()
            boxes = np.asarray([f["bbox"] for f in valid], np.float32)
            embs = self.engine.encode_boxes(image_dev, boxes)
            timer.add("Face Encoding", time.perf_counter() - t0)

        if label:
            # relabel path: a face with no match is only warned about,
            # never enrolled under the given label
            for emb in embs:
                if np.linalg.norm(emb) == 0:
                    continue
                matched = False
                if self.gallery.count > 0:
                    ids, dists = self._matcher.query(emb, k=1)
                    if ids is not None and 1.0 - dists[0][0] > self.similarity_threshold:
                        gid = int(ids[0][0])
                        self.update_label(gid, label)
                        log.info("Updated label for gallery id %d to '%s'.", gid, label)
                        matched = True
                if not matched:
                    log.warning("No matching face found to update with the provided label.")
            self._save_image(image, save_path)
            timer.print_image_report()
            return []

        recognized = []
        new_embs, new_labels = [], []
        t0 = time.perf_counter()
        if self.gallery.count > 0 and len(embs):
            ids, dists = self._matcher.query_batch(embs, k=1)
        else:
            ids = dists = None
        for i, face in enumerate(valid):
            emb = embs[i]
            if np.linalg.norm(emb) == 0:
                continue
            found = None
            if ids is not None and 1.0 - dists[i][0] > self.similarity_threshold:
                found = self.gallery.labels[int(ids[i][0])]
            if found is None:
                found = self._generate_unique_label()
                new_embs.append(emb)
                new_labels.append(found)
            recognized.append({"label": found, "bbox": face["bbox"]})
        timer.add("Face Recognition", time.perf_counter() - t0)

        t0 = time.perf_counter()
        for lbl, emb in zip(new_labels, new_embs):
            self._enroll_now(lbl, emb)
        if new_embs:
            self.gallery.save()
        timer.add("Flushing Embeddings", time.perf_counter() - t0)

        t0 = time.perf_counter()
        out = annotate_faces(image, recognized) if annotate else image.copy()
        timer.add("Image Annotation", time.perf_counter() - t0)

        if self.show:
            imageio.imshow("Face Recognition - Image", out, 0)
            imageio.destroy_windows()

        t0 = time.perf_counter()
        self._save_image(out, save_path)
        timer.add("Image Saving", time.perf_counter() - t0)
        timer.print_image_report()
        return recognized

    def _save_image(self, image: np.ndarray, save_path: Optional[str]) -> None:
        """Save, encrypted when a password was given: JPEG bytes whatever
        the path's name, as JAX writes.  Without OpenCV, which encodes
        the JPEG, a ``.bmp`` or ``.ppm`` path is encoded in its own format
        (one logged warning); any other name raises."""
        if not save_path:
            return
        _ensure_parent_dir(save_path)
        if self.encryptor:
            ext = ".jpg"
            if not imageio.has_cv2():
                ext = os.path.splitext(save_path)[1].lower()
                if ext not in (".bmp", ".ppm"):
                    imageio.require_cv2(f"an encrypted JPEG save ({save_path})")
                _warn_not_jpeg(ext)
            self.encryptor.encrypt_and_write(save_path, imageio.imencode(ext, image))
        else:
            imageio.imwrite(save_path, image)
            log.info("Processed image saved to %s", save_path)

    # -------------------------------------------------------- stream modes --

    def _process_stream(self, cap, annotate: bool = True, save_path: Optional[str] = None,
                        duration: int = 0, name: Optional[str] = None,
                        stream_type: str = "video", on_frame: OnFrame = None) -> None:
        """Per-frame loop with a decode-ahead reader: ``recognize_faces``
        on every frame, then annotate / show / write."""
        self.timer = StageTimer()
        self.timer.start()
        sink = reader = None
        try:
            sink = _StreamSink(cap, annotate, save_path, self.show, stream_type, on_frame,
                               self.timer, self.encryptor)
            reader = PrefetchReader(cap)
            for frame in reader.frames():
                # one bad frame never ends the stream
                try:
                    faces = self.recognize_faces(frame, rename_label=name)
                except Exception as e:
                    log.error("Error recognizing frame %d: %s", self.frame_index, e)
                    faces = []
                if not sink.emit(frame, faces):
                    break
                if duration > 0 and (time.time() - self.timer.start_time) >= duration:
                    log.info("Duration of %d seconds reached. Stopping.", duration)
                    break
        except Exception as e:
            log.error("Error in _process_stream: %s", e)
        finally:
            if reader is not None:
                reader.close()
            cap.release()
            if sink is not None:
                sink.close()

    def _run_stream(self, cap, annotate, save_path, batch_size, duration, name, stream_type,
                    on_frame=None) -> None:
        if batch_size > 0:
            self._process_stream_batched(cap, annotate, save_path, batch_size, duration, name,
                                         stream_type, on_frame)
        else:
            self._process_stream(cap, annotate, save_path, duration, name, stream_type, on_frame)

    def process_video(self, video_path: str, annotate: bool = True,
                      save_path: Optional[str] = None, batch_size: int = 0,
                      duration: int = 0, name: Optional[str] = None) -> None:
        """``batch_size > 0`` selects the batched device-resident
        pipeline, 0 the per-frame one."""
        cap = imageio.open_video(video_path)
        if not cap.isOpened():
            log.error("Cannot open video file: %s", video_path)
            return
        self._run_stream(cap, annotate, save_path, batch_size, duration, name, "video")

    def process_frames(
        self,
        frames,
        annotate: bool = True,
        save_path: Optional[str] = None,
        batch_size: int = 0,
        duration: int = 0,
        name: Optional[str] = None,
        fps: float = 30.0,
        on_frame: OnFrame = None,
    ) -> None:
        """Run the video pipeline over in-RAM BGR uint8 frames, with the
        semantics of :meth:`process_video`.  ``on_frame(frame, faces)``
        receives each frame's ``[{'label','confidence','bbox'}]`` list."""
        cap = FrameSequenceCapture(frames, fps=fps)
        if not cap.isOpened():
            log.error("process_frames received no frames.")
            return
        self._run_stream(cap, annotate, save_path, batch_size, duration, name, "video", on_frame)

    def process_webcam(self, annotate: bool = True, save_path: Optional[str] = None,
                       duration: int = 0, name: Optional[str] = None,
                       batch_size: int = 0) -> None:
        """Camera 0 through either loop; with ``batch_size > 0`` results
        trail the live feed by up to two batches."""
        cap = imageio.open_video(0)
        if not cap.isOpened():
            log.error("Cannot open webcam.")
            return
        self._run_stream(cap, annotate, save_path, batch_size, duration, name, "webcam")

    def process_videos(self, video_paths: List[str], annotate: bool = True,
                       save_path: Optional[str] = None, batch_size: int = 8,
                       duration: int = 0, name: Optional[str] = None) -> None:
        """Several videos at once, one stream per device of the ``dp`` axis
        of ``self.mesh`` (every CUDA device when it is None).  Each stream
        has its own tracker state against the one shared gallery, so an
        identity enrolled from one stream is recognised in the others;
        with fewer videos than streams the rest run blank.  With ``--save``
        stream i writes ``<stem>_stream<i><ext>``.  Every input must have
        the same resolution."""
        caps = []
        for p in video_paths:
            cap = imageio.open_video(p)
            if not cap.isOpened():
                log.error("Cannot open video file: %s", p)
                for c in caps + [cap]:
                    c.release()
                return
            caps.append(cap)
        self._process_streams_batched(caps, list(video_paths), annotate, save_path, batch_size,
                                      duration, name)

    def _process_streams_batched(self, caps, names: List[str], annotate: bool,
                                 save_path: Optional[str], batch_size: int, duration: int = 0,
                                 name: Optional[str] = None,
                                 on_frame: Optional[Callable[[int, np.ndarray, List[dict]],
                                                             None]] = None) -> None:
        """The loop of :meth:`process_videos` over open captures, one batch
        in flight; ``on_frame(stream, frame, faces)`` receives every real
        frame.  Releases the captures."""
        from fire_tpu_torch.parallel.multistream import MultiStreamEngine
        from fire_tpu_torch.pipeline.batch_engine import stream_results

        sinks, readers = [], []
        try:
            wh = None
            for p, cap in zip(names, caps):
                cwh = (int(cap.get(CAP_PROP_FRAME_WIDTH)), int(cap.get(CAP_PROP_FRAME_HEIGHT)))
                if wh is None:
                    wh = cwh
                elif cwh != wh:
                    log.error("All streams must share one resolution: %s is %s, expected %s.",
                              p, cwh, wh)
                    return
            mesh = self.mesh or self._default_mesh()
            n_streams = mesh.shape["dp"]
            if len(caps) > n_streams:
                log.error("%d streams exceed the %d-device dp mesh; run in groups of %d.",
                          len(caps), n_streams, n_streams)
                return
            interval = max(self.detection_interval, 1)
            if batch_size % interval != 0:
                rounded = ((batch_size + interval - 1) // interval) * interval
                log.warning("batch_size %d rounded up to %d (multiple of detection_interval %d).",
                            batch_size, rounded, interval)
                batch_size = rounded
            # no tracker_cfg, as in JAX (``recognizer.py:1160``).  Kept with
            # its step graphs for the next call on a mesh of the same
            # devices, from a fresh state, as the batched path keeps its
            key = (repr(mesh), interval, self.cfg.encode_budget)
            mse = self._batch_engines.get(key)
            if mse is None or mse.inner.engine is not self.engine \
                    or mse.inner.gallery is not self.gallery:
                mse = self._batch_engines[key] = MultiStreamEngine(
                    self.engine, self.gallery, self.cfg, mesh, detection_interval=interval,
                    encode_budget=self.cfg.encode_budget)
            else:
                mse.reset()
            n_real = len(caps)
            self.timer = StageTimer()
            self.timer.start()
            stem, ext = os.path.splitext(save_path) if save_path else (None, None)
            for i in range(n_real):
                # every writer takes the first stream's frame rate, as in JAX
                sinks.append(_StreamSink(
                    caps[0], annotate, f"{stem}_stream{i}{ext or '.avi'}" if save_path else None,
                    self.show, "video",
                    None if on_frame is None else (lambda f, faces, i=i: on_frame(i, f, faces)),
                    self.timer, self.encryptor, title=f"Face Recognition - Stream {i}"))
            readers = [PrefetchReader(c) for c in caps]
            iters = [r.frames() for r in readers]
            done = [False] * n_real

            def next_batches():
                """(S, B, H, W, 3) batch, each stream's real frames, and
                which streams are live (an ended stream gets the engine's
                cached zero batch instead of an upload)."""
                per_stream = []
                for i in range(n_real):
                    frames = []
                    while len(frames) < batch_size and not done[i]:
                        f = next(iters[i], None)
                        if f is None:
                            done[i] = True
                        else:
                            frames.append(f)
                    per_stream.append(frames)
                if all(len(f) == 0 for f in per_stream):
                    return None, None, None
                stacked = np.zeros((n_streams, batch_size, wh[1], wh[0], 3), np.uint8)
                active = [False] * n_streams
                for i, frames in enumerate(per_stream):
                    if not frames:
                        continue
                    active[i] = True
                    for b in range(batch_size):
                        stacked[i, b] = frames[min(b, len(frames) - 1)]
                return stacked, per_stream, active

            def emit(token, per_stream) -> bool:
                t0 = time.perf_counter()
                results = mse.collect(token)
                self.timer.add("device step (S streams)", time.perf_counter() - t0)
                for i, frames in enumerate(per_stream):
                    if not frames:
                        continue
                    for frame, faces in zip(frames,
                                            stream_results(self, results[i], rename_label=name)):
                        self.timer.tick_frame()
                        if not sinks[i].emit(frame, faces):
                            return False
                if duration > 0 and (time.time() - self.timer.start_time) >= duration:
                    log.info("Duration of %d seconds reached. Stopping.", duration)
                    return False
                return True

            inflight = None
            while True:
                stacked, per_stream, active = next_batches()
                if stacked is None:
                    break
                token = mse.submit(stacked, active=active)
                prev, inflight = inflight, (token, per_stream)
                if prev is not None and not emit(*prev):
                    inflight = None
                    break
            if inflight is not None:
                emit(*inflight)
        finally:
            for r in readers:
                r.close()
            for c in caps:
                c.release()
            for sink in sinks:
                sink.close()

    def _process_stream_batched(self, cap, annotate: bool, save_path: Optional[str],
                                batch_size: int, duration: int = 0,
                                name: Optional[str] = None, stream_type: str = "video",
                                on_frame: OnFrame = None) -> None:
        """Batched loop with one batch in flight: batch i+1 is submitted
        before batch i is collected, so annotation and writing overlap
        the device step."""
        from fire_tpu_torch.pipeline.batch_engine import BatchStreamEngine, stream_results

        interval = max(self.detection_interval, 1)
        if batch_size % interval != 0:
            rounded = ((batch_size + interval - 1) // interval) * interval
            log.warning("batch_size %d is not a multiple of detection_interval %d; "
                        "rounding batch up to %d.", batch_size, interval, rounded)
            batch_size = rounded
        self.timer = StageTimer()
        self.timer.start()
        # no tracker_cfg, as in JAX (``recognizer.py:958``): the batched
        # step tracks with the default TrackerConfig.  JAX builds a new
        # engine a call; the port keeps one, with its step graphs, and
        # starts it from a fresh state instead.
        key = (interval, self.cfg.encode_budget)
        bse = self._batch_engines.get(key)
        if bse is None or bse.engine is not self.engine or bse.gallery is not self.gallery:
            bse = self._batch_engines[key] = BatchStreamEngine(
                self.engine, self.gallery, self.cfg, detection_interval=interval,
                encode_budget=self.cfg.encode_budget)
        else:
            bse.reset()
        bse.timer = self.timer
        sink = reader = None

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
                if not sink.emit(frame, faces):
                    return False
            if duration > 0 and (time.time() - self.timer.start_time) >= duration:
                log.info("Duration of %d seconds reached. Stopping.", duration)
                return False
            return True

        inflight = None
        try:
            sink = _StreamSink(cap, annotate, save_path, self.show, stream_type, on_frame,
                               self.timer, self.encryptor)
            reader = PrefetchReader(cap)
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
            if reader is not None:
                reader.close()
            cap.release()
            if sink is not None:
                sink.close()

    # -------------------------------------------------------------- close --

    def close(self) -> None:
        """Flush the enrollment buffer, persist the gallery snapshot and
        the SQLite store, release the captured graphs (the tracker's, the
        batched engines', and the engine's when this recognizer made it),
        and report."""
        if self._owns_engine:
            self.engine.release_graphs()
        self.face_tracker.release_graphs()
        self._batch_engines.clear()
        try:
            self.save_database_to_sqlite()
            self.gallery.save(compact=True)
            self.db_manager.save()
            log.info("Closed FaceRecognition system and saved all data.")
        except Exception as e:
            log.error("Error closing FaceRecognition system: %s", e)
        if self.enable_logging:
            self.timer.log_stream_report()
            log.info("Counters: %s; gallery size: %d", self.counters, self.gallery.count)
            log.info("Span counts: %s; graph captures: %d", self.timer.counts, graphs.captures)
