"""Typed configuration for the port (counterpart of ``fire_tpu.config``).

Every field and default equals the JAX package's (tested field by
field).  Dtype fields stay strings; :attr:`EngineConfig.cdtype` maps
them to ``torch`` dtypes on demand, so importing this module touches no
device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# encoder_model_type → the width of the embedding that encoder hands back:
# FaceNet-128, FaceNet-512, ArcFace IResNet-100
ENCODER_DIMS = {"128": 128, "512": 512, "iresnet100": 512}


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """SORT + linear-KF tracker parameters (``Sort(max_age=4,
    min_hits=4, iou_threshold=0.3)`` and the UKF constants)."""

    max_tracks: int = 64
    max_age: int = 4
    min_hits: int = 4
    iou_threshold: float = 0.3
    max_distance: float = 200.0

    dim_x: int = 10
    dim_z: int = 4
    merwe_alpha: float = 1e-3
    merwe_beta: float = 2.0
    merwe_kappa: float = 0.0
    q_pos: float = 5.0
    q_vel: float = 70.0
    q_acc: float = 3.0
    r_diag: float = 10.0

    min_log_area: float = math.log(10.0)
    min_log_aspect: float = math.log(0.5)
    max_velocity: float = 30.0
    max_acceleration: float = 20.0
    min_wh: float = 10.0
    max_wh: float = 720.0

    # "hungarian" = exact optimum by the on-device JV solver
    # (track/assignment.py:lap_assign); "greedy" = cheaper matching.
    assignment: str = "hungarian"


@dataclasses.dataclass(frozen=True)
class GalleryConfig:
    """Identity gallery: exact cosine top-k over a device matrix."""

    capacity: int = 100_000
    embedding_dim: int = 128
    max_recent: int = 200
    max_new: int = 250
    group_k: int = 50

    @property
    def padded_capacity(self) -> int:
        return _round_up(self.capacity, 128)

    @property
    def padded_recent(self) -> int:
        return _round_up(self.max_recent, 128)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Shapes and dtypes of the device graphs."""

    max_faces: int = 32
    max_encode: int = 16
    frame_batch: int = 8
    detect_size: Tuple[int, int] = (640, 640)
    retinaface_size: Tuple[int, int] = (1024, 1024)
    blazeface_size: Tuple[int, int] = (128, 128)
    encode_size: Tuple[int, int] = (160, 160)

    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # Letterbox resampling in bf16 straight from uint8 by default; True
    # restores f32 preprocessing numerics for strict parity runs.
    strict_f32_preprocess: bool = False
    # Match through the f32 master instead of the bf16 shadow.
    strict_f32_match: bool = False

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)


@dataclasses.dataclass(frozen=True)
class RecognizerConfig:
    """End-to-end recognizer semantics."""

    detector_type: str = "yunet"
    align: bool = True
    encoder_model_type: str = "128"
    encoder_mode: str = "gpu_optimized"
    similarity_threshold: float = 0.5
    unknown_similarity_threshold: float = 0.6
    unknown_trigger_count: int = 3
    enable_logging: bool = True
    show: bool = False
    detection_interval: int = 3
    encode_budget: Optional[int] = None
    encryption_password: Optional[str] = None
    interested_label: Optional[str] = None

    weights_dir: Optional[str] = "weights"

    storage_root: str = "storage"
    hnsw_index_path: Optional[str] = None
    hnsw_labels_path: Optional[str] = None
    hnsw_db_ids_path: Optional[str] = None
    sqlite_db_path: Optional[str] = None
    sqlite_db_encrypted_path: Optional[str] = None

    tracker: TrackerConfig = dataclasses.field(default_factory=TrackerConfig)
    gallery: GalleryConfig = dataclasses.field(default_factory=GalleryConfig)
    engine: EngineConfig = dataclasses.field(default_factory=EngineConfig)

    yunet_conf_threshold: float = 0.90
    yunet_nms_threshold: float = 0.3
    yunet_top_k: int = 5000
    retinaface_threshold: float = 0.9
    retinaface_nms_threshold: float = 0.4
    blazeface_conf_threshold: float = 0.8
    blazeface_extract_conf_threshold: float = 0.5

    @property
    def embedding_dim(self) -> int:
        """The encoder's embedding width (:data:`ENCODER_DIMS`; 128 for a
        name it does not hold, as before)."""
        return ENCODER_DIMS.get(self.encoder_model_type, 128)

    def with_embedding_dim(self) -> "RecognizerConfig":
        gal = dataclasses.replace(self.gallery, embedding_dim=self.embedding_dim)
        return dataclasses.replace(self, gallery=gal)


# (left_eye, right_eye, nose) in a 160x160 canvas.
ALIGN_TEMPLATE_160 = (
    (0.35 * 160.0, 0.35 * 160.0),
    (0.65 * 160.0, 0.35 * 160.0),
    (0.50 * 160.0, 0.55 * 160.0),
)
