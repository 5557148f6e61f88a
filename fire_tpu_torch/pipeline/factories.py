"""Reference-shaped factory entry points (counterpart of
``fire_tpu.pipeline.factories``).

The reference exposes small factories users may call directly:
``initialize_detector(type) -> (detect_faces, extract_faces)``,
``initialize_tracker() -> Sort`` and an ``Encoder`` wrapper with
``encode`` / ``preprocess_for_encoder``.  These give the same call
signatures on the port's :class:`DeviceEngine` and host :class:`Sort`;
each takes ``device`` (``cuda`` unless the caller asks for the CPU).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from fire_tpu_torch.config import RecognizerConfig, TrackerConfig
from fire_tpu_torch.device import DeviceLike
from fire_tpu_torch.pipeline.engine import DeviceEngine, encoder_of
from fire_tpu_torch.track.sort import Sort
from fire_tpu_torch.train.scenes import resize_area, resize_area_u8


def initialize_detector(detector_type: str, cfg: Optional[RecognizerConfig] = None,
                        device: DeviceLike = None):
    """``(detect_faces, extract_faces)`` of one engine."""
    detector_type = detector_type.lower()
    if detector_type not in ("yunet", "retinaface", "mediapipe", "blazeface"):
        raise ValueError(
            "Invalid detector_type. Choose from 'yunet', 'retinaface', 'mediapipe'.")
    cfg = dataclasses.replace(cfg or RecognizerConfig(),
                              detector_type=detector_type).with_embedding_dim()
    engine = DeviceEngine(cfg, device=device)
    return engine.detect_faces, engine.extract_faces


def initialize_tracker(device: DeviceLike = None) -> Sort:
    """``Sort(max_age=4, min_hits=4, iou_threshold=0.3)``, the reference
    wiring."""
    return Sort(TrackerConfig(max_age=4, min_hits=4, iou_threshold=0.3), device=device)


class Encoder:
    """The reference's encoder contract on the port's engine.

    ``preprocess_for_encoder``: resize to 160×160 (area; the crop size
    of an encoder that fixes one, IResNet's 112×112), /255, add a batch
    axis: NHWC float like the reference.  ``encode``: the batched
    FaceNet forward on the engine's device (the unnormalised embedding,
    as the reference returns)."""

    def __init__(self, encoder_model_type: str = "128", encoder_mode: str = "cpu_optimized",
                 engine: Optional[DeviceEngine] = None, device: DeviceLike = None):
        cfg = dataclasses.replace(
            RecognizerConfig(), encoder_model_type=encoder_model_type or "128"
        ).with_embedding_dim()
        self.engine = engine or DeviceEngine(cfg, device=device)
        self.input_shape = encoder_of(cfg).px or (160, 160)
        self.output_shape = cfg.embedding_dim

    def preprocess_for_encoder(self, face_img: np.ndarray) -> np.ndarray:
        """``cv2.resize(face_img, (160, 160), interpolation=INTER_AREA)``
        by the port's area resize, then /255.  A uint8 image is rounded
        back to uint8 first, as OpenCV's resize returns it."""
        face_img = np.asarray(face_img)
        if not (face_img.ndim == 3 and face_img.shape[2] == 3):
            raise ValueError("Face image has incorrect shape for encoder.")
        if face_img.dtype == np.uint8:
            resized = resize_area_u8(face_img, self.input_shape)
        else:
            resized = resize_area(face_img.astype(np.float32), self.input_shape)
        return (resized.astype(np.float32) / 255.0)[None]

    @torch.no_grad()
    def encode(self, face_img: np.ndarray) -> np.ndarray:
        """(B, 160, 160, 3) float [0,1] → (B, D) embedding."""
        x = torch.from_numpy(np.ascontiguousarray(face_img, np.float32)).to(self.engine.device)
        return self.engine.encode(x).float().cpu().numpy()
