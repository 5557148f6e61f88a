"""DeviceEngine: detector + encoder on the device (counterpart of
``fire_tpu.pipeline.engine.DeviceEngine``).

* ``detect(frame)``: letterbox → detector → decode + NMS → padded
  `Detections` in source pixels; ``_build_detect`` is the batched form
  the video path uses.
* ``encode_boxes`` / ``encode_landmarks`` / ``encode_faces``: crop (or
  3-point alignment) + FaceNet + L2 normalisation for all faces of a
  frame in one pass.
* ``extract_faces(image, align)``: detector + aligned or plain 160×160
  RGB crops.

Detector slots: ``yunet``, ``retinaface`` and ``mediapipe`` /
``blazeface`` (BlazeFace).

Weights, as in the JAX engine: both models start from the deterministic
random init (:func:`fire_tpu_torch.weights.materialize`, encoder seed
``seed``, detector ``seed + 1``), kept in a params cache
``params_<detector>_<encoder>.msgpack`` under ``params_dir`` so that
embeddings stay the same across sessions; the file is Flax's
``to_bytes`` format, so either package reads the other's.  Trained
variables replace them through ``load_trained_*``.  The JAX engine also
imports reference ONNX / TFLite files found in ``cfg.weights_dir``; the
importers are not ported, so a real file there makes the port's engine
raise rather than run other weights without a word (a Git-LFS pointer
is ignored, as JAX ignores it).

Where the JAX engine pads each call to a power-of-two bucket to bound
XLA recompiles, the port runs the faces it was given (in chunks of
``max_encode``): eager PyTorch has no compile to bound, and BatchNorm
in eval mode makes a row independent of its neighbours.
"""

from __future__ import annotations

import contextlib
import logging
import os
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from fire_tpu_torch.config import RecognizerConfig
from fire_tpu_torch.device import DeviceLike, resolve_device
from fire_tpu_torch.models.blazeface import BlazeFace, decode_blazeface
from fire_tpu_torch.models.detections import Detections
from fire_tpu_torch.models.facenet import FaceNet
from fire_tpu_torch.models.retinaface import RetinaFace, decode_retinaface
from fire_tpu_torch.models.yunet import YuNet, decode_yunet
from fire_tpu_torch.ops.affine import align_faces_160
from fire_tpu_torch.ops.gallery_match import l2_normalize
from fire_tpu_torch.ops.image import bgr_to_rgb, crop_and_resize, crop_and_resize_mm, letterbox
from fire_tpu_torch.weights import (flax_shapes, from_flax_blazeface, from_flax_facenet,
                                    from_flax_retinaface, from_flax_yunet, load_into, materialize,
                                    msgpack_serialize, read_msgpack)

log = logging.getLogger(__name__)

Frame = Union[np.ndarray, torch.Tensor]

LFS_POINTER = b"version https://git-lfs"
IMPORTERS_TODO = ("the ONNX / TFLite importers are not ported (ROADMAP.md, PyTorch/CUDA port "
                  "queue: 'Model importers')")


def reference_weight_files(cfg: RecognizerConfig) -> List[str]:
    """The files the JAX engine's probe of ``cfg.weights_dir`` would try
    to import for this configuration (``engine.py:455-520``), in its
    order, whether or not they exist."""
    wdir = cfg.weights_dir
    if not wdir:
        return []
    names = [f"facenet{cfg.encoder_model_type}.onnx"]
    if cfg.detector_type == "yunet":
        names.append("face_detection_yunet_2023mar.onnx")
    elif cfg.detector_type in ("mediapipe", "blazeface"):
        names += ["face_detection_short_range.tflite", "blazeface.tflite", "blazeface.onnx",
                  "face_detection_short_range.onnx"]
    elif cfg.detector_type == "retinaface":
        names.append("retinaface.onnx")
    return [os.path.join(wdir, n) for n in names]


def is_lfs_pointer(path: str) -> bool:
    """A Git-LFS pointer stub stands in for an absent file."""
    with open(path, "rb") as f:
        return f.read(len(LFS_POINTER)) == LFS_POINTER


class DeviceEngine:
    def __init__(self, cfg: RecognizerConfig, device: DeviceLike = None,
                 detector: Optional[torch.nn.Module] = None,
                 encoder: Optional[FaceNet] = None,
                 params_dir: Optional[str] = None, seed: int = 0):
        """``detector`` / ``encoder`` accept pre-built modules of the same
        families (e.g. ``YuNet(width=8)``, ``tiny_facenet``) so tests
        drive the production path at a fraction of the FLOPs; ``None``
        builds the full models.  ``params_dir`` holds the params cache
        (none without it); ``seed`` seeds the random init."""
        det = cfg.detector_type
        if det == "yunet":
            detector = detector or YuNet()
            self._detect_input = cfg.engine.detect_size
        elif det == "retinaface":
            detector = detector or RetinaFace()
            self._detect_input = cfg.engine.retinaface_size
        elif det in ("mediapipe", "blazeface"):
            detector = detector or BlazeFace()
            self._detect_input = cfg.engine.blazeface_size
        else:
            raise ValueError(
                "Invalid detector_type. Choose from 'yunet', 'retinaface', 'mediapipe'.")
        for path in reference_weight_files(cfg):
            if os.path.isfile(path) and not is_lfs_pointer(path):
                raise NotImplementedError(
                    f"{path}: the JAX engine would import this file; {IMPORTERS_TODO}. "
                    "Move it away or pass another weights_dir.")
        self.cfg = cfg
        self.params_dir = params_dir
        self.device = resolve_device(device)
        dt = cfg.engine.cdtype
        self.detector = self._place(detector, dt)
        self.encoder = self._place(encoder or FaceNet(embed_dim=cfg.embedding_dim), dt)
        # provenance per role: "random-init" until a loader replaces it
        self.weight_source: Dict[str, str] = {"detector": "random-init",
                                              "encoder": "random-init"}
        self._init_params(seed)
        if self.weight_source["detector"] == "random-init":
            log.warning(
                "DETECTOR '%s' IS RUNNING RANDOM-INIT WEIGHTS — it will not find real faces. "
                "Pass --trained_detector, or use the committed weights_trained/ defaults "
                "(auto-loaded by the CLI).", det)

    def _place(self, module: torch.nn.Module, dtype: torch.dtype) -> torch.nn.Module:
        module = module.to(device=self.device, dtype=dtype).eval()
        if self.device.type == "cuda":
            # NHWC activations: the layout cuDNN's bf16 convolutions prefer
            module = module.to(memory_format=torch.channels_last)
        return module

    # -- weights -----------------------------------------------------------

    def _params_path(self) -> Optional[str]:
        if self.params_dir is None:
            return None
        return os.path.join(
            self.params_dir,
            f"params_{self.cfg.detector_type}_{self.cfg.encoder_model_type}.msgpack")

    def _init_params(self, seed: int) -> None:
        """Load the params cache, or fill both models from the random
        init and write the cache (atomically).  An unreadable cache is
        regenerated with a warning, never fatal."""
        path = self._params_path()
        if path and os.path.exists(path):
            try:
                state = read_msgpack(path)
                self.load_encoder_variables(state["enc"], "random-init")
                self.load_detector_variables(state["det"], "random-init")
                log.info("Loaded model parameters from %s.", path)
                return
            except (OSError, ValueError, KeyError, TypeError) as e:
                log.warning("Params cache %s is unreadable (%s); regenerating from fresh init.",
                            path, e)
        enc_vars = materialize(flax_shapes(self.encoder, unit_bn_scale=True), seed)
        det_vars = materialize(flax_shapes(self.detector), seed + 1)
        self.load_encoder_variables(enc_vars, "random-init")
        self.load_detector_variables(det_vars, "random-init")
        if path:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(msgpack_serialize({"enc": enc_vars, "det": det_vars}))
            os.replace(tmp, path)
            log.info("Saved freshly initialized model parameters to %s "
                     "(embeddings stay stable across sessions).", path)

    def load_encoder_variables(self, tree, source: str) -> None:
        """Load a Flax FaceNet variable tree (nested dicts of arrays)."""
        load_into(self.encoder, from_flax_facenet(tree))
        self.weight_source["encoder"] = source

    def load_detector_variables(self, tree, source: str) -> None:
        """Load a Flax YuNet, RetinaFace or BlazeFace variable tree
        (nested dicts of arrays), whichever this engine's detector is."""
        if isinstance(self.detector, BlazeFace):
            convert = from_flax_blazeface
        elif isinstance(self.detector, RetinaFace):
            convert = from_flax_retinaface
        else:
            convert = from_flax_yunet
        load_into(self.detector, convert(tree))
        self.weight_source["detector"] = source

    def load_trained_encoder(self, path: str) -> None:
        """Load FaceNet variables written by ``python -m fire_tpu.train``."""
        self.load_encoder_variables(read_msgpack(path), f"trained:{path}")
        log.info("Loaded trained encoder variables from %s.", path)

    def load_trained_detector(self, path: str) -> None:
        """Load detector variables written by ``python -m
        fire_tpu.train.detect`` / ``detect_blaze``."""
        self.load_detector_variables(read_msgpack(path), f"trained:{path}")
        log.info("Loaded trained detector variables from %s.", path)

    # -- detection ---------------------------------------------------------

    def to_device(self, frame: Frame) -> torch.Tensor:
        """Host frame → device tensor (a no-op for tensors already
        there), so one copy can serve detect and encode."""
        if isinstance(frame, np.ndarray):
            frame = torch.from_numpy(np.ascontiguousarray(frame))
        return frame.to(self.device)

    def _build_detect(self, frame_hw: Tuple[int, int], timer=None, variant: str = "detect"):
        """Batched detect for frames of ``frame_hw``: letterbox →
        detector → decode + NMS → padded `Detections` (n, max_faces) in
        source pixels.  The JAX version is one frame, vmapped by the
        caller.  ``variant="extract"`` runs BlazeFace at the extraction
        path's lower confidence threshold."""
        cfg = self.cfg
        det_hw = self._detect_input
        resample_dtype = torch.float32 if cfg.engine.strict_f32_preprocess else torch.bfloat16
        dev = self.device
        blaze = isinstance(self.detector, BlazeFace)
        retina = isinstance(self.detector, RetinaFace)
        bf_conf = (cfg.blazeface_extract_conf_threshold if variant == "extract"
                   else cfg.blazeface_conf_threshold)

        def stage(name):
            return timer.stage(name, dev) if timer is not None else contextlib.nullcontext()

        def run(frames_u8: torch.Tensor) -> Detections:
            with stage("letterbox"):
                canvas, scale = letterbox(frames_u8.to(resample_dtype), det_hw)
                x = canvas.float() / 255.0
            if blaze:
                with stage("blazeface"):
                    scores, regs = self.detector(bgr_to_rgb(x))
                with stage("decode+nms"):
                    return decode_blazeface(scores, regs, scale, conf_threshold=bf_conf,
                                            max_faces=cfg.engine.max_faces, input_px=det_hw[0])
            if retina:
                with stage("retinaface"):  # raw-pixel RGB
                    heads = self.detector(bgr_to_rgb(x) * 255.0)
                with stage("decode+nms"):
                    return decode_retinaface(
                        heads, det_hw, scale,
                        threshold=cfg.retinaface_threshold,
                        nms_threshold=cfg.retinaface_nms_threshold,
                        max_faces=cfg.engine.max_faces,
                    )
            with stage("yunet"):
                heads = self.detector(x)
            with stage("decode+nms"):
                return decode_yunet(
                    heads, scale,
                    conf_threshold=cfg.yunet_conf_threshold,
                    nms_threshold=cfg.yunet_nms_threshold,
                    max_faces=cfg.engine.max_faces,
                )

        return run

    @torch.no_grad()
    def detect(self, frame_bgr: Frame, variant: str = "detect") -> Detections:
        """Frame (H, W, 3) uint8 BGR → padded `Detections` on the device.
        ``variant="extract"`` differs only for the BlazeFace slot."""
        frame = self.to_device(frame_bgr)
        d = self._build_detect(tuple(frame.shape[:2]), variant=variant)(frame[None])
        return Detections(*(t[0] for t in d))

    @staticmethod
    def _pack_dets(d: Detections) -> torch.Tensor:
        """(N, 16) float32: bbox(4) ‖ landmarks(10) ‖ score ‖ mask, so the
        host reads one tensor back instead of four."""
        n = d.boxes_xywh.shape[0]
        return torch.cat([d.boxes_xywh.float(), d.landmarks.reshape(n, 10).float(),
                          d.scores[:, None].float(), d.mask[:, None].float()], dim=1)

    def detect_faces(self, frame_bgr: Frame) -> List[dict]:
        """List of ``{bbox, landmarks, confidence}`` dicts; coordinates
        are truncated to int32, not rounded."""
        packed = self._pack_dets(self.detect(frame_bgr)).cpu().numpy()
        return [
            {"bbox": row[:4].astype(np.int32).tolist(),
             "landmarks": row[4:14].reshape(5, 2).astype(np.int32),
             "confidence": float(row[14])}
            for row in packed[packed[:, 15] > 0.5]
        ]

    # -- encoding ----------------------------------------------------------

    def encode(self, faces_rgb01: torch.Tensor) -> torch.Tensor:
        """(M, 160, 160, 3) RGB [0,1] → (M, D) float32, unnormalised."""
        return self.encoder(faces_rgb01)

    @torch.no_grad()
    def _encode_crops(self, frame_bgr: Frame, per_face: np.ndarray, crop) -> np.ndarray:
        """Shared body of ``encode_boxes`` / ``encode_landmarks``:
        ``crop(image01, rows)`` → BGR crops, in chunks of ``max_encode``."""
        k = per_face.shape[0]
        if k == 0:
            return np.zeros((0, self.cfg.embedding_dim), np.float32)
        img = self.to_device(frame_bgr).float() / 255.0
        rows = torch.from_numpy(np.ascontiguousarray(per_face, np.float32)).to(self.device)
        step = self.cfg.engine.max_encode
        outs = [l2_normalize(self.encoder(bgr_to_rgb(crop(img, rows[i : i + step]))).float())
                for i in range(0, k, step)]
        return torch.cat(outs).cpu().numpy()

    def encode_boxes(self, frame_bgr: Frame, boxes_xywh: np.ndarray) -> np.ndarray:
        """Encode all K face boxes of a frame: (K, 4) pixel xywh →
        (K, D) L2-normalised embeddings."""
        size = self.cfg.engine.encode_size
        return self._encode_crops(frame_bgr, boxes_xywh,
                                  lambda img, b: crop_and_resize_mm(img, b, size))

    def encode_landmarks(self, frame_bgr: Frame, lms3: np.ndarray) -> np.ndarray:
        """Encode K faces through landmark-aligned crops: ``lms3``
        (K, 3, 2) per-face (left_eye, right_eye, nose) pixels."""
        return self._encode_crops(frame_bgr, lms3, align_faces_160)

    @torch.no_grad()
    def encode_faces(self, faces_rgb01: np.ndarray) -> np.ndarray:
        """Encode pre-extracted (B, 160, 160, 3) RGB [0,1] crops (the
        ``add_face`` path)."""
        if faces_rgb01.shape[0] == 0:
            return np.zeros((0, self.cfg.embedding_dim), np.float32)
        x = torch.from_numpy(np.ascontiguousarray(faces_rgb01, np.float32)).to(self.device)
        return l2_normalize(self.encoder(x).float()).cpu().numpy()

    # -- extraction (detect + align) --------------------------------------

    @torch.no_grad()
    def extract_faces(self, image_bgr: Frame, align: bool = True) -> List[np.ndarray]:
        """Detect and return 160×160 RGB [0,1] crops, aligned by the
        3-point affine when asked.  Uses the extraction detector variant."""
        image = self.to_device(image_bgr)
        d = self.detect(image, variant="extract")
        idx = torch.nonzero(d.mask)[:, 0]
        if idx.numel() == 0:
            return []
        image01 = image.float() / 255.0
        if align:
            crops = align_faces_160(image01, d.landmarks3[idx])
        else:
            crops = crop_and_resize(image01, d.boxes_xywh[idx], self.cfg.engine.encode_size)
        return list(bgr_to_rgb(crops).cpu().numpy())
