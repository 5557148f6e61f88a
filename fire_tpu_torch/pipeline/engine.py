"""DeviceEngine: detector + encoder on the device (counterpart of
``fire_tpu.pipeline.engine.DeviceEngine`` in the subset the batched
video path uses: YuNet + FaceNet, ``load_trained_detector`` /
``load_trained_encoder`` and the yunet branch of ``_build_detect``,
``engine.py:522-576``).

Weights come from the committed Flax msgpack files through the port's
own decoder.  An engine whose weights were never loaded refuses to run:
the JAX package's deterministic random init and its params cache are
not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import contextlib
import logging
from typing import Dict, Optional, Tuple

import torch

from fire_tpu_torch.config import RecognizerConfig
from fire_tpu_torch.device import DeviceLike, resolve_device
from fire_tpu_torch.models.detections import Detections
from fire_tpu_torch.models.facenet import FaceNet
from fire_tpu_torch.models.yunet import YuNet, decode_yunet
from fire_tpu_torch.ops.image import letterbox
from fire_tpu_torch.weights import from_flax_facenet, from_flax_yunet, load_into, read_msgpack

log = logging.getLogger(__name__)


class DeviceEngine:
    def __init__(self, cfg: RecognizerConfig, device: DeviceLike = None,
                 detector: Optional[YuNet] = None, encoder: Optional[FaceNet] = None):
        """``detector`` / ``encoder`` accept pre-built modules of the same
        families (e.g. ``YuNet(width=8)``, ``tiny_facenet``) so tests
        drive the production path at a fraction of the FLOPs; ``None``
        builds the full models."""
        if cfg.detector_type != "yunet":
            raise NotImplementedError(
                f"detector_type={cfg.detector_type!r}: only 'yunet' is ported "
                "(ROADMAP.md, PyTorch/CUDA port queue)")
        self.cfg = cfg
        self.device = resolve_device(device)
        dt = cfg.engine.cdtype
        self.detector = self._place(detector or YuNet(), dt)
        self.encoder = self._place(encoder or FaceNet(embed_dim=cfg.embedding_dim), dt)
        self._detect_input = cfg.engine.detect_size
        self.weight_source: Dict[str, str] = {"detector": "unloaded", "encoder": "unloaded"}

    def _place(self, module: torch.nn.Module, dtype: torch.dtype) -> torch.nn.Module:
        module = module.to(device=self.device, dtype=dtype).eval()
        if self.device.type == "cuda":
            # NHWC activations: the layout cuDNN's bf16 convolutions prefer
            module = module.to(memory_format=torch.channels_last)
        return module

    # -- weights -----------------------------------------------------------

    def load_encoder_variables(self, tree, source: str) -> None:
        """Load a Flax FaceNet variable tree (nested dicts of arrays)."""
        load_into(self.encoder, from_flax_facenet(tree))
        self.weight_source["encoder"] = source

    def load_detector_variables(self, tree, source: str) -> None:
        """Load a Flax YuNet variable tree (nested dicts of arrays)."""
        load_into(self.detector, from_flax_yunet(tree))
        self.weight_source["detector"] = source

    def load_trained_encoder(self, path: str) -> None:
        """Load FaceNet variables written by ``python -m fire_tpu.train``."""
        self.load_encoder_variables(read_msgpack(path), f"trained:{path}")
        log.info("Loaded trained encoder variables from %s.", path)

    def load_trained_detector(self, path: str) -> None:
        """Load YuNet variables written by ``python -m fire_tpu.train.detect``."""
        self.load_detector_variables(read_msgpack(path), f"trained:{path}")
        log.info("Loaded trained detector variables from %s.", path)

    def require_weights(self) -> None:
        unloaded = [k for k, v in self.weight_source.items() if v == "unloaded"]
        if unloaded:
            raise NotImplementedError(
                f"{', '.join(unloaded)} weights not loaded: random-init engines are not "
                "ported (ROADMAP.md); call load_trained_detector / load_trained_encoder")

    # -- detection ---------------------------------------------------------

    def _build_detect(self, frame_hw: Tuple[int, int], timer=None):
        """Batched detect for frames of ``frame_hw``: letterbox → YuNet →
        decode + NMS → padded `Detections` (n, max_faces) in source
        pixels.  The JAX version is one frame, vmapped by the caller."""
        cfg = self.cfg
        det_hw = self._detect_input
        resample_dtype = torch.float32 if cfg.engine.strict_f32_preprocess else torch.bfloat16
        dev = self.device

        def stage(name):
            return timer.stage(name, dev) if timer is not None else contextlib.nullcontext()

        def run(frames_u8: torch.Tensor) -> Detections:
            with stage("letterbox"):
                canvas, scale = letterbox(frames_u8.to(resample_dtype), det_hw)
                x = canvas.float() / 255.0
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

    # -- encoding ----------------------------------------------------------

    def encode(self, faces_rgb01: torch.Tensor) -> torch.Tensor:
        """(M, 160, 160, 3) RGB [0,1] → (M, D) float32, unnormalised."""
        return self.encoder(faces_rgb01)
