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
``to_bytes`` format, so either package reads the other's.  Then the
reference ONNX / TFLite files found in ``cfg.weights_dir`` are imported
in the JAX probe's order (``_load_reference_weights``): onto the Flax-
named variable tree the engine holds (``enc_vars`` / ``det_vars``), or,
when a file's topology does not map, by putting the ONNX executor
(:class:`fire_tpu_torch.models.onnx_exec.OnnxModel`) in the model's slot;
a Git-LFS pointer keeps the random init.  Trained variables replace any
of them through ``load_trained_*``, which puts the port's own module
back in its slot.

The per-frame calls run the way the JAX engine's jitted functions run.
JAX compiles detect (with ``_pack_dets``) per frame size and variant,
each encoder per (frame size, power-of-two bucket) and ``encode_faces``
per bucket; the port pads to the same buckets (``_buckets``; more faces
than ``max_encode`` go in bucket-sized slices, landmark pad rows take
``ALIGN_TEMPLATE_160``) and, on a card, replays one CUDA graph per key
(:mod:`fire_tpu_torch.runtime.graphs`), captured at the key's first
call: the key is JAX's ``_detect_jit_cache`` key with the device and
the module in the slot.  A frame goes up once, through pinned memory,
into the static frame input of its size, which the detect and encode
graphs of that size read (:meth:`DeviceEngine.to_device`).  A graph's
outputs are overwritten by its next replay, so what leaves the engine is
a copy or a host array.  The eager calls are the graphs' plain version:
the CPU runs them, and on the card the tests and ``chip_smoke.py`` hold
each replay against them.
"""

from __future__ import annotations

import contextlib
import logging
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from fire_tpu_torch.config import ALIGN_TEMPLATE_160, RecognizerConfig
from fire_tpu_torch.device import DeviceLike, resolve_device
from fire_tpu_torch.models.blazeface import BlazeFace, decode_blazeface
from fire_tpu_torch.models.detections import Detections
from fire_tpu_torch.models.facenet import FaceNet
from fire_tpu_torch.models.retinaface import RetinaFace, decode_retinaface
from fire_tpu_torch.models.yunet import YuNet, decode_yunet
from fire_tpu_torch.ops.affine import align_faces_160
from fire_tpu_torch.ops.gallery_match import l2_normalize
from fire_tpu_torch.ops.image import bgr_to_rgb, crop_and_resize, crop_and_resize_mm, letterbox
from fire_tpu_torch.pipeline.timing import span
from fire_tpu_torch.runtime.graphs import GraphCache, HostStaging, indexed, replay
from fire_tpu_torch.weights import (flax_shapes, from_flax_blazeface, from_flax_facenet,
                                    from_flax_retinaface, from_flax_yunet, load_into, materialize,
                                    msgpack_serialize, read_msgpack)

log = logging.getLogger(__name__)

Frame = Union[np.ndarray, torch.Tensor]

YUNET_OUTPUTS = ["cls_8", "obj_8", "bbox_8", "kps_8", "cls_16", "obj_16",
                 "bbox_16", "kps_16", "cls_32", "obj_32", "bbox_32", "kps_32"]
BLAZEFACE_OUTPUTS = ["classifier_8", "regressor_8", "classifier_16", "regressor_16"]
RETINAFACE_PERM = (7, 1, 4, 8, 0, 3, 6, 2, 5)  # the export's output order → (sc, bb, lm) × 32/16/8


def _buckets(n: int, cap: int) -> int:
    """Round n up to the next power-of-two bucket (≤ cap)."""
    b = 1
    while b < n and b < cap:
        b *= 2
    return min(b, cap)


def _ordered(model, want: List[str], what: str) -> List[int]:
    names = list(model.graph.outputs)
    if sorted(names) != sorted(want):
        raise ValueError(f"unexpected {what} output names {names}")
    return [names.index(n) for n in want]


def _per_frame(run, x: torch.Tensor):
    """The executor's graph runs one frame at a time, as the JAX engine
    runs it per frame under vmap (a file may fix its batch to 1)."""
    outs = [run(x[i : i + 1]) for i in range(x.shape[0])]
    if isinstance(outs[0], dict):
        return {k: tuple(torch.cat(t) for t in zip(*(o[k] for o in outs))) for k in outs[0]}
    return tuple(torch.cat(t) for t in zip(*outs))


class OnnxSlot(torch.nn.Module):
    """A model slot held by the ONNX executor (``model``) instead of the
    port's own module."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model


class OnnxEncoder(OnnxSlot):
    """A FaceNet ONNX graph in the encoder slot: NHWC RGB [0, 1] in (the
    reference files' contract), the embedding out."""

    def forward(self, x01_nhwc: torch.Tensor) -> torch.Tensor:
        return self.model(x01_nhwc.float())[0]


class OnnxYuNet(OnnxSlot):
    """A YuNet 2023mar graph in the detector slot: raw-pixel NCHW BGR in,
    (1, h·w, C) maps ``cls_8``…``kps_32`` out, adapted to YuNet's NHWC
    head dict."""

    def __init__(self, model: torch.nn.Module, det_hw):
        super().__init__(model)
        self.order = _ordered(model, YUNET_OUTPUTS, "YuNet")
        self.det_hw = tuple(det_hw)

    def _one(self, x01_nhwc):
        outs = self.model(x01_nhwc.float().permute(0, 3, 1, 2) * 255.0)
        outs = [outs[i] for i in self.order]
        heads = {}
        for level, stride in enumerate((8, 16, 32)):
            h, w = self.det_hw[0] // stride, self.det_hw[1] // stride
            heads[stride] = tuple(a.float().reshape(1, h, w, a.shape[-1])
                                  for a in outs[4 * level : 4 * level + 4])
        return heads

    def forward(self, x01_nhwc):
        return _per_frame(self._one, x01_nhwc)


class OnnxBlazeFace(OnnxSlot):
    """A BlazeFace graph in the detector slot: [-1, 1] RGB NCHW in, four
    NCHW head maps out, adapted to ``(scores, regressions)`` in anchor
    order (the 16×16 grid, then 8×8)."""

    def __init__(self, model: torch.nn.Module):
        super().__init__(model)
        self.order = _ordered(model, BLAZEFACE_OUTPUTS, "BlazeFace")

    def _one(self, x01_nhwc):
        outs = self.model(((x01_nhwc.float() - 0.5) * 2.0).permute(0, 3, 1, 2))
        c8, r8, c16, r16 = (outs[i].permute(0, 2, 3, 1).float() for i in self.order)
        b = c8.shape[0]
        scores = torch.cat([c8.reshape(b, -1), c16.reshape(b, -1)], dim=1)
        regs = torch.cat([r8.reshape(b, -1, 16), r16.reshape(b, -1, 16)], dim=1)
        return scores, regs

    def forward(self, x01_nhwc):
        return _per_frame(self._one, x01_nhwc)


class OnnxRetinaFace(OnnxSlot):
    """The reference RetinaFace graph in the detector slot: NHWC RGB raw
    pixels in (its preprocessing never transposes), nine NHWC head maps
    out in the export's order, the face probability in the last
    ``anchors`` channels of each score map."""

    def __init__(self, model: torch.nn.Module, anchors: int = 2):
        super().__init__(model)
        self.anchors = anchors

    def _one(self, x_rgb255_nhwc):
        outs = self.model(x_rgb255_nhwc.float())
        outs = [outs[i] for i in RETINAFACE_PERM]
        heads = {}
        for level, stride in enumerate((32, 16, 8)):
            sc, bb, lm = (a.float() for a in outs[3 * level : 3 * level + 3])
            heads[stride] = (sc[..., self.anchors:], bb, lm)
        return heads

    def forward(self, x_rgb255_nhwc):
        return _per_frame(self._one, x_rgb255_nhwc)


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
        self.cfg = cfg
        self.params_dir = params_dir
        self.device = resolve_device(device)
        dt = cfg.engine.cdtype
        # the port's own modules; the slots hold them, or the ONNX executor
        self._detector_net = self._place(detector, dt)
        self._encoder_net = self._place(encoder or FaceNet(embed_dim=cfg.embedding_dim), dt)
        self.detector, self.encoder = self._detector_net, self._encoder_net
        # provenance per role: "random-init" until a loader replaces it
        # ("trained:<path>", "onnx-import:<path>", "tflite-import:<path>",
        # "onnx-exec:<path>")
        self.weight_source: Dict[str, str] = {"detector": "random-init",
                                              "encoder": "random-init"}
        # the per-frame graphs (on a card), every key kept as JAX keeps its
        # jit cache until release_graphs(); their static frame inputs by
        # size; the pinned buffers that feed them
        self.graphs = GraphCache(limit=None)
        self._frames: Dict[Tuple[int, int], torch.Tensor] = {}
        self._staging = HostStaging()
        self._init_params(seed)
        self._load_reference_weights()
        if self.weight_source["detector"] == "random-init":
            log.warning(
                "DETECTOR '%s' IS RUNNING RANDOM-INIT WEIGHTS — it will not find real faces. "
                "Provide reference ONNX/TFLite files in %r, pass --trained_detector, or use the "
                "committed weights_trained/ defaults (auto-loaded by the CLI).",
                det, cfg.weights_dir)

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
        enc_vars = materialize(flax_shapes(self._encoder_net, unit_bn_scale=True), seed)
        det_vars = materialize(flax_shapes(self._detector_net), seed + 1)
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
        """Load a Flax FaceNet variable tree (nested dicts of arrays) into
        the port's FaceNet, which takes the slot back from an executor."""
        if not isinstance(self.encoder, OnnxSlot):
            self._encoder_net = self.encoder
        load_into(self._encoder_net, from_flax_facenet(tree))
        self.encoder, self.enc_vars = self._encoder_net, tree
        self.weight_source["encoder"] = source

    def load_detector_variables(self, tree, source: str) -> None:
        """Load a Flax YuNet, RetinaFace or BlazeFace variable tree
        (nested dicts of arrays), whichever this engine's detector is; the
        port's module takes the slot back from an executor."""
        if not isinstance(self.detector, OnnxSlot):
            self._detector_net = self.detector
        if isinstance(self._detector_net, BlazeFace):
            convert = from_flax_blazeface
        elif isinstance(self._detector_net, RetinaFace):
            convert = from_flax_retinaface
        else:
            convert = from_flax_yunet
        load_into(self._detector_net, convert(tree))
        self.detector, self.det_vars = self._detector_net, tree
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

    # -- reference weight files -------------------------------------------

    def _executor(self, path: str):
        from fire_tpu_torch.models.onnx_exec import OnnxModel

        return OnnxModel(path, device=self.device)

    def load_onnx_weights(self, facenet_onnx: str) -> None:
        """Import reference FaceNet weights onto the encoder's tree."""
        from fire_tpu_torch.models.onnx_import import assign_facenet, read_onnx

        graph = read_onnx(facenet_onnx)
        params, stats = assign_facenet(self.enc_vars["params"], self.enc_vars["batch_stats"],
                                       graph)
        self.load_encoder_variables({"params": params, "batch_stats": stats},
                                    f"onnx-import:{facenet_onnx}")
        log.info("Imported FaceNet weights from %s.", facenet_onnx)

    def load_yunet_onnx_weights(self, yunet_onnx: str) -> None:
        """Import the OpenCV-zoo YuNet 2023mar weights."""
        from fire_tpu_torch.models.onnx_import import assign_yunet, read_onnx

        graph = read_onnx(yunet_onnx)
        params, stats = assign_yunet(self.det_vars["params"], self.det_vars["batch_stats"], graph)
        self.load_detector_variables({"params": params, "batch_stats": stats},
                                     f"onnx-import:{yunet_onnx}")
        log.info("Imported YuNet weights from %s.", yunet_onnx)

    def _use_onnx_encoder(self, path: str) -> None:
        """Run the FaceNet ONNX graph itself in the encoder slot."""
        self.encoder, self.enc_vars = OnnxEncoder(self._executor(path)), None
        self.weight_source["encoder"] = f"onnx-exec:{path}"
        log.info("Encoder runs the exact ONNX graph from %s (executor).", path)

    def _use_onnx_yunet(self, path: str) -> None:
        """Run the YuNet ONNX graph itself in the detector slot."""
        self.detector = OnnxYuNet(self._executor(path), self._detect_input)
        self.det_vars = None
        self.weight_source["detector"] = f"onnx-exec:{path}"
        log.info("Detector runs the exact ONNX graph from %s (executor).", path)

    def _force_blazeface_128(self) -> None:
        """Reference BlazeFace weights are trained at the published 128²
        input: importing them pins the slot to 128 even where
        ``blazeface_size`` asks for the trained-default 192."""
        if tuple(self._detect_input) != (128, 128):
            log.info("Imported BlazeFace weights: forcing 128x128 input (was %s).",
                     self._detect_input)
            self._detect_input = (128, 128)

    def load_blazeface_onnx_weights(self, path: str) -> None:
        """Import BlazeFace short-range weights from an ONNX file."""
        from fire_tpu_torch.models.onnx_import import assign_blazeface, read_onnx

        graph = read_onnx(path)
        params, stats = assign_blazeface(self.det_vars["params"],
                                         self.det_vars.get("batch_stats", {}), graph)
        self.load_detector_variables(
            {"params": params} if not stats else {"params": params, "batch_stats": stats},
            f"onnx-import:{path}")
        log.info("Imported BlazeFace weights from %s.", path)
        self._force_blazeface_128()

    def load_blazeface_tflite_weights(self, path: str) -> None:
        """Import BlazeFace weights from MediaPipe's own ``.tflite``."""
        from fire_tpu_torch.models.tflite_import import assign_blazeface_tflite, read_tflite

        params = assign_blazeface_tflite(self.det_vars["params"], read_tflite(path))
        self.load_detector_variables({"params": params}, f"tflite-import:{path}")
        log.info("Imported BlazeFace weights from TFLite file %s.", path)
        self._force_blazeface_128()

    def _use_onnx_blazeface(self, path: str) -> None:
        """Run a BlazeFace ONNX graph itself in the detector slot."""
        self.detector, self.det_vars = OnnxBlazeFace(self._executor(path)), None
        self.weight_source["detector"] = f"onnx-exec:{path}"
        log.info("Detector runs the exact ONNX graph from %s (executor).", path)
        self._force_blazeface_128()

    def _use_onnx_retinaface(self, path: str) -> None:
        """Run the reference RetinaFace ONNX graph itself (a TF-converted
        export with nine outputs that no hand-written module maps)."""
        from fire_tpu_torch.models.onnx_import import read_onnx

        graph = read_onnx(path)
        if len(graph.outputs) != 9:
            raise ValueError(f"expected 9 RetinaFace outputs, got {len(graph.outputs)}")
        from fire_tpu_torch.models.onnx_exec import OnnxModel

        self.detector = OnnxRetinaFace(OnnxModel(graph, device=self.device))
        self.det_vars = None
        self.weight_source["detector"] = f"onnx-exec:{path}"
        log.info("Detector runs the exact ONNX graph from %s (executor).", path)

    def _load_reference_weights(self) -> None:
        """Probe ``cfg.weights_dir`` for the reference files and import
        them; on a topology mismatch run the file's exact graph instead.
        Git-LFS stubs and absent files keep the random init.  The order,
        the fallbacks and the log lines are the JAX engine's."""
        wdir = self.cfg.weights_dir
        if not wdir or not os.path.isdir(wdir):
            return
        enc_path = os.path.join(wdir, f"facenet{self.cfg.encoder_model_type}.onnx")
        if os.path.exists(enc_path):
            try:
                self.load_onnx_weights(enc_path)
            except FileNotFoundError as e:  # LFS stub
                log.info("%s", e)
            except ValueError as e:
                log.warning("FaceNet import mismatch (%s); executor fallback.", e)
                self._use_onnx_encoder(enc_path)
        det = self.cfg.detector_type
        if det == "yunet":
            det_path = os.path.join(wdir, "face_detection_yunet_2023mar.onnx")
            if os.path.exists(det_path):
                try:
                    self.load_yunet_onnx_weights(det_path)
                except FileNotFoundError as e:
                    log.info("%s", e)
                except ValueError as e:
                    log.warning("YuNet import mismatch (%s); executor fallback.", e)
                    self._use_onnx_yunet(det_path)
        elif det in ("mediapipe", "blazeface"):
            for fname in ("face_detection_short_range.tflite", "blazeface.tflite"):
                det_path = os.path.join(wdir, fname)
                if not os.path.exists(det_path):
                    continue
                try:
                    self.load_blazeface_tflite_weights(det_path)
                    return
                except FileNotFoundError as e:  # LFS stub
                    log.info("%s", e)
                except ValueError as e:
                    log.warning("BlazeFace TFLite import failed (%s).", e)
                break
            for fname in ("blazeface.onnx", "face_detection_short_range.onnx"):
                det_path = os.path.join(wdir, fname)
                if not os.path.exists(det_path):
                    continue
                try:
                    self.load_blazeface_onnx_weights(det_path)
                except FileNotFoundError as e:  # LFS stub
                    log.info("%s", e)
                except ValueError as e:
                    log.warning("BlazeFace import mismatch (%s); executor fallback.", e)
                    self._use_onnx_blazeface(det_path)
                break
        elif det == "retinaface":
            det_path = os.path.join(wdir, "retinaface.onnx")
            if os.path.exists(det_path):
                try:
                    self._use_onnx_retinaface(det_path)
                except FileNotFoundError as e:  # LFS stub
                    log.info("%s", e)
                except ValueError as e:
                    log.warning("RetinaFace ONNX unusable (%s); random init.", e)

    # -- detection ---------------------------------------------------------

    def _graphed(self, device: torch.device) -> bool:
        """Whether the per-frame calls replay captured graphs: on a CUDA
        device."""
        return torch.device(device).type == "cuda"

    def release_graphs(self) -> None:
        """Drop the per-frame graphs, their static inputs and the pinned
        buffers; the next call on a card captures again."""
        self.graphs.clear()
        self._frames.clear()
        self._staging = HostStaging()

    def to_device(self, frame: Frame) -> torch.Tensor:
        """Host frame → device tensor (a no-op for tensors already
        there), so one copy can serve detect and encode.  On a card a
        (H, W, 3) uint8 frame goes into the static frame input of its
        size, which the graphs of that size read: from the host through a
        pinned buffer, from a card by a device-to-device copy, so that no
        graph ever binds, reads later or writes a caller's tensor.  The
        static input itself is returned as it is; the next frame of its
        size overwrites it."""
        if isinstance(frame, np.ndarray):
            frame = torch.from_numpy(np.ascontiguousarray(frame))
        if (not self._graphed(self.device) or frame.dtype != torch.uint8 or frame.dim() != 3
                or frame.shape[2] != 3):
            return frame.to(self.device)
        hw = tuple(frame.shape[:2])
        static = self._frames.get(hw)
        if frame is static:
            return static
        if static is None:
            static = self._frames[hw] = torch.empty(frame.shape, dtype=torch.uint8,
                                                    device=self.device)
        if frame.device.type == "cpu":
            return self._staging.upload(frame, self.device, out=static)
        return static.copy_(frame)

    def _run(self, jit_key: tuple, module: torch.nn.Module, fn: Callable,
             args: Sequence) -> Tuple[torch.Tensor, ...]:
        """``fn(*args)`` (device tensors and host arrays) as JAX runs its
        jitted form: on a card the graph of ``(device, jit_key, module)``
        replays (captured at the key's first call) and its static outputs
        come back; elsewhere ``fn`` runs eagerly, its plain version.  The
        key holds the module in the slot (a module put in another's slot
        needs a new capture, and the graph reads its weights)."""
        if self._graphed(self.device):
            key = (indexed(self.device), jit_key, module)
            return replay(self.graphs, key, fn, args, self._staging)
        with torch.no_grad():
            out = fn(*(self._staging.upload(a, self.device) if isinstance(a, np.ndarray) else a
                       for a in args))
        return out if isinstance(out, tuple) else (out,)

    def _frame_arg(self, frame_bgr: Frame) -> torch.Tensor:
        frame = self.to_device(frame_bgr)
        if self._graphed(self.device) and self._frames.get(tuple(frame.shape[:2])) is not frame:
            raise ValueError(f"a frame is (H, W, 3) uint8 BGR, not {frame.dtype} "
                             f"{tuple(frame.shape)}")
        return frame

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
        detector = self.detector
        blaze = isinstance(self._detector_net, BlazeFace)
        retina = isinstance(self._detector_net, RetinaFace)
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
                    scores, regs = detector(bgr_to_rgb(x))
                with stage("decode+nms"):
                    return decode_blazeface(scores, regs, scale, conf_threshold=bf_conf,
                                            max_faces=cfg.engine.max_faces, input_px=det_hw[0])
            if retina:
                with stage("retinaface"):  # raw-pixel RGB
                    heads = detector(bgr_to_rgb(x) * 255.0)
                with stage("decode+nms"):
                    return decode_retinaface(
                        heads, det_hw, scale,
                        threshold=cfg.retinaface_threshold,
                        nms_threshold=cfg.retinaface_nms_threshold,
                        max_faces=cfg.engine.max_faces,
                    )
            with stage("yunet"):
                heads = detector(x)
            with stage("decode+nms"):
                return decode_yunet(
                    heads, scale,
                    conf_threshold=cfg.yunet_conf_threshold,
                    nms_threshold=cfg.yunet_nms_threshold,
                    max_faces=cfg.engine.max_faces,
                )

        return run

    def _detect(self, frame_bgr: Frame, variant: str) -> Tuple[Detections, torch.Tensor]:
        """Detections of one frame and their ``_pack_dets`` rows, under
        JAX's ``_detect_jit_cache`` key (``engine.py:584-591``): on a card
        the graph's static outputs, overwritten by its next replay."""
        frame = self._frame_arg(frame_bgr)
        hw = tuple(frame.shape[:2])
        if variant != "detect" and not isinstance(self._detector_net, BlazeFace):
            variant = "detect"  # the variants differ only for the BlazeFace slot
        detect = self._build_detect(hw, variant=variant)

        def run(frame_u8):
            d = Detections(*(t[0] for t in detect(frame_u8[None])))
            return (*d, self._pack_dets(d))

        out = self._run(hw if variant == "detect" else (hw, variant), self.detector, run, (frame,))
        return Detections(*out[:4]), out[4]

    @torch.no_grad()
    def detect(self, frame_bgr: Frame, variant: str = "detect") -> Detections:
        """Frame (H, W, 3) uint8 BGR → padded `Detections` on the device
        (new tensors, as JAX returns new arrays).  ``variant="extract"``
        differs only for the BlazeFace slot."""
        d, _ = self._detect(frame_bgr, variant)
        if self._graphed(self.device):
            d = Detections(*(t.clone() for t in d))
        return d

    @staticmethod
    def _pack_dets(d: Detections) -> torch.Tensor:
        """(N, 16) float32: bbox(4) ‖ landmarks(10) ‖ score ‖ mask, so the
        host reads one tensor back instead of four."""
        n = d.boxes_xywh.shape[0]
        return torch.cat([d.boxes_xywh.float(), d.landmarks.reshape(n, 10).float(),
                          d.scores[:, None].float(), d.mask[:, None].float()], dim=1)

    def detect_faces(self, frame_bgr: Frame) -> List[dict]:
        """List of ``{bbox, landmarks, confidence}`` dicts; coordinates
        are truncated to int32, not rounded.  On a card the detect graph's
        packed rows are read back, once."""
        if self._graphed(self.device):
            packed = self._detect(frame_bgr, "detect")[1]
        else:
            packed = self._pack_dets(self.detect(frame_bgr))
        with span("readback"):
            packed = packed.cpu().numpy()
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

    def _encode_crops(self, kind: str, frame_bgr: Frame, per_face: np.ndarray, crop,
                      pad_row=0.0) -> np.ndarray:
        """Shared body of ``encode_boxes`` / ``encode_landmarks``: the K
        rows padded to ``_buckets(K, max_encode)`` with ``pad_row``,
        ``crop(image01, rows)`` → BGR crops → FaceNet, one call (one graph
        of ``(kind, frame size, bucket)``) a bucket; more rows than the
        bucket go in bucket-sized slices (``engine.py:650-716``)."""
        k = per_face.shape[0]
        if k == 0:
            return np.zeros((0, self.cfg.embedding_dim), np.float32)
        bucket = _buckets(k, self.cfg.engine.max_encode)
        if k > bucket:
            return np.concatenate([self._encode_crops(kind, frame_bgr, per_face[i : i + bucket],
                                                      crop, pad_row)
                                   for i in range(0, k, bucket)])
        padded = np.empty((bucket, *per_face.shape[1:]), np.float32)
        padded[:k] = per_face
        padded[k:] = pad_row
        frame = self._frame_arg(frame_bgr)

        def run(frame_u8, rows):
            img = frame_u8.float() / 255.0
            return l2_normalize(self.encoder(bgr_to_rgb(crop(img, rows))).float())

        emb = self._run((kind, tuple(frame.shape[:2]), bucket), self.encoder, run,
                        (frame, padded))[0]
        with span("readback"):
            return emb.cpu().numpy()[:k]

    def encode_boxes(self, frame_bgr: Frame, boxes_xywh: np.ndarray) -> np.ndarray:
        """Encode all K face boxes of a frame: (K, 4) pixel xywh →
        (K, D) L2-normalised embeddings."""
        size = self.cfg.engine.encode_size
        return self._encode_crops("encb", frame_bgr, boxes_xywh,
                                  lambda img, b: crop_and_resize_mm(img, b, size))

    def encode_landmarks(self, frame_bgr: Frame, lms3: np.ndarray) -> np.ndarray:
        """Encode K faces through landmark-aligned crops: ``lms3``
        (K, 3, 2) per-face (left_eye, right_eye, nose) pixels.  Pad rows
        take the template (an all-zero triangle would make the affine
        solve singular)."""
        return self._encode_crops("encl", frame_bgr, lms3, align_faces_160,
                                  pad_row=np.asarray(ALIGN_TEMPLATE_160, np.float32))

    def encode_faces(self, faces_rgb01: np.ndarray) -> np.ndarray:
        """Encode pre-extracted (B, 160, 160, 3) RGB [0,1] crops (the
        ``add_face`` path), padded to ``_buckets(B, max(max_encode, B))``
        (``engine.py:718-728``)."""
        b = faces_rgb01.shape[0]
        if b == 0:
            return np.zeros((0, self.cfg.embedding_dim), np.float32)
        bucket = _buckets(b, max(self.cfg.engine.max_encode, b))
        padded = np.zeros((bucket, *faces_rgb01.shape[1:]), np.float32)
        padded[:b] = faces_rgb01
        emb = self._run(("encf", padded.shape), self.encoder,
                        lambda x: l2_normalize(self.encoder(x).float()), (padded,))[0]
        return emb.cpu().numpy()[:b]

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
