"""Batched stream pipeline: engine, batched step, recognizer, I/O, timing."""

from fire_tpu_torch.pipeline.engine import DeviceEngine  # noqa: F401
from fire_tpu_torch.pipeline.recognizer import FaceRecognition  # noqa: F401
