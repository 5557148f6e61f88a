"""Detector and encoder networks as torch modules (NHWC at the public API)."""

from fire_tpu_torch.models.facenet import FaceNet, facenet_128, facenet_512  # noqa: F401
from fire_tpu_torch.models.yunet import YuNet  # noqa: F401
from fire_tpu_torch.models.blazeface import BlazeFace  # noqa: F401
from fire_tpu_torch.models.retinaface import RetinaFace  # noqa: F401
