"""Training: the FaceNet encoder (ArcFace, on one device or sharded
over a dp×mp mesh) and the three detector slots, on one device
(counterpart of ``fire_tpu.train``), plus the numpy-only synthetic
identities and scenes they train on.

Entry points (``--device`` defaults to ``cuda``; ``--device cpu``
without a card):
  python -m fire_tpu_torch.train               FaceNet encoder (ArcFace)
  python -m fire_tpu_torch.train.detect        YuNet detector
  python -m fire_tpu_torch.train.detect_blaze  BlazeFace (mediapipe slot)
  python -m fire_tpu_torch.train.detect_retina RetinaFace
  python -m fire_tpu_torch.train.synth         synthetic identity dataset

Each trainer writes Flax msgpack variables that
``DeviceEngine.load_trained_*`` of either package loads.
"""

from fire_tpu_torch.train.losses import arcface_logits  # noqa: F401
from fire_tpu_torch.train.trainer import (TrainState, make_train_step,  # noqa: F401
                                          state_shardings)
