"""FIRE on PyTorch/CUDA: :mod:`fire_tpu`'s serving surface ported whole:
the batched video path, the per-frame path, image mode and the command
line (``python -m fire_tpu_torch``, every flag of ``fire_tpu.cli``),
with every detector slot (YuNet, RetinaFace, BlazeFace), at-rest
encryption, several streams over a mesh of devices and the row-sharded
gallery (:mod:`fire_tpu_torch.parallel`), and the ONNX / TFLite
importers, exporter and executor behind ``--weights_dir``
(``python -m fire_tpu_torch.verify_onnx`` checks a file), and the
training plane (:mod:`fire_tpu_torch.train`: ArcFace for FaceNet and the
YuNet, BlazeFace and RetinaFace trainers, on one card).

The package mirrors ``fire_tpu``'s module names so each counterpart is
easy to find.  It imports ``torch`` and never JAX, Flax or anything of
``fire_tpu``; weights load from the same Flax msgpack files through its
own decoder, and models without committed weights get the JAX engine's
deterministic random init, kept in the same params cache
(:mod:`fire_tpu_torch.weights`).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a CUDA device they raise instead of falling back.

The one hand-written kernel, K1 (fused cosine top-1 over the gallery),
is CUDA C++ under ``csrc/``, built with ``nvcc`` for ``sm_90a`` at first
use into ``_build/`` and bound with ``ctypes``
(:mod:`fire_tpu_torch.ops.cosine_top1`).  Beside it, ``csrc/`` holds the
encryption's AES-128-CBC for the host CPU, built the same way with the
host C++ compiler (:mod:`fire_tpu_torch.gallery.crypto`).
"""

__version__ = "0.1.0"
