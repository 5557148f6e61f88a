"""Batched stream pipeline: engine, batched step, recognizer, I/O, timing.

``DeviceEngine`` and ``FaceRecognition`` are loaded at first use, so that
the modules below the recognizer (the tracker, the gallery) can import
:mod:`fire_tpu_torch.pipeline.timing` without the recognizer that
imports them."""


def __getattr__(name):
    if name == "DeviceEngine":
        from fire_tpu_torch.pipeline.engine import DeviceEngine
        return DeviceEngine
    if name == "FaceRecognition":
        from fire_tpu_torch.pipeline.recognizer import FaceRecognition
        return FaceRecognition
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
