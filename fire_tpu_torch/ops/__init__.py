"""Tensor ops of the batched path: image resampling, boxes/NMS, anchors,
gallery matching and the K1 kernel wrapper."""
