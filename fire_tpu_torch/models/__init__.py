"""Detector and encoder networks as torch modules (NHWC at the public API)."""
