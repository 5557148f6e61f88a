"""Median over every frame of the window of the time from handing the
frame to ``recognize_faces`` until its labels returned (ms)."""

import numpy as np


def read(r):
    if r["mode"] != "per_frame" or not r["latency_ms"]:
        return None
    return float(np.percentile(r["latency_ms"], 50))
