"""Median per frame of the timer's "tracker" stage, before the traced
part of the window (ms)."""

import numpy as np


def read(r):
    if r["mode"] != "per_frame" or not r["stages_ms"]["tracker"]:
        return None
    return float(np.median(r["stages_ms"]["tracker"]))
