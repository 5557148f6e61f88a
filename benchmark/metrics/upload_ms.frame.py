"""Median per frame of the program's span "upload" (the frame's copy to
the card), over the measured window (ms)."""

import numpy as np


def read(r):
    s = r.get("spans_ms") or {}
    if r["mode"] != "per_frame" or not s.get("upload"):
        return None
    return float(np.median(s["upload"]))
