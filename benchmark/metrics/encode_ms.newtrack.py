"""Median of the timer's "encoding" stage over the frames that encode
(a new track), over the measured window (ms)."""

import numpy as np


def read(r):
    if r["mode"] != "per_frame":
        return None
    enc = [x for x in r["stages_ms"]["encoding"] if x > 0]
    return float(np.median(enc)) if enc else None
