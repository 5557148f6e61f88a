"""Median of the timer's "match" stage over the frames that encode (K1
on one card, the sharded view on several), over the measured
the window (ms)."""

import numpy as np


def read(r):
    if r["mode"] != "per_frame":
        return None
    s = r["stages_ms"]
    m = [x for x, e in zip(s["match"], s["encoding"]) if e > 0]
    return float(np.median(m)) if m else None
