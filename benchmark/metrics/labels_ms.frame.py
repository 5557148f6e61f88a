"""Median per frame of the program's span "labels" (both of a frame's
intervals: the per-track bookkeeping before the encode, the label loop
with its enrolments after the match), over the measured window (ms)."""

import numpy as np


def read(r):
    s = r.get("spans_ms") or {}
    if r["mode"] != "per_frame" or not s.get("labels"):
        return None
    return float(np.median(s["labels"]))
