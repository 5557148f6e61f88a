"""Median per frame of the program's "<stage>.readback" spans together:
the host's waits for the card's answers, over the measured window
(ms)."""

import numpy as np


def read(r):
    s = r.get("spans_ms") or {}
    waits = [v for k, v in s.items() if k.endswith(".readback")]
    if r["mode"] != "per_frame" or not waits:
        return None
    return float(np.median(np.sum(waits, axis=0)))
