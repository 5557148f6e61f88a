"""Median per frame of the frame's time less its four timed stages
(detection, tracker, encoding, match): the host loop, labels, caches
and the upload, over the measured window (ms)."""

import numpy as np


def read(r):
    if r["mode"] != "per_frame" or not r["latency_ms"]:
        return None
    s = r["stages_ms"]
    other = [t - sum(s[k][i] for k in ("detection", "tracker", "encoding", "match"))
             for i, t in enumerate(r["latency_ms"])]
    return float(np.median(other))
