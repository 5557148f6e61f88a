"""Median over the traced queries of the slowest shard's time on its
card: the extent of the program's "match.shard<s>" range on the card
(its query copy and top-k), from the profiler's trace (ms)."""

import numpy as np


def read(r):
    t = r.get("trace") or {}
    if r["mode"] != "per_frame" or not t.get("shard_ms"):
        return None
    return float(np.median(t["shard_ms"]))
