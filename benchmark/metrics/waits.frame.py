"""Mean per frame of the count of the program's "<stage>.readback"
spans: the host's waits for the card, over the measured window."""

import numpy as np


def read(r):
    c = r.get("counts") or {}
    waits = [v for k, v in c.items() if k.endswith(".readback")]
    if r["mode"] != "per_frame" or not waits:
        return None
    return float(np.mean(np.sum(waits, axis=0)))
