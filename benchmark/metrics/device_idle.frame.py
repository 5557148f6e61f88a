"""The first card's idle share of the traced window (%), per-frame path."""


def read(r):
    t = r.get("trace")
    if r["mode"] != "per_frame" or not t or t["window_s"] <= 0 or t["busy_first_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_first_s"] / t["window_s"])
