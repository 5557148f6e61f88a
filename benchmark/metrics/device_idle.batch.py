"""The card's idle share of the traced window (%), batched path."""


def read(r):
    t = r.get("trace")
    if r["mode"] != "batched" or not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
