"""K2's share of its roofline in the traced batches: the least time its
bytes for (B, T, K) could take, over K2's device time by kernel name (%)."""


def read(r):
    t = r.get("trace")
    if r["mode"] != "batched" or not t or t["k2_s"] <= 0 or t["k2_bound_s"] <= 0:
        return None
    return 100.0 * t["k2_bound_s"] / t["k2_s"]
