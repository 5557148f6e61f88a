"""K1's share of its roofline in the traced batches: the least time the
queries the inputs needed (the faces encoded, at most ``encode_k`` a
frame) and the gallery's bf16 rows could take, over K1's device time by
kernel name (%)."""


def read(r):
    t = r.get("trace")
    if r["mode"] != "batched" or not t or t["k1_s"] <= 0 or t["k1_bound_s"] <= 0:
        return None
    return 100.0 * t["k1_bound_s"] / t["k1_s"]
