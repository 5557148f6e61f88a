"""Pad rows the encoder ran per face it encoded: the program's counters
``encoding.padded`` over ``encoding.rows`` (the rows its power-of-two
buckets added, and the faces; its timer's ``counters``, per frame in
``record["counters"]``), summed over the measured window."""


def read(r):
    c = r.get("counters") or {}
    if r["mode"] != "per_frame" or "encoding.rows" not in c:
        return None
    rows = sum(c["encoding.rows"])
    return float(sum(c.get("encoding.padded", ()))) / rows if rows else None
