"""Host staging of a batch: the timer's "stack (host)" and "submit (H2D
+ step)" per batch, over the measured window (ms)."""


def read(r):
    if r["mode"] != "batched" or not r["timed_batches"]:
        return None
    t = r["timer_ms"]
    return (t.get("stack (host)", 0.0) + t.get("submit (H2D + step)", 0.0)) / r["timed_batches"]
