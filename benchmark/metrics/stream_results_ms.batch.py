"""The host's labelling of a batch (the timer's "host stream_results")
per batch, over the measured window (ms)."""


def read(r):
    if r["mode"] != "batched" or not r["timed_batches"]:
        return None
    t = r["timer_ms"].get("host stream_results")
    return None if t is None else t / r["timed_batches"]
