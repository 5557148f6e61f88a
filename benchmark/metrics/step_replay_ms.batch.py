"""The step graph's replay per batch, by CUDA events (the timer's "step
(graph replay)"), over the measured window (ms)."""


def read(r):
    if r["mode"] != "batched" or not r["timed_batches"]:
        return None
    t = r["timer_ms"].get("step (graph replay)")
    return None if t is None else t / r["timed_batches"]
