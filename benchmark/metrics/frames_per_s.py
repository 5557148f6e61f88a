"""Frames whose labels came back in the window, over the window's seconds."""


def read(r):
    if r["mode"] != "batched" or r["window_s"] <= 0:
        return None
    return r["measured"] / r["window_s"]
