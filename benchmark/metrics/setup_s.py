"""Seconds from the process's start to the window's: imports, the
traffic's frames, the gallery, the recognizer and its weights, the
kernels' build and the warm-up of every shape."""


def read(r):
    return r["setup_s"]
