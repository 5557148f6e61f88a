"""Batched stream pipeline: engine, batched step, recognizer, I/O, timing."""
